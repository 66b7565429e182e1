// Bitstream assembly: OR per-entry packed words into each interval's
// stream (kernel K5).
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/pack_pallas.py::assemble_bitstream_pallas (body
// _assemble_kernel), vmapped over restart intervals as the JAX package runs
// it. Same function: (rows, E, EW) u32 per-entry words, each entry's codes
// packed MSB-first from its bit 0, plus (rows, E) int64 bit offsets within
// the row -> (rows, num_words) u32 words, word k of entry e landing at bit
// offsets[e] + 32 k of its row. Words at or past num_words are dropped. The
// TPU kernel clamps such entries onto the buffer's tail instead; the two
// differ only on an overflow, whose payload the caller discards.
//
// The TPU kernel walks the entries in grid order and read-modify-writes a
// VMEM-resident output, placing each entry with lane rolls. Hopper's blocks
// run in no order, so one warp takes one entry: lane l shifts words l and
// l + 32 into place (output word q + k is w[k] >> s | w[k - 1] << (32 - s)
// for the entry's word offset q and bit phase s) and stores them. The
// entries' bit ranges are disjoint (the offsets are an exclusive scan of
// their bit counts), so only the first word and the last non-zero word of
// an entry can hold another entry's bits: those two are atomicOr'ed into
// the zero-filled output, the words between them are plain stores.
//
// What bounds it on Hopper: bytes. It reads EW = 56 words an entry, most of
// them zero for real content (a 1080p 4:2:0 entry averages ~30 bits), and
// writes the stream once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // entries in flight a CTA
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const uint32_t* __restrict__ entry_words,
                const long long* __restrict__ offsets, long long num_items,
                int entries, int ew, uint32_t* __restrict__ out,
                int num_words) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
       item < num_items; item += static_cast<long long>(gridDim.x) * kWarps) {
    const uint32_t* w = entry_words + item * ew;
    uint32_t* row = out + (item / entries) * num_words;
    const long long off = offsets[item];
    const long long q = off >> 5;  // a row may pass 2^31 bits
    const int s = static_cast<int>(off & 31);
    // Output words q + k, k = 0..ew (ew + 1 of them, the last a spill),
    // in rounds of 32; `last` is the entry's last non-zero output word.
    uint32_t vals[2];
    int last = -1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = 32 * r + lane;
      const uint32_t cur = k < ew ? w[k] : 0u;
      const uint32_t prev = (k >= 1 && k - 1 < ew) ? w[k - 1] : 0u;
      vals[r] = s == 0 ? cur : (cur >> s) | (prev << (32 - s));
      const unsigned nz = __ballot_sync(kFull, k <= ew && vals[r] != 0u);
      if (nz) last = 32 * r + 31 - __clz(nz);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = 32 * r + lane;
      const long long gw = q + k;
      if (k > ew || vals[r] == 0u || gw >= num_words) continue;
      if (k == 0 || k == last) {
        atomicOr(&row[gw], vals[r]);  // may hold a neighbour's bits
      } else {
        row[gw] = vals[r];  // inside this entry's bit range alone
      }
    }
  }
}

int grid_for(long long warps_of_work) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    sms = 132;
  }
  const long long ctas = (warps_of_work + kWarps - 1) / kWarps;
  return ctas < 16LL * sms ? static_cast<int>(ctas) : 16 * sms;
}

}  // namespace

// entry_words: (rows, entries, ew) u32, ew <= 63. offsets: (rows, entries)
// int64 bit offsets, >= 0, within each row. out: (rows, num_words) u32
// value words (not byte-swapped), zero-filled here first. Returns the first
// cudaError_t met (0 on success).
extern "C" int jt_assemble_bitstream(const uint32_t* entry_words,
                                     const long long* offsets, int rows,
                                     int entries, int ew, uint32_t* out,
                                     int num_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long num_items = static_cast<long long>(rows) * entries;
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(uint32_t) * static_cast<size_t>(num_words) * rows, st);
  if (err != cudaSuccess || num_items == 0) return static_cast<int>(err);
  assemble_kernel<<<grid_for(num_items), kThreads, 0, st>>>(
      entry_words, offsets, num_items, entries, ew, out, num_words);
  return static_cast<int>(cudaGetLastError());
}

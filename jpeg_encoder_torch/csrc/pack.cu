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
// Precondition (this design's; the plain version does not need it): within
// a row the offsets are non-decreasing and entry e's bits lie in
// [offsets[e], offsets[e + 1]), its words zero past its bit count. That is
// what scan.assemble_operands gives: pack_level1's words, and offsets that
// are an exclusive cumsum of the entries' bit counts. Entries of 0 bits (the
// dead entries under live_entries, the silent padding of a short last
// interval) share the offset of the entry after them.
//
// Design: output-centric. The TPU kernel walks the entries in grid order and
// read-modify-writes a VMEM-resident output; an output-centric kernel lost
// there because its gathers serialize. On Hopper the trade reverses: each
// warp owns a window of 32 output words (1,024 bits) of one row and writes
// it once, one coalesced word a lane, zeros past the payload included: no
// memset, no global atomics. A window before the row's first entry, or past
// its last entry plus that entry's EW words, is zero without a search.
// Otherwise the warp finds the last entry starting at or before the
// window's first bit and the first entry starting at or past its end, both
// in one 32-way search over the row's offsets (one round of loads a step:
// 2 steps for 720 entries, 4 for 48,960); only the entries between can hold
// the window's bits. Those go a lane an entry: an entry ends at the next
// entry's offset (the row's last entry after its EW words), so only its
// live words are read, one or two for a typical 1080p entry of ~30 bits,
// and ORed into the window's words in shared memory. Of a run of entries
// sharing one offset only the last can hold bits (an entry with bits moves
// the next offset), so a batch of 32 entries without bits skips the rest of
// its run with one more search instead of walking it.
//
// What bounds it on Hopper: in principle bytes (8 B of offset an entry, the
// live words, the output rows written once: 0.00046 ms at 1080p 4:2:0 in
// 68 restart intervals), in practice the latency of each payload window's
// chain of dependent loads (bounds check, search, offsets, words: ~7
// rounds), which the card hides only as far as windows with payload are in
// flight; 89% of the windows there are zero tail and cost one round.
// Why it won, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, K5): against
// the kernel it replaced (a warp an entry reading all 56 words, after a
// memset, atomicOr on boundary words), on the same operands in one run,
// 0.0082 ms busy against 0.0101 at 68 rows and 0.0075 against 0.0101 at
// one row, one device operation instead of two. A first output-centric
// design, a thread per 4 words with its own binary search (10-16 dependent
// loads), read 0.0078 and 0.0085 ms by an earlier busy count that could
// read low, and was not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = 32;  // output words a warp: one a lane

// The first index in [lo, hi) whose offset exceeds v (hi if none), for a
// whole warp, and for a second value u at the same time (hu): a 32-way
// search, one round of loads a step, so a row of 48,960 entries takes four
// steps. The offsets are non-decreasing.
__device__ __forceinline__ void warp_upper_bounds(
    const long long* __restrict__ off, int lo, int hi, long long v, int& out_v,
    long long u, int& out_u, int lane) {
  int lv = lo, hv = hi, lu = lo, hu = hi;
  while (hv - lv > 32 || hu - lu > 32) {
    const int sv = (hv - lv + 31) / 32, su = (hu - lu + 31) / 32;
    const int iv = lv + lane * sv, iu = lu + lane * su;
    const bool bv = hv - lv > 32 && iv < hv && off[iv] <= v;
    const bool bu = hu - lu > 32 && iu < hu && off[iu] <= u;
    const int cv = __popc(__ballot_sync(kFull, bv));
    const int cu = __popc(__ballot_sync(kFull, bu));
    if (hv - lv > 32) {
      // Positions lv + j sv for j < cv hold offsets <= v; the next does not.
      const int cap = lv + cv * sv;
      hv = cv == 0 ? lv : (cap < hv ? cap : hv);
      lv = cv == 0 ? lv : lv + (cv - 1) * sv + 1;
    }
    if (hu - lu > 32) {
      const int cap = lu + cu * su;
      hu = cu == 0 ? lu : (cap < hu ? cap : hu);
      lu = cu == 0 ? lu : lu + (cu - 1) * su + 1;
    }
  }
  const bool bv = lv + lane < hv && off[lv + lane] <= v;
  const bool bu = lu + lane < hu && off[lu + lane] <= u;
  out_v = lv + __popc(__ballot_sync(kFull, bv));
  out_u = lu + __popc(__ballot_sync(kFull, bu));
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const uint32_t* __restrict__ entry_words,
                const long long* __restrict__ offsets, long long rows,
                int entries, int ew, uint32_t* __restrict__ out,
                int num_words, long long windows_per_row) {
  __shared__ uint32_t acc_all[kWarps][kWindow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* acc = acc_all[warp];
  const long long total = rows * windows_per_row;
  for (long long win = static_cast<long long>(blockIdx.x) * kWarps + warp;
       win < total; win += static_cast<long long>(gridDim.x) * kWarps) {
    const long long row = win / windows_per_row;
    const long long w0 = (win - row * windows_per_row) * kWindow;
    const long long b0 = 32 * w0;             // the window's first bit
    const long long b1 = b0 + 32 * kWindow;   // one past its last
    const long long* off = offsets + row * entries;
    const uint32_t* words = entry_words + row * entries * ew;
    acc[lane] = 0u;
    __syncwarp();
    // Before the row's first entry, and past its last entry and that
    // entry's ew words, nothing is set.
    const long long first = entries > 0 ? off[0] : 0;
    const long long last = entries > 0 ? off[entries - 1] : 0;
    if (entries > 0 && b1 > first && b0 < last + 32LL * ew) {
      int e, e_end;
      // e: the last entry starting at or before b0 (the last of its run);
      // e_end: the first entry starting at or after b1.
      warp_upper_bounds(off, 0, entries, b0 > first ? b0 : first, e, b1 - 1,
                        e_end, lane);
      --e;
      for (int base = e; base < e_end;) {
        const int i = base + lane;
        bool has_bits = false;
        if (i < e_end) {
          const long long o = off[i];
          const long long end = i + 1 < entries ? off[i + 1] : o + 32LL * ew;
          has_bits = end > o;
          const long long q = o >> 5;
          const int s = static_cast<int>(o & 31);
          // This entry's output words inside the window: q + k, k <= ew (k
          // = ew holds the spill of word ew - 1), up to its last bit.
          const long long lo = q > w0 ? q : w0;
          long long hi = (end - 1) >> 5;
          hi = hi < q + ew ? hi : q + ew;
          hi = hi < w0 + kWindow - 1 ? hi : w0 + kWindow - 1;
          if (has_bits && lo <= hi) {
            const uint32_t* w = words + static_cast<long long>(i) * ew;
            int k = static_cast<int>(lo - q);
            uint32_t prev = (s != 0 && k >= 1) ? w[k - 1] : 0u;
            for (long long g = lo; g <= hi; ++g, ++k) {
              const uint32_t cur = k < ew ? w[k] : 0u;
              const uint32_t val =
                  s == 0 ? cur : (cur >> s) | (prev << (32 - s));
              if (val != 0u) atomicOr(&acc[g - w0], val);
              prev = cur;
            }
          }
        }
        const bool run = __ballot_sync(kFull, has_bits) == 0u &&
                         base + 32 < e_end;
        if (run) {
          // 32 entries of 0 bits share one offset: skip to the last entry
          // of their run (the one of them that can hold bits).
          int skip, unused;
          const long long v = off[base];
          warp_upper_bounds(off, base + 32, e_end, v, skip, v, unused, lane);
          base = skip - 1;
        } else {
          base += 32;
        }
      }
    }
    __syncwarp();
    if (w0 + lane < num_words) out[row * num_words + w0 + lane] = acc[lane];
    __syncwarp();
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
// int64 bit offsets, >= 0, within each row, under the precondition above.
// out: (rows, num_words) u32 value words (not byte-swapped), every word
// written here. One kernel, no other device operation. Returns the first
// cudaError_t met (0 on success).
extern "C" int jt_assemble_bitstream(const uint32_t* entry_words,
                                     const long long* offsets, int rows,
                                     int entries, int ew, uint32_t* out,
                                     int num_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long windows_per_row = (num_words + kWindow - 1) / kWindow;
  const long long total = static_cast<long long>(rows) * windows_per_row;
  if (total == 0) return 0;
  assemble_kernel<<<grid_for(total), kThreads, 0, st>>>(
      entry_words, offsets, rows, entries, ew, out, num_words,
      windows_per_row);
  return static_cast<int>(cudaGetLastError());
}

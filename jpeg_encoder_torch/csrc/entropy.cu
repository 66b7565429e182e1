// Entropy coding + bit packing of JPEG scan entries (kernel K4).
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/entropy_pallas.py::encode_entropy_fused (body
// _entropy_kernel). Same function: (E, 64) int16 zigzag scan entries with
// the raw DC in slot 0 -> a big-endian packed bitstream plus its true bit
// count: DC differences along the three predictor chains (seeded from
// init_dc), run-length symbols with ZRL and EOB, Huffman lookup in packed
// `length << 20 | code` tables, and MSB-first packing. Words at or past
// num_words are dropped and the bit count still reports the true length,
// which is how the caller detects an overflow.
//
// Restart intervals (the TPU kernel vmapped over them): the entries are cut
// every entries_per_interval entries (whole MCUs; the last interval may be
// short) into independently coded streams. Interval j packs into its own
// row of num_words words from bit 0, its DC predictors start at init_dc
// (0 for a restart-framed scan), and interval_bits[j] is its true length;
// an overflowing interval drops its excess words and never spills into row
// j + 1. The unbroken scan is one interval of all entries. Entries at
// index >= live_entries emit nothing (a fully dead interval reports 0).
//
// A batch (the TPU kernel vmapped over images): z holds B images of
// entries_per_image (E) entries each, and the intervals restart at every
// image, so entry e lies in image e / E, in interval (e % E) / epi of that
// image, in row (e / E) * n_int + (e % E) / epi, with n_int = ceil(E / epi)
// rows an image; the unbroken scan of each image is epi = E. live_entries
// counts within each image. The Huffman tables of image i are dc_lut and
// ac_lut advanced by i * lut_stride ints (0: one pair for all); the CTAs of
// blockIdx.y = i code image i alone, so each loads its own pair.
//
// The TPU kernel carries the running bit offset from one grid step to the
// next because its grid runs in order. Hopper gives no such order, so this
// is three passes:
//   1. count: one warp per entry (two zigzag slots a lane) computes the
//      entry's bit count;
//   2. scan: an exclusive scan of the counts (a block scan per tile of
//      4096 entries, then one CTA over the tile totals) gives every entry
//      its global bit offset; an entry's offset in its interval is that
//      minus the offset of the interval's first entry, and an interval's
//      length the difference of two such offsets;
//   3. write: each warp recomputes its entry's slot codes, places them in
//      a shared-memory copy of the words it spans, then stores the words it
//      owns alone and atomicOr's the (at most two) boundary words it shares
//      with its neighbours into the zero-filled output. The bit ranges are
//      disjoint, so the result does not depend on the order of the atomics.
// Words are stored byte-swapped, so the output read as bytes is the stream.
//
// Each slot's symbol needs the entry's run state: a warp max-scan of the
// nonzero positions gives every slot the previous nonzero; the DC
// predictor is the raw DC of the previous entry of the same component,
// read from device memory at the static scan distance 1 (a luma block after
// another of its MCU), bpm - hv + 1 (an MCU's first luma block) or bpm
// (chroma), as _entropy_kernel explains; a lookback that would leave the
// entry's interval takes init_dc instead.
//
// What bounds it on Hopper: bytes moved (128 B of coefficients read twice,
// plus the counts and the output stream) and the serial dependence of the
// offsets, which costs the scan pass and a second symbolization.
//
// The offsets are int32, as in the TPU kernel, and the one scan runs over
// the whole batch: the caller keeps B times an image's worst case below
// 2^31 bits (kernels/entropy.py refuses more, parallel/batch.py sizes its
// chunks under it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;                    // warps (entries in flight) a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // entries per scan tile
// Words one entry can span: 64 slots of at most 32 bits, plus 31 phase bits.
constexpr int kEntryWords = 66;
constexpr int kLutSize = 1024;  // dc luma, dc chroma, ac luma, ac chroma

struct SlotPair {
  uint32_t bits0, bits1;
  int len0, len1;
};

__device__ __forceinline__ int bit_length(int v) { return 32 - __clz(v); }

// Code of one slot: i is the zigzag position, v its value (slot 0: the DC
// difference), run_base the position of the previous nonzero (0 if none).
__device__ __forceinline__ void slot_code(int i, int v, int run_base,
                                          int last_nz, int chroma,
                                          const int* lut, uint32_t& bits,
                                          int& len) {
  if (i == 0 || v != 0) {
    const int bl = bit_length(v < 0 ? -v : v);
    const int mask = (1 << bl) - 1;
    const int ampl = (v < 0 ? v + mask : v) & mask;
    int idx;
    if (i == 0) {
      idx = chroma * 256 + bl;
    } else {
      const int sym = (((i - run_base - 1) & 15) << 4) | bl;
      idx = 512 + chroma * 256 + (sym < 255 ? sym : 255);
    }
    const int cl = lut[idx];
    bits = (static_cast<uint32_t>(cl & 0xFFFFF) << bl) |
           static_cast<uint32_t>(ampl);
    len = (cl >> 20) + bl;
  } else if (i <= last_nz && (i - run_base) % 16 == 0) {  // ZRL
    const int cl = lut[512 + chroma * 256 + 0xF0];
    bits = static_cast<uint32_t>(cl & 0xFFFFF);
    len = cl >> 20;
  } else if (i == 63) {  // EOB: the block ends in zeros
    const int cl = lut[512 + chroma * 256 + 0x00];
    bits = static_cast<uint32_t>(cl & 0xFFFFF);
    len = cl >> 20;
  } else {
    bits = 0;
    len = 0;
  }
}

// Slots 2*lane and 2*lane+1 of entry e, for a whole warp.
// `first` is the index of the first entry of e's interval.
__device__ __forceinline__ SlotPair symbolize(const int16_t* __restrict__ z,
                                              int e, int first, int hv,
                                              const int* __restrict__ init_dc,
                                              const int* lut, int lane) {
  const int bpm = hv + 2;
  const int pos = e % bpm;
  const int chroma = pos >= hv;
  const uint32_t pair =
      reinterpret_cast<const uint32_t*>(z + static_cast<size_t>(e) * 64)[lane];
  int v0 = static_cast<int16_t>(static_cast<uint16_t>(pair & 0xFFFFu));
  const int v1 = static_cast<int16_t>(static_cast<uint16_t>(pair >> 16));
  if (lane == 0) {
    const int d = pos >= hv ? bpm : (pos == 0 ? bpm - hv + 1 : 1);
    const int init = pos < hv ? init_dc[0] : (pos == hv ? init_dc[1] : init_dc[2]);
    const int prev =
        e - d < first ? init
                      : static_cast<int>(z[static_cast<size_t>(e - d) * 64]);
    v0 -= prev;
  }
  const int i0 = 2 * lane, i1 = 2 * lane + 1;
  const int m0 = (i0 > 0 && v0 != 0) ? i0 : 0;
  const int m1 = v1 != 0 ? i1 : 0;
  int incl = max(m0, m1);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = max(incl, t);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0;
  const int last_nz = __shfl_sync(kFull, incl, 31);
  SlotPair s;
  slot_code(i0, v0, excl, last_nz, chroma, lut, s.bits0, s.len0);
  slot_code(i1, v1, max(excl, m0), last_nz, chroma, lut, s.bits1, s.len1);
  return s;
}

__device__ __forceinline__ void load_luts(int* lut, const int* dc_lut,
                                          const int* ac_lut) {
  for (int t = threadIdx.x; t < kLutSize; t += blockDim.x) {
    lut[t] = t < 512 ? dc_lut[t] : ac_lut[t - 512];
  }
  __syncthreads();
}

// blockIdx.y is the image; its entries are e = image * per_image + local.
__global__ void __launch_bounds__(kThreads)
count_kernel(const int16_t* __restrict__ z, int per_image, int epi,
             int live_entries, int hv, const int* __restrict__ init_dc,
             const int* __restrict__ dc_lut, const int* __restrict__ ac_lut,
             int lut_stride, int* __restrict__ entry_bits) {
  __shared__ int lut[kLutSize];
  const int base = blockIdx.y * per_image;
  load_luts(lut, dc_lut + blockIdx.y * lut_stride,
            ac_lut + blockIdx.y * lut_stride);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int local = blockIdx.x * kWarps + warp; local < per_image;
       local += gridDim.x * kWarps) {
    const int e = base + local;
    if (local >= live_entries) {  // warp-uniform
      if (lane == 0) entry_bits[e] = 0;
      continue;
    }
    const SlotPair s =
        symbolize(z, e, base + local / epi * epi, hv, init_dc, lut, lane);
    int n = s.len0 + s.len1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
    if (lane == 0) entry_bits[e] = n;
  }
}

// Inclusive scan of one value per thread over a whole CTA; *total gets the
// CTA's sum. warp_tot is 32 ints of shared memory.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_tot,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int w = lane < nwarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += t;
    }
    if (lane < nwarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const int result = incl + (warp > 0 ? warp_tot[warp - 1] : 0);
  *total = warp_tot[(blockDim.x >> 5) - 1];
  __syncthreads();  // warp_tot may be reused by the caller
  return result;
}

// Per tile of kScanTile entries: counts -> tile-local exclusive offsets (in
// place: each thread reads its items before writing them) + the tile sum.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(int* __restrict__ bits_to_offsets, int num_entries,
                  int* __restrict__ tile_sums) {
  __shared__ int warp_tot[32];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < num_entries ? bits_to_offsets[base + i] : 0;
    sum += v[i];
  }
  int total;
  int run = block_inclusive_scan(sum, warp_tot, &total) - sum;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < num_entries) bits_to_offsets[base + i] = run;
    run += v[i];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One CTA: tile sums -> exclusive tile offsets (in place) + total_bits.
__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums_kernel(int* __restrict__ tile_sums, int num_tiles,
                      int* __restrict__ total_bits) {
  __shared__ int warp_tot[32];
  int carry = 0;
  for (int start = 0; start < num_tiles; start += kScanThreads) {
    const int idx = start + threadIdx.x;
    const int v = idx < num_tiles ? tile_sums[idx] : 0;
    int total;
    const int incl = block_inclusive_scan(v, warp_tot, &total);
    if (idx < num_tiles) tile_sums[idx] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) *total_bits = carry;
}

// Bit offset of entry e (e == num_entries: the total) in the whole scan.
__device__ __forceinline__ int scan_offset(const int* __restrict__ entry_offsets,
                                           const int* __restrict__ tile_offsets,
                                           const int* __restrict__ total_bits,
                                           int e, int num_entries) {
  return e < num_entries ? entry_offsets[e] + tile_offsets[e / kScanTile]
                         : *total_bits;
}

// One thread per row (interval j % n_int of image j / n_int): its true bit
// count.
__global__ void interval_bits_kernel(const int* __restrict__ entry_offsets,
                                     const int* __restrict__ tile_offsets,
                                     const int* __restrict__ total_bits,
                                     int num_entries, int per_image, int epi,
                                     int n_int, int num_rows,
                                     int* __restrict__ interval_bits) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= num_rows) return;
  const int local = (j % n_int) * epi;
  const int first = (j / n_int) * per_image + local;
  const int end = first + (per_image - local > epi ? epi : per_image - local);
  interval_bits[j] =
      scan_offset(entry_offsets, tile_offsets, total_bits, end, num_entries) -
      scan_offset(entry_offsets, tile_offsets, total_bits, first, num_entries);
}

__device__ __forceinline__ void put_bits(uint32_t* buf, int offset,
                                         uint32_t bits, int len) {
  if (len == 0) return;
  const int w = offset >> 5;
  const int end = (offset & 31) + len;
  if (end <= 32) {
    atomicOr(&buf[w], bits << (32 - end));
  } else {
    atomicOr(&buf[w], bits >> (end - 32));
    atomicOr(&buf[w + 1], bits << (64 - end));
  }
}

// blockIdx.y is the image, as in count_kernel; live is the image's live
// entry count, clamped to per_image.
__global__ void __launch_bounds__(kThreads)
write_kernel(const int16_t* __restrict__ z, int per_image, int epi, int n_int,
             int live, int hv, const int* __restrict__ init_dc,
             const int* __restrict__ dc_lut, const int* __restrict__ ac_lut,
             int lut_stride, const int* __restrict__ entry_offsets,
             const int* __restrict__ tile_offsets, uint32_t* __restrict__ out,
             int num_words) {
  __shared__ int lut[kLutSize];
  __shared__ uint32_t buf[kWarps][kEntryWords];
  const int base = blockIdx.y * per_image;
  load_luts(lut, dc_lut + blockIdx.y * lut_stride,
            ac_lut + blockIdx.y * lut_stride);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* wbuf = buf[warp];
  for (int local = blockIdx.x * kWarps + warp; local < live;
       local += gridDim.x * kWarps) {
    const int e = base + local;
    const int row_index = blockIdx.y * n_int + local / epi;
    const int first = base + local / epi * epi;
    const SlotPair s = symbolize(z, e, first, hv, init_dc, lut, lane);
    const int n = s.len0 + s.len1;
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const int entry_len = __shfl_sync(kFull, incl, 31);
    if (entry_len == 0) continue;  // warp-uniform
    const int offset = entry_offsets[e] + tile_offsets[e / kScanTile] -
                       entry_offsets[first] - tile_offsets[first / kScanTile];
    uint32_t* row = out + static_cast<size_t>(row_index) * num_words;
    const int phase = offset & 31;
    const int first_word = offset >> 5;
    const int words = (phase + entry_len + 31) >> 5;
    for (int w = lane; w < words; w += 32) wbuf[w] = 0;
    __syncwarp();
    const int start = phase + incl - n;  // this lane's first bit in wbuf
    put_bits(wbuf, start, s.bits0, s.len0);
    put_bits(wbuf, start + s.len0, s.bits1, s.len1);
    __syncwarp();
    for (int w = lane; w < words; w += 32) {
      const int gw = first_word + w;
      if (gw >= num_words) break;  // the row's capacity: dropped
      const uint32_t val = __byte_perm(wbuf[w], 0, 0x0123);  // big-endian
      if (w == 0 || w == words - 1) {
        atomicOr(&row[gw], val);  // shared with the neighbouring entry
      } else {
        row[gw] = val;  // owned by this entry alone
      }
    }
    __syncwarp();  // wbuf is reused by the next entry
  }
}

// CTAs a grid row (one image) of warps_of_work entries: at most 16 CTAs an
// SM over all images, at least one a row.
int grid_for(int warps_of_work, int images) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    sms = 132;
  }
  const int ctas = (warps_of_work + kWarps - 1) / kWarps;
  const int cap = 16 * sms / images > 1 ? 16 * sms / images : 1;
  return ctas < cap ? ctas : cap;
}

}  // namespace

// z: (num_entries, 64) int16 scan entries, raw DC in slot 0, 4-byte aligned:
// num_entries / per_image images, each cut into n_int = ceil(per_image /
// epi) intervals of epi entries (a multiple of the MCU's hv + 2 blocks);
// entries at an image's index >= live_entries (clamped to [0, per_image] by
// the caller) emit nothing. init_dc: 3 int32 DC predictors (Y, Cb, Cr) of
// every interval's first entries. dc_lut, ac_lut: (2, 256) int32 packed
// tables (row 0 luma, row 1 chroma) for image 0, image i's lut_stride * i
// ints further on. Scratch: entry_bits (num_entries int32), tile_sums
// (ceil(num_entries / 4096) int32), total_bits (1 int32). Outputs:
// interval_bits (one int32 per row), out (num_words u32 per row,
// byte-swapped big-endian words). Returns the first cudaError_t met (0 on
// success).
extern "C" int jt_entropy_encode(const int16_t* z, int num_entries,
                                 int per_image, int epi, int live_entries,
                                 int hv, const int* init_dc, const int* dc_lut,
                                 const int* ac_lut, int lut_stride,
                                 int* entry_bits, int* tile_sums,
                                 int* total_bits, int* interval_bits,
                                 uint32_t* out, int num_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_entries <= 0 || per_image <= 0 || epi <= 0 ||
      num_entries % per_image != 0 || num_entries / per_image > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int images = num_entries / per_image;
  const int n_int = (per_image + epi - 1) / epi;
  const int num_rows = images * n_int;
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(uint32_t) * num_words * static_cast<size_t>(num_rows),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_for(per_image, images), images);
  const int num_tiles = (num_entries + kScanTile - 1) / kScanTile;
  count_kernel<<<grid, kThreads, 0, st>>>(z, per_image, epi, live_entries, hv,
                                          init_dc, dc_lut, ac_lut, lut_stride,
                                          entry_bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<<<num_tiles, kScanThreads, 0, st>>>(entry_bits,
                                                        num_entries, tile_sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_tile_sums_kernel<<<1, kScanThreads, 0, st>>>(tile_sums, num_tiles,
                                                    total_bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  interval_bits_kernel<<<(num_rows + 255) / 256, 256, 0, st>>>(
      entry_bits, tile_sums, total_bits, num_entries, per_image, epi, n_int,
      num_rows, interval_bits);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (live_entries == 0) return 0;
  write_kernel<<<dim3(grid_for(live_entries, images), images), kThreads, 0,
                 st>>>(z, per_image, epi, n_int, live_entries, hv, init_dc,
                       dc_lut, ac_lut, lut_stride, entry_bits, tile_sums, out,
                       num_words);
  return static_cast<int>(cudaGetLastError());
}

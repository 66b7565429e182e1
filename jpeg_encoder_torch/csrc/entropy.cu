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
// Rows. The entries are cut into rows, each coded on its own from bit 0
// into its own num_words words: a restart interval (the TPU kernel vmapped
// over them; entries_per_interval entries, whole MCUs, the last interval
// of an image may be short) or, for the unbroken scan, the whole image. A
// batch (the TPU kernel vmapped over images) holds B images of
// entries_per_image (E) entries each; the intervals restart at every
// image, so local entry l of image i lies in row i * n_int + l / epi, with
// n_int = ceil(E / epi). A row's DC predictors start at init_dc (0 for a
// restart-framed scan or a batch), interval_bits[row] is its true length,
// and an overflowing row drops its excess words and never spills into the
// next. Entries at an image's index >= live_entries emit nothing (a fully
// dead row reports 0). The Huffman tables of image i are dc_lut and ac_lut
// advanced by i * lut_stride ints (0: one pair for all).
//
// The TPU kernel carries the running bit offset from one grid step to the
// next because its grid runs in order. Hopper gives no such order; this
// kernel is one pass, a single-pass scan with decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA technical report, 2016):
//   * A CTA codes one tile of kTile consecutive entries of one image. It
//     takes the tile's index from an atomic counter, not from blockIdx, so
//     every tile it may wait on belongs to a CTA that is already running.
//   * It loads the tile's entries once, coalesced, into shared memory (and
//     the raw DCs of the few entries before the tile, which the first DC
//     predictors need). One thread an entry then finds the entry's row and
//     its DC difference, and each of the 4 warps symbolizes 16 entries once:
//     a lane codes two zigzag slots (the run bases from two ballots of the
//     nonzero slots) and keeps their codes in registers.
//   * The bit offsets are a prefix sum segmented at row starts. The CTA
//     scans its entries' lengths; if its first entry starts a row it needs
//     nothing from other tiles, else it publishes its sum and looks back
//     over its predecessors' published sums until it meets the tile that
//     holds the row's first entry (whose sum for the row is a prefix). A
//     tile that holds a row start publishes that row's prefix at once.
//   * The tile packs its bits in shared memory, one run of words per row
//     it touches (segment), at their final offsets within the row, then
//     stores whole big-endian words coalesced; only a segment's first and
//     last words, which it may share with the neighbouring tiles, go
//     through atomicOr (the bit ranges are disjoint, so the result does not
//     depend on the order). The CTA holding a row's last entry writes the
//     row's bit count.
// One launch therefore reads the coefficients once and runs one kernel,
// after one memset that zeroes the output rows, the tile status words and
// the tile counter (a single buffer from the wrapper).
//
// What bounds it on Hopper: the function moves few bytes (128 B of
// coefficients an entry in, a few bits of stream out), but its
// symbolization is integer, shuffle and table work, a warp an entry, and a
// tile's prefix waits on its predecessors. So each entry is symbolized
// once; a tile of 64 entries on 4 warps keeps the CTA small enough (80
// registers, 6 CTAs an SM) that every 1080p tile is resident at once; and
// the look-back reads 32 predecessors a step.
//
// Bit offsets are relative to the row and 64-bit: a tile's base offset in
// its row, the published tile sums and the row lengths are 64-bit, and only
// offsets inside a tile (at most 64 * 1755 bits) are int. A row may pass
// 2^31 bits. The one bound is num_words, a C int: the caller keeps a row's
// capacity below 2^31 words (kernels/entropy.py refuses more).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                  // entries a tile (one CTA)
constexpr int kPerWarp = kTile / kWarps;   // entries a warp symbolizes
constexpr int kHalo = 8;                   // raw DCs kept from before the tile
constexpr int kLutSize = 1024;  // dc luma, dc chroma, ac luma, ac chroma
// A tile's packed words: 64 slots of at most 32 bits an entry, plus at
// most two partial words a segment (at most kTile segments).
constexpr int kBufWords = kTile * 64 + 2 * kTile;
// Tile status words: a flag in bits 62-63, a 62-bit bit count below it.
constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;  // tile's sum
constexpr unsigned long long kPrefix = 2ull << kFlagShift;  // since row start
constexpr unsigned long long kCountMask = kAggregate - 1;

// Code of one slot: i is the zigzag position, v its value (slot 0: the DC
// difference), run_base the position of the previous nonzero (0 if none).
__device__ __forceinline__ void slot_code(int i, int v, int run_base,
                                          int last_nz, int chroma,
                                          const int* lut, uint32_t& bits,
                                          int& len) {
  if (i == 0 || v != 0) {
    const int bl = 32 - __clz(v < 0 ? -v : v);
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
  } else if (i <= last_nz && ((i - run_base) & 15) == 0) {  // ZRL
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

// The largest slot whose bit is set in m (bit k: slot 2k + parity), or 0.
__device__ __forceinline__ int last_slot(unsigned m, int parity) {
  return m ? 2 * (31 - __clz(m)) + parity : 0;
}

// One warp codes one entry (ent, in shared memory): lane codes slots
// 2*lane and 2*lane+1. dc: the entry's DC difference * 2 + chroma.
__device__ __forceinline__ void symbolize(const int16_t* ent, int dc,
                                          const int* lut, int lane,
                                          uint32_t& bits0, int& len0,
                                          uint32_t& bits1, int& len1) {
  const uint32_t pair = reinterpret_cast<const uint32_t*>(ent)[lane];
  const int chroma = dc & 1;
  const int v0 =
      lane == 0 ? dc >> 1 : static_cast<int16_t>(static_cast<uint16_t>(pair));
  const int v1 = static_cast<int16_t>(static_cast<uint16_t>(pair >> 16));
  // The nonzero AC slots, two ballots: bit k is slot 2k (even; the DC
  // slot excluded) or slot 2k + 1 (odd). A slot's run starts after the
  // last nonzero slot before it.
  const unsigned even = __ballot_sync(kFull, lane > 0 && v0 != 0);
  const unsigned odd = __ballot_sync(kFull, v1 != 0);
  const unsigned below = (1u << lane) - 1;
  const int odd_base = last_slot(odd & below, 1);
  const int base0 = max(last_slot(even & below, 0), odd_base);
  const int base1 = max(last_slot(even & (below | 1u << lane), 0), odd_base);
  const int last_nz = max(last_slot(even, 0), last_slot(odd, 1));
  slot_code(2 * lane, v0, base0, last_nz, chroma, lut, bits0, len0);
  slot_code(2 * lane + 1, v1, base1, last_nz, chroma, lut, bits1, len1);
}

// OR len MSB-first bits into buf at bit position pos (shared memory).
__device__ __forceinline__ void put_bits(uint32_t* buf, int pos,
                                         uint32_t bits, int len) {
  if (len == 0) return;
  const int w = pos >> 5;
  const int end = (pos & 31) + len;
  if (end <= 32) {
    atomicOr(&buf[w], bits << (32 - end));
  } else {
    atomicOr(&buf[w], bits >> (end - 32));
    atomicOr(&buf[w + 1], bits << (64 - end));
  }
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* status, int t) {
  return *reinterpret_cast<const volatile unsigned long long*>(status + t);
}

__device__ __forceinline__ void store_status(unsigned long long* status,
                                             int t, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(status + t) = v;
}

// Warp 0: the row-relative bit offset of the tile's first entry, from the
// statuses of tiles t - 1, t - 2, ... (32 a step, nearest first), which
// all belong to this tile's image: the walk ends at the nearest prefix,
// and the image's first tile publishes one.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, int t, int image_first_tile, int lane) {
  unsigned long long prefix = 0;
  for (int pred = t - 1;; pred -= 32) {
    const int idx = pred - lane;
    unsigned long long s = kPrefix;
    if (idx >= image_first_tile) {
      do {
        s = load_status(status, idx);
      } while ((s >> kFlagShift) == 0);
    }
    const unsigned is_prefix = __ballot_sync(kFull, (s >> kFlagShift) == 2);
    const int stop = is_prefix ? __ffs(is_prefix) - 1 : 31;
    unsigned long long v = lane <= stop ? s & kCountMask : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    prefix += v;
    if (is_prefix) return static_cast<long long>(prefix);
  }
}

__global__ void __launch_bounds__(kThreads)
entropy_kernel(const int16_t* __restrict__ z, int per_image, int epi,
               int live, int hv, const int* __restrict__ init_dc,
               const int* __restrict__ dc_lut, const int* __restrict__ ac_lut,
               int lut_stride, int tiles_per_image,
               long long* __restrict__ interval_bits,
               uint32_t* __restrict__ out,
               int num_words, unsigned long long* status,
               unsigned* __restrict__ counter) {
  __shared__ int lut[kLutSize];
  __shared__ __align__(16) int16_t ents[kTile][64];
  __shared__ int halo_dc[kHalo];
  __shared__ int dc_s[kTile];      // DC difference * 2 + chroma
  __shared__ int row_s[kTile];     // row << 2 | ends the row << 1 | starts it
  __shared__ int len_s[kTile];     // entry bit lengths
  __shared__ int pos_s[kTile];     // entry's first bit in buf
  __shared__ int seg_base[kTile + 1];  // segment's first word in buf, + end
  __shared__ long long seg_word[kTile];  // segment's first word in its row
  __shared__ int seg_row[kTile];
  __shared__ int meta[3];              // tile index, segments, words in buf
  __shared__ uint32_t buf[kBufWords];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) meta[0] = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int t = meta[0];
  const int image = t / tiles_per_image;
  const int first_local = (t % tiles_per_image) * kTile;
  const int n = min(kTile, per_image - first_local);        // entries
  const int n_live = max(0, min(n, live - first_local));    // live ones
  const size_t image_base = static_cast<size_t>(image) * per_image;
  const size_t first = image_base + first_local;
  const int n_int = (per_image + epi - 1) / epi;

  // Tables, the tile's live entries and the DCs before it.
  const int* dc = dc_lut + image * lut_stride;
  const int* ac = ac_lut + image * lut_stride;
  for (int i = threadIdx.x; i < kLutSize; i += kThreads) {
    lut[i] = i < 512 ? dc[i] : ac[i - 512];
  }
  if ((reinterpret_cast<uintptr_t>(z) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(z + first * 64);
    uint4* dst = reinterpret_cast<uint4*>(ents);
    for (int i = threadIdx.x; i < n_live * 8; i += kThreads) dst[i] = src[i];
  } else {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(z + first * 64);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ents);
    for (int i = threadIdx.x; i < n_live * 32; i += kThreads) dst[i] = src[i];
  }
  if (threadIdx.x < kHalo && n_live > 0) {
    const int l = first_local - kHalo + threadIdx.x;
    if (l >= 0) halo_dc[threadIdx.x] = z[(image_base + l) * 64];
  }
  __syncthreads();

  // One thread an entry: its row (index, and whether the entry starts or
  // ends it) and its DC difference along its component's predictor chain:
  // the previous entry of the component lies at a static distance, and a
  // chain's first entry in its row takes init_dc.
  if (threadIdx.x < n) {
    const int j = threadIdx.x, local = first_local + j;
    const int row = local / epi, row_first = row * epi;
    row_s[j] = (image * n_int + row) << 2 |
               (local + 1 == min(row_first + epi, per_image)) << 1 |
               (local == row_first);
    if (j < n_live) {
      const int bpm = hv + 2, pos = local % bpm;
      const int prev =
          local - (pos >= hv ? bpm : (pos == 0 ? bpm - hv + 1 : 1));
      int pred;
      if (prev < row_first) {
        pred = init_dc[pos < hv ? 0 : pos - hv + 1];
      } else if (prev >= first_local) {
        pred = ents[prev - first_local][0];
      } else {
        pred = halo_dc[prev - (first_local - kHalo)];
      }
      dc_s[j] = (ents[j][0] - pred) * 2 + (pos >= hv);
    }
  }
  __syncthreads();

  // Symbolize each live entry once; codes stay in registers.
  uint32_t code0[kPerWarp], code1[kPerWarp];
  int lens[kPerWarp];  // len0 | len1 << 6 | lane's offset in the entry << 12
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int j = warp + kWarps * i;
    lens[i] = 0;
    if (j < n_live) {  // warp-uniform
      int len0, len1;
      symbolize(ents[j], dc_s[j], lut, lane, code0[i], len0, code1[i], len1);
      const int bits = len0 + len1;
      int incl = bits;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      lens[i] = len0 | len1 << 6 | (incl - bits) << 12;
      if (lane == 31) len_s[j] = incl;
    } else if (lane == 0) {
      len_s[j] = 0;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // Segmented scan of the lengths at row starts: lane owns entries
    // 2 * lane and 2 * lane + 1 (none past n).
    const int j0 = 2 * lane, j1 = j0 + 1;
    const int L0 = j0 < n ? len_s[j0] : 0;
    const int L1 = j1 < n ? len_s[j1] : 0;
    const int r0 = j0 < n ? row_s[j0] : 0;  // row << 2 | ends << 1 | starts
    const int r1 = j1 < n ? row_s[j1] : 0;
    const bool f0 = r0 & 1, f1 = r1 & 1;
    bool f = f0 || f1;
    int v = f1 ? L1 : L0 + L1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const bool pf = __shfl_up_sync(kFull, f, off);
      const int pv = __shfl_up_sync(kFull, v, off);
      if (lane >= off) {
        if (!f) v += pv;
        f = f || pf;
      }
    }
    bool ef = __shfl_up_sync(kFull, f, 1);  // exclusive, before entry j0
    int ev = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) {
      ef = false;
      ev = 0;
    }
    const bool tile_has_start = __shfl_sync(kFull, f, 31);
    const int tile_sum = __shfl_sync(kFull, v, 31);  // since the last start
    const bool leading = !(row_s[0] & 1);  // entry 0 continues a row
    long long lead = 0;  // row offset of entry 0 when it continues a row
    const unsigned long long sum = static_cast<unsigned>(tile_sum);
    if (!leading || tile_has_start) {
      if (lane == 0) store_status(status, t, kPrefix | sum);
    } else if (lane == 0) {
      store_status(status, t, kAggregate | sum);
    }
    if (leading) {
      lead = look_back(status, t, image * tiles_per_image, lane);
      if (!tile_has_start && lane == 0) {
        store_status(status, t, kPrefix | (lead + sum));
      }
    }
    // Row offsets: entries before the tile's first row start continue the
    // leading row from `lead`; the others count from their row's start.
    const long long off0 = f0 ? 0 : (ef ? ev : lead + ev);
    const bool g1 = ef || f0;  // a row start at or before entry j0
    const int ex1 = f0 ? L0 : ev + L0;
    const long long off1 = f1 ? 0 : (g1 ? ex1 : lead + ex1);
    // Rows ending here report their length.
    if (r0 & 2) interval_bits[r0 >> 2] = off0 + L0;
    if (r1 & 2) interval_bits[r1 >> 2] = off1 + L1;
    // Segments: a new one starts at every row start after entry 0.
    const int s0 = (f0 && j0 > 0) ? 1 : 0;
    const int s1 = f1 ? 1 : 0;
    int seg_incl = s0 + s1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, seg_incl, off);
      if (lane >= off) seg_incl += u;
    }
    const int seg0 = seg_incl - s1;  // segment of entry j0
    const int seg1 = seg_incl;       // segment of entry j1
    // A segment ends at an entry followed by a row start or by the tile's
    // end; its bits run from its first entry's offset (0 at a row start,
    // `lead` for the leading row) to the end entry's offset plus length.
    const bool e0 = j0 < n && (j1 >= n || f1);
    const bool e1 = j1 < n && (j1 + 1 >= n || (r1 & 2));
    int words0 = 0, words1 = 0;
    long long start0 = 0, start1 = 0;
    if (e0) {
      start0 = (seg0 == 0 && leading) ? lead : 0;
      const long long end = off0 + L0;
      words0 = end > start0
                   ? static_cast<int>(((end + 31) >> 5) - (start0 >> 5))
                   : 0;
    }
    if (e1) {
      start1 = (seg1 == 0 && leading) ? lead : 0;
      const long long end = off1 + L1;
      words1 = end > start1
                   ? static_cast<int>(((end + 31) >> 5) - (start1 >> 5))
                   : 0;
    }
    int w_incl = words0 + words1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, w_incl, off);
      if (lane >= off) w_incl += u;
    }
    const int w_excl = w_incl - words0 - words1;
    if (e0) {
      seg_base[seg0] = w_excl;
      seg_word[seg0] = start0 >> 5;
      seg_row[seg0] = r0 >> 2;
    }
    if (e1) {
      seg_base[seg1] = w_excl + words0;
      seg_word[seg1] = start1 >> 5;
      seg_row[seg1] = r1 >> 2;
    }
    const int n_seg = __shfl_sync(kFull, seg_incl, 31) + 1;
    const int total = __shfl_sync(kFull, w_incl, 31);
    if (lane == 0) {
      seg_base[n_seg] = total;
      meta[1] = n_seg;
      meta[2] = total;
    }
    __syncwarp();
    // An entry's first bit in buf: small, though off and seg_word are not.
    if (j0 < n) {
      pos_s[j0] = seg_base[seg0] * 32 +
                  static_cast<int>(off0 - seg_word[seg0] * 32);
    }
    if (j1 < n) {
      pos_s[j1] = seg_base[seg1] * 32 +
                  static_cast<int>(off1 - seg_word[seg1] * 32);
    }
  } else {
    // Meanwhile the other warps clear the packing buffer.
    for (int i = threadIdx.x - 32; i < kBufWords; i += kThreads - 32) {
      buf[i] = 0;
    }
  }
  __syncthreads();

  // Pack every slot's code at its final place in buf.
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int j = warp + kWarps * i;
    if (j < n_live) {
      const int len0 = lens[i] & 63, len1 = (lens[i] >> 6) & 63;
      const int at = pos_s[j] + (lens[i] >> 12);
      put_bits(buf, at, code0[i], len0);
      put_bits(buf, at + len0, code1[i], len1);
    }
  }
  __syncthreads();

  // Store whole words, coalesced; a segment's end words are ORed.
  const int n_seg = meta[1], total = meta[2];
  for (int w = threadIdx.x; w < total; w += kThreads) {
    int lo = 0, hi = n_seg - 1;  // the last segment starting at or before w
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (seg_base[mid] <= w) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const long long gw = seg_word[lo] + (w - seg_base[lo]);
    if (gw >= num_words) continue;  // the row's capacity: dropped
    const uint32_t val = __byte_perm(buf[w], 0, 0x0123);  // big-endian
    uint32_t* dst = out + static_cast<size_t>(seg_row[lo]) * num_words + gw;
    if (w == seg_base[lo] || w == seg_base[lo + 1] - 1) {
      if (val) atomicOr(dst, val);  // shared with a neighbouring tile
    } else {
      *dst = val;  // owned by this tile alone
    }
  }
}

// Ints of the wrapper's buffer: the output rows, padding to an even index,
// an 8-byte status word a tile and the tile counter (kernels/entropy.py
// sizes it the same way).
long long buffer_ints(int images, int per_image, int epi, int num_words) {
  const long long rows =
      static_cast<long long>(images) * ((per_image + epi - 1) / epi);
  const long long out_ints = rows * num_words;
  const long long tiles =
      static_cast<long long>(images) * ((per_image + kTile - 1) / kTile);
  return out_ints + (out_ints & 1) + 2 * tiles + 2;
}

}  // namespace

// z: (num_entries, 64) int16 scan entries, raw DC in slot 0, 4-byte aligned:
// num_entries / per_image images, each cut into n_int = ceil(per_image /
// epi) rows of epi entries (a multiple of the MCU's hv + 2 blocks);
// entries at an image's index >= live (clamped to [0, per_image] by the
// caller) emit nothing. init_dc: 3 int32 DC predictors (Y, Cb, Cr) of every
// row's first entries. dc_lut, ac_lut: (2, 256) int32 packed tables (row 0
// luma, row 1 chroma) for image 0, image i's lut_stride * i ints further
// on. buffer: int32, the output rows (rows * num_words u32, byte-swapped
// big-endian words), then, from the next even index, one 8-byte status word
// per tile (ceil(per_image / 64) tiles an image) and the 4-byte tile
// counter (buffer_ints), all zeroed here by one memset.
// interval_bits: one int64 per row. Returns the first cudaError_t met (0 on
// success).
extern "C" int jt_entropy_encode(const int16_t* z, int num_entries,
                                 int per_image, int epi, int live, int hv,
                                 const int* init_dc, const int* dc_lut,
                                 const int* ac_lut, int lut_stride,
                                 long long* interval_bits, int32_t* buffer,
                                 int num_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_entries <= 0 || per_image <= 0 || epi <= 0 || num_words <= 0 ||
      num_entries % per_image != 0 || hv + 2 > kHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int images = num_entries / per_image;
  const int tiles_per_image = (per_image + kTile - 1) / kTile;
  const long long rows =
      static_cast<long long>(images) * ((per_image + epi - 1) / epi);
  const long long out_ints = rows * num_words;
  const long long status_at = out_ints + (out_ints & 1);
  const long long tiles = static_cast<long long>(images) * tiles_per_image;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      buffer, 0,
      sizeof(int32_t) *
          static_cast<size_t>(buffer_ints(images, per_image, epi, num_words)),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(buffer + status_at);
  unsigned* counter = reinterpret_cast<unsigned*>(status + tiles);
  entropy_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      z, per_image, epi, live, hv, init_dc, dc_lut, ac_lut, lut_stride,
      tiles_per_image, interval_bits, reinterpret_cast<uint32_t*>(buffer),
      num_words, status, counter);
  return static_cast<int>(cudaGetLastError());
}

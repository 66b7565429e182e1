// The program's front (kernel F1): a BMP file's stored rows, or an RGB
// array, in; the three zero-padded planes [Y, Cb, Cr] out, chroma
// subsampled.
//
// Replaces no TPU kernel. The JAX package runs the same function as plain
// XLA ops (jpeg_encoder_tpu/pipeline.py:251-254: rgb_to_ycbcr, pad_plane,
// subsample_plane), which XLA fuses into a few loops over the image. As
// separate torch ops (jpeg_encoder_torch/ops/front.py, this kernel's plain
// version) the same work is some forty kernels and hundreds of MB of int64
// and int32 intermediates at 4K; this kernel reads each input byte once and
// writes each output byte once.
//
// Function, for each image b of the batch and each pixel (r, x) of its
// (padded_height, padded_width) padded plane:
//
//   - the pixel is live if r < height, x < width and b * height + r <
//     live_rows (the band path's padding rows); a dead pixel is 0 in Y, Cb
//     and Cr (the reference's zero-filled planes), a live one converts its
//     R, G, B by the per-operation-rounded f32 chains of ops/color.py,
//       y  = (k0 r + k1 g) + k2 b
//       cb = ((128 - k3 r) - k4 g) + k5 b
//       cr = ((128 + k6 r) - k7 g) - k8 b
//     every product and sum rounded once (__fmul_rn, __fadd_rn, __fsub_rn,
//     and -fmad=false besides: these are the 256-entry tables' own values
//     and order), then truncated and clamped to [0, 255];
//   - Y is written at row b * padded_height + r;
//   - Cb and Cr: the integer floor mean of each h x v window of the padded
//     plane; window j = (r / v) * (padded_width / h) + x / h of image b is
//     element j of that image's (chroma_height, chroma_width) plane when j
//     < chroma_height * chroma_width, and is dropped otherwise. That is the
//     reference's push-order flatten and truncation (ops/sample.py,
//     oracle.subsample_plane), the dim % (8 * factor) == 1 quirk included.
//
// Input forms: RGB, (B, H, W, 3), row r of image b at src + b *
// image_pitch + r * row_pitch, channels R, G, B; or a BMP file's stored
// rows (bmp.Rows), (B, H, stride), bottom row first (image row r is stored
// row H - 1 - r), channels B, G, R, each row padded to 4 bytes.
//
// What bounds it on Hopper: by count, bytes (per pixel it reads 3 and
// writes 1 + 2 / (h v)); in practice the issue of its instructions, about
// 36 a pixel in the SASS of the unrolled row (9 products, 8 sums, 3 byte
// permutes and 3 subtractions for the inputs, 6 clamps, 3 adds toward
// zero, the packing and the window sums), as much time as its bytes take
// at the memory's rate. None of them runs on the conversion unit, which
// issues 16 results a clock on each SM against 128 adds: a u8 -> f32 or
// f32 -> u32 cast there would cost the issue time of 8 adds.
//
// Design.
//   - Conversions without the conversion unit, with the same roundings. A
//     byte c becomes a float as the bits 0x4B000000 | c (2^23 + c, one
//     byte permute of the staged word) minus 2^23, exactly. A channel value
//     x becomes its byte as clamp(x, 0, 255) + 2^23 rounded toward zero,
//     whose bits are 0x4B000000 + trunc(x): for every float this is the
//     plain version's truncate-then-clamp. Y's bytes are packed from those
//     words by byte permutes; a window's chroma sum adds the words, whose
//     low 24 bits are the sum of the bytes (0x4B000000 has none there).
//   - Loads overlapped with the work. The items (image, row of v image
//     rows, chunk of kThreads * kPx pixels) are dealt round-robin to a grid
//     of kCtasPerSm CTAs a streaming multiprocessor (the count the wrapper
//     passes: a fixed grid, whatever the shape, inside a CUDA graph too).
//     A CTA keeps kStages items' rows in a ring in shared memory: while it
//     converts one, cp.async brings the next ones. Each row's bytes of the
//     chunk arrive as the 16-byte granules of their 16-byte-aligned span,
//     whatever the row's alignment (a granule that holds one byte of the
//     tensor lies in the same page as that byte, so the copy cannot fault;
//     the bytes outside the row are never used).
//   - A thread converts kPx pixels of each of the v rows (16 where h is 2,
//     8 at 4:4:4, whose padded width is only a multiple of 8): it reads its
//     3 kPx bytes a row as aligned words of shared memory and funnel-shifts
//     them into place, writes its Y bytes in one store a row, sums its 8
//     windows in registers and writes them as one store each to Cb and Cr.
//     The padding (rows past the height, columns past the width, the rows
//     past live_rows) is written as zeros by the same threads: there is no
//     memset. One launch for the whole batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;     // items in a CTA's ring
constexpr int kCtasPerSm = 4;  // the grid: this many CTAs a multiprocessor

template <int H>
struct Shape {
  static constexpr int kPx = H == 2 ? 16 : 8;  // pixels a thread, a row
  static constexpr int kChunk = kThreads * kPx;  // pixels of an item's row
  // Bytes of one staged row: the chunk's pixels behind up to 15 bytes of
  // alignment, and the word read past the last thread's bytes.
  static constexpr int kRowBytes = 3 * kChunk + 32;
  static constexpr int kWords = 3 * kPx / 4;  // a thread's words of a row
  static_assert(kPx / H == 8, "a thread writes 8 bytes of Cb and of Cr");
};

// The nine f32 coefficients of the colour chains (ops/color.COEFFICIENTS,
// in the tables' row order), passed by value.
struct FrontParams {
  float k[9];
};

constexpr float kTwo23 = 8388608.0f;

// Byte k of w as a float, exactly: 0x4B0000 | w.byte[k] is 2^23 + byte.
__device__ __forceinline__ float byte_value(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + k)),
                   kTwo23);
}

// A word whose low byte is trunc(x) clamped to [0, 255], and whose low 24
// bits hold nothing else.
__device__ __forceinline__ uint32_t u8_word(float x) {
  return __float_as_uint(__fadd_rz(fminf(fmaxf(x, 0.0f), 255.0f), kTwo23));
}

// The low bytes of a, b, c, d as one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ void copy16_async(void* to, const void* from) {
  const unsigned shared =
      static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared),
               "l"(from)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n / d for 0 <= n < 2^31 as a multiply and a shift (Granlund and
// Montgomery's division by invariant integers: with l = ceil(log2 d), mul
// = ceil(2^(31 + l) / d) < 2^32): a division by a value known only at run
// time would otherwise go through the conversion unit (I2F, F2I).
struct Divisor {
  int d;
  unsigned mul;
  int shift;
  static Divisor of(int d) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    const unsigned long long pow = 1ULL << (31 + l);
    return {d, static_cast<unsigned>((pow + d - 1) / d), 31 + l};
  }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>(
        (static_cast<unsigned long long>(n) * mul) >> shift);
  }
};

struct Geometry {
  const uint8_t* src;
  long long row_pitch, image_pitch;
  int width, height, padded_width, padded_height;
  long long chroma_elems, live_rows;
  Divisor chunks, window_rows;
};

// Item n: image b, row of windows ar, the chunk's first pixel cx0.
struct Item {
  int b, ar, cx0;
  __device__ Item(const Geometry& g, int n, int chunk) {
    const int row = g.chunks.div(n);
    cx0 = (n - row * g.chunks.d) * chunk;
    b = g.window_rows.div(row);
    ar = row - b * g.window_rows.d;
  }
};

// Whether image row ar * V + vv holds pixels of the chunk, and where its
// bytes of the chunk begin.
template <int V, bool kBmp>
__device__ __forceinline__ bool row_source(const Geometry& g, const Item& it,
                                           int vv, const uint8_t** first) {
  const int r = it.ar * V + vv;
  if (r >= g.height || it.cx0 >= g.width ||
      static_cast<long long>(it.b) * g.height + r >= g.live_rows)
    return false;
  const int stored = kBmp ? g.height - 1 - r : r;
  *first = g.src + it.b * g.image_pitch + stored * g.row_pitch + 3 * it.cx0;
  return true;
}

// Start the copies of item it's live rows into one stage of the ring.
template <int H, int V, bool kBmp>
__device__ __forceinline__ void stage_item(const Geometry& g, const Item& it,
                                           uint8_t* stage) {
  using S = Shape<H>;
  const int px_end = min(g.width, it.cx0 + S::kChunk);
#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    const uint8_t* first;
    if (!row_source<V, kBmp>(g, it, vv, &first)) continue;
    const uintptr_t start = reinterpret_cast<uintptr_t>(first);
    const uintptr_t base = start & ~static_cast<uintptr_t>(15);
    const uintptr_t last = start + 3 * (px_end - it.cx0);
    const int pieces = static_cast<int>((last - base + 15) >> 4);
    const uint8_t* from = reinterpret_cast<const uint8_t*>(base);
    uint8_t* to = stage + vv * S::kRowBytes;
    for (int i = threadIdx.x; i < pieces; i += kThreads)
      copy16_async(to + 16 * i, from + 16 * i);
  }
}

// Convert `live` pixels of one row from px, this thread's 3 kPx bytes of
// it: each pixel's Y word into ybyte, its Cb and Cr words added to its
// window's sums. The pixels past `live` (past the width) stay 0.
template <int H, bool kBmp>
__device__ __forceinline__ void convert_row(
    const uint32_t* px, int live, const FrontParams& p, uint32_t* ybyte,
    uint32_t* cb_sum, uint32_t* cr_sum) {
  constexpr int kR = kBmp ? 2 : 0, kB = kBmp ? 0 : 2;
#pragma unroll
  for (int k = 0; k < Shape<H>::kPx; ++k) {
    if (k >= live) break;
    const float r = byte_value(px[(3 * k + kR) / 4], (3 * k + kR) % 4);
    const float gr = byte_value(px[(3 * k + 1) / 4], (3 * k + 1) % 4);
    const float bl = byte_value(px[(3 * k + kB) / 4], (3 * k + kB) % 4);
    const float yv = __fadd_rn(
        __fadd_rn(__fmul_rn(p.k[0], r), __fmul_rn(p.k[1], gr)),
        __fmul_rn(p.k[2], bl));
    const float cbv = __fadd_rn(
        __fsub_rn(__fsub_rn(128.0f, __fmul_rn(p.k[3], r)),
                  __fmul_rn(p.k[4], gr)),
        __fmul_rn(p.k[5], bl));
    const float crv = __fsub_rn(
        __fsub_rn(__fadd_rn(128.0f, __fmul_rn(p.k[6], r)),
                  __fmul_rn(p.k[7], gr)),
        __fmul_rn(p.k[8], bl));
    ybyte[k] = u8_word(yv);
    cb_sum[k / H] += u8_word(cbv);
    cr_sum[k / H] += u8_word(crv);
  }
}

// Convert this thread's pixels of item it from its stage of the ring and
// store them.
template <int H, int V, bool kBmp>
__device__ __forceinline__ void convert_item(
    const Geometry& g, const Item& it, const uint8_t* stage,
    const FrontParams& p, uint8_t* __restrict__ y_out,
    uint8_t* __restrict__ cb_out, uint8_t* __restrict__ cr_out) {
  using S = Shape<H>;
  constexpr int kPx = S::kPx;
  const int x0 = it.cx0 + kPx * threadIdx.x;
  if (x0 >= g.padded_width) return;
  uint32_t cb_sum[8], cr_sum[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) cb_sum[w] = cr_sum[w] = 0;

#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    uint32_t ybyte[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) ybyte[k] = 0;
    const uint8_t* first;
    if (row_source<V, kBmp>(g, it, vv, &first) && x0 < g.width) {
      // This thread's 3 kPx bytes of the row, as kWords words.
      const int start = static_cast<int>(
          reinterpret_cast<uintptr_t>(first) & 15) + 3 * (x0 - it.cx0);
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(stage + vv * S::kRowBytes) +
          (start >> 2);
      const int shift = 8 * (start & 3);
      uint32_t raw[S::kWords + 1], px[S::kWords];
#pragma unroll
      for (int i = 0; i <= S::kWords; ++i) raw[i] = words[i];
#pragma unroll
      for (int i = 0; i < S::kWords; ++i)
        px[i] = __funnelshift_r(raw[i], raw[i + 1], shift);
      if (g.width - x0 >= kPx)  // the common case, with no test a pixel
        convert_row<H, kBmp>(px, kPx, p, ybyte, cb_sum, cr_sum);
      else
        convert_row<H, kBmp>(px, g.width - x0, p, ybyte, cb_sum, cr_sum);
    }
    uint8_t* y_row =
        y_out + (static_cast<size_t>(it.b) * g.padded_height + it.ar * V +
                 vv) * g.padded_width + x0;
    const uint32_t lo = pack4(ybyte[0], ybyte[1], ybyte[2], ybyte[3]);
    const uint32_t hi = pack4(ybyte[4], ybyte[5], ybyte[6], ybyte[7]);
    if constexpr (kPx == 16) {
      *reinterpret_cast<uint4*>(y_row) = make_uint4(
          lo, hi, pack4(ybyte[8], ybyte[9], ybyte[10], ybyte[11]),
          pack4(ybyte[12], ybyte[13], ybyte[14], ybyte[15]));
    } else {
      *reinterpret_cast<uint2*>(y_row) = make_uint2(lo, hi);
    }
  }

  // This thread's 8 windows are elements j0 .. j0 + 7 of image b's chroma
  // planes; j0 and the plane's size are multiples of 8, so they are all
  // inside it or all past it.
  const long long j0 =
      static_cast<long long>(it.ar) * (g.padded_width / H) + x0 / H;
  if (j0 >= g.chroma_elems) return;
  // The mean's floor: the low 24 bits of a sum are the bytes' sum, under
  // 2^10, so the shifted word's low byte is the quotient.
  constexpr int kLog = (H == 2) + (V == 2);
  uint32_t cb_w[2], cr_w[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    cb_w[q] = pack4(cb_sum[4 * q] >> kLog, cb_sum[4 * q + 1] >> kLog,
                    cb_sum[4 * q + 2] >> kLog, cb_sum[4 * q + 3] >> kLog);
    cr_w[q] = pack4(cr_sum[4 * q] >> kLog, cr_sum[4 * q + 1] >> kLog,
                    cr_sum[4 * q + 2] >> kLog, cr_sum[4 * q + 3] >> kLog);
  }
  const size_t at = static_cast<size_t>(it.b) * g.chroma_elems + j0;
  *reinterpret_cast<uint2*>(cb_out + at) = make_uint2(cb_w[0], cb_w[1]);
  *reinterpret_cast<uint2*>(cr_out + at) = make_uint2(cr_w[0], cr_w[1]);
}

template <int H, int V, bool kBmp>
__global__ void __launch_bounds__(kThreads)
front_kernel(Geometry g, int items, FrontParams p, uint8_t* __restrict__ y_out,
             uint8_t* __restrict__ cb_out, uint8_t* __restrict__ cr_out) {
  using S = Shape<H>;
  __shared__ __align__(16) uint8_t ring[kStages][V * S::kRowBytes];

  // The ring: item n of this CTA is in stage n % kStages. Before item n is
  // converted its copy group is complete (wait_copies), and the barrier
  // after it makes every thread's copies visible and frees the stage of
  // item n - 1, which takes item n + kStages - 1.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int n = blockIdx.x + s * gridDim.x;
    if (n < items)
      stage_item<H, V, kBmp>(g, Item(g, n, S::kChunk), ring[s]);
    commit_copies();
  }
  int slot = 0;
  for (int n = blockIdx.x; n < items; n += gridDim.x) {
    wait_copies<kStages - 2>();
    __syncthreads();
    const int ahead = n + (kStages - 1) * gridDim.x;
    if (ahead < items)
      stage_item<H, V, kBmp>(g, Item(g, ahead, S::kChunk),
                             ring[slot == 0 ? kStages - 1 : slot - 1]);
    commit_copies();
    convert_item<H, V, kBmp>(g, Item(g, n, S::kChunk), ring[slot], p, y_out,
                             cb_out, cr_out);
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
}

template <int H, int V, bool kBmp>
cudaError_t launch(Geometry g, int batch, int sm_count, const FrontParams& p,
                   uint8_t* y, uint8_t* cb, uint8_t* cr,
                   cudaStream_t stream) {
  g.chunks = Divisor::of((g.padded_width + Shape<H>::kChunk - 1) /
                         Shape<H>::kChunk);
  g.window_rows = Divisor::of(g.padded_height / V);
  const long long items =
      static_cast<long long>(batch) * g.window_rows.d * g.chunks.d;
  if (items > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const long long ctas = static_cast<long long>(sm_count) * kCtasPerSm;
  front_kernel<H, V, kBmp>
      <<<static_cast<unsigned>(items < ctas ? items : ctas), kThreads, 0,
         stream>>>(g, static_cast<int>(items), p, y, cb, cr);
  return cudaGetLastError();
}

template <bool kBmp>
cudaError_t dispatch(int h, int v, const Geometry& g, int batch,
                     int sm_count, const FrontParams& p, uint8_t* y,
                     uint8_t* cb, uint8_t* cr, cudaStream_t stream) {
#define JT_FRONT(HH, VV)        \
  if (h == HH && v == VV)       \
    return launch<HH, VV, kBmp>(g, batch, sm_count, p, y, cb, cr, stream);
  JT_FRONT(1, 1)
  JT_FRONT(2, 1)
  JT_FRONT(2, 2)
  JT_FRONT(1, 2)
#undef JT_FRONT
  return cudaErrorInvalidValue;
}

}  // namespace

// src: the batch's RGB images or stored BMP rows on the card (bmp 0 or 1),
// row_pitch and image_pitch in bytes; width x height pixels an image, h
// and v the chroma factors (1 or 2), padded_width x padded_height the
// padded plane (padded_width a multiple of 8 h, padded_height of 8 v),
// chroma_elems = chroma_height * chroma_width (a multiple of 64), rows at
// or past live_rows (over the batch's stacked image rows) zero. coeffs:
// the nine colour coefficients, in host memory. y: (batch * padded_height,
// padded_width), cb and cr: (batch * chroma_elems) bytes, each 16-byte
// aligned. sm_count: the card's streaming multiprocessors (the grid is
// kCtasPerSm CTAs each, or one a item where there are fewer items).
// Returns the launch's cudaError_t (0 on success).
extern "C" int jt_front_planes(const uint8_t* src, long long row_pitch,
                               long long image_pitch, int bmp, int batch,
                               int width, int height, int h, int v,
                               int padded_width, int padded_height,
                               long long chroma_elems, long long live_rows,
                               const float* coeffs, uint8_t* y, uint8_t* cb,
                               uint8_t* cr, int sm_count, void* stream) {
  if (batch == 0) return 0;
  if (sm_count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FrontParams p;
  for (int i = 0; i < 9; ++i) p.k[i] = coeffs[i];
  const Geometry g{src, row_pitch, image_pitch, width, height,
                   padded_width, padded_height, chroma_elems, live_rows,
                   {}, {}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bmp ? dispatch<true>(h, v, g, batch, sm_count, p, y, cb, cr, s)
          : dispatch<false>(h, v, g, batch, sm_count, p, y, cb, cr, s);
  return static_cast<int>(err);
}

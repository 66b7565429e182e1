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
// What bounds it on Hopper: bytes. Per pixel it reads 3 bytes and writes
// 1 + 2 / (h v); the arithmetic is ~25 f32 operations a pixel, under half
// the time of the bytes at the card's non-FMA issue rate.
//
// Design. A CTA takes one row of windows (v image rows) of one image over
// a chunk of kThreads * 8 pixels. Its threads copy the chunk's bytes of
// each live row into shared memory in 16-byte loads (every row, whatever
// its alignment: the loads cover the 16-byte-aligned span of the row's
// bytes; a 16-byte granule that holds one byte of the tensor lies in the
// same page as that byte, so the load cannot fault, and the bytes outside
// the row are never used). Then each thread converts 8 pixels of each of
// the v rows: it reads its 24 bytes a row as 7 aligned words of shared
// memory and funnel-shifts them into place, writes 8 Y bytes a row in one
// 8-byte store, sums its 8 / h windows in registers and writes 8 / h Cb
// and Cr bytes in one store each. The padding (rows past the height,
// columns past the width, the rows past live_rows) is written as zeros by
// the same threads: there is no memset. One launch for the whole batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // one thread per 8 pixels of a row
constexpr int kChunk = kThreads * 8;   // pixels of a row per CTA
// Bytes of one staged row: 3 * kChunk bytes of pixels behind up to 15 of
// alignment, and the word read past the last thread's 24 bytes.
constexpr int kRowBytes = 3 * kChunk + 32;

// The nine f32 coefficients of the colour chains (ops/color.COEFFICIENTS,
// in the tables' row order), passed by value.
struct FrontParams {
  float k[9];
};

__device__ __forceinline__ uint32_t to_u8(float x) {
  return static_cast<uint32_t>(fminf(fmaxf(truncf(x), 0.0f), 255.0f));
}

template <int H, int V, bool kBmp>
__global__ void __launch_bounds__(kThreads)
front_kernel(const uint8_t* __restrict__ src, long long row_pitch,
             long long image_pitch, int width, int height, int padded_width,
             int padded_height, long long chroma_elems, long long live_rows,
             FrontParams p, uint8_t* __restrict__ y_out,
             uint8_t* __restrict__ cb_out, uint8_t* __restrict__ cr_out) {
  __shared__ __align__(16) uint8_t staged[V][kRowBytes];

  const int window_rows = padded_height / V;
  const int b = blockIdx.x / window_rows;
  const int ar = blockIdx.x % window_rows;  // row of windows in image b
  const int cx0 = blockIdx.y * kChunk;      // first pixel of the chunk
  const int t = threadIdx.x;

  // Which of the v rows hold image pixels, and where each row's bytes of
  // the chunk begin in shared memory (0 .. 15).
  bool live[V];
  int offset[V];
  const int px_end = min(width, cx0 + kChunk);
#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    const int r = ar * V + vv;
    live[vv] = r < height &&
               static_cast<long long>(b) * height + r < live_rows;
    offset[vv] = 0;
    if (!live[vv] || cx0 >= width) continue;
    const int stored = kBmp ? height - 1 - r : r;
    const uint8_t* row = src + b * image_pitch + stored * row_pitch;
    const uintptr_t first = reinterpret_cast<uintptr_t>(row + 3 * cx0);
    const uintptr_t last = reinterpret_cast<uintptr_t>(row + 3 * px_end);
    const uintptr_t base = first & ~static_cast<uintptr_t>(15);
    offset[vv] = static_cast<int>(first - base);
    const int pieces = static_cast<int>((last - base + 15) >> 4);
    const uint4* from = reinterpret_cast<const uint4*>(base);
    uint4* to = reinterpret_cast<uint4*>(staged[vv]);
    for (int i = t; i < pieces; i += kThreads) to[i] = __ldg(from + i);
  }
  __syncthreads();

  const int x0 = cx0 + 8 * t;
  if (x0 >= padded_width) return;
  constexpr int kWindows = 8 / H;  // windows of this thread's 8 pixels
  uint32_t cb_sum[kWindows], cr_sum[kWindows];
#pragma unroll
  for (int w = 0; w < kWindows; ++w) cb_sum[w] = cr_sum[w] = 0;

#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    uint32_t yw[2] = {0, 0};
    if (live[vv] && x0 < width) {
      // This thread's 24 bytes of the row, as 6 words.
      const int start = offset[vv] + 3 * (x0 - cx0);
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(staged[vv]) + (start >> 2);
      const int shift = 8 * (start & 3);
      uint32_t raw[7], px[6];
#pragma unroll
      for (int i = 0; i < 7; ++i) raw[i] = words[i];
#pragma unroll
      for (int i = 0; i < 6; ++i)
        px[i] = __funnelshift_r(raw[i], raw[i + 1], shift);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (x0 + k >= width) continue;
        const uint32_t c0 = (px[(3 * k) / 4] >> (8 * ((3 * k) % 4))) & 0xFFu;
        const uint32_t c1 =
            (px[(3 * k + 1) / 4] >> (8 * ((3 * k + 1) % 4))) & 0xFFu;
        const uint32_t c2 =
            (px[(3 * k + 2) / 4] >> (8 * ((3 * k + 2) % 4))) & 0xFFu;
        const float r = static_cast<float>(kBmp ? c2 : c0);
        const float g = static_cast<float>(c1);
        const float bl = static_cast<float>(kBmp ? c0 : c2);
        const float yv = __fadd_rn(
            __fadd_rn(__fmul_rn(p.k[0], r), __fmul_rn(p.k[1], g)),
            __fmul_rn(p.k[2], bl));
        const float cbv = __fadd_rn(
            __fsub_rn(__fsub_rn(128.0f, __fmul_rn(p.k[3], r)),
                      __fmul_rn(p.k[4], g)),
            __fmul_rn(p.k[5], bl));
        const float crv = __fsub_rn(
            __fsub_rn(__fadd_rn(128.0f, __fmul_rn(p.k[6], r)),
                      __fmul_rn(p.k[7], g)),
            __fmul_rn(p.k[8], bl));
        yw[k / 4] |= to_u8(yv) << (8 * (k % 4));
        cb_sum[k / H] += to_u8(cbv);
        cr_sum[k / H] += to_u8(crv);
      }
    }
    const size_t y_row =
        static_cast<size_t>(b) * padded_height + ar * V + vv;
    *reinterpret_cast<uint2*>(y_out + y_row * padded_width + x0) =
        make_uint2(yw[0], yw[1]);
  }

  // This thread's windows are elements j0 .. j0 + 8 / h - 1 of image b's
  // chroma planes; j0 and the plane's size are multiples of 8 / h, so they
  // are all inside it or all past it.
  const long long j0 =
      static_cast<long long>(ar) * (padded_width / H) + x0 / H;
  if (j0 >= chroma_elems) return;
  uint32_t cb_w[2] = {0, 0}, cr_w[2] = {0, 0};
#pragma unroll
  for (int w = 0; w < kWindows; ++w) {
    cb_w[w / 4] |= (cb_sum[w] / (H * V)) << (8 * (w % 4));
    cr_w[w / 4] |= (cr_sum[w] / (H * V)) << (8 * (w % 4));
  }
  const size_t at = static_cast<size_t>(b) * chroma_elems + j0;
  if (kWindows == 8) {
    *reinterpret_cast<uint2*>(cb_out + at) = make_uint2(cb_w[0], cb_w[1]);
    *reinterpret_cast<uint2*>(cr_out + at) = make_uint2(cr_w[0], cr_w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(cb_out + at) = cb_w[0];
    *reinterpret_cast<uint32_t*>(cr_out + at) = cr_w[0];
  }
}

template <int H, int V, bool kBmp>
cudaError_t launch(const uint8_t* src, long long row_pitch,
                   long long image_pitch, int batch, int width, int height,
                   int padded_width, int padded_height,
                   long long chroma_elems, long long live_rows,
                   const FrontParams& p, uint8_t* y, uint8_t* cb, uint8_t* cr,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch) * (padded_height / V),
                  (padded_width + kChunk - 1) / kChunk);
  front_kernel<H, V, kBmp><<<grid, kThreads, 0, stream>>>(
      src, row_pitch, image_pitch, width, height, padded_width,
      padded_height, chroma_elems, live_rows, p, y, cb, cr);
  return cudaGetLastError();
}

template <bool kBmp>
cudaError_t dispatch(int h, int v, const uint8_t* src, long long row_pitch,
                     long long image_pitch, int batch, int width, int height,
                     int padded_width, int padded_height,
                     long long chroma_elems, long long live_rows,
                     const FrontParams& p, uint8_t* y, uint8_t* cb,
                     uint8_t* cr, cudaStream_t stream) {
#define JT_FRONT(HH, VV)                                                     \
  if (h == HH && v == VV)                                                  \
    return launch<HH, VV, kBmp>(src, row_pitch, image_pitch, batch, width, \
                                height, padded_width, padded_height,       \
                                chroma_elems, live_rows, p, y, cb, cr,     \
                                stream);
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
// padded_width), cb and cr: (batch * chroma_elems) bytes, each 8-byte
// aligned. Returns the launch's cudaError_t (0 on success).
extern "C" int jt_front_planes(const uint8_t* src, long long row_pitch,
                               long long image_pitch, int bmp, int batch,
                               int width, int height, int h, int v,
                               int padded_width, int padded_height,
                               long long chroma_elems, long long live_rows,
                               const float* coeffs, uint8_t* y, uint8_t* cb,
                               uint8_t* cr, void* stream) {
  if (batch == 0) return 0;
  FrontParams p;
  for (int i = 0; i < 9; ++i) p.k[i] = coeffs[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bmp ? dispatch<true>(h, v, src, row_pitch, image_pitch, batch, width,
                           height, padded_width, padded_height,
                           chroma_elems, live_rows, p, y, cb, cr, s)
          : dispatch<false>(h, v, src, row_pitch, image_pitch, batch, width,
                            height, padded_width, padded_height,
                            chroma_elems, live_rows, p, y, cb, cr, s);
  return static_cast<int>(err);
}

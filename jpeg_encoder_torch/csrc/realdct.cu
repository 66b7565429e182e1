// RealDCT + quantization + zigzag for three padded u8 planes (kernel K1).
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/dct_pallas.py::real_dct_quant_planes_zigzag_pallas_t
// (fast=False, body _realdct_t_planes_chain). Same function: for every 8x8
// block of [Y | Cb | Cr], in the reference's exact float32 order,
//
//     acc = acc + ((px[k] - 128) * a_steps[k][j]) * b_steps[k][j],  k = 0..63
//     out[j] = (int16) trunc((scale[j] * acc) / q[j])
//
// where j is the zigzag output position and q is the luma row for blocks
// below ny, the chroma row otherwise. Every multiply and add rounds once
// (__fmul_rn / __fadd_rn, and the build passes -fmad=false besides), and the
// divide is a true round-to-nearest f32 divide (__fdiv_rn), never a
// reciprocal multiply: the quantized coefficients must be bit-identical to
// the plain chain (jpeg_encoder_torch/ops/dct.py).
//
// The TPU layout is not carried over: no packed (16, N) transpose, no
// rows/cols output form. One thread owns one zigzag coefficient j and keeps
// its 64 a/b factors in registers; a CTA walks groups of 8x8 blocks read
// straight from the planes into shared memory (each thread loads one pixel),
// and each warp then reads pixel k as a shared-memory broadcast.
//
// What bounds it on Hopper: 192 f32 operations per output coefficient
// (64 steps of two multiplies and an add) against 1 byte read and 2 bytes
// written, so it is compute-bound on the FP32 pipes, and fused multiply-adds
// (which would halve the instruction count) are forbidden by the exactness
// contract.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocksPerGroup = 4;           // 8x8 blocks per CTA iteration
constexpr int kThreads = 64 * kBlocksPerGroup;

__global__ void __launch_bounds__(kThreads)
realdct_planes_kernel(const uint8_t* __restrict__ y, int y_width, int ny,
                      const uint8_t* __restrict__ cb,
                      const uint8_t* __restrict__ cr, int c_width, int nc,
                      const float* __restrict__ a_steps,
                      const float* __restrict__ b_steps,
                      const float* __restrict__ scale,
                      const float* __restrict__ q_luma,
                      const float* __restrict__ q_chroma,
                      int16_t* __restrict__ out) {
  __shared__ float px[kBlocksPerGroup][64];
  const int j = threadIdx.x & 63;  // zigzag coefficient owned by this thread
  const int s = threadIdx.x >> 6;  // block slot within the group
  const int n_total = ny + 2 * nc;

  float a[64], b[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    a[k] = a_steps[k * 64 + j];
    b[k] = b_steps[k * 64 + j];
  }
  const float sc = scale[j];
  const float ql = q_luma[j];
  const float qc = q_chroma[j];

  const int groups = (n_total + kBlocksPerGroup - 1) / kBlocksPerGroup;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int n = g * kBlocksPerGroup + s;
    float v = 0.0f;
    if (n < n_total) {
      // This thread loads pixel (x, y) = (j / 8, j % 8) of block n.
      const uint8_t* plane;
      int width, local;
      if (n < ny) {
        plane = y; width = y_width; local = n;
      } else if (n < ny + nc) {
        plane = cb; width = c_width; local = n - ny;
      } else {
        plane = cr; width = c_width; local = n - ny - nc;
      }
      const int blocks_x = width >> 3;
      const int row = (local / blocks_x) * 8 + (j >> 3);
      const int col = (local % blocks_x) * 8 + (j & 7);
      v = static_cast<float>(plane[static_cast<size_t>(row) * width + col]) -
          128.0f;  // exact: an integer in [-128, 127]
    }
    px[s][j] = v;
    __syncthreads();
    if (n < n_total) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 64; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(px[s][k], a[k]), b[k]));
      }
      const float q = n < ny ? ql : qc;
      const float c = __fdiv_rn(__fmul_rn(sc, acc), q);
      out[static_cast<size_t>(n) * 64 + j] = static_cast<int16_t>(truncf(c));
    }
    __syncthreads();
  }
}

}  // namespace

// Planes: y (ny blocks, y_width wide), cb and cr (nc blocks each, c_width
// wide), all padded to multiples of 8. out: (ny + 2 nc, 64) int16, zigzag.
// Returns the launch's cudaError_t (0 on success).
extern "C" int jt_realdct_planes(const uint8_t* y, int y_width, int ny,
                                 const uint8_t* cb, const uint8_t* cr,
                                 int c_width, int nc, const float* a_steps,
                                 const float* b_steps, const float* scale,
                                 const float* q_luma, const float* q_chroma,
                                 int16_t* out, void* stream) {
  const int n_total = ny + 2 * nc;
  if (n_total == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_total + kBlocksPerGroup - 1) / kBlocksPerGroup;
  const int grid = groups < 8 * sms ? groups : 8 * sms;
  realdct_planes_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      y, y_width, ny, cb, cr, c_width, nc, a_steps, b_steps, scale, q_luma,
      q_chroma, out);
  return static_cast<int>(cudaGetLastError());
}

// --fast-dct RealDCT + quantization + zigzag for three padded u8 planes
// (kernel K2).
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/dct_pallas.py::real_dct_quant_planes_zigzag_pallas_t
// with fast=True (body _realdct_t_planes_fast_chain). Same function: for
// every 8x8 block of [Y | Cb | Cr], with px[k] its level-shifted pixels
// (k = row * 8 + column),
//
//     out[j] = (int16) trunc((sum_k K_zz[j][k] * px[k]) / q[j])
//
// where K_zz is the (64, 64) f32 Kronecker DCT basis with the scale folded in
// and rows in zigzag order (constants.fast_kron_zigzag), and q is the luma
// row for blocks below ny, the chroma row otherwise. The divide is a true
// f32 divide (__fdiv_rn). The sum is a float32 product in this kernel's own
// order, with explicit fused multiply-adds (__fmaf_rn; the build's
// -fmad=false only stops the compiler from forming them): --fast-dct is not
// bit-exact by contract (EncoderConfig.fast_dct), so it is held to max |diff|
// 1 against the plain version and against the exact kernel K1, at mismatch
// rates below 1e-3 and 5e-4.
//
// The TPU kernel's 3-term bf16 split on the MXU is not carried over (a
// tensor-core version is later work). This one computes the product on the
// FP32 pipes: a CTA stages K_zz transposed (16 KB) once and then walks groups
// of 32 blocks, whose pixels it reads straight from the planes into shared
// memory as floats (px[k][slot]: a warp of loaders fills one row of 32 slots
// without bank conflicts). Thread (j, g) owns coefficient j of the 8 blocks
// g*8..g*8+7 of the group: for each k it reads K_zz[j][k] once (a warp reads
// 32 consecutive j) and the 8 pixels as two broadcast float4 loads, and does 8
// multiply-adds.
//
// What bounds it on Hopper: FP32 issue. 64 multiply-adds per coefficient,
// 401 MFLOP at 1920x1080 4:2:0, 6 us at the published 67 TFLOP/s, against
// 9.4 MB of traffic (under 3 us at 3.35 TB/s); three shared-memory loads per
// 8 multiply-adds keep it off that bound by a small factor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocks = 32;                        // 8x8 blocks per iteration
constexpr int kThreads = 256;                      // 64 coefficients x 4
constexpr int kPerThread = kBlocks * 64 / kThreads;  // blocks a thread: 8

__global__ void __launch_bounds__(kThreads)
fastdct_planes_kernel(const uint8_t* __restrict__ y, int y_width, int ny,
                      const uint8_t* __restrict__ cb,
                      const uint8_t* __restrict__ cr, int c_width, int nc,
                      const float* __restrict__ kzz,
                      const float* __restrict__ q_luma,
                      const float* __restrict__ q_chroma,
                      int16_t* __restrict__ out) {
  __shared__ float kt[64][64];                          // kt[k][j] = K_zz[j][k]
  __shared__ __align__(16) float px[64][kBlocks];       // px[k][slot]
  const int j = threadIdx.x & 63;   // coefficient (zigzag position)
  const int g = threadIdx.x >> 6;   // block slots g*8 .. g*8+7
  for (int t = threadIdx.x; t < 64 * 64; t += kThreads) {
    kt[t >> 6][t & 63] = kzz[(t & 63) * 64 + (t >> 6)];
  }
  const float ql = q_luma[j];
  const float qc = q_chroma[j];
  const int n_total = ny + 2 * nc;
  const int groups = (n_total + kBlocks - 1) / kBlocks;
  // Loader role: block slot s, pixel row r.
  const int s = threadIdx.x & (kBlocks - 1);
  const int r = threadIdx.x / kBlocks;

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int n0 = grp * kBlocks;
    {
      const int n = n0 + s;
      uint2 p = make_uint2(0u, 0u);
      if (n < n_total) {
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
        const size_t row = static_cast<size_t>(local / blocks_x) * 8 + r;
        p = *reinterpret_cast<const uint2*>(plane + row * width +
                                            (local % blocks_x) * 8);
      }
      __syncthreads();  // the previous group's reads of px are done
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        px[r * 8 + c][s] = static_cast<float>((p.x >> (8 * c)) & 0xFFu) - 128.0f;
        px[r * 8 + c + 4][s] =
            static_cast<float>((p.y >> (8 * c)) & 0xFFu) - 128.0f;
      }
      __syncthreads();  // px (and, the first time, kt) are complete
    }
    float acc[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[i] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < 64; ++k) {
      const float kv = kt[k][j];
      const float4 a = *reinterpret_cast<const float4*>(&px[k][g * kPerThread]);
      const float4 b =
          *reinterpret_cast<const float4*>(&px[k][g * kPerThread + 4]);
      acc[0] = __fmaf_rn(kv, a.x, acc[0]);
      acc[1] = __fmaf_rn(kv, a.y, acc[1]);
      acc[2] = __fmaf_rn(kv, a.z, acc[2]);
      acc[3] = __fmaf_rn(kv, a.w, acc[3]);
      acc[4] = __fmaf_rn(kv, b.x, acc[4]);
      acc[5] = __fmaf_rn(kv, b.y, acc[5]);
      acc[6] = __fmaf_rn(kv, b.z, acc[6]);
      acc[7] = __fmaf_rn(kv, b.w, acc[7]);
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int n = n0 + g * kPerThread + i;
      if (n < n_total) {
        const float c = __fdiv_rn(acc[i], n < ny ? ql : qc);
        out[static_cast<size_t>(n) * 64 + j] =
            static_cast<int16_t>(static_cast<int>(truncf(c)));
      }
    }
  }
}

}  // namespace

// Planes: y (ny blocks, y_width wide), cb and cr (nc blocks each, c_width
// wide), all padded to multiples of 8 and 8-byte aligned. kzz: (64, 64) f32
// row-major K_zz[j][k]. q_luma, q_chroma: (64,) f32 zigzag rows. out:
// (ny + 2 nc, 64) int16, zigzag. Returns the launch's cudaError_t.
extern "C" int jt_fastdct_planes(const uint8_t* y, int y_width, int ny,
                                 const uint8_t* cb, const uint8_t* cr,
                                 int c_width, int nc, const float* kzz,
                                 const float* q_luma, const float* q_chroma,
                                 int16_t* out, void* stream) {
  const int n_total = ny + 2 * nc;
  if (n_total == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_total + kBlocks - 1) / kBlocks;
  const int grid = groups < 4 * sms ? groups : 4 * sms;
  fastdct_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_width, ny, cb, cr, c_width, nc, kzz, q_luma, q_chroma, out);
  return static_cast<int>(cudaGetLastError());
}

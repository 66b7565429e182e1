// binDCT-C + quantization + zigzag for three padded u8 planes (kernel K3).
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/dct_pallas.py::bin_dct_quant_planes_zigzag_pallas_t
// (body _bindct_t_planes_kernel, lifting network _lift8_rows). Same function:
// for every 8x8 block of [Y | Cb | Cr], shift the pixels to int32 x - 128,
// run the 8-point all-lifting binDCT-C along each block row and then along
// each column (int32, arithmetic >>, as the reference's dct_quant.rs:84-129),
// and quantize each coefficient at zigzag position j:
//
//     bug-parity (descale = 0): out[j] = x / q[j]
//         C's integer `/` truncates toward zero, which is exactly the
//         reference's sign(x) * (|x| // q);
//     descale    (descale = 1): out[j] = trunc((x * g[j]) / q[j])
//         in float32, each operation rounded once (__fmul_rn, __fdiv_rn;
//         never x * (g / q), never a reciprocal multiply);
//
// stored as int16, with q the luma row for blocks below ny and the chroma
// row otherwise. The result must equal the plain version
// (jpeg_encoder_torch/ops/dct.py::bin_dct_quant_planes_zigzag) bit for bit.
//
// The TPU's packed (16, N) transposed layout is not carried over. One thread
// owns one 8x8 block: it reads its eight rows as 8-byte loads straight from
// the plane (neighbouring threads own neighbouring blocks, so a warp reads
// 256 contiguous bytes of each pixel row), runs the 16 lifts in registers,
// quantizes, and stages its 64 int16 outputs in shared memory (row stride of
// 33 words: no bank conflicts), from where the CTA writes its contiguous
// slab of output rows with coalesced 4-byte stores.
//
// What bounds it on Hopper: bytes and the launch. A block reads 64 bytes and
// writes 128 (9.4 MB at 1920x1080 4:2:0, under 3 us at 3.35 TB/s); the
// integer work (~720 lifting operations and 64 divides a block) is of the
// same order on the INT32 pipes, so at 1080p the kernel lives on its launch
// and its tail.
//
// The per-block tier (kernel K6c, jt_bindct_blocks) replaces
// dct_pallas.py::bin_dct_quant_zigzag_pallas (body _bindct_kernel): (N, 64)
// u8 blocks, contiguous (16-byte aligned), one quantization row for the
// whole call, bug-parity quantization only, (N, 64) int32 out. It runs K3's
// own lifting (bindct_block) and quantizer, one thread per block, and
// stages its int32 rows (stride 65 words) for coalesced stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 8x8 blocks (one a thread) per CTA
constexpr int kStageStride = 33;  // u32 words per staged block (32 + 1 pad)
constexpr int kBlockStageStride = 65;  // int32 words per staged K6c block

// One 8-point binDCT-C pass in place; outputs in natural frequency order.
__device__ __forceinline__ void lift8(int& x0, int& x1, int& x2, int& x3,
                                     int& x4, int& x5, int& x6, int& x7) {
  const int s7 = x0 - x7;
  const int s0 = x0 - (s7 >> 1);
  int s6 = x1 - x6;
  const int s1 = x1 - (s6 >> 1);
  int s5 = x2 - x5;
  const int s2 = x2 - (s5 >> 1);
  const int s4 = x3 - x4;
  const int s3 = x3 - (s4 >> 1);
  s6 = ((s5 * 3) >> 3) + s6;
  s5 = ((s6 * 5) >> 3) - s5;
  int t0 = s0 + s3;
  int t3 = s0 - s3;
  int t1 = s1 + s2;
  int t2 = s1 - s2;
  int t4 = s4 + s5;
  int t5 = s4 - s5;
  int t6 = s7 - s6;
  const int t7 = s7 + s6;
  t4 = t4 - (t7 >> 3);
  t0 = t0 + t1;
  t1 = -t1 + (t0 >> 1);
  t2 = t2 - ((t3 * 3) >> 3);
  t3 = t3 + ((t2 * 3) >> 3);
  t5 = t5 + ((t6 * 7) >> 3);
  t6 = t6 - (t5 >> 1);
  x0 = t0; x1 = t7; x2 = t3; x3 = t6; x4 = t1; x5 = t5; x6 = t2; x7 = t4;
}

// The 2-D transform of one level-shifted block: rows, then columns.
__device__ __forceinline__ void bindct_block(int (&v)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // rows: frequency along the columns
    lift8(v[r][0], v[r][1], v[r][2], v[r][3], v[r][4], v[r][5], v[r][6],
          v[r][7]);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {  // columns: frequency along the rows
    lift8(v[0][c], v[1][c], v[2][c], v[3][c], v[4][c], v[5][c], v[6][c],
          v[7][c]);
  }
}

// Natural index (u * 8 + v) of zigzag position j (ITU-T T.81); j is a
// compile-time constant in every unrolled caller.
__device__ __forceinline__ int zigzag_index(int j) {
  constexpr int kZigzag[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  return kZigzag[j];
}

// The 8 u8 pixels of a 64-bit word (little-endian), level-shifted.
__device__ __forceinline__ void unpack8(uint32_t lo, uint32_t hi, int* row) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    row[c] = static_cast<int>((lo >> (8 * c)) & 0xFFu) - 128;
    row[c + 4] = static_cast<int>((hi >> (8 * c)) & 0xFFu) - 128;
  }
}

template <bool kDescale>
__device__ __forceinline__ int quantize(int x, int q, float g) {
  if (kDescale) {
    const float c = __fdiv_rn(__fmul_rn(static_cast<float>(x), g),
                              static_cast<float>(q));
    return static_cast<int>(truncf(c));
  }
  return x / q;
}

template <bool kDescale>
__global__ void __launch_bounds__(kThreads)
bindct_planes_kernel(const uint8_t* __restrict__ y, int y_width, int ny,
                     const uint8_t* __restrict__ cb,
                     const uint8_t* __restrict__ cr, int c_width, int nc,
                     const int* __restrict__ q_luma,
                     const int* __restrict__ q_chroma,
                     const float* __restrict__ gains,
                     int16_t* __restrict__ out) {
  __shared__ int q_s[2][64];
  __shared__ float g_s[64];
  __shared__ uint32_t stage[kThreads * kStageStride];

  if (threadIdx.x < 64) {
    q_s[0][threadIdx.x] = q_luma[threadIdx.x];
    q_s[1][threadIdx.x] = q_chroma[threadIdx.x];
    g_s[threadIdx.x] = gains[threadIdx.x];
  }
  __syncthreads();

  const int n_total = ny + 2 * nc;
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + threadIdx.x;
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
    const uint8_t* src = plane +
                         static_cast<size_t>(local / blocks_x) * 8 * width +
                         (local % blocks_x) * 8;
    int v[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint2 p =
          *reinterpret_cast<const uint2*>(src + static_cast<size_t>(r) * width);
      unpack8(p.x, p.y, v[r]);
    }
    bindct_block(v);
    const int* q = q_s[n < ny ? 0 : 1];
    uint32_t* row = stage + threadIdx.x * kStageStride;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int a = zigzag_index(j), b = zigzag_index(j + 1);
      const int lo = quantize<kDescale>(v[a >> 3][a & 7], q[j], g_s[j]);
      const int hi = quantize<kDescale>(v[b >> 3][b & 7], q[j + 1], g_s[j + 1]);
      row[j >> 1] = static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
                    (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
    }
  }
  __syncthreads();
  // The CTA's blocks are consecutive output rows: one contiguous slab.
  const int count = min(kThreads, n_total - n0);
  uint32_t* dst = reinterpret_cast<uint32_t*>(out) + static_cast<size_t>(n0) * 32;
  for (int w = threadIdx.x; w < count * 32; w += kThreads) {
    dst[w] = stage[(w >> 5) * kStageStride + (w & 31)];
  }
}

// K6c: bug-parity binDCT of (n, 64) contiguous blocks, one q row.
__global__ void __launch_bounds__(kThreads)
bindct_blocks_kernel(const uint8_t* __restrict__ blocks, int n,
                     const int* __restrict__ q_row,
                     int32_t* __restrict__ out) {
  __shared__ int q_s[64];
  __shared__ int32_t stage[kThreads * kBlockStageStride];
  if (threadIdx.x < 64) q_s[threadIdx.x] = q_row[threadIdx.x];
  __syncthreads();
  const int n0 = blockIdx.x * kThreads;
  const int nb = n0 + threadIdx.x;
  if (nb < n) {
    const uint4* src =
        reinterpret_cast<const uint4*>(blocks + static_cast<size_t>(nb) * 64);
    int v[8][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // 16 bytes: pixel rows 2r and 2r + 1
      const uint4 p = src[r];
      unpack8(p.x, p.y, v[2 * r]);
      unpack8(p.z, p.w, v[2 * r + 1]);
    }
    bindct_block(v);
    int32_t* row = stage + threadIdx.x * kBlockStageStride;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int a = zigzag_index(j);
      row[j] = quantize<false>(v[a >> 3][a & 7], q_s[j], 0.0f);
    }
  }
  __syncthreads();
  // The CTA's blocks are consecutive output rows: one contiguous slab.
  const int count = min(kThreads, n - n0);
  int32_t* dst = out + static_cast<size_t>(n0) * 64;
  for (int w = threadIdx.x; w < count * 64; w += kThreads) {
    dst[w] = stage[(w >> 6) * kBlockStageStride + (w & 63)];
  }
}

}  // namespace

// Planes: y (ny blocks, y_width wide), cb and cr (nc blocks each, c_width
// wide), all padded to multiples of 8 and 8-byte aligned. q_luma, q_chroma:
// (64,) int32 zigzag quantization rows; gains: (64,) f32 zigzag descale gains
// (read only when descale is 1). out: (ny + 2 nc, 64) int16, zigzag.
// Returns the launch's cudaError_t (0 on success).
extern "C" int jt_bindct_planes(const uint8_t* y, int y_width, int ny,
                                const uint8_t* cb, const uint8_t* cr,
                                int c_width, int nc, const int* q_luma,
                                const int* q_chroma, const float* gains,
                                int descale, int16_t* out, void* stream) {
  const int n_total = ny + 2 * nc;
  if (n_total == 0) return 0;
  const int grid = (n_total + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (descale) {
    bindct_planes_kernel<true><<<grid, kThreads, 0, st>>>(
        y, y_width, ny, cb, cr, c_width, nc, q_luma, q_chroma, gains, out);
  } else {
    bindct_planes_kernel<false><<<grid, kThreads, 0, st>>>(
        y, y_width, ny, cb, cr, c_width, nc, q_luma, q_chroma, gains, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks: (n, 64) u8, contiguous and 16-byte aligned. q_row: (64,) int32
// zigzag quantization row (luma or chroma, scaled to the quality). out:
// (n, 64) int32, zigzag, bug-parity quantization. Returns the launch's
// cudaError_t (0 on success).
extern "C" int jt_bindct_blocks(const uint8_t* blocks, int n,
                                const int* q_row, int32_t* out, void* stream) {
  if (n == 0) return 0;
  bindct_blocks_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(blocks, n,
                                                              q_row, out);
  return static_cast<int>(cudaGetLastError());
}

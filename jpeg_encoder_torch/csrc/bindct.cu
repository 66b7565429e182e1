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
//         reference's sign(x) * (|x| // q); computed without a divide as
//         ((x + mulhi(m, x)) >> s) - (x >> 31), with the magic number m and
//         shift s of q[j] (constants.division_magic: Granlund and
//         Montgomery, PLDI 1994), equal to `/` bit for bit for every q in
//         1..255 and every x the lifting can produce (|x| <= 12434);
//     descale    (descale = 1): out[j] = trunc((x * g[j]) / q[j])
//         in float32, each operation rounded once (__fmul_rn, __fdiv_rn;
//         never x * (g / q), never a reciprocal multiply);
//
// stored as int16, with q the luma row for blocks below ny and the chroma
// row otherwise. The result must equal the plain version
// (jpeg_encoder_torch/ops/dct.py::bin_dct_quant_planes_zigzag) bit for bit.
//
// The TPU's packed (16, N) transposed layout is not carried over. Eight
// threads own one 8x8 block, one pixel row each: a thread reads its row
// with one 8-byte load straight from the plane, runs the row lift in
// registers, and the block's 8-lane group transposes through shared memory
// (rows of 9 words: no bank conflicts), so that each thread then holds one
// column, runs the column lift and quantizes its 8 coefficients. They go to
// their zigzag places in a shared staging slab, from where the CTA (32
// blocks) writes its (32, 64) int16 rows with one 16-byte store a thread.
// A thread holds 8 values, not 64: under 30 registers, and a 1080p frame is
// 391,680 threads, enough to fill the card.
//
// Where each row goes, as in K1 (realdct.cu): with a null destination
// table, block n's row is row n (raster order, one contiguous slab a CTA);
// with a table (ops/entropy.block_entries) it is scan entry dst[n] of the
// (E, 64) entries, none where dst[n] is -1. Eight threads still store one
// 128-byte row, so every store stays a whole 128-byte piece.
//
// What bounds it on Hopper: bytes. A block reads 64 bytes and writes 128
// (9.4 MB at 1920x1080 4:2:0, under 3 us at 3.35 TB/s); its integer work (16
// lifts of 43 operations, 64 level shifts and 64 divides of five: mulhi,
// add, two shifts, subtract) is of the same order on the INT32 pipes.
//
// The per-block tier (kernel K6c, jt_bindct_blocks) replaces
// dct_pallas.py::bin_dct_quant_zigzag_pallas (body _bindct_kernel): (N, 64)
// u8 blocks, contiguous (16-byte aligned), one quantization row for the
// whole call, bug-parity quantization only, (N, 64) int32 out. It runs K3's
// own device code (bindct_rows_cols, the magic-number quantizer) on the
// same 8 threads a block, and stages its int32 rows for 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 threads a block
constexpr int kBlocks = kThreads / 8;      // 8x8 blocks a CTA: 32
constexpr int kRowWords = 9;               // transpose rows: 8 words + 1 pad
constexpr int kBlockWords = 8 * kRowWords;  // 72: 8 banks between blocks

// Natural index (u * 8 + v) of zigzag position j (ITU-T T.81).
__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// One 8-point binDCT-C pass in place; outputs in natural frequency order.
__device__ __forceinline__ void lift8(int (&x)[8]) {
  const int s7 = x[0] - x[7];
  const int s0 = x[0] - (s7 >> 1);
  int s6 = x[1] - x[6];
  const int s1 = x[1] - (s6 >> 1);
  int s5 = x[2] - x[5];
  const int s2 = x[2] - (s5 >> 1);
  const int s4 = x[3] - x[4];
  const int s3 = x[3] - (s4 >> 1);
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
  x[0] = t0; x[1] = t7; x[2] = t3; x[3] = t6;
  x[4] = t1; x[5] = t5; x[6] = t2; x[7] = t4;
}

// The 8 u8 pixels of a 64-bit word (little-endian), level-shifted.
__device__ __forceinline__ void unpack8(uint2 p, int (&row)[8]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    row[c] = static_cast<int>((p.x >> (8 * c)) & 0xFFu) - 128;
    row[c + 4] = static_cast<int>((p.y >> (8 * c)) & 0xFFu) - 128;
  }
}

// The 2-D transform of one block by its 8 threads (one 8-lane group of a
// warp; every lane of the warp calls it): v holds pixel row r in, and
// column r of the coefficients out (v[u] is natural index u * 8 + r). xp is
// the block's kBlockWords words of shared memory.
__device__ __forceinline__ void bindct_rows_cols(int (&v)[8], int* xp, int r) {
  lift8(v);  // along the row: frequency along the columns
#pragma unroll
  for (int k = 0; k < 8; ++k) xp[r * kRowWords + k] = v[k];
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = xp[u * kRowWords + r];
  lift8(v);  // along the column: frequency along the rows
}

// Bug-parity x / q, C's truncating divide by the magic number of q.
__device__ __forceinline__ int magic_div(int x, int m, int s) {
  return ((x + __mulhi(m, x)) >> s) - (x >> 31);
}

// A CTA's quantization operands, by natural index: [luma, chroma] magic
// numbers and shifts, f32 divisors and gains (descale), zigzag positions.
struct QuantShared {
  int m[2][64];
  int s[2][64];
  float q[2][64];
  float g[64];
  int zz[64];
};

// Threads 0..63 fill qs from the zigzag-ordered operands (tables rows of
// q_rows, divisors (tables, 64, 2)); the caller synchronises.
__device__ __forceinline__ void load_quant(QuantShared& qs, int tables,
                                           const int* const* q_rows,
                                           const int* divisors,
                                           const float* gains) {
  const int j = threadIdx.x;
  if (j < 64) {
    const int nat = kZigzag[j];
    qs.zz[nat] = j;
    for (int t = 0; t < tables; ++t) {
      qs.m[t][nat] = divisors[(t * 64 + j) * 2];
      qs.s[t][nat] = divisors[(t * 64 + j) * 2 + 1];
      qs.q[t][nat] = static_cast<float>(q_rows[t][j]);
    }
    if (gains != nullptr) qs.g[nat] = gains[j];
  }
}

template <bool kDescale>
__global__ void __launch_bounds__(kThreads)
bindct_planes_kernel(const uint8_t* __restrict__ y, int y_width, int ny,
                     const uint8_t* __restrict__ cb,
                     const uint8_t* __restrict__ cr, int c_width, int nc,
                     const int* __restrict__ q_luma,
                     const int* __restrict__ q_chroma,
                     const float* __restrict__ gains,
                     const int* __restrict__ divisors,
                     const int* __restrict__ dst,
                     int16_t* __restrict__ out) {
  __shared__ QuantShared qs;
  __shared__ int xpose[kBlocks * kBlockWords];
  __shared__ __align__(16) int16_t stage[kBlocks][64];

  const int* q_rows[2] = {q_luma, q_chroma};
  load_quant(qs, 2, q_rows, divisors, kDescale ? gains : nullptr);
  __syncthreads();

  const int n_total = ny + 2 * nc;
  const int n0 = blockIdx.x * kBlocks;
  const int b = threadIdx.x >> 3, r = threadIdx.x & 7;
  const int n = n0 + b;
  int v[8];
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
    p = *reinterpret_cast<const uint2*>(
        plane + (static_cast<size_t>(local / blocks_x) * 8 + r) * width +
        (local % blocks_x) * 8);
  }
  unpack8(p, v);
  bindct_rows_cols(v, xpose + b * kBlockWords, r);
  const int t = n < ny ? 0 : 1;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int nat = u * 8 + r;
    int c;
    if (kDescale) {
      c = static_cast<int>(truncf(__fdiv_rn(
          __fmul_rn(static_cast<float>(v[u]), qs.g[nat]), qs.q[t][nat])));
    } else {
      c = magic_div(v[u], qs.m[t][nat], qs.s[t][nat]);
    }
    stage[b][qs.zz[nat]] = static_cast<int16_t>(c);
  }
  __syncthreads();
  // Thread t stores 16-byte piece t % 8 of block n's row (b = t / 8): 32
  // rows of 128 bytes, one store a thread.
  if (n < n_total) {
    const int row = dst == nullptr ? n : dst[n];
    if (row >= 0) {
      reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * 64)[r] =
          reinterpret_cast<const uint4*>(stage)[threadIdx.x];
    }
  }
}

// K6c: bug-parity binDCT of (n, 64) contiguous blocks, one q row.
__global__ void __launch_bounds__(kThreads)
bindct_blocks_kernel(const uint8_t* __restrict__ blocks, int n_blocks,
                     const int* __restrict__ q_row,
                     const int* __restrict__ divisors,
                     int32_t* __restrict__ out) {
  __shared__ QuantShared qs;
  __shared__ int xpose[kBlocks * kBlockWords];
  __shared__ __align__(16) int32_t stage[kBlocks][64];

  const int* q_rows[1] = {q_row};
  load_quant(qs, 1, q_rows, divisors, nullptr);
  __syncthreads();

  const int n0 = blockIdx.x * kBlocks;
  const int b = threadIdx.x >> 3, r = threadIdx.x & 7;
  const int n = n0 + b;
  int v[8];
  uint2 p = make_uint2(0u, 0u);
  if (n < n_blocks) {
    p = *reinterpret_cast<const uint2*>(blocks + static_cast<size_t>(n) * 64 +
                                        r * 8);
  }
  unpack8(p, v);
  bindct_rows_cols(v, xpose + b * kBlockWords, r);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int nat = u * 8 + r;
    stage[b][qs.zz[nat]] = magic_div(v[u], qs.m[0][nat], qs.s[0][nat]);
  }
  __syncthreads();
  // 32 rows of 256 bytes: two 16-byte stores a thread.
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(n0) * 64);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = i * kThreads + threadIdx.x;  // 16 a row
    if (n0 + (idx >> 4) < n_blocks) {
      dst[idx] = reinterpret_cast<const uint4*>(stage)[idx];
    }
  }
}

}  // namespace

// Planes: y (ny blocks, y_width wide), cb and cr (nc blocks each, c_width
// wide), all padded to multiples of 8 and 8-byte aligned. q_luma, q_chroma:
// (64,) int32 zigzag quantization rows; gains: (64,) f32 zigzag descale gains
// (read only when descale is 1); divisors: (2, 64, 2) int32 magic numbers
// and shifts of the luma and chroma rows (constants.bindct_divisors). dst:
// null, or (ny + 2 nc,) int32, each block's row of out (-1: not written).
// out: (ny + 2 nc, 64) int16, or with dst as many rows as dst names,
// zigzag, 16-byte aligned. Returns the launch's cudaError_t (0 on success).
extern "C" int jt_bindct_planes(const uint8_t* y, int y_width, int ny,
                                const uint8_t* cb, const uint8_t* cr,
                                int c_width, int nc, const int* q_luma,
                                const int* q_chroma, const float* gains,
                                const int* divisors, int descale,
                                const int* dst, int16_t* out, void* stream) {
  const int n_total = ny + 2 * nc;
  if (n_total == 0) return 0;
  const int grid = (n_total + kBlocks - 1) / kBlocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (descale) {
    bindct_planes_kernel<true><<<grid, kThreads, 0, st>>>(
        y, y_width, ny, cb, cr, c_width, nc, q_luma, q_chroma, gains,
        divisors, dst, out);
  } else {
    bindct_planes_kernel<false><<<grid, kThreads, 0, st>>>(
        y, y_width, ny, cb, cr, c_width, nc, q_luma, q_chroma, gains,
        divisors, dst, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks: (n, 64) u8, contiguous and 16-byte aligned. q_row: (64,) int32
// zigzag quantization row (luma or chroma, scaled to the quality);
// divisors: (64, 2) int32, its magic numbers and shifts. out: (n, 64)
// int32, zigzag, bug-parity quantization, 16-byte aligned. Returns the
// launch's cudaError_t (0 on success).
extern "C" int jt_bindct_blocks(const uint8_t* blocks, int n,
                                const int* q_row, const int* divisors,
                                int32_t* out, void* stream) {
  if (n == 0) return 0;
  bindct_blocks_kernel<<<(n + kBlocks - 1) / kBlocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      blocks, n, q_row, divisors, out);
  return static_cast<int>(cudaGetLastError());
}

// RealDCT + quantization + zigzag for three padded u8 planes (kernel K1).
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/dct_pallas.py::real_dct_quant_planes_zigzag_pallas_t
// (fast=False, body _realdct_t_planes_chain). Same function: for every 8x8
// block of [Y | Cb | Cr] and every frequency (u, v), in the reference's exact
// float32 order,
//
//     acc = acc + ((px[k] - 128) * B[u][x_k]) * B[v][y_k],   k = x_k*8 + y_k
//     out[zigzag(u, v)] = (int16) trunc((scale[u][v] * acc) / q[u][v])
//
// where B is the f32 DCT basis (oracle.dct_basis_f32) and q is the luma row
// for blocks below ny, the chroma row otherwise. Every multiply and add
// rounds once (__fmul_rn / __fadd_rn, and the build passes -fmad=false
// besides), and the divide is a true round-to-nearest f32 divide
// (__fdiv_rn), never a reciprocal multiply: the quantized coefficients must
// be bit-identical to the plain chain (jpeg_encoder_torch/ops/dct.py).
//
// What bounds it on Hopper: float32 operations. The function needs, per
// block, 8 * 64 first products t1 = px[k] * B[u][x_k] (shared by the 8
// coefficients of one u), 64 * 64 second products and adds, and a scale
// multiply and a divide per coefficient: 8,832 operations against 64 bytes
// read and 128 written. Fused multiply-adds, which would halve the issue
// count, and the tensor cores are both ruled out by the exactness contract:
// each product and each add must round on its own, in step order, and
// wgmma/mma accumulate in their own order and precision.
//
// Design. One thread per (block, u) runs 8 independent chains, v = 0..7:
// per step it forms t1 once (__fmul_rn), then 8 x (__fmul_rn, __fadd_rn),
// 2.1 operations a coefficient-step where a thread per coefficient needs 3,
// and 8 chains to hide the add latency where it had one. A CTA takes a
// group of 32 consecutive blocks: warp u runs frequency row u, lane b block
// b. The factors travel as a by-value __grid_constant__ kernel parameter
// (RealDctParams), filled from the wrapper's operands
// (constants.realdct_kernel_operands), never a literal that could drift
// from constants.py; since u is the same for the whole warp, every read of
// them (B[u][x], B[v][y], the scale, the quantizer, the zigzag position)
// is a warp-uniform constant-bank access, most of them an operand of the
// multiply itself, and no thread holds a factor array (32 registers, 8
// CTAs an SM). Reads that differ across a warp's lanes would serialize in
// the constant cache: a lane-per-u layout spent a third of its time there.
// The CTA loads its blocks' plane rows in 16-byte pieces (two neighbouring
// blocks' rows; 8-byte pieces where a pair straddles a block row, a plane
// or an alignment) into shared memory as level-shifted floats, each lane
// reads its block 4 pixels a load, and the quantized zigzag rows are
// staged in shared memory (padded, so the lanes' stores to one zigzag
// position hit different banks) and written out coalesced, 128 bytes a
// block.
//
// The per-block tier (kernel K6a, jt_realdct_blocks) replaces
// dct_pallas.py::real_dct_quant_zigzag_pallas (body _realdct_kernel) and
// its transposed forms real_dct_quant_zigzag_pallas_t (K6b: the same
// function in two Mosaic layouts, bit-identical). It takes (N, 64) u8
// blocks, contiguous, with one quantization row for the whole call (luma or
// chroma), and writes (N, 64) int32; the chains and the quantizer are K1's
// own device code (dct_quant_group), so the two agree bit for bit by
// construction.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kGroup = 32;             // 8x8 blocks per CTA: one a lane
constexpr int kThreads = 8 * kGroup;   // one thread per (block, u); warp = u
constexpr int kPxStride = 68;          // floats per block row of px (padded)

// The kernel's constant operands, passed by value (constant bank).
struct RealDctParams {
  float basis[8][8];  // basis[u][x] = B[u, x]
  float scale[64];    // (0.25 alpha_u) alpha_v, natural index u * 8 + v
  float q[2][64];     // luma, chroma quantization rows, natural index
  int zigzag[64];     // zigzag position of natural index u * 8 + v
};

// Eight bytes of pixels -> eight level-shifted floats (exact: integers in
// [-128, 127]).
__device__ __forceinline__ void shift8(uint2 v, float* dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[i] = static_cast<float>((v.x >> (8 * i)) & 0xFFu) - 128.0f;
    dst[4 + i] = static_cast<float>((v.y >> (8 * i)) & 0xFFu) - 128.0f;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* src) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(src[0], src[1], src[2], src[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(src[4], src[5], src[6], src[7]);
}

// Block n of [Y | Cb | Cr]: its plane, the plane's width, and its block
// row and column.
struct BlockAt {
  const uint8_t* plane;
  int width, brow, bcol, blocks_x;
};

__device__ __forceinline__ BlockAt block_at(int n, const uint8_t* y,
                                            int y_width, int ny,
                                            const uint8_t* cb,
                                            const uint8_t* cr, int c_width,
                                            int nc) {
  BlockAt b;
  int local;
  if (n < ny) {
    b.plane = y; b.width = y_width; local = n;
  } else if (n < ny + nc) {
    b.plane = cb; b.width = c_width; local = n - ny;
  } else {
    b.plane = cr; b.width = c_width; local = n - ny - nc;
  }
  b.blocks_x = b.width >> 3;
  b.brow = local / b.blocks_x;
  b.bcol = local % b.blocks_x;
  return b;
}

__device__ __forceinline__ const uint8_t* row_ptr(const BlockAt& b, int r) {
  return b.plane + static_cast<size_t>(b.brow * 8 + r) * b.width + b.bcol * 8;
}

// Staged output rows are padded by 16 bytes, so the 32 lanes' stores to one
// zigzag position fall in different banks.
template <typename Out>
struct Staged {
  static constexpr int kStride = 64 + 16 / sizeof(Out);
  Out rows[kGroup][kStride];
};

// The chains of (block b, u) over px (64 shifted pixels, step order),
// quantized into row b of `staged`. u is the same for the whole warp, so
// every parameter read is a warp-uniform constant-bank access. luma: the
// block takes the luma row, else the chroma row.
template <typename Out>
__device__ __forceinline__ void dct_quant_group(const float* px, int u, int b,
                                                bool luma,
                                                const RealDctParams& p,
                                                Staged<Out>& staged) {
  float acc[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const float a = p.basis[u][x];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 p4 = *reinterpret_cast<const float4*>(px + x * 8 + half * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = half * 4 + i;
        const float t1 = __fmul_rn(pv[i], a);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          acc[v] = __fadd_rn(acc[v], __fmul_rn(t1, p.basis[v][y]));
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int nat = u * 8 + v;
    const float q = luma ? p.q[0][nat] : p.q[1][nat];
    const float c = __fdiv_rn(__fmul_rn(p.scale[nat], acc[v]), q);
    staged.rows[b][p.zigzag[nat]] =
        static_cast<Out>(static_cast<int>(truncf(c)));
  }
}

// Copy count staged rows (64 Out each) to out, 16 bytes a thread.
template <typename Out>
__device__ __forceinline__ void store_rows(const Staged<Out>& staged,
                                           int count, Out* __restrict__ out) {
  constexpr int kPieces = 64 * sizeof(Out) / 16;  // 16-byte pieces a row
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int i = threadIdx.x; i < count * kPieces; i += kThreads) {
    dst[i] = reinterpret_cast<const uint4*>(staged.rows[i / kPieces])
        [i % kPieces];
  }
}

__global__ void __launch_bounds__(kThreads, 8)
realdct_planes_kernel(const uint8_t* __restrict__ y, int y_width, int ny,
                      const uint8_t* __restrict__ cb,
                      const uint8_t* __restrict__ cr, int c_width, int nc,
                      const __grid_constant__ RealDctParams p,
                      int16_t* __restrict__ out) {
  __shared__ __align__(16) float px[kGroup][kPxStride];
  __shared__ __align__(16) Staged<int16_t> staged;
  const int n0 = blockIdx.x * kGroup;
  const int count = min(kGroup, ny + 2 * nc - n0);

  // Piece (pair q, row r): row r of blocks n0 + 2q and n0 + 2q + 1.
  if (threadIdx.x < kGroup / 2 * 8) {
    const int q = threadIdx.x & (kGroup / 2 - 1);
    const int r = threadIdx.x / (kGroup / 2);
    const int b = 2 * q;
    if (b < count) {
      const BlockAt b0 = block_at(n0 + b, y, y_width, ny, cb, cr, c_width, nc);
      const uint8_t* src = row_ptr(b0, r);
      const bool pair = b + 1 < count && n0 + b + 1 != ny &&
                        n0 + b + 1 != ny + nc && b0.bcol + 1 < b0.blocks_x;
      float v[16];
      if (pair && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const uint4 w = *reinterpret_cast<const uint4*>(src);
        shift8(make_uint2(w.x, w.y), v);
        shift8(make_uint2(w.z, w.w), v + 8);
      } else {
        shift8(*reinterpret_cast<const uint2*>(src), v);
        if (b + 1 < count) {
          const BlockAt b1 =
              block_at(n0 + b + 1, y, y_width, ny, cb, cr, c_width, nc);
          shift8(*reinterpret_cast<const uint2*>(row_ptr(b1, r)), v + 8);
        }
      }
      store8(&px[b][r * 8], v);
      if (b + 1 < count) store8(&px[b + 1][r * 8], v + 8);
    }
  }
  __syncthreads();

  const int b = threadIdx.x & 31;  // one block a lane, one u a warp
  if (b < count) {
    dct_quant_group(px[b], threadIdx.x >> 5, b, n0 + b < ny, p, staged);
  }
  __syncthreads();
  store_rows(staged, count, out + static_cast<size_t>(n0) * 64);
}

// K6a/b: the same chains over (n, 64) contiguous blocks, one q row.
__global__ void __launch_bounds__(kThreads, 8)
realdct_blocks_kernel(const uint8_t* __restrict__ blocks, int n, int q_row,
                      const __grid_constant__ RealDctParams p,
                      int32_t* __restrict__ out) {
  __shared__ __align__(16) float px[kGroup][kPxStride];
  __shared__ __align__(16) Staged<int32_t> staged;
  const int n0 = blockIdx.x * kGroup;
  const int count = min(kGroup, n - n0);
  // Thread t loads bytes 16 (t % 4) .. +15 of block t / 4: 2 KB a CTA.
  if (threadIdx.x < count * 4) {
    const uint4 w = reinterpret_cast<const uint4*>(
        blocks + static_cast<size_t>(n0) * 64)[threadIdx.x];
    float v[16];
    shift8(make_uint2(w.x, w.y), v);
    shift8(make_uint2(w.z, w.w), v + 8);
    float* dst = &px[threadIdx.x >> 2][(threadIdx.x & 3) * 16];
    store8(dst, v);
    store8(dst + 8, v + 8);
  }
  __syncthreads();
  const int b = threadIdx.x & 31;
  if (b < count) {
    dct_quant_group(px[b], threadIdx.x >> 5, b, q_row == 0, p, staged);
  }
  __syncthreads();
  store_rows(staged, count, out + static_cast<size_t>(n0) * 64);
}

RealDctParams make_params(const float* basis, const float* scale,
                          const float* q_luma, const float* q_chroma,
                          const int* zigzag) {
  RealDctParams p;
  memcpy(p.basis, basis, sizeof(p.basis));
  memcpy(p.scale, scale, sizeof(p.scale));
  memcpy(p.q[0], q_luma, sizeof(p.q[0]));
  memcpy(p.q[1], q_chroma, sizeof(p.q[1]));
  memcpy(p.zigzag, zigzag, sizeof(p.zigzag));
  return p;
}

}  // namespace

// Planes: y (ny blocks, y_width wide), cb and cr (nc blocks each, c_width
// wide), all padded to multiples of 8 and 8-byte aligned. Operands, in HOST
// memory (copied into the kernel's parameters at launch): basis (8, 8) f32,
// scale, q_luma, q_chroma (64,) f32 in natural order, zigzag (64,) int32.
// out: (ny + 2 nc, 64) int16, zigzag, 16-byte aligned. Returns the launch's
// cudaError_t (0 on success).
extern "C" int jt_realdct_planes(const uint8_t* y, int y_width, int ny,
                                 const uint8_t* cb, const uint8_t* cr,
                                 int c_width, int nc, const float* basis,
                                 const float* scale, const float* q_luma,
                                 const float* q_chroma, const int* zigzag,
                                 int16_t* out, void* stream) {
  const int n_total = ny + 2 * nc;
  if (n_total == 0) return 0;
  realdct_planes_kernel<<<(n_total + kGroup - 1) / kGroup, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      y, y_width, ny, cb, cr, c_width, nc,
      make_params(basis, scale, q_luma, q_chroma, zigzag), out);
  return static_cast<int>(cudaGetLastError());
}

// blocks: (n, 64) u8, contiguous, 16-byte aligned. Operands as for
// jt_realdct_planes (host memory); q_row selects the luma (0) or chroma (1)
// row for every block. out: (n, 64) int32, zigzag, 16-byte aligned. Returns
// the launch's cudaError_t (0 on success).
extern "C" int jt_realdct_blocks(const uint8_t* blocks, int n, int q_row,
                                 const float* basis, const float* scale,
                                 const float* q_luma, const float* q_chroma,
                                 const int* zigzag, int32_t* out,
                                 void* stream) {
  if (n == 0) return 0;
  realdct_blocks_kernel<<<(n + kGroup - 1) / kGroup, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      blocks, n, q_row, make_params(basis, scale, q_luma, q_chroma, zigzag),
      out);
  return static_cast<int>(cudaGetLastError());
}

// --fast-dct RealDCT + quantization + zigzag for three padded u8 planes
// (kernel K2), on the bf16 tensor cores.
//
// Replaces the TPU kernel
// jpeg_encoder_tpu/kernels/dct_pallas.py::real_dct_quant_planes_zigzag_pallas_t
// with fast=True (body _realdct_t_planes_fast_chain), and computes what it
// computes: for every 8x8 block of [Y | Cb | Cr], with px[k] its
// level-shifted pixels (k = row * 8 + column, integers in [-128, 127], exact
// in bf16),
//
//     out[j] = (int16) trunc((sum_k M[j][k] * px[k]) / q[j])
//
// where M is the (64, 64) f32 Kronecker DCT basis with the scale folded in
// and rows in zigzag order (constants.fast_kron_zigzag), taken as its 3-term
// bf16 split M = m1 + m2 + m3 (m1 = bf16(M), m2 = bf16(M - m1), m3 =
// bf16(M - m1 - m2); constants.fast_kron_split, the TPU kernel's split):
// every product px * m_i is exact, and the three products are accumulated
// in f32 from the smallest term to the largest (m3, then m2, then m1). q is
// the luma row for blocks below ny, the chroma row otherwise, and the
// quotient is truncated from the correctly rounded f32 divide. The tensor
// cores add in their own order and rounding, so --fast-dct is held to a
// tolerance (EncoderConfig.fast_dct) against the plain f32 matmul
// (ops/dct.real_dct_fast_planes_zigzag), not to bytes.
//
// Design. A CTA of 4 warps stages the split (3 x 64 x 64 bf16, rows padded
// to 144 bytes so that ldmatrix reads no two rows from one bank) once, then
// walks tiles of 128 blocks, 32 a warp. A warp reads its blocks' pixel rows
// with 8-byte loads straight from the planes (lane = block, so a warp reads
// 256 contiguous bytes of a pixel row), writes them to shared memory as
// bf16 rows of 64 pixels, and takes its A fragments (2 m16 tiles x 4 k16
// steps) with ldmatrix into registers; the loads of its next tile (and of
// its first, before the split is staged) are in flight while it computes.
// Each accumulator (n8 tile of coefficients x m16 tile of blocks) chains
// mma.sync m16n8k16 (bf16 x bf16 -> f32) through the 4 k-steps of m3, then
// of m2, then of m1, B fragments by ldmatrix from the staged split; two n8
// tiles advance side by side.
//
// The epilogue's divide. A true divide (__fdiv_rn) is a long instruction
// sequence, and 64 a block cost more than the products. trunc(acc / q) only
// needs the integer, so the kernel takes x = acc * (1 / q) (both rounded to
// nearest): x lies within about 2^-23 |acc / q| of the exact quotient, so if x
// is below 0.5 in magnitude or further than 2^-20 |x| from the nearest
// integer, trunc(x) is trunc of the correctly rounded quotient; only within
// 2^-20 of a truncation boundary does it divide with __fdiv_rn. The
// integer is that of trunc(__fdiv_rn(acc, q)) for every acc and q
// (tests/test_torch_ops.py holds the rule to true division, q = 1..255).
// The int16 zigzag rows are staged in the warp's pixel buffer (row stride
// 144 bytes: no bank conflicts), from where the warp stores its 32
// contiguous output rows with 16-byte coalesced stores.
//
// What bounds it on Hopper: bytes. The three products are 1.2 GFLOP at
// 1920x1080 4:2:0, about 1.2 us at the published 989 TFLOP/s of dense bf16,
// while the planes in and the coefficients out are 9.4 MB, 2.8 us at
// 3.35 TB/s; mma.sync takes the product off the critical path, so wgmma and
// TMA would buy nothing for a K = 64 product of this size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpBlocks = 32;                  // blocks a warp's tile
constexpr int kCtaBlocks = kWarps * kWarpBlocks;  // blocks a CTA's tile
constexpr int kRow = 72;  // 16-bit elements a shared row: 64 + 8 of padding
constexpr int kSplits = 3;
constexpr int kChains = 2;  // n8 tiles of coefficients in flight

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two level-shifted pixels (bytes) -> two bf16 in one word. An integer in
// [-128, 127] has at most 8 significant bits, so its f32 bits end in 16
// zeros and the high half is the exact bf16.
__device__ __forceinline__ uint32_t pixel_pair(uint32_t word, int c) {
  const float lo = static_cast<float>((word >> (8 * c)) & 0xFFu) - 128.0f;
  const float hi = static_cast<float>((word >> (8 * c + 8)) & 0xFFu) - 128.0f;
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

// The 8 pixel rows of block n of [Y | Cb | Cr] (zeros past the end).
__device__ __forceinline__ void load_rows(const uint8_t* y, int y_width,
                                          int ny, const uint8_t* cb,
                                          const uint8_t* cr, int c_width,
                                          int nc, int n, uint2 (&rows)[8]) {
  if (n >= ny + 2 * nc) {
#pragma unroll
    for (int r = 0; r < 8; ++r) rows[r] = make_uint2(0u, 0u);
    return;
  }
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
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    rows[r] = *reinterpret_cast<const uint2*>(src + static_cast<size_t>(r) * width);
  }
}

// trunc(__fdiv_rn(acc, q)) as an int, from rq = 1 / q (rounded to nearest):
// see "The epilogue's divide" above.
__device__ __forceinline__ int trunc_quotient(float acc, float q, float rq) {
  float x = __fmul_rn(acc, rq);
  const float ax = fabsf(x);
  if (ax >= 0.5f && fabsf(__fsub_rn(x, rintf(x))) <= __fmul_rn(ax, 0x1p-20f)) {
    x = __fdiv_rn(acc, q);  // near a truncation boundary: divide
  }
  return static_cast<int>(truncf(x));
}

__global__ void __launch_bounds__(kThreads)
fastdct_planes_kernel(const uint8_t* __restrict__ y, int y_width, int ny,
                      const uint8_t* __restrict__ cb,
                      const uint8_t* __restrict__ cr, int c_width, int nc,
                      const uint16_t* __restrict__ split,
                      const float* __restrict__ q_luma,
                      const float* __restrict__ q_chroma,
                      int16_t* __restrict__ out) {
  __shared__ __align__(16) uint16_t basis[kSplits][64][kRow];     // 27 KB
  __shared__ __align__(16) uint16_t tile[kWarps][kWarpBlocks][kRow];  // 18 KB
  __shared__ float q_s[2][64];
  __shared__ float rq_s[2][64];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_total = ny + 2 * nc;
  const int tiles = (n_total + kCtaBlocks - 1) / kCtaBlocks;
  // Lane owns block n0 + lane of each of its warp's tiles; the first
  // tile's rows load while the split is staged.
  uint2 rows[8];
  load_rows(y, y_width, ny, cb, cr, c_width, nc,
            blockIdx.x * kCtaBlocks + warp * kWarpBlocks + lane, rows);
  for (int i = threadIdx.x; i < kSplits * 64 * 8; i += kThreads) {
    const int row = i >> 3, chunk = i & 7;  // row = split * 64 + coefficient
    *reinterpret_cast<uint4*>(&basis[row >> 6][row & 63][chunk * 8]) =
        reinterpret_cast<const uint4*>(split)[i];
  }
  if (threadIdx.x < 64) {
    const float ql = q_luma[threadIdx.x], qc = q_chroma[threadIdx.x];
    q_s[0][threadIdx.x] = ql;
    q_s[1][threadIdx.x] = qc;
    rq_s[0][threadIdx.x] = __frcp_rn(ql);
    rq_s[1][threadIdx.x] = __frcp_rn(qc);
  }
  __syncthreads();

  uint16_t (*buf)[kRow] = tile[warp];
  const int g = lane >> 2, tid = lane & 3;  // mma fragment row and column
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t * kCtaBlocks + warp * kWarpBlocks;
    if (n0 >= n_total) break;  // warp-uniform; later tiles start further on
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      *reinterpret_cast<uint4*>(&buf[lane][r * 8]) = make_uint4(
          pixel_pair(rows[r].x, 0), pixel_pair(rows[r].x, 2),
          pixel_pair(rows[r].y, 0), pixel_pair(rows[r].y, 2));
    }
    __syncwarp();
    // A fragments of the two m16 tiles (blocks 0-15, 16-31), all k-steps.
    uint32_t a[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        ldmatrix_x4(a[mt][ks],
                    &buf[mt * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
      }
    }
    __syncwarp();  // every lane holds its fragments: buf takes the output
    // The next tile's rows load while this one computes.
    load_rows(y, y_width, ny, cb, cr, c_width, nc,
              n0 + gridDim.x * kCtaBlocks + lane, rows);

#pragma unroll 1
    for (int nb = 0; nb < 8; nb += kChains) {  // coefficients nb*8 ..
      float acc[kChains][2][4] = {};
#pragma unroll
      for (int s = kSplits - 1; s >= 0; --s) {  // m3, m2, m1
#pragma unroll
        for (int kp = 0; kp < 4; kp += 2) {
#pragma unroll
          for (int c = 0; c < kChains; ++c) {
            uint32_t b[4];  // b0, b1 of k-step kp, then of kp + 1
            ldmatrix_x4(b, &basis[s][(nb + c) * 8 + (lane & 7)]
                                 [kp * 16 + (lane >> 3) * 8]);
            mma_bf16(acc[c][0], a[0][kp], b[0], b[1]);
            mma_bf16(acc[c][1], a[1][kp], b[0], b[1]);
            mma_bf16(acc[c][0], a[0][kp + 1], b[2], b[3]);
            mma_bf16(acc[c][1], a[1][kp + 1], b[2], b[3]);
          }
        }
      }
      // acc[c][mt][2h + i]: block mt*16 + h*8 + g, coefficient
      // (nb + c) * 8 + 2 tid + i.
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const int col = (nb + c) * 8 + 2 * tid;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + h * 8 + g;
            const int table = n0 + row < ny ? 0 : 1;
            const float* q = q_s[table];
            const float* rq = rq_s[table];
            const int v0 = trunc_quotient(acc[c][mt][2 * h], q[col], rq[col]);
            const int v1 = trunc_quotient(acc[c][mt][2 * h + 1], q[col + 1],
                                          rq[col + 1]);
            *reinterpret_cast<uint32_t*>(&buf[row][col]) =
                static_cast<uint32_t>(static_cast<uint16_t>(v0)) |
                (static_cast<uint32_t>(static_cast<uint16_t>(v1)) << 16);
          }
        }
      }
    }
    __syncwarp();
    // The warp's 32 output rows are contiguous: 8 16-byte stores a lane.
    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(n0) * 64);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = i * 32 + lane, row = idx >> 3, chunk = idx & 7;
      if (n0 + row < n_total) {
        dst[idx] = *reinterpret_cast<const uint4*>(&buf[row][chunk * 8]);
      }
    }
    __syncwarp();  // the rows have left buf before the next tile's pixels
  }
}

}  // namespace

// Planes: y (ny blocks, y_width wide), cb and cr (nc blocks each, c_width
// wide), all padded to multiples of 8 and 8-byte aligned. split: (3, 64, 64)
// bf16 bit patterns [m1, m2, m3] of K_zz, row-major (coefficient j, pixel
// k), 16-byte aligned. q_luma, q_chroma: (64,) f32 zigzag rows. out:
// (ny + 2 nc, 64) int16, zigzag, 16-byte aligned. Returns the launch's
// cudaError_t.
extern "C" int jt_fastdct_planes(const uint8_t* y, int y_width, int ny,
                                 const uint8_t* cb, const uint8_t* cr,
                                 int c_width, int nc, const uint16_t* split,
                                 const float* q_luma, const float* q_chroma,
                                 int16_t* out, void* stream) {
  const int n_total = ny + 2 * nc;
  if (n_total == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent CTAs, 4 an SM: the split is staged once per CTA.
  const int tiles = (n_total + kCtaBlocks - 1) / kCtaBlocks;
  const int grid = tiles < 4 * sms ? tiles : 4 * sms;
  fastdct_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_width, ny, cb, cr, c_width, nc, split, q_luma, q_chroma, out);
  return static_cast<int>(cudaGetLastError());
}

// Helpers of the bf16 entry points of the fused T5 attention kernels
// (t5_attention_fwd.cu, t5_attention_bwd.cu): bf16 operands staged in shared
// memory with cp.async, fragments loaded with ldmatrix, and products as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4; a register holds
// two bf16 values, the lower index in its low half):
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..2t+1),
//                           a[2] = (g, 2t+8..2t+9), a[3] = (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b[0] = (k = 2t..2t+1, n = g), b[1] = (k = 2t+8..2t+9, n = g)
//   C (16 x 8, f32):        c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1)
// Two C tiles side by side (columns 0..7 and 8..15) are therefore exactly the
// A operand of a product over those 16 columns: pack (c0[0], c0[1]),
// (c0[2], c0[3]), (c1[0], c1[1]), (c1[2], c1[3]), with no shuffle.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace t5bf16 {

using bf16 = __nv_bfloat16;

// 16-deep feature steps: D padded to 16, 32, 64 or 128.
inline int kd_of(int d) { return d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : 8; }

// Row stride of a staged matrix in bf16 values: 16 bytes past the padded
// features, so that the eight 16-byte rows an ldmatrix phase reads fall in
// eight different 16-byte slots of the 128-byte bank line (strides of 48, 80,
// 144 and 272 bytes): free of bank conflicts.
template <int KD>
constexpr int kStride = 16 * KD + 8;

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// ---- operands ----

// (x0, x1) rounded to bf16 (to nearest even) in one register, x0 in the low half.
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two values of a packed pair as f32 (exact: a bf16 is an f32's high half).
__device__ __forceinline__ float lo_of(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_of(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// x = hi + mid + lo for a pair of f32 values, each part a pair of bf16
// values. Each remainder (x - hi, then x - hi - mid) is exact in f32, so the
// three parts hold x to 2^-25 (relative), f32's own accuracy; hi alone holds
// it to 2^-9, hi + mid to 2^-17.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                      uint32_t& lo) {
  hi = pack(x0, x1);
  const float r0 = x0 - lo_of(hi), r1 = x1 - hi_of(hi);
  mid = pack(r0, r1);
  lo = pack(r0 - lo_of(mid), r1 - hi_of(mid));
}

// The A operand of a product over 16 columns from two C tiles (columns 0..7
// and 8..15), rounded to bf16.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// The same split hi + mid + lo (the f32 values kept whole).
__device__ __forceinline__ void a_from_c_split(uint32_t (&hi)[4], uint32_t (&mid)[4],
                                               uint32_t (&lo)[4], const float (&c0)[4],
                                               const float (&c1)[4]) {
  split(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

// c += a.b, bf16 operands, f32 accumulator: every product is exact in f32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a.b in a fresh accumulator.
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  mma(c, a, b0, b1);
}

// c = a.b with a as an f32 operand split hi + mid + lo: the small parts
// first, all three into one fresh accumulator.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&mid)[4], const uint32_t (&lo)[4],
                                     uint32_t b0, uint32_t b1) {
  mma0(c, lo, b0, b1);
  mma(c, mid, b0, b1);
  mma(c, hi, b0, b1);
}

// ---- shared memory ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of each matrix, row g, columns 2t and 2t + 1.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, transposed: of each matrix, rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Of a staged matrix x (row stride S), rows r0..r0+15 and columns c0..c0+15:
//   ldsm4 at a_addr: the A operand with those rows (a[0..3] as above);
//   ldsm4 at b_addr: the B operands of X.Y^T for rows r0..r0+7 as columns
//     ({r[0], r[1]}) and r0+8..r0+15 ({r[2], r[3]}), depth c0..c0+15;
//   ldsm4_t at a_addr: the B operands of C.Y over rows r0..r0+15 (the depth)
//     for columns c0..c0+7 ({r[0], r[1]}) and c0+8..c0+15 ({r[2], r[3]}).
template <int S>
__device__ __forceinline__ uint32_t a_addr(const bf16* x, int r0, int c0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return smem_addr(x + (r0 + r + 8 * (m & 1)) * S + c0 + 8 * (m >> 1));
}
template <int S>
__device__ __forceinline__ uint32_t b_addr(const bf16* x, int r0, int c0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return smem_addr(x + (r0 + r + 8 * (m >> 1)) * S + c0 + 8 * (m & 1));
}

// ---- staging ----

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src));
}

// rows x d bf16 values from global into shared memory at row stride `stride`:
// 16 bytes a cp.async where vec16 (d a multiple of 8, 16-byte aligned), else a
// plain copy of each value. Complete after cp.async.wait_group and a barrier.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int rows, int d, int stride,
                                      int vec16) {
  if (vec16) {
    const int per_row = d / 8;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
      const int r = idx / per_row, c = (idx - r * per_row) * 8;
      cp_async16(dst + r * stride + c, src + ((size_t)r * d + c));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
      const int r = idx / d, c = idx - r * d;
      dst[r * stride + c] = src[idx];
    }
  }
}

// Zeros where a staged matrix has no data: features d..dp-1 of the real rows,
// then every feature of rows rows..rows_p-1. Only the padding is visited: a
// one-warp block (serving) would otherwise walk the whole matrix.
__device__ __forceinline__ void zero_pad(bf16* dst, int rows, int rows_p, int d, int dp,
                                         int stride) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
  const int wc = dp - d;
  for (int idx = threadIdx.x; idx < rows * wc; idx += blockDim.x) {
    const int r = idx / wc;
    dst[r * stride + d + (idx - r * wc)] = zero;
  }
  for (int idx = threadIdx.x; idx < (rows_p - rows) * dp; idx += blockDim.x) {
    const int r = idx / dp;
    dst[(rows + r) * stride + (idx - r * dp)] = zero;
  }
}

}  // namespace t5bf16

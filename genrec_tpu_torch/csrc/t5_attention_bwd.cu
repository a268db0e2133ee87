// Fused T5 attention backward for Hopper (sm_90a): q, k, v, dO, dq, dk and dv
// in f32 (t5_attention_bwd) or in bf16 (t5_attention_bwd_bf16); dbias in f32.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of genrec_tpu/ops/t5_attention.py
// (reached through `_bwd_call`). It computes the same function, not the same
// blocks. For each flat row hb = h*B + b of the (H*B, L, D) layout (head slowest)
// it recomputes the forward's probabilities, with the -1e9 terms ADDED in the
// forward's order (q.k, + pos_bias, + causal, + key mask), and then:
//
//   dp[i, j] = (do[i] . v[j]) * dm[i, j]               (dm = 1 without dropout)
//   ds[i, j] = p[i, j] * (dp[i, j] - delta[i]),  delta[i] = sum_j dp[i, j] * p[i, j]
//   dq[i]    = sum_j ds[i, j] * k[j]
//   dk[j]    = sum_i ds[i, j] * q[i]
//   dv[j]    = sum_i p[i, j] * dm[i, j] * do[i]
//   dbias[h, i, j] = sum_b ds[h*B + b, i, j]           (if asked for)
//
// Bound on this card: at the TIGER training shapes (L = 80 or 156, D = 16) the
// five products (q.k and do.v recomputed, ds.k, ds.q, (p*dm).do) are 10*D flops
// per score; the softmax recompute, the masks and ds are about 15 more f32
// operations per score, each exp among them; the f32 dropout mask, when given,
// is the largest input (100 MB at the decoder shape). The design:
//
//   - one block of kWarps warps per flat row hb. Q, K, V and dO of the row are
//     staged in shared memory with cp.async at a padded row stride (8*ND + 4
//     floats, which makes every fragment load below free of bank conflicts);
//     rows are padded to a multiple of 16 and features to 8, 16, 32, 64 or 128
//     with zeros, so a ragged edge is masked, not refused. No (Lq, Lk) tile is
//     kept: 54,400 bytes at 156 x 156 x 16, so four blocks share an SM.
//   - phase A, a warp per 16-row query strip. Pass 1 walks the keys 8 at a time
//     and keeps an online max m, sum l = sum e^(s-m) and u = sum e^(s-m)*dp, so
//     delta = u / l comes from the same pass as the softmax statistics (the
//     forward's output is not needed). Pass 2 recomputes p, dp and ds and adds
//     ds.K into dq in registers; dq is written once. m, 1/l and delta go to
//     shared memory; a padding query row stores m = FLT_MAX and 1/l = 0, so its
//     p is exactly 0 whatever the bias value its clamped loads read.
//   - phase B, a warp per 16-key strip: s^T = K.Q^T and dp^T from the stored
//     statistics; dk += ds^T.Q and dv += (p*dm)^T.dO in registers, written once.
//   - every product on the tensor cores: mma.sync m16n8k8 in TF32 with the
//     3xTF32 split (a = hi + lo, hi = cvt.rna(a); lo.hi + hi.lo + hi.hi summed in
//     f32), which keeps f32 accuracy: one TF32 pass would be off by about 4e-4
//     of the largest value. The accumulator fragment of s or ds is fed back as
//     the A operand of the next product with its 8 keys taken in the order the
//     fragment holds them (2t, 2t+1 on lane t), and the B operand is read in the
//     same order, so no shuffle is needed. mma.sync, not wgmma: the tiles are 16
//     deep and at most 156 long, where 64-row tiles would waste 19% on padding.
//     A warp holds the A fragments of its strip in registers up to D = 64;
//     at D = 128 they would take all of them, and are reloaded from shared
//     memory at each use.
//   - softmax, masks and the dropout multiply in f32 with accurate expf. Tiles
//     are never skipped: a masked score is -1e9 added, as in the forward, and
//     only the padding past the last key is -inf.
//   - what remains bounds it by instructions issued: at D = 16 the three inner
//     loops (pass 1, pass 2, phase B) issue about 1,000 warp instructions per
//     16 x 8 tile of scores, 54 of them mma (genrec_tpu_torch/tools/sass_loops.py
//     counts them in the SASS), so the inner loops' loads carry no guards (only the
//     dbias stores check the ragged edge): the TF32 rounding is two integer
//     operations, the bias and dropout values are read a tile at
//     a time at indices clamped into the data (a padding key scores -inf through
//     the key-mask row, a padding query row has p = 0), and the statistics of a
//     row are one float4.
//   - dbias WITHOUT ATOMICS: each block writes its ds tile to a scratch buffer
//     (H, B, Lq, Lk), and t5_attention_dbias_reduce sums that over the batch
//     axis in order. Every
//     output has one owner and a fixed summation order, so dq, dk, dv and dbias
//     are bit-identical between two calls on the same inputs, as the TPU kernel's
//     are (it summed dbias over an ordered grid axis).
//
// The bf16 entry point (t5_attention_bwd_bf16) replaces the same Pallas kernel
// at a bf16 compute dtype: `_bwd_kernel` casts bf16 q, k, v and dO to f32 and
// computes everything in f32; dq, dk and dv are rounded to bf16 once, at
// their stores. The bias, the dropout mask and the dbias scratch stay f32,
// and the reduction kernel is the f32 one. Bound on this card: with the f32
// dropout mask by bytes (0.041 ms at the decoder shape), without it by bytes
// at 0.011 ms; it runs far above both, bound by the instructions it issues
// per score. It has its own kernel (the helpers in t5_attention_bf16.cuh):
//
//   - Q, dO, K and V staged as bf16 by 16-byte cp.async at a row stride of
//     D + 8 values padded to 16, 32, 64 or 128, rows padded to 16: 33,920
//     bytes at 156 x 156 x 16, against the f32 kernel's 54,400. Every operand
//     comes by ldmatrix.x4: A operands of the strips as they lie, the B
//     operands of X.Y^T as they lie, and those of C.Y transposed (K in dq,
//     Q and dO in dk and dv).
//   - the products with two bf16 operands, s (and s^T) and dO.V^T (and
//     V.dO^T), are one mma.sync.m16n8k16 bf16 pass each: exact products,
//     f32 sums. phase B's K.Q^T sums the same products in the same order as
//     phase A's Q.K^T, so both phases see the same p.
//   - the products with an f32 side, ds.K, ds^T.Q and (p*dm)^T.dO, split it
//     into three bf16 parts (hi, mid, lo; each remainder exact in f32), which
//     hold it to f32's own 24 bits, and take three passes, the small parts
//     first, into a fresh accumulator added in f32. Two parts (17 bits) were
//     measured: dq then lay a rounding of bf16 (one ulp at the top binade)
//     from the f32 plain version where the f32 design did not (PERF.md);
//     two TF32 passes with the bf16 side widened would take four m16n8k8
//     steps and the conversions for what three k16 passes do.
//   - 16 keys (phase A) or 16 queries (phase B) a step: the two accumulator
//     tiles of a step are the next product's A operand, so ds and p*dm pass
//     on with one split per register pair and no shuffle; the online pass 1
//     rescales once per 16 keys.
//   - the rest as the f32 kernel: phases A and B, statistics as one float4,
//     padding query rows at m = FLT_MAX and 1/l = 0 (p exactly 0 whatever the
//     bias, so a bias of +100 makes no NaN), accurate expf, the dbias scratch
//     and its in-order reduction: one owner per output, no atomics, bit-equal
//     calls.
//   At D = 16 the three inner loops issue 325 + 519 + 469 warp instructions
//   per 16 x 16 tile of scores (5.1 per score), where the f32 kernel
//   instantiated for bf16 I/O issued 335 + 356 + 351 per 16 x 8 (8.1);
//   counted in the SASS by genrec_tpu_torch/tools/sass_loops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "t5_attention_bf16.cuh"

namespace {

constexpr int kWarps = 5;  // 160-row strips split evenly at L = 80 and 156
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e9f;
constexpr int kMaxD = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on H100
constexpr int kReduceThreads = 256;

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// 8-wide feature steps: D padded to 8, 16, 32, 64 or 128.
int nd_of(int d) { return d <= 8 ? 1 : d <= 16 ? 2 : d <= 32 ? 4 : d <= 64 ? 8 : 16; }

size_t smem_floats(int lq, int lk, int d) {
  const size_t stride = 8 * nd_of(d) + 4;
  const size_t lqp = pad16(lq), lkp = pad16(lk);
  return 2 * (lqp + lkp) * stride  // Q and dO, K and V
         + 4 * lqp                 // per query row: m, 1/l, delta (a float4)
         + lkp;                    // additive key mask, -inf past the last key
}

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;  // q, k, v, dout, dq, dk and dv: f32 or bf16, as the entry point says
  const void* k;
  const void* v;
  const float* pos_bias;
  const int32_t* kv_mask;
  const float* dmask;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dbias_part;
  int batch, lq, lk, d, causal;
  int vec16;  // q, k, v, dO staged 16 bytes at a time
  int pair;   // bias, dropout mask and dbias scratch read and written 2 floats at a time
};

// ---- f32 and bf16 I/O ----

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// ---- TF32 tensor-core helpers ----

// cvt.rna.tf32.f32 of a finite x: the low 13 bits rounded off to nearest,
// ties away from zero, in two integer operations (the cvt instruction is
// emulated with checks for inf and NaN; every operand here is finite).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 operand. lo is rounded like hi but keeps its low 13
// bits, which the tensor cores ignore.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

struct FragA {  // 16 x 8, row-major: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t hi[4], lo[4];
};
struct FragB {  // 8 x 8: (k = t, n = g), (k = t + 4, n = g)
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in 3xTF32, the small terms first. kSwap orders the two small terms
// by b's split instead of a's, so that K.Q^T (phase B) sums the same terms in
// the same order as Q.K^T (phase A).
template <bool kSwap>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  if (kSwap) {
    mma(c, a.hi, b.lo);
    mma(c, a.lo, b.hi);
  } else {
    mma(c, a.lo, b.hi);
    mma(c, a.hi, b.lo);
  }
  mma(c, a.hi, b.hi);
}

// A fragment of rows r0..r0+15, features k0..k0+7 of a staged matrix.
__device__ __forceinline__ void load_a(FragA& f, const float* x, int stride, int r0, int k0,
                                       int g, int t) {
  const float* p = x + (r0 + g) * stride + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * stride], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * stride + 4], f.hi[3], f.lo[3]);
}

// A warp holds the A fragments of its 16-row strip over all ND feature steps
// in registers up to D = 64. At D = 128, where two strips' fragments would take
// all of a thread's registers, it reloads each from shared memory at its use.
template <int ND>
constexpr int kHeld = ND <= 8 ? ND : 1;

template <int ND>
__device__ __forceinline__ void hold(FragA (&f)[kHeld<ND>], const float* x, int r0, int g,
                                     int t) {
  if constexpr (ND <= 8) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) load_a(f[kk], x, 8 * ND + 4, r0, 8 * kk, g, t);
  }
}

// Feature step kk of a strip: held, or reloaded.
template <int ND>
__device__ __forceinline__ FragA step(const FragA (&f)[kHeld<ND>], const float* x, int r0,
                                      int kk, int g, int t) {
  if constexpr (ND <= 8) {
    return f[kk];
  } else {
    FragA a;
    load_a(a, x, 8 * ND + 4, r0, 8 * kk, g, t);
    return a;
  }
}

// B fragment of X.Y^T: rows n0..n0+7 of Y as columns, features k0..k0+7.
__device__ __forceinline__ void load_bt(FragB& f, const float* y, int stride, int n0, int k0,
                                        int g, int t) {
  const float* p = y + (n0 + g) * stride + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// B fragment of C.Y, where C is an accumulator fragment over rows n0..n0+7 of
// Y: features c0..c0+7 of Y, its rows in the order the fragment holds them
// (lane t: rows 2t and 2t + 1).
__device__ __forceinline__ void load_b(FragB& f, const float* y, int stride, int n0, int c0,
                                       int g, int t) {
  const float* p = y + (n0 + 2 * t) * stride + c0 + g;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[stride], f.hi[1], f.lo[1]);
}

// An accumulator fragment (16 x 8: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)) as an A operand whose column t is column 2t and column t + 4 is 2t + 1.
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// ---- scores and masks ----

// The forward's score of query i and key j from q.k, the bias value and the
// key-mask term (-inf past the last key), added in the forward's order.
__device__ __forceinline__ float score(float qk, float bias, float madd, const Params& P, int i,
                                       int j) {
  float s = qk + bias;
  if (P.causal && j > i + P.lk - P.lq) s += kNegInf;
  return s + madd;
}

// Values j and j + 1 of the row at `row` (an offset into x) of the bias or the
// dropout mask. Indices are clamped into the row: past the last key the score
// is -inf and p is 0, so the (finite) value read there does not count, and no
// load needs a guard.
__device__ __forceinline__ void load2(float& a, float& b, const float* x, int row, int j,
                                      const Params& P) {
  if (P.pair) {  // j even, lk even
    const float2 v = __ldg(reinterpret_cast<const float2*>(x + (row + min(j, P.lk - 2))));
    a = v.x, b = v.y;
  } else {
    a = __ldg(x + (row + min(j, P.lk - 1)));
    b = __ldg(x + (row + min(j + 1, P.lk - 1)));
  }
}

// ds of rows[r] by keys j and j + 1 into this block's dbias scratch.
__device__ __forceinline__ void store_ds(float* part, const float (&ds)[4], const Params& P,
                                         const int (&rows)[2], int j) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    if (i >= P.lq) continue;
    float* dst = part + (size_t)i * P.lk + j;
    if (P.pair) {
      if (j < P.lk) *reinterpret_cast<float2*>(dst) = make_float2(ds[2 * r], ds[2 * r + 1]);
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (j + c < P.lk) dst[c] = ds[2 * r + c];
    }
  }
}

// ---- staging ----

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

// rows x d floats from global into shared memory at row stride `stride`.
__device__ __forceinline__ void stage(float* dst, const float* src, int rows, int d, int stride,
                                      int vec16) {
  if (vec16) {
    const int per_row = d / 4;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx - r * per_row) * 4;
      cp_async16(dst + r * stride + c, src + (size_t)r * d + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      cp_async4(dst + r * stride + c, src + idx);
    }
  }
}

// Zeros where a staged matrix has no data: rows >= rows, features >= d.
__device__ __forceinline__ void zero_pad(float* dst, int rows, int rows_p, int d, int dp,
                                         int stride) {
  for (int idx = threadIdx.x; idx < rows_p * dp; idx += kThreads) {
    const int r = idx / dp, c = idx - r * dp;
    if (r >= rows || c >= d) dst[r * stride + c] = 0.0f;
  }
}

// ---- phase A: a warp per 16-row query strip: softmax statistics, delta, dq ----

template <int ND, typename T>
__device__ __forceinline__ void phase_a(const Params& P, const float* sq, const float* sdo,
                                        const float* sk, const float* sv, float4* stats,
                                        const float* madd, const float* bias_h,
                                        const float* dm_hb, T* dq_hb, float* part, int lqp,
                                        int lkp, int warp, int g, int t) {
  constexpr int S = 8 * ND + 4;
  for (int r0 = warp * 16; r0 < lqp; r0 += kWarps * 16) {  // warp-uniform
    FragA qa[kHeld<ND>], oa[kHeld<ND>];
    hold<ND>(qa, sq, r0, g, t);
    hold<ND>(oa, sdo, r0, g, t);
    const int rows[2] = {r0 + g, r0 + g + 8};
    // the offsets of the rows of the bias and the dropout mask; padding rows
    // read the last row (their p is 0), so the loads need no guard
    const int roff[2] = {min(rows[0], P.lq - 1) * P.lk, min(rows[1], P.lq - 1) * P.lk};

    // pass 1: online max m, l = sum e^(s-m), u = sum e^(s-m) * dp. m starts
    // finite, so padding keys (-inf) give e = 0 and never a NaN.
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
    for (int n0 = 0; n0 < lkp; n0 += 8) {
      const int j = n0 + 2 * t;
      float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dm[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (bias_h) load2(bv[2 * r], bv[2 * r + 1], bias_h, roff[r], j, P);
        if (dm_hb) load2(dm[2 * r], dm[2 * r + 1], dm_hb, roff[r], j, P);
      }
      const float2 mk = *reinterpret_cast<const float2*>(madd + j);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        FragB b;
        load_bt(b, sk, S, n0, 8 * kk, g, t);
        mma3<false>(s, step<ND>(qa, sq, r0, kk, g, t), b);
        load_bt(b, sv, S, n0, 8 * kk, g, t);
        mma3<false>(dp, step<ND>(oa, sdo, r0, kk, g, t), b);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float s0 = score(s[2 * r], bv[2 * r], mk.x, P, rows[r], j);
        const float s1 = score(s[2 * r + 1], bv[2 * r + 1], mk.y, P, rows[r], j + 1);
        const float mx = fmaxf(m[r], fmaxf(s0, s1));
        const float scale = mx > m[r] ? expf(m[r] - mx) : 1.0f;  // expf(0) is 1
        const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
        l[r] = l[r] * scale + e0 + e1;
        u[r] = u[r] * scale + e0 * (dp[2 * r] * dm[2 * r]) + e1 * (dp[2 * r + 1] * dm[2 * r + 1]);
        m[r] = mx;
      }
    }
    // the four lanes of a quad hold one row's keys: combine, identically on each
    float inv_l[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float uo = __shfl_xor_sync(0xffffffffu, u[r], off);
        const float mx = fmaxf(m[r], mo);
        const float a = expf(m[r] - mx), b = expf(mo - mx);
        l[r] = __fadd_rn(__fmul_rn(l[r], a), __fmul_rn(lo, b));  // commutative: no FMA
        u[r] = __fadd_rn(__fmul_rn(u[r], a), __fmul_rn(uo, b));
        m[r] = mx;
      }
      const float den = fmaxf(l[r], 1e-30f);
      // a padding row's p is exactly 0: e^(s - FLT_MAX) is 0 for any finite s
      // (an m of 0 with a bias above 88 would make it inf * 0 = NaN in phase B)
      const bool real = rows[r] < P.lq;
      inv_l[r] = real ? 1.0f / den : 0.0f;
      delta[r] = real ? u[r] / den : 0.0f;
      if (!real) m[r] = FLT_MAX;
      if (t == 0) stats[rows[r]] = make_float4(m[r], inv_l[r], delta[r], 0.0f);
    }

    // pass 2: p, dp, ds; dq += ds.K; ds into the dbias scratch
    float acc[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
    for (int n0 = 0; n0 < lkp; n0 += 8) {
      const int j = n0 + 2 * t;
      float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dm[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (bias_h) load2(bv[2 * r], bv[2 * r + 1], bias_h, roff[r], j, P);
        if (dm_hb) load2(dm[2 * r], dm[2 * r + 1], dm_hb, roff[r], j, P);
      }
      const float2 mk = *reinterpret_cast<const float2*>(madd + j);
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        FragB b;
        load_bt(b, sk, S, n0, 8 * kk, g, t);
        mma3<false>(s, step<ND>(qa, sq, r0, kk, g, t), b);
        load_bt(b, sv, S, n0, 8 * kk, g, t);
        mma3<false>(dp, step<ND>(oa, sdo, r0, kk, g, t), b);
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float sc = score(s[e], bv[e], (e & 1) ? mk.y : mk.x, P, rows[r], j + (e & 1));
        const float p = expf(sc - m[r]) * inv_l[r];
        ds[e] = p * (dp[e] * dm[e] - delta[r]);
      }
      if (part) store_ds(part, ds, P, rows, j);
      FragA a;
      a_from_c(a, ds);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        FragB b;
        load_b(b, sk, S, n0, 8 * nd, g, t);
        mma3<false>(acc[nd], a, b);
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1], c = 8 * nd + 2 * t + (e & 1);
        if (i < P.lq && c < P.d) st(dq_hb + ((size_t)i * P.d + c), acc[nd][e]);
      }
  }
}

// ---- phase B: a warp per 16-key strip: dk, dv ----

template <int ND, typename T>
__device__ __forceinline__ void phase_b(const Params& P, const float* sq, const float* sdo,
                                        const float* sk, const float* sv, const float4* stats,
                                        const float* madd, const float* bias_h,
                                        const float* dm_hb, T* dk_hb, T* dv_hb, int lqp,
                                        int lkp, int warp, int g, int t) {
  constexpr int S = 8 * ND + 4;
  for (int c0 = warp * 16; c0 < lkp; c0 += kWarps * 16) {  // warp-uniform
    FragA ka[kHeld<ND>], va[kHeld<ND>];
    hold<ND>(ka, sk, c0, g, t);
    hold<ND>(va, sv, c0, g, t);
    const int keys[2] = {c0 + g, c0 + g + 8};
    const float mk[2] = {madd[keys[0]], madd[keys[1]]};
    // the keys' columns of the bias and the dropout mask, clamped into the
    // data as in phase A
    const int kcol[2] = {min(keys[0], P.lk - 1), min(keys[1], P.lk - 1)};
    float dka[ND][4], dva[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.0f;
    for (int n0 = 0; n0 < lqp; n0 += 8) {  // 8 queries at a time
      float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dm[4] = {1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = min(n0 + 2 * t + (e & 1), P.lq - 1) * P.lk;
        if (bias_h) bv[e] = __ldg(bias_h + (kcol[e >> 1] + off));
        if (dm_hb) dm[e] = __ldg(dm_hb + (kcol[e >> 1] + off));
      }
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        FragB b;
        load_bt(b, sq, S, n0, 8 * kk, g, t);
        mma3<true>(s, step<ND>(ka, sk, c0, kk, g, t), b);
        load_bt(b, sdo, S, n0, 8 * kk, g, t);
        mma3<true>(dp, step<ND>(va, sv, c0, kk, g, t), b);
      }
      const float4 st[2] = {stats[n0 + 2 * t], stats[n0 + 2 * t + 1]};  // m, 1/l, delta
      float ds[4], pd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float4 q = st[e & 1];
        const float sc = score(s[e], bv[e], mk[r], P, n0 + 2 * t + (e & 1), keys[r]);
        const float p = expf(sc - q.x) * q.y;
        ds[e] = p * (dp[e] * dm[e] - q.z);
        pd[e] = p * dm[e];
      }
      FragA a;
      a_from_c(a, ds);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        FragB b;
        load_b(b, sq, S, n0, 8 * nd, g, t);
        mma3<false>(dka[nd], a, b);
      }
      a_from_c(a, pd);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        FragB b;
        load_b(b, sdo, S, n0, 8 * nd, g, t);
        mma3<false>(dva[nd], a, b);
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = keys[e >> 1], c = 8 * nd + 2 * t + (e & 1);
        if (j < P.lk && c < P.d) {
          st(dk_hb + ((size_t)j * P.d + c), dka[nd][e]);
          st(dv_hb + ((size_t)j * P.d + c), dva[nd][e]);
        }
      }
  }
}

// One block of one flat row hb, with q, k, v, dO, dq, dk and dv of type T.
template <int ND, typename T>
__device__ __forceinline__ void bwd_block(const Params& P) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = 8 * ND + 4;
  const int lqp = pad16(P.lq), lkp = pad16(P.lk);
  float* sq = smem;
  float* sdo = sq + lqp * S;
  float* sk = sdo + lqp * S;
  float* sv = sk + lkp * S;
  float4* stats = reinterpret_cast<float4*>(sv + lkp * S);  // lqp: m, 1/l, delta
  float* madd = reinterpret_cast<float*>(stats + lqp);

  const int hb = blockIdx.x, h = hb / P.batch, b = hb - h * P.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_off = (size_t)hb * P.lq * P.d, kv_off = (size_t)hb * P.lk * P.d;
  const float* bias_h = P.pos_bias ? P.pos_bias + (size_t)h * P.lq * P.lk : nullptr;
  const float* dm_hb = P.dmask ? P.dmask + (size_t)hb * P.lq * P.lk : nullptr;
  float* part = P.dbias_part ? P.dbias_part + (size_t)hb * P.lq * P.lk : nullptr;

  zero_pad(sq, P.lq, lqp, P.d, 8 * ND, S);  // the staging below never writes these
  zero_pad(sdo, P.lq, lqp, P.d, 8 * ND, S);
  zero_pad(sk, P.lk, lkp, P.d, 8 * ND, S);
  zero_pad(sv, P.lk, lkp, P.d, 8 * ND, S);
  stage(sq, static_cast<const T*>(P.q) + q_off, P.lq, P.d, S, P.vec16);
  stage(sdo, static_cast<const T*>(P.dout) + q_off, P.lq, P.d, S, P.vec16);
  stage(sk, static_cast<const T*>(P.k) + kv_off, P.lk, P.d, S, P.vec16);
  stage(sv, static_cast<const T*>(P.v) + kv_off, P.lk, P.d, S, P.vec16);
  asm volatile("cp.async.commit_group;");
  for (int j = threadIdx.x; j < lkp; j += kThreads)
    madd[j] = j >= P.lk  ? -INFINITY
              : P.kv_mask ? (1.0f - (float)P.kv_mask[(size_t)b * P.lk + j]) * kNegInf
                          : 0.0f;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  phase_a<ND>(P, sq, sdo, sk, sv, stats, madd, bias_h, dm_hb, static_cast<T*>(P.dq) + q_off,
              part, lqp, lkp, warp, g, t);
  __syncthreads();  // the statistics of every query row
  phase_b<ND>(P, sq, sdo, sk, sv, stats, madd, bias_h, dm_hb, static_cast<T*>(P.dk) + kv_off,
              static_cast<T*>(P.dv) + kv_off, lqp, lkp, warp, g, t);
}

// Four blocks an SM at D <= 16 (the registers of 20 warps: 96 a thread).
template <int ND>
__global__ void __launch_bounds__(kThreads, ND <= 2 ? 4 : (ND == 4 ? 2 : 1))
t5_attention_bwd_kernel(const Params P) {
  bwd_block<ND, float>(P);
}

// ---- the bf16 entry: bf16 operands, m16n8k16 products, 16-key steps ----

namespace tb = t5bf16;

// The A operands of a 16-row strip of a staged matrix over all KD feature
// steps: held in registers up to D = 64, reloaded by ldmatrix at D = 128.
template <int KD>
constexpr int kHeld16 = KD <= 4 ? KD : 1;

template <int KD>
__device__ __forceinline__ void hold16(uint32_t (&f)[kHeld16<KD>][4], const bf16* x, int r0,
                                       int lane) {
  if constexpr (KD <= 4) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      tb::ldsm4(f[kk], tb::a_addr<tb::kStride<KD>>(x, r0, 16 * kk, lane));
  }
}

// Scores of a 16 x 16 tile in two C tiles (columns 0..7 and 8..15), each
// 16-deep feature step in a fresh accumulator added in f32: s = A.Y^T with
// A's strip held (or reloaded from x at r0) and Y's rows n0..n0+15 staged.
template <int KD>
__device__ __forceinline__ void scores16(float (&s)[2][4], const uint32_t (&f)[kHeld16<KD>][4],
                                         const bf16* x, int r0, const bf16* y, int n0,
                                         int lane) {
  constexpr int S = tb::kStride<KD>;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[4], b[4];
    if constexpr (KD <= 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = f[kk][e];
    } else {
      tb::ldsm4(a, tb::a_addr<S>(x, r0, 16 * kk, lane));
    }
    tb::ldsm4(b, tb::b_addr<S>(y, n0, 16 * kk, lane));
    float c0[4], c1[4];
    tb::mma0(c0, a, b[0], b[1]);
    tb::mma0(c1, a, b[2], b[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][e] = kk == 0 ? c0[e] : s[0][e] + c0[e];
      s[1][e] = kk == 0 ? c1[e] : s[1][e] + c1[e];
    }
  }
}

// acc += C.Y for an f32 C of 16 rows by 16 (C tiles c0 and c1), split
// hi + mid + lo, over rows n0..n0+15 of the staged Y: a fresh accumulator per
// output tile and step, added in f32.
template <int KD>
__device__ __forceinline__ void product16(float (&acc)[2 * KD][4], const float (&c0)[4],
                                          const float (&c1)[4], const bf16* y, int n0,
                                          int lane) {
  constexpr int S = tb::kStride<KD>;
  uint32_t hi[4], mid[4], lo[4];
  tb::a_from_c_split(hi, mid, lo, c0, c1);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t b[4];
    tb::ldsm4_t(b, tb::a_addr<S>(y, n0, 16 * kk, lane));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c[4];
      tb::mma3(c, hi, mid, lo, b[2 * h], b[2 * h + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * kk + h][e] += c[e];
    }
  }
}

// Values of the bias or the dropout mask at (row roff[r], keys j + 8h + c)
// into x[4h + 2r + c], the two C tiles' order; clamped as load2 clamps.
__device__ __forceinline__ void load_tile16(float (&x)[8], const float* src,
                                            const int (&roff)[2], int j, const Params& P) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      load2(x[4 * h + 2 * r], x[4 * h + 2 * r + 1], src, roff[r], j + 8 * h, P);
}

// ds of rows[r] by keys j + 8h and j + 8h + 1 (ds[h]: a C tile) into the
// block's dbias scratch.
__device__ __forceinline__ void store_ds16(float* part, const float (&ds)[2][4], const Params& P,
                                           const int (&rows)[2], int j) {
  store_ds(part, ds[0], P, rows, j);
  store_ds(part, ds[1], P, rows, j + 8);
}

// Features c and c + 1 of an output row, those below d.
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b, int c, const Params& P) {
  if (c < P.d) st(dst, a);
  if (c + 1 < P.d) st(dst + 1, b);
}

// Phase A at bf16, a warp per 16-row query strip: pass 1 (m, l, u), pass 2
// (p, dp, ds; dq += ds.K), 16 keys a step.
template <int KD>
__device__ __forceinline__ void phase_a_bf16(const Params& P, const bf16* sq, const bf16* sdo,
                                             const bf16* sk, const bf16* sv, float4* stats,
                                             const float* madd, const float* bias_h,
                                             const float* dm_hb, bf16* dq_hb, float* part,
                                             int lqp, int lkp, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < lqp; r0 += kWarps * 16) {  // warp-uniform
    uint32_t qa[kHeld16<KD>][4], oa[kHeld16<KD>][4];
    hold16<KD>(qa, sq, r0, lane);
    hold16<KD>(oa, sdo, r0, lane);
    const int rows[2] = {r0 + g, r0 + g + 8};
    const int roff[2] = {min(rows[0], P.lq - 1) * P.lk, min(rows[1], P.lq - 1) * P.lk};

    // pass 1: online max m, l = sum e^(s-m), u = sum e^(s-m) * dp * dm
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f};
    for (int n0 = 0; n0 < lkp; n0 += 16) {
      const int j = n0 + 2 * t;
      float bv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float dm[8] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
      if (bias_h) load_tile16(bv, bias_h, roff, j, P);
      if (dm_hb) load_tile16(dm, dm_hb, roff, j, P);
      const float2 mk[2] = {*reinterpret_cast<const float2*>(madd + j),
                            *reinterpret_cast<const float2*>(madd + j + 8)};
      float s[2][4], dp[2][4];
      scores16<KD>(s, qa, sq, r0, sk, n0, lane);
      scores16<KD>(dp, oa, sdo, r0, sv, n0, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x[4], w[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c;
            x[2 * h + c] = score(s[h][e], bv[4 * h + e], c ? mk[h].y : mk[h].x, P, rows[r],
                                 j + 8 * h + c);
            w[2 * h + c] = dp[h][e] * dm[4 * h + e];
          }
        const float mx = fmaxf(m[r], fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
        const float scale = mx > m[r] ? expf(m[r] - mx) : 1.0f;  // expf(0) is 1
        float e[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) e[c] = expf(x[c] - mx);
        l[r] = l[r] * scale + ((e[0] + e[1]) + (e[2] + e[3]));
        u[r] = u[r] * scale + ((e[0] * w[0] + e[1] * w[1]) + (e[2] * w[2] + e[3] * w[3]));
        m[r] = mx;
      }
    }
    // the four lanes of a quad hold one row's keys: combine, identically on each
    float inv_l[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float uo = __shfl_xor_sync(0xffffffffu, u[r], off);
        const float mx = fmaxf(m[r], mo);
        const float a = expf(m[r] - mx), b = expf(mo - mx);
        l[r] = __fadd_rn(__fmul_rn(l[r], a), __fmul_rn(lo, b));  // commutative: no FMA
        u[r] = __fadd_rn(__fmul_rn(u[r], a), __fmul_rn(uo, b));
        m[r] = mx;
      }
      const float den = fmaxf(l[r], 1e-30f);
      // a padding row's p is exactly 0: e^(s - FLT_MAX) is 0 for any finite s
      const bool real = rows[r] < P.lq;
      inv_l[r] = real ? 1.0f / den : 0.0f;
      delta[r] = real ? u[r] / den : 0.0f;
      if (!real) m[r] = FLT_MAX;
      if (t == 0) stats[rows[r]] = make_float4(m[r], inv_l[r], delta[r], 0.0f);
    }

    // pass 2: p, dp, ds; dq += ds.K (ds split in three); ds into the dbias scratch
    float acc[2 * KD][4];
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
    for (int n0 = 0; n0 < lkp; n0 += 16) {
      const int j = n0 + 2 * t;
      float bv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float dm[8] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
      if (bias_h) load_tile16(bv, bias_h, roff, j, P);
      if (dm_hb) load_tile16(dm, dm_hb, roff, j, P);
      const float2 mk[2] = {*reinterpret_cast<const float2*>(madd + j),
                            *reinterpret_cast<const float2*>(madd + j + 8)};
      float s[2][4], dp[2][4];
      scores16<KD>(s, qa, sq, r0, sk, n0, lane);
      scores16<KD>(dp, oa, sdo, r0, sv, n0, lane);
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float sc = score(s[h][e], bv[4 * h + e], (e & 1) ? mk[h].y : mk[h].x, P,
                                 rows[r], j + 8 * h + (e & 1));
          const float p = expf(sc - m[r]) * inv_l[r];
          ds[h][e] = p * (dp[h][e] * dm[4 * h + e] - delta[r]);
        }
      if (part) store_ds16(part, ds, P, rows, j);
      product16<KD>(acc, ds[0], ds[1], sk, n0, lane);
    }
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = rows[r], c = 8 * nd + 2 * t;
        if (i < P.lq)
          store_pair(dq_hb + ((size_t)i * P.d + c), acc[nd][2 * r], acc[nd][2 * r + 1], c, P);
      }
  }
}

// Phase B at bf16, a warp per 16-key strip: s^T = K.Q^T and dp^T = V.dO^T
// from the stored statistics; dk += ds^T.Q and dv += (p*dm)^T.dO (ds and p*dm
// split in three), 16 queries a step.
template <int KD>
__device__ __forceinline__ void phase_b_bf16(const Params& P, const bf16* sq, const bf16* sdo,
                                             const bf16* sk, const bf16* sv,
                                             const float4* stats, const float* madd,
                                             const float* bias_h, const float* dm_hb,
                                             bf16* dk_hb, bf16* dv_hb, int lqp, int lkp,
                                             int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int c0 = warp * 16; c0 < lkp; c0 += kWarps * 16) {  // warp-uniform
    uint32_t ka[kHeld16<KD>][4], va[kHeld16<KD>][4];
    hold16<KD>(ka, sk, c0, lane);
    hold16<KD>(va, sv, c0, lane);
    const int keys[2] = {c0 + g, c0 + g + 8};
    const float mk[2] = {madd[keys[0]], madd[keys[1]]};
    const int kcol[2] = {min(keys[0], P.lk - 1), min(keys[1], P.lk - 1)};
    float dka[2 * KD][4], dva[2 * KD][4];
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.0f;
    for (int n0 = 0; n0 < lqp; n0 += 16) {  // 16 queries at a time
      // query of C index e in tile h: n0 + 8h + 2t + (e & 1); key: keys[e >> 1]
      float bv[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float dm[8] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = min(n0 + 8 * h + 2 * t + (e & 1), P.lq - 1) * P.lk + kcol[e >> 1];
          if (bias_h) bv[4 * h + e] = __ldg(bias_h + off);
          if (dm_hb) dm[4 * h + e] = __ldg(dm_hb + off);
        }
      float s[2][4], dp[2][4];
      scores16<KD>(s, ka, sk, c0, sq, n0, lane);
      scores16<KD>(dp, va, sv, c0, sdo, n0, lane);
      float ds[2][4], pd[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = n0 + 8 * h + 2 * t;
        const float4 st[2] = {stats[q0], stats[q0 + 1]};  // m, 1/l, delta
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float4 q = st[e & 1];
          const float sc = score(s[h][e], bv[4 * h + e], mk[r], P, q0 + (e & 1), keys[r]);
          const float p = expf(sc - q.x) * q.y;
          ds[h][e] = p * (dp[h][e] * dm[4 * h + e] - q.z);
          pd[h][e] = p * dm[4 * h + e];
        }
      }
      product16<KD>(dka, ds[0], ds[1], sq, n0, lane);
      product16<KD>(dva, pd[0], pd[1], sdo, n0, lane);
    }
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jk = keys[r], c = 8 * nd + 2 * t;
        if (jk < P.lk) {
          store_pair(dk_hb + ((size_t)jk * P.d + c), dka[nd][2 * r], dka[nd][2 * r + 1], c, P);
          store_pair(dv_hb + ((size_t)jk * P.d + c), dva[nd][2 * r], dva[nd][2 * r + 1], c, P);
        }
      }
  }
}

// One block of one flat row hb at bf16: Q, dO, K and V staged as bf16 by
// cp.async, rows padded to 16 and features to 16, 32, 64 or 128.
template <int KD>
__device__ __forceinline__ void bwd_block_bf16(const Params& P) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  constexpr int S = tb::kStride<KD>;
  const int lqp = tb::pad16(P.lq), lkp = tb::pad16(P.lk);
  bf16* sq = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sdo = sq + lqp * S;
  bf16* sk = sdo + lqp * S;
  bf16* sv = sk + lkp * S;
  float4* stats = reinterpret_cast<float4*>(sv + lkp * S);  // 16-aligned: S * 2 bytes a row
  float* madd = reinterpret_cast<float*>(stats + lqp);

  const int hb = blockIdx.x, h = hb / P.batch, b = hb - h * P.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_off = (size_t)hb * P.lq * P.d, kv_off = (size_t)hb * P.lk * P.d;
  const float* bias_h = P.pos_bias ? P.pos_bias + (size_t)h * P.lq * P.lk : nullptr;
  const float* dm_hb = P.dmask ? P.dmask + (size_t)hb * P.lq * P.lk : nullptr;
  float* part = P.dbias_part ? P.dbias_part + (size_t)hb * P.lq * P.lk : nullptr;

  tb::zero_pad(sq, P.lq, lqp, P.d, 16 * KD, S);  // the staging below never writes these
  tb::zero_pad(sdo, P.lq, lqp, P.d, 16 * KD, S);
  tb::zero_pad(sk, P.lk, lkp, P.d, 16 * KD, S);
  tb::zero_pad(sv, P.lk, lkp, P.d, 16 * KD, S);
  tb::stage(sq, static_cast<const bf16*>(P.q) + q_off, P.lq, P.d, S, P.vec16);
  tb::stage(sdo, static_cast<const bf16*>(P.dout) + q_off, P.lq, P.d, S, P.vec16);
  tb::stage(sk, static_cast<const bf16*>(P.k) + kv_off, P.lk, P.d, S, P.vec16);
  tb::stage(sv, static_cast<const bf16*>(P.v) + kv_off, P.lk, P.d, S, P.vec16);
  asm volatile("cp.async.commit_group;");
  for (int j = threadIdx.x; j < lkp; j += kThreads)
    madd[j] = j >= P.lk  ? -INFINITY
              : P.kv_mask ? (1.0f - (float)P.kv_mask[(size_t)b * P.lk + j]) * kNegInf
                          : 0.0f;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  phase_a_bf16<KD>(P, sq, sdo, sk, sv, stats, madd, bias_h, dm_hb,
                   static_cast<bf16*>(P.dq) + q_off, part, lqp, lkp, warp, lane);
  __syncthreads();  // the statistics of every query row
  phase_b_bf16<KD>(P, sq, sdo, sk, sv, stats, madd, bias_h, dm_hb,
                   static_cast<bf16*>(P.dk) + kv_off, static_cast<bf16*>(P.dv) + kv_off, lqp,
                   lkp, warp, lane);
}

template <int KD>
__global__ void __launch_bounds__(kThreads, KD == 1 ? 4 : (KD == 2 ? 2 : 1))
t5_attention_bwd_bf16_kernel(const Params P) {
  bwd_block_bf16<KD>(P);
}

// dbias[h, e] = sum over chunks c, in order, of part[h, c, e].
__global__ void __launch_bounds__(kReduceThreads)
t5_attention_dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int nchunk, int n, int total) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= total) return;
  const int h = idx / n, e = idx - h * n;
  const float* p = part + (size_t)h * nchunk * n + e;
  float acc = 0.0f;
  int c = 0;
  for (; c + 8 <= nchunk; c += 8) {  // eight loads in flight, then their sum in order
    float x[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) x[w] = p[(size_t)(c + w) * n];
#pragma unroll
    for (int w = 0; w < 8; ++w) acc += x[w];
  }
  for (; c < nchunk; ++c) acc += p[(size_t)c * n];
  out[idx] = acc;
}

using Kernel = void (*)(Params);

// The kernel for I/O type T at feature width d, and its shared memory at (lq, lk, d).
template <typename T>
Kernel kernel_of(int d);

template <>
Kernel kernel_of<float>(int d) {
  switch (nd_of(d)) {
    case 1: return &t5_attention_bwd_kernel<1>;
    case 2: return &t5_attention_bwd_kernel<2>;
    case 4: return &t5_attention_bwd_kernel<4>;
    case 8: return &t5_attention_bwd_kernel<8>;
    default: return &t5_attention_bwd_kernel<16>;
  }
}

template <>
Kernel kernel_of<bf16>(int d) {
  switch (tb::kd_of(d)) {
    case 1: return &t5_attention_bwd_bf16_kernel<1>;
    case 2: return &t5_attention_bwd_bf16_kernel<2>;
    case 4: return &t5_attention_bwd_bf16_kernel<4>;
    default: return &t5_attention_bwd_bf16_kernel<8>;
  }
}

template <typename T>
size_t smem_bytes(int lq, int lk, int d);

template <>
size_t smem_bytes<float>(int lq, int lk, int d) {
  return smem_floats(lq, lk, d) * sizeof(float);
}

template <>
size_t smem_bytes<bf16>(int lq, int lk, int d) {  // Q, dO, K, V in bf16; stats, key mask f32
  const size_t lqp = tb::pad16(lq), lkp = tb::pad16(lk);
  return 2 * (lqp + lkp) * (16 * tb::kd_of(d) + 8) * sizeof(bf16) + 4 * lqp * sizeof(float) +
         lkp * sizeof(float);
}

cudaError_t prepare(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t launch(Kernel k, Params P, int grid, size_t smem, cudaStream_t stream) {
  const cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&P};
  const cudaError_t l = cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(grid),
                                         dim3(kThreads), args, smem, stream);
  return l != cudaSuccess ? l : cudaGetLastError();
}

int occupancy(Kernel k, size_t smem) {
  cudaError_t e = prepare(k, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
int blocks_per_sm(int lq, int lk, int d) {
  const size_t smem = smem_bytes<T>(lq, lk, d);
  if (smem > kMaxSmem || d <= 0 || d > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  return occupancy(kernel_of<T>(d), smem);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* pos_bias, const void* kv_mask,
        const void* dmask, const void* dout, void* dq, void* dk, void* dv, void* dbias_part,
        int hb, int batch, int lq, int lk, int d, int causal, void* stream) {
  const size_t smem = smem_bytes<T>(lq, lk, d);
  if (smem > kMaxSmem || hb <= 0 || batch <= 0 || hb % batch != 0 || lq <= 0 || lk <= 0 ||
      d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int per16 = 16 / sizeof(T);  // values in one 16-byte staging load
  Params P{q, k, v, static_cast<const float*>(pos_bias),
           static_cast<const int32_t*>(kv_mask), static_cast<const float*>(dmask),
           dout, dq, dk, dv, static_cast<float*>(dbias_part), batch, lq, lk, d, causal,
           d % per16 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
               aligned(dout, 16),
           lk % 2 == 0 && aligned(pos_bias, 8) && aligned(dmask, 8) && aligned(dbias_part, 8)};
  return static_cast<int>(launch(kernel_of<T>(d), P, hb, smem,
                                 static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the f32 (bf16) kernel needs for (lq, lk, d).
size_t t5_attention_bwd_smem_bytes(int lq, int lk, int d) {
  return smem_bytes<float>(lq, lk, d);
}
size_t t5_attention_bwd_bf16_smem_bytes(int lq, int lk, int d) {
  return smem_bytes<bf16>(lq, lk, d);
}

// Blocks of the f32 (bf16) backward kernel resident on one SM at (lq, lk, d),
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus the CUDA error on
// failure.
int t5_attention_bwd_blocks_per_sm(int lq, int lk, int d) {
  return blocks_per_sm<float>(lq, lk, d);
}
int t5_attention_bwd_bf16_blocks_per_sm(int lq, int lk, int d) {
  return blocks_per_sm<bf16>(lq, lk, d);
}

// Registers per thread and bytes of local memory per thread (spills and
// stack; 0 if nothing spills) of the bf16 backward kernel at width d, as the
// loaded build has them (cudaFuncGetAttributes); returns the CUDA error.
int t5_attention_bwd_bf16_registers(int d, int* registers, int* local_bytes) {
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel_of<bf16>(d)));
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}

const char* t5_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/dout/dq: (hb, lq, d), k/v/dk/dv: (hb, lk, d), pos_bias: (hb / batch, lq, lk) or
// NULL, kv_mask: (batch, lk) int32 or NULL, dmask: (hb, lq, lk) or NULL,
// dbias_part: (hb / batch, batch, lq, lk) scratch for each flat row's ds (need
// not be zeroed), or NULL when no dbias is wanted. All f32 except kv_mask,
// contiguous, on the device; d <= 128. Launches on `stream` and returns
// cudaGetLastError().
int t5_attention_bwd(const void* q, const void* k, const void* v, const void* pos_bias,
                     const void* kv_mask, const void* dmask, const void* dout, void* dq,
                     void* dk, void* dv, void* dbias_part, int hb, int batch, int lq, int lk,
                     int d, int causal, void* stream) {
  return run<float>(q, k, v, pos_bias, kv_mask, dmask, dout, dq, dk, dv, dbias_part, hb, batch,
                    lq, lk, d, causal, stream);
}

// As t5_attention_bwd, with q, k, v, dout, dq, dk and dv in bf16 (pos_bias,
// dmask and dbias_part f32).
int t5_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* pos_bias,
                          const void* kv_mask, const void* dmask, const void* dout, void* dq,
                          void* dk, void* dv, void* dbias_part, int hb, int batch, int lq,
                          int lk, int d, int causal, void* stream) {
  return run<bf16>(q, k, v, pos_bias, kv_mask, dmask, dout, dq, dk, dv, dbias_part, hb, batch,
                   lq, lk, d, causal, stream);
}

// dbias (heads, n) = the sum over the chunk axis of part (heads, nchunk, n), in
// chunk order. f32, contiguous, on the device.
int t5_attention_dbias_reduce(const void* part, void* dbias, int heads, int nchunk, int n,
                              void* stream) {
  if (heads <= 0 || nchunk <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int total = heads * n;
  t5_attention_dbias_reduce_kernel<<<(total + kReduceThreads - 1) / kReduceThreads,
                                     kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), nchunk, n, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

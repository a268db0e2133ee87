// Fused T5 attention forward for Hopper (sm_90a): q, k, v and out in f32
// (t5_attention_fwd) or in bf16 (t5_attention_fwd_bf16).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of genrec_tpu/ops/t5_attention.py
// (reached through `_fwd_call`). It computes the same function, not the same
// blocks. For each flat row hb = h*B + b of the (H*B, L, D) layout (head slowest):
//
//   s[i, j] = q[i] . k[j]                             (unscaled, T5 convention)
//           + pos_bias[h, i, j]                        (if given)
//           + (causal && j > i + (Lk - Lq) ? -1e9 : 0)
//           + (1 - kv_mask[b, j]) * -1e9               (if given)
//   p[i, :] = exp(s[i, :] - max) / max(sum, 1e-30)
//   p      *= dmask[hb, i, :]                          (if given)
//   out[i]  = p[i, :] . v
//
// The -1e9 terms are ADDED in f32 in that order (never a `where`), so a fully
// masked row comes out finite, as the mean of v over the keys that tie for its
// maximum, exactly like the plain version and the reference. The TPU kernel
// folded the key-padding mask into an extra q/k feature column because Mosaic
// could not broadcast it; this kernel reads the (B, Lk) mask directly.
//
// Bound on this card: at the TIGER shapes (L = 80 or 156, D = 16) a score costs
// 4*D flops of products and about 8 f32 operations of softmax, masks and
// dropout, against 4*D*4 bytes of q, k, v and out per row; the f32 dropout mask
// that training passes is 4 bytes per score, the largest input (100 MB at the
// decoder shape), and with it the kernel is bound by bytes. The design:
//
//   - a block of up to kWarps warps per flat row hb, or per group of its 16-row
//     query strips when there are too few flat rows to fill the card (serving at
//     B = 1 has 4). K and V of the row are staged once in shared memory with
//     cp.async at a padded row stride (8*ND + 4 floats, which makes every
//     fragment load below free of bank conflicts), keys padded to a multiple of
//     8 and features to 8, 16, 32, 64 or 128 with zeros; the key mask is staged
//     as additive terms. No (Lq, Lk) tile is kept: 26,240 bytes at Lk = 156,
//     D = 16, which leaves most of the SM's 256 KB to L1 at 4 blocks an SM.
//     (Staging K and V already split into TF32 pairs took 49,280 bytes, and
//     the kernel was slower with it where the dropout mask streams through L1:
//     0.146 against 0.104 ms at the decoder shape; PERF.md.)
//   - a warp per 16-row query strip. It holds its strip's Q A fragments in
//     registers up to D = 64, read once from global memory; at D = 128 they
//     would take most of them, and are reloaded at each use.
//   - both products on the tensor cores: mma.sync m16n8k8 in TF32 with the
//     3xTF32 split (a = hi + lo, hi = cvt.rna(a); lo.hi + hi.lo + hi.hi summed in
//     f32), which keeps f32 accuracy: one TF32 pass would be off by about 4e-4
//     of the largest score. Each 8-deep step (8 features of q.k, 8 keys of P.V)
//     goes into a fresh accumulator that is added to the running sum in f32:
//     the tensor cores' own additions do not round to nearest, and chained
//     through one accumulator (48 mma at D = 128) they left the output 2.5x
//     farther from f64 than the plain f32 version (PERF.md). mma.sync, not
//     wgmma: the strips are 16 rows deep and at most 156 long, where 64-row
//     tiles would waste 19% on padding.
//   - an online softmax over 8-key tiles. Lane t of a quad holds keys 2t and
//     2t + 1 of its two query rows (the accumulator fragment's layout); the four
//     lanes agree on each row's running max m by two shuffles a tile, so that
//     the tile's probabilities can enter one P.V product. The normalisation is
//     deferred: out = sum_j e^(s_j - m) * dm_j * v_j / max(l, 1e-30), with
//     l = sum_j e^(s_j - m), which is the reference's function (the dropout mask
//     multiplies the normalised probability there). An exact two-pass softmax
//     would have to keep the strip's scores in registers (80 a lane at Lk = 160)
//     or compute Q.K^T twice.
//   - the bias and the dropout mask are read from global memory in the
//     accumulator fragment's layout, 8 bytes a lane, each value once, one tile
//     ahead of its use so that the load's latency hides behind a tile of work.
//     A head's (Lq, Lk) bias is shared by the B blocks of its head and stays in L2.
//   - P.V: the probabilities' accumulator fragment is fed back as the A operand
//     with its 8 keys taken in the order the fragment holds them (2t, 2t + 1 on
//     lane t), and V's rows are read in the same order, so no shuffle is needed.
//     Each output row is written once, and only real rows.
//   - ragged edges without load guards in the loop: a padding key (past Lk,
//     156 -> 160) scores -inf through the key-mask row, not -1e9: a fully masked
//     row's real keys all sit near -1e9, and a padding key there would join
//     their tie and pull zeros into the mean. The running max starts at
//     -FLT_MAX, so e^(-inf - m) is 0 and no inf * 0 appears, also in the padding
//     query rows (computed, never stored). Bias and mask indices are clamped
//     into the data.
//   - accurate expf, no fast-math; no atomics. Every output has one owner and a
//     fixed order of summation, which does not depend on how the strips are
//     split over blocks, so two calls give bit-equal outputs.
//
// The bf16 entry point (t5_attention_fwd_bf16) replaces the same Pallas kernel
// at a bf16 compute dtype: `_fwd_kernel` casts bf16 q and k to f32 for q.k,
// rounds the probabilities to v's dtype and takes P.V with f32 accumulation.
// The bias and the dropout mask stay f32 inputs; out is bf16, rounded once at
// its store. Bound on this card: the bytes halve for q, k, v and out, so with
// the f32 dropout mask (4 bytes a score, 99.7 MB at the decoder shape) it is
// bound by bytes (0.036 ms there); without it the bound is 0.006 ms and the
// kernel is bound by the instructions it issues per score. It has its own
// kernel (the helpers in t5_attention_bf16.cuh), designed for bf16:
//
//   - K and V staged as bf16 by 16-byte cp.async, at a row stride of D + 8
//     values padded to 16, 32, 64 or 128 (free of bank conflicts for
//     ldmatrix), keys padded to 16 with zeros: 16,000 bytes at Lk = 156,
//     D = 16, against the f32 kernel's 26,240.
//   - both products as one mma.sync.m16n8k16 bf16 pass with f32 accumulators:
//     a bf16 product is exact in f32, so q.k is the reference's f32 sum in
//     another order, and P.V takes p rounded to bf16 as the reference does.
//     At D = 16 the scores of 16 keys are two mma, where the f32 design's
//     3xTF32 took twelve. B operands come by ldmatrix.x4 (K as it lies, V
//     transposed); q's A operands are read once per strip from global memory.
//   - 16 keys a step: lane t holds keys 2t, 2t + 1, 2t + 8 and 2t + 9 of its
//     two rows, the two accumulator tiles of the step, which are exactly the
//     A operand of P.V, so e^(s - m) * dm goes from one product to the next
//     with one pack per register. The online softmax rescales once per 16
//     keys. Each step's e^(s - m) * dm is rounded to bf16 before P.V (the
//     reference rounds the normalised probability: the two round at points a
//     rounding apart, within one bf16 ulp of out).
//   - the rest as the f32 kernel: a warp per 16-row strip, bias and dropout
//     mask read one step ahead in the accumulator's layout, padding keys at
//     -inf, accurate expf, one owner per output, no atomics (bit-equal calls).
//   The softmax stays online: holding a strip's whole row of scores in
//   registers (80 a lane at Lk = 160) would save the rescales but not the
//   exps, and was not built. At D = 16 a step of 16 keys by 16 rows issues
//   360 warp instructions (1.4 per score), where the f32 kernel instantiated
//   for bf16 I/O issued 398 per 8 keys (3.1 per score); counted in the SASS
//   by genrec_tpu_torch/tools/sass_loops.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "t5_attention_bf16.cuh"

namespace {

constexpr int kWarps = 5;  // 80-row and 160-row query tiles split evenly
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e9f;
constexpr int kMaxD = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on H100
constexpr int kFillBlocks = 264;     // two blocks per SM of an H100: split strips below
constexpr int kMinBlocksD16 = 4;     // blocks per SM the D <= 16 build is held to

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int strips_of(int lq) { return (lq + 15) / 16; }

// 8-wide feature steps: D padded to 8, 16, 32, 64 or 128.
int nd_of(int d) { return d <= 8 ? 1 : d <= 16 ? 2 : d <= 32 ? 4 : d <= 64 ? 8 : 16; }

size_t smem_floats(int lk, int d) {
  const size_t stride = 8 * nd_of(d) + 4;
  const size_t lkp = pad8(lk);
  return 2 * lkp * stride  // K and V
         + lkp;            // additive key mask, -inf past the last key
}

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;  // q, k, v and out: f32 or bf16, as the entry point says
  const void* k;
  const void* v;
  const float* pos_bias;
  const int32_t* kv_mask;
  const float* dmask;
  void* out;
  int batch, lq, lk, d, causal;
  int spb;    // query strips per block
  int vec16;  // k and v staged 16 bytes at a time
  int pair;   // bias and dropout mask read 2 floats at a time
  int out2;   // out written 2 values at a time
};

// ---- f32 and bf16 I/O ----

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// A probability as the f32 P.V product takes it.
__device__ __forceinline__ float as_p(float x, const float*) { return x; }

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

// c += a.b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// A fragment of rows r0..r0+15, features k0..k0+7 of the flat row's q (lq x d
// in global memory), zero past the last row and the last feature.
template <typename T>
__device__ __forceinline__ void load_q(FragA& f, const T* q, const Params& P, int r0, int k0,
                                       int g, int t) {
  const int rows[2] = {r0 + g, r0 + g + 8}, cols[2] = {k0 + t, k0 + t + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = rows[e & 1], c = cols[e >> 1];
    split(i < P.lq && c < P.d ? ld(q + (i * P.d + c)) : 0.0f, f.hi[e], f.lo[e]);
  }
}

// A warp holds the A fragments of its 16-row strip over all ND feature steps
// in registers up to D = 64; at D = 128 it reloads each at its use.
template <int ND>
constexpr int kHeld = ND <= 8 ? ND : 1;

template <int ND, typename T>
__device__ __forceinline__ void hold(FragA (&f)[kHeld<ND>], const T* q, const Params& P,
                                     int r0, int g, int t) {
  if constexpr (ND <= 8) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) load_q(f[kk], q, P, r0, 8 * kk, g, t);
  }
}

// Feature step kk of a strip: held, or reloaded.
template <int ND, typename T>
__device__ __forceinline__ FragA step(const FragA (&f)[kHeld<ND>], const T* q,
                                      const Params& P, int r0, int kk, int g, int t) {
  if constexpr (ND <= 8) {
    return f[kk];
  } else {
    FragA a;
    load_q(a, q, P, r0, 8 * kk, g, t);
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

// The score of query i and key j from q.k, the bias value and the key-mask
// term (-inf past the last key), added in the reference's order.
__device__ __forceinline__ float score(float qk, float bias, float madd, const Params& P, int i,
                                       int j) {
  float s = qk + bias;
  if (P.causal && j > i + P.lk - P.lq) s += kNegInf;
  return s + madd;
}

// Values j and j + 1 of the row at `row` (an offset into x) of the bias or the
// dropout mask. Indices are clamped into the row: past the last key the score
// is -inf and the probability 0, so the (finite) value read there does not
// count, and no load needs a guard.
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

// The bias and dropout-mask values of the tile at key j (lane t: keys j, j + 1
// of rows roff[0] and roff[1]); 0 and 1 where none is given.
__device__ __forceinline__ void load_tile(float (&bv)[4], float (&dm)[4], const float* bias_h,
                                          const float* dm_hb, const int (&roff)[2], int j,
                                          const Params& P) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (bias_h) load2(bv[2 * r], bv[2 * r + 1], bias_h, roff[r], j, P);
    else bv[2 * r] = bv[2 * r + 1] = 0.0f;
    if (dm_hb) load2(dm[2 * r], dm[2 * r + 1], dm_hb, roff[r], j, P);
    else dm[2 * r] = dm[2 * r + 1] = 1.0f;
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
    for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
      const int r = idx / per_row, c = (idx - r * per_row) * 4;
      cp_async16(dst + r * stride + c, src + (size_t)r * d + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
      const int r = idx / d, c = idx - r * d;
      cp_async4(dst + r * stride + c, src + idx);
    }
  }
}

// Zeros where a staged matrix has no data: rows >= rows, features >= d.
__device__ __forceinline__ void zero_pad(float* dst, int rows, int rows_p, int d, int dp,
                                         int stride) {
  for (int idx = threadIdx.x; idx < rows_p * dp; idx += blockDim.x) {
    const int r = idx / dp, c = idx - r * dp;
    if (r >= rows || c >= d) dst[r * stride + c] = 0.0f;
  }
}

// ---- a warp per 16-row query strip ----

template <int ND, typename T>
__device__ __forceinline__ void strip(const Params& P, const T* q_hb, const float* sk,
                                      const float* sv, const float* madd, const float* bias_h,
                                      const float* dm_hb, T* out_hb, int r0, int lkp, int g,
                                      int t) {
  constexpr int S = 8 * ND + 4;
  FragA qa[kHeld<ND>];
  hold<ND>(qa, q_hb, P, r0, g, t);
  const int rows[2] = {r0 + g, r0 + g + 8};
  // the offsets of the rows of the bias and the dropout mask; padding rows
  // read the last row (they are never stored), so the loads need no guard
  const int roff[2] = {min(rows[0], P.lq - 1) * P.lk, min(rows[1], P.lq - 1) * P.lk};

  // m: the row's running max, the same on the four lanes of a quad; it starts
  // finite, so padding keys (-inf) give e = 0 and never a NaN. l: this lane's
  // part of sum e^(s - m). acc: sum e^(s - m) * dm * v over the keys so far.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  float bv[4], dm[4];
  load_tile(bv, dm, bias_h, dm_hb, roff, 2 * t, P);
  for (int n0 = 0; n0 < lkp; n0 += 8) {
    const int j = n0 + 2 * t;
    float bn[4], dn[4];  // the next tile's (clamped past the end: never used there)
    load_tile(bn, dn, bias_h, dm_hb, roff, j + 8, P);
    const float2 mk = *reinterpret_cast<const float2*>(madd + j);
    // each 8-deep step's product in a fresh accumulator, added to the sum in
    // f32: the tensor cores' own additions do not round to nearest, and along
    // one chain of 3 * ND of them the error grows with D
    float s[4];
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      FragB b;
      load_bt(b, sk, S, n0, 8 * kk, g, t);
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma3(c, step<ND>(qa, q_hb, P, r0, kk, g, t), b);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = kk == 0 ? c[e] : s[e] + c[e];
    }
    float p[4], scale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float s0 = score(s[2 * r], bv[2 * r], mk.x, P, rows[r], j);
      const float s1 = score(s[2 * r + 1], bv[2 * r + 1], mk.y, P, rows[r], j + 1);
      float mx = fmaxf(s0, s1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(m[r], mx);
      scale[r] = mx > m[r] ? expf(m[r] - mx) : 1.0f;  // expf(0) is 1
      const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
      l[r] = l[r] * scale[r] + e0 + e1;
      p[2 * r] = as_p(e0 * dm[2 * r], q_hb);
      p[2 * r + 1] = as_p(e1 * dm[2 * r + 1], q_hb);
      m[r] = mx;
    }
    // the tile's P.V, likewise in a fresh accumulator: acc = acc * scale + P.V
    FragA a;
    a_from_c(a, p);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      FragB b;
      load_b(b, sv, S, n0, 8 * nd, g, t);
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma3(c, a, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = fmaf(acc[nd][e], scale[e >> 1], c[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = bn[e], dm[e] = dn[e];
  }
  // the four lanes of a quad hold one row's keys: sum their l, identically on
  // each (a sum of two is commutative)
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    den[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rows[r], c = 8 * nd + 2 * t;
      if (i >= P.lq || c >= P.d) continue;
      const float o0 = acc[nd][2 * r] / den[r], o1 = acc[nd][2 * r + 1] / den[r];
      T* dst = out_hb + (i * P.d + c);
      if (P.out2) {  // d even: c + 1 < d
        st2(dst, o0, o1);
      } else {
        st(dst, o0);
        if (c + 1 < P.d) st(dst + 1, o1);
      }
    }
}

// A block of one flat row hb (blockIdx.x) and strips blockIdx.y * spb onwards,
// q, k, v and out of type T.
template <int ND, typename T>
__device__ __forceinline__ void fwd_block(const Params& P) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = 8 * ND + 4;
  const int lkp = pad8(P.lk);
  float* sk = smem;
  float* sv = sk + lkp * S;
  float* madd = sv + lkp * S;

  const int hb = blockIdx.x, h = hb / P.batch, b = hb - h * P.batch;
  const size_t kv_off = (size_t)hb * P.lk * P.d;
  zero_pad(sk, P.lk, lkp, P.d, 8 * ND, S);  // the staging below never writes these
  zero_pad(sv, P.lk, lkp, P.d, 8 * ND, S);
  stage(sk, static_cast<const T*>(P.k) + kv_off, P.lk, P.d, S, P.vec16);
  stage(sv, static_cast<const T*>(P.v) + kv_off, P.lk, P.d, S, P.vec16);
  asm volatile("cp.async.commit_group;");
  for (int j = threadIdx.x; j < lkp; j += blockDim.x)
    madd[j] = j >= P.lk  ? -INFINITY
              : P.kv_mask ? (1.0f - (float)P.kv_mask[(size_t)b * P.lk + j]) * kNegInf
                          : 0.0f;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* q_hb = static_cast<const T*>(P.q) + (size_t)hb * P.lq * P.d;
  const float* bias_h = P.pos_bias ? P.pos_bias + (size_t)h * P.lq * P.lk : nullptr;
  const float* dm_hb = P.dmask ? P.dmask + (size_t)hb * P.lq * P.lk : nullptr;
  T* out_hb = static_cast<T*>(P.out) + (size_t)hb * P.lq * P.d;
  const int first = blockIdx.y * P.spb, last = min(first + P.spb, strips_of(P.lq));
  for (int st = first + warp; st < last; st += blockDim.x >> 5)  // warp-uniform
    strip<ND>(P, q_hb, sk, sv, madd, bias_h, dm_hb, out_hb, 16 * st, lkp, g, t);
}

template <int ND>
__global__ void __launch_bounds__(kThreads, ND <= 2 ? kMinBlocksD16 : (ND == 4 ? 2 : 1))
t5_attention_fwd_kernel(const Params P) {
  fwd_block<ND, float>(P);
}

// ---- the bf16 entry: bf16 operands, m16n8k16 products, 16-key steps ----

namespace tb = t5bf16;

// The A operand of rows r0..r0+15, features c0..c0+15 of the flat row's q (lq
// x d bf16 values in global memory), zero past the last row and feature.
__device__ __forceinline__ void load_q16(uint32_t (&a)[4], const bf16* q, const Params& P,
                                         int r0, int c0, int g, int t) {
  const unsigned short* x = reinterpret_cast<const unsigned short*>(q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = r0 + g + 8 * (e & 1), c = c0 + 2 * t + 8 * (e >> 1);
    const bool row = i < P.lq;
    const uint32_t lo = row && c < P.d ? __ldg(x + (i * P.d + c)) : 0u;
    const uint32_t hi = row && c + 1 < P.d ? __ldg(x + (i * P.d + c + 1)) : 0u;
    a[e] = lo | (hi << 16);
  }
}

// The bias and dropout-mask values of a 16-key step (lane t: keys j, j + 1,
// j + 8, j + 9 of rows roff[0] and roff[1], j = n0 + 2t): x[4h + 2r + c] is
// row r, key j + 8h + c, the order of the two C tiles' values. 0 and 1 where
// none is given.
__device__ __forceinline__ void load_tile16(float (&bv)[8], float (&dm)[8], const float* bias_h,
                                            const float* dm_hb, const int (&roff)[2], int j,
                                            const Params& P) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int x = 4 * h + 2 * r;
      if (bias_h) load2(bv[x], bv[x + 1], bias_h, roff[r], j + 8 * h, P);
      else bv[x] = bv[x + 1] = 0.0f;
      if (dm_hb) load2(dm[x], dm[x + 1], dm_hb, roff[r], j + 8 * h, P);
      else dm[x] = dm[x + 1] = 1.0f;
    }
}

// A warp's 16-row query strip at bf16: q.k and P.V as one m16n8k16 bf16 pass
// each (exact products, f32 sums), the online softmax once per 16 keys.
template <int KD>
__device__ __forceinline__ void strip_bf16(const Params& P, const bf16* q_hb, const bf16* sk,
                                           const bf16* sv, const float* madd,
                                           const float* bias_h, const float* dm_hb,
                                           bf16* out_hb, int r0, int lkp, int lane) {
  constexpr int S = tb::kStride<KD>;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_q16(qa[kk], q_hb, P, r0, 16 * kk, g, t);
  const int rows[2] = {r0 + g, r0 + g + 8};
  // padding rows read the last row of the bias and the mask (never stored)
  const int roff[2] = {min(rows[0], P.lq - 1) * P.lk, min(rows[1], P.lq - 1) * P.lk};

  // m, l and acc as in the f32 strip, over 16 keys a step
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f};
  float acc[2 * KD][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  float bv[8], dm[8];
  load_tile16(bv, dm, bias_h, dm_hb, roff, 2 * t, P);
  for (int n0 = 0; n0 < lkp; n0 += 16) {
    const int j = n0 + 2 * t;
    float bn[8], dn[8];  // the next step's (clamped past the end: never used there)
    load_tile16(bn, dn, bias_h, dm_hb, roff, j + 16, P);
    const float2 mk[2] = {*reinterpret_cast<const float2*>(madd + j),
                          *reinterpret_cast<const float2*>(madd + j + 8)};
    // s[h]: keys n0 + 8h.. of the strip; each 16-deep step in a fresh
    // accumulator, added in f32
    float s[2][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t b[4];
      tb::ldsm4(b, tb::b_addr<S>(sk, n0, 16 * kk, lane));
      float c0[4], c1[4];
      tb::mma0(c0, qa[kk], b[0], b[1]);
      tb::mma0(c1, qa[kk], b[2], b[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][e] = kk == 0 ? c0[e] : s[0][e] + c0[e];
        s[1][e] = kk == 0 ? c1[e] : s[1][e] + c1[e];
      }
    }
    float p[2][4], scale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[2 * h] = score(s[h][2 * r], bv[4 * h + 2 * r], mk[h].x, P, rows[r], j + 8 * h);
        x[2 * h + 1] =
            score(s[h][2 * r + 1], bv[4 * h + 2 * r + 1], mk[h].y, P, rows[r], j + 8 * h + 1);
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(m[r], mx);
      scale[r] = mx > m[r] ? expf(m[r] - mx) : 1.0f;  // expf(0) is 1
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = expf(x[c] - mx);
      l[r] = l[r] * scale[r] + ((e[0] + e[1]) + (e[2] + e[3]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][2 * r] = e[2 * h] * dm[4 * h + 2 * r];
        p[h][2 * r + 1] = e[2 * h + 1] * dm[4 * h + 2 * r + 1];
      }
      m[r] = mx;
    }
    // P.V: e^(s - m) * dm rounded to bf16 (the reference rounds p to v's
    // dtype), V's B operands by a transposed ldmatrix; acc = acc * scale + P.V
    uint32_t a[4];
    tb::a_from_c(a, p[0], p[1]);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t b[4];
      tb::ldsm4_t(b, tb::a_addr<S>(sv, n0, 16 * kk, lane));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float c[4];
        tb::mma0(c, a, b[2 * h], b[2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[2 * kk + h][e] = fmaf(acc[2 * kk + h][e], scale[e >> 1], c[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) bv[e] = bn[e], dm[e] = dn[e];
  }
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    den[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = rows[r], c = 8 * nd + 2 * t;
      if (i >= P.lq || c >= P.d) continue;
      const float o0 = acc[nd][2 * r] / den[r], o1 = acc[nd][2 * r + 1] / den[r];
      bf16* dst = out_hb + (i * P.d + c);
      if (P.out2) {  // d even: c + 1 < d
        st2(dst, o0, o1);
      } else {
        st(dst, o0);
        if (c + 1 < P.d) st(dst + 1, o1);
      }
    }
}

// A block of one flat row hb (blockIdx.x) and strips blockIdx.y * spb onwards,
// bf16 q, k, v and out: K and V staged as bf16 by cp.async, keys padded to 16.
template <int KD>
__device__ __forceinline__ void fwd_block_bf16(const Params& P) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  constexpr int S = tb::kStride<KD>;
  const int lkp = tb::pad16(P.lk);
  bf16* sk = reinterpret_cast<bf16*>(smem_bf16);
  bf16* sv = sk + lkp * S;
  float* madd = reinterpret_cast<float*>(sv + lkp * S);  // lkp * S * 2 bytes: 16-aligned

  const int hb = blockIdx.x, h = hb / P.batch, b = hb - h * P.batch;
  const size_t kv_off = (size_t)hb * P.lk * P.d;
  tb::zero_pad(sk, P.lk, lkp, P.d, 16 * KD, S);  // the staging below never writes these
  tb::zero_pad(sv, P.lk, lkp, P.d, 16 * KD, S);
  tb::stage(sk, static_cast<const bf16*>(P.k) + kv_off, P.lk, P.d, S, P.vec16);
  tb::stage(sv, static_cast<const bf16*>(P.v) + kv_off, P.lk, P.d, S, P.vec16);
  asm volatile("cp.async.commit_group;");
  for (int j = threadIdx.x; j < lkp; j += blockDim.x)
    madd[j] = j >= P.lk  ? -INFINITY
              : P.kv_mask ? (1.0f - (float)P.kv_mask[(size_t)b * P.lk + j]) * kNegInf
                          : 0.0f;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* q_hb = static_cast<const bf16*>(P.q) + (size_t)hb * P.lq * P.d;
  const float* bias_h = P.pos_bias ? P.pos_bias + (size_t)h * P.lq * P.lk : nullptr;
  const float* dm_hb = P.dmask ? P.dmask + (size_t)hb * P.lq * P.lk : nullptr;
  bf16* out_hb = static_cast<bf16*>(P.out) + (size_t)hb * P.lq * P.d;
  const int first = blockIdx.y * P.spb, last = min(first + P.spb, strips_of(P.lq));
  for (int st = first + warp; st < last; st += blockDim.x >> 5)  // warp-uniform
    strip_bf16<KD>(P, q_hb, sk, sv, madd, bias_h, dm_hb, out_hb, 16 * st, lkp, lane);
}

template <int KD>
__global__ void __launch_bounds__(kThreads, KD == 1 ? kMinBlocksD16 : (KD == 2 ? 2 : 1))
t5_attention_fwd_bf16_kernel(const Params P) {
  fwd_block_bf16<KD>(P);
}

using Kernel = void (*)(Params);

// The kernel for I/O type T at feature width d, and its shared memory at (lk, d).
template <typename T>
Kernel kernel_of(int d);

template <>
Kernel kernel_of<float>(int d) {
  switch (nd_of(d)) {
    case 1: return &t5_attention_fwd_kernel<1>;
    case 2: return &t5_attention_fwd_kernel<2>;
    case 4: return &t5_attention_fwd_kernel<4>;
    case 8: return &t5_attention_fwd_kernel<8>;
    default: return &t5_attention_fwd_kernel<16>;
  }
}

template <>
Kernel kernel_of<bf16>(int d) {
  switch (tb::kd_of(d)) {
    case 1: return &t5_attention_fwd_bf16_kernel<1>;
    case 2: return &t5_attention_fwd_bf16_kernel<2>;
    case 4: return &t5_attention_fwd_bf16_kernel<4>;
    default: return &t5_attention_fwd_bf16_kernel<8>;
  }
}

template <typename T>
size_t smem_bytes(int lk, int d);

template <>
size_t smem_bytes<float>(int lk, int d) {
  return smem_floats(lk, d) * sizeof(float);
}

template <>
size_t smem_bytes<bf16>(int lk, int d) {  // K and V in bf16, the key mask in f32
  const size_t lkp = tb::pad16(lk);
  return 2 * lkp * (16 * tb::kd_of(d) + 8) * sizeof(bf16) + lkp * sizeof(float);
}

cudaError_t prepare(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t launch(Kernel k, Params P, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  const cudaError_t e = prepare(k, smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&P};
  const cudaError_t l = cudaLaunchKernel(reinterpret_cast<const void*>(k), grid, dim3(threads),
                                         args, smem, stream);
  return l != cudaSuccess ? l : cudaGetLastError();
}

int occupancy(Kernel k, int threads, size_t smem) {
  cudaError_t e = prepare(k, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Query strips per block: all of a flat row's when there are enough flat rows
// to give every SM two blocks, else as few as keep kFillBlocks blocks busy.
int strips_per_block(int hb, int lq) {
  const int n = strips_of(lq);
  if (hb >= kFillBlocks) return n;
  const long long want = ((long long)hb * n + kFillBlocks - 1) / kFillBlocks;
  return (int)(want < n ? want : n);
}

int threads_of(int spb) { return 32 * (spb < kWarps ? spb : kWarps); }

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
int blocks_per_sm(int lq, int lk, int d) {
  const size_t smem = smem_bytes<T>(lk, d);
  if (smem > kMaxSmem || lq <= 0 || lk <= 0 || d <= 0 || d > kMaxD)
    return -static_cast<int>(cudaErrorInvalidValue);
  return occupancy(kernel_of<T>(d), threads_of(strips_of(lq)), smem);
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* pos_bias, const void* kv_mask,
        const void* dmask, void* out, int hb, int batch, int lq, int lk, int d, int causal,
        void* stream) {
  const size_t smem = smem_bytes<T>(lk, d);
  if (smem > kMaxSmem || hb <= 0 || batch <= 0 || hb % batch != 0 || lq <= 0 || lk <= 0 ||
      d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int spb = strips_per_block(hb, lq);
  constexpr int per16 = 16 / sizeof(T);  // values in one 16-byte staging load
  Params P{q, k, v,
           static_cast<const float*>(pos_bias),
           static_cast<const int32_t*>(kv_mask),
           static_cast<const float*>(dmask),
           out,
           batch, lq, lk, d, causal, spb,
           d % per16 == 0 && aligned(k, 16) && aligned(v, 16),
           lk % 2 == 0 && aligned(pos_bias, 8) && aligned(dmask, 8),
           d % 2 == 0 && aligned(out, 2 * sizeof(T))};
  const dim3 grid(hb, (strips_of(lq) + spb - 1) / spb);
  return static_cast<int>(launch(kernel_of<T>(d), P, grid, threads_of(spb), smem,
                                 static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the f32 (bf16) kernel needs for (lk, d).
size_t t5_attention_fwd_smem_bytes(int lk, int d) { return smem_bytes<float>(lk, d); }
size_t t5_attention_fwd_bf16_smem_bytes(int lk, int d) { return smem_bytes<bf16>(lk, d); }

// Blocks of the f32 (bf16) forward kernel resident on one SM at (lq, lk, d)
// when each block takes a whole flat row, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus the CUDA error on failure.
int t5_attention_fwd_blocks_per_sm(int lq, int lk, int d) {
  return blocks_per_sm<float>(lq, lk, d);
}
int t5_attention_fwd_bf16_blocks_per_sm(int lq, int lk, int d) {
  return blocks_per_sm<bf16>(lq, lk, d);
}

// Registers per thread and bytes of local memory per thread (spills and
// stack; 0 if nothing spills) of the bf16 forward kernel at width d, as the
// loaded build has them (cudaFuncGetAttributes); returns the CUDA error.
int t5_attention_fwd_bf16_registers(int d, int* registers, int* local_bytes) {
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a{};
  const cudaError_t e =
      cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel_of<bf16>(d)));
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(e);
}

const char* t5_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: (hb, lq, d), k/v: (hb, lk, d), pos_bias: (hb / batch, lq, lk) or NULL,
// kv_mask: (batch, lk) int32 or NULL, dmask: (hb, lq, lk) or NULL,
// out: (hb, lq, d). All f32 except kv_mask, contiguous, on the device; d <= 128.
// Launches on `stream` and returns cudaGetLastError().
int t5_attention_fwd(const void* q, const void* k, const void* v, const void* pos_bias,
                     const void* kv_mask, const void* dmask, void* out, int hb, int batch,
                     int lq, int lk, int d, int causal, void* stream) {
  return run<float>(q, k, v, pos_bias, kv_mask, dmask, out, hb, batch, lq, lk, d, causal,
                    stream);
}

// As t5_attention_fwd, with q, k, v and out in bf16 (pos_bias and dmask f32).
int t5_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* pos_bias,
                          const void* kv_mask, const void* dmask, void* out, int hb, int batch,
                          int lq, int lk, int d, int causal, void* stream) {
  return run<bf16>(q, k, v, pos_bias, kv_mask, dmask, out, hb, batch, lq, lk, d, causal,
                   stream);
}

}  // extern "C"

// Blockwise flash attention backward (recompute from lse), f32 in and out, for
// Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of genrec_tpu/ops/attention.py:
//   - `_flash_bwd_dq_kernel` (:251) and `_flash_bwd_dkv_kernel` (:292),
//     called by `_flash_backward` (:484, pallas_calls :520 and :530);
//   - `_flash_bwd_dq_kernel_blocked` (:354) and `_flash_bwd_dkv_kernel_blocked`
//     (:391), called by `_flash_backward_blocked` (:437, pallas_calls :452 and
//     :471), which accumulate into f32 output blocks so that VMEM never holds
//     a full-length ref.
// That split exists on the TPU only for its VMEM limit; here the dq kernel and
// the dk/dv kernel serve both routes: K/V (or Q/dO) tiles are staged in shared
// memory whatever the length.
//
// What they compute: p = exp(q·kᵀ·scale − lse) (exactly 0 where col > row under
// causal), ds = p·(do·vᵀ − delta), dq = ds·k·scale, dk = dsᵀ·q·scale,
// dv = pᵀ·do; delta = rowsum(do·o) comes in from the caller (a torch
// reduction, as it is an XLA op outside Pallas in the reference).
//
// Layout: q, do, dq (BH, Lq, D); k, v, dk, dv (BH, Lk, D); lse and delta
// (BH, Lq); all contiguous f32. Lq and Lk multiples of 64, D ≤ 128; causal
// needs lq == lk (the reference's diagonal has no lk − lq offset).
//
// What bounds them on this card: at the long-context SASRec shape (BH 128,
// L 2048, D 16, causal) 268.6 M unmasked scores, each 6·D (dq: q·k, do·v,
// ds·k) or 8·D (dk/dv: q·k, do·v, p·do, ds·q) product operations and about 4
// more (exp, two subtractions, a product). At the data sheet's TF32 rate, in
// three passes (495/3 TFLOP/s), the products take 0.156 ms (dq) and 0.208 ms
// (dk/dv); in f32 outside the tensor cores (67 TFLOP/s) 0.40 and 0.53 ms. The
// bytes take under 0.05 ms. At D = 16 a score is only a few tensor-core
// operations, so what the kernels issue around each mma bounds them: the
// design spends its effort on the warp instructions per score.
//
// Design, deterministic, no atomics: every output row is written by one warp.
//   - blocks of 4 warps over 64 rows of the block's own side (query rows for
//     dq, key rows for dk/dv); a warp owns a 16-row strip and holds its rows'
//     A fragments (Q and dO for dq, K and V for dk/dv) split into TF32 pairs in
//     registers up to D = 64 (dq) or 32 (dk/dv), reloaded from global memory at
//     each use above that, and its gradient rows in mma accumulators.
//   - the other side streams through shared memory in tiles of KT rows (64 up
//     to D = 32, 2048 / D above, so that every D fits), in two stages: cp.async
//     brings tile i + 1 into a raw f32 tile while the warps work on tile i;
//     then the block splits each value of it ONCE into its TF32 (hi, lo) pair
//     and writes it in the mma fragments' own order, one 16-byte entry per lane
//     and 8 x 8 step, for each of the two operand layouts it is read in (X·Yᵀ:
//     row g, features t, t + 4; C·Y: rows 2t, 2t + 1, feature g). A warp's B
//     operand is then one conflict-free 16-byte shared load, (hi0, hi1, lo0,
//     lo1) in adjacent registers, and no arithmetic: the split is paid once
//     per block, not once per warp.
//   - dq, a warp per 16 query rows, 8 keys at a time: s = q·kᵀ and dp = do·vᵀ
//     (mma.sync m16n8k8, 3xTF32), p = 2^(s·(scale·log2e) − lse·log2e) with
//     one FFMA and one ex2.approx (the accurate expf on the tiles that cross
//     the diagonal; see exp_score), ds = p·(dp − delta) in the accumulator
//     layout, and dq += ds·k with ds fed back as the A operand, its keys
//     relabelled (k = t is key 2t, k = t + 4 key 2t + 1) and k read in the same
//     order, so no shuffle is needed.
//   - dk/dv, transposed, a warp per 16 keys, 8 queries at a time: sᵀ = k·qᵀ,
//     dpᵀ = v·doᵀ, p and ds from lse and delta read per query column (a float4
//     of two queries' lse·log2e and delta a lane), then dv += pᵀ·do and
//     dk += dsᵀ·q with the queries relabelled the same way.
//   - 3xTF32: a = hi + lo, hi = cvt.rna(a); lo·hi + hi·lo + hi·hi into an
//     accumulator; one TF32 pass is about 1.5e-3 off. Each 8-deep step (8
//     features of a score, 8 keys or queries of a gradient) starts a fresh
//     accumulator that is added to the sum in f32: the tensor cores' own
//     additions do not round to nearest, and chained through one accumulator
//     they put D = 128 2.5x further from f64 (kernel #1, PERF.md).
//   - causal: whole tiles past the diagonal are never staged; inside the
//     diagonal's 64 x 64 block, per warp, the 8-row tiles wholly on the far
//     side are skipped, the two that cross it take the mask (p = 0 where
//     key > query) and the rest run the unmasked loop. No tile outside the
//     diagonal block carries a mask or a bounds check.
//   - the causal tail: the heaviest blocks go first. The grid is (BH, tiles):
//     blocks are handed out with blockIdx.x fastest, so tile index y = 0 of
//     every row goes first; for dq that is the LAST query tile (y reversed),
//     for dk/dv the first key tile. At L = 2048 the 4,096-block grid then ends
//     on short blocks, not long ones.
//   - registers: at D = 16 four blocks share an SM (128 registers a thread);
//     the staging addresses are recomputed from the parameters at each tile,
//     not kept, which keeps the dk/dv kernel under 128 without a spill.
//   - every output has one owner and a fixed summation order that does not
//     depend on scheduling: dq, dk and dv are bit-identical between two calls.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, tools/sass_loops.py;
// PERF.md §6): at D = 16 the dq tile loop issues 80 warp instructions per
// 8-key tile of a 16-row strip (0.63 per score, 18 of them HMMA) and the
// dk/dv loop 112 (0.88 per score, 24 HMMA). At (BH 128, L 2048, causal) dq
// takes 0.48-0.50 ms and dk/dv 0.64 ms of device time, 2.3x and 2.2x less
// than the one-thread-per-row kernels these replace, and about 3x their
// 3xTF32 bounds.
// What the rest is spent on is not measured; the likely causes are latency
// (three dependent HMMA per 8-deep step, 4-5 warps per SM sub-partition) and
// the two barriers per staged tile.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;  // the block's own rows: 64
constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

// 8-wide feature steps: D padded to 16, 32, 64 or 128.
int nd_of(int d) { return d <= 16 ? 2 : d <= 32 ? 4 : d <= 64 ? 8 : 16; }

// Rows of a streamed tile: 64 up to D = 32, then fewer so that every D fits.
template <int ND>
constexpr int kTileRows = ND <= 4 ? 64 : 256 / ND;

// A fragments held in registers (else reloaded from global memory at each use):
// the dq kernel holds Q and dO up to D = 64, the dk/dv kernel K and V up to
// D = 32 (it also holds two accumulators of D columns).
template <int ND, bool kDq>
constexpr bool kHold = kDq ? ND <= 8 : ND <= 4;

// Raw f32 tiles: row stride 8·ND + 4 floats, which makes both split reads
// below free of bank conflicts. Fragment entries: one uint4 per lane and 8 x 8
// step, (KT / 8) · ND · 32 of them per operand layout.
template <int ND>
constexpr int kRawStride = 8 * ND + 4;
template <int ND>
constexpr int kEntries = kTileRows<ND> / 8 * ND * 32;

// Bytes of shared memory: the raw tile of two matrices (K and V, or Q and dO)
// and, for dk/dv, lse and delta; then the fragment layouts (dq: K in
// both, V in one; dk/dv: Q and dO in both) and, for dk/dv, the per-query
// statistics (a float4 of two queries' lse·log2(e) and delta per lane of a
// quad and 8-row tile).
template <int ND, bool kDq>
constexpr size_t kSmemBytes =
    (2 * kTileRows<ND> * kRawStride<ND> + (kDq ? 0 : 2 * kTileRows<ND>)) * 4 +
    (kDq ? 3 : 4) * kEntries<ND> * 16 + (kDq ? 0 : kTileRows<ND> / 2 * 16);

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int lq, lk, d, causal;
  float scale;
  int vec16;  // q, k, v and do staged 16 bytes at a time
};

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

// A fragment entry of a B operand: (hi0, hi1, lo0, lo1) of its two values, so
// that each of the mma's register pairs is two adjacent registers of the load.
__device__ __forceinline__ uint4 split2(float x0, float x1) {
  uint4 e;
  split(x0, e.x, e.z);
  split(x1, e.y, e.w);
  return e;
}

struct FragA {  // 16 x 8, row-major: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a·b of one 8-deep step in 3xTF32, the small terms first, into a fresh
// accumulator. b is a fragment entry: (k = t, n = g) and (k = t + 4, n = g),
// his then los.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, uint4 b) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  mma(c, a.lo, b.x, b.y);
  mma(c, a.hi, b.z, b.w);
  mma(c, a.hi, b.x, b.y);
}

// An accumulator fragment (16 x 8: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)) as an A operand whose column t is column 2t and column t + 4 is 2t + 1.
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// A fragment of rows r0..r0+15, features k0..k0+7 of an (rows, d) matrix in
// global memory, zero past feature d.
__device__ __forceinline__ void load_a(FragA& f, const float* x, int d, int r0, int k0, int g,
                                       int t) {
  const int rows[2] = {r0 + g, r0 + g + 8}, cols[2] = {k0 + t, k0 + t + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = cols[e >> 1];
    split(c < d ? __ldg(x + ((size_t)rows[e & 1] * d + c)) : 0.0f, f.hi[e], f.lo[e]);
  }
}

// A strip's A fragments over all ND feature steps: held in registers, or
// (kHeld false) reloaded from global memory at each use.
template <int ND, bool kHeld>
struct Strip {
  FragA f[kHeld ? ND : 1];
  const float* x;
  int d, r0, g, t;

  __device__ __forceinline__ Strip(const float* x_, int d_, int r0_, int g_, int t_)
      : x(x_), d(d_), r0(r0_), g(g_), t(t_) {
    if constexpr (kHeld) {
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) load_a(f[kk], x, d, r0, 8 * kk, g, t);
    }
  }

  __device__ __forceinline__ FragA step(int kk) const {
    if constexpr (kHeld) {
      return f[kk];
    } else {
      FragA a;
      load_a(a, x, d, r0, 8 * kk, g, t);
      return a;
    }
  }
};

// p = exp(s·scale − lse) = 2^(s·c − l), c = scale·log2(e) and l =
// lse·log2(e) taken once per kernel and per row: one FFMA and one ex2.approx.
// ex2.approx is not rounded to nearest; its error reaches a few ulp. Over a
// long row that averages out in the sums, but not over the few keys of the first rows under
// causal, where it put dq 1.33x farther from f64 than the plain f32 version.
// So the tiles that cross the diagonal (kAccurate), which hold all of those
// keys and under 2% of the work at L = 2048, take the accurate expf of the
// same exponent. (Subtracting in natural units, fma(s, scale, −lse), and an
// FMUL to base 2 avoids the roundings of c and l, which shift all p of a row
// one way; measured, it cost time and was no closer overall.)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kAccurate>
__device__ __forceinline__ float exp_score(float s, float c, float l) {
  const float x = fmaf(s, c, -l);
  return kAccurate ? expf(x * kLn2) : ex2(x);
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

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// KT rows of width d from global memory (row stride d) into a raw tile at
// stride kRawStride; features past d are never written (zeroed once). A
// thread copies one column chunk of every STEP-th row.
template <int ND>
__device__ __forceinline__ void stage(float* dst, const float* src, int d, bool vec16) {
  constexpr int KT = kTileRows<ND>, RS = kRawStride<ND>, DP = 8 * ND;
  if (vec16) {
    constexpr int CH = DP / 4, STEP = kThreads / CH;
    const int c = (threadIdx.x % CH) * 4, r = threadIdx.x / CH;
    if (c < d) {
#pragma unroll
      for (int j = 0; j < KT / STEP; ++j)
        cp_async16(dst + (r + j * STEP) * RS + c, src + ((size_t)(r + j * STEP) * d + c));
    }
  } else {
    constexpr int STEP = kThreads / DP;
    const int c = threadIdx.x % DP, r = threadIdx.x / DP;
    if (c < d) {
#pragma unroll
      for (int j = 0; j < KT / STEP; ++j)
        cp_async4(dst + (r + j * STEP) * RS + c, src + ((size_t)(r + j * STEP) * d + c));
    }
  }
}

// Zeros in features d..8·ND − 1 of `n` raw tiles laid end to end.
template <int ND>
__device__ __forceinline__ void zero_features(float* raw, int n, int d) {
  constexpr int RS = kRawStride<ND>, DP = 8 * ND;
  const int w = DP - d;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < n * kTileRows<ND> * w; i += kThreads)
    raw[(i / w) * RS + d + i % w] = 0.0f;
}

// Split a raw tile into its fragment entries: `bt` in the X·Yᵀ layout (lane
// (g, t) of step (r8, kk): row 8·r8 + g, features 8·kk + t and + 4) and, if
// given, `b` in the C·Y layout (rows 8·r8 + 2t and + 1, feature 8·kk + g).
// Entry i = lane + 32·(ND·r8 + kk); thread x writes entries x + kThreads·j,
// whose step is warp + 4j, so every offset but the thread's own is a constant.
template <int ND>
__device__ __forceinline__ void split_tile(uint4* bt, uint4* b, const float* raw) {
  constexpr int RS = kRawStride<ND>, J = kEntries<ND> / kThreads;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // step w + 4j: kk and r8 of it, the warp's part apart (kWarps = 4 divides
  // or is divided by ND)
  const int kk0 = ND >= kWarps ? w : w % ND, r80 = ND >= kWarps ? 0 : w / ND;
  const float* x = raw + (8 * r80 + g) * RS + 8 * kk0 + t;
  const float* y = raw + (8 * r80 + 2 * t) * RS + 8 * kk0 + g;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int off = ND >= kWarps ? 8 * ((kWarps * j) / ND) * RS + 8 * ((kWarps * j) % ND)
                                 : 8 * ((kWarps * j) / ND) * RS;
    const int i = threadIdx.x + kThreads * j;
    bt[i] = split2(x[off], x[off + 4]);
    if (b) b[i] = split2(y[off], y[off + RS]);
  }
}

// ---- dq: a warp per 16 query rows ----

// One 8-key tile (step r8 of the staged tile) of a strip. kMask: p = 0 where
// the key lies past the query row; `diag` is the strip's first row minus the
// tile's first key.
template <int ND, bool kHeld, bool kMask>
__device__ __forceinline__ void dq_tile(float (&acc)[ND][4], const Strip<ND, kHeld>& qa,
                                        const Strip<ND, kHeld>& da, const uint4* kbt,
                                        const uint4* kb, const uint4* vbt, int r8, int lane,
                                        const float (&lse2)[2], const float (&dl)[2], float c2,
                                        int diag) {
  const int base = r8 * ND * 32 + lane;
  float s[4], dp[4], x[4];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    mma3(x, qa.step(kk), kbt[base + kk * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = kk == 0 ? x[e] : s[e] + x[e];
  }
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    mma3(x, da.step(kk), vbt[base + kk * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[e] = kk == 0 ? x[e] : dp[e] + x[e];
  }
  const int g = lane >> 2, t = lane & 3;
  float ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float p = exp_score<kMask>(s[e], c2, lse2[e >> 1]);
    if (kMask && 8 * r8 + 2 * t + (e & 1) > diag + g + 8 * (e >> 1)) p = 0.0f;
    ds[e] = p * (dp[e] - dl[e >> 1]);
  }
  FragA a;
  a_from_c(a, ds);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    mma3(x, a, kb[base + nd * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] += x[e];
  }
}

template <int ND>
__global__ void __launch_bounds__(kThreads, ND <= 2 ? 4 : (ND == 4 ? 2 : 1))
flash_bwd_dq_kernel(const Params P) {
  constexpr int KT = kTileRows<ND>, RS = kRawStride<ND>, E = kEntries<ND>;
  constexpr bool kHeld = kHold<ND, true>;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;  // [K, V][KT][RS]
  uint4* kbt = reinterpret_cast<uint4*>(raw + 2 * KT * RS);
  uint4* kb = kbt + E;
  uint4* vbt = kb + E;

  const int bh = blockIdx.x;
  const int qt = P.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = qt * kBlockRows + warp * 16;
  const size_t qoff = (size_t)bh * P.lq * P.d;
  const int n_tiles = (P.causal ? (qt + 1) * kBlockRows : P.lk) / KT;

  // rows k0.. of K and V into the raw tile; the addresses are recomputed from
  // the parameters, which keeps them out of registers
  auto stage_kv = [&](int k0) {
    const size_t row = (size_t)blockIdx.x * P.lk + k0;
    stage<ND>(raw, P.k + row * P.d, P.d, P.vec16);
    stage<ND>(raw + KT * RS, P.v + row * P.d, P.d, P.vec16);
    cp_commit();
  };
  zero_features<ND>(raw, 2, P.d);
  stage_kv(0);

  const Strip<ND, kHeld> qa(P.q + qoff, P.d, r0, g, t), da(P.dout + qoff, P.d, r0, g, t);
  float lse2[2], dl[2];  // lse·log2(e) and delta of the lane's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)bh * P.lq + r0 + g + 8 * r;
    lse2[r] = __ldg(P.lse + row) * kLog2e;
    dl[r] = __ldg(P.delta + row);
  }
  const float c2 = P.scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with the last fragments
    split_tile<ND>(kbt, kb, raw);
    split_tile<ND>(vbt, nullptr, raw + KT * RS);
    __syncthreads();  // the fragments are ready and the raw tile is free: load the next
    if (it + 1 < n_tiles) stage_kv((it + 1) * KT);
    const int k0 = it * KT;
    if (!P.causal || k0 + KT <= qt * kBlockRows) {  // below the diagonal block: no mask
#pragma unroll 1
      for (int r8 = 0; r8 < KT / 8; ++r8)
        dq_tile<ND, kHeld, false>(acc, qa, da, kbt, kb, vbt, r8, lane, lse2, dl, c2, 0);
    } else {  // in the diagonal block: unmasked before the strip, masked across it
      const int diag = r0 - k0;
      const int lo = min(max(diag, 0), KT) / 8, hi = min(max(diag + 16, 0), KT) / 8;
#pragma unroll 1
      for (int r8 = 0; r8 < lo; ++r8)
        dq_tile<ND, kHeld, false>(acc, qa, da, kbt, kb, vbt, r8, lane, lse2, dl, c2, 0);
#pragma unroll 1
      for (int r8 = lo; r8 < hi; ++r8)
        dq_tile<ND, kHeld, true>(acc, qa, da, kbt, kb, vbt, r8, lane, lse2, dl, c2, diag);
    }
  }

  float* dq = P.dq + (size_t)blockIdx.x * P.lq * P.d;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * nd + 2 * t + (e & 1);
      if (c < P.d) dq[(size_t)(r0 + g + 8 * (e >> 1)) * P.d + c] = acc[nd][e] * P.scale;
    }
}

// ---- dk/dv: a warp per 16 key rows ----

// One 8-query tile (step r8 of the staged tile) of a key strip. kMask: p = 0
// where the key lies past the query; `diag` is the strip's first key minus the
// tile's first query.
template <int ND, bool kHeld, bool kMask>
__device__ __forceinline__ void dkv_tile(float (&dka)[ND][4], float (&dva)[ND][4],
                                         const Strip<ND, kHeld>& ka, const Strip<ND, kHeld>& va,
                                         const uint4* qbt, const uint4* qb, const uint4* dbt,
                                         const uint4* db, const float4* stats, int r8, int lane,
                                         float c2, int diag) {
  const int base = r8 * ND * 32 + lane;
  float s[4], dp[4], x[4];
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    mma3(x, ka.step(kk), qbt[base + kk * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = kk == 0 ? x[e] : s[e] + x[e];
  }
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    mma3(x, va.step(kk), dbt[base + kk * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[e] = kk == 0 ? x[e] : dp[e] + x[e];
  }
  const int g = lane >> 2, t = lane & 3;
  const float4 st = stats[r8 * 4 + t];  // queries 2t, 2t + 1: lse·log2(e), then delta
  float p[4], ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p[e] = exp_score<kMask>(s[e], c2, (e & 1) ? st.y : st.x);
    if (kMask && diag + g + 8 * (e >> 1) > 8 * r8 + 2 * t + (e & 1)) p[e] = 0.0f;
    ds[e] = p[e] * (dp[e] - ((e & 1) ? st.w : st.z));
  }
  FragA a;
  a_from_c(a, p);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    mma3(x, a, db[base + nd * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[nd][e] += x[e];
  }
  a_from_c(a, ds);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    mma3(x, a, qb[base + nd * 32]);
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] += x[e];
  }
}

template <int ND>
__global__ void __launch_bounds__(kThreads, ND <= 2 ? 4 : (ND == 4 ? 2 : 1))
flash_bwd_dkv_kernel(const Params P) {
  constexpr int KT = kTileRows<ND>, RS = kRawStride<ND>, E = kEntries<ND>;
  constexpr int BUF = 2 * KT * RS + 2 * KT;  // Q, dO, lse, delta
  constexpr bool kHeld = kHold<ND, false>;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;  // Q, dO at stride RS; lse; delta
  uint4* qbt = reinterpret_cast<uint4*>(raw + BUF);
  uint4* qb = qbt + E;
  uint4* dbt = qb + E;
  uint4* db = dbt + E;
  float4* stats = reinterpret_cast<float4*>(db + E);  // [KT / 8][4 lanes]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // under causal the first key tiles see the most queries
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = kt * kBlockRows + warp * 16;
  const size_t koff = (size_t)bh * P.lk * P.d;
  const int q_first = P.causal ? kt * kBlockRows : 0;  // query tiles above see no key here
  const int n_tiles = (P.lq - q_first) / KT;

  // rows q0.. of Q, dO, lse and delta into the raw tile; the addresses are
  // recomputed from the parameters, which keeps them out of registers
  auto stage_all = [&](int q0) {
    const size_t row = (size_t)blockIdx.x * P.lq + q0;
    stage<ND>(raw, P.q + row * P.d, P.d, P.vec16);
    stage<ND>(raw + KT * RS, P.dout + row * P.d, P.d, P.vec16);
    for (int i = threadIdx.x; i < 2 * KT; i += kThreads)
      cp_async4(raw + 2 * KT * RS + i, (i < KT ? P.lse + row + i : P.delta + row + i - KT));
    cp_commit();
  };
  zero_features<ND>(raw, 2, P.d);
  stage_all(q_first);

  const Strip<ND, kHeld> ka(P.k + koff, P.d, j0, g, t), va(P.v + koff, P.d, j0, g, t);
  const float c2 = P.scale * kLog2e;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_first + it * KT;
    cp_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with the last fragments
    split_tile<ND>(qbt, qb, raw);
    split_tile<ND>(dbt, db, raw + KT * RS);
    if (threadIdx.x < KT / 2) {  // two queries a lane: lse·log2(e) and delta
      const float* l = raw + 2 * KT * RS + 2 * threadIdx.x;
      stats[threadIdx.x] = make_float4(l[0] * kLog2e, l[1] * kLog2e, l[KT], l[KT + 1]);
    }
    __syncthreads();  // the fragments are ready and the raw tile is free: load the next
    if (it + 1 < n_tiles) stage_all(q0 + KT);
    if (!P.causal || q0 >= (kt + 1) * kBlockRows) {  // past the diagonal block: no mask
#pragma unroll 1
      for (int r8 = 0; r8 < KT / 8; ++r8)
        dkv_tile<ND, kHeld, false>(dka, dva, ka, va, qbt, qb, dbt, db, stats, r8, lane,
                                   c2, 0);
    } else {  // in the diagonal block: skipped before the strip, masked across it
      const int diag = j0 - q0;
      const int lo = min(max(diag, 0), KT) / 8, hi = min(max(diag + 16, 0), KT) / 8;
#pragma unroll 1
      for (int r8 = lo; r8 < hi; ++r8)
        dkv_tile<ND, kHeld, true>(dka, dva, ka, va, qbt, qb, dbt, db, stats, r8, lane,
                                  c2, diag);
#pragma unroll 1
      for (int r8 = hi; r8 < KT / 8; ++r8)
        dkv_tile<ND, kHeld, false>(dka, dva, ka, va, qbt, qb, dbt, db, stats, r8, lane,
                                   c2, 0);
    }
  }

  float* dk = P.dk + (size_t)blockIdx.x * P.lk * P.d;
  float* dv = P.dv + (size_t)blockIdx.x * P.lk * P.d;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * nd + 2 * t + (e & 1);
      if (c < P.d) {
        const size_t o = (size_t)(j0 + g + 8 * (e >> 1)) * P.d + c;
        dk[o] = dka[nd][e] * P.scale;
        dv[o] = dva[nd][e];
      }
    }
}

// ---- host side ----

bool bad_shape(int bh, int lq, int lk, int d, int causal) {
  return bh <= 0 || lq <= 0 || lk <= 0 || lq % kBlockRows || lk % kBlockRows ||
         lq / kBlockRows > 65535 || lk / kBlockRows > 65535 || d <= 0 || d > kMaxD ||
         (causal && lq != lk);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Above 48 KB a kernel may use dynamic shared memory only once it is allowed
// to; set once per instantiation (and device: the port runs on one).
template <int ND, bool kDq>
cudaError_t allow_smem() {
  constexpr int smem = static_cast<int>(kSmemBytes<ND, kDq>);
  if (smem <= 48 * 1024) return cudaSuccess;
  static cudaError_t done = [] {
    if constexpr (kDq)
      return cudaFuncSetAttribute(flash_bwd_dq_kernel<ND>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    else
      return cudaFuncSetAttribute(flash_bwd_dkv_kernel<ND>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }();
  return done;
}

template <int ND, bool kDq>
cudaError_t launch(const Params& P, int bh, cudaStream_t stream) {
  const cudaError_t err = allow_smem<ND, kDq>();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = kSmemBytes<ND, kDq>;
  const dim3 grid(bh, (kDq ? P.lq : P.lk) / kBlockRows);
  if constexpr (kDq) flash_bwd_dq_kernel<ND><<<grid, kThreads, smem, stream>>>(P);
  else flash_bwd_dkv_kernel<ND><<<grid, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <bool kDq>
cudaError_t launch_d(const Params& P, int bh, cudaStream_t stream) {
  switch (nd_of(P.d)) {
    case 2: return launch<2, kDq>(P, bh, stream);
    case 4: return launch<4, kDq>(P, bh, stream);
    case 8: return launch<8, kDq>(P, bh, stream);
    default: return launch<16, kDq>(P, bh, stream);
  }
}

template <int ND, bool kDq>
cudaError_t func_attributes(cudaFuncAttributes* a) {
  if constexpr (kDq) return cudaFuncGetAttributes(a, flash_bwd_dq_kernel<ND>);
  else return cudaFuncGetAttributes(a, flash_bwd_dkv_kernel<ND>);
}

template <int ND, bool kDq>
int occupancy() {
  cudaError_t e = allow_smem<ND, kDq>();
  int n = 0;
  if (e == cudaSuccess) {
    if constexpr (kDq)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_bwd_dq_kernel<ND>, kThreads,
                                                        kSmemBytes<ND, kDq>);
    else
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_bwd_dkv_kernel<ND>, kThreads,
                                                        kSmemBytes<ND, kDq>);
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

Params params(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, float* dk, float* dv, int lq,
              int lk, int d, int causal, float scale) {
  const bool vec16 = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                     aligned16(dout);
  return Params{q, k, v, dout, lse, delta, dq, dk, dv, lq, lk, d, causal, scale, vec16};
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue (launching nothing) for shapes
// the kernels do not take.
int flash_attention_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                           const float* lse, const float* delta, float* dq, int bh, int lq,
                           int lk, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, lq, lk, d, causal)) return (int)cudaErrorInvalidValue;
  const Params P = params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, lq, lk, d, causal,
                          scale);
  return (int)launch_d<true>(P, bh, (cudaStream_t)stream);
}

int flash_attention_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                            const float* lse, const float* delta, float* dk, float* dv, int bh,
                            int lq, int lk, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, lq, lk, d, causal)) return (int)cudaErrorInvalidValue;
  const Params P = params(q, k, v, dout, lse, delta, nullptr, dk, dv, lq, lk, d, causal, scale);
  return (int)launch_d<false>(P, bh, (cudaStream_t)stream);
}

// Bytes of dynamic shared memory of one block of the dq (dq != 0) or the dk/dv
// kernel at width d.
size_t flash_attention_bwd_smem_bytes(int dq, int d) {
  switch (nd_of(d)) {
    case 2: return dq ? kSmemBytes<2, true> : kSmemBytes<2, false>;
    case 4: return dq ? kSmemBytes<4, true> : kSmemBytes<4, false>;
    case 8: return dq ? kSmemBytes<8, true> : kSmemBytes<8, false>;
    default: return dq ? kSmemBytes<16, true> : kSmemBytes<16, false>;
  }
}

// Blocks of the dq (dq != 0) or dk/dv kernel resident on one SM at width d,
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus the CUDA error on
// failure.
int flash_attention_bwd_blocks_per_sm(int dq, int d) {
  if (d <= 0 || d > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  switch (nd_of(d)) {
    case 2: return dq ? occupancy<2, true>() : occupancy<2, false>();
    case 4: return dq ? occupancy<4, true>() : occupancy<4, false>();
    case 8: return dq ? occupancy<8, true>() : occupancy<8, false>();
    default: return dq ? occupancy<16, true>() : occupancy<16, false>();
  }
}

// Registers per thread and bytes of local memory per thread (spills and stack;
// 0 if nothing spills) of the dq (dq != 0) or dk/dv kernel at width d, as the
// loaded build has them (cudaFuncGetAttributes); returns the CUDA error.
int flash_attention_bwd_registers(int dq, int d, int* registers, int* local_bytes) {
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a{};
  cudaError_t e;
  switch (nd_of(d)) {
    case 2: e = dq ? func_attributes<2, true>(&a) : func_attributes<2, false>(&a); break;
    case 4: e = dq ? func_attributes<4, true>(&a) : func_attributes<4, false>(&a); break;
    case 8: e = dq ? func_attributes<8, true>(&a) : func_attributes<8, false>(&a); break;
    default: e = dq ? func_attributes<16, true>(&a) : func_attributes<16, false>(&a);
  }
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return (int)e;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

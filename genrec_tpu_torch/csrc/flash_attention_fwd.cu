// Blockwise flash attention forward (online softmax), f32 in and out, for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of genrec_tpu/ops/attention.py:
//   - `_flash_kernel` (:69, called by `_flash_forward` :190, pallas_call :228),
//     the full-ref variant with an optional additive bias;
//   - `_flash_fwd_kernel_blocked` (:117, called by `_flash_forward_blocked`
//     :161, pallas_call :175), the same function with its online-softmax state
//     kept in the output refs so that VMEM never holds a full-length K/V.
// The split exists on the TPU only for its VMEM limit; here one kernel serves
// both routes: K/V tiles are staged in shared memory whatever the length.
//
// What it computes, per (B·H row, query row): s = q·kᵀ·scale (+ bias), keys
// past the diagonal masked under causal (no lk − lq offset: causal needs
// lq == lk), m = rowmax s, l = max(Σ exp(s − m), 1e-30), out = Σ exp(s − m)·v
// / l and lse = m + log l in natural units.
//
// Layout: q (BH, Lq, D), k and v (BH, Lk, D), bias (BH, Lq, Lk) or null, all
// contiguous f32; out (BH, Lq, D) and lse (BH, Lq) f32. Lq and Lk are
// multiples of 64 (the wrapper requires 128, as the reference does), D ≤ 128.
//
// What bounds it on this card: at the long-context SASRec shape (BH 128,
// L 2048, D 16, causal) 268.6 M unmasked scores, each 4·D product operations
// (q·k, p·v) and about 5 more (max, exponent, exp, sum, rescale). At the data
// sheet's TF32 rate in three passes (495/3 TFLOP/s) the products take 0.104
// ms; in f32 outside the tensor cores (67 TFLOP/s) everything takes 0.28 ms;
// the bytes (q, k, v, out, lse once) under 0.02 ms. At D = 16 a score is only
// a few tensor-core operations, so what the kernel issues around each mma
// bounds it: the design spends its effort on the warp instructions per score.
//
// Design (the structure of flash_attention_bwd.cu's dq kernel, with the
// online softmax of t5_attention_fwd.cu), deterministic, no atomics:
//   - blocks of 4 warps over 64 query rows; a warp owns a 16-row strip and
//     holds its Q rows' A fragments split into TF32 (hi, lo) pairs in
//     registers up to D = 64 (reloaded from global memory at each use above),
//     and its output rows in mma accumulators.
//   - K and V stream through shared memory in tiles of KT rows (64 up to
//     D = 32, 2048 / D above), in two stages: cp.async brings tile i + 1 into
//     a raw f32 tile while the warps work on tile i; the block then splits each
//     value ONCE into its TF32 pair, written in the mma fragments' order, one
//     16-byte entry per lane and 8 x 8 step: K in the X·Yᵀ order (row g,
//     features t, t + 4), V in the C·Y order (keys 2t, 2t + 1, feature g).
//   - s = q·kᵀ per 8-key tile in 3xTF32 (mma.sync m16n8k8: lo·hi + hi·lo +
//     hi·hi), a fresh accumulator per 8-deep feature step added to the sum in
//     f32.
//   - the online softmax in the accumulator layout: lane t of a quad holds
//     keys 2t and 2t + 1 of rows g and g + 8; the row max is agreed by two
//     __shfl_xor_sync and starts at −FLT_MAX; l is kept per lane and summed
//     across the quad once, at the end; the normalisation is deferred.
//   - the rescale, once per group of 4 tiles (32 keys) held in registers, FA2
//     style: their scores, the new max, then p and p·V, the rescale riding on
//     the group's first tile (acc = acc·α + p·V). At D = 16 a group of 4
//     measured as fast as a whole staged tile of 8 and faster than a rescale
//     per tile, and a group of 8 spilled at the 128 registers of 4 blocks per
//     SM (PERF.md §6). With a bias at D = 16 a group is 2 tiles.
//   - the exponent: p = 2^(y·c − e), y the score in the kernel's units (raw
//     q·k without a bias, q·k·scale + bias with one), c = u·log2(e) with u =
//     scale (1 with a bias), and e = ⌈m·c⌉, an integer: one FFMA and one
//     ex2.approx on unmasked tiles; on the tiles that cross the causal
//     diagonal, expf of the same exponent (the first rows of a causal
//     sequence have a handful of keys, and nothing averages ex2.approx's
//     error out there). Every rescale is by α = 2^(e_old − e), a power of two,
//     exact; l is kept in f64 (one addition per group), and lse = e·ln 2 +
//     log l − δ·m·u in f64 (δ = c·ln 2 / u − 1, the rounding of c), rounded
//     once: within f32's own rounding of lse, which the plain version's lse
//     sits at.
//   - the tensor cores round an mma's sum toward zero (truncation, not to
//     nearest), so a score comes out on average 0.72·2^-24 of itself short;
//     a second FFMA gives that back in each exponent (kTrunc, exp_score).
//   - p·V: the probabilities' accumulator fragment is fed back as the A
//     operand with its keys relabelled (k = t is key 2t, k = t + 4 key
//     2t + 1), V's fragments are in the same order: no shuffle.
//   - the bias, the materialised (BH, Lq, Lk) tensor, is read in the
//     accumulator layout, 8 bytes a lane, one 8-key tile ahead of its use.
//   - causal: whole tiles past the diagonal are never staged; inside the
//     diagonal's 64 x 64 block, per warp, the 8-key tiles wholly past the
//     strip are skipped, the two that cross it take the mask and the rest
//     run unmasked, each a group of one. No tile outside the diagonal block
//     carries a mask.
//   - the causal tail: the grid is (BH, tiles) and blocks are handed out
//     with blockIdx.x fastest; tile index y = 0 is the LAST query tile, so
//     the heaviest blocks go first.
//   - every output row has one owner and a fixed summation order: two calls
//     give bit-identical out and lse.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py,
// tools/sass_loops.py; PERF.md §6): at D = 16 the unmasked group loop issues
// 292 warp instructions per 4 tiles of 8 keys of a 16-row strip (73 a tile,
// 0.57 per score, 12 of them HMMA); 125 registers, 26,624 bytes of shared
// memory, 4 blocks per SM, no local memory. At (BH 128, L 2048, causal) it
// takes 0.3969-0.4057 ms of device time against 0.8883-0.9067 for the
// one-thread-per-row kernel it replaces (3.8x its 3xTF32 bound), at
// (16, 4096) 0.2127-0.2134 against 0.5878-0.5986. What the rest is spent on
// is not measured; as for the backward, the likely causes are the chains of
// three dependent HMMA and the two barriers per staged tile.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;  // query rows of a block: 64
constexpr int kMaxD = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;
constexpr double kLn2d = 0.69314718055994531;
// The tensor cores round the sum of an mma toward zero, not to nearest: a
// score q·k comes out on average half an ulp short, 0.72·2^-24 of itself (the
// mean of 1/mantissa). That shortfall is given back in each exponent, where
// it is not rounded away (see exp_score).
constexpr float kTrunc = 0.7213475204444817f * 0x1p-24f;

// 8-wide feature steps: D padded to 16, 32, 64 or 128.
int nd_of(int d) { return d <= 16 ? 2 : d <= 32 ? 4 : d <= 64 ? 8 : 16; }

// Keys of a streamed tile: 64 up to D = 32, then fewer so that every D fits.
template <int ND>
constexpr int kTileRows = ND <= 4 ? 64 : 256 / ND;

// Q's A fragments held in registers up to D = 64, else reloaded at each use.
template <int ND>
constexpr bool kHold = ND <= 8;

// 8-key tiles per online-softmax rescale on the staged tiles that need no mask:
// 4 (32 keys), or the whole staged tile where it holds fewer; 2 with a bias at
// D ≤ 16, where the bias rows' registers would make 4 spill.
template <int ND, bool kBias>
constexpr int kGroup = kBias && ND <= 2 ? 2 : kTileRows<ND> / 8 < 4 ? kTileRows<ND> / 8 : 4;

// Raw f32 tiles: row stride 8·ND + 4 floats, which makes both split reads
// below free of bank conflicts. Fragment entries: one uint4 per lane and 8 x 8
// step, (KT / 8) · ND · 32 of them per operand.
template <int ND>
constexpr int kRawStride = 8 * ND + 4;
template <int ND>
constexpr int kEntries = kTileRows<ND> / 8 * ND * 32;

// Bytes of shared memory: the raw tiles of K and V, then K's fragments in the
// X·Yᵀ order and V's in the C·Y order.
template <int ND>
constexpr size_t kSmemBytes = 2 * kTileRows<ND> * kRawStride<ND> * 4 + 2 * kEntries<ND> * 16;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  float* out;
  float* lse;
  int lq, lk, d, causal;
  float scale;
  int vec16;      // k and v staged 16 bytes at a time
  int bias_pair;  // the bias read 8 bytes at a time
  int out2;       // out written 8 bytes at a time
};

// ---- TF32 tensor-core helpers (as in flash_attention_bwd.cu) ----

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = 2^(y·c − e), y the score (q·k, or q·k·scale + bias) and e = ⌈m·c⌉ for
// its running max m: one FFMA and one ex2.approx, or (kAccurate, the tiles
// that cross the causal diagonal) expf of the same exponent. A second FFMA
// adds the tensor cores' mean shortfall back, s·ck with s = q·k as they
// summed it and ck = scale·log2(e)·kTrunc: the exponent is small where p
// matters, so the correction survives its rounding.
template <bool kAccurate>
__device__ __forceinline__ float exp_score(float y, float s, float c, float ck, float e) {
  const float x = fmaf(s, ck, fmaf(y, c, -e));
  return kAccurate ? expf(x * kLn2) : ex2(x);
}

// ---- staging (as in flash_attention_bwd.cu) ----

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

// Split a raw tile into its fragment entries, in the X·Yᵀ order (kBt: lane
// (g, t) of step (r8, kk): row 8·r8 + g, features 8·kk + t and + 4) or in the
// C·Y order (rows 8·r8 + 2t and + 1, feature 8·kk + g). Entry i = lane +
// 32·(ND·r8 + kk); thread x writes entries x + kThreads·j, whose step is
// warp + 4j, so every offset but the thread's own is a constant.
template <int ND, bool kBt>
__device__ __forceinline__ void split_tile(uint4* dst, const float* raw) {
  constexpr int RS = kRawStride<ND>, J = kEntries<ND> / kThreads;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  // step w + 4j: kk and r8 of it, the warp's part apart (kWarps = 4 divides
  // or is divided by ND)
  const int kk0 = ND >= kWarps ? w : w % ND, r80 = ND >= kWarps ? 0 : w / ND;
  const float* x = kBt ? raw + (8 * r80 + g) * RS + 8 * kk0 + t
                       : raw + (8 * r80 + 2 * t) * RS + 8 * kk0 + g;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int off = ND >= kWarps ? 8 * ((kWarps * j) / ND) * RS + 8 * ((kWarps * j) % ND)
                                 : 8 * ((kWarps * j) / ND) * RS;
    dst[threadIdx.x + kThreads * j] = kBt ? split2(x[off], x[off + 4])
                                          : split2(x[off], x[off + RS]);
  }
}

// ---- the bias ----

// A lane's two bias rows (g and g + 8 of its strip, `row8` floats apart);
// keys 2t, 2t + 1 of an 8-key tile are one float2 when the rows are 8-byte
// aligned.
struct BiasRows {
  const float* row;
  int row8;
  bool pair;

  __device__ __forceinline__ void load(float (&b)[4], int key) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* x = row + r * row8 + key;
      if (pair) {
        const float2 y = __ldg(reinterpret_cast<const float2*>(x));
        b[2 * r] = y.x, b[2 * r + 1] = y.y;
      } else {
        b[2 * r] = __ldg(x);
        b[2 * r + 1] = __ldg(x + 1);
      }
    }
  }
};

// ---- a warp per 16 query rows ----

// The online-softmax state of a lane's two rows: m, the running max of the
// scores in the kernel's units, and e = ⌈m·c⌉, an integer, the exponents'
// reference (both the same on the four lanes of a quad); l, this lane's part
// of Σ 2^(y·c − e), kept in f64 (one addition per group): over a long row an
// f32 sum moves lse by more than f32's own rounding of it. With an integer
// reference every rescale is by a power of two, exact, where exp2f's results
// are not.
struct Rows {
  float m[2], e[2];
  double l[2];
};

// G consecutive 8-key tiles (steps r8..r8 + G − 1 of the staged tile) of a
// strip, with one rescale: their scores, the new max, acc and l rescaled, then
// p and p·V. kMask: keys past the query row are masked; `diag` is the strip's
// first row minus the staged tile's first key. `key0` is the staged tile's
// first key (for the bias). c = u·log2(e), u the score's units (scale, or 1
// with a bias); ck = scale·log2(e)·kTrunc.
template <int ND, bool kHeld, int G, bool kMask, bool kBias>
__device__ __forceinline__ void fwd_tiles(float (&acc)[ND][4], Rows& st,
                                          const Strip<ND, kHeld>& qa, const uint4* kbt,
                                          const uint4* vb, int r8, int lane,
                                          const BiasRows& bias, int key0, float scale, float c,
                                          float ck, int diag) {
  const int g = lane >> 2, t = lane & 3;
  float s[G][4], x[4];               // q·k as the tensor cores sum it
  float y[kBias ? G : 1][4], bv[4];  // with a bias: the score q·k·scale + bias
  // the score in the kernel's units
  auto score = [&](int j, int e) -> float& {
    if constexpr (kBias) return y[j][e];
    else return s[j][e];
  };
  if constexpr (kBias) bias.load(bv, key0 + 8 * r8 + 2 * t);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float bn[4];  // the next tile's bias, loaded one tile ahead
    if constexpr (kBias) {
      if (j + 1 < G) bias.load(bn, key0 + 8 * (r8 + j + 1) + 2 * t);
    }
    const int base = (r8 + j) * ND * 32 + lane;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      mma3(x, qa.step(kk), kbt[base + kk * 32]);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = kk == 0 ? x[e] : s[j][e] + x[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kBias) y[j][e] = fmaf(s[j][e], scale, bv[e]);
      if (kMask && 8 * (r8 + j) + 2 * t + (e & 1) > diag + g + 8 * (e >> 1))
        score(j, e) = -INFINITY;
    }
    if constexpr (kBias) {
      if (j + 1 < G) {
#pragma unroll
        for (int e = 0; e < 4; ++e) bv[e] = bn[e];
      }
    }
  }
  // the new max of each row, agreed by the quad; a row's first tile always
  // holds a key at or before it (key 0), so m is finite from then on
  float alpha[2], e2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = st.m[r];
#pragma unroll
    for (int j = 0; j < G; ++j) mx = fmaxf(mx, fmaxf(score(j, 2 * r), score(j, 2 * r + 1)));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // the p so far are 2^(y·c − e_old): rescaled by 2^(e_old − e), a power of
    // two built from its exponent bits; 0 at the first tile
    e2[r] = ceilf(__fmul_rn(mx, c));
    const float d = st.e[r] - e2[r];
    alpha[r] = d >= -126.0f ? __int_as_float((127 + (int)d) << 23) : 0.0f;
    st.m[r] = mx;
    st.e[r] = e2[r];
  }
  // acc = acc·α + p·V, the rescale riding on the group's first tile; the
  // group's p are summed in a tree, then l = l·α + that sum in f64
  float pl[G][2];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)  // 0 if masked
      p[e] = exp_score<kMask>(score(j, e), s[j][e], c, ck, e2[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) pl[j][r] = p[2 * r] + p[2 * r + 1];
    FragA a;
    a_from_c(a, p);
    const int base = (r8 + j) * ND * 32 + lane;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      mma3(x, a, vb[base + nd * 32]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nd][e] = j == 0 ? fmaf(acc[nd][e], alpha[e >> 1], x[e]) : acc[nd][e] + x[e];
    }
  }
#pragma unroll
  for (int w = 1; w < G; w *= 2)
#pragma unroll
    for (int j = 0; j + w < G; j += 2 * w)
#pragma unroll
      for (int r = 0; r < 2; ++r) pl[j][r] += pl[j + w][r];
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = fma(st.l[r], (double)alpha[r], (double)pl[0][r]);
}

template <int ND, bool kBias>
__global__ void __launch_bounds__(kThreads, ND <= 2 ? 4 : (ND == 4 ? 2 : 1))
flash_fwd_kernel(const Params P) {
  constexpr int KT = kTileRows<ND>, RS = kRawStride<ND>, E = kEntries<ND>;
  constexpr int G = kGroup<ND, kBias>;
  constexpr bool kHeld = kHold<ND>;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;  // [K, V][KT][RS]
  uint4* kbt = reinterpret_cast<uint4*>(raw + 2 * KT * RS);
  uint4* vb = kbt + E;

  const int bh = blockIdx.x;
  const int qt = P.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = qt * kBlockRows + warp * 16;
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

  const Strip<ND, kHeld> qa(P.q + (size_t)bh * P.lq * P.d, P.d, r0, g, t);
  BiasRows bias{};
  if constexpr (kBias)
    bias = BiasRows{P.bias + ((size_t)bh * P.lq + r0 + g) * P.lk, 8 * P.lk, P.bias_pair != 0};
  const float u = kBias ? 1.0f : P.scale, c = u * kLog2e, ck = P.scale * kLog2e * kTrunc;
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  Rows st{{-FLT_MAX, -FLT_MAX}, {-INFINITY, -INFINITY}, {0.0, 0.0}};

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_all();
    __syncthreads();  // tile it has landed; every warp is done with the last fragments
    split_tile<ND, true>(kbt, raw);
    split_tile<ND, false>(vb, raw + KT * RS);
    __syncthreads();  // the fragments are ready and the raw tile is free: load the next
    if (it + 1 < n_tiles) stage_kv((it + 1) * KT);
    const int k0 = it * KT;
    if (!P.causal || k0 + KT <= qt * kBlockRows) {  // below the diagonal block: no mask
#pragma unroll 1
      for (int r8 = 0; r8 < KT / 8; r8 += G)
        fwd_tiles<ND, kHeld, G, false, kBias>(acc, st, qa, kbt, vb, r8, lane, bias, k0,
                                              P.scale, c, ck, 0);
    } else {  // in the diagonal block: unmasked before the strip, masked across it
      const int diag = r0 - k0;
      const int lo = min(max(diag, 0), KT) / 8, hi = min(max(diag + 16, 0), KT) / 8;
#pragma unroll 1
      for (int r8 = 0; r8 < lo; ++r8)
        fwd_tiles<ND, kHeld, 1, false, kBias>(acc, st, qa, kbt, vb, r8, lane, bias, k0,
                                              P.scale, c, ck, 0);
#pragma unroll 1
      for (int r8 = lo; r8 < hi; ++r8)
        fwd_tiles<ND, kHeld, 1, true, kBias>(acc, st, qa, kbt, vb, r8, lane, bias, k0,
                                             P.scale, c, ck, diag);
    }
  }

  // the four lanes of a quad hold one row's keys: sum their l, identically on
  // each (a sum of two is commutative), then normalise once
  double l[2];
  float lf[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __dadd_rn(st.l[r], __shfl_xor_sync(0xffffffffu, st.l[r], 1));
    l[r] = fmax(__dadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2)), 1e-30);
    lf[r] = (float)l[r];
  }
  const size_t row0 = (size_t)bh * P.lq + r0 + g;
  float* out = P.out + row0 * P.d;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = 8 * nd + 2 * t;
      if (col >= P.d) continue;
      const float o0 = acc[nd][2 * r] / lf[r], o1 = acc[nd][2 * r + 1] / lf[r];
      float* dst = out + (size_t)8 * r * P.d + col;
      if (P.out2) {  // d even: col + 1 < d
        *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
      } else {
        dst[0] = o0;
        if (col + 1 < P.d) dst[1] = o1;
      }
    }
  // lse = e·ln 2 + log l, taken in f64 and rounded once (e is an integer: no
  // rounded base-2 max is converted). c is u·log2(e) rounded to f32, so l sums
  // e^(y·u·(1 + δ)), δ = c·ln 2 / u − 1: δ·m·u is taken off.
  if (t == 0) {
    const double delta = (double)c * kLn2d / (double)u - 1.0;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      P.lse[row0 + 8 * r] =
          (float)(kLn2d * st.e[r] + log(l[r]) - delta * ((double)st.m[r] * u));
  }
}

// ---- host side ----

bool bad_shape(int bh, int lq, int lk, int d, int causal) {
  return bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || lq % kBlockRows || lk % kBlockRows ||
         lq / kBlockRows > 65535 || d <= 0 || d > kMaxD || (causal && lq != lk);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Above 48 KB a kernel may use dynamic shared memory only once it is allowed
// to; set once per instantiation (and device: the port runs on one).
template <int ND, bool kBias>
cudaError_t allow_smem() {
  constexpr int smem = static_cast<int>(kSmemBytes<ND>);
  if (smem <= 48 * 1024) return cudaSuccess;
  static cudaError_t done = cudaFuncSetAttribute(
      flash_fwd_kernel<ND, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return done;
}

template <int ND, bool kBias>
cudaError_t launch(const Params& P, int bh, cudaStream_t stream) {
  const cudaError_t err = allow_smem<ND, kBias>();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, P.lq / kBlockRows);
  flash_fwd_kernel<ND, kBias><<<grid, kThreads, kSmemBytes<ND>, stream>>>(P);
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t launch_d(const Params& P, int bh, cudaStream_t stream) {
  switch (nd_of(P.d)) {
    case 2: return launch<2, kBias>(P, bh, stream);
    case 4: return launch<4, kBias>(P, bh, stream);
    case 8: return launch<8, kBias>(P, bh, stream);
    default: return launch<16, kBias>(P, bh, stream);
  }
}

template <int ND, bool kBias>
int occupancy() {
  cudaError_t e = allow_smem<ND, kBias>();
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<ND, kBias>, kThreads,
                                                      kSmemBytes<ND>);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <bool kBias>
int occupancy_d(int d) {
  switch (nd_of(d)) {
    case 2: return occupancy<2, kBias>();
    case 4: return occupancy<4, kBias>();
    case 8: return occupancy<8, kBias>();
    default: return occupancy<16, kBias>();
  }
}

template <bool kBias>
cudaError_t attributes_d(cudaFuncAttributes* a, int d) {
  switch (nd_of(d)) {
    case 2: return cudaFuncGetAttributes(a, flash_fwd_kernel<2, kBias>);
    case 4: return cudaFuncGetAttributes(a, flash_fwd_kernel<4, kBias>);
    case 8: return cudaFuncGetAttributes(a, flash_fwd_kernel<8, kBias>);
    default: return cudaFuncGetAttributes(a, flash_fwd_kernel<16, kBias>);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (launching nothing) for shapes the kernel does not take.
int flash_attention_fwd(const float* q, const float* k, const float* v, const float* bias,
                        float* out, float* lse, int bh, int lq, int lk, int d, int causal,
                        float scale, void* stream) {
  if (bad_shape(bh, lq, lk, d, causal)) return (int)cudaErrorInvalidValue;
  const Params P{q, k, v, bias, out, lse, lq, lk, d, causal, scale,
                 d % 4 == 0 && aligned(k, 16) && aligned(v, 16), aligned(bias, 8),
                 d % 2 == 0 && aligned(out, 8)};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bias ? launch_d<true>(P, bh, s) : launch_d<false>(P, bh, s));
}

// Bytes of dynamic shared memory of one block at width d.
size_t flash_attention_fwd_smem_bytes(int d) {
  switch (nd_of(d)) {
    case 2: return kSmemBytes<2>;
    case 4: return kSmemBytes<4>;
    case 8: return kSmemBytes<8>;
    default: return kSmemBytes<16>;
  }
}

// Blocks resident on one SM at width d, without (bias == 0) or with a bias,
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus the CUDA error on
// failure.
int flash_attention_fwd_blocks_per_sm(int d, int bias) {
  if (d <= 0 || d > kMaxD) return -static_cast<int>(cudaErrorInvalidValue);
  return bias ? occupancy_d<true>(d) : occupancy_d<false>(d);
}

// Registers per thread and bytes of local memory per thread (spills and stack;
// 0 if nothing spills) at width d, without or with a bias, as the loaded build
// has them (cudaFuncGetAttributes); returns the CUDA error.
int flash_attention_fwd_registers(int d, int bias, int* registers, int* local_bytes) {
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a{};
  const cudaError_t e = bias ? attributes_d<true>(&a, d) : attributes_d<false>(&a, d);
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return (int)e;
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

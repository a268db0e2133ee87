// Fused T5 attention backward for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of genrec_tpu/ops/t5_attention.py
// (reached through `_bwd_call`). It computes the same function, not the same
// blocks. For each flat row hb = h*B + b of the (H*B, L, D) layout (head slowest)
// it recomputes the forward's probabilities, with the -1e9 terms ADDED in the
// forward's order (q.k, + pos_bias, + causal, + key mask), and then:
//
//   dp[i, j] = (do[i] . v[j]) * dm[i, j]               (dm = 1 without dropout)
//   ds[i, j] = p[i, j] * (dp[i, j] - sum_j' dp[i, j'] * p[i, j'])
//   dq[i]    = sum_j ds[i, j] * k[j]
//   dk[j]    = sum_i ds[i, j] * q[i]
//   dv[j]    = sum_i p[i, j] * dm[i, j] * do[i]
//   dbias[h, i, j] = sum_b ds[h*B + b, i, j]           (if asked for)
//
// dbias route: ATOMICS. The TPU kernel summed dbias over the batch by running
// its grid's batch axis in order; CUDA blocks run in no order, so each block
// atomicAdds its (Lq, Lk) ds tile into a (H, Lq, Lk) f32 buffer that the wrapper
// zeroes. The order of the sum over the batch therefore changes from run to
// run, and so do the last bits of dbias: the tolerance says so.
//
// Bound on this card: at the TIGER training shapes (L = 80 or 156, D = 16) each
// score costs about 10*D f32 operations (q.k and do.v recomputed, ds.k, ds.q and
// p.do) against q/k/v/do/dq/dk/dv rows of D floats, so the f32 (non-tensor-core)
// arithmetic bounds it, just ahead of the bytes of the f32 dropout mask when one
// is given (PERF.md reckons both). Design, simple first:
//   - one block per flat row hb, kWarps warps, holding that row's whole (Lq, Lk)
//     ds tile and p*dm tile in dynamic shared memory (2 x 97 KB at 156 x 156, so
//     above 48 KB through cudaFuncSetAttribute; the wrapper refuses shapes beyond
//     the card's 227 KB);
//   - phase 1, one warp per query row: K and V staged in shared memory with a
//     padded row stride; lanes split the keys; softmax and the row sum of dp*p by
//     warp shuffles; dq of the row from the ds row and the staged K;
//   - phase 2, the K/V buffers re-staged with Q and dO; one thread per (key, feature)
//     pair sums the columns of the ds and p*dm tiles into dk and dv;
//   - f32 FMA throughout, accurate expf (no fast-math).
// Making it fast (wgmma, fewer shared-memory loads per FMA, a narrower or
// in-kernel Philox dropout mask, a deterministic dbias reduction) is later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e9f;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on H100

size_t smem_floats(int lq, int lk, int d) {
  const size_t lmax = lq > lk ? lq : lk;
  return 2 * lmax * (d + 1)           // K and V (phase 1), then Q and dO (phase 2)
         + lk                         // additive key mask
         + 2 * (size_t)lq * lk        // ds tile, p*dm tile
         + (size_t)kWarps * 2 * d;    // per-warp q row and do row
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
t5_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ pos_bias,
                        const int32_t* __restrict__ kv_mask, const float* __restrict__ dmask,
                        const float* __restrict__ dout, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ dbias, int batch, int lq, int lk, int d,
                        int causal) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  const int lmax = lq > lk ? lq : lk;
  float* ra = smem;                 // lmax * ds: K, then Q
  float* rb = ra + lmax * ds;       // lmax * ds: V, then dO
  float* madd = rb + lmax * ds;     // lk
  float* tds = madd + lk;           // lq * lk: ds
  float* tpd = tds + lq * lk;       // lq * lk: p * dm
  float* rows = tpd + lq * lk;      // kWarps * 2 * d

  const int hb = blockIdx.x;
  const int h = hb / batch;
  const int b = hb % batch;
  const size_t kv_off = (size_t)hb * lk * d;
  const size_t q_off = (size_t)hb * lq * d;
  for (int i = threadIdx.x; i < lk * d; i += kThreads) {
    const int r = i / d, c = i % d;
    ra[r * ds + c] = k[kv_off + i];
    rb[r * ds + c] = v[kv_off + i];
  }
  for (int j = threadIdx.x; j < lk; j += kThreads)
    madd[j] = kv_mask ? (1.0f - (float)kv_mask[(size_t)b * lk + j]) * kNegInf : 0.0f;
  __syncthreads();

  // ---- phase 1: one warp per query row: p, ds, p*dm and dq ----
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = rows + warp * 2 * d;
  float* dow = qw + d;
  const int shift = lk - lq;
  for (int row = warp; row < lq; row += kWarps) {  // warp-uniform
    const size_t qrow = (size_t)hb * lq + row;
    for (int c = lane; c < d; c += 32) {
      qw[c] = q[qrow * d + c];
      dow[c] = dout[qrow * d + c];
    }
    __syncwarp();

    const float* brow = pos_bias ? pos_bias + ((size_t)h * lq + row) * lk : nullptr;
    const float* drow = dmask ? dmask + qrow * lk : nullptr;
    float* srow = tds + row * lk;
    float* prow = tpd + row * lk;
    float mx = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      const float* kr = ra + j * ds;
      float s = 0.0f;
      for (int c = 0; c < d; ++c) s = fmaf(qw[c], kr[c], s);
      if (brow) s += brow[j];
      if (causal && j > row + shift) s += kNegInf;
      if (kv_mask) s += madd[j];
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    float sum = 0.0f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    const float denom = fmaxf(warp_sum(sum), 1e-30f);

    float dot = 0.0f;  // sum_j dp * p
    for (int j = lane; j < lk; j += 32) {
      const float p = srow[j] / denom;
      const float* vr = rb + j * ds;
      float dpd = 0.0f;
      for (int c = 0; c < d; ++c) dpd = fmaf(dow[c], vr[c], dpd);
      const float dp = drow ? dpd * drow[j] : dpd;
      dot += dp * p;
      srow[j] = p;
      prow[j] = dp;
    }
    dot = warp_sum(dot);

    for (int j = lane; j < lk; j += 32) {
      const float p = srow[j];
      srow[j] = p * (prow[j] - dot);
      prow[j] = drow ? p * drow[j] : p;
    }
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < lk; ++j) acc = fmaf(srow[j], ra[j * ds + c], acc);
      dq[qrow * d + c] = acc;
    }
    __syncwarp();  // the next row overwrites qw and dow
  }
  __syncthreads();

  // ---- phase 2: Q and dO over K and V; columns of the tiles into dk and dv ----
  for (int i = threadIdx.x; i < lq * d; i += kThreads) {
    const int r = i / d, c = i % d;
    ra[r * ds + c] = q[q_off + i];
    rb[r * ds + c] = dout[q_off + i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < lk * d; idx += kThreads) {
    const int j = idx / d, c = idx % d;
    float ak = 0.0f, av = 0.0f;
    for (int i = 0; i < lq; ++i) {
      ak = fmaf(tds[i * lk + j], ra[i * ds + c], ak);
      av = fmaf(tpd[i * lk + j], rb[i * ds + c], av);
    }
    dk[kv_off + idx] = ak;
    dv[kv_off + idx] = av;
  }
  if (dbias) {
    float* dbh = dbias + (size_t)h * lq * lk;
    for (int idx = threadIdx.x; idx < lq * lk; idx += kThreads) atomicAdd(dbh + idx, tds[idx]);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for (lq, lk, d).
size_t t5_attention_bwd_smem_bytes(int lq, int lk, int d) {
  return smem_floats(lq, lk, d) * sizeof(float);
}

const char* t5_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/dout/dq: (hb, lq, d), k/v/dk/dv: (hb, lk, d), pos_bias: (hb / batch, lq, lk) or
// NULL, kv_mask: (batch, lk) int32 or NULL, dmask: (hb, lq, lk) or NULL, dbias:
// (hb / batch, lq, lk) ZEROED by the caller, or NULL when not wanted. All f32
// except kv_mask, contiguous, on the device. Launches on `stream` and returns
// cudaGetLastError().
int t5_attention_bwd(const void* q, const void* k, const void* v, const void* pos_bias,
                     const void* kv_mask, const void* dmask, const void* dout, void* dq,
                     void* dk, void* dv, void* dbias, int hb, int batch, int lq, int lk,
                     int d, int causal, void* stream) {
  const size_t smem = t5_attention_bwd_smem_bytes(lq, lk, d);
  if (smem > kMaxSmem || hb <= 0 || batch <= 0 || hb % batch != 0 || lq <= 0 || lk <= 0 ||
      d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        t5_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  t5_attention_bwd_kernel<<<hb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(pos_bias), static_cast<const int32_t*>(kv_mask),
      static_cast<const float*>(dmask), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dbias), batch, lq, lk, d, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

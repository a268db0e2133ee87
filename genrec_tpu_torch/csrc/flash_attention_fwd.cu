// Blockwise flash attention forward (online softmax), f32, for Hopper (sm_90a).
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
// What it computes, per (B·H row, query row): s = (q·scale)·kᵀ (+ bias),
// s = −1e30 where col > row under causal (no lk − lq offset: causal needs
// lq == lk), then the online softmax over K tiles, out = acc / l and
// lse = m + log l, with l clamped at 1e-30 as the reference clamps it.
//
// Layout: q (BH, Lq, D), k and v (BH, Lk, D), bias (BH, Lq, Lk) or null, all
// contiguous f32; out (BH, Lq, D) and lse (BH, Lq) f32. Lq and Lk are
// multiples of 64 (the wrapper requires 128, as the reference does), D ≤ 128.
//
// Design: one block per (tile of 64 query rows, B·H row); one thread per
// query row holds its q, accumulator, m and l in registers. K and V tiles of
// 64 rows are staged in shared memory (all threads read the same K/V element:
// a broadcast). Scores are taken a chunk of keys at a time (16 at D ≤ 32,
// fewer at larger D so that the unrolled body keeps its size: at 16 keys the
// D=64 and D=128 instantiations made most of the source's nvcc time), and the
// accumulator is rescaled once per chunk. Under causal, tiles past the diagonal are
// skipped. The bias, read per score, is the reference's materialised
// (BH, Lq, Lk) tensor.
//
// What bounds it: at the long-context SASRec shape (BH 128, L 2048, D 16,
// causal) the f32 operations, about 4·D + 5 per unmasked score (0.28 ms at
// 67 TFLOP/s); the bytes (q, k, v, out, lse once) take under 0.02 ms. A thread
// does 2·D FMAs per score on operands read from shared memory; the tensor
// cores are not used (f32). Faster variants are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;  // query rows per block, and keys per staged tile
constexpr float kNegInf = -1e30f;

template <int DP>
__global__ void __launch_bounds__(kTile)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int lq, int lk, int d,
                 int causal, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // (kTile, DP), zero past column d
  float* vs = smem + kTile * DP;  // (kTile, DP)
  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = qt * kTile + tid;

  const float* qrow = q + ((size_t)bh * lq + row) * d;
  float qr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = c < d ? qrow[c] * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const float* brow = bias ? bias + ((size_t)bh * lq + row) * lk : nullptr;
  const float* kbh = k + (size_t)bh * lk * d;
  const float* vbh = v + (size_t)bh * lk * d;
  // causal (lq == lk): key tiles past the query tile hold only masked keys
  const int n_kt = causal ? qt + 1 : lk / kTile;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile is no longer read
    const float* kb = kbh + (size_t)kt * kTile * d;
    const float* vb = vbh + (size_t)kt * kTile * d;
    for (int i = tid; i < kTile * DP; i += kTile) {
      const int r = i / DP, c = i % DP;
      ks[i] = c < d ? kb[r * d + c] : 0.f;
      vs[i] = c < d ? vb[r * d + c] : 0.f;
    }
    __syncthreads();
    constexpr int kChunk = DP <= 32 ? 16 : 512 / DP;  // keys per online-softmax rescale
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (j0 + jj) * DP;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) dot = fmaf(qr[c], kr[c], dot);
        const int col = kt * kTile + j0 + jj;
        if (brow) dot += brow[col];
        if (causal && col > row) dot = kNegInf;
        s[jj] = dot;
        cmax = fmaxf(cmax, dot);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float* vr = vs + (j0 + jj) * DP;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
      m = m_new;
    }
  }
  l = fmaxf(l, 1e-30f);
  float* orow = out + ((size_t)bh * lq + row) * d;
#pragma unroll
  for (int c = 0; c < DP; ++c)
    if (c < d) orow[c] = acc[c] / l;
  lse[(size_t)bh * lq + row] = m + logf(l);
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   float* out, float* lse, int bh, int lq, int lk, int d, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = 2 * kTile * DP * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(lq / kTile, bh);
  flash_fwd_kernel<DP><<<grid, kTile, smem, stream>>>(q, k, v, bias, out, lse, lq, lk, d,
                                                      causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (launching nothing) for shapes the kernel does not take.
int flash_attention_fwd(const float* q, const float* k, const float* v, const float* bias,
                        float* out, float* lse, int bh, int lq, int lk, int d, int causal,
                        float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || lq % kTile || lk % kTile || d <= 0 ||
      d > 128 || (causal && lq != lk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16) return (int)launch<16>(q, k, v, bias, out, lse, bh, lq, lk, d, causal, scale, s);
  if (d <= 32) return (int)launch<32>(q, k, v, bias, out, lse, bh, lq, lk, d, causal, scale, s);
  if (d <= 64) return (int)launch<64>(q, k, v, bias, out, lse, bh, lq, lk, d, causal, scale, s);
  return (int)launch<128>(q, k, v, bias, out, lse, bh, lq, lk, d, causal, scale, s);
}

const char* flash_attention_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

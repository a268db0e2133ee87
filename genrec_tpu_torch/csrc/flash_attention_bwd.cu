// Blockwise flash attention backward (recompute from lse), f32, for Hopper
// (sm_90a): two kernels, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of genrec_tpu/ops/attention.py:
//   - `_flash_bwd_dq_kernel` (:251) and `_flash_bwd_dkv_kernel` (:292),
//     called by `_flash_backward` (:484, pallas_calls :520 and :530);
//   - `_flash_bwd_dq_kernel_blocked` (:354) and `_flash_bwd_dkv_kernel_blocked`
//     (:391), called by `_flash_backward_blocked` (:437, pallas_calls :452 and
//     :471), which accumulate into f32 output blocks so that VMEM never holds
//     a full-length ref.
// That split exists on the TPU only for its VMEM limit; here the dq kernel and
// the dk/dv kernel serve both routes: Q/K/V tiles are staged in shared memory
// whatever the length.
//
// What they compute: p = exp(q·kᵀ·scale − lse) (0 where col > row under
// causal), ds = p·(do·vᵀ − delta), dq = ds·k·scale, dk = dsᵀ·q·scale,
// dv = pᵀ·do; delta = rowsum(do·o) comes in from the caller (a torch
// reduction, as it is an XLA op outside Pallas in the reference).
//
// Layout: q, do, dq (BH, Lq, D); k, v, dk, dv (BH, Lk, D); lse and delta
// (BH, Lq); all contiguous f32. Lq and Lk multiples of 64, D ≤ 128; causal
// needs lq == lk (the reference's diagonal has no lk − lq offset).
//
// Design, deterministic, no atomics: every output row is written by exactly
// one thread.
//   - dq: one block per (tile of 64 query rows, B·H row), one thread per query
//     row holding q, do, its dq accumulator, lse and delta in registers; K/V
//     tiles of 64 rows staged in shared memory; under causal the loop stops at
//     the diagonal tile.
//   - dk/dv: one block per (tile of 64 key rows, B·H row), one thread per key
//     row holding k, v and the dk/dv accumulators; Q, dO, lse and delta tiles
//     staged in shared memory, from the causal start tile (the diagonal) on.
//
// What bounds them: at the long-context SASRec shape (BH 128, L 2048, D 16,
// causal) the f32 operations: per unmasked score dq does q·k, do·v, ds·k
// (6·D) plus 4, dk/dv does q·k, do·v, p·do, ds·q (8·D) plus 4, about 62
// GFLOP, 0.93 ms at 67 TFLOP/s; the bytes take under 0.05 ms.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;

template <int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int d, int tid) {
  // copy kTile rows of width d into a (kTile, DP) tile, zero past column d
  for (int i = tid; i < kTile * DP; i += kTile) {
    const int r = i / DP, c = i % DP;
    dst[i] = c < d ? src[r * d + c] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kTile)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int lq, int lk, int d, int causal, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;               // (kTile, DP)
  float* vs = smem + kTile * DP;  // (kTile, DP)
  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = qt * kTile + tid;
  const size_t qoff = ((size_t)bh * lq + row) * d;

  float qr[DP], dor[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = c < d ? q[qoff + c] : 0.f;
    dor[c] = c < d ? dout[qoff + c] : 0.f;
    acc[c] = 0.f;
  }
  const float lse_r = lse[(size_t)bh * lq + row];
  const float delta_r = delta[(size_t)bh * lq + row];
  const float* kbh = k + (size_t)bh * lk * d;
  const float* vbh = v + (size_t)bh * lk * d;
  const int n_kt = causal ? qt + 1 : lk / kTile;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    stage_rows<DP>(ks, kbh + (size_t)kt * kTile * d, d, tid);
    stage_rows<DP>(vs, vbh + (size_t)kt * kTile * d, d, tid);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      if (causal && kt * kTile + j > row) break;  // p is exactly 0 past the diagonal
      const float* kr = ks + j * DP;
      const float* vr = vs + j * DP;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(qr[c], kr[c], s);
        dp = fmaf(dor[c], vr[c], dp);
      }
      const float p = expf(s * scale - lse_r);
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(ds, kr[c], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < DP; ++c)
    if (c < d) dq[qoff + c] = acc[c] * scale;
}

template <int DP>
__global__ void __launch_bounds__(kTile)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int lq, int lk, int d,
                     int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // (kTile, DP)
  float* dos = smem + kTile * DP;    // (kTile, DP)
  float* lses = dos + kTile * DP;    // (kTile,)
  float* deltas = lses + kTile;      // (kTile,)
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = kt * kTile + tid;
  const size_t koff = ((size_t)bh * lk + col) * d;

  float kr[DP], vr[DP], dk_acc[DP], dv_acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    kr[c] = c < d ? k[koff + c] : 0.f;
    vr[c] = c < d ? v[koff + c] : 0.f;
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }
  const float* qbh = q + (size_t)bh * lq * d;
  const float* dobh = dout + (size_t)bh * lq * d;
  // causal (lq == lk): query tiles above the diagonal see none of these keys
  const int qt0 = causal ? kt : 0;

  for (int qt = qt0; qt < lq / kTile; ++qt) {
    __syncthreads();
    stage_rows<DP>(qs, qbh + (size_t)qt * kTile * d, d, tid);
    stage_rows<DP>(dos, dobh + (size_t)qt * kTile * d, d, tid);
    lses[tid] = lse[(size_t)bh * lq + qt * kTile + tid];
    deltas[tid] = delta[(size_t)bh * lq + qt * kTile + tid];
    __syncthreads();
    // under causal, query rows before this key are masked: start at the key
    const int i0 = (causal && qt == kt) ? tid : 0;
    for (int i = i0; i < kTile; ++i) {
      const float* qi = qs + i * DP;
      const float* doi = dos + i * DP;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(qi[c], kr[c], s);
        dp = fmaf(doi[c], vr[c], dp);
      }
      const float p = expf(s * scale - lses[i]);
      const float ds = p * (dp - deltas[i]);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dv_acc[c] = fmaf(p, doi[c], dv_acc[c]);
        dk_acc[c] = fmaf(ds, qi[c], dk_acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    if (c < d) {
      dk[koff + c] = dk_acc[c] * scale;
      dv[koff + c] = dv_acc[c];
    }
  }
}

bool bad_shape(int bh, int lq, int lk, int d, int causal) {
  return bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || lq % kTile || lk % kTile || d <= 0 ||
         d > 128 || (causal && lq != lk);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq, int bh, int lq, int lk,
                      int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 2 * kTile * DP * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP><<<dim3(lq / kTile, bh), kTile, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, lq, lk, d, causal, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int bh,
                       int lq, int lk, int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = (2 * kTile * DP + 2 * kTile) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP><<<dim3(lk / kTile, bh), kTile, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, lq, lk, d, causal, scale);
  return cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16) return (int)launch_dq<16>(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, causal, scale, s);
  if (d <= 32) return (int)launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, causal, scale, s);
  if (d <= 64) return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, causal, scale, s);
  return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, lq, lk, d, causal, scale, s);
}

int flash_attention_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                            const float* lse, const float* delta, float* dk, float* dv, int bh,
                            int lq, int lk, int d, int causal, float scale, void* stream) {
  if (bad_shape(bh, lq, lk, d, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16) return (int)launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, causal, scale, s);
  if (d <= 32) return (int)launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, causal, scale, s);
  if (d <= 64) return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, causal, scale, s);
  return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, lq, lk, d, causal, scale, s);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Fused T5 attention forward for Hopper (sm_90a), f32.
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
// The -1e9 terms are ADDED in f32 in that order (never a `where`, never -inf),
// so a fully masked row comes out finite, as the mean of v over the keys that
// tie for its maximum, exactly like the plain version and the reference. The
// TPU kernel folded the key-padding mask into an extra q/k feature column
// because Mosaic could not broadcast it; this kernel reads the (B, Lk) mask
// directly.
//
// Bound on this card: at the TIGER shapes (L = 80, D = 16) the work is tiny
// per row: 4*D multiply-adds and a handful of softmax operations per score,
// against 4*D*4 bytes of q/k/v/out per row. Reading q, k, v and writing out
// once is about as long as the f32 (non-tensor-core) arithmetic, so the kernel
// is bound by both about equally (PERF.md reckons both). This design runs far
// above that bound (PERF.md): its inner loops issue a shared-memory load per
// FMA, and the P.V loop keeps only D of 32 lanes busy. Design, simple first:
//   - one block per (h*B + b, tile of kTileRows query rows), kWarps warps;
//   - that row's K and V staged once in dynamic shared memory (80 x 16 f32 each
//     at the serve shape), K with a padded row stride so that lanes reading
//     neighbouring keys hit different banks;
//   - one warp per query row: lanes split the keys, softmax by warp shuffles,
//     probabilities kept in a per-warp shared buffer for the P.V product;
//   - f32 FMA throughout, accurate expf (no fast-math).
// Dynamic shared memory above 48 KB is enabled with cudaFuncSetAttribute, so
// that the decoder training shapes (L = 156) fit; the wrapper refuses shapes
// beyond the card's 227 KB. Making it fast (wgmma, TMA, many rows per block)
// is later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr float kNegInf = -1e9f;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use on H100

size_t smem_floats(int lk, int d) {
  // K (padded stride d+1) + V + additive key mask + per-warp q row + per-warp probs
  return (size_t)lk * (d + 1) + (size_t)lk * d + lk + (size_t)kWarps * (d + lk);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
t5_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ pos_bias,
                        const int32_t* __restrict__ kv_mask, const float* __restrict__ dmask,
                        float* __restrict__ out, int batch, int lq, int lk, int d, int causal) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* ks = smem;               // lk * ds
  float* vs = ks + lk * ds;       // lk * d
  float* madd = vs + lk * d;      // lk
  float* qs = madd + lk;          // kWarps * d
  float* ps = qs + kWarps * d;    // kWarps * lk

  const int hb = blockIdx.x;
  const int h = hb / batch;
  const int b = hb % batch;
  const float* kb = k + (size_t)hb * lk * d;
  const float* vb = v + (size_t)hb * lk * d;
  for (int i = threadIdx.x; i < lk * d; i += blockDim.x) {
    ks[(i / d) * ds + i % d] = kb[i];
    vs[i] = vb[i];
  }
  for (int j = threadIdx.x; j < lk; j += blockDim.x)
    madd[j] = kv_mask ? (1.0f - (float)kv_mask[(size_t)b * lk + j]) * kNegInf : 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * d;
  float* pw = ps + warp * lk;
  const int shift = lk - lq;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = blockIdx.y * kTileRows + rr * kWarps + warp;
    if (row >= lq) break;  // warp-uniform
    const size_t qrow = (size_t)hb * lq + row;
    for (int c = lane; c < d; c += 32) qw[c] = q[qrow * d + c];
    __syncwarp();

    const float* brow = pos_bias ? pos_bias + ((size_t)h * lq + row) * lk : nullptr;
    float mx = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      const float* kr = ks + j * ds;
      float s = 0.0f;
      for (int c = 0; c < d; ++c) s = fmaf(qw[c], kr[c], s);
      if (brow) s += brow[j];
      if (causal && j > row + shift) s += kNegInf;
      if (kv_mask) s += madd[j];
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    float sum = 0.0f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    const float denom = fmaxf(warp_sum(sum), 1e-30f);
    const float* drow = dmask ? dmask + qrow * lk : nullptr;
    for (int j = lane; j < lk; j += 32) {
      float p = pw[j] / denom;
      if (drow) p *= drow[j];
      pw[j] = p;
    }
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < lk; ++j) acc = fmaf(pw[j], vs[j * d + c], acc);
      out[qrow * d + c] = acc;
    }
    __syncwarp();  // the next row overwrites qw and pw
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for (lk, d).
size_t t5_attention_fwd_smem_bytes(int lk, int d) { return smem_floats(lk, d) * sizeof(float); }

const char* t5_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: (hb, lq, d), k/v: (hb, lk, d), pos_bias: (hb / batch, lq, lk) or NULL,
// kv_mask: (batch, lk) int32 or NULL, dmask: (hb, lq, lk) or NULL,
// out: (hb, lq, d). All f32 except kv_mask, contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError().
int t5_attention_fwd(const void* q, const void* k, const void* v, const void* pos_bias,
                     const void* kv_mask, const void* dmask, void* out, int hb, int batch,
                     int lq, int lk, int d, int causal, void* stream) {
  const size_t smem = t5_attention_fwd_smem_bytes(lk, d);
  if (smem > kMaxSmem || hb <= 0 || batch <= 0 || hb % batch != 0 || lq <= 0 || lk <= 0 ||
      d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        t5_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(hb, (lq + kTileRows - 1) / kTileRows);
  t5_attention_fwd_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(pos_bias), static_cast<const int32_t*>(kv_mask),
      static_cast<const float*>(dmask), static_cast<float*>(out), batch, lq, lk, d, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

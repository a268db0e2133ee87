// genrec-native: threaded host-side batch packing, the port's copy of the
// JAX package's native/packer.cpp (the same source, the same C ABI,
// version 1).
//
// The reference's data path is per-sample Python (`SASRec/data_vision.py:
// 51-87`, `RQVAE-T5/data_vision.py:33-55` + the per-batch Python collate).
// Here the pack of an entire split into fixed-shape arrays is one C++ call
// over contiguous buffers, parallelized across a small thread pool.
//
// Built with g++ at first use and bound with ctypes by
// genrec_tpu_torch/data/native_packer.py; semantics are bit-identical to the
// Python builders of genrec_tpu_torch/data/datasets.py (tested against each
// other and against the JAX package's two paths).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to `threads` workers.
template <typename F>
void parallel_for(int64_t n, F fn, int threads = 0) {
  int nt = threads > 0 ? threads
                       : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min<int>(nt, 16));
  if (n < 1024 || nt == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  const int64_t chunk = std::max<int64_t>(256, n / (nt * 8));
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t start = next.fetch_add(chunk);
        if (start >= n) return;
        int64_t end = std::min(n, start + chunk);
        for (int64_t i = start; i < end; ++i) fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// SASRec train pack: per-sequence input=seq[:-1], target=seq[1:], keep the
// most recent max_len steps, pre-pad with 0.
// seqs: concatenated sequences; offsets: (n+1) prefix offsets into seqs.
// out_inputs/out_targets: (n, max_len) int32, caller-allocated.
void pack_sasrec_train(const int32_t* seqs, const int64_t* offsets, int64_t n,
                       int32_t max_len, int32_t* out_inputs,
                       int32_t* out_targets) {
  parallel_for(n, [&](int64_t i) {
    const int64_t lo = offsets[i], hi = offsets[i + 1];
    const int64_t len = hi - lo;            // full sequence length
    const int64_t m = len - 1;              // shifted pair length
    const int64_t keep = std::min<int64_t>(m, max_len);
    int32_t* inp = out_inputs + i * max_len;
    int32_t* tgt = out_targets + i * max_len;
    std::memset(inp, 0, sizeof(int32_t) * max_len);
    std::memset(tgt, 0, sizeof(int32_t) * max_len);
    if (m <= 0) return;
    // input = seq[:-1][-keep:], target = seq[1:][-keep:]
    const int32_t* in_src = seqs + hi - 1 - keep;   // seq[:-1] tail
    const int32_t* tg_src = seqs + hi - keep;       // seq[1:] tail
    std::memcpy(inp + (max_len - keep), in_src, sizeof(int32_t) * keep);
    std::memcpy(tgt + (max_len - keep), tg_src, sizeof(int32_t) * keep);
  });
}

// SASRec test pack: input = seq[:-1] (most recent max_len, pre-padded),
// target = seq[-1]; sequences of length < 2 produce all-pad rows.
void pack_sasrec_test(const int32_t* seqs, const int64_t* offsets, int64_t n,
                      int32_t max_len, int32_t* out_inputs,
                      int32_t* out_targets) {
  parallel_for(n, [&](int64_t i) {
    const int64_t lo = offsets[i], hi = offsets[i + 1];
    const int64_t len = hi - lo;
    int32_t* inp = out_inputs + i * max_len;
    std::memset(inp, 0, sizeof(int32_t) * max_len);
    if (len < 2) {
      out_targets[i] = 0;
      return;
    }
    const int64_t keep = std::min<int64_t>(len - 1, max_len);
    std::memcpy(inp + (max_len - keep), seqs + hi - 1 - keep,
                sizeof(int32_t) * keep);
    out_targets[i] = seqs[hi - 1];
  });
}

// TIGER pack: flat offset-token histories → (n, max_len*code_dim) with
// left [0]*code_dim item padding, most-recent truncation, plus labels
// padded with -100 and attention_mask = (token != 0).
void pack_tiger(const int32_t* hist, const int64_t* hist_offsets,
                const int32_t* tgt, const int64_t* tgt_offsets, int64_t n,
                int32_t max_len, int32_t code_dim, int32_t tgt_tokens,
                int32_t* out_input_ids, int32_t* out_mask,
                int32_t* out_labels) {
  const int64_t seq_tokens = static_cast<int64_t>(max_len) * code_dim;
  parallel_for(n, [&](int64_t i) {
    const int64_t hlo = hist_offsets[i], hhi = hist_offsets[i + 1];
    int64_t hlen = hhi - hlo;
    const int32_t* src = hist + hlo;
    if (hlen > seq_tokens) {  // keep the most recent items
      src += hlen - seq_tokens;
      hlen = seq_tokens;
    }
    int32_t* ii = out_input_ids + i * seq_tokens;
    int32_t* mm = out_mask + i * seq_tokens;
    std::memset(ii, 0, sizeof(int32_t) * seq_tokens);
    std::memcpy(ii + (seq_tokens - hlen), src, sizeof(int32_t) * hlen);
    for (int64_t k = 0; k < seq_tokens; ++k) mm[k] = ii[k] != 0;

    const int64_t tlo = tgt_offsets[i], thi = tgt_offsets[i + 1];
    const int64_t tlen = std::min<int64_t>(thi - tlo, tgt_tokens);
    int32_t* lab = out_labels + i * tgt_tokens;
    for (int32_t k = 0; k < tgt_tokens; ++k) lab[k] = -100;
    std::memcpy(lab, tgt + tlo, sizeof(int32_t) * tlen);
  });
}

// Dense-T5 sliding-window sample counting + packing.
// Pass 1 (out_* null): returns the number of train samples.
// Pass 2: fills history_ids (n_samples, max_seq_len) right-padded,
// seq_lens, target_ids, user_ids.
int64_t pack_dense_t5_train(const int32_t* seqs, const int64_t* offsets,
                            const int32_t* user_ids, int64_t n_users,
                            int32_t max_seq_len, int32_t min_seq_len,
                            int32_t* out_hist, int32_t* out_lens,
                            int32_t* out_tgt, int32_t* out_uid) {
  // sample counts per user (prefix targets 1..len-2)
  std::vector<int64_t> starts(n_users + 1, 0);
  for (int64_t u = 0; u < n_users; ++u) {
    const int64_t len = offsets[u + 1] - offsets[u];
    starts[u + 1] = starts[u] + (len >= min_seq_len ? std::max<int64_t>(len - 2, 0) : 0);
  }
  const int64_t total = starts[n_users];
  if (!out_hist) return total;
  parallel_for(n_users, [&](int64_t u) {
    const int64_t lo = offsets[u];
    const int64_t len = offsets[u + 1] - lo;
    if (len < min_seq_len) return;
    int64_t s = starts[u];
    for (int64_t i = 1; i <= len - 2; ++i, ++s) {
      const int64_t hstart = std::max<int64_t>(0, i - max_seq_len);
      const int64_t hlen = i - hstart;
      int32_t* row = out_hist + s * max_seq_len;
      std::memset(row, 0, sizeof(int32_t) * max_seq_len);
      std::memcpy(row, seqs + lo + hstart, sizeof(int32_t) * hlen);
      out_lens[s] = static_cast<int32_t>(hlen);
      out_tgt[s] = seqs[lo + i];
      out_uid[s] = user_ids[u];
    }
  });
  return total;
}

int32_t genrec_native_abi_version() { return 1; }

}  // extern "C"

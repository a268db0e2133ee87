"""The yardstick's arithmetic for the decoder-only MoE recommender
(DeepSeek-V2 cells): model FLOPs of a batch of recommendations, and the
least time of a grouped-expert launch. Counted from shapes only.

Model FLOPs count 2 per multiply-add of the model's matrix products, in
MLA's plain form (per-head K and V from ``kv_b_proj`` for each new token,
scores over q/k 192 dims and values over 128, every real key of a causal
pair once), over real tokens only:
- a prompt's every real token through every layer (the router's gate, the
  top-k experts and the shared expert of each MoE layer, the dense MLP of
  the first), and the LM head at its last position only;
- each beam's ``code_dim - 1`` decode rows through every layer, attending
  to the prompt's real tokens and the beam's positions so far, and the LM
  head at each.
Work the program does besides (the absorbed form's projections into and
out of latent space, the padded positions of the prefill's attention) is
not counted. Peak: 989 TFLOP/s, the card's dense bf16 rate.

Least time of one grouped-expert launch (the routed experts' gate-and-up
or down projection of one layer-pass): the larger of its products at 989
TFLOP/s and its bytes at 3.35 TB/s: every expert's weights read once
(each expert sees rows at the cell's sizes), the rows in and the
products out once, all bf16. A batch has ``moe layers × (1 + code_dim -
1) × 2`` of them. The launches are found in the trace by the kernel names
in :data:`EXPERT_KERNELS`.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

BF16_FLOPS = 989e12       # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
BF16 = 2
# substrings of the grouped GEMM kernel's name (CUTLASS's grouped problem shape)
EXPERT_KERNELS = ("GroupProblemShape",)


def moe_layers(cfg: dict) -> int:
    return sum(1 for i in range(cfg["num_hidden_layers"])
               if cfg["n_routed_experts"] is not None and i >= cfg["first_k_dense_replace"]
               and i % cfg["moe_layer_freq"] == 0)


def token_flops(cfg: dict, keys) -> np.ndarray:
    """FLOPs of one token through every layer (not the head), attending to
    ``keys`` keys (an array, one entry a token)."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                            cfg["v_head_dim"], cfg["kv_lora_rank"])
    keys = np.asarray(keys, dtype=np.float64)
    proj = 2 * h * nh * (nope + rope) + 2 * h * (rank + rope) + 2 * rank * nh * (nope + vd) \
        + 2 * nh * vd * h
    attn = 2 * nh * (nope + rope + vd) * keys
    n_moe = moe_layers(cfg)
    n_dense = cfg["num_hidden_layers"] - n_moe
    swiglu = lambda inter: 2 * h * 2 * inter + 2 * inter * h  # noqa: E731
    moe = 2 * h * cfg["n_routed_experts"] + cfg["num_experts_per_tok"] * swiglu(
        cfg["moe_intermediate_size"]) + swiglu(cfg["moe_intermediate_size"]
                                                * cfg["n_shared_experts"])
    return cfg["num_hidden_layers"] * (proj + attn) + n_moe * moe \
        + n_dense * swiglu(cfg["intermediate_size"])


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, lengths: Iterable[int]) -> float:
    """Prompts of ``lengths`` real tokens: token i (1-based) attends to i
    keys; the head at the last."""
    total = 0.0
    for n in np.asarray(lengths, dtype=np.int64):
        total += float(token_flops(cfg, np.arange(1, n + 1)).sum()) + head_flops(cfg)
    return total


def decode_flops(cfg: dict, lengths: Iterable[int], beams: int) -> float:
    """Each prompt's ``beams`` beams' decode rows: row s (0-based) attends to
    the prompt's n tokens and s + 1 generated ones; the head at each."""
    steps = cfg["code_dim"] - 1
    n = np.asarray(lengths, dtype=np.float64)
    keys = (n[:, None] + np.arange(1, steps + 1)[None, :]).reshape(-1)
    return beams * (float(token_flops(cfg, keys).sum()) + len(keys) * head_flops(cfg))


def recommend_flops(cfg: dict, lengths: Iterable[int], beams: int) -> float:
    lengths = list(lengths)
    return prefill_flops(cfg, lengths) + decode_flops(cfg, lengths, beams)


def expert_launch_bound_s(cfg: dict, rows: int, proj: str) -> float:
    """Least seconds of one grouped launch over ``rows`` token-expert rows:
    ``proj`` "gate_up" (hidden → 2 × width) or "down" (width → hidden)."""
    h, inter, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    k_in, n_out = (h, 2 * inter) if proj == "gate_up" else (inter, h)
    flops = 2.0 * rows * k_in * n_out
    nbytes = (e * k_in * n_out + rows * k_in + rows * n_out) * BF16
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def batch_expert_launches(cfg: dict) -> int:
    return moe_layers(cfg) * cfg["code_dim"] * 2


def batch_expert_bound_s(cfg: dict, real_tokens: int, prompts: int, beams: int) -> float:
    """Summed least time of a batch's grouped-expert launches: per MoE layer,
    the prefill's ``top_k × real_tokens`` rows and each decode step's
    ``top_k × prompts × beams``."""
    k = cfg["num_experts_per_tok"]
    passes = [k * real_tokens] + [k * prompts * beams] * (cfg["code_dim"] - 1)
    one = sum(expert_launch_bound_s(cfg, rows, p) for rows in passes for p in ("gate_up", "down"))
    return moe_layers(cfg) * one

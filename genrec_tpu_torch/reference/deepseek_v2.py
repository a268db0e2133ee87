"""Plain PyTorch reference of DeepSeek-V2 as a semantic-ID recommender,
written from the published ``modeling_deepseek.py`` (arXiv 2405.04434).

It imports nothing of the port and no JAX. Everything is a function of the
configuration (a dict with the published ``config.json`` keys and the
recommender's ``codebook_size``, ``code_dim``, ``sid_base``), a parameter
dict (the names of :func:`param_spec`) and the inputs:

- the full forward over a left-padded sequence with no cache, grouping or
  batching: RMSNorm; MLA without a query LoRA, in its plain form (per-head
  K and V from ``kv_b_proj``, scores of the whole square, masked to the
  causal real keys); its own YaRN table (extrapolated and interpolated
  inverse frequencies with a linear ramp over the correction range, the
  interleaved rope dims, the softmax scale times mscale(factor,
  mscale_all_dim)²); the dense SwiGLU, and the MoE with the experts run by
  a loop over the experts, each on the rows routed to it (the greedy top-k
  of the softmax of the gate, not renormalised, times
  ``routed_scaling_factor``), plus the shared expert; the untied head;
- the teacher-forced score of token sequences under the item trie, and a
  plain trie-constrained beam search that re-runs the whole prefix at
  every step (stable sorts, lower flat index first on ties).

Positions count real tokens only (a left-padded row's positions are its
unpadded ones). Everything is computed in float32 (the forward sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: :func:`no_tf32`); each
layer's weights are taken to float32 when the layer runs, so that the pass
fits beside bf16 weights on the card.

Departures from ``modeling_deepseek.py``: inference only (no auxiliary
loss, no dropout, no KV cache); the last ``code_dim · codebook_size`` ids
of the vocabulary are the items' semantic-ID digits (``sid_base + level ·
codebook_size + digit``); each SwiGLU's gate and up projections are held as
one matrix (gate rows first) and the routed experts' weights stacked, a
layout only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_BEAM = -1e30  # a beam or token ruled out


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# the published keys this reference computes only at these values (a key
# left out of the configuration is taken at its value here)
SUPPORTED = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func": "softmax",
             "norm_topk_prob": False, "tie_word_embeddings": False, "hidden_act": "silu",
             "attention_bias": False}


def check_supported(cfg: dict) -> None:
    """ValueError where ``cfg`` asks for what this reference does not
    compute (a query LoRA, group-limited or sigmoid routing, renormalised
    top-k weights, a tied head, another activation, attention biases, rope
    other than YaRN)."""
    for key, want in SUPPORTED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{key}={cfg[key]!r} is not supported (only {want!r})")
    rs = cfg.get("rope_scaling")
    if rs and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling type {rs.get('type')!r} is not supported (only 'yarn')")


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def is_moe_layer(cfg: dict, i: int) -> bool:
    return (cfg["n_routed_experts"] is not None and i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


def param_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight, init "normal" (N(0,
    initializer_range²)) or "ones", in a fixed order."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, nope, rope, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank, e, ie = cfg["kv_lora_rank"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    out = [("embed_tokens.weight", (v, h), "normal")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "input_layernorm.weight", (h,), "ones"),
                (p + "self_attn.q_proj.weight", (nh * (nope + rope), h), "normal"),
                (p + "self_attn.kv_a_proj_with_mqa.weight", (rank + rope, h), "normal"),
                (p + "self_attn.kv_a_layernorm.weight", (rank,), "ones"),
                (p + "self_attn.kv_b_proj.weight", (nh * (nope + vd), rank), "normal"),
                (p + "self_attn.o_proj.weight", (h, nh * vd), "normal"),
                (p + "post_attention_layernorm.weight", (h,), "ones")]
        if is_moe_layer(cfg, i):
            shared = ie * cfg["n_shared_experts"]
            out += [(p + "mlp.gate.weight", (e, h), "normal"),
                    (p + "mlp.experts.gate_up_proj", (e, 2 * ie, h), "normal"),
                    (p + "mlp.experts.down_proj", (e, h, ie), "normal")]
            if shared:
                out += [(p + "mlp.shared_experts.gate_up_proj.weight", (2 * shared, h), "normal"),
                        (p + "mlp.shared_experts.down_proj.weight", (h, shared), "normal")]
        else:
            ff = cfg["intermediate_size"]
            out += [(p + "mlp.gate_up_proj.weight", (2 * ff, h), "normal"),
                    (p + "mlp.down_proj.weight", (h, ff), "normal")]
    out += [("norm.weight", (h,), "ones"), ("lm_head.weight", (v, h), "normal")]
    return out


def make_weights(cfg: dict, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight drawn in ``dtype`` on ``device`` from ``generator``, in
    :func:`param_spec`'s order (no float32 copy is made)."""
    out = {}
    for name, shape, init in param_spec(cfg):
        t = torch.empty(shape, dtype=dtype, device=device)
        if init == "ones":
            t.fill_(1.0)
        else:
            t.normal_(0.0, cfg["initializer_range"], generator=generator)
        out[name] = t
    return out


# ----------------------------------------------------------------------------
# YaRN rope
# ----------------------------------------------------------------------------

def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_table(cfg: dict) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies (rope/2,) float64 → float32, the factor on cos
    and sin), as ``DeepseekV2YarnRotaryEmbedding`` makes them."""
    dim, base, rs = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), cfg["rope_scaling"]
    exps = [2 * i / dim for i in range(dim // 2)]
    extra = [1.0 / base ** x for x in exps]
    if not rs:
        return torch.tensor(extra, dtype=torch.float32), 1.0
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    inv = []
    for i, x in enumerate(exps):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        keep = 1.0 - ramp  # weight of the extrapolated frequency
        inv.append((1.0 / (factor * base ** x)) * (1 - keep) + extra[i] * keep)
    m = yarn_get_mscale(factor, rs["mscale"]) / yarn_get_mscale(factor, rs["mscale_all_dim"])
    return torch.tensor(inv, dtype=torch.float32), m


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate(x: torch.Tensor, pos: torch.Tensor, cfg: dict) -> torch.Tensor:
    """DeepSeek's rope of ``x`` (..., L, [heads,] rope) at positions ``pos``
    (B, L): the interleaved dims viewed as (rope/2, 2) and transposed, then
    ``x·cos + rotate_half(x)·sin``, cos and sin in f32 taken to x's dtype."""
    inv, m = yarn_table(cfg)
    freqs = pos.to(torch.float32)[..., None] * inv.to(pos.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = (emb.cos() * m).to(x.dtype), (emb.sin() * m).to(x.dtype)
    if x.dim() == 4:  # (B, L, heads, rope)
        cos, sin = cos[:, :, None], sin[:, :, None]
    d = x.shape[-1]
    x = x.view(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


# ----------------------------------------------------------------------------
# the forward
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    inter = down.shape[-1]
    g, u = x @ gate_up[:inter].t(), x @ gate_up[inter:].t()
    return (F.silu(g) * u) @ down.t()


def attention(cfg: dict, w: Dict[str, torch.Tensor], x, pos, allowed) -> torch.Tensor:
    """MLA on ``x`` (B, L, hidden), ``allowed`` (B, L, L) the keys each
    query sees."""
    b, length, _ = x.shape
    nh, nope, rope, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = (x @ w["q_proj"].t()).view(b, length, nh, nope + rope)
    q_nope, q_pe = q[..., :nope], rotate(q[..., nope:], pos, cfg)
    ckv = x @ w["kv_a_proj_with_mqa"].t()
    c = rms_norm(ckv[..., :rank], w["kv_a_layernorm"], cfg["rms_norm_eps"])
    k_pe = rotate(ckv[..., rank:], pos, cfg)
    kv = (c @ w["kv_b_proj"].t()).view(b, length, nh, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe)) * softmax_scale(cfg)
    scores = scores.masked_fill(~allowed[:, None], float("-inf"))
    p = scores.softmax(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, length, nh * vd)
    return o @ w["o_proj"].t()


def moe(cfg: dict, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The MoE on rows ``x`` (T, hidden): each expert on the rows routed to
    it, weighted, plus the shared expert."""
    probs = (x @ w["gate"].t()).softmax(dim=-1)
    top_w, top_i = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    top_w = top_w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w["experts.gate_up_proj"][e], w["experts.down_proj"][e])
            out.index_add_(0, rows, y * top_w[rows, slot, None])
    if cfg["n_shared_experts"]:
        out = out + swiglu(x, w["shared_experts.gate_up_proj.weight"],
                           w["shared_experts.down_proj.weight"])
    return out


def _layer(p: Dict[str, torch.Tensor], i: int, dt: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Layer i's weights in ``dt``, without the prefixes (and the
    ``.weight`` of a plain matrix)."""
    pre = f"layers.{i}."
    out = {}
    for name, t in p.items():
        if name.startswith(pre):
            key = name[len(pre):].replace("self_attn.", "").replace("mlp.", "")
            if key.endswith(".weight") and not key.startswith("shared_experts."):
                key = key[:-len(".weight")]
            out[key] = t.to(dt)
    return out


def positions(mask: torch.Tensor) -> torch.Tensor:
    return (mask.long().cumsum(1) - 1).clamp(min=0)


def forward(cfg: dict, p: Dict[str, torch.Tensor], ids: torch.Tensor, mask: torch.Tensor,
            logits_at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float32 logits (B, L, V), or (B, T, V) at the positions ``logits_at``
    (B, T), of the padded sequences ``ids`` (B, L) whose real tokens
    ``mask`` marks."""
    no_tf32()
    check_supported(cfg)
    dt = torch.float32
    b, length = ids.shape
    mask = mask.bool()
    pos = positions(mask)
    at = torch.arange(length, device=ids.device)
    allowed = ((at[:, None] >= at[None, :])[None] & mask[:, None, :]) \
        | (at[:, None] == at[None, :])[None]  # a padding query sees itself: no empty row
    h = p["embed_tokens.weight"][ids].to(dt)
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        w = _layer(p, i, dt)
        h = h + attention(cfg, w, rms_norm(h, w["input_layernorm"], eps), pos, allowed)
        x = rms_norm(h, w["post_attention_layernorm"], eps)
        if is_moe_layer(cfg, i):
            h = h + moe(cfg, w, x.reshape(b * length, -1)).view(b, length, -1)
        else:
            h = h + swiglu(x, w["gate_up_proj"], w["down_proj"])
        del w
    if logits_at is not None:
        h = torch.gather(h, 1, logits_at[..., None].expand(-1, -1, h.shape[-1]))
    h = rms_norm(h, p["norm.weight"].to(dt), eps)
    return h @ p["lm_head.weight"].to(dt).t()


# ----------------------------------------------------------------------------
# recommendation
# ----------------------------------------------------------------------------

def item_trie(codes: np.ndarray) -> Dict[tuple, set]:
    """Each prefix of digits that some item has → the digits that continue
    it at the next level."""
    out: Dict[tuple, set] = {}
    for row in np.asarray(codes, dtype=np.int64).tolist():
        for lvl in range(len(row)):
            out.setdefault(tuple(row[:lvl]), set()).add(row[lvl])
    return out


def _digit(cfg: dict, tok: int, step: int) -> int:
    """The digit a token stands for at level ``step``, clamped to the
    codebook (a token the trie rules out walks to a prefix of clamped
    digits, as the beam search's prefix arithmetic does)."""
    k = cfg["codebook_size"]
    return min(max(tok - (cfg["sid_base"] + step * k), 0), k - 1)


def _allowed_tokens(cfg: dict, trie, prefix: tuple, step: int) -> List[int]:
    base = cfg["sid_base"] + step * cfg["codebook_size"]
    return [base + d for d in sorted(trie.get(prefix, ()))]


def _repeat(t: torch.Tensor, k: int) -> torch.Tensor:
    return t.repeat_interleave(k, dim=0)


@torch.no_grad()
def sequence_scores(cfg: dict, p: Dict[str, torch.Tensor], ids, mask, tokens, trie) -> torch.Tensor:
    """The score beam search gives each of ``tokens`` (B, K, code_dim + 1)
    (a start placeholder, then the digits): the sum of each digit's
    teacher-forced log-probability after the prompt and the digits before
    it, -1e30 for each digit the trie rules out."""
    b, k, t = tokens.shape
    steps = t - 1
    length = ids.shape[1]
    full = torch.cat([_repeat(ids, k), tokens[:, :, 1:steps].reshape(b * k, steps - 1)], 1)
    fmask = torch.cat([_repeat(mask, k), torch.ones((b * k, steps - 1), dtype=mask.dtype,
                                                     device=mask.device)], 1)
    at = torch.arange(length - 1, length - 1 + steps, device=ids.device).expand(b * k, steps)
    lp = torch.log_softmax(forward(cfg, p, full, fmask, at), dim=-1)
    lp = torch.gather(lp, 2, tokens[:, :, 1:].reshape(b * k, steps, 1))[..., 0].view(b, k, steps)
    total = torch.zeros((b, k), dtype=torch.float32, device=tokens.device)
    toks = tokens.tolist()
    for step in range(steps):
        ok = torch.tensor([[toks[i][j][step + 1] in _allowed_tokens(
            cfg, trie, tuple(_digit(cfg, x, s) for s, x in enumerate(toks[i][j][1:step + 1])),
            step) for j in range(k)] for i in range(b)], device=tokens.device)
        total = total + torch.where(ok, lp[:, :, step], torch.full_like(total, NEG_BEAM))
    return total


@torch.no_grad()
def beam_search(cfg: dict, p: Dict[str, torch.Tensor], ids, mask, num_beams: int,
                trie) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trie-constrained beam search, (tokens (B, K, code_dim + 1), scores
    (B, K)) best first: each step runs the whole prompt and prefix again;
    every extension of every beam is scored by the beam's score plus the
    token's log-probability, a token the trie rules out at -1e30, and the
    best K are kept by a stable sort (lower flat index first on ties)."""
    b, k, v = ids.shape[0], num_beams, cfg["vocab_size"]
    steps, dev = cfg["code_dim"], ids.device
    length = ids.shape[1]
    tokens = torch.full((b, k, steps + 1), cfg["eos_token_id"], dtype=torch.long, device=dev)
    tokens[:, :, 0] = cfg["bos_token_id"]
    scores = torch.full((b, k), NEG_BEAM, device=dev)
    scores[:, 0] = 0.0
    prefixes = [[() for _ in range(k)] for _ in range(b)]
    for step in range(steps):
        if step == 0:  # every beam's prefix is the prompt
            at = torch.full((b, 1), length - 1, dtype=torch.long, device=dev)
            logits = _repeat(forward(cfg, p, ids, mask, at)[:, 0], k)
        else:
            full = torch.cat([_repeat(ids, k), tokens[:, :, 1:step + 1].reshape(b * k, step)], 1)
            fmask = torch.cat([_repeat(mask, k), torch.ones((b * k, step), dtype=mask.dtype,
                                                             device=dev)], 1)
            at = torch.full((b * k, 1), length + step - 1, dtype=torch.long, device=dev)
            logits = forward(cfg, p, full, fmask, at)[:, 0]
        lp = torch.log_softmax(logits, dim=-1).view(b, k, v)
        allowed = torch.zeros((b, k, v), dtype=torch.bool)
        for i in range(b):
            for j in range(k):
                allowed[i, j, _allowed_tokens(cfg, trie, prefixes[i][j], step)] = True
        lp = torch.where(allowed.to(dev), lp, torch.full_like(lp, NEG_BEAM))
        cand = (scores[:, :, None] + lp).view(b, k * v)
        top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        beam, tok = idx // v, idx % v
        tokens = torch.gather(tokens, 1, beam[:, :, None].expand(b, k, steps + 1)).clone()
        tokens[:, :, step + 1] = tok
        parents, picked = beam.tolist(), tok.tolist()
        prefixes = [[prefixes[i][parents[i][j]] + (_digit(cfg, picked[i][j], step),)
                     for j in range(k)] for i in range(b)]
        scores = top
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(tokens, 1, order[:, :, None].expand(b, k, steps + 1)), scores

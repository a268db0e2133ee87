"""DeepSeek-V2 as a semantic-ID recommender.

A decoder-only mixture-of-experts language model (arXiv 2405.04434; the
layer equations of the published ``modeling_deepseek.py``) whose last
``code_dim · codebook_size`` vocabulary ids are the items' semantic-ID
digits, as LC-Rec (arXiv 2311.09049) puts them into an LLM's vocabulary.
It serves TIGER's contract: :func:`generate` returns ``num_beams`` item
sequences a prompt under the item trie (``ops/beam_search.py``).

A layer: ``h += MLA(RMSNorm(h)); h += MLP(RMSNorm(h))``.

- MLA without a query LoRA: ``q = W_q x`` split into ``q_nope`` and
  ``q_pe``; ``[c_kv; k_pe] = W_kva x``, ``c_kv = RMSNorm(c_kv)``,
  ``[k_nope; v] = W_kvb c_kv`` per head; ``q_pe`` and ``k_pe`` (one for all
  heads) rotated by YaRN rope, whose dims are interleaved pairs (viewed as
  (d/2, 2) and transposed before ``rotate_half``); softmax scale
  ``(nope + rope)^-1/2 · mscale(factor, mscale_all_dim)²`` with
  ``mscale(s, m) = 0.1·m·ln s + 1``.
- MLP: SwiGLU ``down(silu(gate x) · up x)`` in the first
  ``first_k_dense_replace`` layers; then MoE: ``Σ_top-k softmax(W_g x)_i ·
  E_i(x) + S(x)``, greedy top-k of the f32 softmax, weights not
  renormalised (``norm_topk_prob`` false) and scaled by
  ``routed_scaling_factor``; each expert and the shared expert ``S`` (of
  width ``n_shared_experts · moe_intermediate_size``) a SwiGLU.

Weights and products are in ``cfg.dtype`` (bf16 on the card) with f32
accumulation; the residual stream, the norms, rope, the attention softmax,
the router and the experts' weighted sum are f32. Each SwiGLU holds its
gate and up projections as one matrix, gate rows first; the routed
experts' weights are stacked (experts, out, in).

Recommendation (:func:`generate`):

- prefill: the left-padded prompt's real tokens only, packed (one host
  sync a batch, for their count), positions counting real tokens, so a
  padded row gives its unpadded row's logits; attention in the (B, L)
  layout; the first digit's logits from each prompt's last position;
- :class:`LatentCache`: MLA's latent rows (``c_kv`` 512 and the rotated
  ``k_pe`` 64 a position and layer, against 16 × (192 + 128) for per-head
  K and V): the prompt's once per prompt, read by all of its beams; the
  generated positions' per beam, gathered by ``beam_search(reorder=)``;
- decode: one new position a beam, attention in the absorbed form: ``q_nope
  · W_UK`` into latent space, scores against ``c_kv`` and ``k_pe``, the
  output back through ``W_UV``; the prompt's latents read once per prompt
  for its beams' ``beams · heads`` query rows;
- MoE: the rows sorted by expert, the routed experts as two grouped GEMMs
  (``torch._grouped_mm``) over offsets kept on the card, no host sync.

Spans and counters (``utils.profiling``, on under a profiler only):
``lm.prefill``; ``moe.route`` (gate, top-k, sort and offsets), ``moe.experts``
(the grouped GEMMs and the shared expert), ``moe.combine`` (the weighted
sum); ``mla.decode`` (the absorbed attention); ``moe.rows`` (token-expert
assignments), ``moe.busiest`` (the busiest expert's rows a layer-pass,
summed on the card) and ``mla.cache.positions`` (latent positions read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genrec_tpu_torch.configs import DeepSeekV2Config
from genrec_tpu_torch.data import tiger_tokens
from genrec_tpu_torch.ops.beam_search import ConstraintSpec, beam_search
from genrec_tpu_torch.utils import profiling
from genrec_tpu_torch.utils.profiling import span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg: DeepSeekV2Config) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# the published keys this model reads only at these values
SUPPORTED = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func": "softmax",
             "norm_topk_prob": False, "tie_word_embeddings": False, "hidden_act": "silu",
             "attention_bias": False}


def check_supported(cfg: DeepSeekV2Config) -> None:
    """ValueError where ``cfg`` asks for what this model does not compute: a
    query LoRA, group-limited or sigmoid routing, renormalised top-k weights,
    a tied head, another activation, attention biases, or rope other than
    YaRN."""
    for key, want in SUPPORTED.items():
        if getattr(cfg, key) != want:
            raise ValueError(f"DeepSeekV2: {key}={getattr(cfg, key)!r} is not supported "
                             f"(only {want!r})")
    if cfg.rope_scaling and cfg.rope_scaling.get("type") != "yarn":
        raise ValueError(f"DeepSeekV2: rope_scaling type {cfg.rope_scaling.get('type')!r} "
                         "is not supported (only 'yarn')")


# ----------------------------------------------------------------------------
# YaRN rope
# ----------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: DeepSeekV2Config) -> float:
    """The attention's score scale: ``(nope + rope)^-1/2``, times
    ``mscale(factor, mscale_all_dim)²`` under YaRN."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    rs = cfg.rope_scaling
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(cfg: DeepSeekV2Config, device) -> torch.Tensor:
    """(rope / 2,) f32 inverse frequencies: the extrapolated ones below the
    correction range, the interpolated (/ factor) ones above it, a linear
    ramp between."""
    dim, base, rs = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling
    power = base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    extra = 1.0 / power
    if not rs:
        return extra
    inter = 1.0 / (rs["factor"] * power)
    max_pos = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base, max_pos)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base, max_pos)), dim - 1)
    span_ = high - low if high != low else 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / span_).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_attention_factor(cfg: DeepSeekV2Config) -> float:
    """The factor on cos and sin: mscale(factor, mscale) / mscale(factor,
    mscale_all_dim), 1 for DeepSeek-V2-Lite."""
    rs = cfg.rope_scaling
    if not rs:
        return 1.0
    return yarn_mscale(rs["factor"], rs.get("mscale", 1)) / \
        yarn_mscale(rs["factor"], rs.get("mscale_all_dim", 0))


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, rope) f32 cos and sin at ``positions`` (N,)."""
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * factor, emb.sin() * factor


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope on ``x`` (..., rope), in f32, back in x's dtype: the
    dims, interleaved pairs, viewed as (rope/2, 2) and transposed, then
    ``x·cos + rotate_half(x)·sin``."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def prompt_positions(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) rope positions of a padded prompt: each real token's count of
    real tokens before it (0 at the padding)."""
    return (mask.long().cumsum(1) - 1).clamp(min=0)


# ----------------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(out_dtype)


class SwiGLU(nn.Module):
    """``down(silu(gate x) · up x)``, gate and up as one matrix."""

    def __init__(self, hidden: int, inter: int, dtype: torch.dtype):
        super().__init__()
        self.inter = inter
        self.gate_up_proj = nn.Linear(hidden, 2 * inter, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(inter, hidden, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gu = self.gate_up_proj(x)
        return self.down_proj(F.silu(gu[:, :self.inter]) * gu[:, self.inter:])


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[g-1]:offs[g]`` of ``x`` (M, in) times ``w[g]ᵀ`` (``w`` is
    (groups, out, in)), one launch: (M, out)."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)


class Experts(nn.Module):
    """The routed experts' stacked SwiGLU weights."""

    def __init__(self, n: int, hidden: int, inter: int, dtype: torch.dtype):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * inter, hidden, dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, inter, dtype=dtype))

    def forward(self, rows: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """``rows`` sorted by expert, expert g's ending at ``offs[g]``."""
        inter = self.down_proj.shape[2]
        gu = grouped_mm(rows, self.gate_up_proj, offs)
        return grouped_mm(F.silu(gu[:, :inter]) * gu[:, inter:], self.down_proj, offs)


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int,
          scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (N, k) f32, experts (N, k)): the greedy top-k of the softmax
    of the gate's logits, both in f32, not renormalised, times ``scaling``."""
    probs = F.linear(x.float(), gate_weight.float()).softmax(dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1, sorted=False)
    return w * scaling, idx


class MoE(nn.Module):
    def __init__(self, cfg: DeepSeekV2Config, dtype: torch.dtype):
        super().__init__()
        h, e = cfg.hidden_size, cfg.n_routed_experts
        self.top_k, self.scaling, self.n_experts = (cfg.num_experts_per_tok,
                                                    cfg.routed_scaling_factor, e)
        self.gate = nn.Linear(h, e, bias=False, dtype=dtype)
        self.experts = Experts(e, h, cfg.moe_intermediate_size, dtype)
        self.shared_experts = (SwiGLU(h, cfg.moe_intermediate_size * cfg.n_shared_experts, dtype)
                               if cfg.n_shared_experts else None)

    def shared(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        return None if self.shared_experts is None else self.shared_experts(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, hidden) in the compute dtype → (N, hidden) f32."""
        n, hidden = x.shape
        with span("moe.route"):
            w, idx = route(x, self.gate.weight, self.top_k, self.scaling)
            k = idx.shape[1]
            expert, order = torch.sort(idx.reshape(-1), stable=True)
            offs = torch.searchsorted(expert, torch.arange(self.n_experts, device=x.device),
                                      right=True).to(torch.int32)
            profiling.count("moe.rows", n * k)
            if profiling.recording():  # the busiest expert's rows, on the card
                profiling.count_device("moe.busiest",
                                       torch.diff(offs, prepend=offs.new_zeros(1)).max())
        with span("moe.experts"):
            y = self.experts(x.index_select(0, order // k), offs)
            shared = self.shared(x)
        with span("moe.combine"):
            back = torch.empty_like(order)
            back[order] = torch.arange(order.numel(), device=x.device)
            rows = y.index_select(0, back).view(n, k, hidden).float()
            out = torch.bmm(w.unsqueeze(1), rows).view(n, hidden)
            if shared is not None:
                out.add_(shared)
        return out


@dataclasses.dataclass
class _Packing:
    """The real positions of a padded (B, L) prompt, packed in row order."""

    flat: torch.Tensor       # (N,) indices into the flattened (B·L) layout
    batch: int
    length: int
    attn_mask: torch.Tensor  # (B, 1, L, L) bool: causal over real keys, and the diagonal

    def pad(self, t: torch.Tensor) -> torch.Tensor:
        """(N, heads, d) → (B, heads, L, d), zeros at the padding."""
        out = t.new_zeros((self.batch * self.length,) + t.shape[1:])
        out.index_copy_(0, self.flat, t)
        return out.view(self.batch, self.length, *t.shape[1:]).transpose(1, 2)

    def unpad(self, o: torch.Tensor) -> torch.Tensor:
        """(B, heads, L, d) → (N, heads·d)."""
        return o.transpose(1, 2).reshape(self.batch * self.length, -1).index_select(0, self.flat)


@dataclasses.dataclass
class LatentCache:
    """MLA's decode state through one :func:`generate` call: ``prompt``, each
    layer's latent rows of the prompts (layers, B, L, kv_lora + rope), once
    per prompt, and ``key_bias`` (B, L), 0 at their tokens and −inf at their
    padding; ``gen``, each layer's latent rows of the generated positions
    per beam (layers, B·K, steps, kv_lora + rope), with a ``spare`` of the
    same shape (slot ``s`` written at decode step ``s``; ``filled`` counts
    the slots written); ``row_positions`` (B·K,), the rope position of slot
    0 (the prompt's real length). :meth:`reorder` gathers the generated
    slots by the beams' parents, one ``index_select`` for all layers."""

    prompt: torch.Tensor
    key_bias: torch.Tensor
    gen: torch.Tensor
    spare: torch.Tensor
    row_positions: torch.Tensor
    num_beams: int
    filled: int = 0

    def reorder(self, flat_parents: torch.Tensor) -> None:
        n = self.filled
        if n:
            torch.index_select(self.gen[:, :, :n], 1, flat_parents, out=self.spare[:, :, :n])
            self.gen, self.spare = self.spare, self.gen


class MLA(nn.Module):
    """Multi-head latent attention without a query LoRA (HF names)."""

    def __init__(self, cfg: DeepSeekV2Config, dtype: torch.dtype):
        super().__init__()
        h = cfg.hidden_size
        self.heads, self.nope, self.rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                                            cfg.qk_rope_head_dim)
        self.vdim, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        self.q_proj = nn.Linear(h, self.heads * (self.nope + self.rope), bias=False, dtype=dtype)
        self.kv_a_proj_with_mqa = nn.Linear(h, self.rank + self.rope, bias=False, dtype=dtype)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps, dtype)
        self.kv_b_proj = nn.Linear(self.rank, self.heads * (self.nope + self.vdim), bias=False,
                                   dtype=dtype)
        self.o_proj = nn.Linear(self.heads * self.vdim, h, bias=False, dtype=dtype)
        self.scale = softmax_scale(cfg)

    def project(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """(q (N, heads, nope + rope), its rope part rotated; the latent row
        (N, rank + rope): the normalised ``c_kv`` and the rotated ``k_pe``)."""
        n = x.shape[0]
        q = self.q_proj(x).view(n, self.heads, self.nope + self.rope)
        q[..., self.nope:] = apply_rope(q[..., self.nope:], cos[:, None], sin[:, None])
        latent = self.kv_a_proj_with_mqa(x)
        latent[:, :self.rank] = self.kv_a_layernorm(latent[:, :self.rank], x.dtype)
        latent[:, self.rank:] = apply_rope(latent[:, self.rank:], cos, sin)
        return q, latent

    def prefill(self, x, cos, sin, pack: _Packing, cache_rows: torch.Tensor) -> torch.Tensor:
        """The packed prompt's attention; writes its latent rows into
        ``cache_rows`` (B·L, rank + rope)."""
        n = x.shape[0]
        q, latent = self.project(x, cos, sin)
        cache_rows.index_copy_(0, pack.flat, latent)
        kv = self.kv_b_proj(latent[:, :self.rank]).view(n, self.heads, self.nope + self.vdim)
        k = torch.cat([kv[..., :self.nope],
                       latent[:, None, self.rank:].expand(n, self.heads, self.rope)], dim=-1)
        o = F.scaled_dot_product_attention(pack.pad(q), pack.pad(k),
                                           pack.pad(kv[..., self.nope:]),
                                           attn_mask=pack.attn_mask, scale=self.scale)
        return self.o_proj(pack.unpad(o))

    def decode(self, x, cos, sin, cache: LatentCache, layer: int, slot: int) -> torch.Tensor:
        """One new position a beam (rows b·K + k), attending in the absorbed
        form to its prompt's latent rows and its own generated ones."""
        n, heads, nope, rank = x.shape[0], self.heads, self.nope, self.rank
        beams = cache.num_beams
        b = n // beams
        q, latent = self.project(x, cos, sin)
        gen = cache.gen[layer]
        gen[:, slot] = latent
        with span("mla.decode"):
            w = self.kv_b_proj.weight.view(heads, nope + self.vdim, rank)
            q_lat = torch.bmm(q[..., :nope].transpose(0, 1), w[:, :nope])           # (h, N, rank)
            qc = torch.cat([q_lat.transpose(0, 1), q[..., nope:]], dim=-1)           # (N, h, R)
            prompt = cache.prompt[layer]                                              # (B, L, R)
            length = prompt.shape[1]
            seen = gen[:, :slot + 1]                                                  # (N, s+1, R)
            s_prompt = torch.bmm(qc.reshape(b, beams * heads, -1), prompt.transpose(1, 2))
            s_gen = torch.bmm(qc, seen.transpose(1, 2))
            s = torch.cat([s_prompt.view(n, heads, length), s_gen], dim=-1).float() * self.scale
            s.view(b, beams, heads, -1)[..., :length] += cache.key_bias[:, None, None, :]
            p = s.softmax(dim=-1).to(x.dtype)
            o = torch.bmm(p[..., :length].reshape(b, beams * heads, length),
                          prompt[..., :rank]).view(n, heads, rank).float()
            o = (o + torch.bmm(p[..., length:], seen[..., :rank]).float()).to(x.dtype)
            o = torch.bmm(o.transpose(0, 1), w[:, nope:].transpose(1, 2))           # (h, N, v)
            profiling.count("mla.cache.positions", b * length + n * (slot + 1))
        return self.o_proj(o.transpose(0, 1).reshape(n, heads * self.vdim))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepSeekV2Config, index: int, dtype: torch.dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.dtype = dtype
        self.input_layernorm = RMSNorm(h, eps, dtype)
        self.self_attn = MLA(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(h, eps, dtype)
        moe = (cfg.n_routed_experts is not None and index >= cfg.first_k_dense_replace
               and index % cfg.moe_layer_freq == 0)
        self.mlp = MoE(cfg, dtype) if moe else SwiGLU(h, cfg.intermediate_size, dtype)

    def mlp_residual(self, h: torch.Tensor) -> torch.Tensor:
        """``h += MLP(RMSNorm(h))``, in place (f32, the output taken up as added)."""
        return h.add_(self.mlp(self.post_attention_layernorm(h, self.dtype)))


class DeepSeekV2(nn.Module):
    """The decoder-only model (HF parameter names without ``model.``). Its
    weights are not drawn here: load them (``load_state_dict``); ``device``
    ``"meta"`` builds it without memory, for ``load_state_dict(...,
    assign=True)`` of weights made elsewhere (no host copy of them)."""

    def __init__(self, cfg: DeepSeekV2Config, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = compute_dtype(cfg)
        with torch.device(device) if device is not None else contextlib.nullcontext():
            # given its (uninitialised) weight: a normal_ draw on ``meta`` imports torch._dynamo
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, _weight=torch.empty(
                cfg.vocab_size, cfg.hidden_size, dtype=dt))
            self.layers = nn.ModuleList(DecoderLayer(cfg, i, dt)
                                        for i in range(cfg.num_hidden_layers))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dt)
        self._inv_freq: Dict[torch.device, torch.Tensor] = {}

    def rope(self, positions: torch.Tensor):
        dev = positions.device
        if dev not in self._inv_freq:
            self._inv_freq[dev] = yarn_inv_freq(self.cfg, dev)
        return rope_cos_sin(positions, self._inv_freq[dev], rope_attention_factor(self.cfg))

    def _prompt_pass(self, input_ids, attention_mask):
        """The prompt's pass over its real tokens: (final hidden states of the
        packed tokens (N, hidden) f32, the packing, the latent rows
        (layers, B·L, rank + rope))."""
        cfg, dt = self.cfg, self.embed_tokens.weight.dtype
        b, length = input_ids.shape
        mask = attention_mask.bool()
        flat = mask.reshape(-1).nonzero().squeeze(1)  # a host sync: the real tokens' count
        cos, sin = self.rope(prompt_positions(mask).reshape(-1)[flat])
        at = torch.arange(length, device=input_ids.device)
        causal = at[:, None] >= at[None, :]
        attn = (causal[None] & mask[:, None, :]) | (at[:, None] == at[None, :])[None]
        pack = _Packing(flat, b, length, attn.unsqueeze(1))
        rows = torch.zeros((cfg.num_hidden_layers, b * length,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype=dt,
                           device=input_ids.device)
        h = self.embed_tokens(input_ids.reshape(-1).index_select(0, flat)).float()
        for i, layer in enumerate(self.layers):
            x = layer.input_layernorm(h, dt)
            h.add_(layer.self_attn.prefill(x, cos, sin, pack, rows[i]))
            h = layer.mlp_residual(h)
        return h, pack, rows

    def forward(self, input_ids, attention_mask) -> torch.Tensor:
        """Logits (B, L, V) at every real position of a padded prompt (0 at
        the padding), in the compute dtype."""
        h, pack, _ = self._prompt_pass(input_ids, attention_mask)
        logits = self.lm_head(self.norm(h, self.embed_tokens.weight.dtype))
        out = logits.new_zeros((pack.batch * pack.length, logits.shape[1]))
        out.index_copy_(0, pack.flat, logits)
        return out.view(pack.batch, pack.length, -1)

    def prefill(self, input_ids, attention_mask, num_beams: int):
        """(the first digit's logits (B, V) from each prompt's last real
        position, a :class:`LatentCache` for ``num_beams`` beams a prompt)."""
        cfg, dt = self.cfg, self.embed_tokens.weight.dtype
        b, length = input_ids.shape
        h, pack, rows = self._prompt_pass(input_ids, attention_mask)
        real = attention_mask.bool().sum(1)
        last = real.cumsum(0) - 1  # each prompt's last real token in the packing
        logits = self.lm_head(self.norm(h.index_select(0, last), dt))
        width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        gen_shape = (cfg.num_hidden_layers, b * num_beams, cfg.code_dim - 1, width)
        key_bias = torch.zeros((b, length), dtype=torch.float32, device=input_ids.device)
        key_bias.masked_fill_(~attention_mask.bool(), float("-inf"))
        cache = LatentCache(
            prompt=rows.view(cfg.num_hidden_layers, b, length, width), key_bias=key_bias,
            gen=torch.zeros(gen_shape, dtype=dt, device=input_ids.device),
            spare=torch.zeros(gen_shape, dtype=dt, device=input_ids.device),
            row_positions=real.repeat_interleave(num_beams), num_beams=num_beams)
        return logits, cache

    def decode_next(self, tokens: torch.Tensor, slot: int, cache: LatentCache) -> torch.Tensor:
        """Logits (B·K, V) after feeding ``tokens`` (B·K,), one a beam, as
        generated slot ``slot`` (rope position: the prompt's length + slot)."""
        dt = self.embed_tokens.weight.dtype
        h = self.embed_tokens(tokens).float()
        cos, sin = self.rope(cache.row_positions + slot)
        for i, layer in enumerate(self.layers):
            x = layer.input_layernorm(h, dt)
            h.add_(layer.self_attn.decode(x, cos, sin, cache, i, slot))
            h = layer.mlp_residual(h)
        cache.filled = slot + 1
        return self.lm_head(self.norm(h, dt))


# ----------------------------------------------------------------------------
# recommendation
# ----------------------------------------------------------------------------

def make_constraint(cfg: DeepSeekV2Config, codes: np.ndarray) -> ConstraintSpec:
    """The item trie over ``codes`` (N, code_dim), on the CPU (the beam
    search moves it to its device)."""
    children, allowed = tiger_tokens.build_trie_nodes(codes, cfg.codebook_size)
    return ConstraintSpec(mode="trie", trie_children=torch.from_numpy(children),
                          trie_allowed=torch.from_numpy(allowed),
                          codebook_size=cfg.codebook_size, token_base=cfg.sid_base)


@torch.no_grad()
def generate(model: DeepSeekV2, input_ids, attention_mask, *, num_beams: int,
             constraint: Optional[ConstraintSpec] = None):
    """Beam-search recommendation on the model's device, TIGER's contract:
    tokens (B, num_beams, code_dim + 1) int64, a start placeholder
    (``bos_token_id``) then the digits' tokens, and scores (B, num_beams)
    f32, best first. A prefill over the left-padded prompt gives the first
    digit's logits; each later digit is one cached decode step a beam.
    Spans: ``lm.prefill`` (the prompt's pass and its latent rows), then
    beam search's."""
    cfg = model.cfg
    device = model.embed_tokens.weight.device
    input_ids = torch.as_tensor(input_ids, device=device)
    attention_mask = torch.as_tensor(attention_mask, device=device)
    with span("lm.prefill"):
        first, cache = model.prefill(input_ids, attention_mask, num_beams)
        first = first.repeat_interleave(num_beams, dim=0)

    def decode_fn(tokens, step):
        return first if step == 0 else model.decode_next(tokens[:, step], step - 1, cache)

    return beam_search(
        decode_fn, input_ids.shape[0], num_beams, cfg.max_gen_len, cfg.vocab_size,
        decoder_start=cfg.bos_token_id, pad_token=cfg.eos_token_id, eos_token=None,
        constraint=constraint, reorder=cache.reorder, device=device)

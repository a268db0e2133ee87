"""Scratch T5 encoder-decoder, and the encoder-only ``T5Encoder``, in
PyTorch, with training-mode dropout.

Counterpart of ``genrec_tpu/models/t5.py`` with the same numerics: RMS
layer norm (no bias or mean), relative-position bucket biases (one table
per stack, bidirectional for the encoder only), bias-free projections,
unscaled attention, relu feed-forward, tied embeddings with d_model**-0.5
logit rescaling, decoder_start = pad. Module and parameter names follow
the reference's Flax tree, so ``convert.tiger_params_from_flax`` and
``convert.dense_t5_params_from_flax`` map them leaf for leaf.

Attention takes one of two paths:
- without a KV cache (encoder self-attention; the decoder's self- and
  cross-attention in full-sequence ``decode``) the structured-bias path:
  the per-head bias (H, Lq, Lk), with the causal mask folded into it, and
  the (B, Lk) key mask go separately to the fused kernel
  (``ops/t5_attention.py``), in its flat (H·B, L, D) layout;
- with a KV cache (``decode_step``) the plain path: decoder self-attention
  through ``ops/attention.dot_product_attention`` with q pre-scaled by
  √d_kv to cancel its 1/√d, and cross-attention with the beams folded into
  the query axis (``T5Attention._cross_attend_beams``).

Dropout (rate ``cfg.dropout_rate``) is on in training mode (``.train()``)
at the reference's Flax places: the stack's input and output, every
sublayer's output, the feed-forward hidden layer, and the attention weights
(through the fused kernel's multiplicative mask). Its masks are drawn from a
``torch.Generator`` that the caller passes to ``forward`` / ``encode`` /
``decode``; there is no global RNG, and training-mode dropout without a
generator raises. In ``.eval()`` (or at rate 0) no dropout operation runs.
Gradients reach every parameter; the attention's backward is the fused
kernel's (``ops/t5_attention.py``). The KV-cache path (``decode_step``) is
for generation in eval mode only.

``cfg.dtype`` is the computation dtype, float32 or bfloat16, placed as the
reference's Flax modules place it; parameters stay f32 either way. At
bfloat16 every projection (:class:`Dense`) casts its input and its f32
weight to bf16 and returns bf16, as ``nn.Dense(dtype=bf16)`` does, and the
shared embedding returns bf16 rows (:class:`Embed`); the relative-position
bias stays f32 and reaches kernel #1 as f32; RMSNorm returns f32 (its input
times the f32 rsqrt), so the next projection rounds it; the logits multiply
the f32 hidden by the raw f32 table. The residual stream follows the
promotion: bf16 where the stack's input is bf16 (TIGER's embeddings), f32
where it is f32 (DenseT5's ``inputs_embeds``). The attention kernels take
bf16 q/k/v and return bf16.

Rematerialisation, as the reference's flags ask, with
``torch.utils.checkpoint`` (non-reentrant) wherever gradients are recorded:
``cfg.remat`` checkpoints each ``T5Block``, ``cfg.ffn_remat_dropout`` each
``T5FeedForward``; ``cfg.attn_remat_dropout`` keeps the attention's
(H·B, Lq, Lk) dropout mask out of the saved tensors, and kernel #2's caller
draws it again from the generator's saved state (the reference checkpoints
its XLA dropout-attention core instead, whose backward regenerates the mask
from its key; the port's dropout attention runs through kernels #1 and #2,
which keep no probabilities). Checkpoint replays the global RNGs only, and
the port draws every mask from the caller's generator, so :func:`_remat`
replays that generator's state in the recompute and then puts it back: the
recompute draws the forward's masks, and the generator ends where the
forward without remat leaves it. The math is unchanged: loss and gradients
equal the forward without remat.

Tensor parallelism over the mesh's 'model' axis (``parallel/tensor.py``;
``parallel.tensor.shard_model_`` cuts the weights and sets ``tp_mesh``):
an attention whose q/k/v/o were cut runs this rank's heads [h0, h0 + H/M)
through kernels #1 and #2 in the same flat layout, its input through
``copy_to_model`` and ``o``'s partial output through ``reduce_from_model``;
the feed-forward takes ``wi``'s columns and ``wo``'s rows of d_ff alike; the
relative-bias table stays whole and each stack cuts its bias to the rank's
heads. Every dropout mask of a cut tensor is drawn at the whole tensor's
width and sliced, so a rank drops what the one-device model drops and the
generator advances as far; under ``_remat`` every rank recomputes, so the
collectives still pair. The KV-cache decode path runs on the whole model
only (evaluation and serving load the gathered weights).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from genrec_tpu_torch.configs import T5ArchConfig
from genrec_tpu_torch.models.layers import dropout as _dropout
from genrec_tpu_torch.ops.attention import dot_product_attention
from genrec_tpu_torch.ops.t5_attention import fused_t5_attention_flat, make_dropout_mask
from genrec_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

_NEG_INF = -1e9

KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class AttnSpec:
    """Structured attention inputs for the fused kernel: the per-head bias
    (H, Lq, Lk), with any causal mask already folded in, and the
    key-padding mask (B, Lk), kept apart instead of summed into one dense
    (B, H, Lq, Lk) bias."""

    pos_bias: Optional[torch.Tensor]
    kv_mask: Optional[torch.Tensor]


def _drop_rate(module: nn.Module, generator: Optional[torch.Generator]) -> float:
    """The dropout rate in force for ``module``: ``cfg.dropout_rate`` in
    training mode, else 0. Training-mode dropout needs ``generator``."""
    rate = module.cfg.dropout_rate if module.training else 0.0
    if rate > 0.0 and generator is None:
        raise ValueError("training-mode dropout draws its masks from a torch.Generator: "
                         "pass generator=..., or call .eval()")
    return rate


def compute_dtype(cfg: T5ArchConfig) -> Optional[torch.dtype]:
    """The dtype the projections and the embedding cast to for ``cfg.dtype``
    (the reference's ``_cdtype``): bf16, or None at float32, where they
    compute in their parameters' dtype (f32; f64 for an f64 copy of a model,
    as the smoke's witness steps make). Any other name raises."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"T5ArchConfig.dtype must be one of {sorted(_DTYPES)}, got "
                         f"{cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


class Dense(nn.Linear):
    """Bias-free projection computing in ``dtype`` as Flax's
    ``nn.Dense(use_bias=False, dtype=...)``: the input and the f32 weight are
    cast to ``dtype`` at each call, and the output is in ``dtype``; with
    ``dtype`` None, ``nn.Linear``. The parameter stays f32."""

    def __init__(self, d_in: int, d_out: int, dtype: Optional[torch.dtype]):
        super().__init__(d_in, d_out, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt))


class Embed(nn.Embedding):
    """``nn.Embedding`` whose rows come out in ``dtype``: as Flax's
    ``nn.Embed(dtype=...)``, the f32 table is cast to ``dtype`` and then
    gathered, so the rows' gradients are summed in ``dtype`` too; with
    ``dtype`` None, ``nn.Embedding``. The parameter stays f32."""

    def __init__(self, num: int, dim: int, dtype: Optional[torch.dtype]):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        if self.compute_dtype is None:
            return super().forward(ids)
        return F.embedding(ids, self.weight.to(self.compute_dtype))


def _remat(fn, generator: Optional[torch.Generator], *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept. The
    recompute runs with ``generator`` set back to its state at this call, so
    that it draws the same dropout masks, and then puts the generator back
    where it was; the global RNGs are not touched (nothing here draws from
    them)."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    state, calls = generator.get_state(), []

    def run(*a):
        if not calls:  # the forward
            calls.append(1)
            return fn(*a)
        after = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:  # also when the recompute stops early
            generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        nn.init.normal_(t, 0.0, std, generator=generator)


class RMSNorm(nn.Module):
    """T5LayerNorm: scale-only RMS normalization."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        return (self.weight * x).to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5 bucket function (memory_pos - query_pos → bucket id), with the
    reference's f32 log and int32 truncation."""
    relative_position = relative_position.to(torch.int32)
    ret = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (relative_position > 0).to(torch.int32) * num_buckets
        rel = relative_position.abs()
    else:
        rel = -torch.clamp(relative_position, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32,
                                       device=rel.device))
    rel_if_large = max_exact + (
        torch.log(torch.clamp(rel, min=1).to(torch.float32) / max_exact)
        / log_ratio * (num_buckets - max_exact)
    ).to(torch.int32)
    rel_if_large = torch.clamp(rel_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel, rel_if_large)


class RelativePositionBias(nn.Module):
    def __init__(self, cfg: T5ArchConfig, bidirectional: bool):
        super().__init__()
        self.cfg = cfg
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(
            torch.empty(cfg.relative_attention_num_buckets, cfg.num_heads))
        self.tp_mesh = None  # set by parallel.tensor.shard_model_

    def reset_parameters(self, generator=None):
        _normal_(self.rel_embedding, (self.cfg.d_model // self.cfg.num_heads) ** -0.5,
                 generator)

    def buckets(self, qlen: int, klen: int) -> torch.Tensor:
        dev = self.rel_embedding.device
        ctx = torch.arange(qlen, device=dev)[:, None]
        mem = torch.arange(klen, device=dev)[None, :]
        return relative_position_bucket(
            mem - ctx, bidirectional=self.bidirectional,
            num_buckets=self.cfg.relative_attention_num_buckets,
            max_distance=self.cfg.relative_attention_max_distance)

    def forward(self, qlen: int, klen: int, heads: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
        """(1, heads, q, k); with ``heads`` = (first, count) fewer than all,
        those heads of the whole table (a tensor-parallel rank's), whose
        gradient is then summed over 'model'."""
        table = self.rel_embedding
        if heads is not None and heads[1] < self.cfg.num_heads:
            table = copy_to_model(table, self.tp_mesh)[:, heads[0]:heads[0] + heads[1]]
        bias = table[self.buckets(qlen, klen)]  # (q, k, heads)
        return bias.permute(2, 0, 1)[None]      # (1, heads, q, k)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5ArchConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        dt = compute_dtype(cfg)
        self.q = Dense(cfg.d_model, inner, dt)
        self.k = Dense(cfg.d_model, inner, dt)
        self.v = Dense(cfg.d_model, inner, dt)
        self.o = Dense(inner, cfg.d_model, dt)
        self.tp_mesh = None  # set by parallel.tensor.shard_model_

    def reset_parameters(self, generator=None):
        c = self.cfg
        inner = c.num_heads * c.d_kv
        _normal_(self.q.weight, (c.d_model * c.d_kv) ** -0.5, generator)
        _normal_(self.k.weight, c.d_model ** -0.5, generator)
        _normal_(self.v.weight, c.d_model ** -0.5, generator)
        _normal_(self.o.weight, inner ** -0.5, generator)

    def local_heads(self) -> Tuple[int, int]:
        """(first head, head count) this rank computes: every head unless
        q/k/v/o were cut over 'model', then its block of H/M heads."""
        hl = self.q.weight.shape[0] // self.cfg.d_kv
        return (0 if hl == self.cfg.num_heads else self.tp_mesh.index("model") * hl), hl

    def _split_heads(self, t):
        b, l, _ = t.shape
        return t.view(b, l, self.cfg.num_heads, self.cfg.d_kv).transpose(1, 2)

    def project_kv(self, kv) -> KV:
        """(B, Lk, d_model) → per-head K/V (B, heads, Lk, d_kv), computed once
        per sample and reused at every decode step."""
        return self._split_heads(self.k(kv)), self._split_heads(self.v(kv))

    @staticmethod
    def _cross_attend_beams(qh, kh, vh, bias, num_beams: int):
        """Cross-attention with beams folded into the QUERY-LENGTH axis.

        qh: (B·m, h, s, dkv) queries of m beams per sample; kh/vh:
        (B, h, Le, dkv) per-sample K/V, never repeated per beam. Unscaled
        dot product; ``bias`` (B, 1, 1, Le) is the same for every beam."""
        bm, h, s, dkv = qh.shape
        b = bm // num_beams
        q2 = (qh.reshape(b, num_beams, h, s, dkv)
              .transpose(1, 2).reshape(b, h, num_beams * s, dkv))
        logits = torch.matmul(q2.float(), kh.float().transpose(-1, -2))
        if bias is not None:
            logits = logits + bias
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        ctx = torch.matmul(probs.float(), vh.float()).to(vh.dtype)  # f32 sums
        return (ctx.reshape(b, h, num_beams, s, dkv)
                .transpose(1, 2).reshape(bm, h, s, dkv))

    def forward(self, x, kv, bias, *, kv_cache: Optional[KV] = None,
                kv_beams: Optional[int] = None, generator: Optional[torch.Generator] = None):
        c = self.cfg
        h, dkv = c.num_heads, c.d_kv
        inner = h * dkv
        b, lq = x.shape[0], x.shape[1]
        h0, hl = self.local_heads()
        if isinstance(bias, AttnSpec):
            if kv_cache is not None:
                raise ValueError("AttnSpec with kv_cache is unsupported")
            lk = kv.shape[1]
            mesh = self.tp_mesh if hl < h else None
            if mesh is not None:  # this rank's heads: q/k/v column-parallel
                self_attention = kv is x
                x = copy_to_model(x, mesh)
                kv = x if self_attention else copy_to_model(kv, mesh)

            def flat(t, ll):  # (B, L, H·D) → (H·B, L, D), head slowest
                # at B = 1 the reshape is a strided view: make it contiguous
                return (t.view(b, ll, hl, dkv).permute(2, 0, 1, 3)
                        .reshape(hl * b, ll, dkv).contiguous())

            rate = _drop_rate(self, generator)
            # attn_remat_dropout: the kernel's caller draws the mask and draws
            # it again for the backward instead of keeping it
            redraw = rate > 0.0 and c.attn_remat_dropout
            # drawn at the width of all H heads: this rank keeps its heads' rows
            cut = mesh is not None
            dmask = (make_dropout_mask(generator, h * b, lq, lk, rate, x.device,
                                       slice(h0 * b, (h0 + hl) * b) if cut else None)
                     if rate > 0.0 and not redraw else None)
            of = fused_t5_attention_flat(flat(self.q(x), lq), flat(self.k(kv), lk),
                                         flat(self.v(kv), lk), hl, bias.pos_bias,
                                         bias.kv_mask, dropout_rate=rate, dropout_mask=dmask,
                                         dropout_generator=generator if redraw else None,
                                         dropout_rows=(h0 * b, h * b) if redraw and cut else None)
            out = of.view(hl, b, lq, dkv).permute(1, 2, 0, 3).reshape(b, lq, hl * dkv)
            return reduce_from_model(self.o(out), mesh)  # o row-parallel
        if hl < h:
            raise ValueError("the KV-cache attention runs on the whole model: load the "
                             "gathered weights (parallel.tensor.gather_state) to decode")
        qh = self._split_heads(self.q(x))
        kh, vh = kv_cache if kv_cache is not None else self.project_kv(kv)
        if kv_cache is not None and kv_beams is not None and kv_beams > 1:
            out = self._cross_attend_beams(qh, kh, vh, bias, kv_beams)
        else:
            # T5 uses an unscaled dot product; dot_product_attention divides
            # by sqrt(d_kv), so pre-scale q to cancel it.
            out = dot_product_attention(qh * (dkv ** 0.5), kh, vh, bias)
        return self.o(out.transpose(1, 2).reshape(b, lq, inner))


class T5FeedForward(nn.Module):
    def __init__(self, cfg: T5ArchConfig):
        super().__init__()
        if cfg.feed_forward_proj not in ("relu", "gelu", "gated-gelu"):
            raise ValueError(cfg.feed_forward_proj)
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.wi = Dense(cfg.d_model, cfg.d_ff, dt)
        self.wo = Dense(cfg.d_ff, cfg.d_model, dt)
        self.tp_mesh = None  # set by parallel.tensor.shard_model_

    def reset_parameters(self, generator=None):
        _normal_(self.wi.weight, self.cfg.d_model ** -0.5, generator)
        _normal_(self.wo.weight, self.cfg.d_ff ** -0.5, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        d_ff, fl = self.cfg.d_ff, self.wi.weight.shape[0]
        # cut over 'model': this rank's d_ff block, wi column- and wo row-parallel
        mesh = self.tp_mesh if fl < d_ff else None
        h = self.wi(copy_to_model(x, mesh))
        if self.cfg.feed_forward_proj == "relu":
            h = F.relu(h)
        else:  # flax nn.gelu is the tanh approximation
            h = F.gelu(h, approximate="tanh")
        cols = None if mesh is None else (mesh.index("model") * fl, d_ff)
        return reduce_from_model(self.wo(_dropout(h, _drop_rate(self, generator), generator,
                                                  cols=cols)), mesh)


class T5Block(nn.Module):
    def __init__(self, cfg: T5ArchConfig, is_decoder: bool):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        eps = cfg.layer_norm_epsilon
        self.self_norm = RMSNorm(cfg.d_model, eps)
        self.self_attn = T5Attention(cfg)
        if is_decoder:
            self.cross_norm = RMSNorm(cfg.d_model, eps)
            self.cross_attn = T5Attention(cfg)
        self.ff_norm = RMSNorm(cfg.d_model, eps)
        self.ff = T5FeedForward(cfg)

    def forward(self, x, self_bias, enc_out=None, cross_mask=None,
                cross_kv: Optional[KV] = None, cross_kv_beams: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        rate = _drop_rate(self, generator)
        h = self.self_norm(x)
        x = x + _dropout(self.self_attn(h, h, self_bias, generator=generator), rate, generator)
        if self.is_decoder and (enc_out is not None or cross_kv is not None):
            h = self.cross_norm(x)
            x = x + _dropout(self.cross_attn(h, enc_out, cross_mask, kv_cache=cross_kv,
                                             kv_beams=cross_kv_beams, generator=generator),
                             rate, generator)
        h = self.ff_norm(x)
        if self.cfg.ffn_remat_dropout and torch.is_grad_enabled():
            ff = _remat(self.ff, generator, h, generator)
        else:
            ff = self.ff(h, generator)
        return x + _dropout(ff, rate, generator)


def _extend_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, Lk) 1/0 mask → additive (B, 1, 1, Lk) bias."""
    return (1.0 - attention_mask[:, None, None, :].float()) * _NEG_INF


def _causal_bias(length: int, device) -> torch.Tensor:
    row = torch.arange(length, device=device)[:, None]
    col = torch.arange(length, device=device)[None, :]
    return torch.where(col > row, _NEG_INF, 0.0).to(torch.float32)


class T5Stack(nn.Module):
    def __init__(self, cfg: T5ArchConfig, num_layers: int, is_decoder: bool):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        self.rel_bias = RelativePositionBias(cfg, bidirectional=not is_decoder)
        self.blocks = nn.ModuleList(T5Block(cfg, is_decoder) for _ in range(num_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, inputs_embeds, attention_mask=None, enc_out=None, enc_mask=None,
                *, cross_kvs: Optional[Sequence[KV]] = None,
                cross_kv_beams: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        rate = _drop_rate(self, generator)
        lq = inputs_embeds.shape[1]
        dev = inputs_embeds.device
        if cross_kvs is None:
            # (H, Lq, Lq); this rank's heads under tensor parallelism
            pos = self.rel_bias(lq, lq, self.blocks[0].self_attn.local_heads())[0]
            if self.is_decoder:
                pos = pos + _causal_bias(lq, dev)  # causal folded into the bias
            contig = lambda m: None if m is None else m.contiguous()  # noqa: E731
            self_bias = AttnSpec(pos.contiguous(), contig(attention_mask))
            cross_mask = AttnSpec(None, contig(enc_mask)) if enc_out is not None else None
        else:
            self_bias = self.rel_bias(lq, lq)
            if self.is_decoder:
                self_bias = self_bias + _causal_bias(lq, dev)
            if attention_mask is not None:
                self_bias = self_bias + _extend_mask(attention_mask)
            cross_mask = _extend_mask(enc_mask) if enc_mask is not None else None
        x = _dropout(inputs_embeds, rate, generator)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            args = (x, self_bias, enc_out, cross_mask,
                    None if cross_kvs is None else cross_kvs[i], cross_kv_beams, generator)
            x = _remat(block, generator, *args) if remat else block(*args)
        return _dropout(self.final_norm(x), rate, generator)

    def precompute_cross_kv(self, enc_out) -> Tuple[KV, ...]:
        """Per-layer cross-attention K/V of a fixed encoder output (decoder
        stacks only), hoisted out of the generation step loop."""
        return tuple(block.cross_attn.project_kv(enc_out) for block in self.blocks)


def shift_right(labels: torch.Tensor, decoder_start: int, pad_id: int) -> torch.Tensor:
    """HF `_shift_right`: prepend decoder_start, drop last, -100 → pad."""
    start = torch.full((labels.shape[0], 1), decoder_start, dtype=labels.dtype,
                       device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, torch.full_like(shifted, pad_id), shifted)


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored targets (HF labels convention)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _reset_stack_parameters(root: nn.Module, generator: Optional[torch.Generator]):
    """Draw the weights of every T5 stack under ``root`` from the reference's
    initialisers (normal with the Flax stddevs; RMSNorm weights at 1)."""
    for m in root.modules():
        if isinstance(m, (RelativePositionBias, T5Attention, T5FeedForward)):
            m.reset_parameters(generator)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.weight)


class T5EncoderDecoder(nn.Module):
    def __init__(self, cfg: T5ArchConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.tie_word_embeddings:
            raise NotImplementedError("untied lm_head not needed at parity scale")
        self.cfg = cfg
        self.shared = Embed(cfg.vocab_size, cfg.d_model, compute_dtype(cfg))
        self.encoder = T5Stack(cfg, cfg.num_layers, is_decoder=False)
        self.decoder = T5Stack(cfg, cfg.num_decoder_layers, is_decoder=True)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Re-draw every weight from the reference's initialisers (normal
        with the Flax stddevs; RMSNorm weights at 1), from ``generator``."""
        _normal_(self.shared.weight, 1.0, generator)
        _reset_stack_parameters(self, generator)

    def encode(self, input_ids=None, attention_mask=None, inputs_embeds=None,
               generator: Optional[torch.Generator] = None):
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids)
        return self.encoder(inputs_embeds, attention_mask, generator=generator)

    def decode(self, decoder_input_ids, enc_out, enc_mask=None,
               generator: Optional[torch.Generator] = None):
        x = self.shared(decoder_input_ids)
        x = self.decoder(x, None, enc_out, enc_mask, generator=generator)
        return self.lm_logits(x)

    def precompute_cross_kv(self, enc_out) -> Tuple[KV, ...]:
        return self.decoder.precompute_cross_kv(enc_out)

    def decode_step(self, decoder_prefix_ids, cross_kvs, enc_mask=None, num_beams=None):
        """Next-token logits (B, V) for a (B, steps_so_far) decoder prefix.

        Runs the stack only over the live prefix and projects logits at the
        last position; the encoder enters through the precomputed
        ``cross_kvs``. With ``num_beams``, ``cross_kvs``/``enc_mask`` are
        per sample (batch B) and the prefix is (B·num_beams, s)."""
        x = self.shared(decoder_prefix_ids)
        x = self.decoder(x, None, None, enc_mask, cross_kvs=cross_kvs,
                         cross_kv_beams=num_beams)
        return self.lm_logits(x[:, -1, :])

    def lm_logits(self, hidden):
        hidden = hidden * (self.cfg.d_model ** -0.5)
        return torch.matmul(hidden.float(), self.shared.weight.float().t())

    def forward(self, input_ids=None, attention_mask=None, labels=None, inputs_embeds=None,
                generator: Optional[torch.Generator] = None):
        """(loss, logits) like `RQVAE-T5/model.py:42-60`; dropout in training
        mode, drawn from ``generator``."""
        c = self.cfg
        enc_out = self.encode(input_ids, attention_mask, inputs_embeds, generator)
        decoder_input_ids = shift_right(labels, c.decoder_start_token_id, c.pad_token_id)
        logits = self.decode(decoder_input_ids, enc_out, attention_mask, generator)
        return cross_entropy_with_ignore(logits, labels), logits


class T5Encoder(nn.Module):
    """Encoder-only stack (HF `T5EncoderModel`, used by DenseT5): the
    reference's ``T5Encoder`` on ``inputs_embeds``. It holds no ``shared``
    embedding: Flax creates one only when ``input_ids`` are given, and the
    one caller in the repo (DenseT5) always passes ``inputs_embeds``, so the
    reference's parameter tree has none. Its self-attention takes the
    structured-bias route (kernels #1 and #2), with the bidirectional
    relative-position bias and the (B, L) key mask."""

    def __init__(self, cfg: T5ArchConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Stack(cfg, cfg.num_layers, is_decoder=False)
        _reset_stack_parameters(self, generator)

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                generator: Optional[torch.Generator] = None):
        if input_ids is not None or inputs_embeds is None:
            raise NotImplementedError(
                "T5Encoder takes inputs_embeds only: no caller in the repo embeds input_ids "
                "through it, so it has no shared embedding")
        return self.encoder(inputs_embeds, attention_mask, generator=generator)

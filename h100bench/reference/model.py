"""Plain PyTorch reference of TIGER and TIGER-prefix, written from the
published description and the reference repository's equations.

It imports nothing of the measured program. Everything is a function of a
parameter dict (the names the benchmark gives its weights, see
:func:`param_spec`) and the inputs:

- T5 encoder-decoder (HF ``T5Config`` semantics): RMS layer norm, bucketed
  relative-position bias (bidirectional in the encoder), bias-free
  projections, unscaled attention with additive -1e9 masks, ReLU
  feed-forward, tied embeddings with d_model**-0.5 logit scaling;
- TIGER-prefix's three adapters (``RQVAE-T5-prefix/model.py:8-48``):
  cross-attention of the student's token embeddings over five projected
  BERT vectors (scaled dot product), post-norm LayerNorm (eps 1e-6),
  tanh-GELU feed-forward of width 4·d, mean over positions;
- training-mode dropout at Flax's places, drawn from a ``torch.Generator``
  in the order the forward meets it (:class:`Draws`), so that the same
  generator state gives the same masks as the measured program draws;
- token-mean cross-entropy, one Adam update (optax's formula);
- trie-constrained beam search with stable sorts, and the teacher-forced
  score of given token sequences.

``precision`` "f32" computes every product in float32; "tf32" rounds both
operands of every product (forward and backward) to TF32's 10-bit
significand first, which is what a float32 matrix product with TF32 allowed
computes on the card. The latter is the correctness check's control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e9       # additive attention mask
NEG_BEAM = -1e30  # a beam or token ruled out


# ----------------------------------------------------------------------------
# products at a stated precision
# ----------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 explicit significand bits, ties
    away from zero), kept in float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t()

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        gx = gr @ wr
        gw = gr.reshape(-1, gr.shape[-1]).t() @ xr.reshape(-1, xr.shape[-1])
        return gx, gw


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_tf32(g)
        return gr @ br.transpose(-1, -2), ar.transpose(-1, -2) @ gr


class Precision:
    """The product of two float32 operands, in float32 or at TF32."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision must be f32 or tf32, got {name!r}")
        self.name = name

    def linear(self, x, w, b=None):
        y = x @ w.t() if self.name == "f32" else _TF32Linear.apply(x, w)
        return y if b is None else y + b

    def matmul(self, a, b):
        return a @ b if self.name == "f32" else _TF32Matmul.apply(a, b)


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

def _t5_spec(a: dict, prefix: str) -> List[Tuple[str, tuple, tuple]]:
    d, h, dk, ff = a["d_model"], a["num_heads"], a["d_kv"], a["d_ff"]
    inner = h * dk
    out = [(f"{prefix}shared.weight", (a["vocab_size"], d), ("normal", 1.0))]

    def attn(p):
        return [(p + "q.weight", (inner, d), ("normal", (d * dk) ** -0.5)),
                (p + "k.weight", (inner, d), ("normal", d ** -0.5)),
                (p + "v.weight", (inner, d), ("normal", d ** -0.5)),
                (p + "o.weight", (d, inner), ("normal", inner ** -0.5))]

    for stack, n, dec in (("encoder", a["num_layers"], False),
                          ("decoder", a["num_decoder_layers"], True)):
        s = f"{prefix}{stack}."
        out.append((s + "rel_bias.rel_embedding", (a["relative_attention_num_buckets"], h),
                    ("normal", (d // h) ** -0.5)))
        for i in range(n):
            b = f"{s}blocks.{i}."
            out.append((b + "self_norm.weight", (d,), ("ones",)))
            out += attn(b + "self_attn.")
            if dec:
                out.append((b + "cross_norm.weight", (d,), ("ones",)))
                out += attn(b + "cross_attn.")
            out += [(b + "ff_norm.weight", (d,), ("ones",)),
                    (b + "ff.wi.weight", (ff, d), ("normal", d ** -0.5)),
                    (b + "ff.wo.weight", (d, ff), ("normal", ff ** -0.5))]
        out.append((s + "final_norm.weight", (d,), ("ones",)))
    return out


def _adapter_spec(cfg: dict, i: int) -> List[Tuple[str, tuple, tuple]]:
    d, bert = cfg["arch"]["d_model"], cfg["bert_dim"]
    p = f"adapter_lvl{i}."
    out = []
    for name, din, dout in (("bert_proj", bert, d), ("q_proj", d, d), ("k_proj", d, d),
                            ("v_proj", d, d), ("out_proj", d, d), ("ffn_in", d, 4 * d),
                            ("ffn_out", 4 * d, d)):
        out += [(p + name + ".weight", (dout, din), ("normal", din ** -0.5)),
                (p + name + ".bias", (dout,), ("zeros",))]
    for norm in ("norm1", "norm2"):
        out += [(p + norm + ".weight", (d,), ("ones",)), (p + norm + ".bias", (d,), ("zeros",))]
    return out


def param_spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, initialiser) of every parameter of ``cfg``'s model,
    in a fixed order. Initialisers: ("normal", std), ("ones",), ("zeros",),
    the scales of the T5 and Flax initialisers the model is published with."""
    if cfg["arch"].get("dtype", "float32") != "float32":
        raise ValueError("the reference computes a float32 configuration only")
    out = _t5_spec(cfg["arch"], "model.")
    if cfg["model"] == "tiger_prefix":
        for i in (1, 2, 3):
            out += _adapter_spec(cfg, i)
    elif cfg["model"] != "tiger":
        raise ValueError(f"unknown model {cfg['model']!r}")
    return out


# ----------------------------------------------------------------------------
# dropout draws
# ----------------------------------------------------------------------------

class Draws:
    """Training-mode dropout from one generator, in the forward's order."""

    def __init__(self, generator: torch.Generator, rate: float):
        self.g, self.rate = generator, rate

    def _keep(self, shape, device):
        return torch.rand(shape, generator=self.g, device=device) >= self.rate

    def drop(self, x):
        """Flax dropout: kept values divided by 1 - rate rounded to x's dtype."""
        keep_prob = float(torch.tensor(1.0 - self.rate, dtype=x.dtype))
        return torch.where(self._keep(x.shape, x.device), x / keep_prob, 0.0)

    def attn_mask(self, h: int, b: int, lq: int, lk: int, device):
        """Attention-weight mask in (B, H, Lq, Lk): drawn as (H·B, Lq, Lk),
        head slowest, with values 0 or 1/(1 - rate)."""
        keep = self._keep((h * b, lq, lk), device)
        m = torch.where(keep, 1.0 / (1.0 - self.rate), 0.0).to(torch.float32)
        return m.view(h, b, lq, lk).transpose(0, 1)

    def attn_probs(self, probs):
        """``nn.MultiheadAttention(dropout=)`` on probabilities (B, H, Lq, Lk)."""
        return torch.where(self._keep(probs.shape, probs.device),
                           probs / (1.0 - self.rate), 0.0)


def _maybe(draws: Optional[Draws], x):
    return x if draws is None else draws.drop(x)


# ----------------------------------------------------------------------------
# T5
# ----------------------------------------------------------------------------

def rel_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
               max_distance: int) -> torch.Tensor:
    """HF T5's bucket of (key position - query position), the log taken in
    float32 and truncated to int32."""
    rel = rel.to(torch.int32)
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(torch.int32) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    log_ratio = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32,
                                       device=rel.device))
    big = max_exact + (torch.log(torch.clamp(rel, min=1).to(torch.float32) / max_exact)
                       / log_ratio * (num_buckets - max_exact)).to(torch.int32)
    big = torch.clamp(big, max=num_buckets - 1)
    return ret + torch.where(rel < max_exact, rel, big)


def pos_bias(table, lq: int, lk: int, bidirectional: bool, a: dict):
    """(H, Lq, Lk) bias; the decoder's carries the causal -1e9 too."""
    dev = table.device
    rel = torch.arange(lk, device=dev)[None, :] - torch.arange(lq, device=dev)[:, None]
    b = table[rel_bucket(rel, bidirectional, a["relative_attention_num_buckets"],
                         a["relative_attention_max_distance"])].permute(2, 0, 1)
    if not bidirectional:
        b = b + torch.where(rel > 0, NEG, 0.0)[None]
    return b


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps))


def t5_attention(P: Precision, p: dict, pre: str, a: dict, x, kv, bias, kv_mask,
                 draws: Optional[Draws]):
    """x (B, Lq, d) over kv (B, Lk, d): unscaled scores + bias (H, Lq, Lk)
    + -1e9 where ``kv_mask`` (B, Lk) is 0; dropout on the probabilities."""
    b, lq, _ = x.shape
    lk = kv.shape[1]
    h, dk = a["num_heads"], a["d_kv"]

    def heads(t, n):
        return t.view(b, n, h, dk).transpose(1, 2)

    mask = draws.attn_mask(h, b, lq, lk, x.device) if draws is not None else None
    q = heads(P.linear(x, p[pre + "q.weight"]), lq)
    k = heads(P.linear(kv, p[pre + "k.weight"]), lk)
    v = heads(P.linear(kv, p[pre + "v.weight"]), lk)
    s = P.matmul(q, k.transpose(-1, -2))
    if bias is not None:
        s = s + bias[None]
    if kv_mask is not None:
        s = s + ((1.0 - kv_mask.to(s.dtype)) * NEG)[:, None, None, :]
    pr = torch.softmax(s, dim=-1)
    if mask is not None:
        pr = pr * mask
    o = P.matmul(pr, v).transpose(1, 2).reshape(b, lq, h * dk)
    return P.linear(o, p[pre + "o.weight"])


def t5_stack(P: Precision, p: dict, pre: str, a: dict, x, mask, enc=None, enc_mask=None,
             draws: Optional[Draws] = None):
    """One T5 stack over embeddings x (B, L, d); decoder when ``enc`` is given."""
    dec = enc is not None
    eps = a["layer_norm_epsilon"]
    n = a["num_decoder_layers"] if dec else a["num_layers"]
    lq = x.shape[1]
    bias = pos_bias(p[pre + "rel_bias.rel_embedding"], lq, lq, not dec, a)
    x = _maybe(draws, x)
    for i in range(n):
        b = f"{pre}blocks.{i}."
        hh = rms_norm(x, p[b + "self_norm.weight"], eps)
        x = x + _maybe(draws, t5_attention(P, p, b + "self_attn.", a, hh, hh, bias,
                                           None if dec else mask, draws))
        if dec:
            hh = rms_norm(x, p[b + "cross_norm.weight"], eps)
            x = x + _maybe(draws, t5_attention(P, p, b + "cross_attn.", a, hh, enc, None,
                                               enc_mask, draws))
        hh = rms_norm(x, p[b + "ff_norm.weight"], eps)
        hh = _maybe(draws, F.relu(P.linear(hh, p[b + "ff.wi.weight"])))
        x = x + _maybe(draws, P.linear(hh, p[b + "ff.wo.weight"]))
    return _maybe(draws, rms_norm(x, p[pre + "final_norm.weight"], eps))


def lm_logits(P: Precision, p: dict, a: dict, hidden):
    return P.linear(hidden * (a["d_model"] ** -0.5), p["model.shared.weight"])


# ----------------------------------------------------------------------------
# TIGER-prefix adapters
# ----------------------------------------------------------------------------

def adapter(P: Precision, p: dict, i: int, a: dict, student, bert, draws: Optional[Draws]):
    """One prefix token (B, 1, d) from the student's embeddings (B, L, d) and
    the level's BERT vectors (B, n, bert_dim)."""
    pre = f"adapter_lvl{i}."
    lin = lambda name, t: P.linear(t, p[pre + name + ".weight"], p[pre + name + ".bias"])  # noqa: E731
    d, h = a["d_model"], a["num_heads"]
    dh = d // h
    kv = lin("bert_proj", bert)
    b, lq, _ = student.shape
    lk = kv.shape[1]
    q = lin("q_proj", student).view(b, lq, h, dh).transpose(1, 2)
    k = lin("k_proj", kv).view(b, lk, h, dh).transpose(1, 2)
    v = lin("v_proj", kv).view(b, lk, h, dh).transpose(1, 2)
    pr = torch.softmax(P.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
    if draws is not None:
        pr = draws.attn_probs(pr)
    o = P.matmul(pr, v).transpose(1, 2).reshape(b, lq, d)
    x = F.layer_norm(student + lin("out_proj", o), (d,), p[pre + "norm1.weight"],
                     p[pre + "norm1.bias"], eps=1e-6)
    hh = lin("ffn_out", F.gelu(lin("ffn_in", x), approximate="tanh"))
    x = F.layer_norm(x + hh, (d,), p[pre + "norm2.weight"], p[pre + "norm2.bias"], eps=1e-6)
    return x.mean(dim=1, keepdim=True)


def encoder_inputs(P: Precision, cfg: dict, p: dict, batch: dict,
                   draws: Optional[Draws] = None):
    """(embeddings (B, L', d), mask (B, L')) that the encoder reads: the
    token embeddings, after TIGER-prefix's three prefix tokens."""
    a = cfg["arch"]
    ids = batch["input_ids"].long()
    mask = batch["attention_mask"]
    emb = p["model.shared.weight"][ids]
    if cfg["model"] != "tiger_prefix":
        return emb, mask
    pref = [adapter(P, p, i, a, emb, batch[f"prof_lvl{i}"], draws) for i in (1, 2, 3)]
    ones = torch.ones((ids.shape[0], 3), dtype=mask.dtype, device=mask.device)
    return torch.cat(pref + [emb], dim=1), torch.cat([ones, mask], dim=1)


def encode(P: Precision, cfg: dict, p: dict, batch: dict, draws: Optional[Draws] = None):
    emb, mask = encoder_inputs(P, cfg, p, batch, draws)
    return t5_stack(P, p, "model.encoder.", cfg["arch"], emb, mask, draws=draws), mask


def decode(P: Precision, cfg: dict, p: dict, dec_ids, enc, enc_mask,
           draws: Optional[Draws] = None):
    a = cfg["arch"]
    x = p["model.shared.weight"][dec_ids.long()]
    x = t5_stack(P, p, "model.decoder.", a, x, None, enc, enc_mask, draws)
    return lm_logits(P, p, a, x)


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

def loss(P: Precision, cfg: dict, p: dict, batch: dict, draws: Optional[Draws]):
    """Token-mean cross-entropy of a batch; padded rows (``valid`` false)
    and -100 labels take no part."""
    a = cfg["arch"]
    labels = torch.where(batch["valid"][:, None].bool(), batch["labels"].long(), -100)
    enc, enc_mask = encode(P, cfg, p, batch, draws)
    start = torch.full((labels.shape[0], 1), a["decoder_start_token_id"], dtype=labels.dtype,
                       device=labels.device)
    dec_in = torch.cat([start, labels[:, :-1]], dim=1)
    dec_in = torch.where(dec_in == -100, a["pad_token_id"], dec_in)
    logits = decode(P, cfg, p, dec_in, enc, enc_mask, draws)
    ok = labels != -100
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, torch.where(ok, labels, 0)[..., None])[..., 0]
    return torch.where(ok, nll, 0.0).sum() / ok.sum().clamp(min=1)


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], batches: List[dict],
                generator: torch.Generator, precision: str = "f32",
                batch_fn=None) -> dict:
    """Adam steps (optax's ``adam`` at the config's rate and betas, eps 1e-8)
    from ``params`` over ``batches``, dropout from ``generator``. Returns the
    losses, the first step's gradients and the parameters after the last.
    ``batch_fn(batch)`` may stand in for what the step is given (a planted
    fault)."""
    P = Precision(precision)
    tr = cfg["trainer"]
    lr, (b1, b2), eps = tr["lr"], tr["adam_betas"], 1e-8
    names = list(params)
    cur = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in cur.items()}
    s = {k: torch.zeros_like(v) for k, v in cur.items()}
    losses, first_grads = [], None
    rate = cfg["arch"]["dropout_rate"]
    for t, batch in enumerate(batches, start=1):
        leaves = {k: cur[k].requires_grad_(True) for k in names}
        draws = Draws(generator, rate) if rate > 0 else None
        fed = batch if batch_fn is None else batch_fn(batch)
        lo = loss(P, cfg, leaves, fed, draws)
        grads = torch.autograd.grad(lo, [leaves[k] for k in names])
        losses.append(float(lo.detach()))
        with torch.no_grad():
            if first_grads is None:
                first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** t)
                vh = s[k] / (1 - b2 ** t)
                cur[k] = cur[k].detach() - lr * mh / (vh.sqrt() + eps)
        del lo, grads, leaves
    return {"losses": losses, "grads": first_grads, "params": cur}


# ----------------------------------------------------------------------------
# recommendation
# ----------------------------------------------------------------------------

def trie_tables(codes, vocab: int, K: int, device):
    """(allowed (Σ_p K^p, V) bool, row offset of each step) of the item
    code trie: the rows of step p are the base-K prefixes of p digits; a
    token is allowed after a prefix when some item continues it so."""
    import numpy as np

    codes = np.asarray(codes, dtype=np.int64)
    dim = codes.shape[1]
    offsets = np.cumsum([0] + [K ** p for p in range(dim - 1)])
    allowed = np.zeros((int(offsets[-1] + K ** (dim - 1)), vocab), dtype=bool)
    prefix = np.zeros(len(codes), dtype=np.int64)
    for step in range(dim):
        allowed[offsets[step] + prefix, codes[:, step] + step * K + 1] = True
        prefix = prefix * K + codes[:, step]
    return torch.from_numpy(allowed).to(device), torch.as_tensor(offsets, device=device)


def _step_logp(P, cfg, p, enc, enc_mask, tokens, beams: int):
    """log-softmax of the next token after each beam's tokens (B·K, s)."""
    rep = lambda t: t.repeat_interleave(beams, dim=0)  # noqa: E731
    logits = decode(P, cfg, p, tokens, rep(enc), rep(enc_mask))
    return torch.log_softmax(logits[:, -1], dim=-1)


def _trie_walk(prefix, tok, step: int, K: int):
    return prefix * K + torch.clamp(tok - (step * K + 1), 0, K - 1)


@torch.no_grad()
def beam_search(cfg: dict, p: dict, batch: dict, num_beams: int, trie, precision: str = "f32"):
    """Trie-constrained beam search, (tokens (B, K, max_gen_len), scores
    (B, K)) best first: every candidate extension of every beam is scored
    by the beam's score plus the token's log-probability, ruled-out tokens
    at -1e30, and the best K kept by a stable sort (lower index first on
    ties); a beam that emitted eos extends with pad at no cost."""
    P = Precision(precision)
    a = cfg["arch"]
    allowed, offsets = trie
    enc, enc_mask = encode(P, cfg, p, batch)
    B, K, V, L = enc.shape[0], num_beams, a["vocab_size"], cfg["max_gen_len"]
    dev = enc.device
    tokens = torch.full((B, K, L), a["pad_token_id"], dtype=torch.long, device=dev)
    tokens[:, :, 0] = a["decoder_start_token_id"]
    scores = torch.full((B, K), NEG_BEAM, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    prefix = torch.zeros((B, K), dtype=torch.long, device=dev)
    frozen = torch.full((V,), NEG_BEAM, device=dev)
    frozen[a["pad_token_id"]] = 0.0
    Kc = cfg["codebook_size"]
    for step in range(L - 1):
        lp = _step_logp(P, cfg, p, enc, enc_mask, tokens[:, :, :step + 1].reshape(B * K, -1),
                        K).view(B, K, V)
        lp = torch.where(allowed[offsets[step] + prefix], lp, NEG_BEAM)
        lp = torch.where(done[:, :, None], frozen, lp)
        cand = (scores[:, :, None] + lp).view(B, K * V)
        top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        top, idx = top[:, :K], idx[:, :K]
        beam, tok = idx // V, idx % V
        tokens = torch.gather(tokens, 1, beam[:, :, None].expand(B, K, L)).clone()
        tokens[:, :, step + 1] = tok
        done = torch.gather(done, 1, beam) | (tok == a["eos_token_id"])
        prefix = _trie_walk(torch.gather(prefix, 1, beam), tok, step, Kc)
        scores = top
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(tokens, 1, order[:, :, None].expand(B, K, L)), scores


@torch.no_grad()
def sequence_scores(cfg: dict, p: dict, batch: dict, tokens, trie, precision: str = "f32"):
    """The score beam search gives each of ``tokens`` (B, K, max_gen_len):
    the sum over its code tokens of the teacher-forced log-probability,
    -1e30 for a token the trie rules out; after eos, pad costs nothing."""
    P = Precision(precision)
    a = cfg["arch"]
    allowed, offsets = trie
    enc, enc_mask = encode(P, cfg, p, batch)
    B, K, L = tokens.shape
    Kc = cfg["codebook_size"]
    rep = lambda t: t.repeat_interleave(K, dim=0)  # noqa: E731
    logits = decode(P, cfg, p, tokens[:, :, :L - 1].reshape(B * K, L - 1), rep(enc),
                    rep(enc_mask))
    lp = torch.log_softmax(logits, dim=-1).view(B, K, L - 1, -1)
    total = torch.zeros((B, K), device=tokens.device)
    prefix = torch.zeros((B, K), dtype=torch.long, device=tokens.device)
    done = torch.zeros((B, K), dtype=torch.bool, device=tokens.device)
    for step in range(L - 1):
        tok = tokens[:, :, step + 1]
        ok = torch.gather(allowed[offsets[step] + prefix], 2, tok[..., None])[..., 0]
        t_lp = torch.gather(lp[:, :, step], 2, tok[..., None])[..., 0]
        t_lp = torch.where(ok, t_lp, NEG_BEAM)
        pad_ok = tok == a["pad_token_id"]
        total = total + torch.where(done, torch.where(pad_ok, 0.0, NEG_BEAM), t_lp)
        done = done | (tok == a["eos_token_id"])
        prefix = _trie_walk(prefix, tok, step, Kc)
    return total

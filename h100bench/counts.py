"""The yardstick's arithmetic: the card's peaks, the least time of a T5
attention launch (kernels #1 and #2), and the model FLOPs of a step or a
batch of recommendations. Counted from shapes only.

Roofline bound of one entry of the fused T5 attention: the larger of
- the bytes of its arguments read once and its outputs written once, at
  the card's HBM rate, and
- its products at 495 TFLOP/s, the fastest any product of float32 inputs
  runs on the card (TF32 tensor cores).
So no implementation of the entry can read over 100% of it. The forward
(#1) reads q, k, v, the position bias, the key mask and the dropout mask
and writes out; its products are q·kᵀ and p·v. The backward entry (#2 and
its dbias reduction) reads those and the output gradient and writes dq,
dk, dv and dbias; its products are q·kᵀ again, dO·vᵀ, ds·k, dsᵀ·q and
pᵀ·dO.

Model FLOPs count 2 per multiply-add of the model's matrix products, over
real (non-padding) tokens only; attention counts the score and value
products over real keys, causal pairs once. A training step counts three
times its forward. A recommendation counts the encoder once per student
and each of the beams' code tokens as one decoder step with a key/value
cache: work the program recomputes is not counted.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
TF32_FLOPS = 495e12        # dense TF32 tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores
F32 = 4


def attention_bound_s(site: dict, backward: bool) -> float:
    """Least seconds of one launch of the fused T5 attention entry at
    ``site`` (hb, h, b, lq, lk, d and whether it takes a position bias, a
    key mask and a dropout mask)."""
    hb, h, b, lq, lk, d = (site[k] for k in ("hb", "h", "b", "lq", "lk", "d"))
    qkv = hb * (lq + 2 * lk) * d * F32
    extra = ((h * lq * lk * F32 if site["pos_bias"] else 0)
             + (b * lk * F32 if site["kv_mask"] else 0)
             + (hb * lq * lk * F32 if site["dropout"] else 0))
    if backward:
        nbytes = 2 * qkv + extra + hb * lq * d * F32 + (h * lq * lk * F32 if site["pos_bias"]
                                                         else 0)
        flops = 5 * 2 * hb * lq * lk * d
    else:
        nbytes = qkv + extra + hb * lq * d * F32
        flops = 2 * 2 * hb * lq * lk * d
    return max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS)


def attention_sites(cfg: dict, batch: int, enc_len: int, dec_len: int,
                    dropout: bool, decoder: bool = True) -> List[dict]:
    """The fused-attention launches of one forward of ``cfg``'s T5 at
    ``batch`` rows: encoder self-attention, and with ``decoder`` the
    decoder's self- and cross-attention (the causal mask folded into the
    decoder's position bias)."""
    a = cfg["arch"]
    h, d = a["num_heads"], a["d_kv"]
    base = dict(hb=h * batch, h=h, b=batch, d=d, dropout=dropout)
    out = [dict(base, lq=enc_len, lk=enc_len, pos_bias=True, kv_mask=True)
           for _ in range(a["num_layers"])]
    if decoder:
        for _ in range(a["num_decoder_layers"]):
            out.append(dict(base, lq=dec_len, lk=dec_len, pos_bias=True, kv_mask=False))
            out.append(dict(base, lq=dec_len, lk=enc_len, pos_bias=False, kv_mask=True))
    return out


def _prefix_tokens(cfg: dict) -> int:
    return 3 if cfg["model"] == "tiger_prefix" else 0


def _adapter_flops(cfg: dict, n_rows: int) -> float:
    """The three adapters run over every input position (their mean pools
    over all of them), so every position is real work."""
    if cfg["model"] != "tiger_prefix":
        return 0.0
    d, L = cfg["arch"]["d_model"], cfg["max_len"] * cfg["code_dim"]
    nv, bert = cfg["num_prof_vectors"], cfg["bert_dim"]
    one = (2 * nv * bert * d + 2 * nv * 2 * d * d + 2 * L * 2 * d * d + 2 * 2 * L * nv * d
           + 2 * L * 2 * d * 4 * d)
    return 3.0 * one * n_rows


def forward_flops(cfg: dict, enc_tokens: np.ndarray, dec_tokens: np.ndarray) -> float:
    """Forward FLOPs of rows with ``enc_tokens`` real history tokens and
    ``dec_tokens`` real target tokens each (arrays of one entry a row)."""
    a = cfg["arch"]
    d, inner, ff, V = a["d_model"], a["num_heads"] * a["d_kv"], a["d_ff"], a["vocab_size"]
    te = enc_tokens.astype(np.float64) + _prefix_tokens(cfg)
    td = dec_tokens.astype(np.float64)
    enc = a["num_layers"] * (2 * te * (4 * d * inner + 2 * d * ff) + 4 * te * te * inner)
    dec = a["num_decoder_layers"] * (
        2 * td * 4 * d * inner + 4 * inner * td * (td + 1) / 2
        + 2 * td * 2 * d * inner + 2 * te * 2 * d * inner + 4 * td * te * inner
        + 2 * td * 2 * d * ff)
    return float((enc + dec + 2 * td * d * V).sum()) + _adapter_flops(cfg, len(te))


def train_step_flops(cfg: dict, batch: Dict[str, np.ndarray]) -> float:
    """Model FLOPs of one training step on ``batch`` (numpy): three times the
    forward over its valid rows."""
    valid = np.asarray(batch["valid"], dtype=bool)
    enc = (np.asarray(batch["attention_mask"]) != 0).sum(axis=1)[valid]
    dec = (np.asarray(batch["labels"]) != -100).sum(axis=1)[valid]
    return 3.0 * forward_flops(cfg, enc, dec)


def recommend_flops(cfg: dict, enc_tokens: np.ndarray, num_beams: int) -> float:
    """Model FLOPs of recommending to students with ``enc_tokens`` real
    history tokens each: the encoder, the decoder's cross keys and values
    once a student, and num_beams × (max_gen_len - 1) cached decoder steps."""
    a = cfg["arch"]
    d, inner, ff, V = a["d_model"], a["num_heads"] * a["d_kv"], a["d_ff"], a["vocab_size"]
    te = enc_tokens.astype(np.float64) + _prefix_tokens(cfg)
    enc = a["num_layers"] * (2 * te * (4 * d * inner + 2 * d * ff) + 4 * te * te * inner)
    cross_kv = a["num_decoder_layers"] * 2 * te * 2 * d * inner
    steps = cfg["max_gen_len"] - 1
    dec = 0.0
    for j in range(steps):
        dec = dec + a["num_decoder_layers"] * (
            2 * 4 * d * inner + 4 * (j + 1) * inner + 2 * 2 * d * inner + 4 * te * inner
            + 2 * 2 * d * ff) + 2 * d * V
    return float((enc + cross_kv + num_beams * dec).sum()) + _adapter_flops(cfg, len(te))

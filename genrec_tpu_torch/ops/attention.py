"""Plain multi-head attention of the port.

Counterpart of ``genrec_tpu/ops/attention.py``'s ``_xla_attention`` path
only: (B, H, L, D) inputs, scale 1/√d, optional additive bias, causal
masking at −1e30 with the ``lk − lq`` offset, f32 softmax, probabilities
cast to v's dtype. The decoder self-attention of ``decode_step`` takes
this path. The blockwise flash kernel of the reference comes with the
SASRec slice.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def dot_product_attention(q, k, v, bias=None, *, causal: bool = False):
    """q,k,v: (B, H, L, D); bias: additive, broadcastable to (B, H, Lq, Lk)."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(d)
    if bias is not None:
        logits = logits + bias
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        row = torch.arange(lq, device=q.device)[:, None]
        col = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(col > row + (lk - lq), _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(v.dtype)

"""DenseT5: dense-retrieval T5 encoder over precomputed embedding sequences.

Counterpart of ``genrec_tpu/models/dense_t5.py`` (`T5/model.py:6-69`):
input_proj 768→d_model, the T5 encoder on ``inputs_embeds``, a masked
mean-pool, output_proj d_model→768, and the symmetric in-batch InfoNCE
(τ=0.07) against the target item embedding; ``generate`` returns the
L2-normalised query vector, and retrieval is cosine top-k against the
normalised item table (`T5/train.py:69-97`).

The encoder is the port's ``T5Encoder``: each self-attention runs through
kernels #1 and #2 (``ops/t5_attention.py``) with the bidirectional
relative-position bias and the (B, L + 1) key mask. Dropout (the stack's
places, the attention weights' through the kernels' f32 mask) runs in
training mode, its masks drawn from the ``generator`` given to ``forward``.
Parameter names follow the Flax tree (``encoder.encoder.*``,
``input_proj``, ``output_proj``), so ``convert.dense_t5_params_from_flax``
maps it leaf for leaf.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from genrec_tpu_torch.configs import DenseT5Config
from genrec_tpu_torch.models.layers import dense
from genrec_tpu_torch.models.t5 import T5Encoder

_EPS = 1e-8


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=_EPS)


class DenseT5(nn.Module):
    def __init__(self, cfg: DenseT5Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Encoder(cfg.arch, generator)
        self.input_proj = dense(cfg.input_emb_dim, cfg.arch.d_model, generator)
        self.output_proj = dense(cfg.arch.d_model, cfg.target_emb_dim, generator)

    def forward(self, seq_embs, attention_mask=None, target_emb=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(loss or None, the normalised prediction (B, target_emb_dim))."""
        hidden = self.encoder(attention_mask=attention_mask,
                              inputs_embeds=self.input_proj(seq_embs), generator=generator)
        if attention_mask is not None:
            m = attention_mask[..., None].to(torch.float32)
            pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
        else:
            pooled = hidden.mean(dim=1)
        pred = self.output_proj(pooled)
        loss = None
        if target_emb is not None:
            loss = contrastive_loss(pred, target_emb, self.cfg.temperature)
        return loss, _l2norm(pred)

    @torch.no_grad()
    def generate(self, seq_embs, attention_mask=None) -> torch.Tensor:
        """The normalised query vectors; call in ``.eval()``."""
        return self(seq_embs, attention_mask)[1]


def contrastive_loss(pred_emb, target_emb, temperature: float, valid=None) -> torch.Tensor:
    """Symmetric in-batch InfoNCE (`T5/model.py:33-44`). ``valid`` masks the
    padded rows of a fixed-shape batch out on both sides: −1e9 on their
    columns of the logits, and again on the columns of the transpose; the
    mean is over the valid rows."""
    logits = _l2norm(pred_emb) @ _l2norm(target_emb).T / temperature
    if valid is not None:
        v = valid.to(torch.bool)
        neg = (~v)[None, :].to(logits.dtype) * -1e9
        logits = logits + neg  # padded columns can never be positives/negatives
        li = -F.log_softmax(logits, dim=1).diagonal()
        lt = -F.log_softmax(logits.T + neg, dim=1).diagonal()
        w = v.to(logits.dtype)
        return ((li * w).sum() + (lt * w).sum()) / (2.0 * torch.clamp(w.sum(), min=1))
    loss_i2t = -F.log_softmax(logits, dim=1).diagonal().mean()
    loss_t2i = -F.log_softmax(logits.T, dim=1).diagonal().mean()
    return (loss_i2t + loss_t2i) / 2.0

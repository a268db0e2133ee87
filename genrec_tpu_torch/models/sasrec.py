"""SASRec, the self-attentive sequential ranker, in PyTorch: counterpart of
``genrec_tpu/models/sasrec.py`` with the same numerics.

- item embedding (padding row 0) + learned positional embedding;
- N pre-norm blocks: LayerNorm → causal multi-head self-attention →
  output projection → residual; LayerNorm → ReLU FFN (d → mlp → d) →
  residual; final LayerNorm (eps ``cfg.layernorm_eps``, 1e-8);
- ``predict`` scores every item as hₜ·Mᵀ (weight tying);
- no key-padding mask: padding positions attend causally, as in the
  reference (`check_data_alignment.py:204-212`).

Dropout (rate ``cfg.dropout``) is on in training mode at the Flax places:
the attention weights (``ops/attention.py``, which then takes its plain
path, as the reference routes it), the FFN after the ReLU and after the
second projection. Its masks come from the ``torch.Generator`` the caller
passes; training-mode dropout without one raises. Module names map to the
Flax tree through ``convert.sasrec_params_from_flax``.

Losses reproduce `SASRec/train.py:140-168` (full-vocab scores, BCE on the
positive and shared sampled negatives, padding-masked, normalised per valid
timestep) and `SASRec/train.py:59-81` (one-negative validation loss). Both
take the negatives as an argument, or draw them from the generator.

Tensor parallelism over the mesh's 'model' axis: when
``parallel.tensor.shard_model_`` has cut the item table's rows (its
I + 1 rows divide the axis), lookups go through the psum lookup
(``ops/embedding.sharded_embedding_lookup``) and the scores against the
table are this rank's vocabulary columns, gathered whole
(``parallel.tensor.gather_from_model``), so the losses run unchanged on the
full scores. A table whose rows do not divide stays whole.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from genrec_tpu_torch.configs import SASRecConfig
from genrec_tpu_torch.models.layers import PaddedEmbed, dense, dropout
from genrec_tpu_torch.ops.attention import multi_head_attention
from genrec_tpu_torch.ops.embedding import sharded_embedding_lookup
from genrec_tpu_torch.ops.negative_sampling import sample_negatives
from genrec_tpu_torch.parallel.tensor import copy_to_model, gather_from_model


def _drop_rate(module: nn.Module, rate: float, generator: Optional[torch.Generator]) -> float:
    """``rate`` in training mode, else 0; training-mode dropout needs a generator."""
    rate = rate if module.training else 0.0
    if rate > 0.0 and generator is None:
        raise ValueError("training-mode dropout draws its masks from a torch.Generator: "
                         "pass generator=..., or call .eval()")
    return rate


class SASRecBlock(nn.Module):
    """Pre-norm block. ``attn_fn`` (q, k, v, *, num_heads, causal,
    dropout_rate, generator) → out overrides the attention, as the reference's
    ``attn_fn`` field does. Flax names: LayerNorm_0/1 → attn_norm/ff_norm,
    Dense_0..5 → q, k, v, out, ff_in, ff_out."""

    def __init__(self, d: int, num_heads: int, mlp_layer: int, dropout_rate: float,
                 layernorm_eps: float, attn_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.attn_fn = attn_fn or multi_head_attention
        self.attn_norm = nn.LayerNorm(d, eps=layernorm_eps)
        self.q = dense(d, d, generator)
        self.k = dense(d, d, generator)
        self.v = dense(d, d, generator)
        self.out = dense(d, d, generator)
        self.ff_norm = nn.LayerNorm(d, eps=layernorm_eps)
        self.ff_in = dense(d, mlp_layer, generator)
        self.ff_out = dense(mlp_layer, d, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        rate = _drop_rate(self, self.dropout_rate, generator)
        h = self.attn_norm(x)
        attn = self.attn_fn(self.q(h), self.k(h), self.v(h), num_heads=self.num_heads,
                            causal=True, dropout_rate=rate,
                            generator=generator if rate > 0.0 else None)
        x = x + self.out(attn)
        h = dropout(F.relu(self.ff_in(self.ff_norm(x))), rate, generator)
        return x + dropout(self.ff_out(h), rate, generator)


class SASRec(nn.Module):
    def __init__(self, item_num: int, cfg: SASRecConfig,
                 generator: Optional[torch.Generator] = None):
        """Weights drawn from ``generator`` with the Flax initialisers."""
        super().__init__()
        self.item_num = item_num
        self.cfg = cfg
        std = cfg.emb_init_stddev if cfg.emb_init_stddev is not None else 1.0 / math.sqrt(cfg.d)
        self.item_emb = PaddedEmbed(item_num + 1, cfg.d, init_stddev=cfg.emb_init_stddev,
                                    generator=generator)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.d)
        with torch.no_grad():
            nn.init.normal_(self.pos_emb.weight, 0.0, std, generator=generator)
        self.blocks = nn.ModuleList(
            SASRecBlock(cfg.d, cfg.num_heads, cfg.mlp_layer, cfg.dropout, cfg.layernorm_eps,
                        generator=generator)
            for _ in range(cfg.num_blocks))
        self.last_norm = nn.LayerNorm(cfg.d, eps=cfg.layernorm_eps)
        self.tp_mesh = None  # set by parallel.tensor.shard_model_

    def _table_mesh(self):
        """The mesh when the item table's rows were cut over 'model', else None."""
        return self.tp_mesh if self.item_emb.weight.shape[0] < self.item_num + 1 else None

    def table_rows(self, ids):
        """Rows ``ids`` of the item table, row 0 included."""
        mesh = self._table_mesh()
        if mesh is None:
            return self.item_emb.weight[ids]
        return sharded_embedding_lookup(self.item_emb.weight, ids, mesh)

    def _scores(self, h):
        """h against every item embedding: (…, I+1)."""
        mesh = self._table_mesh()
        if mesh is None:
            return h @ self.item_emb.weight.T
        return gather_from_model(copy_to_model(h, mesh) @ self.item_emb.weight.T, mesh, -1)

    def forward(self, log_seqs, generator: Optional[torch.Generator] = None):
        """(B, n) item ids → (B, n, d) sequence features."""
        if self._table_mesh() is None:
            emb = self.item_emb(log_seqs)
        else:  # PaddedEmbed's zero row 0, on the psum lookup
            emb = self.table_rows(log_seqs)
            emb = emb * (log_seqs != 0)[..., None].to(emb.dtype)
        return self.encode(emb, generator)

    def encode(self, emb, generator: Optional[torch.Generator] = None):
        """(B, n, d) gathered item embeddings → (B, n, d) sequence features."""
        x = emb + self.pos_emb.weight[:emb.shape[1]][None]
        for blk in self.blocks:
            x = blk(x, generator)
        return self.last_norm(x)

    def predict(self, log_seqs, generator: Optional[torch.Generator] = None):
        """Last-step features against all item embeddings: (B, I+1) logits."""
        return self._scores(self(log_seqs, generator)[:, -1, :])

    def score_all(self, log_seqs, generator: Optional[torch.Generator] = None):
        """All-timestep full-vocab scores (B, n, I+1) (`SASRec/train.py:131-137`)."""
        return self._scores(self(log_seqs, generator))


def _bce(scores, positive: bool, eps: float):
    """The reference BCE term −log(σ(s) + eps) / −log(1 − σ(s) + eps) in logit
    space: softplus(∓s) capped at −log(eps) (f32 eps, as the reference)."""
    x = -scores if positive else scores
    cap = -torch.log(torch.tensor(eps, dtype=torch.float32, device=scores.device))
    return torch.minimum(F.softplus(x), cap.to(scores.dtype))


def train_loss(model: SASRec, inputs, targets, generator: Optional[torch.Generator],
               cfg: SASRecConfig, item_num: int, batch_valid=None,
               neg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence teacher-forcing BCE (`SASRec/train.py:140-168`); returns
    (normalised loss, valid-timestep count). ``neg`` (B, num_neg) defaults to
    ``sample_negatives`` against ``inputs`` from ``generator``; dropout
    follows the model's mode."""
    if neg is None:
        neg = sample_negatives(generator, inputs, item_num, cfg.num_neg_samples)
    scores = model.score_all(inputs, generator)
    mask = (targets != 0).float()
    if batch_valid is not None:
        mask = mask * batch_valid[:, None].float()
    pos_scores = torch.gather(scores, 2, targets[..., None].long())[..., 0]
    neg_idx = neg[:, None, :].expand(-1, scores.shape[1], -1).long()
    neg_scores = torch.gather(scores, 2, neg_idx)
    pos_loss = _bce(pos_scores, True, cfg.loss_eps) * mask
    neg_loss = _bce(neg_scores, False, cfg.loss_eps).sum(dim=-1) * mask
    valid = mask.sum()
    return (pos_loss + neg_loss).sum() / torch.clamp(valid, min=1.0), valid


def eval_loss(model: SASRec, inputs, targets, generator: Optional[torch.Generator],
              cfg: SASRecConfig, item_num: int, batch_valid=None,
              neg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validation loss: last-position BCE with one sampled negative
    (`SASRec/train.py:59-81`); returns (sum loss, valid count). ``neg`` (B,)
    defaults to one ``sample_negatives`` draw per row from ``generator``."""
    if neg is None:
        neg = sample_negatives(generator, inputs, item_num, 1)[:, 0]
    h = model(inputs, generator)[:, -1, :]
    pos_score = (h * model.table_rows(targets.long())).sum(dim=-1)
    neg_score = (h * model.table_rows(neg.long())).sum(dim=-1)
    per = _bce(pos_score, True, cfg.loss_eps) + _bce(neg_score, False, cfg.loss_eps)
    valid_mask = targets != 0
    if batch_valid is not None:
        valid_mask = valid_mask & batch_valid
    valid_mask = valid_mask.float()
    return (per * valid_mask).sum(), valid_mask.sum()

"""SASRec at catalog scale on one device: counterpart of
``genrec_tpu/models/sasrec_large.py``'s ``SASRecLarge`` with
``use_sharded=False`` and no ``ctx_axis``.

It departs from the parity SASRec (``models/sasrec.py``) as the reference
does: the item table is one (V+1, D) parameter ``item_table`` read by a
pad-masked row gather, and training scores only the positive row and
``num_neg_samples`` sampled negative rows per position (sampled BCE), so the
(B, n, V) score matrix never exists. The tower (positional embedding,
pre-norm causal blocks, final LayerNorm) is :class:`SASRecBlock` unchanged;
at the long-context configuration (``configs.long_context_sasrec_config``,
L ≥ 512) its attention runs through the flash kernels whenever no attention
dropout is drawn (``ops/attention.dot_product_attention``).

Still to port (ROADMAP Queue 1 item 4): the row-sharded table with its
psum and all_to_all lookups, ``sharded_topk_scores``, ring attention over a
context-parallel axis, and the bf16 table.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from genrec_tpu_torch.configs import SASRecLargeConfig
from genrec_tpu_torch.models.sasrec import SASRecBlock, _bce
from genrec_tpu_torch.ops.negative_sampling import sample_negatives

_ITEM_4 = "ROADMAP Queue 1 item 4 (the distributed layer)"


class SASRecLarge(nn.Module):
    """SASRec tower over a (V+1, D) item table on one device. The reference's
    sharded table (``use_sharded=True``) and context-parallel ring
    (``ctx_axis``) are not ported: asking for either raises."""

    def __init__(self, item_num: int, cfg: SASRecLargeConfig, *, use_sharded: bool = True,
                 ctx_axis: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_sharded:
            raise NotImplementedError(f"the row-sharded item table is {_ITEM_4}; "
                                      "pass use_sharded=False")
        if ctx_axis is not None:
            raise NotImplementedError(f"ring attention over a context axis is {_ITEM_4}")
        if cfg.embedding.dtype != "float32":
            raise NotImplementedError(f"the {cfg.embedding.dtype} item table is {_ITEM_4}")
        self.item_num = item_num
        self.cfg = cfg
        dim = cfg.embedding.dim
        self.item_table = nn.Parameter(torch.empty(item_num + 1, dim))
        self.pos_emb = nn.Embedding(cfg.max_len, dim)
        with torch.no_grad():
            nn.init.normal_(self.item_table, 0.0, 1.0 / math.sqrt(dim), generator=generator)
            nn.init.normal_(self.pos_emb.weight, 0.0, 1.0 / math.sqrt(dim), generator=generator)
        self.blocks = nn.ModuleList(
            SASRecBlock(dim, cfg.num_heads, cfg.mlp_layer, cfg.dropout, cfg.layernorm_eps,
                        generator=generator)
            for _ in range(cfg.num_blocks))
        self.last_norm = nn.LayerNorm(dim, eps=cfg.layernorm_eps)

    def embed(self, ids):
        """Pad-masked row gather (torch ``padding_idx=0`` semantics): row 0
        reads zero and gets zero gradient through the mask product. The
        gather is ``F.embedding``: the backward of advanced indexing took most
        of a long-context train step's device time on the H100 (PERF.md)."""
        e = F.embedding(ids, self.item_table)
        return e * (ids != 0)[..., None].to(e.dtype)

    def forward(self, log_seqs, generator: Optional[torch.Generator] = None):
        x = self.embed(log_seqs) + self.pos_emb.weight[:log_seqs.shape[1]][None]
        for blk in self.blocks:
            x = blk(x, generator)
        return self.last_norm(x)

    def sampled_scores(self, inputs, targets, neg_ids,
                       generator: Optional[torch.Generator] = None):
        """(pos_scores (B, n), neg_scores (B, n, K)): only 1 + K rows of the
        table are read per position, never the (B, n, V) matrix."""
        feats = self(inputs, generator)
        pos_scores = (feats * self.embed(targets)).sum(dim=-1)
        neg_scores = torch.einsum("bnd,bkd->bnk", feats, self.embed(neg_ids))
        return pos_scores, neg_scores

    def predict_topk(self, log_seqs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k (values, item ids) of the last position over the whole
        table, row 0 included, as the reference's unsharded branch."""
        h_t = self(log_seqs)[:, -1, :]
        return torch.topk(h_t @ self.item_table.T, k, dim=-1)


def train_loss_sampled(model: SASRecLarge, inputs, targets,
                       generator: Optional[torch.Generator], cfg: SASRecLargeConfig,
                       item_num: int, neg=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampled-BCE training loss, with the parity loss's masking and
    normalisation (`SASRec/train.py:140-168`); returns (normalised loss,
    valid-timestep count). ``neg`` (B, K) defaults to ``sample_negatives``
    from ``generator`` against the full rated set, history AND shifted
    targets (the reference's setdiff1d-vs-rated, `SASRec/train.py:15-30`)."""
    if neg is None:
        rated = torch.cat([inputs, targets], dim=1)
        neg = sample_negatives(generator, rated, item_num, cfg.num_neg_samples)
    pos_scores, neg_scores = model.sampled_scores(inputs, targets, neg, generator)
    mask = (targets != 0).float()
    pos_loss = _bce(pos_scores, True, cfg.loss_eps) * mask
    neg_loss = _bce(neg_scores, False, cfg.loss_eps).sum(dim=-1) * mask
    valid = mask.sum()
    return (pos_loss + neg_loss).sum() / torch.clamp(valid, min=1.0), valid


def make_train_step(model: SASRecLarge, optimizer: torch.optim.Optimizer,
                    cfg: SASRecLargeConfig, item_num: int):
    """``step(inputs, targets, generator, neg=None) -> loss``: one forward in
    training mode, backward and ``optimizer`` update of ``model`` in place.
    The reference steps ``optax.adam(lr)``; ``torch.optim.Adam(lr=lr,
    betas=(0.9, 0.999), eps=1e-8)`` computes the same update."""

    def step(inputs, targets, generator: Optional[torch.Generator], neg=None):
        model.train()
        loss, _ = train_loss_sampled(model, inputs, targets, generator, cfg, item_num, neg)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step

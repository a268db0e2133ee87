"""Metric primitives with the reference's exact semantics: counterpart of
``genrec_tpu/ops/metrics_ops.py``.

- :func:`strict_ranks` (tensors): rank = #(scores strictly greater than the
  target) + 1 (`SASRec/evaluate.py:32`), the padding item masked to -1e9.
- :func:`pos_index_exact_match` (tensors): the beam-eval hit matrix,
  first-match-only (`RQVAE-T5/utils.py:24-32`).
- The numpy aggregators (Hit/NDCG/Recall), copied.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def strict_ranks(logits: torch.Tensor, targets: torch.Tensor,
                 mask_padding_item: bool = True) -> torch.Tensor:
    """(B, I+1) scores + (B,) target ids → (B,) 1-based strict ranks."""
    if mask_padding_item:
        logits = logits.clone()
        logits[:, 0] = -1e9
    target_scores = torch.gather(logits, 1, targets[:, None].long())
    return (logits > target_scores).sum(dim=1) + 1


def pos_index_exact_match(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, maxk, L) beam predictions vs (B, L) labels → (B, maxk) bool,
    True at the first beam whose tokens all equal the label sequence."""
    eq = (preds == labels[:, None, :]).all(dim=-1)      # (B, maxk)
    # first True: cumsum counts the hits so far, so the first hit is where it is 1
    return eq & (torch.cumsum(eq.int(), dim=1) == 1)


def hit_ndcg_from_ranks(ranks: np.ndarray, topk_list: Sequence[int],
                        valid: np.ndarray = None) -> Dict[str, float]:
    """Aggregate Hit@k / NDCG@k from ranks (NDCG = 1/log2(rank+1) when hit,
    `SASRec/evaluate.py:33-42`)."""
    ranks = np.asarray(ranks, dtype=np.float64)
    if valid is not None:
        ranks = ranks[np.asarray(valid, dtype=bool)]
    out = {}
    for k in topk_list:
        hit = ranks <= k
        out[f"Hit@{k}"] = float(hit.mean()) if len(ranks) else 0.0
        out[f"NDCG@{k}"] = float(np.where(hit, 1.0 / np.log2(ranks + 1), 0.0).mean()) \
            if len(ranks) else 0.0
    return out


def recall_at_k(pos_index: np.ndarray, k: int) -> np.ndarray:
    """Per-sample recall (one relevant item): hit within top-k beams
    (`RQVAE-T5/utils.py:34-35`)."""
    return np.asarray(pos_index)[:, :k].sum(axis=1).astype(np.float64)


def ndcg_at_k(pos_index: np.ndarray, k: int) -> np.ndarray:
    """Per-sample NDCG with dcg = 1/log2(rank+1) (`RQVAE-T5/utils.py:37-42`)."""
    pos_index = np.asarray(pos_index)
    ranks = np.arange(1, pos_index.shape[-1] + 1, dtype=np.float64)
    dcg = np.where(pos_index, 1.0 / np.log2(ranks + 1), 0.0)
    return dcg[:, :k].sum(axis=1)


def beam_metrics(pos_index: np.ndarray, topk_list: Sequence[int],
                 valid: np.ndarray = None) -> Dict[str, float]:
    pos_index = np.asarray(pos_index)
    if valid is not None:
        pos_index = pos_index[np.asarray(valid, dtype=bool)]
    out = {}
    for k in topk_list:
        out[f"Recall@{k}"] = float(recall_at_k(pos_index, k).mean()) if len(pos_index) else 0.0
        out[f"NDCG@{k}"] = float(ndcg_at_k(pos_index, k).mean()) if len(pos_index) else 0.0
    return out

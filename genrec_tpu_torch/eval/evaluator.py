"""Evaluation loops with the reference's exact metric semantics:
counterpart of ``genrec_tpu/eval/evaluator.py``.

- :func:`rank_evaluate`: full-vocab scores → strict rank → Hit/NDCG@k
  (`SASRec/evaluate.py:10-54`): padding item masked to -1e9, rank =
  #(strictly greater) + 1, NDCG = 1/log2(rank+1) if rank ≤ k.
- :func:`beam_evaluate` (`RQVAE-T5/utils.py:44-91`): beams =
  max(topk_list ∪ {beam_size}), start token stripped, predictions
  padded/trimmed to the label width, first-match-only position index.

Both ignore padded rows through ``valid``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from genrec_tpu_torch.ops.metrics_ops import (beam_metrics, hit_ndcg_from_ranks,
                                              pos_index_exact_match, strict_ranks)


def rank_evaluate(predict_fn: Callable[[Dict], torch.Tensor],
                  batches: Iterator[Dict[str, np.ndarray]],
                  topk_list: Sequence[int]) -> Dict[str, float]:
    """``predict_fn(batch) -> (B, I+1)`` logits tensor; batch carries
    ``targets`` (B,) and ``valid`` (B,). Targets of 0 are skipped (empty test
    rows, `SASRec/train.py:42-44`)."""
    ranks_all, valid_all = [], []
    for batch in batches:
        logits = predict_fn(batch)
        targets = torch.as_tensor(np.asarray(batch["targets"]), device=logits.device)
        ranks_all.append(strict_ranks(logits, targets).cpu().numpy())
        valid_all.append(np.asarray(batch["valid"]) & (np.asarray(batch["targets"]) != 0))
    ranks = np.concatenate(ranks_all) if ranks_all else np.zeros(0)
    valid = np.concatenate(valid_all) if valid_all else np.zeros(0, bool)
    return hit_ndcg_from_ranks(ranks, topk_list, valid)


def beam_evaluate(generate_fn: Callable[[Dict, int], torch.Tensor],
                  batches: Iterator[Dict[str, np.ndarray]],
                  topk_list: Sequence[int], beam_size: int,
                  *, strip_start: bool = True,
                  batch_mean: bool = True) -> Dict[str, float]:
    """``generate_fn(batch, num_beams) -> (B, beams, L)`` token tensor
    (including the decoder-start token); batch carries ``labels`` (B, L')
    and ``valid``.

    ``batch_mean`` reproduces the reference's mean-of-batch-means
    aggregation (`RQVAE-T5/utils.py:83-90`); with equal batch sizes it
    equals the global mean.
    """
    actual_beams = max(max(topk_list), beam_size)
    per_batch: list = []
    pos_all, valid_all = [], []
    for batch in batches:
        preds = torch.as_tensor(generate_fn(batch, actual_beams)).cpu()  # (B, beams, L)
        labels = torch.as_tensor(np.asarray(batch["labels"]))
        if strip_start:
            preds = preds[:, :, 1:]
        lp, ll = preds.shape[-1], labels.shape[-1]
        if lp < ll:
            preds = torch.nn.functional.pad(preds, (0, ll - lp))
        else:
            preds = preds[:, :, :ll]
        pos = pos_index_exact_match(preds.long(), labels.long()).numpy()
        valid = np.asarray(batch["valid"])
        pos_all.append(pos)
        valid_all.append(valid)
        if valid.any():
            per_batch.append(beam_metrics(pos, topk_list, valid))
    if batch_mean and per_batch:
        keys = per_batch[0].keys()
        return {k: float(np.mean([m[k] for m in per_batch])) for k in keys}
    pos = np.concatenate(pos_all) if pos_all else np.zeros((0, actual_beams), bool)
    valid = np.concatenate(valid_all) if valid_all else np.zeros(0, bool)
    return beam_metrics(pos, topk_list, valid)

"""Beam evaluation with the reference's exact metric semantics: counterpart
of ``genrec_tpu/eval/evaluator.py``'s ``beam_evaluate``
(`RQVAE-T5/utils.py:44-91`): beams = max(topk_list ∪ {beam_size}), start
token stripped, predictions padded/trimmed to the label width,
first-match-only position index, padded rows ignored through ``valid``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from genrec_tpu_torch.ops.metrics_ops import beam_metrics, pos_index_exact_match


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

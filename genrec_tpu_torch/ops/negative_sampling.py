"""On-device negative sampling: counterpart of
``genrec_tpu/ops/negative_sampling.py``.

Uniform candidates in [1, item_num]; a candidate that collides with the
user's history (or with an earlier draw of its row) is replaced by the next
round's draw, for a fixed number of rounds. The draws and the rejection are
two steps, :func:`draw_candidates` (``rounds`` uniform draws from a
``torch.Generator``) and :func:`reject_collisions` (pure), so that a test can
feed the reference's own draws to the rejection step.
"""

from __future__ import annotations

from typing import Optional

import torch


def _collides(cand: torch.Tensor, seq: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """cand (B, N); seq (B, L) history; prev (B, N) earlier draws. True where
    cand appears in seq, or equals an earlier column of prev."""
    hit_seq = (cand[:, :, None] == seq[:, None, :]).any(dim=-1)
    n = cand.shape[1]
    earlier = torch.arange(n, device=cand.device)[None, :] < torch.arange(
        n, device=cand.device)[:, None]                      # (N, N): column j < row i
    hit_prev = ((cand[:, :, None] == prev[:, None, :]) & earlier).any(dim=-1)
    return hit_seq | hit_prev


def draw_candidates(generator: Optional[torch.Generator], batch: int, item_num: int,
                    num_neg: int, *, rounds: int = 4, device=None) -> torch.Tensor:
    """(rounds, batch, num_neg) uniform int64 draws in [1, item_num]."""
    return torch.randint(1, item_num + 1, (rounds, batch, num_neg), generator=generator,
                         device=device)


def reject_collisions(draws: torch.Tensor, seq: torch.Tensor, *,
                      unique: bool = True) -> torch.Tensor:
    """The reference's fixed-round redraw on given draws: start from round 0
    and, for each later round, replace every candidate that collides with
    ``seq`` (or, when ``unique``, an earlier candidate of its row) by that
    round's draw."""
    seq = seq.to(draws.dtype)
    cand = draws[0]
    for r in range(1, draws.shape[0]):
        prev = cand if unique else torch.zeros_like(cand)
        cand = torch.where(_collides(cand, seq, prev), draws[r], cand)
    return cand


def sample_negatives(generator: Optional[torch.Generator], seq: torch.Tensor, item_num: int,
                     num_neg: int, *, rounds: int = 4, unique: bool = True) -> torch.Tensor:
    """(B, num_neg) item ids in [1, item_num] avoiding the ids of ``seq``
    (B, L), 0 = padding, up to the residual collision probability
    (L/I)^rounds; drawn from ``generator`` on ``seq``'s device."""
    draws = draw_candidates(generator, seq.shape[0], item_num, num_neg, rounds=rounds,
                            device=seq.device)
    return reject_collisions(draws, seq, unique=unique)

"""The comparisons that decide ``correct`` in the decoder-only MoE
recommender's cells (DeepSeek-V2), against the plain reference
(``reference/deepseek_v2.py``, float32 with the bf16 weights taken to f32
layer by layer):

- ``score_gap``: |program score − reference score| of the returned
  sequences, the reference scoring the program's tokens by teacher forcing
  under the trie; the 90th percentile over the judged sequences both score
  as real items (a sequence the trie rules out scores -1e30 or less:
  where the program and the reference disagree on that, the gap is that of
  the scores, 1e29 or more, and is taken whole);
- ``score_gap_p75``: the 75th percentile of the same gaps;
- ``best_gap``: |program's best score − the best score of the reference's
  own beam search|, the median over the judged students.

Unlike TIGER's check (``check.py``), which takes the largest gaps, these
are quantiles. The program computes in bf16 and the reference in f32: a
routing flip at a near-tie of the top-k moves a sequence's score by far
more than rounding does, and which sequences flip changes from seed to
seed, so the largest score gap is unsteady; its 90th percentile is steady,
and a fault that moves a tenth of the sequences or more (a fault at the
padding moves those of the padded prompts, about two fifths) moves it. A
beam search that rounding steers off the reference's path ends on another
best, up to 0.9 away on one student in sixteen, so the best gap is taken at
the median (``PERF.md`` §2 gives the readings). The two score quantiles
hold the program to two kinds of fault: the 90th percentile to one that
moves a minority of the sequences far (the padded prompts'), the 75th to
one that moves every sequence a little, such as a residual stream, norms
or softmaxes computed in bf16 where the configuration states f32 (a
reference computed wholly in bf16 reads about 1.4x the program there).
"""

from __future__ import annotations

from typing import Dict

import torch

RULED_OUT = -1e29


def quantiles(gaps: torch.Tensor) -> Dict[str, float]:
    """Median, 75th, 90th percentile, mean and largest of ``gaps``."""
    g = gaps.double().flatten()
    q = torch.quantile(g, torch.tensor([0.5, 0.75, 0.9], dtype=torch.float64, device=g.device))
    return {"median": float(q[0]), "p75": float(q[1]), "p90": float(q[2]),
            "mean": float(g.mean()), "max": float(g.max())}


def recommendation(prog_scores, ref_scores_of_prog, ref_scores) -> Dict[str, float]:
    """score_gap, score_gap_p75 and best_gap over the judged students ((S, K) scores, best
    first: the program's, the reference's of the program's sequences, and
    the reference's beam search's), and under "_notes" the gaps' quantiles."""
    p, r = prog_scores.double(), ref_scores_of_prog.double()
    gap = (p - r).abs()
    real = (p > RULED_OUT) & (r > RULED_OUT)
    class_differs = (p > RULED_OUT) != (r > RULED_OUT)
    best = (p[:, 0] - ref_scores[:, 0].double()).abs()
    sq = quantiles(gap[real]) if real.any() else None
    bq = quantiles(best)
    if class_differs.any():
        score_gap = score_p75 = float(gap[class_differs].max())
    else:
        score_gap = sq["p90"] if sq else float("inf")
        score_p75 = sq["p75"] if sq else float("inf")
    return {"score_gap": score_gap, "score_gap_p75": score_p75, "best_gap": bq["median"],
            "_notes": f"score gaps {sq} over {int(real.sum())} of {real.numel()} sequences "
                      f"(real items); best gaps {bq}"}

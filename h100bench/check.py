"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference (``reference/model.py``), each as one number
held to its limit in ``limits/<cell>.json``.

Training (the first steps of the very trainer the window drives):
- ``batch_mismatch``: elements of the batches the program's steps received,
  after its upload, that differ from the reference's own gather (exact);
- ``loss_gap``: |program − reference| / |reference| of the first step's
  loss;
- ``grad_gap``: of the median leaf, the gap between the norms of the first
  gradient as the program's optimizer got it (its Adam first moment after
  one step, over 1 − β1) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same gap for the parameters' change over the steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by rounding alone and take no part in the two norm gaps.
The later steps' losses and the worst leaf's gaps are not compared, and
are printed with the run's notes: Adam turns a rounding-sized difference
in a gradient element near its eps into a step-sized one, and the small
adapter leaves' gradients swing with the ReLU decisions that rounding
flips, so they move from seed to seed (``PERF.md`` §2 has the readings).

Recommendation (a sample of the students served in the window):
- ``score_gap``: the largest |program score − reference score| of a
  returned sequence, the reference scoring the program's tokens by
  teacher forcing under the trie (a sequence the trie rules out scores
  -1e30);
- ``best_gap``: the largest |program's best score − the best score of the
  reference's own beam search| over the students, which a list that is
  not the beam search's best fails.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              ref_grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """|‖prog‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖) of each leaf that moves
    (see the module's docstring)."""
    gnorm = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    med_g = float(torch.tensor(sorted(gnorm.values())).median())
    keep = [k for k in ref if gnorm[k] >= 1e-3 * med_g]
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(torch.tensor([rn[k] for k in keep]).median())
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med) for k in keep}


def _median(gaps: Dict[str, float]) -> float:
    return float(torch.tensor(list(gaps.values()), dtype=torch.float64).median())


def batch_mismatch(received: List[Dict[str, torch.Tensor]],
                   expected: List[Dict[str, torch.Tensor]]) -> int:
    bad = 0
    for got, want in zip(received, expected):
        if set(got) != set(want):
            return -1
        for k, w in want.items():
            g = got[k].to(w.device)
            if g.shape != w.shape:
                bad += w.numel()
            else:
                bad += int((g.to(w.dtype) != w).sum())
    return bad if len(received) == len(expected) else -1


def training(prog: dict, ref: dict, received, expected) -> Dict[str, float]:
    """The four training numbers, and under "_notes" what is not compared."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = leaf_gaps(prog["grads"], ref["grads"], ref["grads"])
    d_prog = {k: prog["params"][k] - prog["start"][k] for k in ref["params"]}
    d_ref = {k: ref["params"][k] - prog["start"][k] for k in ref["params"]}
    upd = leaf_gaps(d_prog, d_ref, ref["grads"])
    gleaf, uleaf = max(grad, key=grad.get), max(upd, key=upd.get)
    mism = batch_mismatch(received, expected)
    return {"batch_mismatch": float(mism if mism >= 0 else float("inf")),
            "loss_gap": losses[0], "grad_gap": _median(grad), "update_gap": _median(upd),
            "_notes": f"loss gaps by step {losses}; worst leaves: grad {gleaf} {grad[gleaf]}, "
                      f"update {uleaf} {upd[uleaf]}"}


def recommendation(prog_scores, ref_scores_of_prog, ref_scores) -> Dict[str, float]:
    """score_gap and best_gap over the sampled students ((S, K) scores, best
    first: the program's, the reference's of the program's sequences, and
    the reference's beam search's)."""
    gap = float((prog_scores.double() - ref_scores_of_prog.double()).abs().max())
    best = float((prog_scores[:, 0].double() - ref_scores[:, 0].double()).abs().max())
    return {"score_gap": gap, "best_gap": best}


def judge(numbers: Dict[str, float], limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit (a number without a limit, or a missing number, fails)."""
    shown, ok = {}, True
    for name, lim in limits.items():
        value = numbers.get(name)
        limit = lim["limit"] if isinstance(lim, dict) else lim
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        shown[name] = {"value": value if value is not None and math.isfinite(value) else None,
                       "limit": limit}
    return ok, shown

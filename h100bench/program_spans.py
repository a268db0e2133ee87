"""Arithmetic of the readers of the program's own spans: the registry of
``genrec_tpu_torch.utils.profiling`` (``recorded()``: for each span name its
``count``, host ``seconds``, ``max_s`` and ``drained``, the entries at which
the card had finished all the work queued), which fills while a profiler
records, so over a run's traced stretch. The registry is read from the
module already loaded, never imported: a program without it, or a run
without a trace, reads as nothing.

A stretch's steps or batches are counted by a span that runs once in each
(``train.forward``, ``generate.encode``), so that a stretch retried reads
right.
"""

from __future__ import annotations

import sys
from typing import Optional

MODULE = "genrec_tpu_torch.utils.profiling"
TRAIN_UNIT = "train.forward"
RECOMMEND_UNIT = "generate.encode"


def registry(ctx) -> Optional[dict]:
    """The program's span registry after a traced run, or None."""
    if ctx["trace"] is None:
        return None
    recorded = getattr(sys.modules.get(MODULE), "recorded", None)
    return None if recorded is None else recorded()


def span_ms(ctx, unit: str, *names: str) -> Optional[float]:
    """Host milliseconds in ``names``, together, a ``unit`` span (a step or
    a batch)."""
    reg = registry(ctx)
    if not reg or not reg.get(unit, {}).get("count") or not all(n in reg for n in names):
        return None
    return 1e3 * sum(reg[n]["seconds"] for n in names) / reg[unit]["count"]


def wait_ms(ctx, unit: str) -> Optional[float]:
    """Host milliseconds a ``unit`` span in every span whose name ends in
    ``.wait``: the program's waits on the card (0 where it made none)."""
    reg = registry(ctx)
    if not reg or not reg.get(unit, {}).get("count"):
        return None
    return 1e3 * sum(v["seconds"] for n, v in reg.items() if n.endswith(".wait")) \
        / reg[unit]["count"]


def drained_pct(ctx, name: str) -> Optional[float]:
    """Share of ``name``'s entries at which the card had finished all the
    work queued, so waited on the host, %."""
    reg = registry(ctx)
    if not reg or not reg.get(name, {}).get("count"):
        return None
    return 100.0 * reg[name]["drained"] / reg[name]["count"]

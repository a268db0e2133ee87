"""Host spans, and a profiled stretch of the window read in memory.

:class:`Spans` times the benchmark's own calls into each layer of the
program with the host clock; inside a profiled stretch the same names also
go into the trace as ``record_function`` ranges. :func:`profile_stretch`
runs a number of the window's steps under ``torch.profiler`` (host and
device), and :func:`read_trace` reduces the trace to what the per-layer
metrics read: the device's busy time (the union of its operations) over the
stretch, device time by operation name, and the device's idle gaps, each
named by the span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import DeviceType


class Spans:
    """Durations (s) of named host spans; with ``profiling``, each span is a
    ``record_function`` range of the trace too."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


STRETCH = "stretch"


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def read_trace(prof, span_names) -> Optional[dict]:
    """busy_s, window_s, device seconds by operation name, and idle seconds
    by the host span the gap began in, over the ``stretch`` range; None when
    the trace holds no device operation."""
    events = prof.events()
    stretch = [e for e in events if e.name == STRETCH and e.device_type != DeviceType.CUDA]
    dev = _device_events(prof)
    if not stretch or not dev:
        return None
    lo, hi = stretch[0].time_range.start, stretch[0].time_range.end
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.name in span_names and e.device_type != DeviceType.CUDA)
    by_name: Dict[str, float] = {}
    intervals = []
    for e in dev:
        s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if t <= s:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
        intervals.append((s, t))
    intervals.sort()
    busy, gaps, at = 0.0, [], lo
    for s, t in intervals:
        if s > at:
            gaps.append((at, s))
        if t > at:
            busy += t - max(s, at)
            at = t
    if hi > at:
        gaps.append((at, hi))
    idle: Dict[str, float] = {}
    for a, b in gaps:
        name = "no span"
        for s, t, n in spans:  # the innermost span that holds the gap's start
            if s <= a < t:
                name = n
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6, "ops": by_name, "idle": idle,
            "n_ops": len(intervals)}


def profile_stretch(step: Callable[[], None], n: int, spans: Spans, sync: Callable[[], None],
                    device) -> Optional[dict]:
    """Run ``step`` ``n`` times under the profiler, the last followed by
    ``sync``, inside one ``stretch`` range; the trace's reading (read_trace),
    or None when it holds no device time. The profiler has now and then
    returned a trace with no device events on a fresh machine: up to three
    tries."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _ in range(3):
        spans.profiling = True
        try:
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(STRETCH):
                    for _ in range(n):
                        step()
                    sync()
        finally:
            spans.profiling = False
        out = read_trace(prof, set(spans.seconds))
        if out is not None:
            out["steps"] = n
            return out
    return None

"""Tracing and host spans of the port, on ``torch.profiler``.

Counterpart of ``genrec_tpu/utils/profiling.py`` (whose ``StepTimer`` the
port leaves out; the spans are the port's own):

- :func:`trace`: a context manager that records host and device activity
  and writes it under a directory as a Chrome-trace JSON file
  (``<host>_<pid>.<ms>.pt.trace.json``), which Perfetto and chrome://tracing
  open (the reference writes a TensorBoard trace through ``jax.profiler``);
- :func:`annotate`: a named host range in that timeline;
- :func:`span`: a named host range that also adds to a registry of host
  time by name (:func:`recorded`, :func:`reset`, :func:`open_spans`), on
  only while a ``torch.profiler`` session records; :func:`wait_span`, one
  around a host wait on a card, opened on a CUDA device only; :func:`count`,
  a counter in the same registry. The Trainer's streamed
  route and dispatch (``train.fetch``, ``train.upload`` with
  ``train.upload.wait`` and ``train.upload.stage``, ``train.forward``,
  ``train.backward``, ``train.optimizer``), recommendation
  (``generate.encode``, ``beam.search`` with ``beam.search.wait``,
  ``beam.decode``, ``beam.select``) and the T5 stack's relative-position
  buckets (``t5.bucket.wait``) are spans; every host wait on the device on
  those routes is a span whose name ends in ``.wait``. The decoder's
  incremental step counts the self-attention key positions it attends
  (``beam.decode.keys``) and those its cache held (``beam.decode.cached``).
  DeepSeek-V2's recommendation (``models/deepseek_v2.py``) adds the spans
  ``lm.prefill``, ``moe.route``, ``moe.experts``, ``moe.combine`` and
  ``mla.decode``, the counters ``moe.rows`` and ``mla.cache.positions``,
  and ``moe.busiest``, a counter kept on the card (:func:`count_device`).
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

from genrec_tpu_torch.utils.misc import get_logger


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Record the host (CPU) and, on a host with a card, the device (CUDA)
    activity of the block and write it to a Chrome-trace JSON file in
    ``log_dir``. ``create_perfetto_link``: the reference prints a link that
    serves its trace to the Perfetto UI and waits for it to be opened; the
    port has no link to print and does not wait: it logs the written file's
    path, which the Perfetto UI opens."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = set(glob.glob(os.path.join(log_dir, "*.pt.trace.json")))
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    if create_perfetto_link:
        for path in sorted(set(glob.glob(os.path.join(log_dir, "*.pt.trace.json"))) - before):
            get_logger("genrec").info(f"trace written to {path}: open it in the Perfetto UI")


def annotate(name: str):
    """A named host range, visible in a :func:`trace`'s timeline."""
    return record_function(name)


# name -> [count, host ns, longest ns, entries with the card drained]
_registry: Dict[str, List[int]] = {}
# name -> a device tensor of counts not yet added to the registry
_device_counts: Dict[str, torch.Tensor] = {}
_open: List[str] = []
_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        totals = _registry.setdefault(self.name, [0, 0, 0, 0])
        if torch.cuda.is_initialized() and torch.cuda.current_stream().query():
            totals[3] += 1
        self.range = record_function(self.name)
        self.range.__enter__()
        _open.append(self.name)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        _open.pop()
        self.range.__exit__(*exc)
        totals = _registry.setdefault(self.name, [0, 0, 0, 0])
        totals[0] += 1
        totals[1] += ns
        totals[2] = max(totals[2], ns)
        return False


def span(name: str):
    """A named host span, on only while a ``torch.profiler`` session
    records (the profiler's own enabled flag). Off, it is a shared no-op
    context: no clock reading, no range, no allocation. On, it is a
    ``record_function`` range of the trace, on the device events' clock and
    nested under the caller's ranges, and it adds to ``name``'s totals in
    the registry (:func:`recorded`): its count, host seconds, longest
    occurrence, and on a CUDA device the entries at which the current
    stream had finished all its work (``drained``: the card was waiting on
    the host)."""
    return _Span(name) if _recording() else _OFF


def wait_span(name: str, device):
    """:func:`span` around work that makes the host wait on ``device`` (a
    copy from pageable memory, an event's synchronize); its name ends in
    ``.wait``. On a CPU device the same work waits on nothing, so no span
    opens there."""
    return span(name) if torch.device(device).type == "cuda" else _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to ``name``'s count in the registry, with no host time,
    while a ``torch.profiler`` session records (as :func:`span`); off, one
    flag check."""
    if _recording():
        _registry.setdefault(name, [0, 0, 0, 0])[0] += n


def recording() -> bool:
    """Whether a ``torch.profiler`` session records now (spans and counters
    are on)."""
    return _recording()


def count_device(name: str, n: torch.Tensor) -> None:
    """:func:`count` of a 0-d integer tensor on a device, summed there with
    no host sync; :func:`recorded` copies the sum to the host once. Off, one
    flag check, as :func:`count`."""
    if _recording():
        held = _device_counts.get(name)
        _device_counts[name] = n.detach().long() if held is None else held + n


def recorded() -> Dict[str, Dict[str, float]]:
    """A copy of the registry: for each span name its ``count``,
    ``seconds``, ``max_s`` and ``drained``. Counts kept on a device are
    read here (a copy each) and added first."""
    for name, n in _device_counts.items():
        _registry.setdefault(name, [0, 0, 0, 0])[0] += int(n)
    _device_counts.clear()
    return {name: {"count": c, "seconds": ns / 1e9, "max_s": top / 1e9, "drained": d}
            for name, (c, ns, top, d) in _registry.items()}


def reset() -> None:
    """Clear the registry's totals."""
    _registry.clear()
    _device_counts.clear()


def open_spans() -> List[str]:
    """The names of the spans open now, outermost first (recorded spans only)."""
    return list(_open)

"""Tracing and step timing of the port, on ``torch.profiler``.

Counterpart of ``genrec_tpu/utils/profiling.py``:

- :func:`trace`: a context manager that records host and device activity
  and writes it under a directory as a Chrome-trace JSON file
  (``<host>_<pid>.<ms>.pt.trace.json``), which Perfetto and chrome://tracing
  open (the reference writes a TensorBoard trace through ``jax.profiler``);
- :func:`annotate`: a named host range in that timeline;
- :class:`StepTimer`: steps/s and examples/s over windows of steps, the
  device synchronized where a window ends.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Dict, List, Optional

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


def _sync(value) -> None:
    """Wait for the device work that produced ``value`` (a tensor, or a
    dict, list or tuple of them): ``torch.cuda.synchronize`` on each card a
    tensor lies on. A CPU tensor is ready when the call that made it returns."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)
    elif isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


class StepTimer:
    """Rolling per-step timing. Call ``tick(n_examples)`` after each step;
    every ``sync_every`` steps it waits for ``sync_value`` (a device output
    of the step), so the window measures the work and not only its launch,
    and returns the totals since the last ``reset``."""

    def __init__(self, sync_every: int = 50):
        self.sync_every = sync_every
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._examples = 0
        self.history: List[Dict[str, float]] = []

    def tick(self, n_examples: int, sync_value=None) -> Optional[Dict[str, float]]:
        self._steps += 1
        self._examples += n_examples
        if self._steps % self.sync_every == 0:
            if sync_value is not None:
                _sync(sync_value)
            dt = time.perf_counter() - self._t0
            stats = {
                "steps": self._steps,
                "seconds": dt,
                "steps_per_sec": self._steps / dt,
                "examples_per_sec": self._examples / dt,
            }
            self.history.append(stats)
            return stats
        return None

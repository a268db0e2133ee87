"""Checkpoints of the port: the best parameters and the latest train state.

Counterpart of ``genrec_tpu/train/checkpoint.py``'s ``CheckpointStore``, in
the port's own format (``torch.save``), every file written to a temporary
file and renamed into place so that a reader never sees half a file:

- ``<ckpt_dir>/best.pt``: a state_dict of the best parameters
  (:func:`save_best` / :func:`restore_best`; ``tiger_model_fn`` serves it);
  another ``tag`` writes ``<tag>.pt`` beside it (the RQ-VAE pipeline keeps
  its best-collision parameters in ``best_collision.pt``);
- ``<ckpt_dir>/latest_<step>.pt``: the full train state (model, optimizer,
  scheduler, ``step``, ``epoch``, ``best_val``) with bounded retention: the
  newest ``keep`` are kept (:class:`CheckpointStore`).
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Optional

import torch

BEST = "best"
_LATEST = re.compile(r"^latest_(\d+)\.pt$")


def _atomic_save(obj, path: str) -> str:
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=d)
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def save_best(state_dict: Dict[str, torch.Tensor], ckpt_dir: str, tag: str = BEST) -> str:
    """Write ``state_dict`` as the checkpoint ``<tag>.pt`` of ``ckpt_dir``;
    return its path. Every restore loads onto the CPU."""
    return _atomic_save(state_dict, os.path.join(ckpt_dir, f"{tag}.pt"))


def restore_best(ckpt_dir: str, tag: str = BEST) -> Optional[Dict[str, torch.Tensor]]:
    """The state_dict ``<tag>.pt`` of ``ckpt_dir`` on the CPU, or None if absent."""
    path = os.path.join(ckpt_dir, f"{tag}.pt")
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointStore:
    """Latest-state checkpoints with bounded retention, plus the best
    parameters, under one directory."""

    def __init__(self, ckpt_dir: str, keep: int = 5):
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        self.dir = os.path.abspath(ckpt_dir)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self) -> List[int]:
        """Steps of the latest-state checkpoints on disk, oldest first."""
        found = (_LATEST.match(n) for n in os.listdir(self.dir))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"latest_{step:09d}.pt")

    def save_latest(self, step: int, state: Dict[str, Any]) -> str:
        """Write the train state of ``step``; drop all but the newest ``keep``."""
        path = _atomic_save(state, self._path(step))
        for old in self.steps()[:-self.keep]:
            os.remove(self._path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        """The newest train state on the CPU, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def save_best(self, state_dict: Dict[str, torch.Tensor], tag: str = BEST) -> str:
        return save_best(state_dict, self.dir, tag)

    def restore_best(self, tag: str = BEST) -> Optional[Dict[str, torch.Tensor]]:
        return restore_best(self.dir, tag)

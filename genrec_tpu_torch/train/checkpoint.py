"""Best-parameters checkpoint of the port.

The port's own format: one ``torch.save`` of a state_dict at
``<ckpt_dir>/best.pt``, written to a temporary file and renamed into place
so that a reader never sees half a file. ``restore_best`` returns None when
there is none, as the reference's ``CheckpointStore.restore_best`` does.
The port's trainer will add the full-state, bounded-retention checkpoints.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import torch

BEST = "best.pt"


def save_best(state_dict: Dict[str, torch.Tensor], ckpt_dir: str) -> str:
    """Write ``state_dict`` (moved to the CPU) as the best checkpoint of
    ``ckpt_dir``; return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, BEST)
    cpu = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    fd, tmp = tempfile.mkstemp(suffix=".pt", dir=ckpt_dir)
    os.close(fd)
    try:
        torch.save(cpu, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def restore_best(ckpt_dir: str) -> Optional[Dict[str, torch.Tensor]]:
    """The best state_dict of ``ckpt_dir`` on the CPU, or None if absent."""
    path = os.path.join(ckpt_dir, BEST)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)

"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises; the CPU
    is used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless the "
                           "caller passes device='cpu'")
    return dev

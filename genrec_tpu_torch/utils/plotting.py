"""Loss-curve plot: a copy of ``genrec_tpu/utils/plotting.py``'s
``plot_loss_curves`` (`SASRec/train.py:207-220`). Matplotlib is imported
only when a path is given, with the Agg backend, so a machine without it
trains as long as no plot is asked for."""

from __future__ import annotations

import os
from typing import Optional, Sequence


def plot_loss_curves(train_losses: Sequence[float],
                     val_losses: Optional[Sequence[float]] = None,
                     save_path: Optional[str] = None) -> None:
    if not save_path:
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    plt.figure(figsize=(8, 5))
    xs = range(1, len(train_losses) + 1)
    plt.plot(xs, train_losses, marker="o", label="Train Loss")
    if val_losses:
        plt.plot(range(1, len(val_losses) + 1), val_losses, marker="s", label="Val Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.grid(True)
    plt.legend()
    plt.tight_layout()
    plt.savefig(save_path, dpi=200)
    plt.close()

"""Loss-curve and metric plots: a copy of ``genrec_tpu/utils/plotting.py``
(`SASRec/train.py:207-220`, `RQVAE-T5/utils.py:93-163`). Matplotlib is
imported only when a path is given, with the Agg backend, so a machine
without it trains as long as no plot is asked for."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence


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


def plot_training_curves(train_losses: Sequence[float],
                         val_metrics: Optional[Dict[str, Sequence[float]]] = None,
                         save_path: Optional[str] = None) -> None:
    if not save_path:
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig, axes = plt.subplots(2, 2, figsize=(15, 10))
    axes[0, 0].plot(train_losses, linewidth=2, label="Training Loss")
    axes[0, 0].set_title("Training Loss")
    axes[0, 0].legend()
    slots = [(0, 1), (1, 0), (1, 1)]
    if val_metrics:
        for (r, c), (name, values) in zip(slots, val_metrics.items()):
            axes[r, c].plot(values, linewidth=2, label=name)
            axes[r, c].set_title(name)
            axes[r, c].legend()
    for r, c in slots[len(val_metrics or {}):]:
        axes[r, c].axis("off")
    plt.tight_layout()
    plt.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close()

"""The port's single-device Trainer.

Counterpart of ``genrec_tpu/train/trainer.py``'s ``Trainer`` on its
single-device, device-resident path:

- the datasets are uploaded to the device once; each epoch's shuffled index
  matrix is built as the reference's ``_index_matrix`` builds it, seeded
  ``cfg.seed + epoch``, so the batch order equals the reference's; each step
  index-gathers its batch on the device, with -1 padding and a ``valid``
  mask;
- a step is forward, backward and one update of ``optim.make_optimizer``
  (clip, optimizer, schedule); dropout draws from one ``torch.Generator``
  on the device, seeded ``cfg.seed``;
- the loss sums stay on the device and are read once per epoch;
- per-epoch validation loss, early stop on ``early_stop_patience``, the best
  parameters snapshot (``best.pt``), latest-state checkpoints every
  ``ckpt_every_epochs`` with ``keep_checkpoints`` retention, resume, the
  abort on a non-finite loss, and an ``epoch_end_callback(epoch, trainer)``
  after each epoch's latest-state save.

Still to port (ROADMAP Queue 1 items 4 and 5): sharded and multi-process
datasets, length buckets, composite widths and ``profile_dir``. The
reference's batch-factory ``fit`` is left out until a caller needs it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from genrec_tpu_torch.configs import TrainerConfig
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.train.checkpoint import CheckpointStore
from genrec_tpu_torch.train.optim import make_optimizer
from genrec_tpu_torch.utils.misc import get_logger
from genrec_tpu_torch.utils.plotting import plot_loss_curves

Batch = Dict[str, torch.Tensor]
# loss_fn(model, batch, generator) -> (loss, aux); aux holds "sum_loss" and
# "valid", whose sums give the per-valid-normalized epoch means. The
# validation loss runs in eval mode (no dropout) with the same generator, from
# which a loss may draw what else it samples (SASRec's negatives).
LossFn = Callable[[nn.Module, Batch, Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainLoopResult:
    best_params: Dict[str, torch.Tensor]
    final_params: Dict[str, torch.Tensor]
    train_losses: List[float]
    val_losses: List[float]
    best_val_loss: float
    epochs_run: int
    examples_per_sec: float
    # excludes the first epoch run (warm-up: kernel builds, allocator growth)
    steady_examples_per_sec: float = 0.0
    # wall-clock breakdown: train / val / ckpt seconds, wall, the first epoch
    phase_seconds: Optional[Dict[str, float]] = None
    steps_run: int = 0  # optimizer steps taken by this fit()


class Trainer:
    def __init__(self, cfg: TrainerConfig, *, model: nn.Module, loss_fn: LossFn,
                 train_data: Dict[str, np.ndarray],
                 val_data: Optional[Dict[str, np.ndarray]] = None,
                 logger_name: str = "genrec", device=None,
                 eval_loss_fn: Optional[LossFn] = None):
        """``train_data`` / ``val_data``: numpy arrays with one row per
        sample, uploaded to ``device`` once (the card unless ``device="cpu"``)
        and kept there as ``self.train_data`` / ``self.val_data``. ``model``
        is moved there; the trainer updates it in place. ``loss_fn`` serves
        training (model in ``.train()``) and, unless ``eval_loss_fn`` is
        given, validation (``.eval()``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_loss_fn or loss_fn
        n_train = len(next(iter(train_data.values())))
        self.opt = make_optimizer(self.model.parameters(), cfg,
                                  -(-n_train // cfg.batch_size))  # steps per epoch
        self.step = 0
        self.start_epoch = 1
        self.best_val = float("inf")
        self.logger = get_logger(logger_name, cfg.log_path)
        self.store = CheckpointStore(cfg.ckpt_dir, keep=cfg.keep_checkpoints)
        self.train_data = self._upload(train_data)
        self.val_data = self._upload(val_data) if val_data is not None else None
        if cfg.resume:
            self._try_resume()

    def _upload(self, data: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in data.items()}

    def snapshot_params(self) -> Dict[str, torch.Tensor]:
        """A copy of the model's state_dict that later steps leave as it is."""
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    # ------------------------------------------------------------------
    def _state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.opt.optimizer.state_dict(),
                "scheduler": self.opt.scheduler.state_dict(),
                "step": self.step, "epoch": self.start_epoch, "best_val": self.best_val}

    def _try_resume(self):
        restored = self.store.restore_latest()
        if restored is None:
            return
        self.model.load_state_dict(restored["model"])
        self.opt.optimizer.load_state_dict(restored["optimizer"])
        self.opt.scheduler.load_state_dict(restored["scheduler"])
        self.step = int(restored["step"])
        self.start_epoch = int(restored["epoch"]) + 1
        self.best_val = float(restored["best_val"])
        self.logger.info(f"Resumed from step {self.step} (epoch {self.start_epoch - 1}), "
                         f"best_val={self.best_val:.4f}")

    # ------------------------------------------------------------------
    @staticmethod
    def _index_matrix(n: int, batch_size: int, *, shuffle: bool, seed: int) -> np.ndarray:
        """(steps, batch_size) int32 index matrix; -1 pads the final batch."""
        idx = np.arange(n, dtype=np.int32)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        steps = -(-n // batch_size)
        out = np.full((steps * batch_size,), -1, np.int32)
        out[:n] = idx
        return out.reshape(steps, batch_size)

    @staticmethod
    def gather(data: Batch, idx: torch.Tensor) -> Batch:
        """The batch of rows ``idx`` (a device index vector; -1 pads): every
        array's rows, and ``valid`` = idx ≥ 0."""
        safe = idx.clamp(min=0)
        batch = {k: v.index_select(0, safe) for k, v in data.items()}
        batch["valid"] = idx >= 0
        return batch

    def _indices(self, data: Batch, batch_size: int, *, shuffle: bool, seed: int):
        """The index matrix, on the host and on the device."""
        n = len(next(iter(data.values())))
        mat = self._index_matrix(n, batch_size, shuffle=shuffle, seed=seed)
        return mat, torch.from_numpy(mat).to(self.device, torch.int64)

    def train_step(self, batch: Batch, generator: Optional[torch.Generator]):
        """One update on ``batch``; returns its (sum_loss, valid) on the device."""
        self.model.train()
        loss, aux = self.loss_fn(self.model, batch, generator)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self.step += 1
        return aux["sum_loss"].detach(), aux["valid"]

    @torch.no_grad()
    def evaluate_loss(self, generator: Optional[torch.Generator] = None) -> float:
        """Per-valid-sample mean validation loss (SASRec/train.py:59-81 style),
        summed on the device and read once; ``generator`` goes to the loss."""
        self.model.eval()
        _, idx_mat = self._indices(self.val_data, self.cfg.eval_batch_size, shuffle=False,
                                   seed=0)
        total = torch.zeros((), device=self.device)
        valid = torch.zeros((), device=self.device)
        for idx in idx_mat:
            _, aux = self.eval_loss_fn(self.model, self.gather(self.val_data, idx), generator)
            total += aux["sum_loss"]
            valid += aux["valid"]
        total, valid = float(total), float(valid)
        return total / valid if valid > 0 else 0.0

    # ------------------------------------------------------------------
    def fit(self, *, epoch_end_callback: Optional[Callable[[int, "Trainer"], None]] = None
            ) -> TrainLoopResult:
        """Train to ``cfg.epochs`` (or an early stop), calling
        ``epoch_end_callback(epoch, self)`` after each epoch's latest-state
        save."""
        cfg = self.cfg
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        train_losses: List[float] = []
        val_losses: List[float] = []
        best_params = self.snapshot_params()
        no_improve = 0
        total_examples = 0
        total_time = 0.0
        epochs_run = 0
        steps_run = 0
        phase = {"train": 0.0, "val": 0.0, "ckpt": 0.0}
        first_epoch_s = 0.0  # warm-up epoch, excluded from steady ex/s
        first_epoch_examples = 0

        for epoch in range(self.start_epoch, cfg.epochs + 1):
            epochs_run = epoch
            t0 = time.perf_counter()
            mat, idx_mat = self._indices(self.train_data, cfg.batch_size, shuffle=True,
                                         seed=cfg.seed + epoch)
            sum_loss = torch.zeros((), device=self.device)
            sum_valid = torch.zeros((), device=self.device)
            for idx in idx_mat:
                sl, vl = self.train_step(self.gather(self.train_data, idx), generator)
                sum_loss += sl
                sum_valid += vl
            steps_run += len(idx_mat)
            n_examples = int((mat >= 0).sum())
            # the float() reads synchronize: once per epoch
            sum_loss, sum_valid = float(sum_loss), float(sum_valid)
            dt = time.perf_counter() - t0
            phase["train"] += dt
            total_time += dt
            total_examples += n_examples
            if epoch == self.start_epoch:
                first_epoch_s = dt
                first_epoch_examples = n_examples

            avg_loss = sum_loss / sum_valid if sum_valid > 0 else 0.0
            if not np.isfinite(avg_loss):
                # reference aborts on NaN loss (`RQ-VAE/train.py:92-94`)
                self.logger.error(f"Epoch {epoch}: non-finite train loss ({avg_loss}); aborting")
                raise ValueError(f"training diverged: loss={avg_loss} at epoch {epoch}")
            train_losses.append(avg_loss)

            if self.val_data is not None:
                tv = time.perf_counter()
                val_loss = self.evaluate_loss(generator)
                phase["val"] += time.perf_counter() - tv
            else:
                val_loss = avg_loss
            val_losses.append(val_loss)

            self.logger.info(
                f"Epoch {epoch} | Train Loss: {avg_loss:.4f} | Val Loss: {val_loss:.4f} | "
                f"{dt:.2f}s | {n_examples / max(dt, 1e-9):.0f} ex/s")

            self.start_epoch = epoch
            tc = time.perf_counter()
            if (epoch % cfg.ckpt_every_epochs == 0) or epoch == cfg.epochs:
                self.store.save_latest(self.step, self._state_dict())
            phase["ckpt"] += time.perf_counter() - tc

            if epoch_end_callback is not None:
                epoch_end_callback(epoch, self)

            if val_loss < self.best_val:
                self.best_val = val_loss
                no_improve = 0
                best_params = self.snapshot_params()
                tc = time.perf_counter()
                self.store.save_best(best_params)
                phase["ckpt"] += time.perf_counter() - tc
                self.logger.info(f"Best model saved (val_loss={val_loss:.4f})")
            else:
                no_improve += 1
                if no_improve >= cfg.early_stop_patience:
                    self.logger.info(f"Early stopping at epoch {epoch}.")
                    if cfg.ckpt_every_epochs > 1 and epoch % cfg.ckpt_every_epochs != 0:
                        # the cadence skipped this epoch's latest-state save;
                        # persist it so resume starts from the stopping point
                        self.store.save_latest(self.step, self._state_dict())
                    break

        plot_loss_curves(train_losses, val_losses, cfg.loss_plot_path)
        steady_examples = total_examples - first_epoch_examples
        steady_time = phase["train"] - first_epoch_s
        steady_eps = (steady_examples / steady_time if steady_time > 0
                      else total_examples / max(total_time, 1e-9))
        wall = total_time + phase["val"] + phase["ckpt"]
        self.logger.info(
            "Phase breakdown: train %.1fs (first epoch %.1fs) | val %.1fs | ckpt %.1fs "
            "| steady %.0f ex/s" % (phase["train"], first_epoch_s, phase["val"],
                                    phase["ckpt"], steady_eps))
        return TrainLoopResult(
            best_params=best_params,
            final_params=self.snapshot_params(),
            train_losses=train_losses,
            val_losses=val_losses,
            best_val_loss=self.best_val,
            epochs_run=epochs_run,
            examples_per_sec=total_examples / max(total_time, 1e-9),
            steady_examples_per_sec=steady_eps,
            phase_seconds=dict(phase, wall=wall, first_epoch=first_epoch_s),
            steps_run=steps_run,
        )

"""RQ-VAE pipeline of the port: train → semantic-ID assignment → codes.npy.

Counterpart of ``genrec_tpu/pipelines/rqvae_pipeline.py`` (`python
RQ-VAE/main.py`):
- training (`RQ-VAE/train.py:15-288`) on the port's ``Trainer`` with the
  embeddings resident on the device: AdamW with linear warmup, grad-clip
  1.0, the abort on a non-finite loss, the collision rate every
  ``epochs // 10`` epochs with the best-collision parameters kept beside
  the best-loss ones (``best_collision.pt``);
- inference (`RQ-VAE/infer.py:44-184`): greedy code assignment, up to
  ``collision_repair_iters`` rounds that re-assign each collision group's
  last level with Sinkhorn inside the group (earlier levels take argmin),
  then a 4th digit that numbers the duplicates left; writes codes.npy and
  its mapping JSON.

k-means init, training and assignment run on the device; the collision
bookkeeping stays in numpy, as in the reference. Every entry point runs on
the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from genrec_tpu_torch.configs import RQVAEConfig
from genrec_tpu_torch.data.contracts import read_item_embs, write_codes
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.rqvae import RQVAE, collision_rate, kmeans_init_codebooks
from genrec_tpu_torch.train.trainer import Trainer, TrainLoopResult
from genrec_tpu_torch.utils.misc import get_logger


@dataclasses.dataclass
class RQVAEArtifacts:
    params: Dict[str, torch.Tensor]  # best-collision state_dict (the assignment model)
    best_loss_params: Dict[str, torch.Tensor]
    result: TrainLoopResult
    final_collision_rate: float


def loss_fn(model: RQVAE, batch, generator: Optional[torch.Generator]):
    """total = recon + quant_loss_weight·rq over the rows of ``valid`` (the
    trainer pads the last batch with row 0); Sinkhorn assignment; dropout
    follows the model's mode. aux: ``sum_loss`` = total·valid rows."""
    x, row_mask = batch["x"], batch["valid"]
    out, rq_loss, _ = model(x, use_sk=True, row_mask=row_mask, generator=generator)
    total, recon = model.compute_loss(out, rq_loss, x, row_mask)
    valid = row_mask.float().sum()
    return total, {"sum_loss": total * valid, "valid": valid, "recon": recon}


def build_model(cfg: RQVAEConfig, embs: np.ndarray, device) -> RQVAE:
    """An RQ-VAE on ``device`` with weights drawn from ``cfg.trainer.seed``
    and, with ``kmeans_init``, every codebook fit by k-means on (up to) the
    first 8,192 rows (the reference fits on the first training batch; more
    data only helps)."""
    gen = torch.Generator().manual_seed(cfg.trainer.seed)
    model = RQVAE(cfg, generator=gen).to(device)
    if cfg.kmeans_init:
        sample = torch.as_tensor(embs[:min(len(embs), 8192)], device=device)
        kmeans_init_codebooks(model, sample, generator=gen)
    return model


def _batched_indices(model: RQVAE, embs: np.ndarray, batch: int = 1024,
                     use_sk: bool = False) -> np.ndarray:
    """(N, L) codes of ``embs``, ``batch`` rows a call (the last zero-padded)."""
    dev = next(model.parameters()).device
    n = len(embs)
    pad_to = -(-n // batch) * batch
    padded = np.zeros((pad_to, embs.shape[1]), embs.dtype)
    padded[:n] = embs
    out = [model.get_indices(torch.as_tensor(padded[s:s + batch], device=dev), use_sk=use_sk)
           for s in range(0, pad_to, batch)]
    return torch.cat(out).cpu().numpy()[:n]


def train(cfg: RQVAEConfig, item_embs: Optional[np.ndarray] = None,
          device=None) -> RQVAEArtifacts:
    device = resolve_device(device)
    logger = get_logger("rqvae", cfg.trainer.log_path)
    if item_embs is None:
        item_embs, _ = read_item_embs(cfg.data_path)
    embs = np.asarray(item_embs, dtype=np.float32)
    model = build_model(cfg, embs, device)
    trainer = Trainer(cfg.trainer, model=model, loss_fn=loss_fn, train_data={"x": embs},
                      logger_name="rqvae", device=device)

    best_collision = {"rate": float("inf"), "params": trainer.snapshot_params()}

    def on_epoch_end(epoch, tr: Trainer):
        epochs = cfg.trainer.epochs
        if epoch % max(epochs // 10, 1) != 0 and epoch != epochs:
            return
        rate = collision_rate(_batched_indices(tr.model, embs))
        logger.info(f"Epoch {epoch} | collision rate {rate:.4f}")
        if rate < best_collision["rate"]:
            best_collision["rate"] = rate
            best_collision["params"] = tr.snapshot_params()
            tr.store.save_best(best_collision["params"], tag="best_collision")

    result = trainer.fit(epoch_end_callback=on_epoch_end)
    if not np.isfinite(best_collision["rate"]):
        model.load_state_dict(result.best_params)
        best_collision = {"rate": collision_rate(_batched_indices(model, embs)),
                          "params": result.best_params}
    return RQVAEArtifacts(params=best_collision["params"],
                          best_loss_params=result.best_params, result=result,
                          final_collision_rate=best_collision["rate"])


def _collision_groups(codes: np.ndarray):
    _, inv, counts = np.unique(codes, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    return [np.where(inv == g)[0] for g in np.where(counts > 1)[0]]


def infer(cfg: RQVAEConfig, artifacts: RQVAEArtifacts,
          item_embs: Optional[np.ndarray] = None, write: bool = True,
          device=None) -> np.ndarray:
    """Greedy assignment + collision repair + 4th-digit dedup
    (`RQ-VAE/infer.py:44-184`). Returns the (N, L+1) code table."""
    device = resolve_device(device)
    logger = get_logger("rqvae")
    if item_embs is None:
        item_embs, _ = read_item_embs(cfg.data_path)
    embs = np.asarray(item_embs, dtype=np.float32)
    model = RQVAE(cfg)
    model.load_state_dict(artifacts.params)
    model.to(device).eval()

    codes = _batched_indices(model, embs, use_sk=False)  # (N, L)

    # collision repair: Sinkhorn on the last level only (infer.py:108-130),
    # inside each group (the reference re-assigns one group per call): groups
    # of one size go together as a (G, s, D) stack, each balanced on its own
    repair_cfg = dataclasses.replace(
        cfg, sk_epsilons=tuple([0.0] * (len(cfg.sk_epsilons) - 1) + [cfg.sk_epsilons[-1]]))
    repair_model = RQVAE(repair_cfg)
    repair_model.load_state_dict(artifacts.params)
    repair_model.to(device).eval()
    for it in range(cfg.collision_repair_iters):
        groups = _collision_groups(codes)
        if not groups:
            break
        logger.info(f"Collision-repair iter {it}: {len(groups)} groups")
        by_size: Dict[int, list] = {}
        for g in groups:
            by_size.setdefault(len(g), []).append(g)
        for size, gs in sorted(by_size.items()):
            idx = np.stack(gs)  # (G, s)
            new = repair_model.get_indices(torch.as_tensor(embs[idx], device=device),
                                           use_sk=True).cpu().numpy()
            codes[idx.reshape(-1)] = new.reshape(-1, new.shape[-1])

    # 4th-digit dedup (infer.py:150-171)
    full = np.concatenate([codes.astype(np.int64),
                           np.zeros((len(codes), 1), np.int64)], axis=1)
    uniq, counts = np.unique(full, axis=0, return_counts=True)
    for dup in uniq[counts > 1]:
        idx = np.where((full == dup).all(axis=1))[0]
        for i, j in enumerate(idx):
            full[j, -1] = i

    rate = collision_rate(codes)
    logger.info(f"Final collision rate before dedup digit: {rate:.4f}")
    if write:
        write_codes(cfg.semantic_id_file, full)
    return full


def main(cfg: RQVAEConfig = RQVAEConfig(), device=None):
    artifacts = train(cfg, device=device)
    return infer(cfg, artifacts, device=device)

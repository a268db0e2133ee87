"""DenseT5 pipeline of the port: contrastive train → cosine top-k retrieval eval.

Counterpart of ``genrec_tpu/pipelines/dense_t5_pipeline.py`` (train
`T5/train.py:134-207`, in-training eval `T5/train.py:69-97`). History item
ids are batched; the (I + 1, D) item table and the (U, D) user table are
uploaded to the device once, and each step gathers its sequences there. The
reference hands the tables to its Trainer as ``extra_data``; here the loss
is a closure over the device tables, which gives the same batches. Every
entry point runs on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from genrec_tpu_torch.configs import DenseT5Config
from genrec_tpu_torch.data import datasets
from genrec_tpu_torch.data.contracts import read_interactions, read_item_embs, read_user_embs
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.dense_t5 import DenseT5, contrastive_loss
from genrec_tpu_torch.ops.metrics_ops import hit_ndcg_from_ranks
from genrec_tpu_torch.train.trainer import Trainer, TrainLoopResult
from genrec_tpu_torch.utils.csv_results import append_results_csv


@dataclasses.dataclass
class DenseT5Artifacts:
    params: Dict[str, torch.Tensor]  # the best state_dict of models.dense_t5.DenseT5
    result: TrainLoopResult


def _gather_batch(item_embs: torch.Tensor, user_embs: torch.Tensor, batch):
    """(B, L + 1, D) sequences: the user's profile embedding at position 0
    (``user_embs`` row ``user_id − 1``), then the history items; the mask
    covers the user embedding and the real items (``pos <= seq_lens``,
    `T5/data_vision.py:131-154`); and the (B, D) target embeddings."""
    hist = batch["history_ids"]                                  # (B, L)
    seq = F.embedding(hist, item_embs)                           # (B, L, D)
    uemb = F.embedding(batch["user_ids"] - 1, user_embs)         # (B, D)
    seq = torch.cat([uemb[:, None, :], seq], dim=1)              # (B, L + 1, D)
    pos = torch.arange(hist.shape[1] + 1, device=hist.device)[None, :]
    mask = (pos <= batch["seq_lens"][:, None]).to(torch.int32)
    return seq, mask, F.embedding(batch["target_ids"], item_embs)


def _tables(cfg: DenseT5Config, item_embs, user_embs, device):
    """The item and user tables, read from ``cfg``'s files when not given,
    as f32 tensors on ``device``."""
    if item_embs is None:
        item_embs, _ = read_item_embs(cfg.item_emb_h5_path)
    if user_embs is None:
        user_embs = read_user_embs(cfg.user_emb_h5_path)
    return tuple(torch.as_tensor(np.asarray(t, np.float32)).to(device)
                 for t in (item_embs, user_embs))


def build_model(cfg: DenseT5Config) -> DenseT5:
    """A DenseT5 with weights drawn from ``cfg.trainer.seed``."""
    return DenseT5(cfg, generator=torch.Generator().manual_seed(cfg.trainer.seed))


def make_loss_fn(cfg: DenseT5Config, item_embs: torch.Tensor, user_embs: torch.Tensor):
    """The Trainer's loss over device tables: InfoNCE of one batch with its
    padded rows masked by ``valid``; aux holds ``sum_loss`` (loss · valid
    rows) and ``valid``. Dropout follows the model's mode (the reference's
    train and eval loss functions)."""

    def loss_fn(model: DenseT5, batch, generator: Optional[torch.Generator]):
        seq, mask, tgt = _gather_batch(item_embs, user_embs, batch)
        _, pred = model(seq, mask, generator=generator)
        loss = contrastive_loss(pred, tgt, cfg.temperature, valid=batch["valid"])
        n = batch["valid"].to(torch.float32).sum()
        return loss, {"sum_loss": loss * n, "valid": n}

    return loss_fn


def train(cfg: DenseT5Config, data=None, item_embs: Optional[np.ndarray] = None,
          user_embs: Optional[np.ndarray] = None, device=None) -> DenseT5Artifacts:
    device = resolve_device(device)
    if data is None:
        data = read_interactions(cfg.rec_path)
    items, users = _tables(cfg, item_embs, user_embs, device)
    tr = datasets.build_dense_t5_arrays(data, cfg.max_seq_len, "train")
    te = datasets.build_dense_t5_arrays(data, cfg.max_seq_len, "test")
    trainer = Trainer(cfg.trainer, model=build_model(cfg),
                      loss_fn=make_loss_fn(cfg, items, users), train_data=tr.arrays,
                      val_data=te.arrays, logger_name="dense_t5", device=device)
    result = trainer.fit()
    return DenseT5Artifacts(params=result.best_params, result=result)


def evaluate(cfg: DenseT5Config, artifacts: DenseT5Artifacts, data=None,
             item_embs: Optional[np.ndarray] = None, user_embs: Optional[np.ndarray] = None,
             device=None) -> Dict[str, float]:
    """Cosine top-k retrieval against the normalised item table
    (`T5/train.py:69-97` / `T5/evaluate.py:45-67`), reported as strict-rank
    Recall/NDCG with the padding column at −1e9; the results-CSV row when
    ``results_csv_path`` is set."""
    dev = resolve_device(device)
    if data is None:
        data = read_interactions(cfg.rec_path)
    items, users = _tables(cfg, item_embs, user_embs, dev)
    te = datasets.build_dense_t5_arrays(data, cfg.max_seq_len, "test")
    model = DenseT5(cfg)
    model.load_state_dict(artifacts.params)
    model.to(dev).eval()
    item_norm = items / torch.clamp(torch.linalg.vector_norm(items, dim=1, keepdim=True),
                                    min=1e-8)

    ranks, valids = [], []
    with torch.no_grad():
        for batch in datasets.iterate_batches(te.arrays, cfg.trainer.eval_batch_size,
                                              shuffle=False):
            b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            seq, mask, _ = _gather_batch(items, users, b)
            _, pred = model(seq, mask)
            scores = pred @ item_norm.T
            scores[:, 0] = -1e9
            tgt = scores.gather(1, b["target_ids"].long()[:, None])
            ranks.append((scores > tgt).sum(dim=1) + 1)
            valids.append(batch["valid"])
    ranks = torch.cat(ranks).cpu().numpy() if ranks else np.zeros(0)
    valids = np.concatenate(valids) if valids else np.zeros(0, bool)
    hits = hit_ndcg_from_ranks(ranks, cfg.topk_list, valids)
    metrics = {}
    for k in cfg.topk_list:  # the reference reports Recall@k (one relevant item: = Hit@k)
        metrics[f"Recall@{k}"] = hits[f"Hit@{k}"]
        metrics[f"NDCG@{k}"] = hits[f"NDCG@{k}"]
    if cfg.trainer.results_csv_path:
        a = cfg.arch
        row = {"task_id": cfg.task_id, "d_model": a.d_model,
               "num_layers": a.num_layers, "dropout_rate": a.dropout_rate,
               "temperature": cfg.temperature, "lr": cfg.trainer.lr,
               "batch_size": cfg.trainer.batch_size, **metrics}
        append_results_csv(cfg.trainer.results_csv_path, row)
    return metrics


def main(cfg: DenseT5Config = DenseT5Config(), device=None):
    artifacts = train(cfg, device=device)
    return evaluate(cfg, artifacts, device=device)

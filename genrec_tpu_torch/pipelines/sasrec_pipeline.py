"""SASRec pipeline of the port: train → evaluate → results CSV.

Counterpart of ``genrec_tpu/pipelines/sasrec_pipeline.py`` (train
`SASRec/train.py:84-220`, evaluate `SASRec/evaluate.py:10-54`) on the port's
single-device ``Trainer``: the losses draw dropout masks and negatives from
the trainer's generator, on the device. Every entry point runs on the card
unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from genrec_tpu_torch.configs import SASRecConfig
from genrec_tpu_torch.data import datasets
from genrec_tpu_torch.data.contracts import InteractionData, read_interactions
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.eval.evaluator import rank_evaluate
from genrec_tpu_torch.models.sasrec import SASRec, eval_loss, train_loss
from genrec_tpu_torch.train.trainer import Trainer, TrainLoopResult
from genrec_tpu_torch.utils.csv_results import append_results_csv


@dataclasses.dataclass
class SASRecArtifacts:
    params: Dict[str, torch.Tensor]  # the best state_dict of models.sasrec.SASRec
    item_num: int
    result: TrainLoopResult


def make_loss_fns(cfg: SASRecConfig, item_num: int):
    """(train loss_fn, validation loss_fn) for the ``Trainer``: each takes
    (model, batch, generator); aux holds ``sum_loss`` and ``valid``."""

    def loss_fn(model, batch, generator):
        loss, valid = train_loss(model, batch["inputs"], batch["targets"], generator, cfg,
                                 item_num, batch_valid=batch["valid"])
        return loss, {"sum_loss": loss * valid, "valid": valid}

    def val_fn(model, batch, generator):
        s, v = eval_loss(model, batch["inputs"], batch["targets"], generator, cfg, item_num,
                         batch_valid=batch["valid"])
        return s / torch.clamp(v, min=1.0), {"sum_loss": s, "valid": v}

    return loss_fn, val_fn


def train(cfg: SASRecConfig, data: Optional[InteractionData] = None,
          device=None) -> SASRecArtifacts:
    device = resolve_device(device)
    if data is None:
        data = read_interactions(cfg.data_path)
    tr = datasets.build_sasrec_arrays(data, cfg.max_len, "train", cfg.min_seq_len)
    te = datasets.build_sasrec_arrays(data, cfg.max_len, "test", cfg.min_seq_len)
    item_num = tr.item_num
    model = SASRec(item_num, cfg, generator=torch.Generator().manual_seed(cfg.trainer.seed))
    loss_fn, val_fn = make_loss_fns(cfg, item_num)
    trainer = Trainer(cfg.trainer, model=model, loss_fn=loss_fn, eval_loss_fn=val_fn,
                      train_data=tr.arrays, val_data=te.arrays, logger_name="sasrec",
                      device=device)
    result = trainer.fit()
    return SASRecArtifacts(params=result.best_params, item_num=item_num, result=result)


@torch.no_grad()
def evaluate(cfg: SASRecConfig, artifacts: SASRecArtifacts,
             data: Optional[InteractionData] = None, device=None) -> Dict[str, float]:
    """Leave-one-out rank evaluation of the best parameters, and the
    results-CSV row when ``results_csv_path`` is set (`SASRec/evaluate.py:10-89`)."""
    dev = resolve_device(device)
    if data is None:
        data = read_interactions(cfg.data_path)
    te = datasets.build_sasrec_arrays(data, cfg.max_len, "test", cfg.min_seq_len)
    model = SASRec(artifacts.item_num, cfg)
    model.load_state_dict(artifacts.params)
    model.to(dev).eval()
    metrics = rank_evaluate(
        lambda batch: model.predict(torch.as_tensor(batch["inputs"], device=dev)),
        datasets.iterate_batches(te.arrays, cfg.trainer.eval_batch_size, shuffle=False),
        cfg.topk_list)
    if cfg.trainer.results_csv_path:
        row = {"task_id": cfg.task_id, "d": cfg.d, "num_blocks": cfg.num_blocks,
               "num_heads": cfg.num_heads, "dropout": cfg.dropout,
               "lr": cfg.trainer.lr, "batch_size": cfg.trainer.batch_size,
               "epochs": cfg.trainer.epochs, "mlp_layer": cfg.mlp_layer,
               "max_len": cfg.max_len, "top_k": cfg.top_k, **metrics}
        append_results_csv(cfg.trainer.results_csv_path, row)
    return metrics


def main(cfg: SASRecConfig = SASRecConfig(), device=None):
    artifacts = train(cfg, device=device)
    return evaluate(cfg, artifacts, device=device)

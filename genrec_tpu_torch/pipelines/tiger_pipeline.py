"""TIGER pipeline of the port: train → beam-search eval → results CSV.

Counterpart of ``genrec_tpu/pipelines/tiger_pipeline.py`` (train
`RQVAE-T5/train.py:62-151`, eval `RQVAE-T5/evaluate.py:12-125`) on the
port's single-device ``Trainer``, with dropout in training and the fused
attention kernels forward and backward. Every entry point runs on the card
unless it is given ``device="cpu"``.

Still to port (ROADMAP Queue 1 items 4 and 5): length buckets and
composite widths (``target_len_buckets`` / ``target_len_composite`` > 1
raise ``ValueError``), multi-device eval.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.data import datasets
from genrec_tpu_torch.data.contracts import read_codes, read_tiger_split
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.ops.metrics_ops import beam_metrics, pos_index_exact_match
from genrec_tpu_torch.train.trainer import Trainer, TrainLoopResult
from genrec_tpu_torch.utils.csv_results import append_results_csv


@dataclasses.dataclass
class TIGERArtifacts:
    params: Dict[str, torch.Tensor]  # the best state_dict of models.tiger.TIGER
    result: TrainLoopResult


def loss_fn(model: TIGER, batch, generator: Optional[torch.Generator]):
    """Token-mean CE of one batch, with padded rows' labels set to -100;
    aux holds ``sum_loss`` (loss · valid tokens) and ``valid``. Dropout
    follows the model's mode (``.train()`` / ``.eval()``)."""
    labels = torch.where(batch["valid"][:, None], batch["labels"], -100)
    loss, _ = model(batch["input_ids"], batch["attention_mask"], labels, generator=generator)
    n_valid = (labels != -100).sum().float()
    return loss, {"sum_loss": loss * n_valid, "valid": n_valid}


def _refuse_bucket_modes(cfg: TIGERConfig) -> None:
    """The reference partitions training by target length on either field
    (`genrec_tpu/pipelines/tiger_pipeline.py:86-92`); training flat instead
    would give other batches and losses for the same config."""
    if cfg.target_len_buckets > 1 or cfg.target_len_composite > 1:
        raise ValueError(
            f"target_len_buckets={cfg.target_len_buckets} and target_len_composite="
            f"{cfg.target_len_composite}: the length-bucket and composite-width modes are "
            "not ported yet (ROADMAP.md Queue 1 item 5); use 1 and 0")


def build_trainer(cfg: TIGERConfig, train_arrays: datasets.TigerArrays,
                  test_arrays: datasets.TigerArrays, device=None) -> Trainer:
    """A TIGER at ``cfg`` with weights drawn from ``cfg.trainer.seed``, and
    its Trainer over the two splits on ``device``."""
    _refuse_bucket_modes(cfg)
    model = TIGER(cfg, generator=torch.Generator().manual_seed(cfg.trainer.seed))
    return Trainer(cfg.trainer, model=model, loss_fn=loss_fn, train_data=train_arrays.arrays,
                   val_data=test_arrays.arrays, logger_name="tiger", device=device)


def train(cfg: TIGERConfig,
          train_arrays: Optional[datasets.TigerArrays] = None,
          test_arrays: Optional[datasets.TigerArrays] = None,
          device=None) -> TIGERArtifacts:
    device = resolve_device(device)
    _refuse_bucket_modes(cfg)
    if train_arrays is None:
        train_arrays = datasets.build_tiger_arrays(
            read_tiger_split(cfg.train_dataset_path), cfg.max_len, cfg.code_dim)
    if test_arrays is None:
        test_arrays = datasets.build_tiger_arrays(
            read_tiger_split(cfg.test_dataset_path), cfg.max_len, cfg.code_dim,
            max_target_items=1)
    result = build_trainer(cfg, train_arrays, test_arrays, device).fit()
    return TIGERArtifacts(params=result.best_params, result=result)


@torch.no_grad()
def _evaluate_device_resident(cfg: TIGERConfig, model: TIGER,
                              test_arrays: datasets.TigerArrays, constraint,
                              actual_beams: int) -> Dict[str, float]:
    """Beam eval on the model's device: the test split is uploaded once,
    each batch is an index gather, and generation, start-strip, pad/trim and
    the first-match exact match run there. Only the (N, beams) hit matrix
    comes back to the host."""
    dev = model.model.shared.weight.device
    ii_dev = torch.as_tensor(test_arrays.input_ids, device=dev)
    am_dev = torch.as_tensor(test_arrays.attention_mask, device=dev)
    lab_dev = torch.as_tensor(test_arrays.labels, device=dev).long()
    n = len(test_arrays.input_ids)
    bsz = cfg.trainer.eval_batch_size
    lab_w = lab_dev.shape[1]
    pos_parts, valid_parts = [], []
    for s in range(0, n, bsz):
        idx = torch.arange(s, s + bsz, device=dev)
        idx = torch.where(idx < n, idx, -1)
        safe = idx.clamp(min=0)
        toks, _ = generate(model, ii_dev[safe], am_dev[safe], num_beams=actual_beams,
                           constraint=constraint)
        preds = toks[:, :, 1:]  # strip decoder-start (RQVAE-T5/utils.py:69)
        gen_w = preds.shape[-1]
        if gen_w < lab_w:
            preds = torch.nn.functional.pad(preds, (0, lab_w - gen_w))
        else:
            preds = preds[:, :, :lab_w]
        pos_parts.append(pos_index_exact_match(preds, lab_dev[safe]))
        valid_parts.append(idx >= 0)
    pos = torch.cat(pos_parts).cpu().numpy()
    valid = torch.cat(valid_parts).cpu().numpy()
    # the reference's mean of batch means (RQVAE-T5/utils.py:83-90) over
    # equal-size batches; here the global mean over the valid rows
    return beam_metrics(pos, cfg.topk_list, valid)


def evaluate(cfg: TIGERConfig, artifacts: TIGERArtifacts,
             test_arrays: Optional[datasets.TigerArrays] = None,
             codes: Optional[np.ndarray] = None, device=None) -> Dict[str, float]:
    """Beam-search eval (`RQVAE-T5/utils.py:44-91` semantics) of the best
    parameters, and the results-CSV row when ``results_csv_path`` is set."""
    dev = resolve_device(device)
    if test_arrays is None:
        test_arrays = datasets.build_tiger_arrays(
            read_tiger_split(cfg.test_dataset_path), cfg.max_len, cfg.code_dim,
            max_target_items=1)
    if codes is None and cfg.constrained_decoding == "trie":
        codes = read_codes(cfg.code_path)
    model = TIGER(cfg)
    model.load_state_dict(artifacts.params)
    model.to(dev).eval()
    constraint = make_constraint(cfg, codes).to(dev)
    actual_beams = max(max(cfg.topk_list), cfg.beam_size)
    metrics = _evaluate_device_resident(cfg, model, test_arrays, constraint, actual_beams)
    if cfg.trainer.results_csv_path:
        a = cfg.arch
        row = {"task_id": cfg.task_id, "num_layers": a.num_layers,
               "num_decoder_layers": a.num_decoder_layers, "d_model": a.d_model,
               "d_ff": a.d_ff, "num_heads": a.num_heads, "d_kv": a.d_kv,
               "dropout_rate": a.dropout_rate, "lr": cfg.trainer.lr,
               "batch_size": cfg.trainer.batch_size, "beam_size": cfg.beam_size,
               "constrained": cfg.constrained_decoding, **metrics}
        append_results_csv(cfg.trainer.results_csv_path, row)
    return metrics


def main(cfg: TIGERConfig = TIGERConfig(), device=None):
    artifacts = train(cfg, device=device)
    return evaluate(cfg, artifacts, device=device)

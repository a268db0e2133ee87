"""TIGER-prefix pipeline of the port: prefix-conditioned train → beam eval.

Counterpart of ``genrec_tpu/pipelines/tiger_prefix_pipeline.py`` (train
`RQVAE-T5-prefix/train.py:87-187`, eval `RQVAE-T5-prefix/evaluate.py:12-95`):
TIGER plus per-sample joins of the three prof_lvl{1,2,3}.h5 embedding sets,
threaded through training and generation. Training runs the port's
``Trainer`` on device-resident arrays, the three (N, 5, bert_dim) prof
arrays included: its shuffled index matrix (seed ``cfg.trainer.seed +
epoch``) and row-0 padding give the batches of the reference's
``iterate_batches`` factories, in the same order. Every entry point runs
on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from genrec_tpu_torch.configs import TIGERConfig, TIGERPrefixConfig
from genrec_tpu_torch.data import datasets
from genrec_tpu_torch.data.contracts import read_codes, read_prof_lvl, read_tiger_split
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.eval.evaluator import beam_evaluate
from genrec_tpu_torch.models import tiger as tiger_mod
from genrec_tpu_torch.models.tiger_prefix import TIGERPrefix, generate
from genrec_tpu_torch.ops.beam_search import ConstraintSpec
from genrec_tpu_torch.train.trainer import Trainer, TrainLoopResult
from genrec_tpu_torch.utils.csv_results import append_results_csv


@dataclasses.dataclass
class TIGERPrefixArtifacts:
    params: Dict[str, torch.Tensor]  # the best state_dict of models.tiger_prefix.TIGERPrefix
    result: TrainLoopResult


def make_constraint(cfg: TIGERPrefixConfig, codes=None) -> ConstraintSpec:
    """TIGER's `make_constraint` tables (the same token space), on the CPU."""
    proxy = TIGERConfig(arch=cfg.arch, codebook_size=cfg.codebook_size,
                        max_gen_len=cfg.max_gen_len,
                        constrained_decoding=cfg.constrained_decoding)
    return tiger_mod.make_constraint(proxy, codes)


def attach_prof(arrays: datasets.TigerArrays, prof_paths_or_data) -> Dict[str, np.ndarray]:
    """Join prof_lvl{1,2,3} embeddings by user id into the batch arrays;
    each source is a prof_lvl*.h5 path or a (user_ids, embs) pair."""
    out = dict(arrays.arrays)
    for i, src in enumerate(prof_paths_or_data):
        uids, embs = read_prof_lvl(src) if isinstance(src, str) else src
        out[f"prof_lvl{i + 1}"] = datasets.join_prof_embs(arrays.user_ids, uids, embs)
    return out


def loss_fn(model: TIGERPrefix, batch, generator: Optional[torch.Generator]):
    """Token-mean CE of one batch, padded rows' labels set to -100; aux holds
    ``sum_loss`` (loss · valid tokens) and ``valid``. Dropout follows the
    model's mode (the reference's train and eval loss functions)."""
    labels = torch.where(batch["valid"][:, None], batch["labels"], -100)
    loss, _ = model(batch["input_ids"], batch["attention_mask"], labels, batch["prof_lvl1"],
                    batch["prof_lvl2"], batch["prof_lvl3"], generator=generator)
    n_valid = (labels != -100).sum().float()
    return loss, {"sum_loss": loss * n_valid, "valid": n_valid}


def build_model(cfg: TIGERPrefixConfig) -> TIGERPrefix:
    """A TIGERPrefix with weights drawn from ``cfg.trainer.seed``."""
    return TIGERPrefix(cfg, generator=torch.Generator().manual_seed(cfg.trainer.seed))


def _split(cfg: TIGERPrefixConfig, path: str, test: bool) -> Dict[str, np.ndarray]:
    arrays = datasets.build_tiger_arrays(read_tiger_split(path), cfg.max_len, cfg.code_dim,
                                         max_target_items=1 if test else None)
    return attach_prof(arrays, cfg.prof_lvl_paths)


def train(cfg: TIGERPrefixConfig, train_data: Optional[Dict[str, np.ndarray]] = None,
          test_data: Optional[Dict[str, np.ndarray]] = None,
          device=None) -> TIGERPrefixArtifacts:
    device = resolve_device(device)
    if train_data is None:
        train_data = _split(cfg, cfg.train_dataset_path, test=False)
    if test_data is None:
        test_data = _split(cfg, cfg.test_dataset_path, test=True)
    trainer = Trainer(cfg.trainer, model=build_model(cfg), loss_fn=loss_fn,
                      train_data=train_data, val_data=test_data, logger_name="tiger_prefix",
                      device=device)
    result = trainer.fit()
    return TIGERPrefixArtifacts(params=result.best_params, result=result)


def evaluate(cfg: TIGERPrefixConfig, artifacts: TIGERPrefixArtifacts,
             test_data: Optional[Dict[str, np.ndarray]] = None,
             codes: Optional[np.ndarray] = None, device=None) -> Dict[str, float]:
    """Beam-search eval (`RQVAE-T5-prefix/evaluate.py:12-95`) of the best
    parameters with max(topk_list ∪ {beam_size}) beams, and the results-CSV
    row when ``results_csv_path`` is set."""
    dev = resolve_device(device)
    if test_data is None:
        test_data = _split(cfg, cfg.test_dataset_path, test=True)
    if codes is None and cfg.constrained_decoding == "trie":
        codes = read_codes(cfg.code_path)
    model = TIGERPrefix(cfg)
    model.load_state_dict(artifacts.params)
    model.to(dev).eval()
    constraint = make_constraint(cfg, codes).to(dev)

    def generate_fn(batch, num_beams):
        toks, _ = generate(model, batch["input_ids"], batch["attention_mask"],
                           batch["prof_lvl1"], batch["prof_lvl2"], batch["prof_lvl3"],
                           num_beams=num_beams, constraint=constraint)
        return toks

    metrics = beam_evaluate(
        generate_fn,
        datasets.iterate_batches(test_data, cfg.trainer.eval_batch_size, shuffle=False),
        cfg.topk_list, cfg.beam_size)
    if cfg.trainer.results_csv_path:
        a = cfg.arch
        row = {"task_id": cfg.task_id, "d_model": a.d_model,
               "num_decoder_layers": a.num_decoder_layers, "num_heads": a.num_heads,
               "lr": cfg.trainer.lr, "batch_size": cfg.trainer.batch_size,
               "beam_size": cfg.beam_size, "constrained": cfg.constrained_decoding,
               **metrics}
        append_results_csv(cfg.trainer.results_csv_path, row)
    return metrics


def main(cfg: TIGERPrefixConfig = TIGERPrefixConfig(), device=None):
    artifacts = train(cfg, device=device)
    return evaluate(cfg, artifacts, device=device)

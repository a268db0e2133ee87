"""General runners, one per traffic kind: each reads a cell's configuration
and traffic parameters, builds the program under test from them, runs its
set-up, the measured window and the check, and returns a :class:`Run`."""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Run:
    setup_s: float
    window: dict                       # what the window ran and how long it took
    spans: Dict[str, List[float]]      # host spans of the window, seconds
    trace: Optional[dict]              # the profiled stretch's reading (traced runs)
    numbers: Dict[str, float]          # the correctness check's numbers
    notes: List[str]                   # lines for standard error
    attempted: int
    failed: int
    memory_peak_bytes: int


def program_config(cfg: dict, batch: int, ckpt_dir: str):
    """The program's configuration object for ``cfg`` at ``batch``."""
    from genrec_tpu_torch import configs as C

    arch = C.T5ArchConfig(**cfg["arch"])
    tr = cfg["trainer"]
    trainer = C.TrainerConfig(batch_size=batch, eval_batch_size=batch, lr=tr["lr"],
                              adam_betas=tuple(tr["adam_betas"]), optimizer=tr["optimizer"],
                              epochs=tr["epochs"], ckpt_dir=ckpt_dir)
    common = dict(arch=arch, codebook_size=cfg["codebook_size"], code_dim=cfg["code_dim"],
                  max_len=cfg["max_len"], max_gen_len=cfg["max_gen_len"],
                  beam_size=cfg["beam_size"], topk_list=tuple(cfg["topk_list"]),
                  constrained_decoding=cfg["constrained_decoding"], trainer=trainer)
    if cfg["model"] == "tiger_prefix":
        return C.TIGERPrefixConfig(bert_dim=cfg["bert_dim"],
                                   num_prof_vectors=cfg["num_prof_vectors"], **common)
    return C.TIGERConfig(**common)


def program_model(cfg: dict, pcfg, weights: Dict[str, torch.Tensor], device):
    """The program's model for ``cfg`` on ``device``, holding ``weights``
    (built as the pipelines build it, on the host, then moved)."""
    if cfg["model"] == "tiger_prefix":
        from genrec_tpu_torch.models.tiger_prefix import TIGERPrefix as cls
    else:
        from genrec_tpu_torch.models.tiger import TIGER as cls
    model = cls(pcfg).to(device)
    model.load_state_dict(weights, strict=True)
    return model


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def quiet_window():
    """Collect now, then keep the collector out of the window."""
    gc.collect()
    gc.disable()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" \
        else 0


def free(device) -> None:
    gc.enable()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

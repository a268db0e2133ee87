"""Trained-model recommend functions of the port.

Counterpart of ``genrec_tpu/serving/model_fn.py``'s ``tiger_model_fn``:
load the best checkpoint and return a plain ``fn(history_ids, top_k) ->
[item_id]``. The other recommend functions and the route table come with
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.data import tiger_tokens
from genrec_tpu_torch.data.contracts import read_codes
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.train.checkpoint import restore_best


def tiger_model_fn(ckpt_dir: str, codes_path: str, cfg: Optional[TIGERConfig] = None,
                   device=None) -> Optional[Callable[[List[int], int], List[int]]]:
    """Serve the best TIGER checkpoint of ``ckpt_dir`` by generative retrieval.

    History item ids map to their semantic-ID tokens, left-padded to
    ``max_len * code_dim`` tokens; the beam decodes with the TRIE
    constraint over the item code table at ``max(beam_size, 20, max_len)``
    beams, so every decoded tuple is a real item; the tuples map back to
    item ids best-first, without duplicates and without the history.
    Returns None when no best checkpoint exists.
    """
    dev = resolve_device(device)
    cfg = cfg or TIGERConfig(code_path=codes_path)
    codes = read_codes(codes_path)                      # (N_items+1, 4)
    token_table = tiger_tokens.codes_to_token_table(codes, cfg.codebook_size)
    tup2item = {tuple(map(int, token_table[i])): i for i in range(1, len(token_table))}
    state = restore_best(ckpt_dir)
    if state is None:
        return None
    model = TIGER(cfg)
    model.load_state_dict(state)
    model.to(dev).eval()
    seq = cfg.max_len * cfg.code_dim
    constraint = make_constraint(
        dataclasses.replace(cfg, constrained_decoding="trie"), codes).to(dev)
    beams = max(cfg.beam_size, 20, cfg.max_len)  # headroom over history dedup

    def fn(history: List[int], top_k: int) -> List[int]:
        ids = [int(i) for i in history if 0 < int(i) < len(token_table)][-cfg.max_len:]
        ii = np.zeros((1, seq), np.int64)
        if ids:
            toks = token_table[np.asarray(ids, np.int64)].reshape(-1)
            ii[0, seq - len(toks):] = toks
        am = (ii != 0).astype(np.int32)
        tokens, _scores = generate(model, torch.from_numpy(ii), torch.from_numpy(am),
                                   num_beams=beams, constraint=constraint)
        out: List[int] = []
        hist = set(ids)
        for beam in tokens[0].cpu().numpy():          # best-first
            item = tup2item.get(tuple(map(int, beam[1:1 + cfg.code_dim])))
            if item is not None and item not in hist and item not in out:
                out.append(int(item))
            if len(out) >= int(top_k):
                break
        return out

    return fn

"""Trained-model recommend functions of the port.

Counterpart of ``genrec_tpu/serving/model_fn.py``'s ``sasrec_model_fn``,
``tiger_model_fn`` and ``dense_t5_model_fn``: load the best checkpoint and
return a plain ``fn(history_ids, top_k) -> [item_id]``, which
``cli.make_context`` wires to ``/api/v1/recommend/model``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from genrec_tpu_torch.configs import DenseT5Config, SASRecConfig, TIGERConfig
from genrec_tpu_torch.data import tiger_tokens
from genrec_tpu_torch.data.contracts import (InteractionData, read_codes, read_interactions,
                                             read_item_embs)
from genrec_tpu_torch.device import resolve_device
from genrec_tpu_torch.models.dense_t5 import DenseT5
from genrec_tpu_torch.models.sasrec import SASRec
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.train.checkpoint import restore_best


def sasrec_model_fn(ckpt_dir: str, data: Union[str, InteractionData],
                    cfg: Optional[SASRecConfig] = None,
                    device=None) -> Optional[Callable[[List[int], int], List[int]]]:
    """Serve the best SASRec checkpoint of ``ckpt_dir``.

    ``data``, the training interactions (the H5 path or an
    ``InteractionData``), fixes the item-id space: the checkpoint's table rows
    are the dense 1-based ids of that corpus, so its size is derived as
    training derived it. ``cfg`` must match the training config. Returns None
    when no best checkpoint exists.

    The returned fn left-pads or truncates the history to ``cfg.max_len``,
    scores the full vocabulary with ``SASRec.predict`` and returns the top-k
    item ids, without the padding row and without the history itself
    (leave-one-out serving semantics, `SASRec/evaluate.py:27-37`).
    """
    dev = resolve_device(device)
    if isinstance(data, str):
        cfg = cfg or SASRecConfig(data_path=data)
        data = read_interactions(data)
    cfg = cfg or SASRecConfig()
    item_num = data.max_item_id
    state = restore_best(ckpt_dir)
    if state is None:
        return None
    model = SASRec(item_num, cfg)
    model.load_state_dict(state)
    model.to(dev).eval()

    @torch.no_grad()
    def fn(history: List[int], top_k: int) -> List[int]:
        ids = [int(i) for i in history if 0 < int(i) <= item_num][-cfg.max_len:]
        seq = np.zeros((1, cfg.max_len), np.int64)
        if ids:
            seq[0, cfg.max_len - len(ids):] = ids
        logits = model.predict(torch.from_numpy(seq).to(dev))[0].cpu().numpy().copy()
        logits[0] = -np.inf                            # padding row
        logits[np.asarray(ids, np.int64)] = -np.inf   # rated exclusion
        k = min(int(top_k), item_num)
        return [int(t) for t in np.argsort(-logits)[:k]]

    return fn


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


def dense_t5_model_fn(ckpt_dir: str, item_emb_h5: Union[str, np.ndarray],
                      cfg: Optional[DenseT5Config] = None,
                      user_emb: Optional[np.ndarray] = None,
                      device=None) -> Optional[Callable[[List[int], int], List[int]]]:
    """Serve the best DenseT5 checkpoint of ``ckpt_dir`` by encoder retrieval.

    ``item_emb_h5`` is the item-embedding file or its (N_items + 1, D) table
    (row 0 padding). History item ids in (0, n_items], the last
    ``cfg.max_seq_len`` of them, gather their embeddings (right-padded,
    `T5/data_vision.py:131-154` layout) after the position-0 profile
    embedding: ``user_emb``, or zeros (a cold profile; the route carries
    history only). The encoder gives one query vector; its cosine scores
    against the normalised item table, with the padding row at −1e9 and the
    history at −inf, give the top ``min(top_k, n_items)`` items. Returns None
    when no best checkpoint exists.
    """
    dev = resolve_device(device)
    if isinstance(item_emb_h5, str):
        cfg = cfg or DenseT5Config(item_emb_h5_path=item_emb_h5)
        item_embs, _ = read_item_embs(item_emb_h5)
    else:
        item_embs = item_emb_h5
    cfg = cfg or DenseT5Config()
    item_embs = np.asarray(item_embs, np.float32)
    n_items = len(item_embs) - 1                     # row 0 = padding
    state = restore_best(ckpt_dir)
    if state is None:
        return None
    model = DenseT5(cfg)
    model.load_state_dict(state)
    model.to(dev).eval()
    norms = np.linalg.norm(item_embs, axis=1, keepdims=True)
    item_norm = torch.from_numpy(item_embs / np.maximum(norms, 1e-8)).to(dev)
    L = cfg.max_seq_len
    prof = (np.zeros((cfg.input_emb_dim,), np.float32)
            if user_emb is None else np.asarray(user_emb, np.float32))

    @torch.no_grad()
    def fn(history: List[int], top_k: int) -> List[int]:
        ids = [int(i) for i in history if 0 < int(i) <= n_items][-L:]
        seq = np.zeros((1, L + 1, cfg.input_emb_dim), np.float32)
        seq[0, 0] = prof
        if ids:
            seq[0, 1:1 + len(ids)] = item_embs[np.asarray(ids, np.int64)]
        mask = (np.arange(L + 1)[None, :] <= len(ids)).astype(np.int32)
        _, pred = model(torch.from_numpy(seq).to(dev), torch.from_numpy(mask).to(dev))
        scores = (pred @ item_norm.T)[0]
        scores[0] = -1e9
        scores = scores.cpu().numpy()
        scores[np.asarray(ids, np.int64)] = -np.inf  # rated exclusion
        k = min(int(top_k), n_items)
        return [int(t) for t in np.argsort(-scores)[:k]]

    return fn

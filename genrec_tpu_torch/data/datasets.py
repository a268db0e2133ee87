"""Fixed-shape SASRec, TIGER and DenseT5 arrays and batch iterators: copies
of ``genrec_tpu/data/datasets.py``'s ``SASRecArrays``,
``build_sasrec_arrays``, ``build_tiger_arrays`` and
``build_dense_t5_arrays`` (their Python paths, not the native packer),
``TigerArrays``, ``DenseT5Arrays``, ``num_batches``, ``iterate_batches`` and
``join_prof_embs``.

SASRec train rows: input = seq[:-1], target = seq[1:], the last ``max_len``
kept, left-padded with 0; test rows: leave-one-out (input = seq[:-1],
target = seq[-1]) (`SASRec/data_vision.py:51-87`). TIGER histories are
left-padded with [0]*code_dim to ``max_len`` items
(`RQVAE-T5/data_vision.py:33-55`), labels padded with -100, attention
mask = (token != 0). DenseT5 samples are item ids, right-padded with 0
(`T5/data_vision.py:87-117`). Every batch has a static shape; the last
partial batch is padded and flagged by a ``valid`` mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from genrec_tpu_torch.data.contracts import InteractionData, TigerSplit

Batch = Dict[str, np.ndarray]


def iterate_batches(arrays: Batch, batch_size: int, *, shuffle: bool,
                    seed: int = 0, drop_last: bool = False) -> Iterator[Batch]:
    """Yield fixed-shape batches; the final partial batch is zero-padded and
    flagged via a ``valid`` bool mask."""
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for start in range(0, n, batch_size):
        sel = idx[start:start + batch_size]
        pad = batch_size - len(sel)
        if pad > 0 and drop_last:
            break
        valid = np.ones(batch_size, dtype=bool)
        if pad > 0:
            valid[len(sel):] = False
            sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
        batch = {k: v[sel] for k, v in arrays.items()}
        batch["valid"] = valid
        yield batch


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


@dataclasses.dataclass
class SASRecArrays:
    """Materialized fixed-shape SASRec split."""

    inputs: np.ndarray    # (N, max_len) int32, pre-padded with 0
    targets: np.ndarray   # train: (N, max_len); test: (N,) int32
    item_num: int         # max item id over the corpus (SASRec/data_vision.py:38)

    @property
    def arrays(self) -> Batch:
        return {"inputs": self.inputs, "targets": self.targets}


def build_sasrec_arrays(data: InteractionData, max_len: int, mode: str,
                        min_seq_len: int = 3) -> SASRecArrays:
    """The train or test split of the sequences with at least ``min_seq_len`` items."""
    inputs: List[np.ndarray] = []
    targets: List = []
    for seq in data.item_id_lists:
        seq = np.asarray(seq, dtype=np.int64)
        if len(seq) < min_seq_len:
            continue
        if mode == "train":
            raw_in = seq[:-1][-max_len:]
            raw_tg = seq[1:][-max_len:]
            pad = max_len - len(raw_in)
            inputs.append(np.concatenate([np.zeros(pad, np.int64), raw_in]))
            targets.append(np.concatenate([np.zeros(pad, np.int64), raw_tg]))
        elif mode == "test":
            if len(seq) < 2:
                inputs.append(np.zeros(max_len, np.int64))
                targets.append(0)
                continue
            raw_in = seq[:-1][-max_len:]
            pad = max_len - len(raw_in)
            inputs.append(np.concatenate([np.zeros(pad, np.int64), raw_in]))
            targets.append(int(seq[-1]))
        else:
            raise ValueError(mode)
    return SASRecArrays(
        inputs=np.stack(inputs).astype(np.int32),
        targets=(np.stack(targets).astype(np.int32) if mode == "train"
                 else np.asarray(targets, dtype=np.int32)),
        item_num=data.max_item_id,
    )


@dataclasses.dataclass
class TigerArrays:
    """Materialized fixed-shape TIGER split.

    ``input_ids`` (N, max_len*code_dim), ``attention_mask`` likewise,
    ``labels`` (N, max_target_len) with -100 padding, ``user_ids`` (N,).
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    labels: np.ndarray
    user_ids: np.ndarray

    @property
    def arrays(self) -> Batch:
        return {"input_ids": self.input_ids, "attention_mask": self.attention_mask,
                "labels": self.labels, "user_ids": self.user_ids}


def build_tiger_arrays(split: TigerSplit, max_len: int, code_dim: int = 4,
                       pad_token: int = 0,
                       max_target_items: Optional[int] = None) -> TigerArrays:
    """Pad/truncate histories to ``max_len`` items (left pad, keep the most
    recent), flatten to tokens; pad flat targets with -100 to a fixed width.

    ``max_target_items`` defaults to the longest target in the split (the
    teacher-forcing train width); eval splits pass 1.
    """
    seq_tokens = max_len * code_dim
    n = len(split.histories)
    if max_target_items is None:
        longest = max((len(t) for t in split.targets), default=code_dim) // code_dim
        max_target_items = max(1, longest)
    tgt_tokens = max_target_items * code_dim

    input_ids = np.zeros((n, seq_tokens), dtype=np.int32)
    labels = np.full((n, tgt_tokens), -100, dtype=np.int32)
    for i, (hist, tgt) in enumerate(zip(split.histories, split.targets)):
        hist = np.asarray(hist, dtype=np.int32)
        n_items = len(hist) // code_dim
        if n_items > max_len:  # truncate: keep most recent
            hist = hist[-seq_tokens:]
            n_items = max_len
        input_ids[i, seq_tokens - n_items * code_dim:] = hist
        tgt = np.asarray(tgt, dtype=np.int32)[:tgt_tokens]
        labels[i, :len(tgt)] = tgt
    attention_mask = (input_ids != pad_token).astype(np.int32)
    return TigerArrays(input_ids, attention_mask, labels,
                       np.asarray(split.user_ids, dtype=np.int32))


def join_prof_embs(user_ids: np.ndarray, prof_user_ids: np.ndarray,
                   prof_embs: np.ndarray) -> np.ndarray:
    """Per-sample join of prof_lvl embeddings by user id.

    Mirrors `RQVAE-T5-prefix/data_vision.py:104-119` (dict lookup by user_id;
    zeros for missing users).
    """
    lut = np.zeros(int(max(prof_user_ids.max(), user_ids.max())) + 1, dtype=np.int64) - 1
    lut[prof_user_ids] = np.arange(len(prof_user_ids))
    rows = lut[user_ids]
    out = np.zeros((len(user_ids),) + prof_embs.shape[1:], dtype=prof_embs.dtype)
    found = rows >= 0
    out[found] = prof_embs[rows[found]]
    return out


@dataclasses.dataclass
class DenseT5Arrays:
    """Sliding-window dense-retrieval samples, stored as item ids (the
    embeddings are gathered on the device at step time)."""

    history_ids: np.ndarray  # (N, max_seq_len) int32, right-padded with 0
    seq_lens: np.ndarray     # (N,) int32 — history length (excl. user emb)
    target_ids: np.ndarray   # (N,) int32
    user_ids: np.ndarray     # (N,) int32

    @property
    def arrays(self) -> Batch:
        return {"history_ids": self.history_ids, "seq_lens": self.seq_lens,
                "target_ids": self.target_ids, "user_ids": self.user_ids}


def build_dense_t5_arrays(data: InteractionData, max_seq_len: int, mode: str,
                          min_seq_len: int = 2) -> DenseT5Arrays:
    """Sliding-window (train) / leave-one-out (test) samples.

    Matches `T5/data_vision.py:87-117`: train targets range over positions
    1..n-2 (the last item is test-only), histories keep the most recent
    ``max_seq_len`` items, right-padded here (mask built at batch time).
    """
    hist_rows: List[np.ndarray] = []
    lens: List[int] = []
    tgts: List[int] = []
    uids: List[int] = []
    for uid, seq in zip(data.user_ids, data.item_id_lists):
        seq = list(np.asarray(seq, dtype=np.int64))
        if len(seq) < min_seq_len:
            continue
        if mode == "train":
            end_idx = len(seq) - 2
            for i in range(1, end_idx + 1):
                h = seq[max(0, i - max_seq_len):i]
                row = np.zeros(max_seq_len, np.int32)
                row[:len(h)] = h
                hist_rows.append(row)
                lens.append(len(h))
                tgts.append(int(seq[i]))
                uids.append(int(uid))
        elif mode == "test":
            h = seq[max(0, len(seq) - 1 - max_seq_len):len(seq) - 1]
            row = np.zeros(max_seq_len, np.int32)
            row[:len(h)] = h
            hist_rows.append(row)
            lens.append(len(h))
            tgts.append(int(seq[-1]))
            uids.append(int(uid))
        else:
            raise ValueError(mode)
    return DenseT5Arrays(
        history_ids=np.stack(hist_rows) if hist_rows else np.zeros((0, max_seq_len), np.int32),
        seq_lens=np.asarray(lens, dtype=np.int32),
        target_ids=np.asarray(tgts, dtype=np.int32),
        user_ids=np.asarray(uids, dtype=np.int32),
    )

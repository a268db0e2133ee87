"""Fixed-shape SASRec, TIGER and DenseT5 arrays and batch iterators: copies
of ``genrec_tpu/data/datasets.py``'s ``SASRecArrays``,
``build_sasrec_arrays``, ``build_tiger_arrays`` and
``build_dense_t5_arrays`` (each on the port's native packer,
``data/native_packer.py``, when it is available, else on its Python path,
with bit-identical arrays), ``TigerArrays``, ``DenseT5Arrays``,
``num_batches``, ``iterate_batches``, ``join_prof_embs`` and the TIGER
length partitions ``bucket_by_target_len`` and ``target_len_widths``.

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
                        min_seq_len: int = 3,
                        use_native: Optional[bool] = None) -> SASRecArrays:
    """The train or test split of the sequences with at least ``min_seq_len``
    items; ``use_native`` None packs natively when the packer is available."""
    from genrec_tpu_torch.data import native_packer
    if use_native is None:
        use_native = native_packer.available()
    if use_native:
        kept = [np.asarray(s, np.int32) for s in data.item_id_lists
                if len(s) >= min_seq_len]
        inputs_n, targets_n = native_packer.pack_sasrec(kept, max_len, mode)
        return SASRecArrays(inputs=inputs_n, targets=targets_n, item_num=data.max_item_id)
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
                       max_target_items: Optional[int] = None,
                       use_native: Optional[bool] = None) -> TigerArrays:
    """Pad/truncate histories to ``max_len`` items (left pad, keep the most
    recent), flatten to tokens; pad flat targets with -100 to a fixed width.

    ``max_target_items`` defaults to the longest target in the split (the
    teacher-forcing train width); eval splits pass 1. ``use_native`` None
    packs natively when the packer is available, and only at ``pad_token``
    0, as the reference does.
    """
    seq_tokens = max_len * code_dim
    n = len(split.histories)
    if max_target_items is None:
        longest = max((len(t) for t in split.targets), default=code_dim) // code_dim
        max_target_items = max(1, longest)
    tgt_tokens = max_target_items * code_dim

    from genrec_tpu_torch.data import native_packer
    if use_native is None:
        use_native = native_packer.available()
    if use_native and pad_token == 0:
        input_ids, attention_mask, labels = native_packer.pack_tiger(
            [np.asarray(h, np.int32) for h in split.histories],
            [np.asarray(t, np.int32) for t in split.targets],
            max_len, code_dim, tgt_tokens)
        return TigerArrays(input_ids, attention_mask, labels,
                           np.asarray(split.user_ids, dtype=np.int32))

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


def bucket_by_target_len(arrays: Dict[str, np.ndarray], n_buckets: int,
                         code_dim: int = 4,
                         label_key: str = "labels") -> List[Dict[str, np.ndarray]]:
    """Partition a TIGER-style data dict into length buckets on the
    teacher-forcing target width.

    The reference DataLoader pads each batch to its max target length
    (`RQVAE-T5/data_vision.py` collate); static shapes pad to the corpus max
    instead. Bucketing restores most of the per-batch-max economy with a
    handful of shapes: boundaries sit at target-length quantiles (rounded up
    to whole items), every bucket's labels are sliced to its own width, and
    the Trainer runs each bucket's batches at that width
    (``train_data_buckets``).

    Returns 1..n_buckets dicts (empty buckets are dropped); with
    n_buckets=1 this is the identity partition.
    """
    labels = arrays[label_key]
    lens = (labels != -100).sum(axis=1)
    widths = _quantile_widths(lens, n_buckets, code_dim)
    buckets = []
    lower = -1
    for w in widths:
        sel = (lens > lower) & (lens <= w)
        lower = w
        if not sel.any():
            continue
        d = {k: v[sel] for k, v in arrays.items()}
        d[label_key] = d[label_key][:, :w]
        buckets.append(d)
    return buckets


def _quantile_widths(lens: np.ndarray, n_buckets: int,
                     code_dim: int) -> List[int]:
    """Ascending static widths at target-length quantiles, rounded up to
    whole items; the 1.0-quantile makes the top width cover lens.max().
    Shared by bucket_by_target_len and target_len_widths so the two
    modes partition on identical boundaries by construction."""
    qs = np.quantile(lens, [(i + 1) / n_buckets for i in range(n_buckets)])
    return sorted({int(np.ceil(q / code_dim) * code_dim) for q in qs})


def target_len_widths(arrays: Dict[str, np.ndarray], n_buckets: int,
                      code_dim: int = 4, label_key: str = "labels"):
    """(row_widths, widths) for the Trainer's composite width mode: the
    same quantile boundaries as :func:`bucket_by_target_len`, but the data
    stays one flat full-width dict; each epoch assigns rows to static-width
    batch groups, letting shorter rows ride in wider batches (see
    ``TrainerConfig.composite_mix``)."""
    labels = arrays[label_key]
    lens = (labels != -100).sum(axis=1)
    widths = _quantile_widths(lens, n_buckets, code_dim)
    row_widths = np.ceil(lens / code_dim).astype(np.int64) * code_dim
    return row_widths, widths


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
                          min_seq_len: int = 2,
                          use_native: Optional[bool] = None) -> DenseT5Arrays:
    """Sliding-window (train) / leave-one-out (test) samples.

    Matches `T5/data_vision.py:87-117`: train targets range over positions
    1..n-2 (the last item is test-only), histories keep the most recent
    ``max_seq_len`` items, right-padded here (mask built at batch time).
    ``use_native`` None packs natively when the packer is available, and
    only in train mode, as the reference does.
    """
    from genrec_tpu_torch.data import native_packer
    if use_native is None:
        use_native = native_packer.available()
    if use_native and mode == "train":
        hist, lens_n, tgt_n, uid_n = native_packer.pack_dense_t5_train(
            [np.asarray(s, np.int32) for s in data.item_id_lists],
            np.asarray(data.user_ids, np.int32), max_seq_len, min_seq_len)
        return DenseT5Arrays(history_ids=hist, seq_lens=lens_n,
                             target_ids=tgt_n, user_ids=uid_n)
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

"""The benchmark's inputs, made from ``--seed``: the synthetic TIGER corpus,
its semantic-ID table and its token arrays, and the large random tensors
(weights, BERT vectors) drawn on the device.

The corpus follows the program's own synthetic generator
(``genrec_tpu_torch/data/synthetic.py`` ``make_interactions`` and
``make_codes``, copied here and vectorised, so that the yardstick stays
fixed when the program changes): items 1..N in topics, Zipf popularity in
a topic, a sticky Markov walk over topics per student. One change: the
students' sequence lengths are the same multiset for every seed (the range
``min_items..max_items`` repeated, in a seeded order), so that every seed
gives the same number of real tokens and the same work. Token arrays follow
``RQVAE-T5/data_read.ipynb``: token = code + level·K + 1; a history is the
most recent ``max_len`` items, left-padded with 0; the training split of
a sequence s_1..s_n is (s_1..s_{n-2} → s_2..s_{n-1}) and its serving
history is s_1..s_{n-1}.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def derived_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream ``tag`` of ``--seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, tag])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, tag))


def make_codes(r: np.random.Generator, num_items: int, K: int, levels: int) -> np.ndarray:
    """(num_items + 1, levels + 1) semantic IDs, row 0 the padding item; the
    last digit tells apart items whose level codes collide."""
    codes = r.integers(0, K, size=(num_items + 1, levels)).astype(np.int64)
    _, inv = np.unique(codes, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")
    first = np.searchsorted(inv[order], inv[order], side="left")
    dup = np.empty_like(inv)
    dup[order] = np.arange(len(inv)) - first
    return np.concatenate([codes, dup[:, None]], axis=1)


def make_sequences(r: np.random.Generator, n: int, t: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(items (n, max_items) int64, lengths (n,)): each student's item
    sequence, valid up to its length."""
    num_items, topics = t["items"], t["num_topics"]
    lo, hi = t["min_items"], t["max_items"]
    item_topic = r.integers(0, topics, size=num_items + 1)
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    pop = pop[r.permutation(num_items)]
    members = [np.where(item_topic[1:] == k)[0] + 1 for k in range(topics)]
    members = [m if len(m) else np.arange(1, num_items + 1) for m in members]
    width = max(len(m) for m in members)
    items_rect = np.zeros((topics, width), dtype=np.int64)
    cum_rect = np.ones((topics, width), dtype=np.float64)
    for k, m in enumerate(members):
        w = pop[m - 1]
        items_rect[k, :len(m)] = m
        items_rect[k, len(m):] = m[-1]
        cum_rect[k, :len(m)] = np.cumsum(w / w.sum())
    lengths = r.permutation(np.resize(np.arange(lo, hi + 1), n))
    topic = r.integers(0, topics, size=n)
    out = np.zeros((n, hi), dtype=np.int64)
    for i in range(hi):
        switch = r.random(n) > t["topic_stickiness"]
        topic = np.where(switch, r.integers(0, topics, size=n), topic)
        u = r.random(n)
        col = np.minimum((u[:, None] > cum_rect[topic]).sum(axis=1), width - 1)
        out[:, i] = items_rect[topic, col]
    return out, lengths


def _tokens(codes: np.ndarray, K: int) -> np.ndarray:
    return (codes + np.arange(codes.shape[1]) * K + 1).astype(np.int32)


def _history(tok: np.ndarray, end: np.ndarray, max_len: int) -> np.ndarray:
    """(n, max_len·code_dim) tokens of items [end - max_len, end), left-padded."""
    n, _, dim = tok.shape
    src = end[:, None] - max_len + np.arange(max_len)[None, :]
    ok = src >= 0
    picked = tok[np.arange(n)[:, None], np.clip(src, 0, None)]
    return np.where(ok[..., None], picked, 0).reshape(n, max_len * dim).astype(np.int32)


def train_arrays(seed: int, cfg: dict, t: dict) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The training split of ``t["students"]`` sequences, as the pipeline's
    arrays (input_ids, attention_mask, labels), and the code table."""
    r = rng(seed, 1)
    K, dim = cfg["codebook_size"], cfg["code_dim"]
    codes = make_codes(r, t["items"], K, dim - 1)
    items, lengths = make_sequences(r, t["students"], t)
    tok = _tokens(codes, K)[items]                     # (n, max_items, dim)
    ids = _history(tok, lengths - 2, cfg["max_len"])
    width = (t["max_items"] - 2) * dim
    n_tgt = (lengths - 2) * dim
    flat = tok[:, 1:t["max_items"] - 1].reshape(len(items), -1)
    labels = np.where(np.arange(width)[None, :] < n_tgt[:, None], flat, -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "labels": labels}, codes


def serving_histories(seed: int, cfg: dict, t: dict) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The serving histories of ``t["pool"]`` students (input_ids,
    attention_mask), and the code table."""
    r = rng(seed, 1)
    K, dim = cfg["codebook_size"], cfg["code_dim"]
    codes = make_codes(r, t["items"], K, dim - 1)
    items, lengths = make_sequences(r, t["pool"], t)
    ids = _history(_tokens(codes, K)[items], lengths - 1, cfg["max_len"])
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}, codes


def device_normal(seed: int, tag: int, shape, device) -> torch.Tensor:
    """A standard normal draw of ``shape`` in one call, on ``device``."""
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, tag))
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def prof_vectors(seed: int, cfg: dict, n: int, device) -> Dict[str, np.ndarray]:
    """The three levels' major vectors (n, num_prof_vectors, bert_dim) of each
    student, N(0, 0.5²) as ``make_prof_embs`` draws them, in host memory."""
    x = device_normal(seed, 2, (3, n, cfg["num_prof_vectors"], cfg["bert_dim"]), device)
    x = (x * 0.5).cpu().numpy()
    return {f"prof_lvl{i + 1}": x[i] for i in range(3)}


def make_weights(seed: int, spec, device) -> Dict[str, torch.Tensor]:
    """The model's weights from one normal draw on ``device``, each leaf
    scaled by its initialiser's deviation (ones and zeros as stated)."""
    sizes = [int(np.prod(shape)) for _, shape, init in spec if init[0] == "normal"]
    flat = device_normal(seed, 3, (sum(sizes),), device)
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            k = int(np.prod(shape))
            out[name] = (flat[at:at + k] * init[1]).view(shape)
            at += k
        elif init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out

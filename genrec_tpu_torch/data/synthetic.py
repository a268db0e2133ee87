"""Synthetic corpora, embeddings and semantic-ID tables for the smoke run and
the tests: copies of ``genrec_tpu/data/synthetic.py``'s ``make_interactions``,
``make_item_embs``, ``make_user_embs``, ``make_codes`` and ``make_prof_embs``,
which give the same arrays from the same seed.

Sequences follow a power-law item popularity with per-user Markov topic
drift, which is enough structure for a retriever to beat random.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from genrec_tpu_torch.data.contracts import InteractionData


def make_interactions(
    num_users: int = 2000,
    num_items: int = 700,
    min_len: int = 3,
    max_len: int = 40,
    num_topics: int = 16,
    topic_stickiness: float = 0.85,
    seed: int = 0,
) -> InteractionData:
    """Synthetic user→item interaction sequences (user_item_interact.h5).

    Items 1..num_items are assigned to topics; each user walks a sticky
    Markov chain over topics and samples Zipf-weighted items inside the
    current topic. user_ids are 1-based contiguous.
    """
    rng = np.random.default_rng(seed)
    item_topic = rng.integers(0, num_topics, size=num_items + 1)
    # Zipf-ish popularity inside each topic.
    pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    pop = pop[rng.permutation(num_items)]

    topic_items = [np.where(item_topic[1:] == t)[0] + 1 for t in range(num_topics)]
    topic_probs = []
    for t in range(num_topics):
        ids = topic_items[t]
        if len(ids) == 0:
            ids = np.arange(1, num_items + 1)
        w = pop[ids - 1]
        topic_probs.append(w / w.sum())
        topic_items[t] = ids

    user_ids = np.arange(1, num_users + 1, dtype=np.int32)
    profiles = [f"user_{u}" for u in user_ids]

    # vectorized over users: walk topics step-by-step, then inverse-CDF
    # sample an item within each user's current topic.
    lens = rng.integers(min_len, max_len + 1, size=num_users)
    # pad ragged per-topic tables to a rectangle for fancy indexing
    width = max(len(t) for t in topic_items)
    items_rect = np.zeros((num_topics, width), dtype=np.int64)
    cum_rect = np.ones((num_topics, width), dtype=np.float64)
    for t in range(num_topics):
        k = len(topic_items[t])
        items_rect[t, :k] = topic_items[t]
        cum_rect[t, :k] = np.cumsum(topic_probs[t])
        items_rect[t, k:] = topic_items[t][-1]

    topic = rng.integers(0, num_topics, size=num_users)
    all_steps = np.zeros((num_users, max_len), dtype=np.int32)
    for i in range(max_len):
        switch = rng.random(num_users) > topic_stickiness
        topic = np.where(switch, rng.integers(0, num_topics, size=num_users), topic)
        u = rng.random(num_users)
        col = np.array([np.searchsorted(cum_rect[t], x)
                        for t, x in zip(topic, u)]) if num_users < 512 else \
            (u[:, None] > cum_rect[topic]).sum(axis=1)
        col = np.minimum(col, width - 1)
        all_steps[:, i] = items_rect[topic, col]
    seqs = [all_steps[j, :lens[j]].astype(np.int32) for j in range(num_users)]
    return InteractionData(user_ids, profiles, seqs)


def make_item_embs(num_items: int, dim: int = 768, num_topics: int = 16,
                   seed: int = 0, noise: float = 0.3) -> np.ndarray:
    """Synthetic item embedding table with cluster structure.

    Row 0 is the zero padding row (contract of `T5/item_encode.py:99-101`).
    Cluster structure makes RQ-VAE codebooks meaningful.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1.0, size=(num_topics, dim)).astype(np.float32)
    topics = rng.integers(0, num_topics, size=num_items)
    embs = centers[topics] + noise * rng.normal(0, 1.0, size=(num_items, dim)).astype(np.float32)
    table = np.zeros((num_items + 1, dim), dtype=np.float32)
    table[1:] = embs
    return table


def make_user_embs(num_users: int, dim: int = 768, seed: int = 1) -> np.ndarray:
    """(num_users, dim) f32 profile embeddings (user_profile_embs.h5): row i
    is user i+1."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1.0, size=(num_users, dim)).astype(np.float32) * 0.5


def make_codes(num_items: int, codebook_size: int = 8, num_levels: int = 3,
               seed: int = 0) -> np.ndarray:
    """Synthetic collision-free (num_items+1, num_levels+1) semantic-ID table.

    Same shape/semantics as course_rqvae_codes.npy (row indexed by dense item
    id; last column is the disambiguation digit). Row 0 is padding.
    """
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, codebook_size, size=(num_items + 1, num_levels)).astype(np.int64)
    full = np.concatenate([codes, np.zeros((num_items + 1, 1), dtype=np.int64)], axis=1)
    # dedup via the 4th digit exactly like RQ-VAE/infer.py:150-171
    uniq, counts = np.unique(full, axis=0, return_counts=True)
    for dup in uniq[counts > 1]:
        idx = np.where((full == dup).all(axis=1))[0]
        for i, j in enumerate(idx):
            full[j, -1] = i
    return full


def make_prof_embs(num_users: int, num_vectors: int = 5, dim: int = 768,
                   seed: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic prof_lvl*.h5 payload: (user_ids, (N, 5, 768) vectors)."""
    rng = np.random.default_rng(seed)
    user_ids = np.arange(1, num_users + 1, dtype=np.int32)
    embs = rng.normal(0, 0.5, size=(num_users, num_vectors, dim)).astype(np.float32)
    return user_ids, embs

"""Synthetic semantic-ID tables for the smoke run and the tests."""

from __future__ import annotations

import numpy as np


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

"""TIGER semantic-ID token space and decode-constraint tables.

Token mapping: ``token = raw_code + level*codebook_size + 1``, giving
level-disjoint ranges [1-8], [9-16], [17-24], [25-32] for K=8, with pad=0
outside all ranges and eos=31 overlapping the level-3 range (a wart of the
reference, kept for parity). Host-side numpy; the tables are moved to the
device by the beam search.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def codes_to_token_table(codes: np.ndarray, codebook_size: int = 8) -> np.ndarray:
    """Vectorized token mapping of a full (N_items, code_dim) code table."""
    codes = np.asarray(codes, dtype=np.int64)
    levels = np.arange(codes.shape[1], dtype=np.int64)[None, :]
    return (codes + levels * codebook_size + 1).astype(np.int32)


def level_token_ranges(codebook_size: int, code_dim: int) -> List[Tuple[int, int]]:
    """Valid [lo, hi] inclusive token range per decode position."""
    return [(p * codebook_size + 1, (p + 1) * codebook_size) for p in range(code_dim)]


def build_level_masks(vocab_size: int, codebook_size: int, code_dim: int,
                      extend_last: bool = True) -> np.ndarray:
    """(code_dim, vocab_size) bool: token validity per decode position.

    ``extend_last`` opens the final position up to ``vocab_size-1``: the
    collision-disambiguation digit can exceed codebook_size-1 when a code
    group has many duplicates, producing tokens above the nominal level
    range that are still < vocab_size.
    """
    masks = np.zeros((code_dim, vocab_size), dtype=bool)
    for p, (lo, hi) in enumerate(level_token_ranges(codebook_size, code_dim)):
        if extend_last and p == code_dim - 1:
            hi = vocab_size - 1
        masks[p, lo:min(hi, vocab_size - 1) + 1] = True
    return masks


def build_code_trie(codes: np.ndarray, vocab_size: int,
                    codebook_size: int = 8) -> np.ndarray:
    """Prefix-trie validity table over the actual item code set.

    Returns ``allowed`` of shape (sum_p K**p, vocab_size): the rows of step
    ``p`` start at ``trie_prefix_offsets(K, code_dim)[p]`` and are indexed
    by the flat base-K prefix ``sum_j code_j * K**(p-1-j)``.
    """
    codes = np.asarray(codes, dtype=np.int64)
    code_dim = codes.shape[1]
    tokens = codes_to_token_table(codes, codebook_size)  # (N, code_dim)

    total_prefixes = sum(codebook_size ** p for p in range(code_dim))
    allowed = np.zeros((total_prefixes, vocab_size), dtype=bool)
    offsets = trie_prefix_offsets(codebook_size, code_dim)

    for row, tok in zip(codes, tokens):
        prefix = 0
        for p in range(code_dim):
            allowed[offsets[p] + prefix, tok[p]] = True
            prefix = prefix * codebook_size + int(row[p])
    return allowed


def trie_prefix_offsets(codebook_size: int, code_dim: int) -> np.ndarray:
    """Row offsets into the flat trie table per decode step."""
    return np.cumsum([0] + [codebook_size ** p for p in range(code_dim - 1)]).astype(np.int32)

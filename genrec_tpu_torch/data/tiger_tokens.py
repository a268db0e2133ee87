"""TIGER semantic-ID token space, leave-one-out splits and decode-constraint
tables.

Token mapping: ``token = raw_code + level*codebook_size + 1``, giving
level-disjoint ranges [1-8], [9-16], [17-24], [25-32] for K=8, with pad=0
outside all ranges and eos=31 overlapping the level-3 range (a wart of the
reference, kept for parity). Leave-one-out split with teacher forcing
(`RQVAE-T5/data_read.ipynb`): for a user item sequence s_1..s_n (n ≥ 2),
test = (s_1..s_{n-1} → s_n) and train = (s_1..s_{n-2} → s_2..s_{n-1});
users with exactly 2 items are train-only. Host-side numpy; the tables are
moved to the device by the beam search. The beam search walks the trie as
a node table over the prefixes that exist (:func:`build_trie_nodes`); the
dense table of every base-K prefix (:func:`build_code_trie`) is the JAX
package's, kept for comparison.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from genrec_tpu_torch.data.contracts import TigerSplit


def item_to_offset_code(code: Sequence[int], codebook_size: int = 8) -> np.ndarray:
    """Map raw per-level codes to the level-disjoint token space.

    ``token(level, code) = level*K + code + 1`` (SURVEY.md §2.6 token space).
    """
    code = np.asarray(code, dtype=np.int64)
    levels = np.arange(code.shape[-1], dtype=np.int64)
    return (code + levels * codebook_size + 1).astype(np.int32)


def offset_code_to_item(tokens: Sequence[int], codebook_size: int = 8) -> np.ndarray:
    """Inverse of :func:`item_to_offset_code` (tokens outside range → -1)."""
    tokens = np.asarray(tokens, dtype=np.int64)
    levels = np.arange(tokens.shape[-1], dtype=np.int64)
    raw = tokens - levels * codebook_size - 1
    valid = (raw >= 0) & (raw < codebook_size)
    return np.where(valid, raw, -1).astype(np.int32)


def codes_to_token_table(codes: np.ndarray, codebook_size: int = 8) -> np.ndarray:
    """Vectorized token mapping of a full (N_items, code_dim) code table."""
    codes = np.asarray(codes, dtype=np.int64)
    levels = np.arange(codes.shape[1], dtype=np.int64)[None, :]
    return (codes + levels * codebook_size + 1).astype(np.int32)


def build_tiger_splits(
    item_id_lists: Sequence[np.ndarray],
    user_ids: Sequence[int],
    codes: np.ndarray,
    codebook_size: int = 8,
    min_seq_len: int = 2,
    vocab_size: int = 64,
) -> Tuple[TigerSplit, TigerSplit]:
    """Build tiger/{train,test} splits from raw interactions + item codes.

    ``codes`` is the (max_item_id+1, code_dim) table indexed by dense item id
    (row 0 unused / padding). Histories/targets are stored flattened in the
    offset-token space, matching the vlen-int32 H5 contract.
    """
    token_table = codes_to_token_table(codes, codebook_size)
    # dedup digits are unbounded (RQ-VAE/infer.py:150-171); tokens must still
    # fit the model vocabulary: fail loudly instead of wrapping in the lookup
    max_tok = int(token_table.max()) if token_table.size else 0
    if max_tok >= vocab_size:
        raise ValueError(
            f"offset token {max_tok} ≥ vocab {vocab_size} — a collision group has "
            f"more duplicates than the token space can disambiguate; "
            f"retrain RQ-VAE for a lower collision rate or grow the vocab")

    train_uids: List[int] = []
    train_hist: List[np.ndarray] = []
    train_tgt: List[np.ndarray] = []
    test_uids: List[int] = []
    test_hist: List[np.ndarray] = []
    test_tgt: List[np.ndarray] = []

    for uid, items in zip(user_ids, item_id_lists):
        items = np.asarray(items, dtype=np.int64)
        n = len(items)
        if n < min_seq_len:
            continue
        tok = token_table[items]  # (n, code_dim)
        if n >= 3:
            # test: full history minus last → last item
            test_uids.append(int(uid))
            test_hist.append(tok[:-1].reshape(-1))
            test_tgt.append(tok[-1].reshape(-1))
            # train: teacher forcing over the remaining prefix
            train_uids.append(int(uid))
            train_hist.append(tok[:-2].reshape(-1))
            train_tgt.append(tok[1:-1].reshape(-1))
        else:  # n == 2: train-only (notebook behavior)
            train_uids.append(int(uid))
            train_hist.append(tok[:1].reshape(-1))
            train_tgt.append(tok[1:2].reshape(-1))

    train = TigerSplit(np.asarray(train_uids, dtype=np.int32), train_hist, train_tgt)
    test = TigerSplit(np.asarray(test_uids, dtype=np.int32), test_hist, test_tgt)
    return train, test


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


def build_trie_nodes(codes: np.ndarray, codebook_size: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """The prefix trie over the actual item code set as a node table over
    the prefixes that exist: ``(children (nodes, W) int64, allowed (nodes, W)
    bool)`` with ``W = max(codebook_size, largest digit + 1)``.

    Node 0 is the empty prefix; every prefix of 1..code_dim-1 digits that
    some item has is a node, level by level; the last node is dead: no item
    continues it, and its children are itself. ``allowed[n, d]``: some item
    continues node n's prefix with digit d. ``children[n, d]``: the node of
    that prefix extended by d, the dead node where no item has it (and at
    the last level). A walk that leaves the items' prefixes so ends in the
    dead node, as the dense table's prefix arithmetic ends in rows with
    nothing allowed, and every allowed mask equals the dense table's row.
    """
    codes = np.asarray(codes, dtype=np.int64)
    n_items, code_dim = codes.shape
    width = max(codebook_size, int(codes.max()) + 1 if codes.size else 0)
    levels = [np.unique(codes[:, :p], axis=0, return_inverse=True) for p in range(1, code_dim)]
    sizes = [len(u) for u, _ in levels]
    dead = 1 + sum(sizes)
    children = np.full((dead + 1, width), dead, dtype=np.int64)
    allowed = np.zeros((dead + 1, width), dtype=bool)
    node = np.zeros(n_items, dtype=np.int64)  # each item's node at the current level
    first = 1
    for p in range(code_dim):
        allowed[node, codes[:, p]] = True
        if p + 1 < code_dim:
            nxt = first + levels[p][1].reshape(-1)
            children[node, codes[:, p]] = nxt
            node, first = nxt, first + sizes[p]
    return children, allowed

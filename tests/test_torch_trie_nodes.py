"""The item trie as a node table over the prefixes that exist
(``data/tiger_tokens.build_trie_nodes``) and beam search's selection over
each beam's allowed children (``ops/beam_search.py``), against what they
replace: the dense table over every base-K prefix, and a frozen copy of
the selection that masked and sorted all K·V candidates of a sample. No
JAX."""

import itertools

import numpy as np
import pytest
import torch

from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.data import tiger_tokens
from genrec_tpu_torch.data.synthetic import make_codes
from genrec_tpu_torch.models import tiger


def test_node_table_gives_the_dense_tables_masks_on_the_course_catalog():
    """Walking every base-8 prefix of 0-3 digits down the node table gives
    the dense table's row: the prefixes no course has reach the dead node,
    with nothing allowed."""
    codes = make_codes(700)[1:]
    dense = tiger_tokens.build_code_trie(codes, 64, 8)
    offsets = tiger_tokens.trie_prefix_offsets(8, 4)
    children, allowed = tiger_tokens.build_trie_nodes(codes, 8)
    width = allowed.shape[1]
    dead = len(children) - 1
    assert not allowed[dead].any() and (children[dead] == dead).all()
    reached = set()
    for p in range(4):
        for prefix in itertools.product(range(8), repeat=p):
            node = 0
            for d in prefix:
                node = children[node, d]
            reached.add(node)
            row = dense[offsets[p] + sum(d * 8 ** (p - 1 - j) for j, d in enumerate(prefix))]
            want = np.zeros(64, dtype=bool)
            lo = p * 8 + 1
            want[lo:lo + width] = allowed[node, :64 - lo]
            np.testing.assert_array_equal(row, want, err_msg=str(prefix))
    assert reached == set(range(len(children)))  # every node is some prefix's


def _old_beam_search(decode_fn, batch_size, num_beams, max_len, vocab_size, *, decoder_start=0,
                     pad_token=0, eos_token=None, constraint=None, reorder=None, device="cpu",
                     dense=None):
    """Beam search as it stood before the node table: the trie a dense
    (Σ K^p, V) table indexed by the base-K prefix, every one of the K·V
    candidates of a sample masked and sorted (frozen copy)."""
    trie, offsets = dense
    B, K, V = batch_size, num_beams, vocab_size
    steps = max_len - 1
    tokens = torch.full((B, K, max_len), pad_token, dtype=torch.int64, device=device)
    tokens[:, :, 0] = decoder_start
    scores = torch.full((B, K), -1e30, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    prefix = torch.zeros((B, K), dtype=torch.int64, device=device)
    frozen_row = torch.full((V,), -1e30, dtype=torch.float32, device=device)
    frozen_row[pad_token] = 0.0
    neg = torch.tensor(-1e30, dtype=torch.float32, device=device)
    row_base = torch.arange(0, B * K, K, device=device)[:, None]
    for step in range(steps):
        logits = decode_fn(tokens.view(B * K, max_len), step)
        logp = torch.log_softmax(logits.float(), dim=-1).view(B, K, V)
        logp = torch.where(trie[offsets[step] + prefix], logp, neg)
        logp = torch.where(finished[:, :, None], frozen_row, logp)
        cand = (scores[:, :, None] + logp).view(B, K * V)
        top_scores, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
        beam_idx, tok_idx = top_idx // V, top_idx % V
        tokens = torch.gather(tokens, 1, beam_idx[:, :, None].expand(B, K, max_len))
        tokens[:, :, step + 1] = tok_idx
        finished = torch.gather(finished, 1, beam_idx)
        prefix = torch.gather(prefix, 1, beam_idx)
        scores = top_scores
        if eos_token is not None:
            finished = finished | (tok_idx == eos_token)
        kc = constraint.codebook_size
        prefix = prefix * kc + torch.clamp(tok_idx - (step * kc + 1), 0, kc - 1)
        if reorder is not None and step + 1 < steps:
            reorder((beam_idx + row_base).view(B * K))
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.gather(tokens, 1, order[:, :, None].expand(B, K, max_len)), scores


@pytest.mark.parametrize("seed", [0, 1])
def test_tiger_generate_is_bit_identical_to_the_old_selection(monkeypatch, seed):
    """TIGER (``TIGERConfig()``, random weights) with 20 beams over the
    700-course trie, whose root has at most 8 children, so most beams of
    the first step are ties at -1e30 that the flat index orders, and eos
    (token 31, a last-level digit) can freeze a beam: the same tokens and
    scores, bit for bit, as the old selection's."""
    cfg = TIGERConfig(constrained_decoding="trie")
    torch.manual_seed(seed)
    model = tiger.TIGER(cfg, torch.Generator().manual_seed(seed)).eval()
    codes = make_codes(700)[1:]
    g = torch.Generator().manual_seed(seed + 7)
    ids = torch.randint(1, 33, (6, 80), generator=g)
    mask = torch.ones_like(ids)
    mask[1, :40] = 0
    ids = ids * mask
    new = tiger.generate(model, ids, mask, num_beams=20, constraint=tiger.make_constraint(cfg, codes))
    dense = (torch.from_numpy(tiger_tokens.build_code_trie(codes, 64, 8)),
             torch.from_numpy(tiger_tokens.trie_prefix_offsets(8, 4)).long())
    monkeypatch.setattr(tiger, "beam_search",
                        lambda *a, **k: _old_beam_search(*a, dense=dense, **k))
    old = tiger.generate(model, ids, mask, num_beams=20, constraint=tiger.make_constraint(cfg, codes))
    assert torch.equal(new[0], old[0])
    assert torch.equal(new[1], old[1])

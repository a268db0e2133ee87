"""The reference's `check_data_alignment.py` invariants on the port's
dataset builders: the ten tests of tests/test_alignment.py, one for one,
with ``genrec_tpu_torch`` in place of ``genrec_tpu``.

The port's ``check-alignment`` subcommand runs this file. It imports
nothing of JAX, so it runs where the port runs (``--noconftest`` skips the
suite's JAX setup).
"""

import numpy as np

from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens
from genrec_tpu_torch.data.contracts import InteractionData


def _demo_interactions(seqs):
    return InteractionData(
        user_ids=np.arange(1, len(seqs) + 1, dtype=np.int32),
        user_profiles=[f"u{i}" for i in range(len(seqs))],
        item_id_lists=[np.asarray(s, dtype=np.int32) for s in seqs],
    )


# ① T5 sliding-window sample split (check_data_alignment.py:20-58)
def test_dense_t5_split_no_leakage():
    demo = [10, 20, 30, 40, 50]
    data = _demo_interactions([demo])
    train = datasets.build_dense_t5_arrays(data, max_seq_len=20, mode="train")
    test = datasets.build_dense_t5_arrays(data, max_seq_len=20, mode="test")

    for row, ln, tgt in zip(train.history_ids, train.seq_lens, train.target_ids):
        h = row[:ln].tolist()
        # target immediately follows history, never leaks into it
        assert demo.index(tgt) == demo.index(h[-1]) + 1
        assert tgt not in h
        assert tgt != demo[-1]  # last item is test-only
    th = test.history_ids[0][:test.seq_lens[0]].tolist()
    assert test.target_ids[0] == demo[-1]
    assert demo[-1] not in th


# ② mask direction + mean-pooling numerics (check_data_alignment.py:60-82)
def test_dense_t5_mask_and_meanpool():
    seq_lens = [5, 3, 7]
    max_l = max(seq_lens)
    embs = np.zeros((3, max_l, 4), np.float32)
    mask = np.zeros((3, max_l), np.int64)
    for i, l in enumerate(seq_lens):
        embs[i, :l] = 1.0
        mask[i, :l] = 1
    for i, l in enumerate(seq_lens):
        assert mask[i, :l].all() and (mask[i, l:] == 0).all()
        m = mask[i][:, None].astype(np.float32)
        pooled = (embs[i] * m).sum(0) / max(m.sum(), 1e-9)
        assert abs(pooled[0] - 1.0) < 1e-4


# ④ token ranges and EOS/PAD conflicts (check_data_alignment.py:100-135)
def test_tiger_token_ranges_and_eos_overlap():
    K, code_dim, eos_id, pad_id = 8, 4, 31, 0
    ranges = tiger_tokens.level_token_ranges(K, code_dim)
    assert ranges == [(1, 8), (9, 16), (17, 24), (25, 32)]
    all_valid = set()
    for lo, hi in ranges:
        all_valid |= set(range(lo, hi + 1))
    assert pad_id not in all_valid
    # documented wart: eos overlaps only the LAST level's range
    assert eos_id in all_valid
    overlap_positions = [p for p, (lo, hi) in enumerate(ranges) if lo <= eos_id <= hi]
    assert overlap_positions == [code_dim - 1]
    # mapping and inverse agree
    code = [3, 5, 0, 7]
    tok = tiger_tokens.item_to_offset_code(code, K)
    assert tok.tolist() == [4, 14, 17, 32]
    assert tiger_tokens.offset_code_to_item(tok, K).tolist() == code


# ⑤ attention mask covers exactly the padding (check_data_alignment.py:137-156)
def test_tiger_attention_mask_covers_padding():
    from genrec_tpu_torch.data.contracts import TigerSplit
    split = TigerSplit(
        user_ids=np.array([1], np.int32),
        histories=[np.array([1, 9, 17, 25, 2, 10, 18, 26, 3, 11, 19, 27], np.int32)],
        targets=[np.array([4, 12, 20, 28], np.int32)],
    )
    arr = datasets.build_tiger_arrays(split, max_len=5, code_dim=4)
    flat = arr.input_ids[0]
    mask = arr.attention_mask[0]
    pad_pos = set(np.where(flat == 0)[0])
    zero_pos = set(np.where(mask == 0)[0])
    assert pad_pos == zero_pos
    # minimum legal code token is 1 ≠ pad 0
    assert flat[flat != 0].min() >= 1
    # left padding: two pad items then three real items
    assert (flat[:8] == 0).all() and (flat[8:] != 0).all()


# ⑥ SASRec input/target shift alignment (check_data_alignment.py:158-182)
def test_sasrec_shift_alignment():
    demo = [1, 2, 3, 4, 5, 6]
    data = _demo_interactions([demo])
    arr = datasets.build_sasrec_arrays(data, max_len=10, mode="train", min_seq_len=3)
    s, o = arr.inputs[0], arr.targets[0]
    for i in range(len(s) - 1):
        if s[i] != 0 and o[i] != 0:
            assert o[i] == s[i + 1]


# ⑦ SASRec leave-one-out test split (check_data_alignment.py:185-202)
def test_sasrec_leave_one_out():
    demo = [10, 20, 30, 40, 50]
    data = _demo_interactions([demo])
    arr = datasets.build_sasrec_arrays(data, max_len=10, mode="test", min_seq_len=3)
    assert arr.targets[0] == demo[-1]
    assert demo[-1] not in arr.inputs[0]


# train truncation keeps the most recent max_len steps, pre-padded
def test_sasrec_truncation_and_prepad():
    demo = list(range(1, 30))
    data = _demo_interactions([demo])
    arr = datasets.build_sasrec_arrays(data, max_len=10, mode="train")
    s, o = arr.inputs[0], arr.targets[0]
    assert s.tolist() == demo[:-1][-10:]
    assert o.tolist() == demo[1:][-10:]
    short = _demo_interactions([[1, 2, 3]])
    arr2 = datasets.build_sasrec_arrays(short, max_len=10, mode="train")
    assert arr2.inputs[0].tolist() == [0] * 8 + [1, 2]
    assert arr2.targets[0].tolist() == [0] * 8 + [2, 3]


# TIGER leave-one-out split semantics (RQVAE-T5/data_read.ipynb cells 2-3)
def test_tiger_split_semantics():
    codes = synthetic.make_codes(num_items=20, codebook_size=8, num_levels=3)
    seqs = [[1, 2, 3, 4], [5, 6], [7]]
    data = _demo_interactions(seqs)
    train, test = tiger_tokens.build_tiger_splits(
        data.item_id_lists, data.user_ids, codes, codebook_size=8)
    # user 1 (len 4): test = (items[0:3] → item[3]); train = (items[0:2] → items[1:3])
    assert len(test.histories) == 1
    assert len(test.histories[0]) == 3 * 4 and len(test.targets[0]) == 4
    # user 2 (len 2): train-only
    assert len(train.histories) == 2
    assert len(train.histories[1]) == 4 and len(train.targets[1]) == 4
    # user 3 (len 1): dropped entirely
    assert 3 not in train.user_ids and 3 not in test.user_ids
    # targets are valid offset tokens of the right levels
    tgt = np.asarray(test.targets[0]).reshape(-1, 4)
    for lvl in range(4):
        lo, hi = tiger_tokens.level_token_ranges(8, 4)[lvl]
        assert ((tgt[:, lvl] >= lo) & (tgt[:, lvl] <= hi)).all()


def test_trie_masks():
    codes = synthetic.make_codes(num_items=10, codebook_size=8, num_levels=3)
    trie = tiger_tokens.build_code_trie(codes[1:], vocab_size=64, codebook_size=8)
    offsets = tiger_tokens.trie_prefix_offsets(8, 4)
    # step 0: root row allows exactly the distinct first tokens of real items
    first_tokens = set(tiger_tokens.codes_to_token_table(codes[1:], 8)[:, 0].tolist())
    assert set(np.where(trie[offsets[0]])[0].tolist()) == first_tokens
    # every item's full path is walkable
    toks = tiger_tokens.codes_to_token_table(codes[1:], 8)
    for row, tok in zip(codes[1:], toks):
        prefix = 0
        for p in range(4):
            assert trie[offsets[p] + prefix, tok[p]]
            prefix = prefix * 8 + int(row[p])


def test_fixed_shape_batching():
    arrays = {"x": np.arange(10), "y": np.arange(10) * 2}
    batches = list(datasets.iterate_batches(arrays, 4, shuffle=False))
    assert len(batches) == 3
    assert all(b["x"].shape == (4,) for b in batches)
    assert batches[-1]["valid"].tolist() == [True, True, False, False]
    seen = np.concatenate([b["x"][b["valid"]] for b in batches])
    assert sorted(seen.tolist()) == list(range(10))

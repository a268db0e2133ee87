"""The traffic generators give the same inputs for the same seed, other
inputs for another seed, and the same amount of work for every seed."""

import numpy as np
import torch

from h100bench import cell as cells, corpus

BIG_SEED = 2 ** 31 + 12345


def _train(seed, n=300):
    c = cells.find_cell("tiger_prefix.train_b1024")
    return corpus.train_arrays(seed, c.config, dict(c.traffic, students=n))


def _serve(seed, n=300):
    c = cells.find_cell("tiger.recommend_b4096")
    return corpus.serving_histories(seed, c.config, dict(c.traffic, pool=n))


def test_same_seed_same_inputs():
    for make in (_train, _serve):
        (a, ca), (b, cb) = make(BIG_SEED), make(BIG_SEED)
        assert np.array_equal(ca, cb)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    w1 = corpus.make_weights(BIG_SEED, [("w", (3, 4), ("normal", 0.5))], "cpu")["w"]
    w2 = corpus.make_weights(BIG_SEED, [("w", (3, 4), ("normal", 0.5))], "cpu")["w"]
    assert torch.equal(w1, w2)


def test_other_seed_other_inputs_same_work():
    (a, _), (b, _) = _train(7), _train(8)
    assert not np.array_equal(a["input_ids"], b["input_ids"])
    assert (a["labels"] != -100).sum() == (b["labels"] != -100).sum()
    (a, _), (b, _) = _serve(7), _serve(8)
    assert not np.array_equal(a["input_ids"], b["input_ids"])
    assert sorted(a["attention_mask"].sum(1)) == sorted(b["attention_mask"].sum(1))


def test_the_arrays_have_the_pipeline_shapes():
    c = cells.find_cell("tiger_prefix.train_b1024")
    arrays, codes = _train(3)
    assert arrays["input_ids"].shape == (300, 80) and arrays["input_ids"].dtype == np.int32
    assert arrays["labels"].shape == (300, 156)
    assert arrays["input_ids"].max() < c.config["arch"]["vocab_size"]
    assert codes.shape == (701, 4)
    # every code is distinct once the collision digit is added
    assert len({tuple(r) for r in codes}) == len(codes)
    # left-padded: a row's real tokens are its last ones
    m = arrays["attention_mask"]
    assert np.all(np.diff(m, axis=1) >= 0)
    # a label token follows the history it is the target of (teacher forcing)
    assert np.array_equal(arrays["labels"][:, :4] > 0, np.ones((300, 4), bool))


def test_histories_end_where_the_target_begins():
    items = np.array([[5, 6, 7, 8, 9, 0]])
    tok = np.repeat(items[..., None], 2, axis=2)
    out = corpus._history(tok, np.array([4]), 3)
    assert out.tolist() == [[6, 6, 7, 7, 8, 8]]
    out = corpus._history(tok, np.array([2]), 3)
    assert out.tolist() == [[0, 0, 5, 5, 6, 6]]

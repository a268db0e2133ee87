"""The port's copies of the JAX package's framework-free helpers give what
the originals give: synthetic corpora and codes, TIGER splits and arrays,
batch iteration, the TIGER split file contract, the metric primitives and
aggregators, beam evaluation, the results CSV and the logger. Exact
equality throughout (the same numpy code, or integer results).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.data import contracts as jax_contracts
from genrec_tpu.data import datasets as jax_datasets
from genrec_tpu.data import synthetic as jax_synthetic
from genrec_tpu.data import tiger_tokens as jax_tokens
from genrec_tpu.eval.evaluator import beam_evaluate as jax_beam_evaluate
from genrec_tpu.ops import metrics_ops as jax_metrics
from genrec_tpu.utils.csv_results import append_results_csv as jax_append_csv
from genrec_tpu_torch.data import contracts, datasets, synthetic, tiger_tokens
from genrec_tpu_torch.eval.evaluator import beam_evaluate
from genrec_tpu_torch.ops import metrics_ops
from genrec_tpu_torch.utils import misc, plotting
from genrec_tpu_torch.utils.csv_results import append_results_csv


def _same_interactions(a, b):
    np.testing.assert_array_equal(a.user_ids, b.user_ids)
    assert a.user_profiles == b.user_profiles
    assert len(a.item_id_lists) == len(b.item_id_lists)
    for x, y in zip(a.item_id_lists, b.item_id_lists):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("num_users", [60, 600])  # per-user search / vectorized branch
def test_make_interactions_and_codes_equal(num_users):
    kw = dict(num_users=num_users, num_items=50, min_len=3, max_len=12, seed=4)
    got, want = synthetic.make_interactions(**kw), jax_synthetic.make_interactions(**kw)
    _same_interactions(got, want)
    assert got.num_users == want.num_users and got.max_item_id == want.max_item_id
    np.testing.assert_array_equal(synthetic.make_codes(50, seed=2),
                                  jax_synthetic.make_codes(50, seed=2))


@pytest.fixture(scope="module")
def splits():
    corpus = jax_synthetic.make_interactions(num_users=80, num_items=40, min_len=2,
                                             max_len=14, seed=9)
    codes = jax_synthetic.make_codes(40, seed=3)
    got = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    want = jax_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    return got, want


def _same_split(a, b):
    np.testing.assert_array_equal(a.user_ids, b.user_ids)
    for xs, ys in ((a.histories, b.histories), (a.targets, b.targets)):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)


def test_tiger_splits_and_arrays_equal(splits):
    (tr, te), (jtr, jte) = splits
    _same_split(tr, jtr)
    _same_split(te, jte)
    for split, jsplit, kw in ((tr, jtr, {}), (te, jte, {"max_target_items": 1})):
        got = datasets.build_tiger_arrays(split, 8, 4, **kw).arrays
        want = jax_datasets.build_tiger_arrays(jsplit, 8, 4, **kw).arrays
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="vocab"):
        tiger_tokens.build_tiger_splits([np.array([1, 2, 3])], [1],
                                        np.full((4, 4), 40), vocab_size=64)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal(splits, shuffle):
    arrays = datasets.build_tiger_arrays(splits[0][0], 8, 4).arrays
    assert datasets.num_batches(70, 32) == jax_datasets.num_batches(70, 32) == 3
    assert datasets.num_batches(70, 32, True) == jax_datasets.num_batches(70, 32, True) == 2
    got = list(datasets.iterate_batches(arrays, 32, shuffle=shuffle, seed=5))
    want = list(jax_datasets.iterate_batches(arrays, 32, shuffle=shuffle, seed=5))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_tiger_split_files_cross_read(tmp_path, splits):
    (tr, _), _ = splits
    contracts.write_tiger_split(str(tmp_path / "port.h5"), tr)
    _same_split(jax_contracts.read_tiger_split(str(tmp_path / "port.h5")), tr)
    jax_contracts.write_tiger_split(str(tmp_path / "jax.h5"), tr)
    _same_split(contracts.read_tiger_split(str(tmp_path / "jax.h5")), tr)


def test_metric_primitives_equal():
    r = np.random.default_rng(0)
    labels = r.integers(1, 4, size=(6, 3)).astype(np.int32)
    preds = r.integers(1, 4, size=(6, 5, 3)).astype(np.int32)
    preds[0, 1] = preds[0, 3] = labels[0]   # duplicate beams: the first match only
    preds[1, :] = labels[1]                  # every beam matches
    preds[2, :, 0] = 0                       # none matches
    got = metrics_ops.pos_index_exact_match(torch.from_numpy(preds), torch.from_numpy(labels))
    want = jax_metrics.pos_index_exact_match(jnp.asarray(preds), jnp.asarray(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [False, True, False, False, False]

    logits = np.round(r.normal(size=(5, 9)), 1).astype(np.float32)  # ties
    targets = np.array([0, 3, 8, 1, 3], np.int32)
    for mask in (True, False):
        got = metrics_ops.strict_ranks(torch.from_numpy(logits), torch.from_numpy(targets),
                                       mask)
        want = jax_metrics.strict_ranks(jnp.asarray(logits), jnp.asarray(targets), mask)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    pos = metrics_ops.pos_index_exact_match(
        torch.from_numpy(preds), torch.from_numpy(labels)).numpy()
    valid = np.array([1, 1, 1, 0, 1, 1], bool)
    assert metrics_ops.beam_metrics(pos, (1, 3), valid) == \
        jax_metrics.beam_metrics(pos, (1, 3), valid)
    ranks = np.array([1, 4, 2, 9, 3])
    assert metrics_ops.hit_ndcg_from_ranks(ranks, (1, 5), valid[:5]) == \
        jax_metrics.hit_ndcg_from_ranks(ranks, (1, 5), valid[:5])


def test_beam_evaluate_equals_the_reference(splits):
    arrays = datasets.build_tiger_arrays(splits[0][1], 8, 4, max_target_items=1).arrays
    r = np.random.default_rng(1)

    def fake_generate(batch, num_beams):  # beams built from the labels: some hit
        toks = r.integers(1, 9, size=(len(batch["labels"]), num_beams, 5)).astype(np.int32)
        toks[::2, 2, 1:] = batch["labels"][::2]
        return toks

    outs = [fake_generate(b, 5) for b in datasets.iterate_batches(arrays, 16, shuffle=False)]
    for batch_mean in (True, False):
        it = iter(outs)
        got = beam_evaluate(lambda b, n: torch.from_numpy(next(it)),
                            datasets.iterate_batches(arrays, 16, shuffle=False), (1, 5), 5,
                            batch_mean=batch_mean)
        it = iter(outs)
        want = jax_beam_evaluate(lambda b, n: next(it),
                                 jax_datasets.iterate_batches(arrays, 16, shuffle=False),
                                 (1, 5), 5, batch_mean=batch_mean)
        assert got == pytest.approx(want, abs=1e-12)
        assert got["Recall@5"] > 0


def test_results_csv_logger_and_plot(tmp_path, monkeypatch):
    row = {"task_id": "t", "lr": 0.001, "Recall@5": 0.25, "n": 3}
    append_results_csv(str(tmp_path / "a" / "port.csv"), row)
    append_results_csv(str(tmp_path / "a" / "port.csv"), row)
    jax_append_csv(str(tmp_path / "b" / "jax.csv"), row)
    jax_append_csv(str(tmp_path / "b" / "jax.csv"), row)
    assert (tmp_path / "a" / "port.csv").read_text() == (tmp_path / "b" / "jax.csv").read_text()

    log = misc.get_logger("port_test_logger", str(tmp_path / "x.log"))
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert "hello" in (tmp_path / "x.log").read_text()

    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib on this machine")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    plotting.plot_loss_curves([1.0, 0.5], [1.1, 0.6], None)  # no path: no import


@pytest.mark.parametrize("kw", [dict(num_items=30, dim=12, seed=3),
                                dict(num_items=5, dim=768, num_topics=2, seed=0, noise=0.1)])
def test_make_item_embs_equal(kw):
    got, want = synthetic.make_item_embs(**kw), jax_synthetic.make_item_embs(**kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and not got[0].any()  # row 0: the padding row


@pytest.mark.parametrize("args", [(40, 5, 16, 2), (7, 3, 8, 9)])
def test_make_prof_embs_equal(args):
    (u1, e1), (u2, e2) = synthetic.make_prof_embs(*args), jax_synthetic.make_prof_embs(*args)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(e1, e2)


def test_join_prof_embs_equal():
    uids, embs = jax_synthetic.make_prof_embs(20, 5, 4)
    users = np.array([3, 1, 25, 20, 3], np.int32)  # 25 is missing: a zero row
    keep = np.arange(20) != 6
    got = datasets.join_prof_embs(users, uids[keep], embs[keep])
    np.testing.assert_array_equal(got, jax_datasets.join_prof_embs(users, uids[keep], embs[keep]))
    assert not got[2].any() and np.array_equal(got[0], embs[2])


def test_item_emb_and_prof_files_cross_read(tmp_path):
    table = jax_synthetic.make_item_embs(9, 6, seed=1)
    contracts.write_item_embs(str(tmp_path / "port.h5"), table, meta={"model": "x"})
    embs, meta = jax_contracts.read_item_embs(str(tmp_path / "port.h5"))
    np.testing.assert_array_equal(embs, table)
    assert meta == {"model": "x", "dim": 6}
    jax_contracts.write_item_embs(str(tmp_path / "jax.h5"), table)
    embs, meta = contracts.read_item_embs(str(tmp_path / "jax.h5"))
    np.testing.assert_array_equal(embs, table)
    assert meta == {"dim": 6}

    uids, prof = jax_synthetic.make_prof_embs(6, 5, 4)
    contracts.write_prof_lvl(str(tmp_path / "p_port.h5"), uids, prof)
    for got, want in zip(jax_contracts.read_prof_lvl(str(tmp_path / "p_port.h5")), (uids, prof)):
        np.testing.assert_array_equal(got, want)
    jax_contracts.write_prof_lvl(str(tmp_path / "p_jax.h5"), uids, prof)
    for got, want in zip(contracts.read_prof_lvl(str(tmp_path / "p_jax.h5")), (uids, prof)):
        np.testing.assert_array_equal(got, want)

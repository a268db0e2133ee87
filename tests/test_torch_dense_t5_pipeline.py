"""The port's DenseT5 pipeline (genrec_tpu_torch/pipelines/dense_t5_pipeline.py)
and ``dense_t5_model_fn`` against the JAX package's, on the CPU at a tiny
size, mirroring tests/test_pipelines.py::test_dense_t5_end_to_end and
tests/test_serving.py::test_dense_t5_model_fn_retrieval.

- ``build_dense_t5_arrays`` equals the reference's Python and native paths;
  ``make_user_embs`` and the user-embedding file equal the reference's.
- ``_gather_batch`` equals JAX's: the user row ``user_id − 1`` at position
  0, the mask ``pos <= seq_lens``.
- From the same initial weights (the reference pipeline's own init,
  converted) at dropout 0, ``train`` gives per-epoch train and validation
  losses within 1e-4 of JAX's (f32 forward, backward and Adam, summed in
  another order); ``evaluate`` of the same weights gives JAX's Recall/NDCG
  within 1e-6 (the same strict ranks).
- ``dense_t5_model_fn`` serves JAX's lists on the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.data import contracts as jax_contracts
from genrec_tpu.data import datasets as jax_datasets
from genrec_tpu.data import synthetic as jax_synthetic
from genrec_tpu.models import dense_t5 as jax_dt5
from genrec_tpu.pipelines import dense_t5_pipeline as jax_pipeline
from genrec_tpu.serving.model_fn import dense_t5_model_fn as jax_model_fn
from genrec_tpu.train.checkpoint import CheckpointStore
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import dense_t5_params_from_flax
from genrec_tpu_torch.data import contracts, datasets, synthetic
from genrec_tpu_torch.models.dense_t5 import DenseT5
from genrec_tpu_torch.pipelines import dense_t5_pipeline
from genrec_tpu_torch.serving.model_fn import dense_t5_model_fn
from genrec_tpu_torch.train.checkpoint import save_best

EMB, L, ITEMS = 32, 8, 24


def _cfgs(path, dropout=0.0, **trainer):
    tr = dict(dict(epochs=2, batch_size=32, eval_batch_size=32, lr=1e-3, seed=0,
                   ckpt_dir=str(path / "ckpt"), early_stop_patience=10), **trainer)
    arch = dict(d_model=32, num_layers=1, num_heads=2, d_kv=16, d_ff=64, dropout_rate=dropout)
    kw = dict(input_emb_dim=EMB, target_emb_dim=EMB, max_seq_len=L, topk_list=(5, 10))
    return (jconfigs.DenseT5Config(arch=jconfigs.T5ArchConfig(**arch, fused_attention="off"),
                                   trainer=jconfigs.TrainerConfig(**tr), **kw),
            configs.DenseT5Config(arch=configs.T5ArchConfig(**arch),
                                  trainer=configs.TrainerConfig(**tr), **kw))


@pytest.fixture(scope="module")
def data():
    corpus = synthetic.make_interactions(num_users=40, num_items=ITEMS, min_len=3, max_len=12,
                                         num_topics=4, topic_stickiness=0.9, seed=3)
    items = synthetic.make_item_embs(ITEMS, dim=EMB, num_topics=4, seed=7)
    users = synthetic.make_user_embs(corpus.num_users, dim=EMB, seed=2)
    return corpus, items, users


def _jax_initial_params(jcfg):
    """The JAX pipeline's own init (dense_t5_pipeline.py:75-78)."""
    params = jax.jit(jax_dt5.DenseT5(jcfg).init)(
        jax.random.PRNGKey(jcfg.trainer.seed), jnp.zeros((1, L + 1, EMB)),
        jnp.ones((1, L + 1), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


def _loaded(cfg, flax_params):
    model = DenseT5(cfg)
    model.load_state_dict(dense_t5_params_from_flax(flax_params, cfg))
    return model


@pytest.mark.parametrize("mode", ["train", "test"])
def test_arrays_equal_both_reference_paths(data, mode):
    corpus = data[0]
    got = datasets.build_dense_t5_arrays(corpus, L, mode)
    n_users = len(corpus.user_ids)
    assert len(got.history_ids) > n_users if mode == "train" else len(got.history_ids) == n_users
    for use_native in (False, True):
        want = jax_datasets.build_dense_t5_arrays(corpus, L, mode, use_native=use_native)
        assert set(got.arrays) == set(want.arrays)
        for k, v in got.arrays.items():
            assert v.dtype == np.int32, k
            np.testing.assert_array_equal(v, want.arrays[k], err_msg=f"{k} native={use_native}")
    # right padding: row i holds seq_lens[i] ids, then zeros
    pos = np.arange(L)[None, :]
    assert ((got.history_ids != 0) == (pos < got.seq_lens[:, None])).all()


def test_user_embs_and_their_file_equal_the_reference(tmp_path, data):
    np.testing.assert_array_equal(synthetic.make_user_embs(30, 16, seed=4),
                                  jax_synthetic.make_user_embs(30, 16, seed=4))
    users = data[2]
    contracts.write_user_embs(str(tmp_path / "port" / "u.h5"), users)
    np.testing.assert_array_equal(jax_contracts.read_user_embs(str(tmp_path / "port" / "u.h5")),
                                  users)
    jax_contracts.write_user_embs(str(tmp_path / "jax.h5"), users)
    got = contracts.read_user_embs(str(tmp_path / "jax.h5"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, users)


def test_gather_batch_equals_jax(data):
    corpus, items, users = data
    arrays = datasets.build_dense_t5_arrays(corpus, L, "train").arrays
    rows = np.arange(0, len(arrays["history_ids"]), 7)
    batch = {k: v[rows] for k, v in arrays.items()}
    want = jax_pipeline._gather_batch(jnp.asarray(items), jnp.asarray(users),
                                      {k: jnp.asarray(v) for k, v in batch.items()})
    got = dense_t5_pipeline._gather_batch(torch.from_numpy(items), torch.from_numpy(users),
                                          {k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32 and got[0].shape == (len(rows), L + 1, EMB)
    np.testing.assert_array_equal(got[0][:, 0].numpy(), users[batch["user_ids"] - 1])


def test_epoch_losses_and_metrics_match_the_jax_pipeline(tmp_path, data, monkeypatch):
    corpus, items, users = data
    jcfg, tcfg = _cfgs(tmp_path / "jax")
    tcfg = dataclasses.replace(tcfg, trainer=dataclasses.replace(
        tcfg.trainer, ckpt_dir=str(tmp_path / "port"),
        results_csv_path=str(tmp_path / "dense.csv")))
    want = jax_pipeline.train(jcfg, corpus, items, users)
    params = _jax_initial_params(jcfg)
    monkeypatch.setattr(dense_t5_pipeline, "build_model", lambda cfg: _loaded(cfg, params))
    got = dense_t5_pipeline.train(tcfg, corpus, items, users, device="cpu")
    assert got.result.epochs_run == want.result.epochs_run == 2
    n_train = len(datasets.build_dense_t5_arrays(corpus, L, "train").history_ids)
    assert got.result.steps_run == 2 * datasets.num_batches(n_train, 32)
    np.testing.assert_allclose(got.result.train_losses, want.result.train_losses, atol=1e-4)
    np.testing.assert_allclose(got.result.val_losses, want.result.val_losses, atol=1e-4)

    # evaluate the JAX-trained parameters on both sides
    trained = jax.tree_util.tree_map(np.asarray, want.params)
    want_m = jax_pipeline.evaluate(jcfg, want, corpus, items, users)
    got_m = dense_t5_pipeline.evaluate(
        tcfg, dense_t5_pipeline.DenseT5Artifacts(dense_t5_params_from_flax(trained, tcfg), None),
        corpus, items, users, device="cpu")
    assert set(got_m) == {"Recall@5", "Recall@10", "NDCG@5", "NDCG@10"} == set(want_m)
    for k in got_m:
        assert abs(got_m[k] - want_m[k]) < 1e-6, (k, got_m, want_m)
    assert (tmp_path / "dense.csv").exists()


def test_dense_t5_end_to_end_and_main(tmp_path, data):
    """As the reference's end-to-end test: at dropout 0.3 the loss falls
    and Recall@10 beats chance (10/24); then ``main`` from the three files."""
    corpus, items, users = data
    _, cfg = _cfgs(tmp_path, dropout=0.3, epochs=3, lr=3e-3)
    art = dense_t5_pipeline.train(cfg, corpus, items, users, device="cpu")
    assert art.result.train_losses[-1] < art.result.train_losses[0]
    metrics = dense_t5_pipeline.evaluate(cfg, art, corpus, items, users, device="cpu")
    assert metrics["Recall@10"] >= metrics["Recall@5"] and metrics["Recall@10"] > 10 / ITEMS

    paths = {k: str(tmp_path / "data" / f"{k}.h5") for k in ("inter", "items", "users")}
    jax_contracts.write_interactions(paths["inter"], corpus)
    contracts.write_item_embs(paths["items"], items)
    contracts.write_user_embs(paths["users"], users)
    cfg = dataclasses.replace(cfg, rec_path=paths["inter"], item_emb_h5_path=paths["items"],
                              user_emb_h5_path=paths["users"],
                              trainer=dataclasses.replace(cfg.trainer, epochs=1,
                                                          ckpt_dir=str(tmp_path / "main")))
    metrics = dense_t5_pipeline.main(cfg, device="cpu")
    assert set(metrics) == {"Recall@5", "Recall@10", "NDCG@5", "NDCG@10"}
    assert torch.load(tmp_path / "main" / "best.pt", weights_only=True)


def test_model_fn_serves_the_jax_lists(tmp_path, data):
    """The same weights as JAX's best checkpoint and as the port's: equal
    lists for histories with ids outside (0, n_items], longer than
    max_seq_len, empty; with the zero profile vector and with a given one;
    from the file and from the table; None without a checkpoint."""
    _, items, users = data
    jcfg, tcfg = _cfgs(tmp_path)
    params = _jax_initial_params(jcfg)
    store = CheckpointStore(str(tmp_path / "jax_ckpt"))
    store.save_best({"params": params})
    store.wait()
    save_best(dense_t5_params_from_flax(params, tcfg), str(tmp_path / "port_ckpt"))
    h5 = str(tmp_path / "items.h5")
    contracts.write_item_embs(h5, items)
    histories = [[], [3], [5, 9, 2, 0, 77, -1], list(range(1, 16)), [ITEMS, ITEMS + 1]]
    for prof in (None, users[4]):
        want_fn = jax_model_fn(str(tmp_path / "jax_ckpt"), h5, cfg=jcfg, user_emb=prof)
        got_fn = dense_t5_model_fn(str(tmp_path / "port_ckpt"), h5, cfg=tcfg, user_emb=prof,
                                   device="cpu")
        for hist in histories:
            got = got_fn(hist, 10)
            assert got == want_fn(hist, 10), (hist, prof is None)
            assert len(got) == 10 == len(set(got)) and all(0 < i <= ITEMS for i in got)
            assert not set(got) & {i for i in hist[-L:] if 0 < i <= ITEMS}
        assert len(got_fn([1], 100)) == ITEMS
        from_table = dense_t5_model_fn(str(tmp_path / "port_ckpt"), items, cfg=tcfg,
                                       user_emb=prof, device="cpu")
        assert all(from_table(hist, 10) == got_fn(hist, 10) for hist in histories)
    assert dense_t5_model_fn(str(tmp_path / "empty"), h5, cfg=tcfg, device="cpu") is None

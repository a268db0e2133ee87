"""The port's TIGER-prefix pipeline (genrec_tpu_torch/pipelines/
tiger_prefix_pipeline.py) against the JAX package's, on the CPU at a tiny
size.

- From the same initial weights (the reference pipeline's own init,
  converted) at dropout 0, ``train``, streaming through the batch-factory
  trainer as JAX's does, gives per-epoch train and validation losses within
  1e-4 of JAX's (f32 forward, backward and Adam, each summed in another
  order).
- ``evaluate`` of the same parameters gives JAX's Recall/NDCG exactly (the
  same generated tokens), and writes the results CSV.
- End to end, mirroring tests/test_pipelines.py::test_tiger_prefix_end_to_end:
  ``attach_prof`` joins (users missing from a prof file get zero rows), the
  model learns at dropout 0.1, ``main`` reads the split and prof files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.data import datasets as jax_datasets
from genrec_tpu.models import tiger_prefix as jax_tp
from genrec_tpu.pipelines import tiger_prefix_pipeline as jax_pipeline
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import tiger_prefix_params_from_flax
from genrec_tpu_torch.data import contracts, datasets, synthetic, tiger_tokens
from genrec_tpu_torch.models.tiger_prefix import TIGERPrefix
from genrec_tpu_torch.pipelines import tiger_prefix_pipeline

BERT = 16


def _cfgs(path, dropout=0.0, **trainer):
    tr = dict(dict(epochs=2, batch_size=64, eval_batch_size=64, lr=3e-3, seed=0,
                   ckpt_dir=str(path / "ckpt"), early_stop_patience=10), **trainer)
    arch = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=32, d_ff=64,
                num_heads=2, d_kv=16, dropout_rate=dropout)
    kw = dict(max_len=8, beam_size=5, topk_list=(2, 5), bert_dim=BERT,
              constrained_decoding="level")
    return (jconfigs.TIGERPrefixConfig(arch=jconfigs.T5ArchConfig(**arch, fused_attention="off"),
                                       trainer=jconfigs.TrainerConfig(**tr), **kw),
            configs.TIGERPrefixConfig(arch=configs.T5ArchConfig(**arch),
                                      trainer=configs.TrainerConfig(**tr), **kw))


@pytest.fixture(scope="module")
def data():
    corpus = synthetic.make_interactions(num_users=300, num_items=60, min_len=4, max_len=15,
                                         num_topics=6, topic_stickiness=0.95, seed=7)
    codes = synthetic.make_codes(num_items=60, seed=5)
    tr_split, te_split = tiger_tokens.build_tiger_splits(corpus.item_id_lists,
                                                         corpus.user_ids, codes)
    profs = [synthetic.make_prof_embs(corpus.num_users, 5, BERT, seed=s) for s in (2, 3, 4)]
    tr = datasets.build_tiger_arrays(tr_split, 8, 4)
    te = datasets.build_tiger_arrays(te_split, 8, 4, max_target_items=1)
    return dict(splits=(tr_split, te_split), profs=profs,
                train=tiger_prefix_pipeline.attach_prof(tr, profs),
                test=tiger_prefix_pipeline.attach_prof(te, profs))


def _jax_initial_params(jcfg, seq):
    """The JAX pipeline's own init (tiger_prefix_pipeline.py:94-100)."""
    prof0 = jnp.zeros((1, jcfg.num_prof_vectors, jcfg.bert_dim), jnp.float32)
    params = jax.jit(jax_tp.TIGERPrefix(jcfg).init)(
        jax.random.PRNGKey(jcfg.trainer.seed), jnp.zeros((1, seq), jnp.int32),
        jnp.ones((1, seq), jnp.int32), jnp.ones((1, jcfg.code_dim), jnp.int32),
        prof0, prof0, prof0)
    return jax.tree_util.tree_map(np.asarray, params)


def test_attach_prof_joins_by_user_and_zero_fills_missing(data):
    tr = datasets.build_tiger_arrays(data["splits"][0], 8, 4)
    uids, embs = data["profs"][0]
    keep = uids % 3 != 0  # a prof file without every third user
    got = tiger_prefix_pipeline.attach_prof(tr, [(uids[keep], embs[keep])] * 3)
    want = jax_pipeline.attach_prof(jax_datasets.TigerArrays(
        tr.input_ids, tr.attention_mask, tr.labels, tr.user_ids), [(uids[keep], embs[keep])] * 3)
    assert set(got) == set(want) and got["prof_lvl1"].shape == (len(tr.user_ids), 5, BERT)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    missing = tr.user_ids % 3 == 0
    assert missing.any() and not got["prof_lvl2"][missing].any()


def test_epoch_losses_and_metrics_match_the_jax_pipeline(tmp_path, data, monkeypatch):
    jcfg, tcfg = _cfgs(tmp_path / "jax")
    tcfg = dataclasses.replace(tcfg, trainer=dataclasses.replace(
        tcfg.trainer, ckpt_dir=str(tmp_path / "port"),
        results_csv_path=str(tmp_path / "prefix.csv")))
    want = jax_pipeline.train(jcfg, data["train"], data["test"])
    params = _jax_initial_params(jcfg, jcfg.max_len * jcfg.code_dim)
    monkeypatch.setattr(tiger_prefix_pipeline, "build_model", lambda cfg: _loaded(cfg, params))
    got = tiger_prefix_pipeline.train(tcfg, data["train"], data["test"], device="cpu")
    assert got.result.epochs_run == want.result.epochs_run == 2
    steps = datasets.num_batches(len(data["train"]["input_ids"]), 64)
    assert got.result.steps_run == 2 * steps
    np.testing.assert_allclose(got.result.train_losses, want.result.train_losses, atol=1e-4)
    np.testing.assert_allclose(got.result.val_losses, want.result.val_losses, atol=1e-4)

    # evaluate the JAX-trained parameters on both sides
    trained = jax.tree_util.tree_map(np.asarray, want.params)
    want_m = jax_pipeline.evaluate(jcfg, want, data["test"])
    got_m = tiger_prefix_pipeline.evaluate(
        tcfg, tiger_prefix_pipeline.TIGERPrefixArtifacts(
            tiger_prefix_params_from_flax(trained, tcfg), None), data["test"], device="cpu")
    assert set(got_m) == {"Recall@2", "Recall@5", "NDCG@2", "NDCG@5"} == set(want_m)
    for k in got_m:
        assert abs(got_m[k] - want_m[k]) < 1e-6, (k, got_m, want_m)
    assert (tmp_path / "prefix.csv").exists()


def _loaded(cfg, flax_params):
    model = TIGERPrefix(cfg)
    model.load_state_dict(tiger_prefix_params_from_flax(flax_params, cfg))
    return model


def test_tiger_prefix_end_to_end_and_main(tmp_path, data):
    _, cfg = _cfgs(tmp_path, dropout=0.1, epochs=3)
    art = tiger_prefix_pipeline.train(cfg, data["train"], data["test"], device="cpu")
    assert art.result.train_losses[-1] < art.result.train_losses[0]
    metrics = tiger_prefix_pipeline.evaluate(cfg, art, data["test"], device="cpu")
    assert metrics["Recall@5"] >= metrics["Recall@2"] and metrics["Recall@5"] > 0.0

    paths = {k: str(tmp_path / "data" / f"{k}.h5") for k in ("train", "test")}
    for k, split in zip(("train", "test"), data["splits"]):
        contracts.write_tiger_split(paths[k], split)
    prof_paths = tuple(str(tmp_path / "data" / f"prof_lvl{i}.h5") for i in (1, 2, 3))
    for p, (uids, embs) in zip(prof_paths, data["profs"]):
        contracts.write_prof_lvl(p, uids, embs)
    cfg = dataclasses.replace(cfg, train_dataset_path=paths["train"],
                              test_dataset_path=paths["test"], prof_lvl_paths=prof_paths,
                              trainer=dataclasses.replace(cfg.trainer, epochs=1,
                                                          ckpt_dir=str(tmp_path / "main")))
    metrics = tiger_prefix_pipeline.main(cfg, device="cpu")
    assert set(metrics) == {"Recall@2", "Recall@5", "NDCG@2", "NDCG@5"}
    assert torch.load(tmp_path / "main" / "best.pt", weights_only=True)

"""The port's SASRec data, evaluation, pipeline and serving
(genrec_tpu_torch/data/{contracts,datasets}.py, eval/evaluator.py,
pipelines/sasrec_pipeline.py, serving/model_fn.py) against the JAX
package's, on the CPU at a tiny size.

Arrays and ranks are equal to JAX's; the pipeline trains, learns, evaluates,
writes the results CSV and resumes, as the JAX package's own
tests/test_pipelines.py asks of it (dropout streams differ, so parity is the
model learning); ``sasrec_model_fn`` serves the same item lists as JAX's
``SASRec.predict`` for converted weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.data import datasets as jdatasets
from genrec_tpu.data import synthetic as jsynthetic
from genrec_tpu.data.contracts import write_interactions
from genrec_tpu.eval.evaluator import rank_evaluate as jax_rank_evaluate
from genrec_tpu.models.sasrec import SASRec as JaxSASRec
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import sasrec_params_from_flax
from genrec_tpu_torch.data import datasets, synthetic
from genrec_tpu_torch.eval.evaluator import rank_evaluate
from genrec_tpu_torch.pipelines import sasrec_pipeline
from genrec_tpu_torch.serving.model_fn import sasrec_model_fn
from genrec_tpu_torch.train.checkpoint import save_best


@pytest.fixture(scope="module")
def corpus():
    return synthetic.make_interactions(num_users=300, num_items=60, min_len=4, max_len=15,
                                       num_topics=6, topic_stickiness=0.95, seed=7)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_build_sasrec_arrays_equals_jax(use_native, mode):
    data = jsynthetic.make_interactions(num_users=50, num_items=30, min_len=2, max_len=14,
                                        seed=3)
    want = jdatasets.build_sasrec_arrays(data, 8, mode, 3, use_native=use_native)
    got = datasets.build_sasrec_arrays(data, 8, mode, 3)
    assert got.item_num == want.item_num
    for k, v in want.arrays.items():
        assert got.arrays[k].dtype == v.dtype
        np.testing.assert_array_equal(got.arrays[k], v)


def test_rank_evaluate_equals_jax():
    """Integer-valued logits, so that ties exercise the strict rank; target 0
    and the padded rows of the last batch are skipped."""
    r = np.random.default_rng(0)
    arrays = {"targets": r.integers(0, 12, size=10).astype(np.int32)}
    batches = list(jdatasets.iterate_batches(arrays, 4, shuffle=False))
    for b in batches:
        b["logits"] = r.integers(0, 5, size=(4, 13)).astype(np.float32)
    want = jax_rank_evaluate(lambda b: jnp.asarray(b["logits"]), iter(batches), (1, 3, 5))
    got = rank_evaluate(lambda b: torch.from_numpy(b["logits"]), iter(batches), (1, 3, 5))
    assert got == pytest.approx(want, abs=1e-12)


def _cfg(tmp_path, **kw):
    trainer = dict(epochs=8, batch_size=64, eval_batch_size=64, lr=1e-2,
                   ckpt_dir=str(tmp_path / "ckpt"), early_stop_patience=10, seed=0)
    trainer.update(kw.pop("trainer", {}))
    base = dict(d=16, num_blocks=1, num_heads=1, mlp_layer=32, max_len=10, dropout=0.1,
                num_neg_samples=5, topk_list=(5, 10))
    base.update(kw)
    return configs.SASRecConfig(trainer=configs.TrainerConfig(**trainer), **base)


def test_sasrec_pipeline_trains_evaluates_and_resumes(tmp_path, corpus):
    cfg = _cfg(tmp_path, trainer=dict(results_csv_path=str(tmp_path / "res.csv")))
    art = sasrec_pipeline.train(cfg, corpus, device="cpu")
    assert art.result.train_losses[-1] < art.result.train_losses[0]
    assert art.item_num == corpus.max_item_id
    metrics = sasrec_pipeline.evaluate(cfg, art, corpus, device="cpu")
    assert set(metrics) == {f"{m}@{k}" for m in ("Hit", "NDCG") for k in (5, 10)}
    assert metrics["Hit@10"] > 0.2  # random Hit@10 on 60 items ≈ 0.167
    assert (tmp_path / "res.csv").exists()

    cfg2 = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, epochs=9,
                                                                resume=True))
    art2 = sasrec_pipeline.train(cfg2, corpus, device="cpu")
    assert len(art2.result.train_losses) == 1 and art2.result.epochs_run == 9


def test_sasrec_main_reads_the_interactions_file(tmp_path, corpus):
    h5 = str(tmp_path / "user_item_interact.h5")
    write_interactions(h5, corpus)
    cfg = _cfg(tmp_path, data_path=h5, trainer=dict(epochs=1))
    metrics = sasrec_pipeline.main(cfg, device="cpu")
    assert set(metrics) == {f"{m}@{k}" for m in ("Hit", "NDCG") for k in (5, 10)}


def test_sasrec_model_fn_serves_what_jax_predict_ranks(tmp_path, corpus):
    """Flax weights, converted and saved as the best checkpoint, served from
    an ``InteractionData`` and from the H5 file: the item lists equal the
    top-k of JAX's ``SASRec.predict`` without padding and history."""
    cfg = _cfg(tmp_path, dropout=0.0)
    jcfg = jconfigs.SASRecConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg) if f.name != "trainer"})
    item_num = corpus.max_item_id
    jm = JaxSASRec(item_num=item_num, cfg=jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, cfg.max_len), jnp.int32))
    ckpt = str(tmp_path / "served")
    save_best(sasrec_params_from_flax(params, item_num, cfg), ckpt)
    h5 = str(tmp_path / "user_item_interact.h5")
    write_interactions(h5, corpus)

    def jax_serve(history, top_k):
        ids = [i for i in history if 0 < i <= item_num][-cfg.max_len:]
        seq = np.zeros((1, cfg.max_len), np.int32)
        if ids:
            seq[0, cfg.max_len - len(ids):] = ids
        logits = np.asarray(jm.apply(params, jnp.asarray(seq), method=JaxSASRec.predict))[0]
        logits = logits.copy()
        logits[0] = -np.inf
        logits[np.asarray(ids, np.int64)] = -np.inf
        return [int(t) for t in np.argsort(-logits)[:min(top_k, item_num)]]

    histories = [[], [3], [5, 9, 2, 0, 77], list(range(1, 16))]
    for source in (corpus, h5):
        fn = sasrec_model_fn(ckpt, source, cfg=cfg, device="cpu")
        for hist in histories:
            got = fn(hist, 10)
            assert got == jax_serve(hist, 10), hist
            # the history beyond max_len is cut before the exclusion, as in the reference
            assert not set(got) & set(hist[-cfg.max_len:]) and 0 not in got
    assert sasrec_model_fn(str(tmp_path / "empty"), corpus, cfg=cfg, device="cpu") is None

"""The port's Trainer and checkpoints (genrec_tpu_torch/train/{trainer,
checkpoint}.py) against the JAX package's Trainer.

A tiny TIGER at dropout 0 trains on the same numpy arrays from the same
initial weights (Flax init → ``tiger_params_from_flax``) with the same
config on both sides: the index matrices are equal and the per-epoch train
and validation losses agree within 1e-4 over 2 epochs (f32 forward,
backward and Adam updates, each summed in another order). Then early stop,
resume, checkpoint retention and the abort on a non-finite loss.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TIGERConfig as JaxTIGERConfig
from genrec_tpu.configs import T5ArchConfig as JaxArch
from genrec_tpu.configs import TrainerConfig as JaxTrainerConfig
from genrec_tpu.data import datasets as jax_datasets
from genrec_tpu.data import synthetic as jax_synthetic
from genrec_tpu.data import tiger_tokens as jax_tokens
from genrec_tpu.models.tiger import TIGER as JaxTIGER
from genrec_tpu.pipelines.tiger_pipeline import _loss_fn as jax_loss_fn
from genrec_tpu.train.trainer import Trainer as JaxTrainer
from genrec_tpu_torch.configs import T5ArchConfig, TIGERConfig, TrainerConfig
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models.tiger import TIGER
from genrec_tpu_torch.pipelines.tiger_pipeline import loss_fn
from genrec_tpu_torch.train.checkpoint import CheckpointStore
from genrec_tpu_torch.train.trainer import Trainer

ARCH = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=32, d_ff=64,
            num_heads=2, d_kv=16, dropout_rate=0.0)
MAX_LEN = 6


@pytest.fixture(scope="module")
def data():
    corpus = jax_synthetic.make_interactions(num_users=90, num_items=40, min_len=4,
                                             max_len=10, num_topics=4, seed=3)
    codes = jax_synthetic.make_codes(40, seed=1)
    tr, te = jax_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    return (jax_datasets.build_tiger_arrays(tr, MAX_LEN, 4),
            jax_datasets.build_tiger_arrays(te, MAX_LEN, 4, max_target_items=1))


def _cfg(tmp_path, **kw):
    base = dict(epochs=2, batch_size=32, eval_batch_size=32, lr=3e-3,
                ckpt_dir=str(tmp_path / "ckpt"), early_stop_patience=10, seed=0)
    base.update(kw)
    return TIGERConfig(arch=T5ArchConfig(**ARCH), max_len=MAX_LEN,
                       trainer=TrainerConfig(**base))


def _flax_params(cfg):
    jc = JaxTIGERConfig(arch=JaxArch(**ARCH), max_len=MAX_LEN)
    seq = cfg.max_len * cfg.code_dim
    params = JaxTIGER(jc).init(jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32),
                               jnp.ones((1, seq), jnp.int32),
                               jnp.ones((1, cfg.code_dim), jnp.int32))
    return jc, jax.tree_util.tree_map(np.asarray, params)


def _port_trainer(cfg, data, params=None):
    tr, te = data
    model = TIGER(cfg, generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict(tiger_params_from_flax(params, cfg))
    return Trainer(cfg.trainer, model=model, loss_fn=loss_fn, train_data=tr.arrays,
                   val_data=te.arrays, logger_name="tiger_test", device="cpu")


@pytest.mark.parametrize("n,bsz,seed", [(90, 32, 1), (64, 32, 7), (5, 8, 0)])
def test_index_matrix_equals_the_reference(n, bsz, seed):
    for shuffle in (False, True):
        np.testing.assert_array_equal(
            Trainer._index_matrix(n, bsz, shuffle=shuffle, seed=seed),
            JaxTrainer._index_matrix(n, bsz, shuffle=shuffle, seed=seed))


def test_epoch_losses_match_the_jax_trainer(tmp_path, data):
    cfg = _cfg(tmp_path / "port")
    jc, params = _flax_params(cfg)
    tr, te = data
    jcfg = JaxTrainerConfig(**dict(dataclasses.asdict(cfg.trainer),
                                   ckpt_dir=str(tmp_path / "jax")))
    jloss, jval = jax_loss_fn(JaxTIGER(jc))
    steps = -(-len(tr.input_ids) // jcfg.batch_size)
    want = JaxTrainer(jcfg, init_params=params, loss_fn=jloss, eval_loss_fn=jval,
                      steps_per_epoch=steps, logger_name="tiger_jax_test",
                      train_data=tr.arrays, val_data=te.arrays).fit()
    got = _port_trainer(cfg, data, params).fit()
    assert got.epochs_run == want.epochs_run == 2
    assert got.steps_run == 2 * steps
    np.testing.assert_allclose(got.train_losses, want.train_losses, atol=1e-4)
    np.testing.assert_allclose(got.val_losses, want.val_losses, atol=1e-4)
    assert got.train_losses[-1] < got.train_losses[0]


def test_early_stop_saves_the_stopping_state(tmp_path, data):
    # lr 0: the val loss never improves after epoch 1, so patience 1 stops at 2;
    # the cadence of 3 skipped epoch 2's latest state, which is saved anyway
    cfg = _cfg(tmp_path, epochs=5, lr=0.0, early_stop_patience=1, ckpt_every_epochs=3)
    trainer = _port_trainer(cfg, data)
    res = trainer.fit()
    assert res.epochs_run == 2 and len(res.train_losses) == 2
    assert trainer.store.latest_step() == res.steps_run
    assert trainer.store.restore_best() is not None


def test_resume_continues_at_the_next_epoch(tmp_path, data):
    """A run of 2 epochs resumed to 3 runs one epoch (the reference's
    test_sasrec_resume) and lands where 3 uninterrupted epochs land."""
    full = _port_trainer(_cfg(tmp_path / "full", epochs=3), data).fit()
    _port_trainer(_cfg(tmp_path, epochs=2), data).fit()
    res = _port_trainer(_cfg(tmp_path, epochs=3, resume=True), data).fit()
    assert len(res.train_losses) == 1 and res.epochs_run == 3
    assert abs(res.train_losses[0] - full.train_losses[2]) < 1e-6
    for k, v in res.final_params.items():
        torch.testing.assert_close(v, full.final_params[k], rtol=0, atol=1e-6)


def test_latest_checkpoints_keep_the_newest(tmp_path, data):
    cfg = _cfg(tmp_path, epochs=4, keep_checkpoints=2)
    trainer = _port_trainer(cfg, data)
    res = trainer.fit()
    steps = res.steps_run // 4
    assert trainer.store.steps() == [3 * steps, 4 * steps]
    state = trainer.store.restore_latest()
    assert state["step"] == 4 * steps and state["epoch"] == 4
    assert set(state) == {"model", "optimizer", "scheduler", "step", "epoch", "best_val"}
    assert not [n for n in os.listdir(trainer.store.dir) if n.endswith(".pt")
                and not n.startswith(("latest_", "best"))]  # no temporary file left


def test_checkpoint_store_round_trip(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    assert store.latest_step() is None and store.restore_latest() is None
    assert store.restore_best() is None
    for step in (5, 10, 15):
        store.save_latest(step, {"step": step, "w": torch.full((2,), float(step))})
    assert store.steps() == [10, 15]
    assert torch.equal(store.restore_latest()["w"], torch.full((2,), 15.0))
    store.save_best({"w": torch.ones(3)})
    assert torch.equal(store.restore_best()["w"], torch.ones(3))
    with pytest.raises(ValueError):
        CheckpointStore(str(tmp_path), keep=0)


def test_non_finite_loss_aborts(tmp_path, data):
    trainer = _port_trainer(_cfg(tmp_path, epochs=1), data)

    def nan_loss(model, batch, generator):
        loss, aux = loss_fn(model, batch, generator)
        return loss, dict(aux, sum_loss=aux["sum_loss"] * float("nan"))

    trainer.loss_fn = nan_loss
    with pytest.raises(ValueError, match="diverged"):
        trainer.fit()


def test_epoch_end_callback_runs_once_per_epoch_with_the_trainer(tmp_path, data):
    trainer = _port_trainer(_cfg(tmp_path, epochs=3), data)
    seen = []

    def callback(epoch, tr):
        assert tr is trainer and tr.start_epoch == epoch
        assert tr.store.latest_step() == tr.step  # after the epoch's latest-state save
        seen.append((epoch, tr.snapshot_params()))

    res = trainer.fit(epoch_end_callback=callback)
    assert [e for e, _ in seen] == [1, 2, 3]
    for k, v in res.final_params.items():  # the last snapshot is the final state
        assert torch.equal(seen[-1][1][k], v)
    assert not torch.equal(seen[0][1]["model.shared.weight"], seen[-1][1]["model.shared.weight"])


def test_save_best_with_a_tag_writes_its_own_file(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save_best({"w": torch.ones(2)})
    store.save_best({"w": torch.zeros(2)}, tag="best_collision")
    assert sorted(os.listdir(tmp_path)) == ["best.pt", "best_collision.pt"]
    assert torch.equal(store.restore_best()["w"], torch.ones(2))
    assert torch.equal(store.restore_best("best_collision")["w"], torch.zeros(2))
    assert store.restore_best("other") is None

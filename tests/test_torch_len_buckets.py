"""The port's length-bucketed and composite-width training against the JAX
package's.

- ``bucket_by_target_len``, ``target_len_widths`` and ``_composite_plan``
  are copies: the same partitions, widths and plans on the same arrays;
- the port's ``Trainer`` on the JAX Trainer's linear-regression setups
  (``tests/test_trainer.py``), in both modes: per-epoch losses within 1e-5
  relative, the same step count, each row once an epoch, the same widths
  run; one bucket is the flat path;
- ``tiger_pipeline.train`` at ``target_len_buckets=2`` and
  ``target_len_composite=2``, dropout 0, from the Flax weights JAX's
  pipeline draws: per-epoch losses within 1e-4 relative of JAX's;
- the CLI's ``tiger --len-buckets 2`` trains; composite widths refuse
  buckets and sharded datasets, where the reference asserts;
- two gloo ranks train bucketed in sharded-dataset mode (each bucket's rows
  split over 'data') and equal the JAX Trainer on a 2-device data axis.
  The ranks run this file as a script (``spawn_ranks`` of
  ``test_torch_parallel.py``) and import no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import spawn_ranks  # noqa: E402

ARCH = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=16, d_ff=32,
            num_heads=2, d_kv=8, dropout_rate=0.0)
MAX_LEN = 6
WORLD = 2


# --------------------------------------------------------------------------
# the linear-regression setups of tests/test_trainer.py, on both sides
# --------------------------------------------------------------------------

def _regression_data(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.normal(size=n).astype(np.float32)
    return {"x": x, "y": y}


def _composite_data(n=256, width=16):
    """tests/test_trainer.py:236's rows: y repeated over a per-row target
    length, -100 padded; returns (data, row widths)."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8,)).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = x @ w_true
    row_w = rng.choice([4, 8, 16], size=n)
    labels = np.full((n, width), -100.0, np.float32)
    for i, length in enumerate(row_w):
        labels[i, :length] = y[i]
    return {"x": x, "labels": labels}, row_w


class _Linear(nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d))


def _regression_loss(model, batch, generator):
    valid = batch["valid"].float()
    se = (batch["x"] @ model.w - batch["y"]) ** 2 * valid
    return se.sum() / valid.sum().clamp(min=1.0), {"sum_loss": se.sum(), "valid": valid.sum()}


def _labels_loss(model, batch, generator):
    lab = batch["labels"]
    m = (lab != -100.0) & batch["valid"][:, None]
    se = torch.where(m, ((batch["x"] @ model.w)[:, None] - lab) ** 2, 0.0)
    return se.sum() / m.sum().clamp(min=1), {"sum_loss": se.sum(), "valid": m.sum().float()}


def _jax_regression_loss(p, batch, rng_):
    import jax.numpy as jnp

    valid = batch["valid"].astype(jnp.float32)
    se = (batch["x"] @ p["w"] - batch["y"]) ** 2 * valid
    return se.sum() / jnp.maximum(valid.sum(), 1.0), {"sum_loss": se.sum(), "valid": valid.sum()}


def _jax_labels_loss(p, batch, rng_):
    import jax.numpy as jnp

    lab = batch["labels"]
    m = (lab != -100.0) & batch["valid"][:, None]
    se = jnp.where(m, ((batch["x"] @ p["w"])[:, None] - lab) ** 2, 0.0)
    return se.sum() / jnp.maximum(m.sum(), 1), {"sum_loss": se.sum(), "valid": m.sum()}


def _two_buckets(data, cut=100):
    return [{k: v[:cut] for k, v in data.items()}, {k: v[cut:] for k, v in data.items()}]


# --------------------------------------------------------------------------
# rank side: run as ``python test_torch_len_buckets.py <rank> <world> <rdv> <out>``
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist

    from genrec_tpu_torch.configs import MeshConfig, TrainerConfig
    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.parallel.mesh import initialize_multihost
    from genrec_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    try:
        cfg = TrainerConfig(epochs=4, batch_size=64, lr=0.1, shard_dataset=True,
                            ckpt_dir=os.path.join(out, "ckpt"), early_stop_patience=50)
        data = _regression_data(n=230)
        trainer = Trainer(cfg, model=_Linear(), loss_fn=_regression_loss,
                          train_data_buckets=_two_buckets(data, 101), val_data=data,
                          logger_name="buckets_dp", device="cpu",
                          mesh=dp_shardings(MeshConfig()))
        r = trainer.fit()
        torch.save({"train": r.train_losses, "val": r.val_losses, "steps": r.steps_run,
                    "rows": [len(b["x"]) for b in trainer.train_buckets]},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# pytest side
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiger_arrays():
    from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens

    corpus = synthetic.make_interactions(num_users=80, num_items=40, min_len=4, max_len=12,
                                         num_topics=4, seed=3)
    codes = synthetic.make_codes(40, seed=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    return (datasets.build_tiger_arrays(tr, MAX_LEN, 4),
            datasets.build_tiger_arrays(te, MAX_LEN, 4, max_target_items=1))


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4])
def test_length_partitions_equal_the_reference(tiger_arrays, n_buckets):
    from genrec_tpu.data import datasets as jd
    from genrec_tpu_torch.data import datasets

    arrays = tiger_arrays[0].arrays
    got, want = (m.bucket_by_target_len(arrays, n_buckets, 4) for m in (datasets, jd))
    assert [len(b["labels"]) for b in got] == [len(b["labels"]) for b in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    (rw, ws), (jrw, jws) = (m.target_len_widths(arrays, n_buckets, 4) for m in (datasets, jd))
    assert ws == jws == [b["labels"].shape[1] for b in got]
    np.testing.assert_array_equal(rw, jrw)


@pytest.mark.parametrize("trial", range(-1, 12))
def test_composite_plan_equals_the_reference(trial):
    """Trial -1: tests/test_trainer.py:214's plan; 0-11: the property fuzz
    of tests/test_trainer.py:293, trial by trial."""
    from genrec_tpu.train.trainer import Trainer as JTrainer
    from genrec_tpu_torch.train.trainer import Trainer

    if trial < 0:
        rng = np.random.default_rng(0)
        row_w = rng.choice([4, 8, 12, 16], size=500, p=[0.4, 0.3, 0.2, 0.1])
        args = (row_w, [4, 8, 12, 16], 32, 0.5, 7)
    else:
        rng = np.random.default_rng(123)
        for _ in range(trial + 1):  # the fuzz draws its trials from one stream
            n = int(rng.integers(5, 400))
            k = int(rng.integers(1, 5))
            widths = sorted(rng.choice(np.arange(1, 40) * 4, size=k, replace=False).tolist())
            row_w = rng.choice(widths, size=n, p=rng.dirichlet(np.ones(k))).astype(np.int64)
            bs = int(rng.choice([8, 16, 64, 512]))
            mix = float(rng.choice([0.0, 0.25, 0.5, 0.9]))
        args = (row_w, widths, bs, mix, trial)
    got, want = Trainer._composite_plan(*args), JTrainer._composite_plan(*args)
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _jax_trainer(cfg, loss, data=None, **kw):
    import jax.numpy as jnp

    from genrec_tpu.configs import TrainerConfig as JTrainerConfig
    from genrec_tpu.train.trainer import Trainer as JTrainer

    jcfg = JTrainerConfig(**dict(dataclasses.asdict(cfg), ckpt_dir=cfg.ckpt_dir + "_jax"))
    return JTrainer(jcfg, init_params={"w": jnp.zeros(8)}, loss_fn=loss, train_data=data, **kw)


@pytest.mark.parametrize("mode", ["buckets", "composite"])
def test_trainer_modes_equal_the_jax_trainer(tmp_path, mode):
    """tests/test_trainer.py:87 (two buckets of 100 and 156 rows, validation
    on the whole set) and :236 (composite widths 4, 8, 16): per-epoch losses
    within 1e-5 relative, the same steps, each row once an epoch, the same
    widths run."""
    from genrec_tpu_torch.configs import TrainerConfig
    from genrec_tpu_torch.train.trainer import Trainer

    cfg = TrainerConfig(epochs=6, batch_size=64, lr=0.1, ckpt_dir=str(tmp_path / "c"),
                        early_stop_patience=50)
    if mode == "buckets":
        data = _regression_data()
        want_tr = _jax_trainer(cfg, _jax_regression_loss, train_data_buckets=_two_buckets(data),
                               val_data=data)
        got_tr = Trainer(cfg, model=_Linear(), loss_fn=_regression_loss, device="cpu",
                         train_data_buckets=_two_buckets(data), val_data=data)
        steps = 2 + 3  # ceil(100 / 64) + ceil(156 / 64)
    else:
        data, row_w = _composite_data()
        kw = dict(composite_widths=[4, 8, 16], row_widths=row_w, width_slice_keys=("labels",))
        want_tr = _jax_trainer(cfg, _jax_labels_loss, data, **kw)
        got_tr = Trainer(cfg, model=_Linear(), loss_fn=_labels_loss, device="cpu",
                         train_data=data, **kw)
        steps = sum(len(m) for _, m in Trainer._composite_plan(row_w, [4, 8, 16], 64, 0.5,
                                                               cfg.seed + 1))
    want, got = want_tr.fit(), got_tr.fit()
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=1e-5)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-5)
    assert got.train_losses[-1] < got.train_losses[0] / 10
    assert got.steps_run == got_tr.step == want_tr.step
    if mode == "buckets":
        assert got.steps_run == cfg.epochs * steps
    else:
        assert sorted(got_tr.widths_run) == sorted(want_tr._composite_fns) and 16 in got_tr.widths_run
    for epoch in (1, cfg.epochs):  # every row of every dataset once an epoch
        seen = {}
        for rows, _, chunk, _ in got_tr._epoch_work(epoch):
            seen.setdefault(id(rows), []).extend(chunk[chunk >= 0].tolist())
        assert all(sorted(v) == list(range(len(v))) for v in seen.values())
        assert sorted(map(len, seen.values())) == ([100, 156] if mode == "buckets" else [256])
    if mode == "composite":
        assert sum(len(c) for _, _, c, _ in got_tr._epoch_work(1)) == steps


def test_one_bucket_is_the_flat_path(tmp_path):
    from genrec_tpu_torch.configs import TrainerConfig
    from genrec_tpu_torch.train.trainer import Trainer

    data = _regression_data(n=100)
    runs = []
    for kw in ({"train_data": data}, {"train_data_buckets": [data]}):
        cfg = TrainerConfig(epochs=3, batch_size=32, lr=0.1, ckpt_dir=str(tmp_path / str(len(runs))))
        runs.append(Trainer(cfg, model=_Linear(), loss_fn=_regression_loss, device="cpu",
                            val_data=data, **kw).fit())
    assert runs[0].train_losses == runs[1].train_losses
    assert runs[0].steps_run == runs[1].steps_run == 3 * 4


@pytest.mark.parametrize("mode", ["buckets", "composite"])
def test_tiger_pipeline_modes_equal_jax(tmp_path, monkeypatch, tiger_arrays, mode):
    """``tiger_pipeline.train`` at 2 buckets or 2 composite widths, dropout
    0, from the Flax weights JAX's pipeline draws: per-epoch losses within
    1e-4 relative of JAX's ``tiger_pipeline.train``."""
    import jax
    import jax.numpy as jnp

    from genrec_tpu import configs as jc
    from genrec_tpu.models.tiger import TIGER as JTIGER
    from genrec_tpu.pipelines import tiger_pipeline as jpipe
    from genrec_tpu_torch import configs
    from genrec_tpu_torch.convert import tiger_params_from_flax
    from genrec_tpu_torch.models.tiger import TIGER
    from genrec_tpu_torch.pipelines import tiger_pipeline

    field = "target_len_buckets" if mode == "buckets" else "target_len_composite"
    trainer = dict(epochs=2, batch_size=32, eval_batch_size=32, lr=3e-3,
                   early_stop_patience=10, seed=0)
    cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(**ARCH), max_len=MAX_LEN,
                              trainer=configs.TrainerConfig(ckpt_dir=str(tmp_path / "p"),
                                                            **trainer), **{field: 2})
    jcfg = jc.TIGERConfig(arch=jc.T5ArchConfig(**ARCH), max_len=MAX_LEN,
                          trainer=jc.TrainerConfig(ckpt_dir=str(tmp_path / "j"), **trainer),
                          **{field: 2})
    seq = MAX_LEN * 4
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JTIGER(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32), jnp.ones((1, seq), jnp.int32),
        jnp.ones((1, 4), jnp.int32)))
    tr, te = tiger_arrays
    want = jpipe.train(jcfg, tr, te).result

    def from_flax(c, generator=None):
        model = TIGER(c)
        model.load_state_dict(tiger_params_from_flax(params, c))
        return model

    monkeypatch.setattr(tiger_pipeline, "TIGER", from_flax)
    got = tiger_pipeline.train(cfg, tr, te, device="cpu").result
    assert got.epochs_run == want.epochs_run == 2
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=1e-4)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-4)


def test_cli_len_buckets_trains(tmp_path, monkeypatch):
    """``tiger --len-buckets 2`` trains on two buckets and evaluates, through
    the CLI's own config; ``TIGERConfig()`` is cut to the tests' tiny widths
    and batch 16 (the CLI has no width flags)."""
    from genrec_tpu_torch import cli, configs
    from genrec_tpu_torch.pipelines import tiger_pipeline

    full = configs.TIGERConfig

    def tiny():
        return full(arch=configs.T5ArchConfig(**ARCH), trainer=configs.TrainerConfig(
            batch_size=16, eval_batch_size=16, epochs=500, lr=1e-3))

    buckets = []

    class Recording(tiger_pipeline.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            buckets.append(len(self.train_buckets))

    monkeypatch.setattr(configs, "TIGERConfig", tiny)
    monkeypatch.setattr(tiger_pipeline, "Trainer", Recording)
    data, ckpt = str(tmp_path / "d"), tmp_path / "ckpt"
    cli.main(["synth", "--out", data, "--users", "20", "--items", "30"])
    cli.main(["tiger", "--len-buckets", "2", "--device", "cpu", "--epochs", "1",
              "--constrained", "none", "--data-dir", data, "--ckpt-dir", str(ckpt)])
    assert buckets == [2]
    assert (ckpt / "best.pt").exists() and (ckpt / "RQVAE-T5-results.csv").exists()


@pytest.mark.parametrize("case", ["buckets", "sharded"])
def test_composite_refuses_buckets_and_sharded_data(tmp_path, case):
    """The reference asserts on both (genrec_tpu/train/trainer.py:340-343)."""
    from genrec_tpu_torch.configs import MeshConfig, TrainerConfig
    from genrec_tpu_torch.parallel.mesh import make_mesh
    from genrec_tpu_torch.train.trainer import Trainer

    data, row_w = _composite_data(n=32)
    kw = dict(composite_widths=[4, 8, 16], row_widths=row_w)
    cfg = TrainerConfig(batch_size=16, ckpt_dir=str(tmp_path / "c"),
                        shard_dataset=case == "sharded")
    if case == "buckets":
        kw.update(train_data_buckets=[data])
    else:
        kw.update(train_data=data, mesh=make_mesh(MeshConfig()))
    with pytest.raises(ValueError, match="composite widths"):
        Trainer(cfg, model=_Linear(), loss_fn=_labels_loss, device="cpu", **kw)


def test_sharded_buckets_on_two_ranks_equal_jax_on_two_devices(tmp_path):
    """Each bucket padded and split over 'data' (101 → 51 + 50 rows, 129 →
    65 + 64), each rank's batches from ``_index_matrix_sharded`` per bucket:
    the per-epoch losses of both ranks equal the JAX Trainer's in
    sharded-dataset mode on a 2-device data axis, over 2 + 3 steps an epoch."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from genrec_tpu.configs import MeshConfig as JMesh
    from genrec_tpu.parallel.mesh import make_mesh as jmake_mesh
    from genrec_tpu_torch.configs import TrainerConfig

    out = tmp_path / "ranks"
    out.mkdir()
    ranks = spawn_ranks(__file__, WORLD, out, timeout=120)
    data = _regression_data(n=230)
    mesh = jmake_mesh(JMesh(data_axis=2, model_axis=1), devices=jax.devices()[:2])
    cfg = TrainerConfig(epochs=4, batch_size=64, lr=0.1, shard_dataset=True,
                        ckpt_dir=str(tmp_path / "j"), early_stop_patience=50)
    want_tr = _jax_trainer(cfg, _jax_regression_loss, train_data_buckets=_two_buckets(data, 101),
                           val_data=data, batch_sharding=NamedSharding(mesh, P("data")),
                           replicate_sharding=NamedSharding(mesh, P()))
    want = want_tr.fit()
    for r in ranks:
        assert r["rows"] == [51, 65]
        np.testing.assert_allclose(r["train"], want.train_losses, rtol=1e-5)
        np.testing.assert_allclose(r["val"], want.val_losses, rtol=1e-5)
        assert r["steps"] == want_tr.step == 4 * (2 + 3)
    assert ranks[0]["train"] == ranks[1]["train"]

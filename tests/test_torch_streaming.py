"""The port's streaming Trainer (genrec_tpu_torch/train/trainer.py:
``fit(train_batches, val_batches)``, ``evaluate_loss(batches)``, ``_put``,
``steps_per_epoch``) against the JAX package's, on the CPU at a tiny size.

- The counterpart of ``tests/test_trainer.py:40``: on the same linear
  regression data, from the same weights, the JAX ``Trainer.fit`` over
  ``iterate_batches`` factories and the port's give per-epoch train and
  validation losses within 1e-5 (rel), and the port's streamed and resident
  routes on the same batches within 1e-6;
- ``evaluate_loss(batches)`` equals JAX's ``evaluate_loss(batches, rng)``;
- an epoch counts a batch's ``valid`` rows, or all its rows without
  ``valid`` (the reference's ``trainer.py:667-668``);
- a linear schedule with warm-up follows the caller's ``steps_per_epoch``,
  step by step, as the reference's optax schedule;
- a streamed run of 2 epochs resumed to 3 equals 3 straight;
- two gloo ranks, each fed its ``process_rows`` slice of every batch, give
  the one-rank run's losses within 1e-6 and the JAX Trainer's on one
  process (the setup of ``tests/test_multihost.py:322-371``) within 1e-5;
- ``_put`` on the CPU gives the arrays' values in the resident route's
  dtypes.

The rank processes run this file as a script and import no JAX; the JAX side
runs in the pytest process only.
"""

from __future__ import annotations

import dataclasses
import itertools
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_parallel import spawn_ranks  # noqa: E402

from genrec_tpu_torch.configs import TrainerConfig  # noqa: E402
from genrec_tpu_torch.data import datasets  # noqa: E402
from genrec_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from genrec_tpu_torch.train.trainer import Trainer  # noqa: E402

D = 8


def _linear_data(n=250, seed=0):
    """tests/test_trainer.py's linear regression data (n rows)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(D,)).astype(np.float32)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.normal(size=n).astype(np.float32)
    return {"x": x, "y": y}


class Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(np.asarray(w, np.float32)))


def loss_fn(model, batch, generator):
    """Squared error over the valid rows (every row without ``valid``)."""
    pred = batch["x"] @ model.w
    valid = batch["valid"].float() if "valid" in batch else torch.ones_like(pred)
    se = (pred - batch["y"]) ** 2 * valid
    return se.sum() / valid.sum().clamp(min=1.0), {"sum_loss": se.sum(), "valid": valid.sum()}


def _jax_loss(p, batch, rng_):
    import jax.numpy as jnp

    pred = batch["x"] @ p["w"]
    valid = (batch["valid"].astype(jnp.float32) if "valid" in batch
             else jnp.ones_like(pred))
    se = (pred - batch["y"]) ** 2 * valid
    return se.sum() / jnp.maximum(valid.sum(), 1.0), {"sum_loss": se.sum(), "valid": valid.sum()}


def _cfg(tmp_path, name, **kw):
    return TrainerConfig(**dict(dict(epochs=10, batch_size=64, eval_batch_size=64, lr=0.1,
                                     seed=0, ckpt_dir=str(tmp_path / name),
                                     early_stop_patience=50), **kw))


def _jax_cfg(cfg, tmp_path):
    from genrec_tpu.configs import TrainerConfig as JaxTrainerConfig

    return JaxTrainerConfig(**dict(dataclasses.asdict(cfg), ckpt_dir=str(tmp_path / "jax")))


def _factories(mod, data, cfg):
    """train_batches and val_batches over ``data`` with ``mod``'s
    ``iterate_batches``: shuffled with seed ``cfg.seed + epoch``, then in
    order, as the TIGER-prefix pipeline passes them."""
    return (lambda e: mod.iterate_batches(data, cfg.batch_size, shuffle=True, seed=cfg.seed + e),
            lambda e: mod.iterate_batches(data, cfg.eval_batch_size, shuffle=False))


def _streamed(cfg, w=np.zeros(D), steps=4):
    """A streaming Trainer of the linear model on the CPU."""
    return Trainer(cfg, model=Linear(w), loss_fn=loss_fn, steps_per_epoch=steps, device="cpu")


def test_streamed_fit_matches_the_jax_trainer_and_the_resident_route(tmp_path):
    import jax.numpy as jnp

    from genrec_tpu.data import datasets as jax_datasets
    from genrec_tpu.train.trainer import Trainer as JaxTrainer

    data = _linear_data()
    cfg = _cfg(tmp_path, "stream")
    want = JaxTrainer(_jax_cfg(cfg, tmp_path), init_params={"w": jnp.zeros(D)},
                      loss_fn=_jax_loss, steps_per_epoch=4).fit(
        *_factories(jax_datasets, data, cfg))
    got = _streamed(cfg).fit(*_factories(datasets, data, cfg))
    resident = Trainer(dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "resident")),
                       model=Linear(np.zeros(D)), loss_fn=loss_fn, train_data=data,
                       val_data=data, device="cpu").fit()
    assert got.epochs_run == want.epochs_run == resident.epochs_run == 10
    assert got.steps_run == resident.steps_run == 10 * 4
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=1e-5)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-5)
    np.testing.assert_allclose(got.train_losses, resident.train_losses, rtol=1e-6)
    np.testing.assert_allclose(got.val_losses, resident.val_losses, rtol=1e-6)
    assert got.train_losses[-1] < 0.05 and got.val_losses[-1] < 0.05


def test_evaluate_loss_over_batches_equals_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from genrec_tpu.data import datasets as jax_datasets
    from genrec_tpu.train.trainer import Trainer as JaxTrainer

    data = _linear_data(n=100)
    w = np.random.default_rng(3).normal(size=D).astype(np.float32)
    cfg = _cfg(tmp_path, "eval")
    want = JaxTrainer(_jax_cfg(cfg, tmp_path), init_params={"w": jnp.asarray(w)},
                      loss_fn=_jax_loss).evaluate_loss(
        jax_datasets.iterate_batches(data, 64, shuffle=False), jax.random.PRNGKey(0))
    trainer = _streamed(cfg, w)
    got = trainer.evaluate_loss(datasets.iterate_batches(data, 64, shuffle=False))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="val_data or batches"):
        trainer.evaluate_loss()


@pytest.mark.parametrize("with_valid", [True, False])
def test_an_epoch_counts_valid_rows_or_all_rows(tmp_path, monkeypatch, with_valid):
    """100 rows in batches of 64: the padded 128 rows hold 100 valid ones,
    and unpadded batches without ``valid`` hold 100 rows. A clock that
    ticks once a call makes the epoch last 1 s, so examples/s is the count."""
    data = _linear_data(n=100)

    def batches(epoch):
        if with_valid:
            yield from datasets.iterate_batches(data, 64, shuffle=True, seed=epoch)
        else:
            for s in range(0, 100, 64):
                yield {k: v[s:s + 64] for k, v in data.items()}

    clock = itertools.count()
    monkeypatch.setattr(trainer_mod, "time",
                        types.SimpleNamespace(perf_counter=lambda: float(next(clock))))
    res = _streamed(_cfg(tmp_path, "count", epochs=1), steps=2).fit(batches)
    assert res.steps_run == 2
    assert res.examples_per_sec == 100.0
    assert res.val_losses == res.train_losses  # no validation: the train mean stands in


def test_linear_warmup_follows_the_callers_steps_per_epoch(tmp_path):
    from genrec_tpu.train import optim as jax_optim

    data = _linear_data()
    cfg = _cfg(tmp_path, "sched", epochs=3, lr_scheduler="linear", warmup_epochs=1)
    trainer = _streamed(cfg)
    lrs = []
    step = trainer.opt.step

    def recording_step():
        lrs.append(trainer.opt.optimizer.param_groups[0]["lr"])
        step()

    trainer.opt.step = recording_step
    trainer.fit(*_factories(datasets, data, cfg))
    ref = jax_optim.make_schedule(_jax_cfg(cfg, tmp_path), 4)
    assert len(lrs) == 12
    for count, lr in enumerate(lrs):  # optax's schedule runs in f32: one f32 ulp of lr
        assert abs(lr - float(ref(count))) <= 2 ** -23 * cfg.lr, (count, lr, float(ref(count)))
    assert lrs[-1] > 0.0  # a count of 1 step an epoch would have decayed to 0 by step 3


def test_streamed_resume_equals_a_straight_run(tmp_path):
    data = _linear_data()
    kw = dict(warmup_epochs=1)  # the warm-up is restored with the schedule's count
    full_cfg = _cfg(tmp_path, "full", epochs=3, **kw)
    full = _streamed(full_cfg).fit(*_factories(datasets, data, full_cfg))
    cfg = _cfg(tmp_path, "part", epochs=2, **kw)
    _streamed(cfg).fit(*_factories(datasets, data, cfg))
    res = _streamed(dataclasses.replace(cfg, epochs=3, resume=True)).fit(
        *_factories(datasets, data, cfg))
    assert res.epochs_run == 3 and len(res.train_losses) == 1 and res.steps_run == 4
    assert abs(res.train_losses[0] - full.train_losses[2]) < 1e-6
    assert abs(res.val_losses[0] - full.val_losses[2]) < 1e-6
    torch.testing.assert_close(res.final_params["w"], full.final_params["w"], rtol=0, atol=1e-6)


def test_put_on_the_cpu_gives_the_resident_dtypes(tmp_path):
    rng = np.random.default_rng(0)
    data = {"ids": rng.integers(0, 9, (20, 4)).astype(np.int32),
            "mask": np.ones((20, 4), np.int32),
            "emb": rng.normal(size=(20, 2, 3)).astype(np.float32)}
    trainer = Trainer(_cfg(tmp_path, "put", batch_size=8), model=Linear(np.zeros(D)),
                      loss_fn=loss_fn, train_data=data, device="cpu")
    batches = list(datasets.iterate_batches(data, 8, shuffle=False))
    idx = torch.tensor([16, 17, 18, 19, -1, -1, -1, -1])
    want = trainer.gather(trainer.train_data, idx)
    got = trainer._put(batches[-1])  # the padded tail: rows 16-19 and row 0 four times
    assert set(got) == set(want) == {"ids", "mask", "emb", "valid"}
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].device.type == "cpu", k
        assert torch.equal(got[k], want[k]), k


def test_the_routes_refuse_what_they_cannot_run(tmp_path):
    data = _linear_data(n=20)
    kw = dict(model=Linear(np.zeros(D)), loss_fn=loss_fn, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        Trainer(_cfg(tmp_path, "a"), train_data=data, train_data_buckets=[data], **kw)
    with pytest.raises(ValueError, match="flat train_data"):
        Trainer(_cfg(tmp_path, "b"), train_data_buckets=[data], composite_widths=[4],
                row_widths=np.ones(20), **kw)
    with pytest.raises(ValueError, match="needs train_batches"):
        Trainer(_cfg(tmp_path, "c"), **kw).fit()


# --------------------------------------------------------------------------
# two gloo ranks: the streaming setup of tests/test_multihost.py:322-371
# --------------------------------------------------------------------------

def _streaming_data():
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(D,)).astype(np.float32)
    x = rng.normal(size=(64, D)).astype(np.float32)
    return x, (x @ w_true).astype(np.float32)


def _streaming_batches(lo=0, hi=16):
    """Each epoch's permuted batches of 16, rows [lo, hi) of each."""
    x, y = _streaming_data()

    def batches(epoch):
        order = np.random.default_rng(epoch).permutation(len(x))
        for s in range(0, len(x), 16):
            rows = order[s:s + 16]
            yield {"x": x[rows][lo:hi], "y": y[rows][lo:hi]}

    return batches


def _streaming_cfg(ckpt_dir):
    return TrainerConfig(epochs=3, batch_size=16, lr=0.1, shard_dataset=False,
                         ckpt_dir=str(ckpt_dir), early_stop_patience=99)


def _rank_main(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist

    from genrec_tpu_torch.parallel.auto import dp_shardings
    from genrec_tpu_torch.parallel.mesh import initialize_multihost, process_rows

    torch.set_num_threads(1)
    initialize_multihost(f"file://{rdv}", world, rank, device="cpu")
    out = pathlib.Path(out)
    try:
        mesh = dp_shardings()
        trainer = Trainer(_streaming_cfg(out / f"ckpt{rank}"), model=Linear(np.zeros(D)),
                          loss_fn=loss_fn, device="cpu", mesh=mesh)
        res = trainer.fit(_streaming_batches(*process_rows(mesh, 16)))
        torch.save({"train_losses": res.train_losses, "rows": process_rows(mesh, 16)},
                   out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


def test_two_ranks_on_their_process_rows_equal_one_rank_and_jax(tmp_path):
    import jax.numpy as jnp

    from genrec_tpu.train.trainer import Trainer as JaxTrainer

    ranks = spawn_ranks(__file__, 2, tmp_path)
    assert [r["rows"] for r in ranks] == [(0, 8), (8, 16)]
    a, b = (r["train_losses"] for r in ranks)
    assert a == b
    one = Trainer(_streaming_cfg(tmp_path / "one"), model=Linear(np.zeros(D)), loss_fn=loss_fn,
                  device="cpu").fit(_streaming_batches()).train_losses
    np.testing.assert_allclose(a, one, rtol=1e-6)
    want = JaxTrainer(_jax_cfg(_streaming_cfg(tmp_path / "j"), tmp_path),
                      init_params={"w": jnp.zeros(D)}, loss_fn=_jax_loss).fit(
        _streaming_batches()).train_losses
    np.testing.assert_allclose(one, want, rtol=1e-5)
    assert one[-1] < one[0]

"""The port's optimizers and schedules (genrec_tpu_torch/train/optim.py)
against the JAX package's optax chains (genrec_tpu/train/optim.py).

Five updates of fixed, numpy-seeded gradients on the same parameters, for
every optimizer name, both schedules with and without warmup, and the
global-norm clip on and off. Tolerance: 1e-6 max abs on the parameters (f32,
the same formulas evaluated in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TrainerConfig as JaxTrainerConfig
from genrec_tpu.train import optim as jax_optim
from genrec_tpu_torch.configs import TrainerConfig
from genrec_tpu_torch.train import optim

STEPS, STEPS_PER_EPOCH = 5, 2
SHAPES = [(4, 3), (5,)]


def _run_both(**kw):
    tcfg = dataclasses.replace(TrainerConfig(), epochs=3, lr=1e-2, **kw)
    jcfg = JaxTrainerConfig(**dataclasses.asdict(tcfg))
    r = np.random.default_rng(0)
    params = [r.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[r.normal(size=s).astype(np.float32) * 3 for s in SHAPES] for _ in range(STEPS)]
    # one step with a zero gradient entry: adagrad's "0 where the sum is 0" branch
    grads[0][1][0] = 0.0

    tx = jax_optim.make_optimizer(jcfg, STEPS_PER_EPOCH)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]

    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    opt = optim.make_optimizer(tp, tcfg, STEPS_PER_EPOCH)
    lrs = []
    for g in grads:
        opt.zero_grad()
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        lrs.append(opt.optimizer.param_groups[0]["lr"])
        opt.step()
    return [np.asarray(p) for p in jp], [p.detach().numpy() for p in tp], lrs, jcfg


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adagrad", "rmsprop"])
def test_optimizer_matches_optax(name, clip):
    want, got, _, _ = _run_both(optimizer=name, grad_clip_norm=clip, weight_decay=0.05)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("warmup", [0, 1])
@pytest.mark.parametrize("sched", ["constant", "linear"])
def test_schedule_matches_optax(sched, warmup):
    want, got, lrs, jcfg = _run_both(lr_scheduler=sched, warmup_epochs=warmup)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-6)
    ref = jax_optim.make_schedule(jcfg, STEPS_PER_EPOCH)
    for count, lr in enumerate(lrs):
        assert abs(lr - float(ref(count))) < 1e-9, (count, lr, float(ref(count)))


def test_clip_scales_by_max_over_norm_without_epsilon():
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([3.0, 4.0])
    norm = optim.clip_by_global_norm_([p], 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8]), rtol=0, atol=0)
    p.grad = torch.tensor([0.3, 0.4])
    optim.clip_by_global_norm_([p], 1.0)
    torch.testing.assert_close(p.grad, torch.tensor([0.3, 0.4]), rtol=0, atol=0)


def test_unknown_names_raise():
    p = [torch.nn.Parameter(torch.zeros(1))]
    with pytest.raises(ValueError):
        optim.make_optimizer(p, TrainerConfig(optimizer="lamb"))
    with pytest.raises(ValueError):
        optim.make_optimizer(p, TrainerConfig(lr_scheduler="cosine"))

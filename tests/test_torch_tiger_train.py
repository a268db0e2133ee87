"""The port's TIGER in training mode (genrec_tpu_torch/models/{t5,tiger}.py)
against the JAX package's Flax model.

At ``TIGERConfig()`` widths with dropout 0, the training forward's loss and
every parameter's gradient equal Flax ``value_and_grad`` with
``fused_attention`` "on" (the Pallas kernels in interpret mode) and "off"
(XLA); Flax's gradient tree goes through ``tiger_params_from_flax``.
Tolerances as the JAX package holds "on" against "off": loss within 1e-5,
gradients within 5e-4 max abs. At dropout 0.1 the two sides draw different
bits, so dropout is checked for what it must do: one generator seed gives
one loss, the drop share is the rate, ``eval()`` is untouched, and every
parameter gets a gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import TIGERConfig as JaxTIGERConfig
from genrec_tpu.models.tiger import TIGER as JaxTIGER
from genrec_tpu_torch.configs import TIGERConfig
from genrec_tpu_torch.convert import tiger_params_from_flax
from genrec_tpu_torch.models.tiger import TIGER

SEQ = TIGERConfig().max_len * TIGERConfig().code_dim
LT = 12  # teacher-forcing target tokens


def _inputs(bsz, seed=0):
    r = np.random.default_rng(seed)
    ii = r.integers(1, 33, size=(bsz, SEQ)).astype(np.int32)
    pad = r.integers(0, SEQ // 2, size=bsz)
    pad[0] = 0
    am = (np.arange(SEQ)[None, :] >= pad[:, None]).astype(np.int32)
    lab = r.integers(1, 33, size=(bsz, LT)).astype(np.int32)
    lab[-1, LT // 2:] = -100
    return ii * am, am, lab


def _cfgs(dropout, mode="off"):
    base = JaxTIGERConfig()
    jc = dataclasses.replace(base, arch=dataclasses.replace(
        base.arch, dropout_rate=dropout, fused_attention=mode))
    tc = TIGERConfig()
    tc = dataclasses.replace(tc, arch=dataclasses.replace(tc.arch, dropout_rate=dropout))
    return jc, tc


@pytest.fixture(scope="module")
def flax_params():
    ii, am, lab = _inputs(2)
    params = JaxTIGER(_cfgs(0.0)[0]).init(jax.random.PRNGKey(0), jnp.asarray(ii),
                                          jnp.asarray(am), jnp.asarray(lab))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(flax_params, dropout):
    model = TIGER(_cfgs(dropout)[1])
    model.load_state_dict(tiger_params_from_flax(flax_params), strict=True)
    return model


@pytest.mark.parametrize("mode,bsz", [("off", 3), ("on", 3), ("off", 1)])
def test_training_loss_and_grads_match_flax(flax_params, mode, bsz):
    ii, am, lab = _inputs(bsz, seed=bsz)
    jc, tc = _cfgs(0.0, mode)
    jm = JaxTIGER(jc)

    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ii), jnp.asarray(am), jnp.asarray(lab),
                           deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
        return loss

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(flax_params)
    want = tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tc)

    model = _port(flax_params, 0.0).train()
    loss_t, _ = model(torch.from_numpy(ii), torch.from_numpy(am), torch.from_numpy(lab),
                      generator=torch.Generator().manual_seed(0))
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) < 1e-5
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None, k
        err = float((g - want[k]).abs().max())
        assert err < 5e-4, (k, err)


def test_dropout_follows_the_generator_and_the_rate(flax_params):
    ii, am, lab = (torch.from_numpy(a) for a in _inputs(4))
    model = _port(flax_params, 0.1).train()

    def loss(seed):
        with torch.no_grad():
            return float(model(ii, am, lab, generator=torch.Generator().manual_seed(seed))[0])

    assert loss(5) == loss(5)
    assert loss(5) != loss(6)
    with pytest.raises(ValueError, match="Generator"):
        model(ii, am, lab)  # training-mode dropout needs a generator: no global RNG

    # every parameter gets a gradient through the dropout path
    model.zero_grad()
    model(ii, am, lab, generator=torch.Generator().manual_seed(7))[0].backward()
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, k


def test_dropout_drops_the_rate_and_scales_by_one_over_keep():
    from genrec_tpu_torch.models import t5

    x = torch.ones(256, 1024)
    y = t5._dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert abs(float((y == 0).float().mean()) - 0.1) < 0.01
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1) / np.float32(0.9))}
    assert t5._dropout(x, 0.0, None) is x


def test_eval_forward_is_unchanged_by_dropout(flax_params):
    """In eval() the forward at dropout 0.1 is the deterministic one, bit for
    bit, with or without a generator, and equals Flax's deterministic loss."""
    ii, am, lab = _inputs(3)
    t = [torch.from_numpy(a) for a in (ii, am, lab)]
    with torch.no_grad():
        base = _port(flax_params, 0.0).eval()(*t)
        drop = _port(flax_params, 0.1).eval()
        a = drop(*t)
        b = drop(*t, generator=torch.Generator().manual_seed(3))
    for x, y, z in zip(base, a, b):
        assert torch.equal(x, y) and torch.equal(x, z)
    jc, _ = _cfgs(0.1)
    loss_j, _ = JaxTIGER(jc).apply(flax_params, jnp.asarray(ii), jnp.asarray(am),
                                   jnp.asarray(lab), deterministic=True)
    assert abs(float(a[0]) - float(loss_j)) < 1e-5

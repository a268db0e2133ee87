"""The port's SASRec family (genrec_tpu_torch/models/{layers,sasrec,sasrec_large}.py,
ops/negative_sampling.py, convert.py) against the JAX package's Flax models.

Weights go from Flax to the port through the strict converters; inputs are
made with numpy from a seed; the negatives are the JAX side's own, fed to the
port. Tolerances: outputs and losses within 1e-5 (f32, other summation
orders), every gradient within 5e-4·max|JAX grad| + 1e-7 as the T5 tests hold
them, negative sampling exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from genrec_tpu import configs as jconfigs
from genrec_tpu.models import layers as jlayers
from genrec_tpu.models import sasrec as jsasrec
from genrec_tpu.models import sasrec_large as jlarge
from genrec_tpu.ops import negative_sampling as jneg
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import sasrec_large_params_from_flax, sasrec_params_from_flax
from genrec_tpu_torch.models.layers import PaddedEmbed
from genrec_tpu_torch.models.sasrec import SASRec, eval_loss, train_loss
from genrec_tpu_torch.models.sasrec_large import (SASRecLarge, make_train_step,
                                                  train_loss_sampled)
from genrec_tpu_torch.ops import attention as ta
from genrec_tpu_torch.ops import negative_sampling as neg_ops

ITEMS = 40
KEY = jax.random.PRNGKey(3)
SMALL = dict(d=16, num_blocks=2, num_heads=2, mlp_layer=32, max_len=12, dropout=0.0,
             num_neg_samples=6)
LARGE = dict(max_len=128, num_blocks=1, num_heads=2, mlp_layer=32, dropout=0.0,
             num_neg_samples=8)


def _seqs(b, n, items, seed=0):
    """Left-padded histories and their shifted targets."""
    r = np.random.default_rng(seed)
    x = r.integers(1, items + 1, size=(b, n + 1)).astype(np.int32)
    for i in range(b):
        x[i, :int(r.integers(0, n // 2))] = 0
    x[0, 0] = 0
    return x[:, :-1], np.where(x[:, :-1] == 0, 0, x[:, 1:]).astype(np.int32)


def _close(got: torch.Tensor, want, rel=0.0, atol=1e-5):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= rel * np.abs(want).max() + atol, (err, np.abs(want).max())


def _grads_close(model, jax_grads, convert):
    ref = convert(jax_grads)
    got = dict(model.named_parameters())
    assert set(ref) == set(got)
    for name, g in ref.items():
        _close(got[name].grad, g.numpy(), rel=5e-4, atol=1e-7)


@pytest.fixture(scope="module")
def sasrec():
    jcfg = jconfigs.SASRecConfig(**SMALL)
    jm = jsasrec.SASRec(item_num=ITEMS, cfg=jcfg)
    x, t = _seqs(3, SMALL["max_len"], ITEMS)
    params = jm.init(KEY, jnp.asarray(x))
    cfg = configs.SASRecConfig(**SMALL)
    port = SASRec(ITEMS, cfg)
    port.load_state_dict(sasrec_params_from_flax(params, ITEMS, cfg), strict=True)
    return jm, jcfg, params, port, cfg, x, t


def test_padded_embed_matches_flax_and_row_0_gets_no_gradient():
    ids = np.array([[0, 3, 1], [2, 0, 3]], np.int32)
    flax_embed = jlayers.PaddedEmbed(5, 4)
    params = flax_embed.init(KEY, jnp.asarray(ids))
    port = PaddedEmbed(5, 4)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(np.asarray(params["params"]["embedding"])))
    out = port(torch.tensor(ids))
    _close(out, flax_embed.apply(params, jnp.asarray(ids)), atol=0.0)
    assert torch.equal(out[0, 0], torch.zeros(4))
    out.sum().backward()
    assert torch.equal(port.weight.grad[0], torch.zeros(4))
    assert torch.equal(port.weight.grad[3], torch.full((4,), 2.0))


@pytest.mark.parametrize("unique", [True, False])
def test_negative_sampling_equals_jax_on_its_draws(unique):
    """Few items and long histories, so that collisions and redraws happen."""
    items, rounds, num_neg = 12, 4, 5
    seq = np.random.default_rng(1).integers(0, items + 1, size=(64, 6)).astype(np.int32)
    key = jax.random.PRNGKey(9)
    want = jneg.sample_negatives(key, jnp.asarray(seq), items, num_neg, rounds=rounds,
                                 unique=unique)
    keys = jax.random.split(key, rounds)
    draws = np.stack([np.asarray(jax.random.randint(keys[r], (64, num_neg), 1, items + 1))
                      for r in range(rounds)])
    got = neg_ops.reject_collisions(torch.tensor(draws, dtype=torch.int64),
                                    torch.tensor(seq), unique=unique)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(draws[0], np.asarray(want))  # some candidates were redrawn
    drawn = neg_ops.sample_negatives(torch.Generator().manual_seed(0), torch.tensor(seq),
                                     items, num_neg)
    assert drawn.shape == (64, num_neg) and int(drawn.min()) >= 1 and int(drawn.max()) <= items


def test_sasrec_forward_predict_and_score_all_match_flax(sasrec):
    jm, _, params, port, _, x, _ = sasrec
    port.eval()
    xt, xj = torch.tensor(x), jnp.asarray(x)
    with torch.no_grad():
        _close(port(xt), jm.apply(params, xj))
        _close(port.predict(xt), jm.apply(params, xj, method=jsasrec.SASRec.predict))
        _close(port.score_all(xt), jm.apply(params, xj, method=jsasrec.SASRec.score_all))


def test_sasrec_losses_and_every_gradient_match_flax(sasrec):
    """At dropout 0, with the JAX side's negatives fed to the port."""
    jm, jcfg, params, port, cfg, x, t = sasrec
    valid = np.array([True, True, False])
    xj, tj, vj = jnp.asarray(x), jnp.asarray(t), jnp.asarray(valid)
    xt, tt, vt = torch.tensor(x), torch.tensor(t), torch.tensor(valid)
    neg = jneg.sample_negatives(jax.random.split(KEY)[1], xj, ITEMS, cfg.num_neg_samples)

    def jloss(p):
        return jsasrec.train_loss(jm, p, xj, tj, KEY, jcfg, ITEMS, batch_valid=vj)[0]

    want, jgrads = jax.value_and_grad(jloss)(params)
    port.train()
    port.zero_grad()
    loss, valid_n = train_loss(port, xt, tt, None, cfg, ITEMS, batch_valid=vt,
                               neg=torch.tensor(np.asarray(neg)))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5
    assert float(valid_n) == float((t[:2] != 0).sum())
    _grads_close(port, jgrads, lambda g: sasrec_params_from_flax(g, ITEMS, cfg))

    port.eval()
    with torch.no_grad():
        s, v = eval_loss(port, xt, tt[:, -1], None, cfg, ITEMS, batch_valid=vt,
                         neg=torch.tensor(np.asarray(
                             jneg.sample_negatives(KEY, xj, ITEMS, 1)[:, 0])))
    js, jv = jsasrec.eval_loss(jm, params, xj, tj[:, -1], KEY, jcfg, ITEMS, batch_valid=vj)
    assert abs(float(s) - float(js)) <= 1e-5 and float(v) == float(jv)


def test_sasrec_dropout_draws_from_the_generator(sasrec):
    _, _, _, port, cfg, x, t = sasrec
    drop = SASRec(ITEMS, dataclasses.replace(cfg, dropout=0.3))
    drop.load_state_dict(port.state_dict())
    xt, tt = torch.tensor(x), torch.tensor(t)
    drop.train()
    with pytest.raises(ValueError, match="Generator"):
        drop(xt)
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = train_loss(drop, xt, tt, g(0), cfg, ITEMS)[0].item()
    assert a == train_loss(drop, xt, tt, g(0), cfg, ITEMS)[0].item()
    assert a != train_loss(drop, xt, tt, g(1), cfg, ITEMS)[0].item()
    drop.eval()
    port.eval()
    with torch.no_grad():
        torch.testing.assert_close(drop(xt), port(xt), rtol=0, atol=0)


@pytest.fixture(scope="module")
def large():
    jcfg = dataclasses.replace(jconfigs.long_context_sasrec_config(max_len=128, dim=16),
                               embedding=jconfigs.ShardedEmbeddingConfig(vocab_size=64, dim=16),
                               **LARGE)
    cfg = dataclasses.replace(configs.long_context_sasrec_config(max_len=128, dim=16),
                              embedding=configs.ShardedEmbeddingConfig(vocab_size=64, dim=16),
                              **LARGE)
    item_num = cfg.embedding.vocab_size - 1
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jm = jlarge.SASRecLarge(item_num=item_num, cfg=jcfg, mesh=mesh, use_sharded=False)
    x, t = _seqs(2, cfg.max_len, item_num, seed=4)
    params = jm.init(KEY, jnp.asarray(x))
    return jm, jcfg, params, cfg, item_num, x, t


def _port_large(large, force_kernel=None):
    _, _, params, cfg, item_num, _, _ = large
    model = SASRecLarge(item_num, cfg, use_sharded=False)
    model.load_state_dict(sasrec_large_params_from_flax(params, item_num, cfg), strict=True)
    if force_kernel:
        for blk in model.blocks:
            blk.attn_fn = functools.partial(ta.multi_head_attention, force_kernel=True)
    return model


def test_sasrec_large_scores_and_topk_match_flax(large):
    jm, _, params, cfg, item_num, x, t = large
    model = _port_large(large).eval()
    neg = np.random.default_rng(2).integers(1, item_num + 1, size=(2, 8)).astype(np.int32)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(neg),
                    method=jlarge.SASRecLarge.sampled_scores)
    with torch.no_grad():
        got = model.sampled_scores(torch.tensor(x), torch.tensor(t), torch.tensor(neg))
        vals, ids = model.predict_topk(torch.tensor(x), 5)
    for g, w in zip(got, want):
        _close(g, w)
    jv, ji = jm.apply(params, jnp.asarray(x), 5, method=jlarge.SASRecLarge.predict_topk)
    _close(vals, jv)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    # the default build is the row-sharded table (use_sharded=True), here on
    # the 1 x 1 mesh: the same top-k as JAX's sharded model on a 1 x 1 mesh
    sharded = SASRecLarge(item_num, cfg).eval()
    sharded.load_state_dict(model.state_dict(), strict=True)
    js = jlarge.SASRecLarge(item_num=item_num, cfg=jm.cfg, mesh=jm.mesh)
    sv, si = js.apply(params, jnp.asarray(x), 5, method=jlarge.SASRecLarge.predict_topk)
    vals, ids = sharded.predict_topk(torch.tensor(x), 5)
    _close(vals, sv)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(si))


@pytest.mark.parametrize("force_kernel", [False, True])
def test_sasrec_large_loss_and_grads_match_flax(large, force_kernel):
    """The sampled loss and every gradient at dropout 0, on the plain path
    and routed through the flash Function (its plain versions on the CPU)."""
    jm, jcfg, params, cfg, item_num, x, t = large
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    rated = jnp.concatenate([xj, tj], axis=1)
    neg = jneg.sample_negatives(jax.random.split(KEY)[1], rated, item_num, cfg.num_neg_samples)
    want, jgrads = jax.value_and_grad(
        lambda p: jlarge.train_loss_sampled(jm, p, xj, tj, KEY, jcfg, item_num)[0])(params)
    model = _port_large(large, force_kernel).train()
    loss, _ = train_loss_sampled(model, torch.tensor(x), torch.tensor(t), None, cfg, item_num,
                                 neg=torch.tensor(np.asarray(neg)))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5
    _grads_close(model, jgrads, lambda g: sasrec_large_params_from_flax(g, item_num, cfg))
    assert ta.fwd_launches == ta.bwd_dq_launches == ta.bwd_dkv_launches == 0


def test_sasrec_large_train_step_matches_optax_adam(large):
    """One step: the loss, Adam's first moment (the gradient, 5e-4·max) and
    the new parameters within 2e-6 wherever |grad| > 1e-6. Adam's first step
    moves each parameter by lr·g/(|g| + eps), so where the gradient is zero
    in exact arithmetic (the key bias: softmax ignores a per-query shift) it
    turns f32 rounding noise into a move of up to lr; those entries are
    held to lr."""
    jm, jcfg, params, cfg, item_num, x, t = large
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    rated = jnp.concatenate([xj, tj], axis=1)
    neg = jneg.sample_negatives(jax.random.split(KEY)[1], rated, item_num, cfg.num_neg_samples)
    tx = optax.adam(1e-3)
    step = jlarge.make_train_step(jm, tx, jcfg, item_num)
    new_params, opt_state, jloss = step(params, tx.init(params), xj, tj, KEY)
    model = _port_large(large)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    loss = make_train_step(model, opt, cfg, item_num)(torch.tensor(x), torch.tensor(t), None,
                                                     neg=torch.tensor(np.asarray(neg)))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    convert = lambda tree: sasrec_large_params_from_flax(tree, item_num, cfg)  # noqa: E731
    want, mu = convert(new_params), convert(opt_state[0].mu)
    for name, p in model.named_parameters():
        _close(opt.state[p]["exp_avg"], mu[name].numpy(), rel=5e-4, atol=1e-8)
        live = (mu[name].abs() > 1e-7).numpy()  # |grad| > 1e-6
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert err[live].max(initial=0.0) <= 2e-6 and err.max() <= 2e-3, name


def test_converters_are_strict(sasrec, large):
    _, _, params, _, cfg, _, _ = sasrec
    tree = jax.tree_util.tree_map(np.asarray, params)
    extra = {"params": dict(tree["params"], stray={"kernel": np.zeros((2, 2))})}
    with pytest.raises(KeyError, match="no counterpart"):
        sasrec_params_from_flax(extra, ITEMS, cfg)
    missing = {"params": {k: v for k, v in tree["params"].items() if k != "last_norm"}}
    with pytest.raises(KeyError, match="unfilled"):
        sasrec_params_from_flax(missing, ITEMS, cfg)
    with pytest.raises(ValueError, match="does not fit"):
        sasrec_params_from_flax(tree, ITEMS + 1, cfg)
    _, _, lparams, lcfg, item_num, _, _ = large
    ltree = jax.tree_util.tree_map(np.asarray, lparams)
    bad = {"params": dict(ltree["params"], item_table=np.zeros((item_num, 16)))}
    with pytest.raises(ValueError, match="item_table"):
        sasrec_large_params_from_flax(bad, item_num, lcfg)
    sd = sasrec_params_from_flax(tree, ITEMS, cfg)
    np.testing.assert_array_equal(sd["blocks.1.attn_norm.weight"].numpy(),
                                  tree["params"]["blocks_1"]["LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["blocks.0.ff_out.weight"].numpy(),
                                  tree["params"]["blocks_0"]["Dense_5"]["kernel"].T)

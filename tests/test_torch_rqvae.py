"""The port's RQ-VAE model and its Sinkhorn and k-means
(genrec_tpu_torch/{models/rqvae,ops/sinkhorn,models/layers}.py) against the
JAX package's Flax model and ops.

Inputs are made with numpy from a seed; Flax weights pass through
``convert.rqvae_params_from_flax``. Tolerances: Sinkhorn and k-means within
1e-5 (f32, log domain, other summation orders); code indices exactly
equal; forward outputs and losses within 1e-5; gradients within 5e-4·max,
as the TIGER parity tests hold them.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.configs import RQVAEConfig as JaxRQVAEConfig
from genrec_tpu.models import layers as jax_layers
from genrec_tpu.models import rqvae as jax_rqvae
from genrec_tpu_torch.configs import RQVAEConfig
from genrec_tpu_torch.convert import _state_from_flax, rqvae_params_from_flax
from genrec_tpu_torch.models import layers
from genrec_tpu_torch.models.rqvae import (RQVAE, _masked_mean, collision_rate,
                                           kmeans_init_codebooks)
from genrec_tpu_torch.ops import sinkhorn

jax_sk = importlib.import_module("genrec_tpu.ops.sinkhorn")  # the package exports a function
KEY = jax.random.PRNGKey(0)
CFG = dict(in_dim=24, layers=(32, 16), e_dim=8, num_emb_list=(8, 8, 8), dropout=0.0,
           sk_epsilons=(0.01, 0.01, 0.01), sk_iters=30, kmeans_iters=10)


def _np(x):
    return np.asarray(x)


def _distances(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) ** 2 * 3.0


def test_sinkhorn_matches_jax_where_a_direct_f32_exp_overflows():
    d = _distances((16, 8), 0)
    centered = _np(jax_sk.center_distance(jnp.asarray(d)))
    assert np.abs(centered).max() > 0.99  # -d/eps spans about ±100 at eps = 0.01
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(-centered.astype(np.float32) / np.float32(0.01))).all()
    got = sinkhorn.sinkhorn(sinkhorn.center_distance(torch.from_numpy(d)), 0.01, 50).numpy()
    want = _np(jax_sk.sinkhorn(jnp.asarray(centered), 0.01, 50))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # balanced: the last step leaves every code's column holding B/K of the mass
    np.testing.assert_allclose(got.sum(0), np.full(8, 16 / 8), atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_grouped_sinkhorn_normalizes_each_group_like_jax_vmap():
    """A (G, s, K) stack: center_distance's max and min and Sinkhorn's row and
    column sums are each group's own, as ``jax.vmap`` over groups gives."""
    d = _distances((3, 5, 8), 1)
    d[1] *= 20.0  # groups on different scales: a stack-wide max would differ
    fn = jax.vmap(lambda x: jax_sk.sinkhorn(jax_sk.center_distance(x), 0.01, 50))
    want = _np(fn(jnp.asarray(d)))
    got = sinkhorn.sinkhorn(sinkhorn.center_distance(torch.from_numpy(d)), 0.01, 50)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    for g in range(3):
        one = sinkhorn.sinkhorn(sinkhorn.center_distance(torch.from_numpy(d[g])), 0.01, 50)
        torch.testing.assert_close(got[g], one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,k,iters", [(64, 8, 10), (40, 8, 0), (30, 5, 20)])
def test_kmeans_given_jaxs_first_index_matches(n, k, iters):
    x = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    want = _np(jax_sk.kmeans(key, jnp.asarray(x), k, iters))
    first = int(jax.random.randint(key, (), 0, n))
    got = sinkhorn.kmeans(torch.from_numpy(x), k, iters, first=first).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_kmeans_draws_its_first_center_from_the_generator():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(50, 4)).astype(np.float32))
    a = sinkhorn.kmeans(x, 6, 5, generator=torch.Generator().manual_seed(3))
    b = sinkhorn.kmeans(x, 6, 5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    first = int(torch.randint(0, 50, (), generator=torch.Generator().manual_seed(3)))
    assert torch.equal(a, sinkhorn.kmeans(x, 6, 5, first=first))


def test_argmin_and_argmax_take_the_first_index_on_ties():
    """JAX's rule, on which farthest-point init and assignment depend."""
    t = torch.tensor([[3.0, 1.0, 1.0, 5.0, 5.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    assert torch.argmin(t, dim=1).tolist() == [1, 0]
    assert torch.argmax(t, dim=1).tolist() == [3, 0]
    assert int(torch.argmax(torch.tensor([0.0, 7.0, 7.0]))) == 1


@pytest.fixture(scope="module")
def model_pair():
    """Flax params with k-means-initialised codebooks (so that every level's
    codes are in use) and the port's RQ-VAE loaded from them."""
    jcfg, tcfg = JaxRQVAEConfig(**CFG), RQVAEConfig(**CFG)
    jm = jax_rqvae.RQVAE(jcfg)
    x = np.random.default_rng(5).normal(size=(48, 24)).astype(np.float32)
    params = jm.init(KEY, jnp.asarray(x[:1]))
    params = jax_rqvae.kmeans_init_codebooks(params, jm, jnp.asarray(x), KEY)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = RQVAE(tcfg)
    tm.load_state_dict(rqvae_params_from_flax(params, tcfg), strict=True)
    return jm, params, tm, x


def test_converter_keeps_the_codebook_storage_shift(model_pair):
    jm, params, tm, _ = model_pair
    p = params["params"]
    assert set(p) == {"encoder", "decoder", "codebook_0", "codebook_1", "codebook_2"}
    sd = tm.state_dict()
    assert len(sd) == 2 * 3 + 2 * 3 + 3
    np.testing.assert_array_equal(sd["codebooks.1"].numpy(), p["codebook_1"])
    np.testing.assert_array_equal(sd["encoder.layers.2.weight"].numpy(),
                                  p["encoder"]["Dense_2"]["kernel"].T)
    want = _np(jm.apply(params, 1, method=lambda m, i: m._codebook(i)))
    np.testing.assert_array_equal(tm.codebook(1).detach().numpy(), want)


@pytest.mark.parametrize("use_sk", [False, True])
def test_forward_and_indices_match_flax(model_pair, use_sk):
    jm, params, tm, x = model_pair
    out_j, rq_j, idx_j = jm.apply(params, jnp.asarray(x), use_sk=use_sk)
    with torch.no_grad():
        out_t, rq_t, idx_t = tm.eval()(torch.from_numpy(x), use_sk=use_sk)
    np.testing.assert_array_equal(idx_t.numpy(), _np(idx_j))
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=1e-5)
    assert abs(float(rq_t) - float(rq_j)) < 1e-5
    got = tm.get_indices(torch.from_numpy(x), use_sk=use_sk).numpy()
    want = _np(jm.apply(params, jnp.asarray(x), use_sk=use_sk, method=jax_rqvae.RQVAE.get_indices))
    np.testing.assert_array_equal(got, want)
    if use_sk:  # Sinkhorn balances: it moves some codes away from the nearest
        greedy = tm.get_indices(torch.from_numpy(x), use_sk=False).numpy()
        assert (greedy != got).any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_sk", [False, True])
def test_losses_and_gradients_match_flax(model_pair, masked, use_sk):
    jm, params, tm, x = model_pair
    mask = np.ones(len(x), bool)
    if masked:
        mask[-7:] = False  # pad rows, as the trainer's last batch has them
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None

    def loss_j(p):
        out, rq, _ = jm.apply(p, jnp.asarray(x), use_sk=use_sk, deterministic=False,
                              row_mask=jmask)
        total, recon = jm.apply(p, out, rq, jnp.asarray(x), jmask,
                                method=jax_rqvae.RQVAE.compute_loss)
        return total, recon

    (total_j, recon_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    want = rqvae_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tm.cfg)
    tm.train().zero_grad()
    out, rq, _ = tm(torch.from_numpy(x), use_sk=use_sk, row_mask=tmask)
    total, recon = tm.compute_loss(out, rq, torch.from_numpy(x), tmask)
    total.backward()
    assert abs(total.item() - float(total_j)) < 1e-5
    assert abs(recon.item() - float(recon_j)) < 1e-5
    for k, p in tm.named_parameters():
        w = want[k].numpy()
        assert p.grad is not None, k
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 5e-4 * np.abs(w).max() + 1e-9, (k, err)
    tm.eval()


def test_row_mask_keeps_pad_rows_out_of_every_loss_term(model_pair):
    """A masked batch gives the loss of its valid rows alone."""
    _, _, tm, x = model_pair
    mask = torch.ones(len(x), dtype=torch.bool)
    mask[40:] = False
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, rq, _ = tm.eval()(xt, row_mask=mask, use_sk=False)
        total, _ = tm.compute_loss(out, rq, xt, mask)
        out2, rq2, _ = tm(xt[:40], use_sk=False)
        total2, _ = tm.compute_loss(out2, rq2, xt[:40])
    assert abs(float(total) - float(total2)) < 1e-6
    assert float(_masked_mean(torch.ones(3), torch.zeros(3, dtype=torch.bool))) == 0.0


def test_kmeans_init_codebooks_matches_jax_on_jaxs_draws():
    jcfg, tcfg = JaxRQVAEConfig(**CFG), RQVAEConfig(**CFG)
    jm = jax_rqvae.RQVAE(jcfg)
    x = np.random.default_rng(9).normal(size=(64, 24)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    params = jm.init(KEY, jnp.asarray(x[:1]))
    want = jax_rqvae.kmeans_init_codebooks(params, jm, jnp.asarray(x), key)["params"]
    firsts, k = [], key
    for _ in tcfg.num_emb_list:  # the reference's draws: one split and one randint a level
        k, sub = jax.random.split(k)
        firsts.append(int(jax.random.randint(sub, (), 0, len(x))))
    tm = RQVAE(tcfg)
    tm.load_state_dict(rqvae_params_from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    kmeans_init_codebooks(tm, torch.from_numpy(x), firsts=firsts)
    for i in range(3):
        np.testing.assert_allclose(tm.codebooks[i].detach().numpy(), _np(want[f"codebook_{i}"]),
                                   atol=1e-5)


def test_mlp_stack_matches_flax_and_drops_before_every_linear(monkeypatch):
    x = np.random.default_rng(2).normal(size=(5, 12)).astype(np.float32)
    jm = jax_layers.MLPStack((20, 7, 3), dropout=0.5)
    params = jax.tree_util.tree_map(np.asarray, jm.init(KEY, jnp.asarray(x)))
    tm = layers.MLPStack(12, (20, 7, 3), dropout=0.5)
    rename = {f"Dense_{i}": f"layers.{i}" for i in range(3)}
    tm.load_state_dict(_state_from_flax(params, tm, rename), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jm.apply(params, jnp.asarray(x))), atol=1e-5)

    calls = []
    real = layers.dropout
    monkeypatch.setattr(layers, "dropout", lambda t, rate, g: calls.append((t, rate)) or
                        real(t, rate, g))
    xt = torch.from_numpy(x)
    tm.train()(xt, torch.Generator().manual_seed(0))
    assert [r for _, r in calls] == [0.5, 0.5, 0.5] and calls[0][0] is xt
    calls.clear()
    tm(xt, deterministic=True)
    assert [r for _, r in calls] == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="Generator"):
        tm(xt)


def test_mlp_stack_init_is_xavier_normal_with_zero_bias():
    tm = layers.MLPStack(300, (500, 4), generator=torch.Generator().manual_seed(0))
    w = tm.layers[0].weight.detach()
    std = np.sqrt(2.0 / 800)
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6  # truncated at 2σ
    assert all(float(layer.bias.detach().abs().max()) == 0.0 for layer in tm.layers)


def test_collision_rate():
    idx = np.array([[1, 2], [1, 2], [3, 4]])
    assert collision_rate(idx) == pytest.approx(1 / 3)
    assert collision_rate(torch.from_numpy(idx)) == jax_rqvae.collision_rate(idx)

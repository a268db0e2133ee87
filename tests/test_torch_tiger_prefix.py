"""The port's TIGER-prefix (genrec_tpu_torch/models/tiger_prefix.py) against
the JAX package's Flax model, and kernels #1 and #2's plain versions at
the prefixed encoder's shapes against the Pallas kernels in interpret mode.

Weights come from the Flax init through ``tiger_prefix_params_from_flax``;
inputs are made with numpy from a seed. Tolerances as for TIGER: the
adapter's output, the loss and generate's scores within 1e-5, gradients
within 5e-4·max, generated tokens exactly equal; the attention forward
within 1e-5 and its gradients within 1e-4·max + 1e-6, as the T5 attention
tests hold them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.models import tiger_prefix as jax_tp
from genrec_tpu.ops.t5_attention import fused_t5_attention as jax_fused
from genrec_tpu.pipelines import tiger_prefix_pipeline as jax_tpp
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import _state_from_flax, tiger_prefix_params_from_flax
from genrec_tpu_torch.models import tiger_prefix as tp
from genrec_tpu_torch.ops import t5_attention as ta
from genrec_tpu_torch.pipelines import tiger_prefix_pipeline

BERT, NVEC, LT = 16, 5, 8
# 2 heads of 16, and the full config's 8 heads (of 4 here) over 20 items: 83 encoder tokens
SHAPES = {"h2": (dict(num_heads=2, d_kv=16), 8), "h8_83": (dict(num_heads=8, d_kv=4), 20)}


def _arch(mod, heads, dropout=0.0, mode=None):
    kw = dict(vocab_size=64, num_layers=1, num_decoder_layers=2, d_model=32, d_ff=64,
              dropout_rate=dropout, **heads)
    if mode is not None:
        kw["fused_attention"] = mode
    return mod.T5ArchConfig(**kw)


def _cfgs(shape, dropout=0.0, mode="off"):
    heads, max_len = SHAPES[shape]
    kw = dict(bert_dim=BERT, max_len=max_len, beam_size=5, topk_list=(2, 5))
    return (jconfigs.TIGERPrefixConfig(arch=_arch(jconfigs, heads, dropout, mode), **kw),
            configs.TIGERPrefixConfig(arch=_arch(configs, heads, dropout), **kw))


def _inputs(cfg, bsz, seed=0):
    r = np.random.default_rng(seed)
    seq = cfg.max_len * cfg.code_dim
    ii = r.integers(1, 33, size=(bsz, seq)).astype(np.int32)
    pad = r.integers(0, seq // 2, size=bsz)
    pad[0] = 0
    am = (np.arange(seq)[None, :] >= pad[:, None]).astype(np.int32)
    lab = r.integers(1, 33, size=(bsz, LT)).astype(np.int32)
    lab[-1, LT // 2:] = -100
    prof = [r.normal(0, 0.5, size=(bsz, NVEC, BERT)).astype(np.float32) for _ in range(3)]
    return ii * am, am, lab, prof


@functools.lru_cache(maxsize=None)
def _flax_params(shape):
    jc, _ = _cfgs(shape)
    ii, am, lab, prof = _inputs(jc, 1)
    params = jax_tp.TIGERPrefix(jc).init(jax.random.PRNGKey(0), jnp.asarray(ii),
                                         jnp.asarray(am), jnp.asarray(lab),
                                         *map(jnp.asarray, prof))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(shape, dropout=0.0):
    _, tc = _cfgs(shape, dropout)
    model = tp.TIGERPrefix(tc)
    model.load_state_dict(tiger_prefix_params_from_flax(_flax_params(shape), tc), strict=True)
    return model


def test_converter_fills_every_parameter():
    params = _flax_params("h2")["params"]
    assert set(params) == {"model", "adapter_lvl1", "adapter_lvl2", "adapter_lvl3"}
    sd = _port("h2").state_dict()
    ad = params["adapter_lvl2"]
    assert set(ad) == {"bert_proj", "q_proj", "k_proj", "v_proj", "out_proj", "ffn_in",
                       "ffn_out", "norm1", "norm2"}
    np.testing.assert_array_equal(sd["adapter_lvl2.bert_proj.weight"].numpy(),
                                  ad["bert_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["adapter_lvl2.norm2.weight"].numpy(), ad["norm2"]["scale"])
    np.testing.assert_array_equal(sd["model.shared.weight"].numpy(),
                                  params["model"]["shared"]["embedding"])


def test_adapter_matches_flax():
    """LayerNorm ε = 1e-6, tanh GELU, transposed Dense kernels, 5 BERT keys."""
    r = np.random.default_rng(3)
    hidden = r.normal(size=(3, 80, 32)).astype(np.float32)
    bert = r.normal(0, 0.5, size=(3, NVEC, BERT)).astype(np.float32)
    jm = jax_tp.ProfessionalAdapter(32, 8, 0.1)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                                        jnp.asarray(hidden), jnp.asarray(bert)))
    want = np.asarray(jm.apply(params, jnp.asarray(hidden), jnp.asarray(bert)))
    tm = tp.ProfessionalAdapter(BERT, 32, 8, 0.1)
    tm.load_state_dict(_state_from_flax(params, tm), strict=True)
    assert tm.norm1.eps == 1e-6
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(hidden), torch.from_numpy(bert))
    assert got.shape == (3, 1, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # attention-weight dropout in training mode, from the generator
    tm.train()
    a = tm(torch.from_numpy(hidden), torch.from_numpy(bert), torch.Generator().manual_seed(0))
    b = tm(torch.from_numpy(hidden), torch.from_numpy(bert), torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.allclose(a, got, atol=1e-4)
    with pytest.raises(ValueError, match="Generator"):
        tm(torch.from_numpy(hidden), torch.from_numpy(bert))


def test_prefix_inputs_prepend_three_tokens_and_three_ones():
    jc, tc = _cfgs("h8_83")
    ii, am, _, prof = _inputs(tc, 2)
    model = _port("h8_83").eval()
    with torch.no_grad():
        emb, mask = model.build_prefix_inputs(torch.from_numpy(ii), torch.from_numpy(am),
                                              *map(torch.from_numpy, prof))
    assert emb.shape == (2, 83, 32) and mask.shape == (2, 83) and mask.dtype == torch.int32
    assert mask[:, :3].eq(1).all() and torch.equal(mask[:, 3:], torch.from_numpy(am))
    jemb, jmask = jax_tp.TIGERPrefix(jc).apply(
        _flax_params("h8_83"), jnp.asarray(ii), jnp.asarray(am), *map(jnp.asarray, prof),
        method=jax_tp.TIGERPrefix.build_prefix_inputs)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("shape,mode", [("h2", "off"), ("h8_83", "off"), ("h8_83", "on")])
def test_training_loss_and_grads_match_flax(shape, mode):
    jc, tc = _cfgs(shape, mode=mode)
    ii, am, lab, prof = _inputs(tc, 3, seed=1)
    jm = jax_tp.TIGERPrefix(jc)

    def loss_fn(p):
        loss, _ = jm.apply(p, jnp.asarray(ii), jnp.asarray(am), jnp.asarray(lab),
                           *map(jnp.asarray, prof), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return loss

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(_flax_params(shape))
    want = tiger_prefix_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tc)
    model = _port(shape).train()
    loss_t, logits = model(torch.from_numpy(ii), torch.from_numpy(am), torch.from_numpy(lab),
                           *map(torch.from_numpy, prof))
    loss_t.backward()
    assert logits.shape == (3, LT, 64)
    assert abs(loss_t.item() - float(loss_j)) < 1e-5
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None, k
        w = want[k]
        err = float((g - w).abs().max())
        assert err <= 5e-4 * float(w.abs().max()) + 1e-9, (k, err)


def test_dropout_follows_the_generator_and_eval_is_deterministic():
    _, tc = _cfgs("h2", dropout=0.1)
    ii, am, lab, prof = _inputs(tc, 4)
    t = [torch.from_numpy(a) for a in (ii, am, lab, *prof)]
    model = _port("h2", dropout=0.1).train()

    def loss(seed):
        with torch.no_grad():
            return model(*t, generator=torch.Generator().manual_seed(seed))[0].item()

    assert loss(5) == loss(5) and loss(5) != loss(6)
    with pytest.raises(ValueError, match="Generator"):
        model(*t)
    model.zero_grad()
    model(*t, generator=torch.Generator().manual_seed(7))[0].backward()
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
    with torch.no_grad():
        a = model.eval()(*t)[0]
        b = _port("h2", dropout=0.0).eval()(*t)[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", ["h2", "h8_83"])
def test_generate_matches_jax(shape):
    jc, tc = _cfgs(shape)
    ii, am, _, prof = _inputs(tc, 3, seed=2)
    beams = 10
    jm = jax_tp.TIGERPrefix(jc)
    gen = jax.jit(functools.partial(jax_tp.generate, jm, num_beams=beams,
                                    constraint=jax_tpp.make_constraint(jc)))
    toks_j, scores_j = gen(_flax_params(shape), jnp.asarray(ii), jnp.asarray(am),
                           *map(jnp.asarray, prof))
    model = _port(shape).eval()
    toks, scores = tp.generate(model, ii, am, *prof, num_beams=beams,
                               constraint=tiger_prefix_pipeline.make_constraint(tc))
    assert toks.shape == (3, beams, tc.max_gen_len)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(toks_j))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j), atol=1e-5)


# --- kernels #1 and #2 at the prefixed encoder's shapes: Lq = Lk = 83, H = 8 ---

H, LE, LD, D = 8, 83, 12, 16


def _attention_inputs(b, lq, lk, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(b, H, n, D)).astype(np.float32) for n in (lq, lk, lk))
    bias = r.normal(size=(H, lq, lk)).astype(np.float32)
    mask = np.ones((b, lk), np.int32)
    mask[:, 3:3 + int(r.integers(1, lk - 3))] = 0  # left padding after 3 prefix ones
    return q, k, v, bias, mask


@pytest.mark.parametrize("name,lq,with_bias", [("enc_self", LE, True), ("cross", LD, False)])
def test_attention_plain_versions_match_pallas_at_the_prefix_shapes(name, lq, with_bias):
    q, k, v, bias, mask = _attention_inputs(2, lq, LE, seed=lq)
    bias = bias if with_bias else None
    j = [jnp.asarray(a) for a in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    want = jax_fused(*j, jb, jnp.asarray(mask), batch_block=2, interpret=True)
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    got = ta.fused_t5_attention(*t, tb, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)

    def loss_j(q, k, v, b):
        return jnp.sum(jnp.sin(jax_fused(q, k, v, b, jnp.asarray(mask), batch_block=2,
                                         interpret=True)))

    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    want_g = jax.grad(loss_j, argnums)(*j, jb)
    torch.sin(got).sum().backward()
    got_g = [x.grad for x in t] + ([tb.grad] if tb is not None else [])
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max() + 1e-6

"""The port's DenseT5 (genrec_tpu_torch/models/dense_t5.py) and its
``T5Encoder`` against the JAX package's Flax models, and kernels #1 and #2's
plain versions at DenseT5's attention shape against the Pallas kernels in
interpret mode.

Weights come from the Flax init through the strict converters; inputs are
made with numpy from a seed, at a small size (d_model 32, 2 heads of 16,
L + 1 = 9 positions, 32-dimensional embeddings). The reference is run with
``fused_attention="off"`` (XLA attention) and ``"on"`` (Pallas in interpret
mode). Tolerances: the encoder output, the prediction and the loss within
1e-5 (f32, another summation order); parameter gradients at dropout 0
within 1e-4 of the largest; the attention forward within 1e-5 and its
gradients within 1e-4·max + 1e-6, as the T5 attention tests hold them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.models import dense_t5 as jax_dt5
from genrec_tpu.models.t5 import T5Encoder as JaxT5Encoder
from genrec_tpu.ops.t5_attention import fused_t5_attention as jax_fused
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import _state_from_flax, dense_t5_params_from_flax
from genrec_tpu_torch.models import dense_t5
from genrec_tpu_torch.models.t5 import T5Encoder
from genrec_tpu_torch.ops import t5_attention as ta

EMB, L = 32, 8


def _arch(mod, layers, dropout=0.0, mode=None):
    kw = dict(d_model=32, num_layers=layers, num_heads=2, d_kv=16, d_ff=64,
              dropout_rate=dropout)
    if mode is not None:
        kw["fused_attention"] = mode
    return mod.T5ArchConfig(**kw)


def _cfgs(layers=2, dropout=0.0, mode="off"):
    kw = dict(input_emb_dim=EMB, target_emb_dim=EMB, max_seq_len=L)
    return (jconfigs.DenseT5Config(arch=_arch(jconfigs, layers, dropout, mode), **kw),
            configs.DenseT5Config(arch=_arch(configs, layers, dropout), **kw))


def _inputs(bsz, seed=0):
    """Sequences (B, L + 1, EMB), the right-padded mask (user vector + 0..L
    items; row 0 full, row 1 the user vector alone) and targets (B, EMB)."""
    r = np.random.default_rng(seed)
    seq = r.normal(size=(bsz, L + 1, EMB)).astype(np.float32)
    lens = r.integers(0, L + 1, size=bsz)
    lens[:2] = (L, 0)[:bsz]
    mask = (np.arange(L + 1)[None, :] <= lens[:, None]).astype(np.int32)
    tgt = r.normal(size=(bsz, EMB)).astype(np.float32)
    return seq, mask, tgt


@functools.lru_cache(maxsize=None)
def _flax_params(layers):
    jc, _ = _cfgs(layers)
    seq, mask, _ = _inputs(1)
    params = jax_dt5.DenseT5(jc).init(jax.random.PRNGKey(0), jnp.asarray(seq), jnp.asarray(mask))
    return jax.tree_util.tree_map(np.asarray, params)


def _port(layers, dropout=0.0):
    _, tc = _cfgs(layers, dropout)
    model = dense_t5.DenseT5(tc)
    model.load_state_dict(dense_t5_params_from_flax(_flax_params(layers), tc), strict=True)
    return model


def test_converter_on_the_full_config_tree():
    """DenseT5Config()'s own Flax tree: 54 leaves, 3,153,792 parameters, no
    ``shared`` embedding; every leaf lands on a port parameter of its shape."""
    cfg = configs.DenseT5Config()
    shapes = jax.eval_shape(jax_dt5.DenseT5(jconfigs.DenseT5Config()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 21, 768)),
                            jnp.ones((1, 21), jnp.int32))
    leaves = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == 54 and sum(int(np.prod(x.shape)) for x in leaves) == 3_153_792
    assert set(shapes["params"]) == {"encoder", "input_proj", "output_proj"}
    assert set(shapes["params"]["encoder"]) == {"encoder"}
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = dense_t5_params_from_flax(tree, cfg)
    assert len(sd) == 54 and sum(v.numel() for v in sd.values()) == 3_153_792
    assert not any("shared" in k for k in sd)
    model = dense_t5.DenseT5(cfg)
    assert {k: v.shape for k, v in model.state_dict().items()} == {k: v.shape
                                                                  for k, v in sd.items()}
    # a tree with a shared embedding has a leaf the port does not hold: strict refusal
    tree["params"]["encoder"]["shared"] = {"embedding": np.zeros((64, 512), np.float32)}
    with pytest.raises(KeyError, match="shared"):
        dense_t5_params_from_flax(tree, cfg)


def test_converter_transposes_the_projections():
    params = _flax_params(2)["params"]
    sd = _port(2).state_dict()
    np.testing.assert_array_equal(sd["input_proj.weight"].numpy(),
                                  params["input_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["output_proj.bias"].numpy(), params["output_proj"]["bias"])
    np.testing.assert_array_equal(
        sd["encoder.encoder.rel_bias.rel_embedding"].numpy(),
        params["encoder"]["encoder"]["rel_bias"]["rel_embedding"])


@pytest.mark.parametrize("mode", ["off", "on"])
def test_t5_encoder_matches_flax(mode):
    """The encoder alone on inputs_embeds with a padded key mask; padding
    query rows included."""
    jc, tc = _cfgs(1, mode=mode)
    seq, mask, _ = _inputs(4, seed=1)
    x = seq[..., :32]
    jm = JaxT5Encoder(jc.arch)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(2), None, jnp.asarray(mask), jnp.asarray(x)))
    assert "shared" not in params["params"]
    want = np.asarray(jm.apply(params, None, jnp.asarray(mask), jnp.asarray(x)))
    tm = T5Encoder(tc.arch)
    tm.load_state_dict(_state_from_flax(params, tm), strict=True)
    with torch.no_grad():
        got = tm.eval()(attention_mask=torch.from_numpy(mask), inputs_embeds=torch.from_numpy(x))
    assert got.shape == (4, L + 1, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert not any(isinstance(m, torch.nn.Embedding) for m in tm.modules())
    with pytest.raises(NotImplementedError, match="inputs_embeds"):
        tm(torch.zeros((4, L + 1), dtype=torch.int64), torch.from_numpy(mask))


@pytest.mark.parametrize("layers,mode", [(1, "off"), (2, "off"), (2, "on")])
def test_pred_and_loss_match_flax_in_eval_mode(layers, mode):
    jc, _ = _cfgs(layers, mode=mode)
    seq, mask, tgt = _inputs(6, seed=3)
    jm = jax_dt5.DenseT5(jc)
    params = _flax_params(layers)
    for m in (mask, None):
        jm_mask = None if m is None else jnp.asarray(m)
        loss_j, pred_j = jm.apply(params, jnp.asarray(seq), jm_mask, jnp.asarray(tgt))
        model = _port(layers).eval()
        with torch.no_grad():
            loss, pred = model(torch.from_numpy(seq), None if m is None else torch.from_numpy(m),
                               torch.from_numpy(tgt))
            gen = model.generate(torch.from_numpy(seq), None if m is None else torch.from_numpy(m))
        assert pred.shape == (6, EMB)
        np.testing.assert_allclose(pred.numpy(), np.asarray(pred_j), atol=1e-5)
        np.testing.assert_allclose(gen.numpy(), np.asarray(pred_j), atol=1e-5)
        assert abs(loss.item() - float(loss_j)) < 1e-5
        np.testing.assert_allclose(torch.linalg.vector_norm(pred, dim=1).numpy(), 1.0,
                                   atol=1e-6)


@pytest.mark.parametrize("valid", ["none", "all", "tail", "all_padding"])
def test_contrastive_loss_matches_jax(valid):
    """Without ``valid``, with every row valid, with a padded tail (−1e9 on
    both sides, the mean over the valid rows) and with no valid row."""
    r = np.random.default_rng(4)
    pred = r.normal(size=(7, 16)).astype(np.float32)
    tgt = r.normal(size=(7, 16)).astype(np.float32)
    v = {"none": None, "all": np.ones(7, bool), "tail": np.arange(7) < 4,
         "all_padding": np.zeros(7, bool)}[valid]
    want = float(jax_dt5.contrastive_loss(jnp.asarray(pred), jnp.asarray(tgt), 0.07,
                                          None if v is None else jnp.asarray(v)))
    p = torch.tensor(pred, requires_grad=True)
    got = dense_t5.contrastive_loss(p, torch.from_numpy(tgt), 0.07,
                                    None if v is None else torch.from_numpy(v))
    assert abs(got.item() - want) <= 1e-5 * max(1.0, abs(want)), (got.item(), want)
    got.backward()
    assert torch.isfinite(p.grad).all()
    if valid == "tail":  # padded rows carry no gradient
        assert p.grad[4:].abs().max() == 0 and p.grad[:4].abs().max() > 0
    if valid == "all_padding":
        assert got.item() == 0.0


@pytest.mark.parametrize("mode", ["off", "on"])
def test_parameter_gradients_match_jax_grad(mode):
    """The pipeline's training loss (normalised prediction, InfoNCE with a
    padded tail) at dropout 0 in training mode: every parameter gradient."""
    jc, tc = _cfgs(2, mode=mode)
    seq, mask, tgt = _inputs(6, seed=5)
    valid = np.arange(6) < 5
    jm = jax_dt5.DenseT5(jc)

    def loss_fn(p):
        _, pred = jm.apply(p, jnp.asarray(seq), jnp.asarray(mask), None, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_dt5.contrastive_loss(pred, jnp.asarray(tgt), jc.temperature,
                                        valid=jnp.asarray(valid))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(_flax_params(2))
    want = dense_t5_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tc)
    model = _port(2).train()
    _, pred = model(torch.from_numpy(seq), torch.from_numpy(mask))
    loss = dense_t5.contrastive_loss(pred, torch.from_numpy(tgt), tc.temperature,
                                     torch.from_numpy(valid))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) < 1e-5
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g is not None, k
        w = want[k]
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-9, (k, err)


def test_dropout_follows_the_generator_and_eval_is_deterministic():
    _, tc = _cfgs(2, dropout=0.3)
    seq, mask, tgt = _inputs(4, seed=6)
    t = [torch.from_numpy(a) for a in (seq, mask, tgt)]
    model = _port(2, dropout=0.3).train()

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
        a = model.eval()(*t)
        b = _port(2, dropout=0.0).eval()(*t)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_seeded_weights_follow_the_generator():
    _, tc = _cfgs(1)
    a, b = (dense_t5.DenseT5(tc, torch.Generator().manual_seed(s)).state_dict() for s in (0, 0))
    c = dense_t5.DenseT5(tc, torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_proj.weight"], c["input_proj.weight"])
    assert a["input_proj.bias"].abs().max() == 0
    assert torch.equal(a["encoder.encoder.final_norm.weight"], torch.ones(32))


# --- kernels #1 and #2 at DenseT5's shape: 4 heads, the user vector + 20 items ---

H, LS, D, RATE = 4, 21, 16, 0.3


def _attention_inputs(b, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(H * b, LS, D)).astype(np.float32) for _ in range(3))
    bias = r.normal(size=(H, LS, LS)).astype(np.float32)      # bidirectional, no causal fold
    lens = r.integers(0, LS, size=b)
    mask = (np.arange(LS)[None, :] <= lens[:, None]).astype(np.int32)  # right padding
    dmask = np.where(r.random((H * b, LS, LS)) >= RATE, np.float32(1 / (1 - RATE)),
                     np.float32(0.0)).astype(np.float32)
    return q, k, v, bias, mask, dmask


@pytest.mark.parametrize("dropout", [False, True])
def test_attention_plain_versions_match_pallas_at_the_dense_t5_shape(dropout):
    """(H·B, 21, 16) with a bidirectional bias and a right-padded key mask,
    with and without the rate-0.3 f32 dropout mask: #1's and #2's plain
    versions against the interpret-mode Pallas forward and ``jax.grad``
    through its backward."""
    q, k, v, bias, mask, dmask = _attention_inputs(4, seed=21 + dropout)
    rate = RATE if dropout else 0.0
    jd = jnp.asarray(dmask) if dropout else None
    td = torch.from_numpy(dmask) if dropout else None

    def run_j(q, k, v, b):
        return jax_fused(q, k, v, b, jnp.asarray(mask), dropout_rate=rate, dropout_mask=jd,
                         batch_block=2, interpret=True)

    j = [jnp.asarray(a) for a in (q, k, v, bias)]
    flat = lambda a: jnp.swapaxes(a.reshape(H, 4, LS, D), 0, 1)  # noqa: E731  (B, H, L, D)
    want = run_j(*[flat(a) for a in j[:3]], j[3])
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    got = ta.fused_t5_attention_flat(*t[:3], H, t[3], torch.from_numpy(mask),
                                     dropout_rate=rate, dropout_mask=td)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jnp.swapaxes(want, 0, 1)).reshape(H * 4, LS, D),
                               atol=1e-5)

    def loss_j(q, k, v, b):
        out = run_j(flat(q), flat(k), flat(v), b)
        return jnp.sum(jnp.sin(out))

    want_g = jax.grad(loss_j, (0, 1, 2, 3))(*j)
    torch.sin(got).sum().backward()
    for g, w in zip([x.grad for x in t], want_g):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max() + 1e-6

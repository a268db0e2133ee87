"""The port's bfloat16 compute path (``T5ArchConfig.dtype="bfloat16"``)
against the JAX package's at the same dtype, on the CPU.

Inputs are made with numpy from a seed (rounded to bf16 once, so both sides
hold the same bf16 values) and handed to both. On the CPU the port's kernel
wrappers run their plain versions; JAX's Pallas kernels run in interpret
mode. The JAX models are compiled with ``xla_allow_excess_precision`` off
(:func:`_jit_exact`): by default XLA's CPU backend keeps excess precision
inside its fusions and skips bf16 roundings that each op's output has op by
op and in the port (measured on TIGER: with it, JAX's gradients lay up to 7%
from the port's and its beam scores 0.14 apart; without it, 2.4% and 0.017,
and JAX equals its own op-by-op run within 1e-7). The bounds, each stated
where it is held:

- kernel #1's plain version at bf16 against ``fused_t5_attention_flat``: the
  same dtype, ``out`` within 2⁻⁸·max|ref| (one bf16 ulp at the largest value);
- kernel #2's plain version against ``jax.vjp`` through the same call: dq,
  dk, dv bf16 within 2⁻⁸·max|ref|; dbias f32 within 1e-5·max|ref| + 1e-6;
- the decode route's plain ``dot_product_attention`` at bf16 against JAX's
  ``_xla_attention``: out within 2⁻⁸·max|ref|;
- TIGER (fused "on" and "auto"), TIGER-prefix and DenseT5 at bf16 against
  Flax at bf16, dropout 0: loss within 5e-3·|loss|, logits (DenseT5: the
  normalised prediction) within 2⁻⁶·max|ref|, each gradient within 3e-2
  relative Frobenius error. The two frameworks round to bf16 at the same
  places but sum in their own order (RMSNorm's f32 mean differs in its last
  bit, and the next projection's bf16 rounding then now and then in one
  ulp), so the stacks drift apart by a few bf16 roundings;
- ``generate`` at bf16: beam scores within 1e-2; the top sequence equal on
  every row whose JAX margin over the second beam exceeds 0.05;
- one epoch of ``tiger_pipeline.train`` at bf16 against JAX's Trainer from
  the same weights: the train loss within 2e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu import configs as jconfigs
from genrec_tpu.data import datasets as jax_datasets
from genrec_tpu.data import synthetic as jax_synthetic
from genrec_tpu.data import tiger_tokens as jax_tokens
from genrec_tpu.models import dense_t5 as jax_dt5
from genrec_tpu.models import tiger as jax_tiger
from genrec_tpu.models import tiger_prefix as jax_tp
from genrec_tpu.ops.attention import _xla_attention as jax_xla_attention
from genrec_tpu.ops.t5_attention import fused_t5_attention_flat as jax_fused_flat
from genrec_tpu.pipelines.tiger_pipeline import _loss_fn as jax_loss_fn
from genrec_tpu.train.trainer import Trainer as JaxTrainer
from genrec_tpu_torch import configs
from genrec_tpu_torch.convert import (dense_t5_params_from_flax, tiger_params_from_flax,
                                      tiger_prefix_params_from_flax)
from genrec_tpu_torch.data import datasets, synthetic, tiger_tokens
from genrec_tpu_torch.data.contracts import write_codes
from genrec_tpu_torch.models import dense_t5, layers, t5
from genrec_tpu_torch.models import tiger_prefix as tp
from genrec_tpu_torch.models.tiger import TIGER, generate, make_constraint
from genrec_tpu_torch.ops import t5_attention as ta
from genrec_tpu_torch.ops.attention import dot_product_attention
from genrec_tpu_torch.pipelines import tiger_pipeline
from genrec_tpu_torch.serving.model_fn import dense_t5_model_fn, tiger_model_fn
from genrec_tpu_torch.train.checkpoint import CheckpointStore

BF16 = torch.bfloat16
ULP = 2.0 ** -8
H, B, D = 2, 4, 16
RATE = 0.1


def _bf16_np(x):
    """f32 values that are exact bf16 values (torch rounds to nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16).float().numpy()


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


def _jit_exact(fn, *args):
    """``jax.jit(fn)(*args)`` compiled without excess precision, so that every
    bf16 op's output is rounded as op-by-op JAX (and the port) rounds it."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# --------------------------------------------------------------------------
# kernels #1 and #2: the plain versions at bf16 against interpret-mode Pallas
# --------------------------------------------------------------------------

# name: (lq, lk, bias, causal folded into the bias, key mask, a fully padded row)
CASES = {"enc": (12, 12, True, False, True, False),
         "dec": (12, 12, True, True, False, False),
         "cross": (12, 10, False, False, True, False),
         "fully_padded_row": (12, 12, True, False, True, True)}


def _case(name, with_mask, seed=0):
    lq, lk, bias, causal, pad, fully = CASES[name]
    r = np.random.default_rng(seed)
    q, k, v, do = (_bf16_np(r.normal(size=(H * B, n, D))) for n in (lq, lk, lk, lq))
    pb = r.normal(size=(H, lq, lk)).astype(np.float32) if bias else None
    if causal:
        pb = pb + np.where(np.arange(lk)[None, :] > np.arange(lq)[:, None], -1e9,
                           0.0).astype(np.float32)
    mask = None
    if pad:
        mask = (r.random((B, lk)) > 0.3).astype(np.int32)
        mask[:, -1] = 1
        if fully:
            mask[0] = 0
    dm = None
    if with_mask:
        dm = np.where(r.random((H * B, lq, lk)) >= RATE, np.float32(1) / np.float32(1 - RATE),
                      0).astype(np.float32)
    return q, k, v, pb, mask, dm, do


def _jax_call(pb, mask, dm):
    rate = RATE if dm is not None else 0.0

    def f(q, k, v, b):
        return jax_fused_flat(q, k, v, H, b, _j(mask), dropout_rate=rate, dropout_mask=_j(dm),
                              batch_block=2, interpret=True)
    return f


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_plain_matches_pallas_at_bf16(name, with_mask):
    q, k, v, pb, mask, dm, _ = _case(name, with_mask)
    want = _jax_call(pb, mask, dm)(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                   _j(v, jnp.bfloat16), _j(pb))
    got = ta.fused_t5_attention_flat(_t(q, BF16), _t(k, BF16), _t(v, BF16), H, _t(pb),
                                     _t(mask), dropout_rate=RATE if with_mask else 0.0,
                                     dropout_mask=_t(dm))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= ULP * np.abs(want).max(), (name, err)
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_backward_plain_matches_jax_vjp_at_bf16(name, with_mask):
    q, k, v, pb, mask, dm, do = _case(name, with_mask, seed=1)
    f = _jax_call(pb, mask, dm)
    args = [_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16)]
    if pb is not None:
        _, vjp = jax.vjp(f, *args, _j(pb))
    else:
        _, vjp = jax.vjp(lambda q_, k_, v_: f(q_, k_, v_, None), *args)
    want = vjp(_j(do, jnp.bfloat16))
    got = ta.t5_attention_bwd(_t(q, BF16), _t(k, BF16), _t(v, BF16), H, _t(pb), _t(mask),
                              _t(do, BF16), dropout_mask=_t(dm))
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        assert w.dtype == jnp.bfloat16 and g.dtype == BF16, gname
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max()
        assert err <= ULP * np.abs(w).max(), (name, gname, err)
    if pb is None:
        assert got[3] is None
    else:
        assert want[3].dtype == jnp.float32 and got[3].dtype == torch.float32
        w = np.asarray(want[3])
        err = np.abs(got[3].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-6, (name, err)


def test_wrapper_dtype_contract():
    q, k, v, pb, mask, dm, do = _case("enc", True, seed=2)
    leaves = [_t(x, BF16).requires_grad_(True) for x in (q, k, v)]
    bias = _t(pb).requires_grad_(True)
    out = ta.fused_t5_attention_flat(*leaves, H, bias, _t(mask), dropout_rate=RATE,
                                     dropout_mask=_t(dm))
    assert out.dtype == BF16
    out.backward(_t(do, BF16))
    assert all(x.grad.dtype == BF16 for x in leaves)
    assert bias.grad.dtype == torch.float32
    # a bf16 bias is cast to f32, as the reference casts it: the same output,
    # and its gradient flows back through the cast
    bias16 = bias.detach().to(BF16).requires_grad_(True)
    out16 = ta.fused_t5_attention_flat(*(x.detach() for x in leaves), H, bias16, _t(mask))
    ref = ta.fused_t5_attention_flat(*(x.detach() for x in leaves), H,
                                     bias16.detach().float(), _t(mask))
    assert torch.equal(out16, ref)
    out16.float().sum().backward()
    assert bias16.grad.dtype == BF16
    # one dtype for q, k and v, f32 or bf16, and the output gradient in it
    qf, kf, vf = (_t(x) for x in (q, k, v))
    with pytest.raises(TypeError, match="share one dtype"):
        ta.fused_t5_attention_flat(qf, kf.to(BF16), vf, H)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ta.fused_t5_attention_flat(qf.half(), kf.half(), vf.half(), H)
    with pytest.raises(TypeError, match="output gradient"):
        ta.t5_attention_bwd(qf.to(BF16), kf.to(BF16), vf.to(BF16), H, None, None, _t(do))
    with pytest.raises(TypeError, match="dropout_mask"):
        ta.fused_t5_attention_flat(qf.to(BF16), kf.to(BF16), vf.to(BF16), H, dropout_rate=RATE,
                                   dropout_mask=_t(dm).to(BF16))
    assert ta.bf16_launches == ta.bf16_bwd_launches == 0  # the CPU never counts a launch


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_xla_at_bf16(causal):
    """The decode route's ``dot_product_attention`` at bf16 against JAX's
    ``_xla_attention``: scores summed in f32, the probabilities rounded to
    v's dtype before ·V, the output in bf16."""
    r = np.random.default_rng(3)
    q, k, v = (_bf16_np(r.normal(size=(B, H, n, D))) for n in (5, 9, 9))
    bias = r.normal(size=(B, 1, 1, 9)).astype(np.float32)
    want = jax_xla_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                             _j(bias), causal)
    got = dot_product_attention(_t(q, BF16), _t(k, BF16), _t(v, BF16), _t(bias),
                                causal=causal)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= ULP * np.abs(want).max(), err


def test_dropout_computes_in_the_input_dtype():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0)).to(BF16)
    y = layers.dropout(x, RATE, torch.Generator().manual_seed(1))
    assert y.dtype == BF16
    kept = (y != 0).numpy()
    # Flax's x / keep_prob in bf16
    want = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16) / (1.0 - RATE), np.float32)
    np.testing.assert_array_equal(y.float().numpy()[kept], want[kept])


# --------------------------------------------------------------------------
# the models at bf16 against Flax at bf16
# --------------------------------------------------------------------------

SEQ = configs.TIGERConfig().max_len * configs.TIGERConfig().code_dim
LT = 12


def _tiger_cfgs(mode, dtype="bfloat16"):
    jb, tb = jconfigs.TIGERConfig(), configs.TIGERConfig()
    jc = dataclasses.replace(jb, arch=dataclasses.replace(
        jb.arch, dropout_rate=0.0, fused_attention=mode, dtype=dtype))
    tc = dataclasses.replace(tb, arch=dataclasses.replace(tb.arch, dropout_rate=0.0,
                                                          dtype=dtype))
    return jc, tc


def _tiger_inputs(bsz, seed=0):
    r = np.random.default_rng(seed)
    ii = r.integers(1, 33, size=(bsz, SEQ)).astype(np.int32)
    pad = r.integers(0, SEQ // 2, size=bsz)
    pad[0] = 0
    am = (np.arange(SEQ)[None, :] >= pad[:, None]).astype(np.int32)
    lab = r.integers(1, 33, size=(bsz, LT)).astype(np.int32)
    lab[-1, LT // 2:] = -100
    return ii * am, am, lab


@pytest.fixture(scope="module")
def tiger_params():
    jc, _ = _tiger_cfgs("off", "float32")
    ii, am, lab = _tiger_inputs(1)
    params = jax.jit(jax_tiger.TIGER(jc).init)(jax.random.PRNGKey(0), jnp.asarray(ii),
                                                jnp.asarray(am), jnp.asarray(lab))
    return jax.tree_util.tree_map(np.asarray, params)


def _dtype_probe(model):
    """Hooks recording the output dtype of every T5Block and RMSNorm."""
    seen = {}

    def record(name):
        def hook(mod, args, out):  # returns None: the output stays as it is
            seen.setdefault(name, out.dtype)
        return hook

    hooks = [m.register_forward_hook(record(n)) for n, m in model.named_modules()
             if isinstance(m, (t5.T5Block, t5.RMSNorm))]
    return seen, hooks


def _close(got, want, what):
    """Loss within 5e-3·|loss|, the output within 2⁻⁶·max|ref|, each gradient
    within 3e-2 relative Frobenius error."""
    (lt, ot, gt), (lj, oj, gj) = got, want
    assert abs(lt - lj) <= 5e-3 * abs(lj), (what, lt, lj)
    err = np.abs(ot - oj).max()
    assert err <= 2.0 ** -6 * np.abs(oj).max(), (what, err)
    assert set(gt) == set(gj)
    # a leaf whose gradient is 0 in exact arithmetic (the adapters' key bias
    # shifts all of a query's scores alike) holds rounding noise on both
    # sides: its error is taken relative to 1e-3 of the whole gradient's norm
    floor = 1e-3 * float(torch.stack([w.norm() for w in gj.values()]).norm())
    for k, g in gt.items():
        w = gj[k]
        rel = float((g - w).norm()) / max(float(w.norm()), floor)
        assert rel <= 3e-2, (what, k, rel)


def _check_placement(model, seen, stream_dtypes):
    """Parameters f32; every RMSNorm returns f32; each stack's blocks return
    its residual stream's dtype."""
    assert all(p.dtype == torch.float32 for p in model.parameters())
    norms = [n for n in seen if n.endswith("norm")]
    assert norms and all(seen[n] == torch.float32 for n in norms)
    for stack, dtype in stream_dtypes.items():
        blocks = [n for n in seen if f"{stack}.blocks." in n and not n.endswith("norm")]
        assert blocks and all(seen[n] == dtype for n in blocks), (stack, seen)


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_tiger_matches_flax_at_bf16(tiger_params, mode):
    jc, tc = _tiger_cfgs(mode)
    ii, am, lab = _tiger_inputs(3, seed=3)
    jm = jax_tiger.TIGER(jc)

    def loss_fn(p):
        return jm.apply(p, jnp.asarray(ii), jnp.asarray(am), jnp.asarray(lab),
                        deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})

    (loss_j, logits_j), grads_j = _jit_exact(jax.value_and_grad(loss_fn, has_aux=True), 
        tiger_params)
    want = tiger_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tc)

    model = TIGER(tc)
    model.load_state_dict(tiger_params_from_flax(tiger_params), strict=True)
    model.train()
    seen, hooks = _dtype_probe(model)
    loss, logits = model(_t(ii), _t(am), _t(lab), generator=torch.Generator().manual_seed(0))
    loss.backward()
    for hk in hooks:
        hk.remove()
    assert logits.dtype == torch.float32
    assert model.model.shared(_t(ii)).dtype == BF16
    _check_placement(model, seen, {"encoder": BF16, "decoder": BF16})
    grads = {k: p.grad for k, p in model.named_parameters()}
    _close((loss.item(), logits.detach().numpy(), grads),
           (float(loss_j), np.asarray(logits_j), want), f"tiger {mode}")


def test_tiger_prefix_matches_flax_at_bf16():
    heads = dict(num_heads=2, d_kv=16)

    def arch(mod, **kw):
        return mod.T5ArchConfig(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=32,
                                d_ff=64, dropout_rate=0.0, **heads, **kw)

    kw = dict(bert_dim=16, max_len=8, beam_size=5, topk_list=(2, 5))
    jc = jconfigs.TIGERPrefixConfig(arch=arch(jconfigs, fused_attention="auto",
                                              dtype="bfloat16"), **kw)
    tc = configs.TIGERPrefixConfig(arch=arch(configs, dtype="bfloat16"), **kw)
    r = np.random.default_rng(4)
    seq = tc.max_len * tc.code_dim
    ii = r.integers(1, 33, size=(3, seq)).astype(np.int32)
    am = (np.arange(seq)[None, :] >= np.array([0, 5, 11])[:, None]).astype(np.int32)
    lab = r.integers(1, 33, size=(3, 8)).astype(np.int32)
    prof = [r.normal(0, 0.5, size=(3, 5, 16)).astype(np.float32) for _ in range(3)]
    jm = jax_tp.TIGERPrefix(jc)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(ii * am), jnp.asarray(am), jnp.asarray(lab),
        *map(jnp.asarray, prof)))

    def loss_fn(p):
        return jm.apply(p, jnp.asarray(ii * am), jnp.asarray(am), jnp.asarray(lab),
                        *map(jnp.asarray, prof), deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})

    (loss_j, logits_j), grads_j = _jit_exact(jax.value_and_grad(loss_fn, has_aux=True), params)
    want = tiger_prefix_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tc)
    model = tp.TIGERPrefix(tc)
    model.load_state_dict(tiger_prefix_params_from_flax(params, tc), strict=True)
    model.train()
    seen, hooks = _dtype_probe(model)
    loss, logits = model(_t(ii * am), _t(am), _t(lab), *map(_t, prof))
    loss.backward()
    for hk in hooks:
        hk.remove()
    # the f32 prefix tokens make the encoder's stream f32; the decoder's is bf16
    _check_placement(model, seen, {"encoder": torch.float32, "decoder": BF16})
    grads = {k: p.grad for k, p in model.named_parameters()}
    _close((loss.item(), logits.detach().numpy(), grads),
           (float(loss_j), np.asarray(logits_j), want), "tiger-prefix")


def test_dense_t5_matches_flax_at_bf16():
    def arch(mod, **kw):
        return mod.T5ArchConfig(d_model=32, num_layers=2, num_heads=2, d_kv=16, d_ff=64,
                                dropout_rate=0.0, dtype="bfloat16", **kw)

    kw = dict(input_emb_dim=32, target_emb_dim=32, max_seq_len=8)
    jc = jconfigs.DenseT5Config(arch=arch(jconfigs, fused_attention="auto"), **kw)
    tc = configs.DenseT5Config(arch=arch(configs), **kw)
    r = np.random.default_rng(5)
    seq = r.normal(size=(6, 9, 32)).astype(np.float32)
    mask = (np.arange(9)[None, :] <= np.array([8, 0, 3, 5, 8, 2])[:, None]).astype(np.int32)
    tgt = r.normal(size=(6, 32)).astype(np.float32)
    valid = np.arange(6) < 5
    jm = jax_dt5.DenseT5(jc)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(seq), jnp.asarray(mask)))

    def loss_fn(p):
        _, pred = jm.apply(p, jnp.asarray(seq), jnp.asarray(mask), None, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jax_dt5.contrastive_loss(pred, jnp.asarray(tgt), jc.temperature,
                                        valid=jnp.asarray(valid)), pred

    (loss_j, pred_j), grads_j = _jit_exact(jax.value_and_grad(loss_fn, has_aux=True), params)
    want = dense_t5_params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j), tc)
    model = dense_t5.DenseT5(tc)
    model.load_state_dict(dense_t5_params_from_flax(params, tc), strict=True)
    model.train()
    seen, hooks = _dtype_probe(model)
    _, pred = model(_t(seq), _t(mask))
    loss = dense_t5.contrastive_loss(pred, _t(tgt), tc.temperature, _t(valid))
    loss.backward()
    for hk in hooks:
        hk.remove()
    # f32 inputs_embeds + bf16 sublayer outputs: the residual stream stays f32
    _check_placement(model, seen, {"encoder": torch.float32})
    grads = {k: p.grad for k, p in model.named_parameters()}
    _close((loss.item(), pred.detach().numpy(), grads),
           (float(loss_j), np.asarray(pred_j), want), "dense-t5")


def test_unknown_dtype_raises():
    arch = dataclasses.replace(configs.TIGERConfig().arch, dtype="float16")
    with pytest.raises(ValueError, match="dtype"):
        TIGER(configs.TIGERConfig(arch=arch))
    with pytest.raises(ValueError, match="dtype"):
        t5.T5Encoder(arch)


# --------------------------------------------------------------------------
# generation, serving and one pipeline epoch at bf16
# --------------------------------------------------------------------------

def test_generate_matches_jax_at_bf16(tiger_params):
    n_items, beams = 120, 20
    codes = synthetic.make_codes(n_items)
    jc, tc = _tiger_cfgs("auto")
    jc = dataclasses.replace(jc, constrained_decoding="level")
    tc = dataclasses.replace(tc, constrained_decoding="level")
    r = np.random.default_rng(6)
    table = codes[1:] + np.arange(4)[None, :] * 8 + 1
    ii = np.zeros((4, SEQ), np.int32)
    for row, n in enumerate((3, 20, 7, 12)):
        ii[row, SEQ - 4 * n:] = table[r.integers(0, n_items, size=n)].reshape(-1)
    am = (ii != 0).astype(np.int32)
    jm = jax_tiger.TIGER(jc)
    jcon = jax_tiger.make_constraint(jc, codes)
    jt, js = _jit_exact(lambda p, a, b: jax_tiger.generate(jm, p, a, b, num_beams=beams,
                                                           constraint=jcon),
                        tiger_params, jnp.asarray(ii), jnp.asarray(am))
    jt, js = np.asarray(jt), np.asarray(js)

    model = TIGER(tc)
    model.load_state_dict(tiger_params_from_flax(tiger_params))
    model.eval()
    tt, ts = generate(model, _t(ii), _t(am), num_beams=beams,
                      constraint=make_constraint(tc, codes))
    assert ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-2)
    clear = js[:, 0] - js[:, 1] > 0.05
    assert clear.any()
    np.testing.assert_array_equal(tt.numpy()[clear, 0], jt[clear, 0])


def test_bf16_checkpoint_round_trips_and_serves(tiger_params, tmp_path):
    _, tc = _tiger_cfgs("auto")
    codes = synthetic.make_codes(60)
    codes_path = str(tmp_path / "codes.npy")
    write_codes(codes_path, codes, write_mapping_json=False)
    model = TIGER(tc)
    model.load_state_dict(tiger_params_from_flax(tiger_params))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    store = CheckpointStore(str(tmp_path / "ckpt"))
    store.save_best(model.state_dict())
    back = store.restore_best()
    assert back.keys() == model.state_dict().keys()
    assert all(v.dtype == torch.float32 and torch.equal(v, model.state_dict()[k])
               for k, v in back.items())
    fn = tiger_model_fn(str(tmp_path / "ckpt"), codes_path, cfg=tc, device="cpu")
    got = fn([3, 17, 42], 5)
    assert 0 < len(got) <= 5 and all(1 <= i <= 60 for i in got)
    assert not {3, 17, 42} & set(got)
    assert got == fn([3, 17, 42], 5)  # deterministic at bf16


def test_bf16_dense_t5_checkpoint_serves(tmp_path):
    """A bf16-config DenseT5 checkpoint (f32 parameters) served by
    ``dense_t5_model_fn``: its lists are the cosine ranking of the bf16
    model's own query vector."""
    arch = configs.T5ArchConfig(d_model=32, num_layers=2, num_heads=2, d_kv=16, d_ff=64,
                                dtype="bfloat16")
    cfg = configs.DenseT5Config(arch=arch, input_emb_dim=32, target_emb_dim=32, max_seq_len=8)
    model = dense_t5.DenseT5(cfg, torch.Generator().manual_seed(0)).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    CheckpointStore(str(tmp_path / "ckpt")).save_best(model.state_dict())
    items = np.random.default_rng(7).normal(size=(41, 32)).astype(np.float32)
    fn = dense_t5_model_fn(str(tmp_path / "ckpt"), items, cfg=cfg, device="cpu")
    hist = [5, 17, 33]
    seq = np.zeros((1, 9, 32), np.float32)
    seq[0, 1:4] = items[hist]
    mask = (np.arange(9)[None, :] <= 3).astype(np.int32)
    pred = model.generate(_t(seq), _t(mask))[0].numpy()
    table = items / np.linalg.norm(items, axis=1, keepdims=True)
    scores = table @ pred
    scores[0], scores[hist] = -1e9, -np.inf
    assert fn(hist, 5) == [int(i) for i in np.argsort(-scores)[:5]]


def test_one_pipeline_epoch_matches_jax_at_bf16(tmp_path, monkeypatch):
    """``tiger_pipeline.train`` for one epoch at bf16 from Flax's initial
    weights, on the TIGER pipeline test's corpus, against JAX's Trainer."""
    arch = dict(vocab_size=64, num_layers=1, num_decoder_layers=1, d_model=32, d_ff=64,
                num_heads=2, d_kv=16, dropout_rate=0.0, dtype="bfloat16")
    trainer = dict(epochs=1, batch_size=64, eval_batch_size=64, lr=3e-3,
                   early_stop_patience=10, seed=0)
    cfg = configs.TIGERConfig(arch=configs.T5ArchConfig(**arch), max_len=8,
                              trainer=configs.TrainerConfig(ckpt_dir=str(tmp_path / "port"),
                                                            **trainer))
    jc = jconfigs.TIGERConfig(arch=jconfigs.T5ArchConfig(**arch), max_len=8)
    corpus = jax_synthetic.make_interactions(num_users=300, num_items=60, min_len=4,
                                             max_len=15, num_topics=6,
                                             topic_stickiness=0.95, seed=7)
    codes = jax_synthetic.make_codes(num_items=60, codebook_size=8, num_levels=3, seed=5)
    jtr, jte = jax_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    jtr = jax_datasets.build_tiger_arrays(jtr, 8, 4)
    jte = jax_datasets.build_tiger_arrays(jte, 8, 4, max_target_items=1)
    tr, te = tiger_tokens.build_tiger_splits(corpus.item_id_lists, corpus.user_ids, codes)
    tr = datasets.build_tiger_arrays(tr, 8, 4)
    te = datasets.build_tiger_arrays(te, 8, 4, max_target_items=1)

    seq = cfg.max_len * cfg.code_dim
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_tiger.TIGER(jc).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32), jnp.ones((1, seq), jnp.int32),
        jnp.ones((1, 4), jnp.int32)))
    jcfg = jconfigs.TrainerConfig(**dict(dataclasses.asdict(cfg.trainer),
                                         ckpt_dir=str(tmp_path / "jax")))
    jloss, jval = jax_loss_fn(jax_tiger.TIGER(jc))
    want = JaxTrainer(jcfg, init_params=params, loss_fn=jloss, eval_loss_fn=jval,
                      steps_per_epoch=-(-len(jtr.input_ids) // 64), logger_name="bf16_jax",
                      train_data=jtr.arrays, val_data=jte.arrays).fit()

    def from_flax(c, generator=None):
        model = TIGER(c)
        model.load_state_dict(tiger_params_from_flax(params, c))
        return model

    monkeypatch.setattr(tiger_pipeline, "TIGER", from_flax)
    got = tiger_pipeline.train(cfg, tr, te, device="cpu").result
    assert got.epochs_run == want.epochs_run == 1
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=2e-2)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=2e-2)

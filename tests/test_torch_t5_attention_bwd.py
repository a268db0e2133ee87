"""The port's fused T5 attention backward (genrec_tpu_torch/ops/t5_attention.py)
against ``jax.grad`` through the JAX package's Pallas kernel pair, run in
interpret mode on the CPU.

On the CPU the autograd Function's backward runs the plain version
``t5_attention_bwd_reference``; the CUDA kernel is held against that plain
version on the card by ``chip_smoke.py``. Inputs and dropout masks are made
with numpy from a seed and handed to both sides. Tolerance, as the JAX
package holds its kernel against XLA: atol 5e-6 and max abs ≤ 1e-4·max|ref|
+ 1e-6 on dq, dk, dv and dbias (f32, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops.t5_attention import fused_t5_attention as jax_fused
from genrec_tpu_torch.ops import t5_attention as ta

B, H, LQ, LK, D = 4, 2, 12, 10, 8
RATE = 0.1


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    q = r.normal(size=(B, H, LQ, D)).astype(np.float32)
    k = r.normal(size=(B, H, LK, D)).astype(np.float32)
    v = r.normal(size=(B, H, LK, D)).astype(np.float32)
    bias = r.normal(size=(H, LQ, LK)).astype(np.float32)
    mask = (r.random((B, LK)) > 0.2).astype(np.int32)
    # a given dropout mask, in the flat (H·B, Lq, Lk) layout, f32 {0, 1/keep}
    dmask = np.where(r.random((H * B, LQ, LK)) >= RATE, np.float32(1 / (1 - RATE)),
                     np.float32(0)).astype(np.float32)
    return q, k, v, bias, mask, dmask


def _grads_both(q, k, v, bias, mask, causal, dmask=None):
    """(JAX grads, port grads) of sum(sin(attention)) w.r.t. q, k, v (and
    the bias when given)."""
    rate = RATE if dmask is not None else 0.0
    jm = None if mask is None else jnp.asarray(mask)
    jd = None if dmask is None else jnp.asarray(dmask)
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)

    def loss_j(q, k, v, b=None):
        return jnp.sum(jnp.sin(jax_fused(q, k, v, b, jm, causal=causal, dropout_rate=rate,
                                         dropout_mask=jd, batch_block=2, interpret=True)))

    jargs = [jnp.asarray(a) for a in (q, k, v, bias) if a is not None]
    want = jax.grad(loss_j, argnums)(*jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias) if a is not None]
    tb = targs[3] if bias is not None else None
    out = ta.fused_t5_attention(*targs[:3], tb, None if mask is None else torch.tensor(mask),
                                causal=causal, dropout_rate=rate,
                                dropout_mask=None if dmask is None else torch.tensor(dmask))
    torch.sin(out).sum().backward()
    return [np.asarray(w) for w in want], [t.grad.numpy() for t in targs]


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-6)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_backward_matches_pallas_grads(inputs, causal, with_bias, with_mask):
    q, k, v, bias, mask, _ = inputs
    want, got = _grads_both(q, k, v, bias if with_bias else None,
                            mask if with_mask else None, causal)
    assert len(got) == (4 if with_bias else 3)
    _assert_close(got, want)


def test_backward_fully_masked_rows_match_pallas(inputs):
    """Additive −1e9 semantics in the backward too: rows whose keys are all
    masked give finite gradients equal to JAX's."""
    q, k, v, bias, _, _ = inputs
    mask = np.ones((B, LK), np.int32)
    mask[0] = 0
    want, got = _grads_both(q, k, v, bias, mask, False)
    assert all(np.isfinite(g).all() for g in got)
    _assert_close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_with_given_dropout_mask_matches_pallas(inputs, causal):
    q, k, v, bias, mask, dmask = inputs
    want, got = _grads_both(q, k, v, bias, mask, causal, dmask)
    _assert_close(got, want)


class _PlainF64(torch.autograd.Function):
    """The plain forward and backward of the port in f64 (the kernels and
    their wrapper take f32 only)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, dmask, h, causal):
        ctx.save_for_backward(q, k, v, bias, mask, dmask)
        ctx.h, ctx.causal = h, causal
        return ta.t5_attention_reference(q, k, v, h, bias, mask, causal=causal,
                                         dropout_mask=dmask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, dmask = ctx.saved_tensors
        dq, dk, dv, db = ta.t5_attention_bwd_reference(
            q, k, v, ctx.h, bias, mask, do, causal=ctx.causal, dropout_mask=dmask)
        return dq, dk, dv, db, None, None, None, None


@pytest.mark.parametrize("dropout", [False, True])
def test_plain_backward_passes_gradcheck_in_f64(dropout):
    r = np.random.default_rng(3)
    # no fully masked row: its logits sit near −1e9, where f64's spacing
    # (1.2e-7) swamps the finite differences (those rows are held to JAX above)
    h, b, lq, lk, d = 2, 2, 3, 4, 3
    t = lambda a: torch.tensor(a, dtype=torch.float64, requires_grad=True)  # noqa: E731
    q, k, v = (t(r.normal(size=(h * b, n, d))) for n in (lq, lk, lk))
    bias = t(r.normal(size=(h, lq, lk)))
    mask = torch.tensor([[1, 1, 0, 1], [0, 1, 1, 1]], dtype=torch.int32)
    dmask = (torch.tensor(np.where(r.random((h * b, lq, lk)) > 0.3, 1 / 0.7, 0.0))
             if dropout else None)
    fn = lambda q, k, v, bias: _PlainF64.apply(q, k, v, bias, mask, dmask, h, True)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v, bias), eps=1e-6, atol=1e-7)


def test_backward_takes_a_strided_gradient_and_skips_unwanted_dbias(inputs):
    """The gradient that reaches the backward through a permute is made
    contiguous (at B = 1 too); no dbias is computed for a bias that needs
    none."""
    q, k, v, bias, mask, _ = inputs
    for b in (1, B):
        qf = torch.tensor(q[:b].transpose(1, 0, 2, 3).reshape(H * b, LQ, D), requires_grad=True)
        kf = torch.tensor(k[:b].transpose(1, 0, 2, 3).reshape(H * b, LK, D))
        vf = torch.tensor(v[:b].transpose(1, 0, 2, 3).reshape(H * b, LK, D))
        out = ta.fused_t5_attention_flat(qf, kf, vf, H, torch.tensor(bias),
                                         torch.tensor(mask[:b]))
        # (H·B, Lq, D) → (B, Lq, H·D) as the model reshapes it: the incoming
        # gradient of the flat output is a strided view
        y = out.view(H, b, LQ, D).permute(1, 2, 0, 3).reshape(b, LQ, H * D)
        (y * torch.arange(H * D, dtype=torch.float32)).sum().backward()
        ref = ta.t5_attention_bwd_reference(
            qf.detach(), kf, vf, H, torch.tensor(bias), torch.tensor(mask[:b]),
            (torch.arange(H * D, dtype=torch.float32).expand(b, LQ, H * D)
             .reshape(b, LQ, H, D).permute(2, 0, 1, 3).reshape(H * b, LQ, D).contiguous()),
            need_dbias=False)
        assert ref[3] is None
        torch.testing.assert_close(qf.grad, ref[0], rtol=0, atol=1e-6)


def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(inputs):
    q, k, v, bias, mask, _ = inputs
    qf = torch.tensor(q.reshape(B * H, LQ, D))
    kf, vf = torch.tensor(k.reshape(B * H, LK, D)), torch.tensor(v.reshape(B * H, LK, D))
    do = torch.ones_like(qf)
    with pytest.raises(ValueError, match="output gradient"):
        ta.t5_attention_bwd(qf, kf, vf, H, None, None, do[:, :-1].contiguous())
    with pytest.raises(TypeError, match="output gradient"):
        ta.t5_attention_bwd(qf, kf, vf, H, None, None, do.double())
    with pytest.raises(ValueError, match="contiguous"):
        ta.t5_attention_bwd(qf, kf, vf, H, None, None, do.transpose(1, 2).transpose(1, 2)
                            .as_strided(do.shape, (LQ * D, 1, LQ)))
    meta = [t.to("meta") for t in (qf, kf, vf, do)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        ta.t5_attention_bwd(*meta[:3], H, None, None, meta[3])
    assert ta.bwd_launches == 0  # the CPU path never counts a kernel launch


def test_make_dropout_mask_draws_from_the_generator():
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    m = ta.make_dropout_mask(g(0), 64, 64, 64, RATE)
    assert m.dtype == torch.float32 and m.shape == (64, 64, 64)
    vals = set(torch.unique(m).tolist())
    assert vals == {0.0, float(np.float32(1 / (1 - RATE)))}  # f32 1/keep, not bf16's 1.109375
    assert abs(float((m == 0).float().mean()) - RATE) < 0.01
    assert torch.equal(m, ta.make_dropout_mask(g(0), 64, 64, 64, RATE))
    assert not torch.equal(m, ta.make_dropout_mask(g(1), 64, 64, 64, RATE))

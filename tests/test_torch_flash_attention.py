"""The port's flash attention (genrec_tpu_torch/ops/attention.py) against the
JAX package's Pallas kernels #3-#6, run in interpret mode on the CPU.

On the CPU the kernel wrappers run their plain versions
(``flash_attention_fwd_reference`` / ``flash_attention_bwd_reference``);
``chip_smoke.py`` holds the CUDA kernels against those plain versions on the
card. The reference's blocked route (#4, #6) is taken by setting its
``_BWD_FULL_REF_BYTES_LIMIT`` to 1, as tests/test_ops.py does. Inputs are
made with numpy from a seed and handed to both sides. Tolerances, as the JAX
package holds its kernels against XLA: forward out and lse within 2e-5,
gradients within 3e-4 (f32, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops import attention as A
from genrec_tpu_torch.ops import attention as ta

H = 2


def _qkv(b, lq, lk, d, seed=0, bias=False):
    r = np.random.default_rng(seed)
    out = [r.normal(size=(b, H, n, d)).astype(np.float32) for n in (lq, lk, lk)]
    out.append(r.normal(size=(1, H, lq, lk)).astype(np.float32) if bias else None)
    out.append(r.normal(size=(b, H, lq, d)).astype(np.float32))  # an output cotangent
    return out


def _route(monkeypatch, route):
    if route == "blocked":
        monkeypatch.setattr(A, "_BWD_FULL_REF_BYTES_LIMIT", 1)
    assert A._use_blocked_bwd(256, 256, 64) == (route == "blocked")


def _t(a, **kw):
    return None if a is None else torch.tensor(a, **kw)


@pytest.mark.parametrize("route,causal,with_bias,lq,lk,d", [
    ("full", False, False, 128, 256, 64),
    ("full", True, False, 256, 256, 16),
    ("full", False, True, 256, 256, 16),
    ("full", True, True, 128, 128, 64),
    ("blocked", False, False, 128, 256, 16),
    ("blocked", True, False, 256, 256, 64),
])
def test_plain_forward_matches_pallas_out_and_lse(monkeypatch, route, causal, with_bias, lq, lk,
                                                  d):
    """Kernel #3 (full) and #4 (blocked) against the port's plain forward."""
    _route(monkeypatch, route)
    b = 2
    q, k, v, bias, _ = _qkv(b, lq, lk, d, seed=lq + d, bias=with_bias)
    bq, bk = A._auto_blocks(lq, lk, d)
    jbias = None if bias is None else jnp.broadcast_to(jnp.asarray(bias), (b, H, lq, lk))
    want_out, want_lse = A._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias,
                                          causal, bq, bk, True)
    flat = lambda a: torch.tensor(a).reshape(b * H, *a.shape[2:])  # noqa: E731
    tb = None if bias is None else torch.tensor(np.broadcast_to(bias, (b, H, lq, lk))
                                                .reshape(b * H, lq, lk))
    out, lse = ta.flash_attention_fwd(flat(q), flat(k), flat(v), tb, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out).reshape(b * H, lq, d),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("route", ["full", "blocked"])
@pytest.mark.parametrize("causal", [False, True])
def test_function_grads_match_jax_grad(monkeypatch, route, causal):
    """The Function's backward (plain dq and dk/dv) against ``jax.grad``
    through kernels #5 (full) and #6 (blocked)."""
    _route(monkeypatch, route)
    b, l, d = 2, 256, 16
    q, k, v, _, w = _qkv(b, l, l, d, seed=7)

    def loss_j(q, k, v):
        return jnp.sum(A.flash_attention(q, k, v, causal=causal, interpret=True) * w)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (ta.flash_attention(*leaves, causal=causal) * torch.tensor(w)).sum().backward()
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_biased_function_grads_match_jax_grad_with_dbias(causal):
    """With a bias the backward recomputes through _xla_attention: all four
    gradients, dbias summed over the broadcast batch, equal JAX's."""
    b, l, d = 2, 128, 16
    q, k, v, bias, w = _qkv(b, l, l, d, seed=3, bias=True)

    def loss_j(q, k, v, bias):
        return jnp.sum(A.flash_attention(q, k, v, bias, causal=causal, interpret=True) * w)

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    (ta.flash_attention(*leaves, causal=causal) * torch.tensor(w)).sum().backward()
    assert leaves[3].grad.shape == (1, H, l, l)
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_function_passes_gradcheck_in_f64(causal, with_bias):
    r = np.random.default_rng(5)
    t = lambda *s: torch.tensor(r.normal(size=s), dtype=torch.float64,  # noqa: E731
                                requires_grad=True)
    args = [t(1, 1, 128, 4) for _ in range(3)] + ([t(1, 1, 128, 128)] if with_bias else [])
    fn = lambda *a: ta.flash_attention(*a, causal=causal)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6, fast_mode=True)


def test_reference_assertions_and_biased_backward_guard(monkeypatch):
    x = torch.zeros(1, H, 128, 16)
    with pytest.raises(AssertionError, match="multiples of 128"):
        ta.flash_attention(torch.zeros(1, H, 100, 16), x, x)
    with pytest.raises(AssertionError, match="lq == lk"):
        ta.flash_attention(x, torch.zeros(1, H, 256, 16), torch.zeros(1, H, 256, 16),
                           causal=True)
    # the reference raises where its biased backward would be blocked-scale
    monkeypatch.setattr(ta, "_BWD_FULL_REF_BYTES_LIMIT", 1)
    q = torch.zeros(1, H, 128, 16, requires_grad=True)
    out = ta.flash_attention(q, x, x, torch.zeros(1, H, 128, 128))
    with pytest.raises(NotImplementedError, match="blocked-kernel scale"):
        out.sum().backward()
    out = ta.flash_attention(q, x, x)  # no bias: no guard
    out.sum().backward()


@pytest.mark.parametrize("causal", [False, True])
def test_dq_and_dkv_wrappers_make_up_the_backward(causal):
    """The dq and dk/dv wrappers (one CUDA kernel each) on their shared
    inputs give the whole backward's gradients."""
    q, k, v, _, do = (torch.tensor(a[0]) if a is not None else None
                      for a in _qkv(1, 256, 256, 16, seed=13))
    out, lse = ta.flash_attention_fwd(q, k, v, causal=causal)
    delta = ta._delta(do, out)
    want = ta.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    got = (ta.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal),
           *ta.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="delta"):
        ta.flash_attention_bwd_dq(q, k, v, do, lse, delta[:, :-1], causal=causal)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros(2, 128, 16)
    with pytest.raises(ValueError, match="k/v"):
        ta.flash_attention_fwd(f, torch.zeros(2, 128, 8), f)
    with pytest.raises(ValueError, match="bias"):
        ta.flash_attention_fwd(f, f, f, torch.zeros(2, 128, 64))
    with pytest.raises(ValueError, match="lse"):
        ta.flash_attention_bwd(f, f, f, f, torch.zeros(2, 64), f)
    meta = f.to("meta")
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        ta.flash_attention_fwd(meta, meta, meta)


def test_dot_product_attention_on_cpu_stays_plain_and_counts_no_launch():
    """The gate needs CUDA tensors: at L=512 on the CPU the plain path runs;
    ``force_kernel=True`` takes the Function, whose CPU tensors run the plain
    versions. Neither counts a kernel launch; both give the same values."""
    q, k, v, _, _ = _qkv(1, 512, 512, 16, seed=11)
    q, k, v = map(torch.tensor, (q, k, v))
    assert not ta._use_kernel(q, k)
    plain = ta.dot_product_attention(q, k, v, causal=True)
    torch.testing.assert_close(plain, ta._xla_attention(q, k, v, causal=True), rtol=0, atol=0)
    forced = ta.dot_product_attention(q, k, v, causal=True, force_kernel=True)
    torch.testing.assert_close(forced, plain, rtol=2e-5, atol=2e-5)
    assert ta.fwd_launches == ta.bwd_dq_launches == ta.bwd_dkv_launches == 0


@pytest.mark.parametrize("lq,lk,causal,with_bias", [
    (12, 12, True, True), (8, 12, True, False), (12, 8, False, True)])
def test_xla_attention_matches_jax(lq, lk, causal, with_bias):
    q, k, v, bias, _ = _qkv(2, lq, lk, 8, seed=lq * lk, bias=with_bias)
    want = A._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if bias is None else jnp.asarray(bias), causal)
    got = ta._xla_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), _t(bias),
                            causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_attention_weight_dropout_rate_seed_and_eval():
    """Dropout parity is statistical (torch and JAX draw different bits): the
    drop share is the rate, the kept weights are scaled by 1/keep, one seed
    gives one result, no generator means no dropout, and dropout keeps even a
    forced call off the kernels, as the reference routes it."""
    q, k, v, _, _ = _qkv(2, 128, 128, 16, seed=2)
    q, k = torch.tensor(q), torch.tensor(k)
    eye = torch.eye(128).expand(2, H, 128, 128).contiguous()  # v = I exposes the weights
    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    rate = 0.2
    probs = ta._xla_attention(q, k, eye)
    dropped = ta.dot_product_attention(q, k, eye, dropout_rate=rate, generator=g(0),
                                       force_kernel=True)
    zero = dropped == 0
    assert abs(float(zero.float().mean()) - rate) < 0.01
    torch.testing.assert_close(dropped[~zero], probs[~zero] / (1 - rate))
    again = ta.dot_product_attention(q, k, eye, dropout_rate=rate, generator=g(0))
    assert torch.equal(dropped, again)
    assert not torch.equal(dropped, ta.dot_product_attention(q, k, eye, dropout_rate=rate,
                                                             generator=g(1)))
    torch.testing.assert_close(ta.dot_product_attention(q, k, eye, dropout_rate=rate), probs,
                               rtol=0, atol=0)
    assert ta.fwd_launches == 0

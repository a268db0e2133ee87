"""The port's fused T5 attention forward (genrec_tpu_torch/ops/t5_attention.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
is held against that plain version on the card by ``chip_smoke.py``. Inputs
are made with numpy from a seed and handed to both. Tolerance: atol 1e-5, f32
with another summation order on each side (the Pallas interpreter's XLA dots
against PyTorch's CPU bmm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops.attention import _xla_attention
from genrec_tpu.ops.t5_attention import fused_t5_attention as jax_fused
from genrec_tpu.ops.t5_attention import fused_t5_attention_flat as jax_fused_flat
from genrec_tpu.ops.t5_attention import make_dropout_mask
from genrec_tpu_torch.ops import _build
from genrec_tpu_torch.ops import t5_attention as ta
from genrec_tpu_torch.ops.attention import dot_product_attention

B, H, LQ, LK, D = 4, 2, 12, 10, 8
ATOL = 1e-5


@pytest.fixture(scope="module")
def qkv():
    r = np.random.default_rng(0)
    q = r.normal(size=(B, H, LQ, D)).astype(np.float32)
    k = r.normal(size=(B, H, LK, D)).astype(np.float32)
    v = r.normal(size=(B, H, LK, D)).astype(np.float32)
    bias = r.normal(size=(H, LQ, LK)).astype(np.float32)
    mask = (r.random((B, LK)) > 0.2).astype(np.int32)
    return q, k, v, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_forward_matches_pallas(qkv, causal, with_bias, with_mask):
    q, k, v, bias, mask = qkv
    b_ = bias if with_bias else None
    m_ = mask if with_mask else None
    want = jax_fused(_j(q), _j(k), _j(v), _j(b_), _j(m_), causal=causal, batch_block=2,
                     interpret=True)
    got = ta.fused_t5_attention(_t(q), _t(k), _t(v), _t(b_), _t(m_), causal=causal)
    assert got.shape == (B, H, LQ, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flat_layout_matches_pallas(qkv):
    """The flat (H·B, L, D) entry, head dimension slowest, as the model calls it."""
    q, k, v, bias, mask = qkv
    flat = lambda x: np.ascontiguousarray(  # noqa: E731
        x.transpose(1, 0, 2, 3).reshape(H * B, x.shape[2], D))
    want = jax_fused_flat(_j(flat(q)), _j(flat(k)), _j(flat(v)), H, _j(bias), _j(mask),
                          causal=True, batch_block=2, interpret=True)
    got = ta.fused_t5_attention_flat(_t(flat(q)), _t(flat(k)), _t(flat(v)), H, _t(bias),
                                     _t(mask), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fully_masked_rows_match_pallas(qkv):
    """Additive −1e9 semantics: a row whose keys are all masked comes out
    finite (the mean of v over the keys tied at the maximum), as in JAX."""
    q, k, v, bias, _ = qkv
    mask = np.ones((B, LK), np.int32)
    mask[0] = 0
    want = jax_fused(_j(q), _j(k), _j(v), _j(bias), _j(mask), batch_block=2, interpret=True)
    got = ta.fused_t5_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_given_dropout_mask_matches_pallas(qkv):
    """The same multiplicative mask on both sides (JAX's bf16 {0, 1/keep}
    values, exact in f32) gives the same output."""
    q, k, v, bias, mask = qkv
    rate = 0.1
    dmask = make_dropout_mask(jax.random.PRNGKey(7), H * B, LQ, LK, rate)
    want = jax_fused(_j(q), _j(k), _j(v), _j(bias), _j(mask), dropout_rate=rate,
                     dropout_mask=dmask, batch_block=2, interpret=True)
    got = ta.fused_t5_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask), dropout_rate=rate,
                                dropout_mask=_t(np.asarray(dmask, np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # rate 0 ignores a given mask, as the reference does
    plain = ta.fused_t5_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                                  dropout_mask=_t(np.zeros((H * B, LQ, LK), np.float32)))
    ref = jax_fused(_j(q), _j(k), _j(v), _j(bias), _j(mask), batch_block=2, interpret=True)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_xla(qkv, causal):
    """The plain multi-head attention (1/√d scale, additive bias, causal at
    −1e30 with the lk − lq offset) against the JAX package's XLA path."""
    q, k, v, bias, mask = qkv
    add = bias[None] + (1.0 - mask[:, None, None, :]) * -1e9
    want = _xla_attention(_j(q), _j(k), _j(v), _j(add), causal)
    got = dot_product_attention(_t(q), _t(k), _t(v), _t(add.astype(np.float32)),
                                causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_refuses_what_the_kernel_does_not_take(qkv):
    q, k, v, bias, mask = (_t(a) for a in qkv)
    with pytest.raises(TypeError):
        ta.fused_t5_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        ta.fused_t5_attention(q, k, v, bias[:, :, :-1].contiguous())
    qf, kf, vf = q.reshape(-1, LQ, D), k.reshape(-1, LK, D), v.reshape(-1, LK, D)
    strided = torch.cat([qf, qf], dim=-1)[..., :D]
    assert strided.shape == qf.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ta.fused_t5_attention_flat(strided, kf, vf, H)
    with pytest.raises(TypeError):
        ta.fused_t5_attention(q, k, v, bias, mask.float())
    with pytest.raises(ValueError):
        ta.fused_t5_attention(q, k, v, dropout_rate=0.1)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        ta.fused_t5_attention(*meta)
    assert ta.launches == 0  # the CPU path never counts a kernel launch


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A missing compiler is an error, never a fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("t5_attention_fwd")
    assert not list(tmp_path.rglob("*.so"))

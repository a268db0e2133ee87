"""The arithmetic that the Hopper design of the fused T5 attention backward
(genrec_tpu_torch/csrc/t5_attention_bwd.cu) rests on, checked on the CPU
against the JAX package's Pallas kernels in interpret mode.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against ``t5_attention_bwd_reference``. Here:

- delta: the kernel takes delta_i = Σ_j dp_ij·p_ij from one online pass over
  the keys, 8 at a time on 4 lanes (running max m, l = Σ e^(s−m),
  u = Σ e^(s−m)·dp, then a 4-lane combine); that equals rowsum(dO ∘ O) of
  the Pallas forward's output and the direct rowsum(dp·dm·p), to 1e-5;
- dbias: the in-order sum over the batch of the per-block ds scratch
  (H, B, Lq, Lk) that the reduction kernel computes equals the Pallas
  kernel's dbias;
- 3xTF32: the product split a = hi + lo in TF32 (10 mantissa bits, rounded
  to nearest as ``cvt.rna`` does), summed as lo·hi + hi·lo + hi·hi in f32,
  stays within 1e-6·max of an f64 product at the train shapes' depths (16,
  80, 156) and the kernel's widest D (64, 128), where one TF32 pass is more
  than 1e-4·max off: the reason ``BWD_REL`` = 1e-4 still holds for the
  tensor-core kernel.

Inputs are made with numpy from seeds and handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops.t5_attention import _bwd_call, _fwd_call
from genrec_tpu_torch.ops import t5_attention as ta

RATE = 0.1
TILE = 8   # keys per kernel tile
LANES = 4  # lanes of a quad sharing one query row


def _case(seed, h, b, lq, lk, d, *, causal=False, dropout=False, fully_masked=False):
    r = np.random.default_rng(seed)
    qf = r.normal(size=(h * b, lq, d)).astype(np.float32)
    kf = r.normal(size=(h * b, lk, d)).astype(np.float32)
    vf = r.normal(size=(h * b, lk, d)).astype(np.float32)
    do = r.normal(size=(h * b, lq, d)).astype(np.float32)
    bias = r.normal(size=(h, lq, lk)).astype(np.float32)
    mask = (r.random((b, lk)) > 0.3).astype(np.int32)
    mask[:, -1] = 1
    if fully_masked:
        mask[0] = 0
    dmask = (np.where(r.random((h * b, lq, lk)) >= RATE, 1 / (1 - RATE), 0).astype(np.float32)
             if dropout else None)
    return dict(qf=qf, kf=kf, vf=vf, do=do, bias=bias, mask=mask, dmask=dmask, h=h,
                causal=causal)


def _jax(c, fn, *extra):
    rate = RATE if c["dmask"] is not None else 0.0
    dm = None if c["dmask"] is None else jnp.asarray(c["dmask"])
    args = [jnp.asarray(c[k]) for k in ("qf", "kf", "vf", "bias", "mask")]
    return fn(*args, dm, *[jnp.asarray(x) for x in extra], c["h"], c["causal"], rate, 1, True)


def _torch(c):
    t = {k: (None if v is None else torch.from_numpy(v)) for k, v in c.items()
         if k not in ("h", "causal")}
    return t


def _scores(c):
    """The kernel's scores s (the forward's additive terms, -inf past the
    last key of a tile row padded to a multiple of 16) and dp·dm."""
    t = _torch(c)
    hb, lq, _ = t["qf"].shape
    lk = t["kf"].shape[1]
    h, b = c["h"], hb // c["h"]
    s = torch.bmm(t["qf"], t["kf"].transpose(1, 2)).view(h, b, lq, lk) + t["bias"][:, None]
    if c["causal"]:
        row, col = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
        s = s + torch.where(col > row + (lk - lq), -1e9, 0.0)
    s = (s + ((1.0 - t["mask"].float()) * -1e9)[None, :, None, :]).reshape(hb, lq, lk)
    dp = torch.bmm(t["do"], t["vf"].transpose(1, 2))
    if t["dmask"] is not None:
        dp = dp * t["dmask"]
    lkp = -(-lk // 16) * 16
    s = torch.nn.functional.pad(s, (0, lkp - lk), value=-float("inf"))
    dp = torch.nn.functional.pad(dp, (0, lkp - lk))
    return s, dp


def _online_delta(s, dp):
    """delta as the kernel's phase A pass 1 takes it: lane t of a quad walks
    keys n0 + 2t and n0 + 2t + 1 of each 8-key tile with a running max,
    then the four lanes combine by xor 1 and xor 2."""
    hb, lq, lkp = s.shape
    sl = s.view(hb, lq, lkp // TILE, LANES, 2)
    dl = dp.view(hb, lq, lkp // TILE, LANES, 2)
    m = torch.full((hb, lq, LANES), -float("inf"))
    l, u = torch.zeros(hb, lq, LANES), torch.zeros(hb, lq, LANES)
    for n in range(lkp // TILE):
        x, y = sl[:, :, n], dl[:, :, n]
        mx = torch.maximum(m, x.amax(dim=-1))
        live = mx > -float("inf")
        mx_safe = torch.where(live, mx, 0.0)
        scale = torch.exp(m - mx_safe)
        e = torch.exp(x - mx_safe[..., None])
        l = torch.where(live, l * scale + e[..., 0] + e[..., 1], l)
        u = torch.where(live, u * scale + e[..., 0] * y[..., 0] + e[..., 1] * y[..., 1], u)
        m = torch.where(live, mx, m)
    for off in (1, 2):
        perm = torch.arange(LANES) ^ off
        mo, lo, uo = m[..., perm], l[..., perm], u[..., perm]
        mx = torch.maximum(m, mo)
        l = l * torch.exp(m - mx) + lo * torch.exp(mo - mx)
        u = u * torch.exp(m - mx) + uo * torch.exp(mo - mx)
        m = mx
    return u[..., 0] / torch.clamp(l[..., 0], min=1e-30)


CASES = {
    "plain": dict(seed=0, h=2, b=3, lq=12, lk=10, d=8),
    "dropout": dict(seed=1, h=2, b=3, lq=12, lk=10, d=8, dropout=True),
    "fully_masked_rows": dict(seed=2, h=2, b=3, lq=12, lk=10, d=8, fully_masked=True,
                              dropout=True),
    "causal_lq>lk": dict(seed=3, h=2, b=2, lq=12, lk=9, d=8, causal=True, dropout=True),
    "causal_lq<lk": dict(seed=4, h=2, b=2, lq=7, lk=20, d=16, causal=True),
    "b1_dropout": dict(seed=5, h=3, b=1, lq=9, lk=9, d=8, dropout=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_delta_from_the_output_equals_rowsum_dp_p(name):
    """rowsum(dO ∘ O), O from the Pallas forward, equals rowsum(dp·dm·p) of
    the port's plain backward and the kernel's one-pass online delta."""
    c = _case(**CASES[name])
    out = np.asarray(_jax(c, _fwd_call))
    from_out = (c["do"] * out).sum(-1)
    t = _torch(c)
    p = ta._probs(t["qf"], t["kf"], c["h"], t["bias"], t["mask"], c["causal"])
    s, dp = _scores(c)
    direct = (dp[..., :p.shape[-1]] * p).sum(-1).numpy()
    np.testing.assert_allclose(direct, from_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_online_delta(s, dp).numpy(), from_out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_dbias_reduced_in_batch_order_equals_pallas(name):
    """The backward kernel's dbias scratch is each flat row's ds, (H, B,
    Lq, Lk) with the head slowest; summed over B in order it is the Pallas
    kernel's dbias."""
    c = _case(**CASES[name])
    want = np.asarray(_jax(c, _bwd_call, c["do"])[3])
    t = _torch(c)
    ds, _ = ta._bwd_scores(t["qf"], t["kf"], t["vf"], c["h"], t["bias"], t["mask"], t["do"],
                           c["causal"], t["dmask"])
    hb, lq, lk = ds.shape
    part = ds.view(c["h"], hb // c["h"], lq, lk)
    got = ta.t5_attention_dbias_reduce(part).numpy()  # CPU tensor: the plain in-order sum
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_dbias_reduce_reference_sums_chunks_in_order():
    r = np.random.default_rng(7)
    part = torch.from_numpy(r.normal(size=(3, 5, 4, 6)).astype(np.float32))
    want = part[:, 0].clone()
    for c in range(1, 5):
        want = want + part[:, c]
    got = ta.dbias_reduce_reference(part)
    assert torch.equal(got, want)  # the same additions in the same order
    assert torch.equal(ta.t5_attention_dbias_reduce(part), got)
    torch.testing.assert_close(got, part.sum(dim=1), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        ta.t5_attention_dbias_reduce(part.double())
    with pytest.raises(ValueError, match="contiguous"):
        ta.t5_attention_dbias_reduce(part[:, 0])


def _tf32(x):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits dropped."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mma_3xtf32(a, b):
    """a·b as the kernel takes it: 8-deep steps of lo·hi, hi·lo, hi·hi into
    one f32 accumulator (each TF32 product is exact in f32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    c = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        sl = slice(k, k + 8)
        c = c + a_lo[:, sl] @ b_hi[sl]
        c = c + a_hi[:, sl] @ b_lo[sl]
        c = c + a_hi[:, sl] @ b_hi[sl]
    return c


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12), 3.0,
                      1.0 + 2.0 ** -10 + 2.0 ** -11], dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 3.0, 1.0 + 2.0 ** -9]
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    assert ((_tf32(y).view(torch.int32) & 0x1FFF) == 0).all()
    assert (_tf32(y) - y).abs().max() <= (y.abs() * 2.0 ** -11).max()


@pytest.mark.parametrize("depth", [16, 64, 80, 128, 156])
def test_3xtf32_product_keeps_f32_accuracy_where_one_pass_does_not(depth):
    """At the backward's depths (D = 16 for q·k and do·v at the train
    shapes, up to 128 elsewhere; L = 80 and 156 for ds·k, dsᵀ·q and
    (p·dm)ᵀ·do): 3xTF32 within 1e-6·max|product| of f64, one TF32 pass more
    than 1e-4·max off."""
    r = np.random.default_rng(depth)
    a = torch.from_numpy(r.normal(size=(160, depth)).astype(np.float32))
    b = torch.from_numpy(r.normal(size=(depth, 160)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    err3 = (_mma_3xtf32(a, b).double() - exact).abs().max().item()
    err1 = ((_tf32(a) @ _tf32(b)).double() - exact).abs().max().item()
    assert err3 <= 1e-6 * scale, err3 / scale
    assert err1 > 1e-4 * scale, err1 / scale


def test_kernel_path_refuses_what_the_kernel_does_not_take():
    """The kernel route checks D before it builds anything (so this runs
    without nvcc); the CPU route takes any D."""
    r = np.random.default_rng(5)
    qf, kf, vf, do = (torch.from_numpy(r.normal(size=(2, 4, 129)).astype(np.float32))
                      for _ in range(4))
    with pytest.raises(ValueError, match="D=129"):
        ta._launch_bwd(qf, kf, vf, 1, None, None, None, do, False, False)
    bias = torch.from_numpy(r.normal(size=(1, 4, 4)).astype(np.float32))
    got = ta.t5_attention_bwd(qf, kf, vf, 1, bias, None, do)
    want = ta.t5_attention_bwd_reference(qf, kf, vf, 1, bias, None, do)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ta.bwd_launches == 0 and ta.dbias_reduce_launches == 0

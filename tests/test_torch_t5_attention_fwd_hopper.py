"""The arithmetic that the Hopper design of the fused T5 attention forward
(genrec_tpu_torch/csrc/t5_attention_fwd.cu) rests on, checked on the CPU
against the JAX package's Pallas kernel in interpret mode.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against ``t5_attention_reference``. Here:

- the online softmax: the kernel walks the keys 8 at a time; lane t of a
  quad holds keys 2t and 2t + 1 of a query row, the quad shares the row's
  running max m, each lane keeps its part of l = Σ e^(s−m), P·V takes
  Σ e^(s−m)·dm·v with the dropout mask inside the sum, and the
  normalisation comes last: out = acc / max(l, 1e-30). That equals the
  Pallas forward (which normalises, then multiplies by the mask) to 1e-5
  at small encoder, decoder and cross shapes, with and without the mask;
- padding keys (Lk not a multiple of 8): at −inf they give Pallas's answer
  on fully masked rows (the mean of v over the tied real keys); at −1e9
  they would join the tie and do not;
- 3xTF32: the products split a = hi + lo in TF32 (10 mantissa bits, rounded
  to nearest as ``cvt.rna`` does), summed as lo·hi + hi·lo + hi·hi in f32,
  stay within 1e-6·max of an f64 product at the forward's depths (q·kᵀ at
  D = 16, 64, 128; P·V at Lk = 80, 156), where one TF32 pass is more than
  1e-4·max off.

Inputs are made with numpy from seeds and handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops.t5_attention import _fwd_call
from genrec_tpu_torch.ops import t5_attention as ta

RATE = 0.1
TILE = 8   # keys per kernel tile
LANES = 4  # lanes of a quad sharing one query row
F32_MAX = float(np.finfo(np.float32).max)


def _case(seed, h, b, lq, lk, d, *, bias=True, mask=True, causal=False, causal_in_bias=False,
          dropout=False, fully_masked=False):
    r = np.random.default_rng(seed)
    c = dict(qf=r.normal(size=(h * b, lq, d)).astype(np.float32),
             kf=r.normal(size=(h * b, lk, d)).astype(np.float32),
             vf=r.normal(size=(h * b, lk, d)).astype(np.float32),
             bias=None, mask=None, dmask=None, h=h, causal=causal)
    if bias:
        c["bias"] = r.normal(size=(h, lq, lk)).astype(np.float32)
        if causal_in_bias:  # as the decoder passes it, with causal=False
            c["bias"] += np.where(np.arange(lk)[None] > np.arange(lq)[:, None], -1e9, 0.0
                                  ).astype(np.float32)
    if mask:
        c["mask"] = (r.random((b, lk)) > 0.3).astype(np.int32)
        c["mask"][:, -1] = 1
        if fully_masked:
            c["mask"][0] = 0
    if dropout:
        keep = r.random((h * b, lq, lk)) >= RATE
        c["dmask"] = np.where(keep, 1 / (1 - RATE), 0).astype(np.float32)
    return c


def _pallas(c):
    rate = RATE if c["dmask"] is not None else 0.0
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return np.asarray(_fwd_call(j(c["qf"]), j(c["kf"]), j(c["vf"]), j(c["bias"]), j(c["mask"]),
                                j(c["dmask"]), c["h"], c["causal"], rate, 1, True))


def _kernel_forward(c, pad_score=-float("inf")):
    """The forward as the kernel takes it, in f32: the scores with their
    additive terms in the reference's order, keys padded to a multiple of 8
    at ``pad_score`` (zero values), then per 8-key tile a quad-shared running
    max m, per-lane l = l·e^(m_old−m) + e_2t + e_2t+1, acc = acc·e^(m_old−m)
    + Σ_tile e·dm·v; l summed over the quad; out = acc / max(l, 1e-30)."""
    t = {k: None if c[k] is None else torch.from_numpy(c[k])
         for k in ("qf", "kf", "vf", "bias", "mask", "dmask")}
    hb, lq, d = t["qf"].shape
    lk = t["kf"].shape[1]
    h = c["h"]
    s = torch.bmm(t["qf"], t["kf"].transpose(1, 2)).view(h, hb // h, lq, lk)
    if t["bias"] is not None:
        s = s + t["bias"][:, None]
    if c["causal"]:
        row, col = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
        s = s + torch.where(col > row + (lk - lq), -1e9, 0.0)
    if t["mask"] is not None:
        s = s + ((1.0 - t["mask"].float()) * -1e9)[None, :, None, :]
    s = s.reshape(hb, lq, lk)
    dm = t["dmask"] if t["dmask"] is not None else torch.ones(hb, lq, lk)
    lkp = -(-lk // TILE) * TILE
    s = torch.nn.functional.pad(s, (0, lkp - lk), value=pad_score)
    dm = torch.nn.functional.pad(dm, (0, lkp - lk), value=1.0)
    v = torch.nn.functional.pad(t["vf"], (0, 0, 0, lkp - lk)).view(hb, lkp // TILE, TILE, d)
    sl = s.view(hb, lq, lkp // TILE, LANES, 2)
    dl = dm.view(hb, lq, lkp // TILE, TILE)
    m = torch.full((hb, lq), -F32_MAX)
    l = torch.zeros(hb, lq, LANES)
    acc = torch.zeros(hb, lq, d)
    for n in range(lkp // TILE):
        x = sl[:, :, n]
        mx = torch.maximum(m, x.amax(dim=(-1, -2)))
        scale = torch.where(mx > m, torch.exp(m - mx), 1.0)
        e = torch.exp(x - mx[..., None, None])
        l = l * scale[..., None] + e[..., 0] + e[..., 1]
        p = e.reshape(hb, lq, TILE) * dl[:, :, n]  # lane t's keys 2t, 2t + 1 in key order
        acc = acc * scale[..., None] + torch.bmm(p, v[:, n])
        m = mx
    lsum = (l[..., 0] + l[..., 1]) + (l[..., 2] + l[..., 3])
    return (acc / torch.clamp(lsum, min=1e-30)[..., None]).numpy()


SHAPES = {  # small stand-ins for the train shapes: Lk 20 and 12 are not multiples of 8
    "enc": dict(h=2, b=3, lq=20, lk=20, d=16),
    "dec": dict(h=2, b=3, lq=20, lk=20, d=16, mask=False, causal_in_bias=True),
    "cross": dict(h=2, b=3, lq=20, lk=12, d=16, bias=False),
    "causal_lq!=lk": dict(h=2, b=2, lq=9, lk=13, d=8, causal=True),
}


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_online_softmax_on_quads_equals_pallas(shape, dropout):
    c = _case(seed=len(shape) + 10 * dropout, dropout=dropout, **SHAPES[shape])
    np.testing.assert_allclose(_kernel_forward(c), _pallas(c), rtol=0, atol=1e-5)


@pytest.mark.parametrize("lk", [10, 13, 156])
def test_padding_keys_must_score_minus_inf(lk):
    """A fully masked row (batch row 0) puts every real key near −1e9 and
    returns the (dropout-weighted) mean of v over them. Padding keys at −inf
    leave that as it is; at −1e9 they join the tie and pull zeros into the
    mean (Lk/Lk_padded of it), while rows with a real key to attend do not
    notice."""
    c = _case(seed=lk, h=2, b=2, lq=6, lk=lk, d=8, fully_masked=True, dropout=True)
    want = _pallas(c)
    np.testing.assert_allclose(_kernel_forward(c), want, rtol=0, atol=1e-5)
    wrong = _kernel_forward(c, pad_score=-1e9)
    masked = np.arange(want.shape[0]) % 2 == 0  # flat rows h·B + 0
    lkp = -(-lk // TILE) * TILE
    assert np.abs(wrong[masked] - want[masked]).max() > 1e-3
    np.testing.assert_allclose(wrong[masked], want[masked] * lk / lkp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(wrong[~masked], want[~masked], rtol=0, atol=1e-5)


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


def _operands(product, depth, seed):
    """(a, b) of one of the forward's products on 160 query rows: q·kᵀ at
    depth D against 80 keys; or P·V at depth Lk, P the kernel's unnormalised
    e^(s − m)·dm of D = 16 scores, V of width 16."""
    r = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(r.normal(size=shape).astype(np.float32))  # noqa: E731
    if product == "scores":
        return t(160, depth), t(depth, 80)
    s = t(160, 16) @ t(16, depth)
    keep = torch.from_numpy(r.random((160, depth)) >= RATE)
    e = torch.exp(s - s.amax(dim=1, keepdim=True)) * torch.where(keep, 1 / (1 - RATE), 0.0)
    return e, t(depth, 16)


@pytest.mark.parametrize("product,depth", [("scores", 16), ("scores", 64), ("scores", 128),
                                           ("pv", 80), ("pv", 156)])
def test_3xtf32_products_keep_f32_accuracy_where_one_pass_does_not(product, depth):
    a, b = _operands(product, depth, seed=depth)
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
    qf, kf, vf = (torch.from_numpy(r.normal(size=(2, 4, 129)).astype(np.float32))
                  for _ in range(3))
    with pytest.raises(ValueError, match="D=129"):
        ta._launch(qf, kf, vf, 1, None, None, None, False)
    bias = torch.from_numpy(r.normal(size=(1, 4, 4)).astype(np.float32))
    got = ta.t5_attention_fwd(qf, kf, vf, 1, bias)
    assert torch.equal(got, ta.t5_attention_reference(qf, kf, vf, 1, bias))
    assert ta.launches == 0

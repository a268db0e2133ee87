"""The arithmetic that the bf16 entry points of the fused T5 attention
kernels (``t5_attention_fwd_bf16``, ``t5_attention_bwd_bf16`` in
genrec_tpu_torch/csrc/) rest on, checked on the CPU against the JAX
package's Pallas kernels in interpret mode at ``jnp.bfloat16`` inputs and
against f64.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against ``t5_attention_reference`` and ``t5_attention_bwd_reference``. Here,
emulated in f32 with torch:

- exact products: a bf16·bf16 product is exact in f32, so ``mma.sync``
  m16n8k16 steps (16 features deep, each in a fresh accumulator, the steps
  added in f32) give the scores q·kᵀ of the Pallas forward, which casts q and
  k to f32, to within the order of the f32 sums;
- the forward as the kernel takes it: keys in steps of 16, lane t of a quad
  holding keys 2t, 2t + 1, 2t + 8 and 2t + 9 of a row (two accumulator tiles
  side by side, which are the next product's A operand), one rescale per
  step, each step's e^(s − m)·dm rounded to bf16 before P·V, out rounded to
  bf16 once: within one bf16 ulp at max|out| of the Pallas forward, with and
  without the dropout mask, causal and not, with a 3-token prefix;
- the split of an f32 operand into bf16 parts (each remainder exact in f32):
  hi + lo (two passes) lies within 2⁻¹⁵·max of f64 at the backward's depths
  16, 80 and 156, where one pass does not; hi + mid + lo (three passes, the
  kernel's) within 2⁻²¹·max, an f32 product's accuracy;
- the backward as the kernel takes it: per-lane online m, l and u over
  16-key steps combined over the quad, ds = p·(dp·dm − delta), dq = ds·K,
  dk = dsᵀ·Q and dv = (p·dm)ᵀ·dO with ds and p·dm split in three: dq, dk
  and dv within 2⁻⁸·max of JAX's bf16 vjp through the Pallas kernels.

Inputs are made with numpy from seeds and handed to both sides.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops.t5_attention import _fwd_call, _scores
from genrec_tpu.ops.t5_attention import fused_t5_attention_flat as jax_fused_flat
from genrec_tpu_torch.ops import t5_attention as ta

BF16 = torch.bfloat16
RATE = 0.1
STEP = 16   # keys (and features) per kernel step: one m16n8k16 product deep
LANES = 4   # lanes of a quad sharing one query row
F32_MAX = float(np.finfo(np.float32).max)


def _bf16(x):
    """x rounded to bf16 (to nearest even), kept as f32."""
    return x.to(BF16).float()


def _bf16_np(x):
    return _bf16(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| > 0: 2^(⌊log2 |x|⌋ − 7), bf16 having 8 significant bits."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _mm16(a, b):
    """a·b as the kernel takes it: 16-deep steps, each one bf16 product with
    f32 sums in a fresh accumulator, the steps added in f32 in order."""
    c = None
    for k0 in range(0, a.shape[-1], STEP):
        part = a[..., k0:k0 + STEP] @ b[..., k0:k0 + STEP, :]
        c = part if c is None else c + part
    return c


def _split(x, parts=3):
    """x = hi + mid + lo (or hi + lo), each rounded to bf16 from the exact
    remainder of the parts before it."""
    out = []
    for _ in range(parts):
        out.append(_bf16(x))
        x = x - out[-1]
    return out


def _mm16_split(a, b, parts=3):
    """a·b with a f32 operand split in ``parts`` bf16 parts and b bf16: per
    16-deep step the smallest part's product first, all into one fresh
    accumulator, the steps added in f32."""
    pieces = _split(a, parts)[::-1]
    c = None
    for k0 in range(0, a.shape[-1], STEP):
        sl = slice(k0, k0 + STEP)
        part = None
        for x in pieces:
            y = x[..., sl] @ b[..., sl, :]
            part = y if part is None else part + y
        c = part if c is None else c + part
    return c


def _case(seed, h, b, lq, lk, d, *, bias=True, mask=True, causal=False, causal_in_bias=False,
          prefix=0, dropout=False):
    """q, k, v and dO rounded to bf16 (kept as f32 numpy), the f32 bias, the
    key mask (left padding, ``prefix`` leading keys never masked) and the f32
    dropout mask."""
    r = np.random.default_rng(seed)
    n = lambda rows: _bf16_np(r.normal(size=(h * b, rows, d)))  # noqa: E731
    c = dict(qf=n(lq), kf=n(lk), vf=n(lk), do=n(lq), bias=None, mask=None, dmask=None, h=h,
             causal=causal)
    if bias:
        c["bias"] = r.normal(size=(h, lq, lk)).astype(np.float32)
        if causal_in_bias:  # as the decoder passes it, with causal=False
            c["bias"] += np.where(np.arange(lk)[None] > np.arange(lq)[:, None], -1e9, 0.0
                                  ).astype(np.float32)
    if mask:
        valid = r.integers(1, lk + 1, size=b)
        c["mask"] = (np.arange(lk)[None, :] >= lk - valid[:, None]).astype(np.int32)
        c["mask"][:, :prefix] = 1
    if dropout:
        keep = r.random((h * b, lq, lk)) >= RATE
        c["dmask"] = np.where(keep, np.float32(1) / np.float32(1 - RATE), 0).astype(np.float32)
    return c


def _j(x, dtype=None):
    return None if x is None else jnp.asarray(x, dtype)


def _pallas_forward(c):
    rate = RATE if c["dmask"] is not None else 0.0
    bf = jnp.bfloat16
    out = _fwd_call(_j(c["qf"], bf), _j(c["kf"], bf), _j(c["vf"], bf), _j(c["bias"]),
                    _j(c["mask"]), _j(c["dmask"]), c["h"], c["causal"], rate, 1, True)
    assert out.dtype == bf
    return np.asarray(out, np.float32)


def _tensors(c):
    return {k: None if c[k] is None else torch.from_numpy(c[k])
            for k in ("qf", "kf", "vf", "do", "bias", "mask", "dmask")}


def _kernel_scores(t, h, causal):
    """The scores with their additive terms in the reference's order, keys
    padded to a multiple of 16 at −inf (the kernel's key-mask row), features
    padded to 16 with zeros; q·kᵀ in 16-deep steps."""
    q, k = t["qf"], t["kf"]
    hb, lq, d = q.shape
    lk = k.shape[1]
    dp = -(-d // STEP) * STEP
    q, k = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k))
    s = _mm16(q, k.transpose(1, 2)).view(h, hb // h, lq, lk)
    if t["bias"] is not None:
        s = s + t["bias"][:, None]
    if causal:
        row, col = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
        s = s + torch.where(col > row + (lk - lq), -1e9, 0.0)
    if t["mask"] is not None:
        s = s + ((1.0 - t["mask"].float()) * -1e9)[None, :, None, :]
    lkp = -(-lk // STEP) * STEP
    return torch.nn.functional.pad(s.reshape(hb, lq, lk), (0, lkp - lk), value=-float("inf"))


def _lanes(x):
    """(…, 16) step values → (…, 4 lanes, 4): lane t holds keys 2t, 2t + 1,
    2t + 8, 2t + 9 (two accumulator tiles of 8 keys, 2 keys a lane each)."""
    return x.unflatten(-1, (2, LANES, 2)).transpose(-3, -2).flatten(-2)


def _lane_sum(e):
    """Each lane's sum of its four values, as the kernel adds them:
    (tile 0's pair) + (tile 1's pair)."""
    return (e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3])


def _kernel_forward(c):
    """The bf16 forward as the kernel computes it, in f32 (see the module
    docstring); out rounded to bf16."""
    t = _tensors(c)
    s = _kernel_scores(t, c["h"], c["causal"])
    hb, lq, lkp = s.shape
    lk, d = t["vf"].shape[1:]
    v = torch.nn.functional.pad(t["vf"], (0, 0, 0, lkp - lk))
    dm = t["dmask"] if t["dmask"] is not None else torch.ones(hb, lq, lk)
    dm = torch.nn.functional.pad(dm, (0, lkp - lk), value=1.0)
    m = torch.full((hb, lq), -F32_MAX)
    l = torch.zeros(hb, lq, LANES)
    acc = torch.zeros(hb, lq, d)
    for n0 in range(0, lkp, STEP):
        x = s[..., n0:n0 + STEP]
        mx = torch.maximum(m, x.amax(dim=-1))
        scale = torch.where(mx > m, torch.exp(m - mx), 1.0)
        e = torch.exp(x - mx[..., None])
        l = l * scale[..., None] + _lane_sum(_lanes(e))
        p = _bf16(e * dm[..., n0:n0 + STEP])  # rounded as the reference rounds p to v's dtype
        acc = acc * scale[..., None] + p @ v[:, n0:n0 + STEP]
        m = mx
    lsum = (l[..., 0] + l[..., 1]) + (l[..., 2] + l[..., 3])
    return _bf16(acc / torch.clamp(lsum, min=1e-30)[..., None]).numpy()


def test_a_step_s_two_accumulator_tiles_are_the_next_a_operand():
    """The m16n8k16 layouts: lane (g, t) holds C values (g, 2t..2t+1) and
    (g + 8, 2t..2t+1) of each 8-key tile; the A operand wants (g, 2t..2t+1),
    (g + 8, 2t..2t+1), (g, 2t+8..2t+9), (g + 8, 2t+8..2t+9) of the 16 keys.
    Tiles 0 and 1 side by side give exactly that, every key of every row
    once, so p and ds pass from one product to the next with one pack each
    and no shuffle; ``_lanes`` takes the same keys."""
    held_c, want_a = {}, {}
    for lane in range(32):
        g, t = divmod(lane, 4)
        held_c[lane] = [(row, 8 * tile + 2 * t + c) for tile in (0, 1) for row in (g, g + 8)
                        for c in (0, 1)]
        want_a[lane] = [(row, col + c) for col, row in ((2 * t, g), (2 * t, g + 8),
                                                        (2 * t + 8, g), (2 * t + 8, g + 8))
                        for c in (0, 1)]
        assert held_c[lane] == want_a[lane]
    every = sorted(x for v in want_a.values() for x in v)
    assert every == [(row, key) for row in range(16) for key in range(16)]
    keys = torch.arange(16.0)
    for t in range(LANES):
        assert _lanes(keys)[t].tolist() == [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]


@pytest.mark.parametrize("d", [16, 64, 128])
def test_bf16_products_are_exact_and_give_the_pallas_scores(d):
    """Each bf16·bf16 product is exact in f32; the 16-deep steps then differ
    from the Pallas forward's f32 q·kᵀ only by the order of the f32 sums:
    within d·2⁻²⁴·Σ|q||k| of it and of f64."""
    c = _case(d, 2, 3, 20, 13, d, bias=False, mask=False)
    q, k = torch.from_numpy(c["qf"]), torch.from_numpy(c["kf"])
    prod32 = q[:, :, None, :] * k[:, None, :, :]
    assert torch.equal(prod32.double(), q.double()[:, :, None, :] * k.double()[:, None, :, :])
    got = _mm16(q, k.transpose(1, 2)).double()
    pallas = np.array(_scores(_j(c["qf"], jnp.bfloat16).astype(jnp.float32),
                                _j(c["kf"], jnp.bfloat16).astype(jnp.float32), None, False))
    exact = q.double() @ k.double().transpose(1, 2)
    bound = d * 2.0 ** -24 * (q.double().abs() @ k.double().abs().transpose(1, 2))
    assert ((got - exact).abs() <= bound).all()
    assert ((got - torch.from_numpy(pallas).double()).abs() <= 2 * bound).all()


FWD_SHAPES = {  # small stand-ins for the train shapes; Lk 20, 13 and 11 are not multiples of 16
    "enc": dict(h=2, b=3, lq=20, lk=20, d=16),
    "dec": dict(h=2, b=3, lq=20, lk=20, d=16, mask=False, causal_in_bias=True),
    "cross": dict(h=2, b=3, lq=20, lk=13, d=16, bias=False),
    # no key mask here: a row whose visible keys are all padded sums its -1e9
    # terms twice, and the reference's bf16 mask column rounds -1e9 otherwise
    "causal_lq!=lk": dict(h=2, b=2, lq=9, lk=13, d=8, causal=True, mask=False),
    "prefix": dict(h=2, b=3, lq=11, lk=11, d=16, prefix=3),
}


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_forward_in_16_key_steps_is_within_one_ulp_of_pallas(shape, dropout):
    c = _case(len(shape) + 10 * dropout, dropout=dropout, **FWD_SHAPES[shape])
    want = _pallas_forward(c)
    got = _kernel_forward(c)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= bf16_ulp(np.abs(want).max()), (err, np.abs(want).max())


def _split_operands(kind, depth, seed):
    """(a, b) of one of the backward's products with an f32 side: ds·K (a =
    ds over ``depth`` keys) or (p·dm)ᵀ·dO (a = p·dm over ``depth`` queries),
    on 160 rows, b bf16 of width 16."""
    r = np.random.default_rng(seed)
    t = lambda *shape: _bf16(torch.from_numpy(r.normal(size=shape).astype(np.float32)))  # noqa
    s = t(160, 16) @ t(16, depth)
    p = torch.softmax(s, dim=1)
    keep = torch.from_numpy(r.random((160, depth)) >= RATE)
    dm = torch.where(keep, 1 / (1 - RATE), 0.0)
    if kind == "ds":
        dp = (t(160, 16) @ t(16, depth)) * dm
        a = p * (dp - (dp * p).sum(dim=1, keepdim=True))
    else:
        a = p * dm
    return a.float(), t(depth, 16)


@pytest.mark.parametrize("kind", ["ds", "pdm"])
@pytest.mark.parametrize("depth", [16, 80, 156])
def test_bf16_split_keeps_the_f32_side_where_one_pass_does_not(depth, kind):
    """hi + lo (two passes) holds the product within 2⁻¹⁵·max of f64, one
    pass does not; hi + mid + lo (the kernel's three passes) holds it within
    2⁻²¹·max, as an f32 product does, where two passes lie 30-50x farther.
    On the card two passes flipped the bf16 rounding of dq against the plain
    f32 version at the top binade (one ulp, above 2⁻⁸·max), three do not."""
    a, b = _split_operands(kind, depth, seed=depth)
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    hi, mid, lo = _split(a)
    assert torch.equal(a - hi - mid - lo, (a.double() - hi.double() - mid.double() -
                                           lo.double()).float())  # exact remainders
    err = {n: (_mm16_split(a, b, n).double() - exact).abs().max().item() / scale
           for n in (1, 2, 3)}
    f32 = ((a @ b).double() - exact).abs().max().item() / scale
    assert err[1] > 2.0 ** -15, err
    assert 2.0 ** -21 < err[2] <= 2.0 ** -15, err
    assert err[3] <= 2.0 ** -21 and err[3] <= 2 * f32 + 2.0 ** -24, (err, f32)


def _kernel_backward(c):
    """dq, dk and dv as the bf16 backward kernel computes them, in f32,
    rounded to bf16 at the end."""
    t = _tensors(c)
    h = c["h"]
    s = _kernel_scores(t, h, c["causal"])
    hb, lq, lkp = s.shape
    lk, d = t["vf"].shape[1:]
    dpad = -(-d // STEP) * STEP
    pad_f = lambda x: torch.nn.functional.pad(x, (0, dpad - d))  # noqa: E731
    k = torch.nn.functional.pad(pad_f(t["kf"]), (0, 0, 0, lkp - lk))
    v = torch.nn.functional.pad(pad_f(t["vf"]), (0, 0, 0, lkp - lk))
    q, do = pad_f(t["qf"]), pad_f(t["do"])
    dm = t["dmask"] if t["dmask"] is not None else torch.ones(hb, lq, lk)
    dm = torch.nn.functional.pad(dm, (0, lkp - lk), value=1.0)
    dp = _mm16(do, v.transpose(1, 2))
    # pass 1: each lane its own m, l, u over its 4 keys a step
    m = torch.full((hb, lq, LANES), -F32_MAX)
    l = torch.zeros(hb, lq, LANES)
    u = torch.zeros(hb, lq, LANES)
    for n0 in range(0, lkp, STEP):
        x = _lanes(s[..., n0:n0 + STEP])
        w = _lanes(dp[..., n0:n0 + STEP] * dm[..., n0:n0 + STEP])
        mx = torch.maximum(m, x.amax(dim=-1))
        scale = torch.where(mx > m, torch.exp(m - mx), 1.0)
        e = torch.exp(x - mx[..., None])
        l = l * scale + _lane_sum(e)
        u = u * scale + _lane_sum(e * w)
        m = mx
    for off in (1, 2):  # the quad's combine, lane t with lane t ^ off
        idx = torch.tensor([t ^ off for t in range(LANES)])
        mo, lo, uo = m[..., idx], l[..., idx], u[..., idx]
        mx = torch.maximum(m, mo)
        a, b = torch.exp(m - mx), torch.exp(mo - mx)
        l, u, m = l * a + lo * b, u * a + uo * b, mx
    den = torch.clamp(l[..., 0], min=1e-30)
    inv_l, delta, m = 1.0 / den, u[..., 0] / den, m[..., 0]
    p = torch.exp(s - m[..., None]) * inv_l[..., None]
    ds = p * (dp * dm - delta[..., None])
    dq = _mm16_split(ds, k)[..., :d]
    dk = _mm16_split(ds.transpose(1, 2), q)[:, :lk, :d]
    dv = _mm16_split((p * dm).transpose(1, 2), do)[:, :lk, :d]
    return [_bf16(x).numpy() for x in (dq, dk, dv)]


BWD_SHAPES = {
    "enc": dict(h=2, b=2, lq=20, lk=20, d=16),
    "dec": dict(h=2, b=2, lq=20, lk=20, d=16, mask=False, causal_in_bias=True),
    "cross": dict(h=2, b=2, lq=20, lk=13, d=16, bias=False),
    "prefix": dict(h=2, b=2, lq=11, lk=11, d=16, prefix=3),
}


@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_backward_with_the_split_is_within_2_8_of_jax_vjp(shape, dropout):
    c = _case(100 + len(shape) + 10 * dropout, dropout=dropout, **BWD_SHAPES[shape])
    rate = RATE if dropout else 0.0
    bf = jnp.bfloat16
    mask, dm = _j(c["mask"]), _j(c["dmask"])

    def f(q, k, v):
        return jax_fused_flat(q, k, v, c["h"], _j(c["bias"]), mask, causal=c["causal"],
                              dropout_rate=rate, dropout_mask=dm, batch_block=1,
                              interpret=True)
    _, vjp = jax.vjp(f, _j(c["qf"], bf), _j(c["kf"], bf), _j(c["vf"], bf))
    want = vjp(_j(c["do"], bf))
    for gname, g, w in zip(("dq", "dk", "dv"), _kernel_backward(c), want):
        assert w.dtype == bf, gname
        w = np.asarray(w, np.float32)
        assert np.isfinite(g).all(), gname
        err = np.abs(g - w).max()
        assert err <= 2.0 ** -8 * np.abs(w).max(), (gname, err, np.abs(w).max())


def test_bf16_kernel_path_refuses_what_the_kernel_does_not_take():
    """The bf16 route checks D before it builds anything (so this runs
    without nvcc), as the f32 route does; the CPU route takes any D."""
    r = np.random.default_rng(5)
    qf, kf, vf = (torch.from_numpy(r.normal(size=(2, 4, 129)).astype(np.float32)).to(BF16)
                  for _ in range(3))
    with pytest.raises(ValueError, match="D=129"):
        ta._launch(qf, kf, vf, 1, None, None, None, False)
    with pytest.raises(ValueError, match="D=129"):
        ta._launch_bwd(qf, kf, vf, 1, None, None, None, qf, False, False)
    got = ta.t5_attention_fwd(qf, kf, vf, 1)
    assert got.dtype == BF16 and torch.equal(got, ta.t5_attention_reference(qf, kf, vf, 1))
    assert ta.bf16_launches == ta.bf16_bwd_launches == 0

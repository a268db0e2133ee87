"""The arithmetic that the Hopper design of the flash attention forward
(genrec_tpu_torch/csrc/flash_attention_fwd.cu, TPU kernels #3 and #4) rests
on, checked on the CPU against the JAX package's Pallas forward in interpret
mode (``_flash_forward`` for the full-ref route #3, ``_flash_forward_blocked``
for the blocked route #4, as tests/test_torch_flash_attention.py calls them)
and against f64.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against ``flash_attention_fwd_reference``. Here its order of work is emulated
in f32:

- the schedule: blocks of 64 query rows of 16-row strips, K/V staged KT keys
  at a time (64 up to D = 32, 2048 / D above); below the causal diagonal
  block a staged tile is cut into rescale groups of 4 tiles of 8 keys (2 with
  a bias at D ≤ 16; all of a staged tile that holds fewer); in the diagonal
  block the 8-key tiles before the strip run one by one unmasked, the two
  that cross it masked, the rest are skipped. Every unmasked score is visited
  exactly once; the grid hands out the heaviest blocks first;
- s = q·kᵀ in 3xTF32 8-deep steps, each mma's sum rounded toward zero as the
  tensor cores round it (not to nearest), each step in a fresh accumulator
  added in f32; then q·k·scale + bias with a bias;
- the online softmax of a group: the new row max m over the group's keys and
  the old max (from −FLT_MAX), the integer exponent reference e = ⌈m·c⌉,
  c = u·log2(e) (u = scale, 1 with a bias), the rescale α = 2^(e_old − e), a
  power of two; per 8-key tile p = 2^(y·c − e) in one fused multiply-add
  (exp of that exponent times ln 2 on the masked diagonal tiles) with the
  tensor cores' mean shortfall given back by a second, l (lane t: keys 2t and
  2t + 1, the group's p summed in a tree, then l·α + that sum in f64) and
  acc = acc·α + p·V on the group's first tile, acc + p·V after it;
- deferred normalisation: l summed over the quad's four lanes once,
  clamped at 1e-30, out = acc / l and lse = e·ln 2 + log l − δ·m·u in f64,
  δ = c·ln 2 / u − 1.

Inputs are made with numpy from seeds and handed to both sides. Tolerances:
the emulation's out and lse within 2e-5 of the Pallas forward's, the
tolerance tests/test_torch_flash_attention.py holds the plain forward to
(f32, other summation orders), and within 2e-6·max of the f64 forward.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops import attention as A
from genrec_tpu_torch.ops import attention as ta
from test_torch_flash_attention_bwd_hopper import _fma, _kt, _nd, _pad, _tf32

H = 2
BLOCK = 64   # query rows of a block: 4 warps of 16-row strips
STRIP = 16
TILE = 8     # keys per mma step
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.69314718055994531)
FLT_MAX = float(np.finfo(np.float32).max)
KTRUNC = np.float32(0.7213475204444817 * 2.0 ** -24)  # the mean shortfall of a truncated sum


# ---------------------------------------------------------------------------
# the kernel's schedule, as its loops walk it
# ---------------------------------------------------------------------------

def block_order(lq, causal):
    """Query tiles in the order the grid hands them out (blockIdx.y): the
    last query tile first under causal."""
    n = lq // BLOCK
    return [n - 1 - y for y in range(n)] if causal else list(range(n))


def group_tiles(d, bias=False):
    """8-key tiles per rescale on an unmasked staged tile: 4, or all of a
    staged tile that holds fewer; 2 with a bias at D ≤ 16."""
    return 2 if bias and _nd(d) <= 2 else min(4, _kt(d) // TILE)


def fwd_groups(lq, lk, d, causal, bias=False):
    """[(row0, key0, tiles, masked)] of every rescale group a warp runs, in
    the order it runs them: staged tiles of KT keys up to the diagonal block;
    below it groups of ``group_tiles`` tiles; in it the tiles before the
    strip one group each unmasked, the two that cross it masked, the rest
    skipped."""
    kt, g, out = _kt(d), group_tiles(d, bias), []
    for qt in block_order(lq, causal):
        n_tiles = ((qt + 1) * BLOCK if causal else lk) // kt
        for w in range(BLOCK // STRIP):
            r0 = qt * BLOCK + w * STRIP
            for it in range(n_tiles):
                k0 = it * kt
                if not causal or k0 + kt <= qt * BLOCK:
                    out += [(r0, k0 + TILE * j, g, False) for j in range(0, kt // TILE, g)]
                    continue
                diag = r0 - k0
                lo, hi = min(max(diag, 0), kt) // TILE, min(max(diag + STRIP, 0), kt) // TILE
                out += [(r0, k0 + TILE * r8, 1, False) for r8 in range(lo)]
                out += [(r0, k0 + TILE * r8, 1, True) for r8 in range(lo, hi)]
    return out


SCHEDULES = [(128, 128, 16, True, False), (256, 256, 16, True, True), (256, 256, 64, True, False),
             (256, 256, 128, True, False), (256, 256, 24, True, True),
             (128, 256, 16, False, False), (256, 128, 128, False, False),
             (512, 512, 32, True, False)]


@pytest.mark.parametrize("lq,lk,d,causal,bias", SCHEDULES)
def test_tile_schedule_visits_every_unmasked_score_once(lq, lk, d, causal, bias):
    """Each score with key ≤ query (every score without causal) is visited
    exactly once, no 8-key tile wholly past the diagonal is visited, only the
    tiles that cross it are masked, and a strip meets its keys in order."""
    row, col = np.arange(lq)[:, None], np.arange(lk)[None, :]
    want = np.ones((lq, lk), int) if not causal else (col <= row).astype(int)
    seen = np.zeros((lq, lk), int)
    last_key = {}
    for r0, k0, tiles, masked in fwd_groups(lq, lk, d, causal, bias):
        assert k0 > last_key.get(r0, -1), (r0, k0)
        last_key[r0] = k0
        for j in range(tiles):
            cols = slice(k0 + TILE * j, k0 + TILE * (j + 1))
            tile = want[r0:r0 + STRIP, cols]
            assert tile.any(), (r0, k0, j)
            assert masked == (not tile.all()), (r0, k0, j, masked)
            seen[r0:r0 + STRIP, cols] += tile
    np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("l", [256, 2048])
def test_causal_grid_hands_out_the_heaviest_blocks_first(l):
    """Under causal the work of the block at grid index y never grows with y."""
    work = {}
    for r0, _, tiles, _ in fwd_groups(l, l, 16, True):
        work[r0 // BLOCK] = work.get(r0 // BLOCK, 0) + tiles
    per_y = [work[qt] for qt in block_order(l, True)]
    assert all(a >= b for a, b in zip(per_y, per_y[1:])), per_y
    assert per_y[0] > per_y[-1]


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------

def _f32(x):
    return torch.tensor(np.float32(x))


def _toward_zero(x):
    """f64 → f32 rounded toward zero, as the tensor cores round an mma's sum."""
    y = x.to(torch.float32)
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def tc_step(a, b):
    """One 8-deep step a·b in 3xTF32 on the tensor cores: lo·hi, then hi·lo,
    then hi·hi into one fresh accumulator, each mma's sum (exact products)
    rounded toward zero."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    c = _toward_zero(a_lo.double() @ b_hi.double())
    c = _toward_zero(c.double() + a_hi.double() @ b_lo.double())
    return _toward_zero(c.double() + a_hi.double() @ b_hi.double())


def tc_product(a, b):
    """a·b over a depth that is a multiple of 8: each 8-deep step a
    :func:`tc_step`, the steps added in order in f32."""
    out = tc_step(a[..., :8], b[..., :8, :])
    for k in range(8, a.shape[-1], 8):
        out = out + tc_step(a[..., k:k + 8], b[..., k:k + 8, :])
    return out


def fwd_emulated(q, k, v, bias, causal):
    """(out, lse) as the forward kernel computes them, group by group in its
    schedule's order (all strips with a group at a key at once: each strip
    still meets its keys in order)."""
    bh, lq, d = q.shape
    scale = _f32(1.0 / math.sqrt(d))
    u = _f32(1.0) if bias is not None else scale
    c = (u * _f32(LOG2E)).to(torch.float32)
    ck = (scale * _f32(LOG2E) * _f32(KTRUNC)).to(torch.float32)
    qp, kp, vp = (_pad(x, d) for x in (q, k, v))
    acc = torch.zeros(bh, lq, 8 * _nd(d))
    m = torch.full((bh, lq), -FLT_MAX)
    e = torch.full((bh, lq), -math.inf)
    lanes = torch.zeros(bh, lq, 4, dtype=torch.float64)  # each lane's part of l, in f64
    by_key = {}
    for r0, k0, tiles, masked in fwd_groups(lq, k.shape[1], d, causal, bias is not None):
        by_key.setdefault((k0, tiles, masked), []).append(r0)
    for (k0, tiles, masked), starts in sorted(by_key.items()):
        rows = torch.cat([torch.arange(r0, r0 + STRIP) for r0 in starts])
        keys = torch.arange(k0, k0 + TILE * tiles)
        raw = tc_product(qp[:, rows], kp[:, keys].transpose(1, 2))  # (bh, rows, keys)
        s = raw if bias is None else _fma(raw, scale, bias[:, rows][:, :, keys])
        if masked:
            s = torch.where(keys[None, :] > rows[:, None], -math.inf, s)
        m_new = torch.maximum(m[:, rows], s.amax(-1))
        e_new = torch.ceil((m_new * c).to(torch.float32))  # the exponents' integer reference
        alpha = torch.exp2(e[:, rows] - e_new)              # a power of two: exact
        m[:, rows], e[:, rows] = m_new, e_new
        e2 = e_new[..., None]
        a, pls = acc[:, rows], []
        for j in range(tiles):  # the rescale rides on the group's first tile
            cols = slice(TILE * j, TILE * (j + 1))  # the truncation's mean shortfall put back
            x = _fma(raw[..., cols], ck, _fma(s[..., cols], c, -e2))
            p = torch.exp((x * _f32(LN2)).to(torch.float32)) if masked else torch.exp2(x)
            pls.append(p.view(bh, len(rows), 4, 2).sum(-1))
            pv = tc_step(p, vp[:, keys[TILE * j:TILE * (j + 1)]])
            a = _fma(a, alpha[..., None], pv) if j == 0 else a + pv
        while len(pls) > 1:  # the group's p in a tree, then one fma into each lane's l
            pls = [x + y for x, y in zip(pls[::2], pls[1::2])]
        acc[:, rows] = a
        lanes[:, rows] = lanes[:, rows] * alpha[..., None].double() + pls[0].double()
    l = torch.clamp((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]), min=1e-30)
    delta = c.double() * math.log(2.0) / u.double() - 1.0
    lse = math.log(2.0) * e.double() + torch.log(l) - delta * (m.double() * u.double())
    return (acc / l.float()[..., None])[..., :d], lse.to(torch.float32)


def _case(b, lq, lk, d, seed, bias=False):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(b, H, n, d)).astype(np.float32) for n in (lq, lk, lk))
    bb = r.normal(size=(b, H, lq, lk)).astype(np.float32) if bias else None
    return q, k, v, bb


def _flat(a):
    return None if a is None else torch.from_numpy(a).reshape(-1, *a.shape[2:])


def _pallas(q, k, v, bias, causal, blocked):
    """The Pallas forward in interpret mode: (out, lse) flat, as numpy."""
    b, h, lq, d = q.shape
    bq, bk = A._auto_blocks(lq, k.shape[2], d)
    if blocked:
        flat = lambda a: jnp.asarray(a).reshape(b * h, *a.shape[2:])  # noqa: E731
        out, lse = A._flash_forward_blocked(flat(q), flat(k), flat(v), causal, bq, bk,
                                            1.0 / d ** 0.5, True)
    else:
        jb = None if bias is None else jnp.asarray(bias)
        out, lse = A._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, causal,
                                    bq, bk, True)
    return np.asarray(out).reshape(b * h, lq, d), np.asarray(lse).reshape(b * h, lq)


def _rel(x, ref):
    return ((x.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


CASES = [  # lq, lk, d, causal, bias, route
    (128, 128, 16, True, False, "full"), (256, 256, 16, True, False, "blocked"),
    (128, 256, 16, False, False, "full"), (256, 128, 24, False, False, "blocked"),
    (256, 256, 24, True, False, "full"), (128, 128, 64, True, False, "blocked"),
    (256, 128, 64, False, False, "full"), (128, 128, 128, True, False, "full"),
    (128, 256, 128, False, False, "blocked"),
    (128, 256, 16, False, True, "full"), (256, 256, 16, True, True, "full"),
    (256, 128, 24, False, True, "full"), (128, 128, 64, True, True, "full"),
    (128, 256, 128, False, True, "full"),
]


@pytest.mark.parametrize("lq,lk,d,causal,with_bias,route", CASES)
def test_strip_order_and_online_softmax_equal_pallas_forward(lq, lk, d, causal, with_bias,
                                                             route):
    """out and lse in the kernel's order of work (3xTF32 steps, the group
    rescale, the folded exp2, exp on the masked tiles, deferred
    normalisation) equal the Pallas forward's within 2e-5 and lie within
    2e-6·max of the f64 forward."""
    q, k, v, bias = _case(1, lq, lk, d, seed=lq + 3 * lk + d + with_bias, bias=with_bias)
    args = [_flat(x) for x in (q, k, v, bias)]
    out, lse = fwd_emulated(*args, causal)
    want_out, want_lse = _pallas(q, k, v, bias, causal, route == "blocked")
    exact_out, exact_lse = ta.flash_attention_fwd_reference(
        *[None if x is None else x.double() for x in args[:3]],
        None if bias is None else args[3].double(), causal=causal)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), want_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=2e-5)
    assert _rel(out, exact_out) <= 2e-6, _rel(out, exact_out)
    assert _rel(lse, exact_lse) <= 2e-6, _rel(lse, exact_lse)


@pytest.mark.parametrize("d", [16, 64])
def test_first_causal_rows_with_one_to_four_keys(d):
    """The first rows of a causal sequence, with 1-4 keys, all in a masked
    diagonal tile (exp, not exp2): row 0's output is v[0] and its lse its
    single score; rows 0-3 lie within 2e-6·max of f64. (Nothing averages out
    there: each output is a sum of 1-4 tensor-core products, whose truncated
    sums put it up to 2x farther from f64 than the plain f32 version.)"""
    q, k, v, _ = _case(2, 128, 128, d, seed=40 + d)
    args = [_flat(x) for x in (q, k, v)]
    out, lse = fwd_emulated(*args, None, True)
    exact_out, exact_lse = ta.flash_attention_fwd_reference(*[x.double() for x in args],
                                                            causal=True)
    first = slice(0, 4)
    np.testing.assert_allclose(out[:, 0].numpy(), args[2][:, 0].numpy(), rtol=0, atol=1e-6)
    s00 = (args[0][:, 0].double() * args[1][:, 0].double()).sum(-1) / math.sqrt(d)
    np.testing.assert_allclose(lse[:, 0].numpy(), s00.numpy(), rtol=0, atol=2e-6)
    scale = exact_out[:, first].abs().max().item()
    err = (out[:, first].double() - exact_out[:, first]).abs().max().item()
    assert err <= 2e-6 * scale, err / scale
    assert (lse[:, first].double() - exact_lse[:, first]).abs().max().item() <= 2e-6


@pytest.mark.parametrize("d", [16, 128])
def test_group_rescale_equals_a_rescale_per_tile(d):
    """The schedule's choice of rescale granularity does not change the
    function: with every staged tile cut into one-tile groups (a rescale per
    8 keys, as kernel #1 does), out and lse stay within 1e-6·max of the
    kernel's groups."""
    q, k, v, _ = _case(1, 256, 256, d, seed=60 + d)
    args = [_flat(x) for x in (q, k, v)]
    got = fwd_emulated(*args, None, False)
    global fwd_groups
    grouped = fwd_groups
    try:
        fwd_groups = lambda *a: [(r0, k0 + TILE * j, 1, m)  # noqa: E731
                                 for r0, k0, n, m in grouped(*a) for j in range(n)]
        per_tile = fwd_emulated(*args, None, False)
    finally:
        fwd_groups = grouped
    for x, y in zip(got, per_tile):
        assert _rel(x, y) <= 1e-6, _rel(x, y)

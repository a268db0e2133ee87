"""The arithmetic that the Hopper design of the flash attention backward
(genrec_tpu_torch/csrc/flash_attention_bwd.cu, TPU kernels #5 and #6) rests
on, checked on the CPU against the JAX package's Pallas backward in interpret
mode (through ``jax.grad`` of ``flash_attention``, as
tests/test_torch_flash_attention.py runs it) and against f64.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against ``flash_attention_bwd_dq_reference`` and
``flash_attention_bwd_dkv_reference``. Here the kernels' own order of work is
emulated in f32:

- the schedule: blocks of 64 rows of 16-row strips, tiles of the other side
  staged KT rows at a time (64 up to D = 32, 2048 / D above) and walked 8 at a
  time; under causal no tile past the diagonal block is staged, the 8-row tiles
  of the diagonal block wholly past a strip are skipped and the two that cross
  it masked. Every unmasked score is visited exactly once, by both kernels;
- dq: s = q·kᵀ and dp = do·vᵀ per 8-key tile, p = 2^(s·(scale·log2e) −
  lse·log2e) in one fused multiply-add (exp of the same exponent times ln 2
  on the tiles that cross the causal diagonal), ds = p·(dp − delta),
  dq += ds·k;
- dk/dv transposed: sᵀ = k·qᵀ and dpᵀ = v·doᵀ per 8-query tile of a 16-key
  strip, lse and delta read per query column, dv += pᵀ·do, dk += dsᵀ·q;
- every product in 3xTF32 (each operand split into TF32 hi and lo, rounded
  to nearest as ``cvt.rna`` does; lo·hi + hi·lo + hi·hi), each 8-deep step in
  a fresh f32 accumulator added to the running sum in f32.

Inputs are made with numpy from seeds and handed to both sides. Tolerances:
the emulation within 1e-5·max|Pallas| of the Pallas gradients (f32, other
summation orders; the Pallas backward itself lies up to 2.6e-6·max from f64
at D = 128) and within 2e-6·max of the f64 backward (measured: at most
7.6e-7, where the plain f32 version lies up to 2.0e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genrec_tpu.ops import attention as A
from genrec_tpu_torch.ops import attention as ta

H = 2
BLOCK = 64   # rows of a block's own side: 4 warps of 16-row strips
STRIP = 16
TILE = 8     # rows of the other side per mma step
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.69314718055994531)


def _nd(d):
    return 2 if d <= 16 else 4 if d <= 32 else 8 if d <= 64 else 16


def _kt(d):
    """Rows of a staged tile: 64 up to D = 32, 2048 / D above."""
    nd = _nd(d)
    return 64 if nd <= 4 else 256 // nd


# ---------------------------------------------------------------------------
# the kernels' schedules, as their loops walk them
# ---------------------------------------------------------------------------

def dq_visits(lq, lk, d, causal):
    """[(row0, key0, masked)] of every (16-row strip, 8-key tile) the dq
    kernel computes, in the order a warp walks its tiles, from its loops:
    staged tiles of KT keys up to the diagonal block; below it every 8-key
    tile unmasked; in it the tiles before the strip unmasked, the two that
    cross it masked, the rest skipped."""
    kt, out = _kt(d), []
    for qt in range(lq // BLOCK):
        n_tiles = ((qt + 1) * BLOCK if causal else lk) // kt
        for w in range(BLOCK // STRIP):
            r0 = qt * BLOCK + w * STRIP
            for it in range(n_tiles):
                k0 = it * kt
                if not causal or k0 + kt <= qt * BLOCK:
                    out += [(r0, k0 + TILE * r8, False) for r8 in range(kt // TILE)]
                    continue
                diag = r0 - k0
                lo, hi = min(max(diag, 0), kt) // TILE, min(max(diag + STRIP, 0), kt) // TILE
                out += [(r0, k0 + TILE * r8, False) for r8 in range(lo)]
                out += [(r0, k0 + TILE * r8, True) for r8 in range(lo, hi)]
    return out


def dkv_visits(lq, lk, d, causal):
    """[(key0, query0, masked)] of every (16-key strip, 8-query tile) the
    dk/dv kernel computes: staged tiles of KT queries from the diagonal block
    on; in it the tiles before the strip skipped, the two that cross it
    masked, the rest unmasked; past it every tile unmasked."""
    kt, out = _kt(d), []
    for kb in range(lk // BLOCK):
        q_first = kb * BLOCK if causal else 0
        for w in range(BLOCK // STRIP):
            j0 = kb * BLOCK + w * STRIP
            for it in range((lq - q_first) // kt):
                q0 = q_first + it * kt
                if not causal or q0 >= (kb + 1) * BLOCK:
                    out += [(j0, q0 + TILE * r8, False) for r8 in range(kt // TILE)]
                    continue
                diag = j0 - q0
                lo, hi = min(max(diag, 0), kt) // TILE, min(max(diag + STRIP, 0), kt) // TILE
                out += [(j0, q0 + TILE * r8, True) for r8 in range(lo, hi)]
                out += [(j0, q0 + TILE * r8, False) for r8 in range(hi, kt // TILE)]
    return out


SCHEDULES = [(128, 128, 16, True), (256, 256, 16, True), (256, 256, 64, True),
             (256, 256, 128, True), (256, 256, 24, True), (128, 256, 16, False),
             (256, 128, 128, False), (512, 512, 32, True)]


@pytest.mark.parametrize("lq,lk,d,causal", SCHEDULES)
def test_tile_schedules_visit_every_unmasked_score_once(lq, lk, d, causal):
    """Both kernels visit each score with key ≤ query (every score without
    causal) exactly once, never a tile wholly past the diagonal, and mask
    only the tiles that cross it."""
    row, col = np.arange(lq)[:, None], np.arange(lk)[None, :]
    want = np.ones((lq, lk), int) if not causal else (col <= row).astype(int)
    for visits, by_row in ((dq_visits(lq, lk, d, causal), True),
                           (dkv_visits(lq, lk, d, causal), False)):
        seen = np.zeros((lq, lk), int)
        for own0, other0, masked in visits:
            rows = slice(own0, own0 + STRIP) if by_row else slice(other0, other0 + TILE)
            cols = slice(other0, other0 + TILE) if by_row else slice(own0, own0 + STRIP)
            tile = want[rows, cols]
            assert tile.any(), (own0, other0)          # no tile wholly past the diagonal
            assert masked == (not tile.all()), (own0, other0, masked)
            seen[rows, cols] += tile
        np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("l", [256, 2048])
def test_causal_grids_hand_out_the_heaviest_blocks_first(l):
    """The grid is (B·H, tiles) with blockIdx.y slowest: dq maps y to query
    tile L/64 − 1 − y and dk/dv to key tile y, so the work per y never
    grows along the grid."""
    n = l // BLOCK
    dq_blocks = [v[0] // BLOCK for v in dq_visits(l, l, 16, True)]
    dkv_blocks = [v[0] // BLOCK for v in dkv_visits(l, l, 16, True)]
    dq_work = [dq_blocks.count(n - 1 - y) for y in range(n)]
    dkv_work = [dkv_blocks.count(y) for y in range(n)]
    for work in (dq_work, dkv_work):
        assert all(a >= b for a, b in zip(work, work[1:])), work
        assert work[0] > work[-1]


# ---------------------------------------------------------------------------
# the kernels' arithmetic
# ---------------------------------------------------------------------------

def _tf32(x):
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` and the kernels' ``to_tf32`` do."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _step(a, b):
    """One 8-deep step a·b (a (..., M, 8), b (..., 8, N)) in 3xTF32 into a
    fresh accumulator: lo·hi, then hi·lo, then hi·hi (each TF32 product exact
    in f32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    c = a_lo @ b_hi
    c = c + a_hi @ b_lo
    return c + a_hi @ b_hi


def mma_product(a, b):
    """a·b over a depth that is a multiple of 8, as the kernels take it: each
    8-deep step in a fresh 3xTF32 accumulator, the steps added in order in f32."""
    out = _step(a[..., :8], b[..., :8, :])
    for k in range(8, a.shape[-1], 8):
        out = out + _step(a[..., k:k + 8], b[..., k:k + 8, :])
    return out


def _fma(x, y, z):
    """fmaf in f32: the exact product plus z, rounded once (an f32 product is
    exact in f64; the sum's f64 rounding lies far below f32's)."""
    return (x.double() * y.double() + z.double()).to(torch.float32)


def folded_exp(s, scale, lse, accurate=False):
    """p = exp(s·scale − lse) as the kernels' ``exp_score`` takes it:
    2^(s·c − l) with c = scale·log2(e) and l = lse·log2(e) rounded to f32,
    in one fused multiply-add (the kernels then take ex2.approx), or, where
    ``accurate`` (the tiles that cross the causal diagonal), exp of that
    exponent times ln 2 rounded to f32."""
    c = torch.tensor(np.float32(np.float32(scale) * LOG2E))
    x = _fma(s, c, -(lse * LOG2E).to(torch.float32))
    return torch.where(torch.as_tensor(accurate), torch.exp((x * LN2).to(torch.float32)),
                       torch.exp2(x))


def natural_exp(s, scale, lse):
    """The natural-units alternative: exp(fma(s, scale, −lse))."""
    return torch.exp(_fma(s, torch.tensor(np.float32(scale)), -lse))


def _pad(x, d):
    """Features padded with zeros to the kernels' width 8·ND."""
    return torch.nn.functional.pad(x, (0, 8 * _nd(d) - d))


def dq_emulated(q, k, v, do, lse, delta, causal):
    """dq as the dq kernel computes it, strip by strip and 8-key tile by tile
    in its schedule's order (all strips of a row set at once)."""
    bh, lq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = (_pad(x, d) for x in (q, k, v, do))
    acc = torch.zeros(bh, lq, 8 * _nd(d))
    by_tile = {}
    for r0, k0, masked in dq_visits(lq, k.shape[1], d, causal):
        by_tile.setdefault(k0, []).append((r0, masked))
    for k0 in sorted(by_tile):  # each strip meets its key tiles in increasing order
        keys = slice(k0, k0 + TILE)
        kt, vt = kp[:, keys], vp[:, keys]
        rows = torch.cat([torch.arange(r0, r0 + STRIP) for r0, _ in by_tile[k0]])
        masked = torch.tensor([m for _, m in by_tile[k0] for _ in range(STRIP)])
        s = mma_product(qp[:, rows], kt.transpose(1, 2))
        dp = mma_product(dop[:, rows], vt.transpose(1, 2))
        p = folded_exp(s, scale, lse[:, rows, None], masked[:, None])
        if causal:
            p = torch.where(torch.arange(k0, k0 + TILE)[None, :] > rows[:, None], 0.0, p)
        ds = p * (dp - delta[:, rows, None])
        acc[:, rows] = acc[:, rows] + _step(ds, kt)
    return (acc * scale)[..., :d]


def dkv_emulated(q, k, v, do, lse, delta, causal):
    """(dk, dv) as the dk/dv kernel computes them, transposed: a 16-key strip
    against 8-query tiles, lse and delta per query column."""
    bh, lq, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qp, kp, vp, dop = (_pad(x, d) for x in (q, k, v, do))
    dk, dv = torch.zeros(bh, lk, 8 * _nd(d)), torch.zeros(bh, lk, 8 * _nd(d))
    by_tile = {}
    for j0, q0, masked in dkv_visits(lq, lk, d, causal):
        by_tile.setdefault(q0, []).append((j0, masked))
    for q0 in sorted(by_tile):
        queries = slice(q0, q0 + TILE)
        qt, dot = qp[:, queries], dop[:, queries]
        keys = torch.cat([torch.arange(j0, j0 + STRIP) for j0, _ in by_tile[q0]])
        masked = torch.tensor([m for _, m in by_tile[q0] for _ in range(STRIP)])
        st = mma_product(kp[:, keys], qt.transpose(1, 2))   # (bh, keys, 8 queries)
        dpt = mma_product(vp[:, keys], dot.transpose(1, 2))
        p = folded_exp(st, scale, lse[:, None, queries], masked[:, None])
        if causal:
            p = torch.where(keys[:, None] > torch.arange(q0, q0 + TILE)[None, :], 0.0, p)
        ds = p * (dpt - delta[:, None, queries])
        dv[:, keys] = dv[:, keys] + _step(p, dot)
        dk[:, keys] = dk[:, keys] + _step(ds, qt)
    return (dk * scale)[..., :d], dv[..., :d]


def _case(b, lq, lk, d, causal, seed):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(b, H, n, d)).astype(np.float32) for n in (lq, lk, lk))
    w = r.normal(size=(b, H, lq, d)).astype(np.float32)  # the output cotangent
    flat = lambda a: torch.from_numpy(a).reshape(b * H, *a.shape[2:])  # noqa: E731
    qf, kf, vf, do = flat(q), flat(k), flat(v), flat(w)
    out, lse = ta.flash_attention_fwd_reference(qf, kf, vf, causal=causal)
    return dict(np=(q, k, v, w), args=(qf, kf, vf, do, lse, ta._delta(do, out)), b=b)


def _pallas_grads(c, causal):
    q, k, v, w = c["np"]

    def loss(q, k, v):
        return jnp.sum(A.flash_attention(q, k, v, causal=causal, interpret=True) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return [torch.from_numpy(np.array(g)).reshape(-1, *g.shape[2:]) for g in grads]


def _f64(c, causal):
    args = [x.double() for x in c["args"]]
    return (ta.flash_attention_bwd_dq_reference(*args, causal=causal),
            *ta.flash_attention_bwd_dkv_reference(*args, causal=causal))


def _rel(x, ref):
    return ((x.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


STRIPS = [  # lq, lk, d, causal
    (128, 128, 16, True), (256, 256, 16, True), (128, 256, 16, False), (256, 128, 24, False),
    (256, 256, 24, True), (128, 128, 64, True), (256, 128, 64, False), (128, 128, 128, True),
    (128, 256, 128, False),
]


@pytest.mark.parametrize("lq,lk,d,causal", STRIPS)
def test_strip_and_tile_order_equals_pallas_backward(lq, lk, d, causal):
    """dq, dk and dv in the kernels' order of work (3xTF32 8-deep steps, the
    folded exp, causal tiles skipped or masked) equal the Pallas backward's
    gradients and lie within 2e-6·max of the f64 backward."""
    c = _case(1, lq, lk, d, causal, seed=lq + 3 * lk + d)
    got = (dq_emulated(*c["args"], causal), *dkv_emulated(*c["args"], causal))
    want = _pallas_grads(c, causal)
    exact = _f64(c, causal)
    plain = (ta.flash_attention_bwd_dq_reference(*c["args"], causal=causal),
             *ta.flash_attention_bwd_dkv_reference(*c["args"], causal=causal))
    for name, g, w, e, p in zip(("dq", "dk", "dv"), got, want, exact, plain):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))
        assert _rel(g, e) <= 2e-6, (name, _rel(g, e), _rel(p, e))


@pytest.mark.parametrize("lq,lk,d,causal", [(256, 256, 16, True), (128, 256, 64, False),
                                           (128, 128, 128, True)])
def test_transposed_dkv_equals_the_plain_reference(lq, lk, d, causal):
    """The dk/dv kernel's transposed formulation (sᵀ = k·qᵀ, dpᵀ = v·doᵀ, lse
    and delta by query column, dv += pᵀ·do, dk += dsᵀ·q) equals
    ``flash_attention_bwd_dkv_reference``, the dk/dv kernel's plain version."""
    c = _case(2, lq, lk, d, causal, seed=7 * d + lq)
    dk, dv = dkv_emulated(*c["args"], causal)
    want_dk, want_dv = ta.flash_attention_bwd_dkv_reference(*c["args"], causal=causal)
    assert _rel(dk, want_dk) <= 1e-5 and _rel(dv, want_dv) <= 1e-5, (
        _rel(dk, want_dk), _rel(dv, want_dv))


@pytest.mark.parametrize("d", [16, 24, 64, 128])
def test_exp2_with_the_folded_scale_keeps_f32_accuracy(d):
    """p = 2^(s·(scale·log2e) − lse·log2e) in one fused multiply-add: every p
    within 1e-6 of exp(s·scale − lse) in f64, relative, where p is above
    1e-3 (half an ulp of a base-2 exponent up to 16 in size, and exp2's own),
    and a row's Σ p within 6e-7 of its f64 value; so is exp of the same
    exponent times ln 2, the diagonal tiles' form. The natural-units form
    exp(fma(s, scale, −lse)) lies closer on both: the base-2 exponent is
    1.44x larger, and the roundings of scale·log2e and lse·log2e shift every
    p of a row one way. That is the price of one ex2.approx per score."""
    c = _case(1, 256, 256, d, False, seed=d)
    qf, kf, _, _, lse, _ = c["args"]
    s = torch.bmm(qf, kf.transpose(1, 2))
    scale = 1.0 / math.sqrt(d)
    exact = torch.exp(s.double() * scale - lse.double()[..., None])
    big = exact > 1e-3
    element = lambda p: ((p.double() - exact).abs()[big] / exact[big]).max().item()  # noqa: E731
    row_sum = lambda p: (p.double().sum(-1) - exact.sum(-1)).abs().max().item()  # noqa: E731
    got = folded_exp(s, scale, lse[..., None])
    diagonal = folded_exp(s, scale, lse[..., None], accurate=True)
    natural = natural_exp(s, scale, lse[..., None])
    for p in (got, diagonal):
        assert element(p) <= 1e-6 and row_sum(p) <= 6e-7, (element(p), row_sum(p))
    assert element(natural) < element(got) and row_sum(natural) < row_sum(got)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12), 3.0],
                     dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 3.0]
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    assert ((_tf32(y).view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("what,depth", [("q·k", 16), ("q·k", 32), ("q·k", 64), ("q·k", 128),
                                        ("ds·k", 8), ("ds·k over 256 keys", 256)])
def test_3xtf32_steps_keep_f32_accuracy_where_one_pass_does_not(what, depth):
    """At the backward's depths (D for q·kᵀ and do·vᵀ; 8 keys or queries per
    tile for ds·k, dsᵀ·q and pᵀ·do, summed over a row's tiles): 8-deep 3xTF32
    steps in fresh accumulators within 1e-6·max|product| of f64, one TF32
    pass more than 1e-4·max off."""
    r = np.random.default_rng(depth)
    a = torch.from_numpy(r.normal(size=(16, depth)).astype(np.float32))
    b = torch.from_numpy(r.normal(size=(depth, 16)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    err3 = (mma_product(a, b).double() - exact).abs().max().item()
    err1 = ((_tf32(a) @ _tf32(b)).double() - exact).abs().max().item()
    assert err3 <= 1e-6 * scale, err3 / scale
    assert err1 > 1e-4 * scale, err1 / scale

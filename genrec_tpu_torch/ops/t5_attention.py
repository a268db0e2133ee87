"""Fused short-sequence T5 attention, forward and backward: CUDA kernels
and plain versions.

Counterpart of ``genrec_tpu/ops/t5_attention.py`` (``fused_t5_attention_flat``
/ ``fused_t5_attention`` and their custom VJP), with the same layouts: the
flat entry takes q/k/v as (H·B, L, D) with the head dimension slowest,
``pos_bias`` (H, Lq, Lk) is a learned additive bias, ``kv_mask`` (B, Lk) is 1
where a key may be attended, ``dropout_mask`` (H·B, Lq, Lk) is a
multiplicative mask applied to the softmax probabilities. Unscaled dot
product (T5 convention); every mask is an ADDITIVE −1e9 term in f32.

The entry points are a ``torch.autograd.Function``: gradients flow to q, k,
v and ``pos_bias`` (never to the masks). Dispatch, decided by where the
tensors lie and nothing else:
- CUDA tensors go to the hand-written kernels ``csrc/t5_attention_fwd.cu``
  and ``csrc/t5_attention_bwd.cu`` (built at first use, ``ops/_build.py``)
  or raise; nothing falls back. The backward writes each block's ds to a
  scratch buffer and its second kernel, ``t5_attention_dbias_reduce``, sums
  that over the batch in order: no atomics, so its gradients are
  bit-identical between two calls on the same inputs;
- CPU tensors go to the plain versions :func:`t5_attention_reference` and
  :func:`t5_attention_bwd_reference`.

q, k, v (and the output gradient) share one dtype, f32 or bf16, as the
reference's kernels take them: ``out``, dq, dk and dv come back in that dtype,
dbias in f32. ``pos_bias`` is cast to f32 as the reference casts it; the
dropout mask is f32 at either dtype. A bf16 CUDA tensor goes to the kernels'
bf16 entry points (q, k, v and the output gradient staged as bf16, the
products on bf16 tensor cores with f32 sums, the probabilities rounded to
bf16 before P·V as the reference rounds them to v's dtype) or raises. The kernels take D ≤ 128. ``launches``, ``bwd_launches``
(f32), ``bf16_launches``, ``bf16_bwd_launches`` (bf16) and
``dbias_reduce_launches`` (either) count kernel launches, so a run can show
that its main path went through the kernels.

With ``dropout_generator`` in place of a mask, :func:`fused_t5_attention_flat`
draws the mask itself and keeps only the generator's state for the backward,
which draws the same mask again (the port's counterpart of the reference's
``attn_remat_dropout``: the (H·B, Lq, Lk) mask is not kept between the
forward and the backward).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from genrec_tpu_torch.ops import _build

_NEG_INF = -1e9
_MAX_SMEM = 232448  # bytes of shared memory one block may use on H100
_MAX_D = 128        # both kernels' feature steps: D padded to 8, 16, 32, 64 or 128
_KERNEL = "t5_attention_fwd"
_BWD_KERNEL = "t5_attention_bwd"

launches = 0      # f32 forward kernel launches since import (or since a caller reset it)
bwd_launches = 0  # f32 backward kernel launches, likewise
bf16_launches = 0      # bf16 forward kernel launches, likewise
bf16_bwd_launches = 0  # bf16 backward kernel launches, likewise
dbias_reduce_launches = 0  # the backward's dbias reduction kernel (either dtype), likewise

_lib = None
_bwd_lib = None


def load_kernel():
    """Build (at first use) and bind the forward kernel's library."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.t5_attention_fwd, lib.t5_attention_fwd_bf16):
            fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        for fn in (lib.t5_attention_fwd_smem_bytes, lib.t5_attention_fwd_bf16_smem_bytes):
            fn.argtypes = [i, i]
            fn.restype = ctypes.c_size_t
        for fn in (lib.t5_attention_fwd_blocks_per_sm, lib.t5_attention_fwd_bf16_blocks_per_sm):
            fn.argtypes = [i, i, i]
            fn.restype = ctypes.c_int
        lib.t5_attention_fwd_bf16_registers.argtypes = [i, p, p]
        lib.t5_attention_fwd_bf16_registers.restype = ctypes.c_int
        lib.t5_attention_fwd_error_string.argtypes = [i]
        lib.t5_attention_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def load_bwd_kernel():
    """Build (at first use) and bind the backward kernel's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(_BWD_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.t5_attention_bwd, lib.t5_attention_bwd_bf16):
            fn.argtypes = [p] * 11 + [i] * 6 + [p]
            fn.restype = ctypes.c_int
        lib.t5_attention_dbias_reduce.argtypes = [p, p, i, i, i, p]
        lib.t5_attention_dbias_reduce.restype = ctypes.c_int
        for fn in (lib.t5_attention_bwd_smem_bytes, lib.t5_attention_bwd_bf16_smem_bytes):
            fn.argtypes = [i, i, i]
            fn.restype = ctypes.c_size_t
        for fn in (lib.t5_attention_bwd_blocks_per_sm, lib.t5_attention_bwd_bf16_blocks_per_sm):
            fn.argtypes = [i, i, i]
            fn.restype = ctypes.c_int
        lib.t5_attention_bwd_bf16_registers.argtypes = [i, p, p]
        lib.t5_attention_bwd_bf16_registers.restype = ctypes.c_int
        lib.t5_attention_bwd_error_string.argtypes = [i]
        lib.t5_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _bf16(dtype) -> bool:
    return dtype == torch.bfloat16


def fwd_occupancy(lq: int, lk: int, d: int, dtype=torch.float32):
    """(bytes of shared memory per block, blocks resident per SM) of the
    forward kernel for ``dtype`` I/O at (lq, lk, d) with a flat row per
    block, the latter from the CUDA occupancy API."""
    lib = load_kernel()
    per_sm = lib.t5_attention_fwd_bf16_blocks_per_sm if _bf16(dtype) else \
        lib.t5_attention_fwd_blocks_per_sm
    n = per_sm(lq, lk, d)
    if n < 0:
        msg = lib.t5_attention_fwd_error_string(-n).decode()
        raise RuntimeError(f"t5_attention_fwd occupancy query failed: {msg} ({-n})")
    return _fwd_smem(lib, dtype)(lk, d), n


def _fwd_smem(lib, dtype):
    """The forward library's shared-memory size function for ``dtype`` I/O."""
    return lib.t5_attention_fwd_bf16_smem_bytes if _bf16(dtype) else \
        lib.t5_attention_fwd_smem_bytes


def bwd_occupancy(lq: int, lk: int, d: int, dtype=torch.float32):
    """(bytes of shared memory per block, blocks resident per SM) of the
    backward kernel for ``dtype`` I/O at (lq, lk, d), the latter from the
    CUDA occupancy API."""
    lib = load_bwd_kernel()
    per_sm = lib.t5_attention_bwd_bf16_blocks_per_sm if _bf16(dtype) else \
        lib.t5_attention_bwd_blocks_per_sm
    n = per_sm(lq, lk, d)
    if n < 0:
        msg = lib.t5_attention_bwd_error_string(-n).decode()
        raise RuntimeError(f"t5_attention_bwd occupancy query failed: {msg} ({-n})")
    return _bwd_smem(lib, dtype)(lq, lk, d), n


def _bwd_smem(lib, dtype):
    """The backward library's shared-memory size function for ``dtype`` I/O."""
    return lib.t5_attention_bwd_bf16_smem_bytes if _bf16(dtype) else \
        lib.t5_attention_bwd_smem_bytes


def bf16_kernel_attributes(d: int):
    """{"fwd": {...}, "bwd": {...}} of the bf16 entries' kernels at width
    ``d``: ``registers`` per thread and ``local_bytes`` per thread (spills and
    stack, cudaFuncGetAttributes), as the loaded builds have them."""
    out = {}
    for kind, lib in (("fwd", load_kernel()), ("bwd", load_bwd_kernel())):
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = getattr(lib, f"t5_attention_{kind}_bf16_registers")(
            d, ctypes.byref(regs), ctypes.byref(local))
        if err:
            msg = getattr(lib, f"t5_attention_{kind}_error_string")(err).decode()
            raise RuntimeError(f"t5_attention_{kind}_bf16 attribute query failed: {msg} ({err})")
        out[kind] = dict(registers=regs.value, local_bytes=local.value)
    return out


def make_dropout_mask(generator: torch.Generator, hb: int, lq: int, lk: int, rate: float,
                      device=None, rows: Optional[slice] = None) -> torch.Tensor:
    """Multiplicative inverted-dropout mask for the flat (H·B, Lq, Lk) layout:
    f32 values in {0, 1/(1−rate)}, each kept with probability 1 − rate, drawn
    from ``generator`` (on ``device``) and no global RNG. The scale is the f32
    1/keep that the reference's XLA dropout path divides by; the reference's
    own ``make_dropout_mask`` rounds it to bf16 (1.109375 at rate 0.1).
    ``rows`` keeps those flat rows of the (H·B, Lq, Lk) draw: a
    tensor-parallel rank's heads [h0, h0 + H_local) are the rows
    [h0·B, (h0 + H_local)·B), head slowest, and the generator advances as
    for the whole mask."""
    keep = torch.rand((hb, lq, lk), generator=generator, device=device) >= rate
    if rows is not None:
        keep = keep[rows]
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(torch.float32)


class RedrawnMask:
    """A dropout mask drawn from ``generator`` by :func:`make_dropout_mask`,
    with the generator's state just before the draw, so that the same mask
    can be drawn again later instead of being kept."""

    def __init__(self, generator: torch.Generator, hb: int, lq: int, lk: int, rate: float,
                 device=None, rows: Optional[slice] = None):
        self.generator, self.args = generator, (hb, lq, lk, rate, device, rows)
        self.state = generator.get_state()

    def draw(self) -> torch.Tensor:
        """The mask, advancing the generator as one make_dropout_mask call does."""
        return make_dropout_mask(self.generator, *self.args)

    def redraw(self) -> torch.Tensor:
        """The same mask again, the generator left where it was found."""
        after = self.generator.get_state()
        self.generator.set_state(self.state)
        try:
            return make_dropout_mask(self.generator, *self.args)
        finally:
            self.generator.set_state(after)


def _acc(t):
    """The plain versions' working type: f32, or f64 for f64 inputs (gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _probs(qf, kf, h: int, pos_bias, kv_mask, causal: bool):
    """Softmax probabilities (H·B, Lq, Lk): the terms added in the kernels'
    order (q·kᵀ, + bias, + causal, + key mask), the sum clamped at 1e-30."""
    hb, lq, _ = qf.shape
    lk = kf.shape[1]
    b = hb // h
    s = torch.bmm(_acc(qf), _acc(kf).transpose(1, 2)).view(h, b, lq, lk)
    if pos_bias is not None:
        s = s + _acc(pos_bias)[:, None]
    if causal:
        row = torch.arange(lq, device=qf.device)[:, None]
        col = torch.arange(lk, device=qf.device)[None, :]
        s = s + torch.where(col > row + (lk - lq), _NEG_INF, 0.0).to(s.dtype)
    if kv_mask is not None:
        s = s + ((1.0 - kv_mask.to(s.dtype)) * _NEG_INF)[None, :, None, :]
    s = s.reshape(hb, lq, lk)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def t5_attention_reference(qf, kf, vf, h: int, pos_bias=None, kv_mask=None, *,
                           causal: bool = False, dropout_mask=None):
    """Plain PyTorch version of the forward kernel, in the flat (H·B, L, D)
    layout: the probabilities of :func:`_probs`, then the multiplicative
    dropout mask, then rounded to v's dtype and ·V with the products summed
    in the working type (the reference's ``preferred_element_type=f32``);
    out in q's dtype."""
    p = _probs(qf, kf, h, pos_bias, kv_mask, causal)
    if dropout_mask is not None:
        p = p * _acc(dropout_mask)
    return torch.bmm(_acc(p.to(vf.dtype)), _acc(vf)).to(qf.dtype)


def _bwd_scores(qf, kf, vf, h: int, pos_bias, kv_mask, do, causal: bool, dropout_mask):
    """(ds, p·dm) of the backward, (H·B, Lq, Lk): dp = (do·vᵀ)·dm and
    ds = p·(dp − rowsum(dp·p))."""
    p = _probs(qf, kf, h, pos_bias, kv_mask, causal)
    dp = torch.bmm(_acc(do), _acc(vf).transpose(1, 2))
    pd = p
    if dropout_mask is not None:
        dm = _acc(dropout_mask)
        dp, pd = dp * dm, p * dm
    return p * (dp - (dp * p).sum(dim=-1, keepdim=True)), pd


def t5_attention_bwd_reference(qf, kf, vf, h: int, pos_bias, kv_mask, do, *,
                               causal: bool = False, dropout_mask=None,
                               need_dbias: bool = True):
    """Plain PyTorch version of the backward kernel (the reference's
    ``_bwd_kernel``): recompute p, then dp = (do·vᵀ)·dm,
    ds = p·(dp − rowsum(dp·p)), dq = ds·k, dk = dsᵀ·q, dv = (p·dm)ᵀ·do and
    dbias = Σ_b ds (None unless ``pos_bias`` is given and ``need_dbias``),
    all in the working type from the inputs cast to it (as the reference
    casts bf16 inputs to f32); dq, dk and dv are rounded to the input dtype
    at the end, dbias stays in the working type."""
    hb, lq, _ = qf.shape
    lk = kf.shape[1]
    ds, pd = _bwd_scores(qf, kf, vf, h, pos_bias, kv_mask, do, causal, dropout_mask)
    dq = torch.bmm(ds, _acc(kf))
    dk = torch.bmm(ds.transpose(1, 2), _acc(qf))
    dv = torch.bmm(pd.transpose(1, 2), _acc(do))
    dbias = None
    if pos_bias is not None and need_dbias:
        dbias = ds.view(h, hb // h, lq, lk).sum(dim=1)
    return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), dbias


def dbias_reduce_reference(partial):
    """Plain version of the dbias reduction kernel: (H, C, Lq, Lk) → (H, Lq,
    Lk), the sum over C taken in order, from chunk 0 up."""
    out = torch.zeros_like(partial[:, 0])
    for c in range(partial.shape[1]):
        out = out + partial[:, c]
    return out


_DTYPES = (torch.float32, torch.bfloat16)


def _f32(pos_bias):
    """The bias as the kernels take it: f32, as the reference casts it."""
    return None if pos_bias is None else pos_bias.to(torch.float32)


def _check(qf, kf, vf, h, pos_bias, kv_mask, dmask, do=None):
    for name, t in (("qf", qf), ("kf", kf), ("vf", vf)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be (H*B, L, D), got {tuple(t.shape)}")
    if qf.dtype not in _DTYPES:
        raise TypeError(f"qf must be float32 or bfloat16, got {qf.dtype}")
    if kf.dtype != qf.dtype or vf.dtype != qf.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {qf.dtype}, {kf.dtype} and "
                        f"{vf.dtype}")
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    if h <= 0 or hb % h != 0:
        raise ValueError(f"H*B={hb} is not a multiple of h={h}")
    if tuple(kf.shape) != (hb, lk, d) or tuple(vf.shape) != (hb, lk, d):
        raise ValueError(f"k/v must be ({hb}, Lk, {d}), got {tuple(kf.shape)} "
                         f"and {tuple(vf.shape)}")
    b = hb // h
    if pos_bias is not None:
        if tuple(pos_bias.shape) != (h, lq, lk):
            raise ValueError(f"pos_bias must be ({h}, {lq}, {lk}), got "
                             f"{tuple(pos_bias.shape)}")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, lk):
            raise ValueError(f"kv_mask must be ({b}, {lk}), got {tuple(kv_mask.shape)}")
        if kv_mask.is_floating_point() or kv_mask.is_complex():
            raise TypeError(f"kv_mask must be integer or bool, got {kv_mask.dtype}")
    if dmask is not None:
        if tuple(dmask.shape) != (hb, lq, lk):
            raise ValueError(f"dropout_mask must be ({hb}, {lq}, {lk}), got "
                             f"{tuple(dmask.shape)}")
        if dmask.dtype != torch.float32:
            raise TypeError(f"dropout_mask must be float32, got {dmask.dtype}")
    if do is not None:
        if tuple(do.shape) != (hb, lq, d):
            raise ValueError(f"the output gradient must be ({hb}, {lq}, {d}), got "
                             f"{tuple(do.shape)}")
        if do.dtype != qf.dtype:
            raise TypeError(f"the output gradient must be {qf.dtype} as q is, got {do.dtype}")
    given = [t for t in (qf, kf, vf, pos_bias, kv_mask, dmask, do) if t is not None]
    if len({t.device for t in given}) != 1:
        raise ValueError(f"all tensors must lie on one device, got {[t.device for t in given]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("t5_attention takes contiguous tensors only")
    if qf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"t5_attention runs on CUDA or CPU tensors, not {qf.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(qf, kf, vf, h, pos_bias, kv_mask, dmask, causal):
    global launches, bf16_launches
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    if d > _MAX_D:
        raise ValueError(f"t5_attention_fwd: D={d} is above the kernel's {_MAX_D}")
    lib = load_kernel()
    smem = _fwd_smem(lib, qf.dtype)(lk, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"t5_attention_fwd: Lk={lk}, D={d} needs {smem} bytes of "
                         f"shared memory per block, above the card's {_MAX_SMEM}")
    out = torch.empty_like(qf)
    mask32 = None if kv_mask is None else kv_mask.to(torch.int32).contiguous()
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        fwd = lib.t5_attention_fwd_bf16 if _bf16(qf.dtype) else lib.t5_attention_fwd
        err = fwd(_ptr(qf), _ptr(kf), _ptr(vf), _ptr(pos_bias), _ptr(mask32), _ptr(dmask),
                  _ptr(out), hb, hb // h, lq, lk, d, int(causal), stream)
    if err != 0:
        msg = lib.t5_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"t5_attention_fwd launch failed ({qf.dtype}): {msg} ({err})")
    if _bf16(qf.dtype):
        bf16_launches += 1
    else:
        launches += 1
    return out


def _launch_dbias_reduce(partial):
    global dbias_reduce_launches
    h, nchunk, lq, lk = partial.shape
    lib = load_bwd_kernel()
    dbias = torch.empty((h, lq, lk), dtype=torch.float32, device=partial.device)
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream(partial.device).cuda_stream
        err = lib.t5_attention_dbias_reduce(_ptr(partial), _ptr(dbias), h, nchunk, lq * lk,
                                            stream)
    if err != 0:
        msg = lib.t5_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"t5_attention_dbias_reduce launch failed: {msg} ({err})")
    dbias_reduce_launches += 1
    return dbias


def _launch_bwd(qf, kf, vf, h, pos_bias, kv_mask, dmask, do, causal, need_dbias):
    global bwd_launches, bf16_bwd_launches
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    if d > _MAX_D:
        raise ValueError(f"t5_attention_bwd: D={d} is above the kernel's {_MAX_D}")
    lib = load_bwd_kernel()
    smem = _bwd_smem(lib, qf.dtype)(lq, lk, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"t5_attention_bwd: Lq={lq}, Lk={lk}, D={d} needs {smem} bytes of "
                         f"shared memory per block, above the card's {_MAX_SMEM}")
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    # each block writes its flat row's ds here; the reduce kernel then sums
    # over the batch in order: no atomics, no zeroing
    b = hb // h
    partial = (torch.empty((h, b, lq, lk), dtype=torch.float32, device=qf.device)
               if pos_bias is not None and need_dbias else None)
    mask32 = None if kv_mask is None else kv_mask.to(torch.int32).contiguous()
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        bwd = lib.t5_attention_bwd_bf16 if _bf16(qf.dtype) else lib.t5_attention_bwd
        err = bwd(_ptr(qf), _ptr(kf), _ptr(vf), _ptr(pos_bias), _ptr(mask32), _ptr(dmask),
                  _ptr(do), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(partial), hb, b, lq, lk, d,
                  int(causal), stream)
    if err != 0:
        msg = lib.t5_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"t5_attention_bwd launch failed ({qf.dtype}): {msg} ({err})")
    if _bf16(qf.dtype):
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    dbias = None if partial is None else _launch_dbias_reduce(partial)
    return dq, dk, dv, dbias


def t5_attention_fwd(qf, kf, vf, h: int, pos_bias=None, kv_mask=None, *,
                     causal: bool = False, dropout_mask=None):
    """The forward on its own (no autograd): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    pos_bias = _f32(pos_bias)
    _check(qf, kf, vf, h, pos_bias, kv_mask, dropout_mask)
    if qf.device.type == "cpu":
        return t5_attention_reference(qf, kf, vf, h, pos_bias, kv_mask, causal=causal,
                                      dropout_mask=dropout_mask)
    return _launch(qf, kf, vf, h, pos_bias, kv_mask, dropout_mask, causal)


def t5_attention_bwd(qf, kf, vf, h: int, pos_bias, kv_mask, do, *, causal: bool = False,
                     dropout_mask=None, need_dbias: bool = True):
    """The backward on its own: (dq, dk, dv, dbias) from the output gradient
    ``do`` (H·B, Lq, D), the kernels on CUDA tensors, the plain version on CPU
    tensors. dbias is None unless ``pos_bias`` is given and ``need_dbias``."""
    pos_bias = _f32(pos_bias)
    _check(qf, kf, vf, h, pos_bias, kv_mask, dropout_mask, do)
    if qf.device.type == "cpu":
        return t5_attention_bwd_reference(qf, kf, vf, h, pos_bias, kv_mask, do, causal=causal,
                                          dropout_mask=dropout_mask, need_dbias=need_dbias)
    return _launch_bwd(qf, kf, vf, h, pos_bias, kv_mask, dropout_mask, do, causal, need_dbias)


def t5_attention_dbias_reduce(partial):
    """The backward's dbias reduction on its own: (H, C, Lq, Lk) f32 → (H, Lq,
    Lk), summed over C in order; the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if partial.dim() != 4 or partial.dtype != torch.float32 or not partial.is_contiguous():
        raise ValueError(f"partial must be a contiguous (H, C, Lq, Lk) float32 tensor, got "
                         f"{partial.dtype} {tuple(partial.shape)}")
    if partial.device.type == "cpu":
        return dbias_reduce_reference(partial)
    if partial.device.type != "cuda":
        raise ValueError(f"t5_attention_dbias_reduce runs on CUDA or CPU tensors, not "
                         f"{partial.device}")
    return _launch_dbias_reduce(partial)


class _FusedT5Attention(torch.autograd.Function):
    """Forward kernel #1 and backward kernel #2 (the reference's custom VJP
    ``_fused``); the masks and the non-tensor arguments get no gradient.
    dq, dk and dv come back in the inputs' dtype, dbias in f32. With a
    :class:`RedrawnMask` ``redraw`` in place of ``dmask``, the forward draws
    the mask and the backward draws it again: it is not saved."""

    @staticmethod
    def forward(ctx, qf, kf, vf, pos_bias, kv_mask, dmask, h, causal, redraw):
        if redraw is not None:
            dmask = redraw.draw()
        out = t5_attention_fwd(qf, kf, vf, h, pos_bias, kv_mask, causal=causal,
                               dropout_mask=dmask)
        ctx.save_for_backward(qf, kf, vf, pos_bias, kv_mask, None if redraw else dmask)
        ctx.h, ctx.causal, ctx.redraw = h, causal, redraw
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, pos_bias, kv_mask, dmask = ctx.saved_tensors
        if ctx.redraw is not None:
            dmask = ctx.redraw.redraw()
        # the gradient arrives through the caller's view/permute/reshape
        dq, dk, dv, dbias = t5_attention_bwd(
            qf, kf, vf, ctx.h, pos_bias, kv_mask, do.contiguous(), causal=ctx.causal,
            dropout_mask=dmask, need_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None, None, None


def fused_t5_attention_flat(qf, kf, vf, h: int, pos_bias=None, kv_mask=None, *,
                            causal: bool = False, dropout_rate: float = 0.0,
                            dropout_mask: Optional[torch.Tensor] = None,
                            dropout_generator: Optional[torch.Generator] = None,
                            dropout_rows: Optional[Tuple[int, int]] = None):
    """Flat-layout entry: qf/kf/vf (H·B, L, D), f32 or bf16, head dimension
    slowest; out in their dtype. ``pos_bias`` is cast to f32.
    ``dropout_mask`` (H·B, Lq, Lk) f32 holds {0, 1/(1−rate)} (see
    :func:`make_dropout_mask`) and is used only when ``dropout_rate > 0``;
    or, with ``dropout_generator`` instead, the mask is drawn from it here by
    :func:`make_dropout_mask` and drawn again in the backward rather than
    kept (:class:`RedrawnMask`); ``dropout_rows`` = (first row, rows of the
    whole mask) then says which rows of a wider draw these flat rows are (a
    tensor-parallel rank's heads). Differentiable in q, k, v and
    ``pos_bias``."""
    redraw = None
    if dropout_rate > 0.0:
        if (dropout_mask is None) == (dropout_generator is None):
            raise ValueError("dropout_rate > 0 requires one of dropout_mask and "
                             "dropout_generator")
        if dropout_generator is not None:
            hb, lq, _ = qf.shape
            total, rows = hb, None
            if dropout_rows is not None:
                total, rows = dropout_rows[1], slice(dropout_rows[0], dropout_rows[0] + hb)
            redraw = RedrawnMask(dropout_generator, total, lq, kf.shape[1], dropout_rate,
                                 qf.device, rows)
    dmask = dropout_mask if dropout_rate > 0.0 else None
    return _FusedT5Attention.apply(qf, kf, vf, _f32(pos_bias), kv_mask, dmask, h, causal,
                                   redraw)


def _hbld(x):
    """(B, H, L, D) → (H·B, L, D), head dim slowest."""
    b, h, l, d = x.shape
    return x.transpose(0, 1).reshape(h * b, l, d).contiguous()


def fused_t5_attention(q, k, v, pos_bias=None, kv_mask=None, *,
                       causal: bool = False, dropout_rate: float = 0.0,
                       dropout_mask: Optional[torch.Tensor] = None):
    """(B, H, L, D)-layout wrapper over :func:`fused_t5_attention_flat` (a
    transpose each way). ``dropout_mask`` stays in the flat (H·B, Lq, Lk)
    layout, as in the reference."""
    b, h = q.shape[0], q.shape[1]
    out = fused_t5_attention_flat(_hbld(q), _hbld(k), _hbld(v), h, pos_bias, kv_mask,
                                  causal=causal, dropout_rate=dropout_rate,
                                  dropout_mask=dropout_mask)
    hb, l, d = out.shape
    return out.view(h, b, l, d).transpose(0, 1)

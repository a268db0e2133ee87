"""Attention of the port: the plain multi-head path and the blockwise flash
attention, forward and backward, as CUDA kernels with plain versions.

Counterpart of ``genrec_tpu/ops/attention.py``, with its (B, H, L, D)
layout, scale 1/√d, optional additive bias (B|1, H|1, Lq, Lk) and f32
softmax:

- :func:`_xla_attention` is the reference's plain path: causal masking at
  −1e30 with the ``lk − lq`` offset, and inverted dropout on the attention
  weights drawn from a caller's ``torch.Generator``. The T5 decode step
  (``models/t5.py``) and every short or dropout call take it.
- :func:`flash_attention` is a ``torch.autograd.Function`` over the flash
  kernels (the reference's ``_flash_nobias`` / ``_flash_bias``). The
  forward is ``csrc/flash_attention_fwd.cu`` (TPU kernels #3 and #4); with
  no bias the backward is ``csrc/flash_attention_bwd.cu``'s dq and dk/dv
  kernels (#5 and #6) from the saved (q, k, v, out, lse); with a bias it
  recomputes through :func:`_xla_attention` under autograd, as the
  reference's ``_flash_bias_bwd`` does.
- :func:`dot_product_attention` routes between them by the reference's
  own gate (:func:`_use_kernel`).

Dispatch inside the kernel wrappers is decided by where the tensors lie and
nothing else: CUDA tensors go to the kernels (built at first use,
``ops/_build.py``) or raise, nothing falls back; CPU tensors go to the plain
versions :func:`flash_attention_fwd_reference` and
:func:`flash_attention_bwd_reference`. The kernels take f32 only, D ≤ 128
and lengths that are multiples of 128. ``fwd_launches``,
``bwd_dq_launches`` and ``bwd_dkv_launches`` count kernel launches, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from genrec_tpu_torch.ops import _build

_NEG_INF = -1e30
_FWD_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
_MAX_D = 128

fwd_launches = 0      # forward kernel launches since import (or since a caller reset it)
bwd_dq_launches = 0   # dq kernel launches, likewise
bwd_dkv_launches = 0  # dk/dv kernel launches, likewise

_fwd_lib = None
_bwd_lib = None


def load_fwd_kernel():
    """Build (at first use) and bind the forward kernel's library."""
    global _fwd_lib
    if _fwd_lib is None:
        lib = _build.load(_FWD_KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p] * 6 + [i] * 5 + [f, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_fwd_smem_bytes.argtypes = [i]
        lib.flash_attention_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_fwd_blocks_per_sm.argtypes = [i, i]
        lib.flash_attention_fwd_blocks_per_sm.restype = ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.flash_attention_fwd_registers.argtypes = [i, i, ip, ip]
        lib.flash_attention_fwd_registers.restype = ctypes.c_int
        lib.flash_attention_fwd_error_string.argtypes = [i]
        lib.flash_attention_fwd_error_string.restype = ctypes.c_char_p
        _fwd_lib = lib
    return _fwd_lib


def load_bwd_kernel():
    """Build (at first use) and bind the dq and dk/dv kernels' library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(_BWD_KERNEL)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_dq.argtypes = [p] * 7 + [i] * 5 + [f, p]
        lib.flash_attention_bwd_dq.restype = ctypes.c_int
        lib.flash_attention_bwd_dkv.argtypes = [p] * 8 + [i] * 5 + [f, p]
        lib.flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.flash_attention_bwd_smem_bytes.argtypes = [i, i]
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.flash_attention_bwd_blocks_per_sm.argtypes = [i, i]
        lib.flash_attention_bwd_blocks_per_sm.restype = ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.flash_attention_bwd_registers.argtypes = [i, i, ip, ip]
        lib.flash_attention_bwd_registers.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def fwd_occupancy(d: int):
    """{"plain": {...}, "bias": {...}} of the forward kernel at width ``d``,
    without and with a bias (two instantiations): ``smem_bytes`` per block,
    ``blocks_per_sm`` (the CUDA occupancy API), ``registers`` per thread and
    ``local_bytes`` per thread (spills and stack, cudaFuncGetAttributes), as
    the loaded build has them."""
    lib = load_fwd_kernel()
    out = {}
    for name, bias in (("plain", 0), ("bias", 1)):
        n = lib.flash_attention_fwd_blocks_per_sm(d, bias)
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = -n if n < 0 else lib.flash_attention_fwd_registers(
            d, bias, ctypes.byref(regs), ctypes.byref(local))
        if err:
            msg = lib.flash_attention_fwd_error_string(err).decode()
            raise RuntimeError(f"flash_attention_fwd attribute query failed: {msg} ({err})")
        out[name] = dict(smem_bytes=lib.flash_attention_fwd_smem_bytes(d), blocks_per_sm=n,
                         registers=regs.value, local_bytes=local.value)
    return out


def bwd_occupancy(d: int):
    """{"dq": {...}, "dkv": {...}} of the backward kernels at width ``d``:
    ``smem_bytes`` per block, ``blocks_per_sm`` (the CUDA occupancy API),
    ``registers`` per thread and ``local_bytes`` per thread (spills and stack,
    cudaFuncGetAttributes), as the loaded build has them."""
    lib = load_bwd_kernel()
    out = {}
    for name, which in (("dq", 1), ("dkv", 0)):
        n = lib.flash_attention_bwd_blocks_per_sm(which, d)
        regs, local = ctypes.c_int(), ctypes.c_int()
        err = -n if n < 0 else lib.flash_attention_bwd_registers(
            which, d, ctypes.byref(regs), ctypes.byref(local))
        if err:
            msg = lib.flash_attention_bwd_error_string(err).decode()
            raise RuntimeError(f"flash_attention_bwd attribute query failed: {msg} ({err})")
        out[name] = dict(smem_bytes=lib.flash_attention_bwd_smem_bytes(which, d),
                         blocks_per_sm=n, registers=regs.value, local_bytes=local.value)
    return out


def _acc(t):
    """The plain versions' working type: f32, or f64 for f64 inputs (gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _xla_attention(q, k, v, bias=None, causal: bool = False, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """The reference's plain path. q, k, v: (B, H, L, D); bias additive,
    broadcastable to (B, H, Lq, Lk). With ``dropout_rate`` > 0 and a
    ``generator``, inverted dropout on the attention WEIGHTS (torch
    ``nn.MultiheadAttention(..., dropout=)`` semantics): keep where
    ``torch.rand(generator=...) >= rate``, kept probabilities divided by
    1 − rate in f32."""
    d = q.shape[-1]
    logits = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) / math.sqrt(d)
    if bias is not None:
        logits = logits + bias
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        row = torch.arange(lq, device=q.device)[:, None]
        col = torch.arange(lk, device=q.device)[None, :]
        logits = logits.masked_fill(col > row + (lk - lq), _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, generator=generator, device=probs.device) >= dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    # probs rounded to v's dtype, the products summed in the working type
    return torch.matmul(_acc(probs.to(v.dtype)), _acc(v)).to(v.dtype)


# ---------------------------------------------------------------------------
# flash kernels (flat (B·H, L, D) layout) and their plain versions
# ---------------------------------------------------------------------------

def _scores(qf, kf, scale: float, causal: bool, bias=None):
    """q·kᵀ·scale (+ bias) in the working type, −1e30 where col > row under
    causal (no lk − lq offset: the kernels' diagonal)."""
    s = torch.bmm(_acc(qf), _acc(kf).transpose(1, 2)) * scale
    if bias is not None:
        s = s + _acc(bias)
    if causal:
        lq, lk = s.shape[1], s.shape[2]
        row = torch.arange(lq, device=s.device)[:, None]
        col = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(col > row, _NEG_INF)
    return s


def flash_attention_fwd_reference(qf, kf, vf, bias=None, *, causal: bool = False):
    """Plain PyTorch version of the forward kernel (the reference's
    ``_flash_kernel``): s = (q·kᵀ)/√d (+ bias), −1e30 past the diagonal
    under causal, m = rowmax s, l = max(Σ exp(s − m), 1e-30); returns
    out = exp(s − m)·v / l (B·H, Lq, D) and lse = m + log l (B·H, Lq)."""
    s = _scores(qf, kf, 1.0 / math.sqrt(qf.shape[-1]), causal, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.bmm(p, _acc(vf)) / l
    return out.to(qf.dtype), (m + torch.log(l))[..., 0]


def _bwd_scores(qf, kf, vf, do, lse, delta, causal: bool):
    """(p, ds) of the backward: p = exp(s − lse), ds = p·(do·vᵀ − delta)."""
    scale = 1.0 / math.sqrt(qf.shape[-1])
    p = torch.exp(_scores(qf, kf, scale, causal) - _acc(lse)[..., None])
    ds = p * (torch.bmm(_acc(do), _acc(vf).transpose(1, 2)) - _acc(delta)[..., None])
    return p, ds, scale


def flash_attention_bwd_dq_reference(qf, kf, vf, do, lse, delta, *, causal: bool = False):
    """Plain PyTorch version of the dq kernel (the reference's
    ``_flash_bwd_dq_kernel``): dq = ds·k/√d."""
    _, ds, scale = _bwd_scores(qf, kf, vf, do, lse, delta, causal)
    return (torch.bmm(ds, _acc(kf)) * scale).to(qf.dtype)


def flash_attention_bwd_dkv_reference(qf, kf, vf, do, lse, delta, *, causal: bool = False):
    """Plain PyTorch version of the dk/dv kernel (the reference's
    ``_flash_bwd_dkv_kernel``): dk = dsᵀ·q/√d, dv = pᵀ·do."""
    p, ds, scale = _bwd_scores(qf, kf, vf, do, lse, delta, causal)
    dk = torch.bmm(ds.transpose(1, 2), _acc(qf)) * scale
    return dk.to(kf.dtype), torch.bmm(p.transpose(1, 2), _acc(do)).to(vf.dtype)


def _delta(do, out):
    """rowsum(do·o) (B·H, Lq): the softmax-jacobian row term, a torch
    reduction outside the kernels as it is an XLA op in the reference."""
    return (_acc(do) * _acc(out)).sum(dim=-1)


def flash_attention_bwd_reference(qf, kf, vf, out, lse, do, *, causal: bool = False):
    """Plain PyTorch version of the whole backward (the reference's
    ``_flash_backward``): delta = rowsum(do·o), p = exp(s − lse),
    ds = p·(do·vᵀ − delta), dq = ds·k/√d, dk = dsᵀ·q/√d, dv = pᵀ·do."""
    p, ds, scale = _bwd_scores(qf, kf, vf, do, lse, _delta(do, out), causal)
    dq = torch.bmm(ds, _acc(kf)) * scale
    dk = torch.bmm(ds.transpose(1, 2), _acc(qf)) * scale
    dv = torch.bmm(p.transpose(1, 2), _acc(do))
    return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype)


def _check(qf, kf, vf, causal: bool, bias=None, rows=()):
    """Shapes, dtypes, devices and contiguity of the flat entries; ``rows``
    are (name, tensor, shape) triples of the backward's extra inputs."""
    for name, t in (("qf", qf), ("kf", kf), ("vf", vf)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B*H, L, D), got {tuple(t.shape)}")
    bh, lq, d = qf.shape
    lk = kf.shape[1]
    if tuple(kf.shape) != (bh, lk, d) or tuple(vf.shape) != (bh, lk, d):
        raise ValueError(f"k/v must be ({bh}, Lk, {d}), got {tuple(kf.shape)} and "
                         f"{tuple(vf.shape)}")
    given = [("qf", qf, None), ("kf", kf, None), ("vf", vf, None), *rows]
    if bias is not None:
        given.append(("bias", bias, (bh, lq, lk)))
    for name, t, shape in given:
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if causal and lq != lk:
        raise ValueError("causal flash attention needs lq == lk")
    tensors = [t for _, t, _ in given]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must lie on one device, got "
                         f"{[t.device for t in tensors]}")
    if qf.device.type == "cpu":
        return
    if qf.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, not {qf.device}")
    for name, t, _ in given:
        if t.dtype != torch.float32:
            raise TypeError(f"the flash kernels take float32 only: {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the flash kernels take contiguous tensors only: {name}")
    if d > _MAX_D:
        raise ValueError(f"the flash kernels take D <= {_MAX_D}, got {d}")
    if lq % 128 or lk % 128:
        raise ValueError(f"the flash kernels take lengths that are multiples of 128, got "
                         f"({lq}, {lk})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str, error_string):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {error_string(err).decode()} ({err})")


def flash_attention_fwd(qf, kf, vf, bias=None, *, causal: bool = False):
    """The forward on its own (no autograd): (out (B·H, Lq, D), lse (B·H, Lq)
    f32). The kernel on CUDA tensors, the plain version on CPU tensors.
    ``bias`` is the materialised (B·H, Lq, Lk) additive bias or None."""
    global fwd_launches
    _check(qf, kf, vf, causal, bias)
    if qf.device.type == "cpu":
        return flash_attention_fwd_reference(qf, kf, vf, bias, causal=causal)
    bh, lq, d = qf.shape
    lk = kf.shape[1]
    lib = load_fwd_kernel()
    out = torch.empty_like(qf)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=qf.device)
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.flash_attention_fwd(_ptr(qf), _ptr(kf), _ptr(vf), _ptr(bias), _ptr(out),
                                      _ptr(lse), bh, lq, lk, d, int(causal),
                                      1.0 / math.sqrt(d), stream)
    _raise_on(err, "flash_attention_fwd", lib.flash_attention_fwd_error_string)
    fwd_launches += 1
    return out, lse


def _check_bwd(qf, kf, vf, do, lse, delta, causal):
    bh, lq, d = qf.shape
    _check(qf, kf, vf, causal, rows=(("do", do, (bh, lq, d)), ("lse", lse, (bh, lq)),
                                     ("delta", delta, (bh, lq))))


def flash_attention_bwd_dq(qf, kf, vf, do, lse, delta, *, causal: bool = False):
    """dq (B·H, Lq, D) from q, k, v, the output gradient ``do``, the
    forward's ``lse`` and ``delta`` = rowsum(do·o) (B·H, Lq): the dq kernel
    on CUDA tensors, its plain version on CPU tensors."""
    global bwd_dq_launches
    _check_bwd(qf, kf, vf, do, lse, delta, causal)
    if qf.device.type == "cpu":
        return flash_attention_bwd_dq_reference(qf, kf, vf, do, lse, delta, causal=causal)
    bh, lq, d = qf.shape
    lib = load_bwd_kernel()
    dq = torch.empty_like(qf)
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.flash_attention_bwd_dq(_ptr(qf), _ptr(kf), _ptr(vf), _ptr(do), _ptr(lse),
                                         _ptr(delta), _ptr(dq), bh, lq, kf.shape[1], d,
                                         int(causal), 1.0 / math.sqrt(d), stream)
    _raise_on(err, "flash_attention_bwd_dq", lib.flash_attention_bwd_error_string)
    bwd_dq_launches += 1
    return dq


def flash_attention_bwd_dkv(qf, kf, vf, do, lse, delta, *, causal: bool = False):
    """(dk, dv) (B·H, Lk, D), from the same inputs as
    :func:`flash_attention_bwd_dq`: the dk/dv kernel on CUDA tensors, its
    plain version on CPU tensors."""
    global bwd_dkv_launches
    _check_bwd(qf, kf, vf, do, lse, delta, causal)
    if qf.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(qf, kf, vf, do, lse, delta, causal=causal)
    bh, lq, d = qf.shape
    lib = load_bwd_kernel()
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.flash_attention_bwd_dkv(_ptr(qf), _ptr(kf), _ptr(vf), _ptr(do), _ptr(lse),
                                          _ptr(delta), _ptr(dk), _ptr(dv), bh, lq,
                                          kf.shape[1], d, int(causal), 1.0 / math.sqrt(d),
                                          stream)
    _raise_on(err, "flash_attention_bwd_dkv", lib.flash_attention_bwd_error_string)
    bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd(qf, kf, vf, out, lse, do, *, causal: bool = False):
    """The backward on its own: (dq, dk, dv) from the saved (q, k, v, out,
    lse) and the output gradient ``do`` (B·H, Lq, D). On CUDA tensors delta
    = rowsum(do·o) is a torch reduction and the dq and dk/dv kernels run; on
    CPU tensors the plain version runs."""
    _check(qf, kf, vf, causal, rows=(("out", out, tuple(qf.shape)),
                                     ("do", do, tuple(qf.shape))))
    delta = _delta(do, out)
    _check_bwd(qf, kf, vf, do, lse, delta, causal)
    if qf.device.type == "cpu":
        return flash_attention_bwd_reference(qf, kf, vf, out, lse, do, causal=causal)
    dq = flash_attention_bwd_dq(qf, kf, vf, do, lse, delta, causal=causal)
    return (dq, *flash_attention_bwd_dkv(qf, kf, vf, do, lse, delta, causal=causal))


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

# The reference switches to its blocked kernels (#4, #6) past this many
# lane-padded bytes of a full-length (1, L, d) ref, a TPU VMEM limit. The port
# has one kernel for both routes; the rule stays only for the biased
# backward's guard below, which the reference raises at the same lengths.
_BWD_FULL_REF_BYTES_LIMIT = 1_500_000


def _use_blocked_bwd(lq: int, lk: int, d: int) -> bool:
    return max(lq, lk) * max(d, 128) * 4 > _BWD_FULL_REF_BYTES_LIMIT


def _flat(x):
    """(B, H, L, D) → (B·H, L, D), contiguous."""
    b, h, l, d = x.shape
    return x.contiguous().view(b * h, l, d)


class _FlashAttention(torch.autograd.Function):
    """No bias (the reference's ``_flash_nobias``): the forward kernel, and
    the dq and dk/dv kernels from the saved (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        qf, kf, vf = _flat(q), _flat(k), _flat(v)
        out, lse = flash_attention_fwd(qf, kf, vf, causal=causal)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal = causal
        return out.view(q.shape)

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, out, lse = ctx.saved_tensors
        # the gradient arrives through the caller's transpose/reshape
        dq, dk, dv = flash_attention_bwd(qf, kf, vf, out, lse,
                                         do.contiguous().view(out.shape), causal=ctx.causal)
        b, h = do.shape[0], do.shape[1]
        return (dq.view(b, h, *dq.shape[1:]), dk.view(b, h, *dk.shape[1:]),
                dv.view(b, h, *dv.shape[1:]), None)


class _FlashAttentionBias(torch.autograd.Function):
    """With an additive bias (the reference's ``_flash_bias``): the forward
    kernel on the bias materialised to (B·H, Lq, Lk); the backward
    recomputes through :func:`_xla_attention` under autograd, which gives all
    four gradients, the bias's included."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        b, h, lq, _ = q.shape
        lk = k.shape[2]
        bias_f = bias.expand(b, h, lq, lk).reshape(b * h, lq, lk).contiguous()
        out, _ = flash_attention_fwd(_flat(q), _flat(k), _flat(v), bias_f, causal=causal)
        ctx.save_for_backward(q, k, v, bias)
        ctx.causal = causal
        return out.view(q.shape)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
        if _use_blocked_bwd(lq, lk, dh):
            raise NotImplementedError(
                f"biased flash backward at blocked-kernel scale (Lq={lq}, Lk={lk}, d={dh}): "
                "the recompute would materialise O(L²) scores. Drop the bias (fold it into "
                "the inputs), use ops/t5_attention.py for relative-position bias, or add a "
                "dbias kernel before enabling this configuration.")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
            out = _xla_attention(*leaves, causal=ctx.causal)
            grads = torch.autograd.grad(out, leaves, do)
        return (*grads, None)


def flash_attention(q, k, v, bias=None, *, causal: bool = False):
    """Blockwise flash attention, differentiable. q, k, v: (B, H, L, D) with
    Lq and Lk multiples of 128; bias: optional (B|1, H|1, Lq, Lk) additive.
    The kernels choose their own tiles (the reference's ``block_q`` /
    ``block_k`` were TPU tile sizes)."""
    lq, lk = q.shape[2], k.shape[2]
    if lq % 128 or lk % 128:
        raise AssertionError(
            f"flash_attention needs Lq/Lk multiples of 128, got ({lq}, {lk}); "
            "pad the sequence — a full-length block would blow VMEM")
    # The kernels mask `col > row` with NO (lk - lq) offset, unlike
    # _xla_attention's `col > row + (lk - lq)`: for lq != lk the two paths
    # would silently disagree on which diagonal is causal.
    if causal and lq != lk:
        raise AssertionError(
            f"causal flash_attention requires lq == lk (got {lq} vs {lk}); "
            "the kernel masks the main diagonal, not the lk-lq-offset one — "
            "use force_kernel=False for causal cross-length attention")
    if bias is None:
        return _FlashAttention.apply(q, k, v, causal)
    return _FlashAttentionBias.apply(q, k, v, bias, causal)


def _use_kernel(q, k) -> bool:
    """The reference's ``_use_pallas`` gate with "TPU backend" read as "the
    tensors are on CUDA": Lq and Lk ≥ 512 and multiples of 128. Its 512 was
    measured on a TPU v5e (below it both paths sat at the dispatch floor);
    the H100's own threshold is to be measured in a later PR. Keeping the
    reference's gate sends the same configurations to the kernels on the card
    as on the TPU."""
    lq, lk = q.shape[2], k.shape[2]
    return q.is_cuda and lq >= 512 and lk >= 512 and lq % 128 == 0 and lk % 128 == 0


def dot_product_attention(q, k, v, bias=None, *, causal: bool = False,
                          force_kernel: Optional[bool] = None, dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None):
    """(B, H, L, D) attention with optional additive bias, causal mask and
    attention-weight dropout. The flash kernels take it when
    :func:`_use_kernel` holds (or ``force_kernel`` says so) and no dropout is
    drawn; otherwise :func:`_xla_attention`. On CUDA the short-L and dropout
    routes to :func:`_xla_attention` are the reference's own routing (its
    kernel has no in-kernel dropout), not a fallback: a kernel that fails
    raises."""
    with_drop = dropout_rate > 0.0 and generator is not None
    use = (_use_kernel(q, k) if force_kernel is None else force_kernel) and not with_drop
    if use:
        return flash_attention(q, k, v, bias, causal=causal)
    return _xla_attention(q, k, v, bias, causal, dropout_rate, generator)


def multi_head_attention(q, k, v, *, num_heads: int, bias=None, causal: bool = False,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         force_kernel: Optional[bool] = None):
    """Split (B, L, H·D) projections into heads, attend, and merge back.
    ``dropout_rate`` with a ``generator`` drops attention weights (pass a
    generator only when training)."""
    b, lq, dm = q.shape
    lk = k.shape[1]
    dh = dm // num_heads
    qh = q.reshape(b, lq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(b, lk, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, lk, num_heads, dh).transpose(1, 2)
    out = dot_product_attention(qh, kh, vh, bias, causal=causal, force_kernel=force_kernel,
                                dropout_rate=dropout_rate, generator=generator)
    return out.transpose(1, 2).reshape(b, lq, dm)

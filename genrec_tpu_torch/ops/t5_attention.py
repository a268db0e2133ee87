"""Fused short-sequence T5 attention forward: CUDA kernel and plain version.

Counterpart of ``genrec_tpu/ops/t5_attention.py``'s forward
(``fused_t5_attention_flat`` / ``fused_t5_attention``), with the same
layouts: the flat entry takes q/k/v as (H·B, L, D) with the head dimension
slowest, ``pos_bias`` (H, Lq, Lk) is a learned additive bias, ``kv_mask``
(B, Lk) is 1 where a key may be attended, ``dropout_mask`` (H·B, Lq, Lk)
is a multiplicative mask applied to the softmax probabilities. Unscaled
dot product (T5 convention); every mask is an ADDITIVE −1e9 term in f32.

Dispatch, decided by where the tensors lie and nothing else:
- CUDA tensors go to the hand-written kernel ``csrc/t5_attention_fwd.cu``
  (built at first use, ``ops/_build.py``) or raise; nothing falls back;
- CPU tensors go to the plain version :func:`t5_attention_reference`.

Forward only, f32 only, for now: the backward kernel comes with the
training slice, bf16 later. ``launches`` counts kernel launches, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from genrec_tpu_torch.ops import _build

_NEG_INF = -1e9
_MAX_SMEM = 232448  # bytes of shared memory one block may use on H100
_KERNEL = "t5_attention_fwd"

launches = 0  # kernel launches since import (or since a caller reset it)

_lib = None


def load_kernel():
    """Build (at first use) and bind the kernel's library."""
    global _lib
    if _lib is None:
        lib = _build.load(_KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.t5_attention_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.t5_attention_fwd.restype = ctypes.c_int
        lib.t5_attention_fwd_smem_bytes.argtypes = [i, i]
        lib.t5_attention_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.t5_attention_fwd_error_string.argtypes = [i]
        lib.t5_attention_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def t5_attention_reference(qf, kf, vf, h: int, pos_bias=None, kv_mask=None, *,
                           causal: bool = False, dropout_mask=None):
    """Plain PyTorch version of the kernel, in the flat (H·B, L, D) layout:
    the same terms added in the same order as the kernel and the Pallas
    reference (q·kᵀ, + bias, + causal, + key mask), f32 softmax with the
    sum clamped at 1e-30, then the multiplicative dropout mask, then ·V."""
    hb, lq, _ = qf.shape
    lk = kf.shape[1]
    b = hb // h
    s = torch.bmm(qf.float(), kf.float().transpose(1, 2)).view(h, b, lq, lk)
    if pos_bias is not None:
        s = s + pos_bias.float()[:, None]
    if causal:
        row = torch.arange(lq, device=qf.device)[:, None]
        col = torch.arange(lk, device=qf.device)[None, :]
        s = s + torch.where(col > row + (lk - lq), _NEG_INF, 0.0).to(s.dtype)
    if kv_mask is not None:
        s = s + ((1.0 - kv_mask.float()) * _NEG_INF)[None, :, None, :]
    s = s.reshape(hb, lq, lk)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if dropout_mask is not None:
        p = p * dropout_mask.float()
    return torch.bmm(p.to(vf.dtype), vf).to(qf.dtype)


def _check(qf, kf, vf, h, pos_bias, kv_mask, dmask):
    for name, t in (("qf", qf), ("kf", kf), ("vf", vf)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be (H*B, L, D), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
        if pos_bias.dtype != torch.float32:
            raise TypeError(f"pos_bias must be float32, got {pos_bias.dtype}")
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
    given = [t for t in (qf, kf, vf, pos_bias, kv_mask, dmask) if t is not None]
    if len({t.device for t in given}) != 1:
        raise ValueError(f"all tensors must lie on one device, got {[t.device for t in given]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("t5_attention_fwd takes contiguous tensors only")


def _launch(qf, kf, vf, h, pos_bias, kv_mask, dmask, causal):
    global launches
    hb, lq, d = qf.shape
    lk = kf.shape[1]
    lib = load_kernel()
    smem = lib.t5_attention_fwd_smem_bytes(lk, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"t5_attention_fwd: Lk={lk}, D={d} needs {smem} bytes of "
                         f"shared memory per block, above the card's {_MAX_SMEM}")
    out = torch.empty_like(qf)
    mask32 = None if kv_mask is None else kv_mask.to(torch.int32).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = lib.t5_attention_fwd(
            ptr(qf), ptr(kf), ptr(vf), ptr(pos_bias), ptr(mask32), ptr(dmask),
            ptr(out), hb, hb // h, lq, lk, d, int(causal), stream)
    if err != 0:
        msg = lib.t5_attention_fwd_error_string(err).decode()
        raise RuntimeError(f"t5_attention_fwd launch failed: {msg} ({err})")
    launches += 1
    return out


def fused_t5_attention_flat(qf, kf, vf, h: int, pos_bias=None, kv_mask=None, *,
                            causal: bool = False, dropout_rate: float = 0.0,
                            dropout_mask: Optional[torch.Tensor] = None):
    """Flat-layout entry: qf/kf/vf (H·B, L, D) f32, head dimension slowest.
    ``dropout_mask`` (H·B, Lq, Lk) f32 holds {0, 1/(1−rate)} and is used
    only when ``dropout_rate > 0``."""
    if dropout_rate > 0.0 and dropout_mask is None:
        raise ValueError("dropout_rate > 0 requires dropout_mask")
    dmask = dropout_mask if dropout_rate > 0.0 else None
    _check(qf, kf, vf, h, pos_bias, kv_mask, dmask)
    if qf.device.type == "cpu":
        return t5_attention_reference(qf, kf, vf, h, pos_bias, kv_mask,
                                      causal=causal, dropout_mask=dmask)
    if qf.device.type != "cuda":
        raise ValueError(f"t5_attention_fwd runs on CUDA or CPU tensors, not {qf.device}")
    return _launch(qf, kf, vf, h, pos_bias, kv_mask, dmask, causal)


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

"""Ring attention: exact attention with the sequence sharded over a mesh axis.

Counterpart of ``genrec_tpu/ops/ring_attention.py`` on ``torch.distributed``.
The M ranks along ``axis_name`` each hold one L/M block of a sequence's
queries, keys and values. Each keeps its query block and passes its K/V
block round the ring, rank s to rank s+1, M−1 times; at hop j it holds the
block that started at rank (i − j) mod M, and an online softmax (initial
max −1e30) merges that block's scores into its output, with the causal mask
on absolute token offsets. The output is acc / max(l, 1e-30).

Autograd cannot see through ``send``/``recv``, so the hop is an autograd
Function (:class:`_RingShift`) whose backward sends the cotangent round the
reverse ring; ``batch_isend_irecv`` posts each hop's send and receive
together so no rank waits on another. Inside a (query block, key block)
pair the math is plain PyTorch, as the reference's is plain jnp; the
attention-weight dropout of the single-device path has no ring counterpart
in the reference, and none here.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from genrec_tpu_torch.parallel.mesh import Mesh

_NEG_INF = -1e30


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank s's ``x`` lands on rank s + ``step`` (mod the group's size)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (me + step) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One hop s → s+1 round ``group``; the cotangent goes s+1 → s."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _block_attend(q, k, v, q_off: int, k_off: int, causal: bool, sm_scale: float, carry):
    """Merge one (query block, key block) pair into carry = (acc, m, l):
    q (B, H, lq, D), k/v (B, H, lk, D) at absolute offsets q_off/k_off,
    m and l (B, H, lq, 1)."""
    acc, m_prev, l_prev = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if causal:
        row = torch.arange(q.shape[2], device=q.device)[:, None] + q_off
        col = torch.arange(k.shape[2], device=q.device)[None, :] + k_off
        s = s.masked_fill(col > row, _NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return acc, m_new, l_new


def ring_attention(q, k, v, mesh: Mesh, *, axis_name: str = "data", causal: bool = False):
    """Attention of this rank's (B, H, L/M, D) query block over the whole
    sequence, whose K/V blocks sit on the M ranks along ``axis_name`` in
    rank order. Returns this rank's (B, H, L/M, D) output block. The batch
    dimension may be sharded over the mesh's other axis: each rank's B rows
    are its own (JAX's ``batch_axis``)."""
    M, i, group = mesh.size(axis_name), mesh.index(axis_name), mesh.group(axis_name)
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    l_loc = q.shape[2]
    q32 = q.float()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:3], 1), _NEG_INF, dtype=torch.float32, device=q.device)
    carry = (acc, m, torch.zeros_like(m))
    kv = torch.stack([k.float(), v.float()])  # one message a hop
    for j in range(M):
        carry = _block_attend(q32, kv[0], kv[1], i * l_loc, ((i - j) % M) * l_loc, causal,
                              sm_scale, carry)
        if j != M - 1:
            kv = _RingShift.apply(kv, group)
    acc, _, l = carry
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_multi_head_attention(q, k, v, mesh: Mesh, *, num_heads: int, axis_name: str = "data",
                              causal: bool = False):
    """(B, L/M, H·D) wrapper of :func:`ring_attention`, as
    ``ops.attention.multi_head_attention`` is of the single-device one."""
    b, lq, dm = q.shape
    dh = dm // num_heads

    def split(x):
        return x.reshape(b, x.shape[1], num_heads, dh).transpose(1, 2)

    out = ring_attention(split(q), split(k), split(v), mesh, axis_name=axis_name, causal=causal)
    return out.transpose(1, 2).reshape(b, lq, dm)

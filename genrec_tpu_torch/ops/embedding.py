"""Row-sharded embedding lookups over the mesh's 'model' axis.

Counterpart of ``genrec_tpu/ops/embedding.py`` on ``torch.distributed``.
Each rank of a data row holds one (V/M, D) block of rows of the table (the
rows ``[m·V/M, (m+1)·V/M)`` at model index m) and the same ids, its data
index's share of the batch; the lookup gives every rank of the row the full
(…, D) embeddings. Two collectives, as in the reference:

- :func:`sharded_embedding_lookup`: a masked local gather and one
  all-reduce over the 'model' group;
- :func:`alltoall_embedding_lookup`: ids bucketed by owner, exchanged with
  ``all_to_all_single``, gathered by their owners and sent back.

Both are differentiable with respect to the local table block. Every rank
of a data row computes the same loss from the same embeddings, so each holds
the full cotangent of a replicated output. JAX's ``shard_map`` hands each of
the M copies 1/M of it, and the transposes sum the copies back
(``ops/embedding.py:17-23`` there). Here: the all-reduce's backward passes
the cotangent through unchanged, which is the all-reduce of the M shares;
the all_to_all path splits it into M shares and sends each back through the
reverse exchange. ``torch.distributed``'s own differentiable all-reduce
would sum the M copies instead and make the table gradient M times too
large. Collectives over a mesh without a process group are the identity.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.nn import functional as F

from genrec_tpu_torch.parallel.mesh import Mesh


class _AllReduceReplicated(torch.autograd.Function):
    """Σ over ``group`` forward; the output is replicated over the group,
    so its backward passes each rank's cotangent through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0; its transpose is
    the same exchange of the cotangent's blocks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _ShareGrad(torch.autograd.Function):
    """Identity forward; the backward gives 1/n of the cotangent: the share
    of one of n replicated copies."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sharded_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh, *,
                             axis_name: str = "model") -> torch.Tensor:
    """Look ``ids`` (any shape, global row ids) up in a table row-sharded
    over ``axis_name``, of which this rank holds ``table_shard``: rows it
    owns are gathered, the others read zero, and one all-reduce over the
    axis assembles them. Returns (*ids.shape, D) in the table's dtype."""
    rows = table_shard.shape[0]
    local = ids - mesh.index(axis_name) * rows
    mine = (local >= 0) & (local < rows)
    part = F.embedding(torch.where(mine, local, 0), table_shard)
    part = part * mine[..., None].to(part.dtype)
    group = mesh.group(axis_name)
    return part if group is None else _AllReduceReplicated.apply(part, group)


def alltoall_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh, *,
                              axis_name: str = "model", capacity_factor: float = 2.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The id-partition variant. This rank buckets its n ids by owner shard
    into M buckets of ``max(int(c·n/M + 0.999), 1)`` slots (c the capacity
    factor; -1 marks an empty slot), in each owner's group in the ids' own
    order (a stable sort), exchanges the buckets, gathers the rows it owns
    and sends them back. Returns ``(embs, ok)``: ``ok`` is False for an id
    its bucket had no room for, which reads a zero row and gets a zero
    gradient. An overflowing id is written to a spare slot past the last
    bucket, which is cut off before the exchange: no index leaves its
    tensor, which on the card would be a device-side assert."""
    M, me, group = mesh.size(axis_name), mesh.index(axis_name), mesh.group(axis_name)
    rows = table_shard.shape[0]
    flat = ids.reshape(-1)
    n = flat.shape[0]
    cap = max(int(capacity_factor * n / M + 0.999), 1)
    dev = flat.device
    owner = torch.clamp(torch.div(flat, rows, rounding_mode="floor"), 0, M - 1)
    order = torch.sort(owner, stable=True).indices
    sorted_owner = owner[order]
    group_start = torch.searchsorted(sorted_owner, torch.arange(M, device=dev, dtype=owner.dtype))
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=dev) - group_start[sorted_owner]
    ok = pos < cap
    slot = owner * cap + torch.where(ok, pos, 0)
    buckets = torch.full((M * cap + 1,), -1, dtype=flat.dtype, device=dev)
    buckets[torch.where(ok, slot, M * cap)] = flat
    buckets = buckets[:M * cap]
    if group is not None:
        sent = torch.empty_like(buckets)
        dist.all_to_all_single(sent, buckets, group=group)
    else:
        sent = buckets
    valid = sent >= 0
    gathered = F.embedding(torch.clamp(sent - me * rows, 0, rows - 1), table_shard)
    gathered = gathered * valid[:, None].to(gathered.dtype)
    back = gathered if group is None else _AllToAll.apply(gathered, group)
    out = back[slot] * ok[:, None].to(back.dtype)
    if M > 1:  # the output is replicated over the M ranks of the data row
        out = _ShareGrad.apply(out, M)
    return out.reshape(*ids.shape, table_shard.shape[1]), ok.reshape(ids.shape)

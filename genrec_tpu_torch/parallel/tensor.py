"""Dense tensor parallelism over the mesh's 'model' axis: the collectives
inside the T5 and SASRec modules, and cutting a model to its shards.

JAX has no counterpart file: there GSPMD places every collective from the
parameters' shardings (``genrec_tpu/parallel/auto.py`` ``param_shardings``).
The port writes them out, in the Megatron pattern. Each rank of a data row
holds the same batch and a block of the split weights:

- a column-parallel projection (q/k/v, ``wi``, the parity SASRec's vocabulary
  scores) takes a replicated input through :func:`copy_to_model` and gives
  this rank's block of output columns;
- a row-parallel projection (``o``, ``wo``) gives a partial sum, made whole
  by :func:`reduce_from_model`;
- :func:`gather_from_model` assembles a tensor whose blocks lie on the
  ranks (the full-vocabulary scores).

Each takes the 'model' group of a mesh and is the identity when the mesh is
None or has no group. They use nothing but ``all_reduce``, which gloo also
runs on CUDA tensors (two gloo ranks may share one card). Every rank of the
group computes the same loss from the same replicated activations, so each
holds the full gradient of a replicated tensor: the backward of a gather is
this rank's block of it, not another all-reduce.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Set

import torch
import torch.distributed as dist
from torch import nn

from genrec_tpu_torch.parallel.mesh import Mesh
from genrec_tpu_torch.parallel.sharding import Spec, shard_tensor

AXIS = "model"


def _group(mesh: Optional[Mesh]):
    return None if mesh is None or mesh.size(AXIS) <= 1 else mesh.group(AXIS)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, size):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= size
        full = x.new_zeros(shape)
        full.narrow(dim, index * ctx.n, ctx.n).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Identity forward, Σ over 'model' backward: the replicated input of a
    column-parallel projection, whose gradient each rank holds in part."""
    group = _group(mesh)
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Σ over 'model' forward, identity backward: the output of a
    row-parallel projection, a partial sum on each rank."""
    group = _group(mesh)
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh], dim: int) -> torch.Tensor:
    """The whole tensor of which each rank of 'model' holds the block at its
    index along ``dim`` (equal blocks): a zero tensor of the full size with
    this rank's block filled in, summed over the group, so exact. The
    backward is this rank's block of the full gradient."""
    group = _group(mesh)
    if group is None:
        return x
    dim = dim % x.dim()
    return _GatherFromModel.apply(x, group, dim, mesh.index(AXIS), mesh.size(AXIS))


def split_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec splits over 'model', None when it splits none."""
    return spec.index(AXIS) if AXIS in spec else None


def shard_model_(model: nn.Module, mesh: Mesh, specs: Mapping[str, Spec]) -> Set[str]:
    """Cut, in place, every parameter whose spec splits it over 'model' to
    this rank's block (``sharding.shard_tensor``), and hand ``mesh`` to every
    module that has a ``tp_mesh`` attribute (the modules that run the
    collectives). Returns the names of the parameters cut. Every rank must
    have built the same whole model (the same seed) before."""
    cut = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = specs.get(name, ())
            if split_dim(spec) is not None:
                p.data = shard_tensor(p.data, spec, mesh).contiguous()
                cut.add(name)
    for m in model.modules():
        if hasattr(m, "tp_mesh"):
            m.tp_mesh = mesh
    return cut


@torch.no_grad()
def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of a shard cut by ``spec`` (outside autograd)."""
    dim = split_dim(spec)
    return t if dim is None else gather_from_model(t.detach(), mesh, dim)


def gather_state(state: Mapping[str, torch.Tensor], mesh: Mesh,
                 specs: Mapping[str, Spec]) -> Dict[str, torch.Tensor]:
    """The inverse of ``sharding.shard_params``: the whole tensors of a
    state dict whose ``specs`` entries name the cut ones. Every rank of the
    'model' group must call it (it is collective); each gets the whole
    tensors. Checkpoints and ``best_params`` hold these."""
    return {k: gather_tensor(v, specs.get(k, ()), mesh) for k, v in state.items()}

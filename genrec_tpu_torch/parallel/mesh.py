"""Process groups and the named-axis meshes of the port.

Counterpart of ``genrec_tpu/parallel/mesh.py`` on ``torch.distributed``: one
process per GPU (NCCL), or per CPU rank (gloo) when the caller asks for the
CPU. A rank is one device, so where JAX speaks of a process's devices the
port speaks of the rank itself.

A mesh has any number of named axes, as ``jax.sharding.Mesh(
devices.reshape(shape), names)`` has, and rank ``r`` sits at its row-major
coordinate in ``shape``: on the (data, model) mesh of :func:`make_mesh`
that is ``(r // model, r % model)``. The ranks of one data row share a data
index and hold the same batch rows; the ranks of one column share a model
index and hold the same table shard. :func:`make_named_mesh` builds any
other layout, such as the (data, ctx, model) mesh of long-context SASRec.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from genrec_tpu_torch.configs import MeshConfig
from genrec_tpu_torch.device import resolve_device


def _new_groups(grid: np.ndarray, axes: Sequence[int], rank: int):
    """Every group of the ranks that differ along ``axes`` only (one per
    coordinate of the other axes, in row-major order; ``dist.new_group`` is
    collective, so every rank makes all of them), and the one holding
    ``rank``."""
    k = len(axes)
    classes = np.moveaxis(grid, list(axes), list(range(grid.ndim - k, grid.ndim)))
    mine = None
    for ranks in classes.reshape(-1, int(np.prod([grid.shape[a] for a in axes]))):
        g = dist.new_group(ranks.tolist())
        mine = g if rank in ranks else mine
    return mine


class Mesh:
    """This rank's view of a mesh of named axes: each axis's size, this
    rank's index along it, and the process group of the ranks that differ
    from this one along that axis only. Built by :func:`make_mesh` or
    :func:`make_named_mesh`; a mesh built without a process group has no
    groups (``None``), so every collective over it is the identity.
    ``grid`` (the ranks at their coordinates) lets :meth:`group_over` build
    the groups of several axes when they are first asked for."""

    def __init__(self, names: Sequence[str], shape: Sequence[int],
                 coordinate: Sequence[int], groups: Sequence[Optional[object]],
                 grid: Optional[np.ndarray] = None):
        self.names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self._index = dict(zip(names, coordinate))
        self._groups = dict(zip(names, groups))
        self._grid = grid
        self._joint: Dict[FrozenSet[str], object] = {}

    def size(self, axis: Optional[str]) -> int:
        """The axis's size; 1 for an axis the mesh does not have (or None)."""
        return self.shape.get(axis, 1)

    def index(self, axis: Optional[str]) -> int:
        """This rank's index along ``axis``; 0 for an axis the mesh lacks."""
        return self._index.get(axis, 0)

    def group(self, axis: Optional[str]):
        """The group along ``axis``; None without a process group, or for an
        axis the mesh does not have."""
        return self._groups.get(axis)

    def group_over(self, axes: Sequence[Optional[str]]):
        """The group of the ranks that differ from this one along ``axes``
        only: the world for all of the mesh's axes, one axis's group for one,
        None for none (or without a process group). A group of some axes but
        not all is made the first time it is asked for, which is collective:
        every rank must ask for it, in the same order."""
        axes = frozenset(a for a in axes if a in self.shape)
        if not axes or self._groups[self.names[0]] is None:
            return None
        if len(axes) == len(self.names):
            return dist.group.WORLD
        if len(axes) == 1:
            return self._groups[next(iter(axes))]
        if axes not in self._joint:
            if self._grid is None:
                raise ValueError("this mesh was built without its grid of ranks: the group "
                                 f"over {sorted(axes)} cannot be made")
            self._joint[axes] = _new_groups(
                self._grid, [i for i, n in enumerate(self.names) if n in axes],
                dist.get_rank())
        return self._joint[axes]


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, *, device=None,
                         backend: Optional[str] = None) -> torch.device:
    """Join this process to a group of ``world_size`` ranks at ``init_method``
    (``tcp://host:port`` or ``file:///path``) and return the device it runs
    on: ``cuda:<rank % cards>`` unless ``device="cpu"``. ``backend`` is the
    group's: by default NCCL on the card and gloo on the CPU; ``"gloo"`` on
    the card runs every collective through the host (gloo takes CUDA
    tensors for all_reduce and broadcast), which lets two ranks share one
    card, as NCCL does not. Without ``world_size`` it is a no-op (one
    process, no group) and returns ``resolve_device(device)``. A failed
    NCCL start raises; it is never retried on gloo."""
    dev = resolve_device(device)
    if world_size is None:
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev.type}: NCCL runs on the card only, "
                         "gloo on either")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend == "gloo":
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size,
                                rank=rank)
        return dev
    dist.init_process_group("nccl", init_method=init_method, world_size=world_size, rank=rank,
                            device_id=dev)
    return dev


def make_named_mesh(shape: Sequence[int], names: Sequence[str]) -> Mesh:
    """The mesh of ``names`` over every rank of the process group, laid out
    row-major in ``shape`` (whose sizes must multiply to the world size), as
    ``jax.sharding.Mesh(np.asarray(devices).reshape(shape), names)`` lays
    devices out. Without a process group the world is one rank and every
    size must be 1. Every rank must call this, in the same order as its other
    group creations: it makes one group per line of ranks along each axis
    (``dist.new_group`` is collective)."""
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    shape = tuple(int(x) for x in shape)
    assert int(np.prod(shape)) == n, f"mesh {'x'.join(map(str, shape))} != {n} devices"
    if not live:
        return Mesh(names, shape, (0,) * len(shape), (None,) * len(shape))
    rank = dist.get_rank()
    grid = np.arange(n).reshape(shape)
    coordinate = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = [_new_groups(grid, [i], rank) for i in range(len(shape))]
    return Mesh(names, shape, coordinate, groups, grid)


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """Build the (data, model) mesh over every rank of the process group.

    ``data_axis == -1`` takes all remaining ranks; the axis sizes must
    multiply to the world size. Without a process group the world is one
    rank and the mesh 1 × 1 with no groups. Every rank must call this, in
    the same order as its other group creations: it makes one group per
    column (along 'data') and then one per row (along 'model')."""
    cfg = cfg or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    model = cfg.model_axis if cfg.model_axis > 0 else 1
    data = cfg.data_axis if cfg.data_axis > 0 else n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    return make_named_mesh((data, model), cfg.axis_names)


def process_rows(mesh: Mesh, n_rows: int) -> Tuple[int, int]:
    """[start, stop) of the leading-axis rows this rank holds when ``n_rows``
    are split over 'data' in contiguous blocks of ceil(n_rows / size) (the
    last block shorter): which rows a per-rank loader should read."""
    per = -(-n_rows // mesh.size("data"))
    lo = min(mesh.index("data") * per, n_rows)
    return lo, min(lo + per, n_rows)


def make_global_array(x, mesh: Mesh, *, process_local: bool = False,
                      device=None) -> torch.Tensor:
    """This rank's rows of a leading-axis-sharded array, on ``device``.

    ``process_local=False``: ``x`` is the host-global array and the rank
    takes its :func:`process_rows` slice. ``process_local=True``: ``x`` is
    already this rank's slice, read by a per-rank loader, and goes to the
    device as it is. The port holds no global array object: a rank's
    tensor is its shard."""
    if not process_local:
        lo, hi = process_rows(mesh, len(x))
        x = x[lo:hi]
    return torch.as_tensor(np.asarray(x)).to(resolve_device(device))


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of ``x`` over ``group``, outside autograd; ``x`` itself for None."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def is_main_process() -> bool:
    """Rank 0, or a process without a group: the one writer of files on a
    shared filesystem."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def write_once(write: Callable[[], object]) -> None:
    """``write()`` on the main process only; then every rank meets, so that
    a read after this call sees the file."""
    if is_main_process():
        write()
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


# the mesh of a model built without one: 1 × 1, no groups
ONE_BY_ONE = Mesh(MeshConfig().axis_names, (1, 1), (0, 0), (None, None))

"""Data-parallel wiring for the pipelines.

Counterpart of ``genrec_tpu/parallel/auto.py``. On one process without a
process group it returns None and every pipeline runs on its one device as
before; under a group it returns the mesh the Trainer runs data-parallel
over.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from genrec_tpu_torch.configs import MeshConfig
from genrec_tpu_torch.parallel.mesh import Mesh, make_mesh

DENSE_TP = "ROADMAP Queue 1 item 4b (dense tensor parallelism)"


def dp_shardings(mesh_cfg: Optional[MeshConfig] = None) -> Optional[Mesh]:
    """The mesh of ``mesh_cfg`` over the process group; None without one.
    JAX returns (mesh, batch sharding, replicated sharding): in the port a
    batch's sharding is its leading dimension over 'data'
    (``sharding.BATCH_SPEC``) and parameters are replicated, so the mesh
    says it all."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return make_mesh(mesh_cfg or MeshConfig())


def param_shardings(mesh: Optional[Mesh]) -> None:
    """None when there is no mesh or its model axis is 1: pure data
    parallelism with replicated parameters. The tensor-parallel layout over
    'model' (T5's d_ff and heads, the parity SASRec's row-sharded item
    table) is not ported: a model axis > 1 raises, before any data is read."""
    if mesh is None or mesh.size("model") <= 1:
        return None
    raise NotImplementedError(
        f"model axis {mesh.size('model')}: the tensor-parallel parameter layout is {DENSE_TP}; "
        "use MeshConfig(model_axis=1)")

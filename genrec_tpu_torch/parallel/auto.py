"""Data- and tensor-parallel wiring for the pipelines.

Counterpart of ``genrec_tpu/parallel/auto.py``. On one process without a
process group ``dp_shardings`` returns None and every pipeline runs on its
one device as before; under a group it returns the mesh the Trainer runs
data-parallel over. ``param_shardings`` gives the tensor-parallel layout
over the mesh's 'model' axis, which the TIGER and SASRec pipelines pass to
the Trainer (``parallel/tensor.py`` holds the collectives it needs).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch.distributed as dist
from torch import nn

from genrec_tpu_torch.configs import MeshConfig
from genrec_tpu_torch.parallel.mesh import Mesh, make_mesh
from genrec_tpu_torch.parallel.sharding import (DEFAULT_RULES, Rules, Spec, _divisible,
                                                match_partition_rules)

_HEADS = re.compile(r"\.(self_attn|cross_attn)\.(q|k|v|o)\.weight$")


def dp_shardings(mesh_cfg: Optional[MeshConfig] = None) -> Optional[Mesh]:
    """The mesh of ``mesh_cfg`` over the process group; None without one.
    JAX returns (mesh, batch sharding, replicated sharding): in the port a
    batch's sharding is its leading dimension over 'data'
    (``sharding.BATCH_SPEC``) and parameters are replicated, so the mesh
    says it all."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return make_mesh(mesh_cfg or MeshConfig())


def param_shardings(mesh: Optional[Mesh], model: nn.Module,
                    rules: Rules = DEFAULT_RULES) -> Optional[Dict[str, Spec]]:
    """The tensor-parallel layout of ``model``'s parameters over the mesh's
    'model' axis: each name's spec from the partition rules (T5's d_ff and
    attention heads, the parity SASRec's row-sharded item table), ``()``
    where a split dimension does not divide the axis, as JAX's
    ``_divisible`` falls back to replication. One narrowing: kernels #1 and
    #2 take whole heads, so an attention's q/k/v/o split only when its head
    count divides the axis, and otherwise the whole attention stays
    replicated (the same math as GSPMD's mid-head split). None when there
    is no mesh or its model axis is 1: pure data parallelism."""
    if mesh is None or mesh.size("model") <= 1:
        return None
    params = dict(model.named_parameters())
    out = {}
    for name, spec in match_partition_rules(rules, params).items():
        whole_heads = not _HEADS.search(name) or model.get_submodule(
            name.rsplit(".", 2)[0]).cfg.num_heads % mesh.size("model") == 0
        out[name] = spec if whole_heads and _divisible(params[name].shape, spec, mesh) else ()
    return out

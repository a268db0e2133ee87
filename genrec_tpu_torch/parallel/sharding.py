"""Partition rules and parameter and batch sharding helpers.

Counterpart of ``genrec_tpu/parallel/sharding.py`` over the port's parameter
names. A spec is a tuple with one mesh axis name (or None) per dimension,
``()`` for a replicated tensor: JAX's ``PartitionSpec`` as a plain tuple.
Flax ``Dense`` kernels are (in, out) and torch ``Linear`` weights (out,
in), so a kernel's spec appears here reversed: the T5 ``wi`` kernel's
``P(None, 'model')`` (d_ff over 'model') is ``('model', None)`` on
``ff.wi.weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from genrec_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# Row-shard the big embedding tables and split T5's d_ff and attention
# heads over 'model'; everything else replicated.
DEFAULT_RULES: Rules = (
    (r"(^|\.)item_emb\.weight$", ("model", None)),  # parity SASRec's PaddedEmbed
    (r"(^|\.)item_table$", ("model", None)),        # SASRecLarge's row-sharded table
    (r"(^|\.)shared\.weight$", (None, None)),       # tiny vocab (64): replicate
    (r"(^|\.)codebooks\.\d+$", (None, None)),       # small codebooks: replicate
    (r"\.ff\.wi\.weight$", ("model", None)),        # (d_ff, d_model)
    (r"\.ff\.wo\.weight$", (None, "model")),        # (d_model, d_ff)
    (r"\.(self_attn|cross_attn)\.(q|k|v)\.weight$", ("model", None)),
    (r"\.(self_attn|cross_attn)\.o\.weight$", (None, "model")),
    (r".*", ()),
)

BATCH_SPEC: Spec = ("data",)   # batches: the leading dimension over 'data'


def match_partition_rules(rules: Rules, params: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    """The spec of each named tensor (``model.named_parameters()`` or a
    state_dict) from the first rule whose regex finds its name; scalars and
    one-element tensors are replicated. A name no rule matches raises."""
    out = {}
    for name, t in params.items():
        if t.dim() == 0 or t.numel() == 1:
            out[name] = ()
            continue
        for rule, spec in rules:
            if re.search(rule, name):
                out[name] = spec  # non-dividing axes are dropped in shard_params
                break
        else:
            raise ValueError(f"no partition rule for {name}")
    return out


def _divisible(shape, spec: Spec, mesh: Mesh) -> bool:
    return all(axis is None or dim % mesh.size(axis) == 0 for dim, axis in zip(shape, spec))


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: each named dimension cut
    into the axis's size equal blocks, the rank's index picking one. The
    whole tensor when a named dimension does not divide its axis."""
    if not _divisible(t.shape, spec, mesh):
        return t
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            t = t.chunk(mesh.size(axis), dim)[mesh.index(axis)]
    return t


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 rules: Rules = DEFAULT_RULES) -> Dict[str, torch.Tensor]:
    """Every tensor of ``params`` cut to this rank's shard by the matched
    rules (replicated where a dimension does not divide its mesh axis)."""
    specs = match_partition_rules(rules, params)
    return {k: shard_tensor(v, specs[k], mesh).contiguous() for k, v in params.items()}


def shard_batch(batch: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: the leading dimension over
    'data' (:data:`BATCH_SPEC`), in equal blocks."""
    return {k: shard_tensor(v, BATCH_SPEC, mesh) for k, v in batch.items()}

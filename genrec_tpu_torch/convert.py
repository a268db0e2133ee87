"""Weight bridge from the reference's Flax parameter trees to the port.

``tiger_params_from_flax`` takes the variables of a Flax ``TIGER`` (the
dict ``TIGER.init`` returns, ``{"params": {"model": ...}}``) as a nested
dict of numpy arrays and returns the state_dict of the port's
``models.tiger.TIGER`` at the same config. The mapping:

- ``Dense.kernel`` (in, out) → ``Linear.weight`` (out, in), transposed;
- ``Embed.embedding`` → ``Embedding.weight``;
- RMSNorm ``weight`` and ``rel_embedding`` (buckets, heads) as they are;
- Flax ``block_<i>`` → torch ``blocks.<i>``.

It is strict: every Flax leaf is consumed, every torch entry is filled,
and every shape is checked against the port's module; anything else raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from genrec_tpu_torch.configs import TIGERConfig


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _torch_key(flax_path: str) -> str:
    """'params/model/encoder/block_0/self_attn/q/kernel' →
    'model.encoder.blocks.0.self_attn.q.weight'."""
    parts = flax_path.split("/")
    if parts[0] != "params":
        raise KeyError(f"{flax_path}: Flax variables must sit under 'params'")
    out = []
    for p in parts[1:]:
        if p.startswith("block_") and p[len("block_"):].isdigit():
            out += ["blocks", p[len("block_"):]]
        elif p in ("kernel", "embedding"):
            out.append("weight")
        else:
            out.append(p)
    return ".".join(out)


def tiger_params_from_flax(tree: Mapping, cfg: Optional[TIGERConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flax TIGER variables (nested numpy dict) → the port's TIGER state_dict."""
    from genrec_tpu_torch.models.tiger import TIGER

    cfg = cfg or TIGERConfig()
    with torch.device("meta"):
        expected = {k: v.shape for k, v in TIGER(cfg).state_dict().items()}
    leaves = _flatten(tree)
    state: Dict[str, torch.Tensor] = {}
    for path, arr in leaves.items():
        key = _torch_key(path)
        if key not in expected:
            raise KeyError(f"Flax leaf {path} has no counterpart ({key}) in the port")
        if key in state:
            raise KeyError(f"two Flax leaves map to {key}")
        if path.endswith("/kernel"):
            if arr.ndim != 2:
                raise ValueError(f"{path}: Dense kernel must be 2-D, got {arr.shape}")
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[key]):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} does not fit {key} "
                             f"{tuple(expected[key])}")
        state[key] = torch.tensor(np.asarray(arr, dtype=np.float32))  # a copy
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"the Flax tree leaves these port parameters unfilled: {missing}")
    return state

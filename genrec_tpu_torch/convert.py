"""Weight bridge from the reference's Flax parameter trees to the port.

Each converter takes the variables of a Flax model (the dict its ``init``
returns, ``{"params": ...}``) as a nested dict of numpy arrays and returns
the state_dict of the port's module at the same config:
``tiger_params_from_flax`` (``models.tiger.TIGER``),
``tiger_prefix_params_from_flax`` (``models.tiger_prefix.TIGERPrefix``),
``rqvae_params_from_flax`` (``models.rqvae.RQVAE``),
``dense_t5_params_from_flax`` (``models.dense_t5.DenseT5``),
``sasrec_params_from_flax`` (``models.sasrec.SASRec``) and
``sasrec_large_params_from_flax`` (``models.sasrec_large.SASRecLarge``).
The mapping:

- ``Dense.kernel`` (in, out) → ``Linear.weight`` (out, in), transposed;
- ``Embed.embedding`` → ``Embedding.weight``; LayerNorm ``scale`` →
  ``weight``; RMSNorm ``weight``, ``rel_embedding`` (buckets, heads) and
  SASRecLarge's raw ``item_table`` (V+1, D) as they are;
- Flax ``block_<i>`` (T5) and ``blocks_<i>`` (SASRec) → torch ``blocks.<i>``;
- SASRecBlock's auto-named ``Dense_0..5`` and ``LayerNorm_0/1`` → the
  port's ``q``, ``k``, ``v``, ``out``, ``ff_in``, ``ff_out``, ``attn_norm``
  and ``ff_norm``;
- RQ-VAE's ``MLPStack`` ``Dense_<i>`` → ``layers.<i>``, and ``codebook_<i>``
  → ``codebooks.<i>`` as stored: the centers plus 1/n_e, the shift that
  ``RQVAE.codebook`` takes off again;
- TIGER-prefix's ``adapter_lvl{1,2,3}`` keep their names and submodules
  (``bert_proj``, ``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``,
  ``ffn_in``, ``ffn_out``, ``norm1``, ``norm2``).

It is strict: every Flax leaf is consumed, every torch entry is filled,
and every shape is checked against the port's module; anything else raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from genrec_tpu_torch.configs import (DenseT5Config, RQVAEConfig, SASRecConfig,
                                      SASRecLargeConfig, TIGERConfig, TIGERPrefixConfig)

# SASRecBlock's Flax submodules are auto-named in call order (sasrec.py:48-68)
_SASREC_BLOCK_NAMES = {"Dense_0": "q", "Dense_1": "k", "Dense_2": "v", "Dense_3": "out",
                       "Dense_4": "ff_in", "Dense_5": "ff_out",
                       "LayerNorm_0": "attn_norm", "LayerNorm_1": "ff_norm"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _torch_key(flax_path: str, rename: Optional[Mapping[str, str]] = None) -> str:
    """'params/model/encoder/block_0/self_attn/q/kernel' →
    'model.encoder.blocks.0.self_attn.q.weight';
    'params/blocks_1/LayerNorm_0/scale' with SASRec's ``rename`` →
    'blocks.1.attn_norm.weight'."""
    parts = flax_path.split("/")
    if parts[0] != "params":
        raise KeyError(f"{flax_path}: Flax variables must sit under 'params'")
    out = []
    for p in parts[1:]:
        stem, _, index = p.rpartition("_")
        if stem in ("block", "blocks") and index.isdigit():
            out += ["blocks", index]
        elif p in ("kernel", "embedding", "scale"):
            out.append("weight")
        else:
            out.append((rename or {}).get(p, p))
    return ".".join(out)


def _state_from_flax(tree: Mapping, module: torch.nn.Module,
                     rename: Optional[Mapping[str, str]] = None) -> Dict[str, torch.Tensor]:
    """The strict mapping of the Flax ``tree`` onto ``module``'s state_dict
    (``module`` may live on the meta device: only its shapes are read)."""
    expected = {k: v.shape for k, v in module.state_dict().items()}
    leaves = _flatten(tree)
    state: Dict[str, torch.Tensor] = {}
    for path, arr in leaves.items():
        key = _torch_key(path, rename)
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


def tiger_params_from_flax(tree: Mapping, cfg: Optional[TIGERConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flax TIGER variables (nested numpy dict) → the port's TIGER state_dict."""
    from genrec_tpu_torch.models.tiger import TIGER

    with torch.device("meta"):
        module = TIGER(cfg or TIGERConfig())
    return _state_from_flax(tree, module)


def tiger_prefix_params_from_flax(tree: Mapping, cfg: Optional[TIGERPrefixConfig] = None
                                  ) -> Dict[str, torch.Tensor]:
    """Flax TIGERPrefix variables → the port's TIGERPrefix state_dict: the
    T5 as for TIGER, and the three adapters under their Flax names."""
    from genrec_tpu_torch.models.tiger_prefix import TIGERPrefix

    with torch.device("meta"):
        module = TIGERPrefix(cfg or TIGERPrefixConfig())
    return _state_from_flax(tree, module)


def rqvae_params_from_flax(tree: Mapping, cfg: Optional[RQVAEConfig] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flax RQVAE variables → the port's RQVAE state_dict, the codebooks as
    stored (centers + 1/n_e)."""
    from genrec_tpu_torch.models.rqvae import RQVAE

    cfg = cfg or RQVAEConfig()
    rename = {f"Dense_{i}": f"layers.{i}" for i in range(len(cfg.layers) + 1)}
    rename.update({f"codebook_{i}": f"codebooks.{i}" for i in range(len(cfg.num_emb_list))})
    with torch.device("meta"):
        module = RQVAE(cfg)
    return _state_from_flax(tree, module, rename)


def dense_t5_params_from_flax(tree: Mapping, cfg: Optional[DenseT5Config] = None
                              ) -> Dict[str, torch.Tensor]:
    """Flax DenseT5 variables → the port's DenseT5 state_dict: the encoder
    stack under ``encoder.encoder`` (no ``shared`` embedding, as in the Flax
    tree), and ``input_proj`` / ``output_proj`` with their kernels
    transposed and their biases as they are."""
    from genrec_tpu_torch.models.dense_t5 import DenseT5

    with torch.device("meta"):
        module = DenseT5(cfg or DenseT5Config())
    return _state_from_flax(tree, module)


def sasrec_params_from_flax(tree: Mapping, item_num: int,
                            cfg: Optional[SASRecConfig] = None) -> Dict[str, torch.Tensor]:
    """Flax SASRec variables → the port's SASRec state_dict."""
    from genrec_tpu_torch.models.sasrec import SASRec

    with torch.device("meta"):
        module = SASRec(item_num, cfg or SASRecConfig())
    return _state_from_flax(tree, module, _SASREC_BLOCK_NAMES)


def sasrec_large_params_from_flax(tree: Mapping, item_num: int, cfg: SASRecLargeConfig
                                  ) -> Dict[str, torch.Tensor]:
    """Flax SASRecLarge variables → the port's single-device SASRecLarge
    state_dict (the raw ``item_table`` as it is)."""
    from genrec_tpu_torch.models.sasrec_large import SASRecLarge

    with torch.device("meta"):
        module = SASRecLarge(item_num, cfg, use_sharded=False)
    return _state_from_flax(tree, module, _SASREC_BLOCK_NAMES)

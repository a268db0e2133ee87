"""Faults planted in the DeepSeek-V2 program (``models/deepseek_v2.py``) for
the correctness check's calibration (``calibrate_lm.py``) and its tests:
each must make a run come out not correct.

- ``top5``: the router keeps one expert fewer than ``num_experts_per_tok``;
- ``no_shared``: the shared experts left out of the MoE's sum;
- ``no_mscale``: YaRN's mscale² left out of the attention's softmax scale;
- ``no_reorder``: the latent cache's generated slots not reordered by the
  beams' parents;
- ``rope_padded``: the prompt's rope positions counted over its padded
  width (real tokens start at the padding's count), while the decode steps
  count real tokens: each padded prompt's generated positions sit that
  many positions too close to it.
"""

from __future__ import annotations

import contextlib

FAULTS = ("top5", "no_shared", "no_mscale", "no_reorder", "rope_padded")


def _patches(ds, name):
    if name == "top5":
        route = ds.route
        return [(ds, "route", lambda x, w, k, s: route(x, w, k - 1, s))]
    if name == "no_shared":
        return [(ds.MoE, "shared", lambda self, x: None)]
    if name == "no_mscale":
        return [(ds, "softmax_scale",
                 lambda cfg: (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5)]
    if name == "no_reorder":
        return [(ds.LatentCache, "reorder", lambda self, parents: None)]
    if name == "rope_padded":
        import torch

        return [(ds, "prompt_positions",
                 lambda mask: torch.arange(mask.shape[1], device=mask.device).expand(mask.shape))]
    raise KeyError(name)


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` while the block runs (build the model
    inside it: ``no_mscale`` acts when the attention is made)."""
    from genrec_tpu_torch.models import deepseek_v2 as ds

    patches = _patches(ds, name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, new in patches:
        setattr(obj, attr, new)
    try:
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)

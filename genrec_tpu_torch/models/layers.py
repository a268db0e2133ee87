"""Shared building blocks of the port: counterpart of
``genrec_tpu/models/layers.py``'s ``PaddedEmbed``, with the Flax dropout and
the Flax initialisers the port's models use.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Flax ``nn.Dropout``: keep each element with probability 1 − rate and
    divide the kept ones by 1 − rate; the identity at rate 0. The mask is
    drawn from ``generator``, never the global RNG."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def dense(d_in: int, d_out: int, generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` with Flax ``nn.Dense``'s initialisation: a lecun-normal
    kernel (a normal truncated at ±2σ, scaled to variance 1/fan_in) and a
    zero bias."""
    layer = nn.Linear(d_in, d_out)
    std = math.sqrt(1.0 / d_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        layer.bias.zero_()
    return layer


class PaddedEmbed(nn.Module):
    """Embedding table whose row 0 acts as ``padding_idx=0`` (torch
    semantics: zero vector, zero gradient), as used at `SASRec/model.py:18`:
    the gathered rows are multiplied by (ids != 0), so row 0's gradient is
    zero through the product, as in the reference."""

    def __init__(self, num_embeddings: int, features: int,
                 init_stddev: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = 1.0 / math.sqrt(features) if init_stddev is None else init_stddev
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        return out * (ids != 0)[..., None].to(out.dtype)

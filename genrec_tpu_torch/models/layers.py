"""Shared building blocks of the port: counterpart of
``genrec_tpu/models/layers.py``'s ``MLPStack`` and ``PaddedEmbed``, with the
Flax dropout and the Flax initialisers the port's models use.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], *,
            cols: Optional[Tuple[int, int]] = None):
    """Flax ``nn.Dropout``: keep each element with probability 1 − rate and
    divide the kept ones by 1 − rate, in ``x``'s dtype: as in Flax's
    ``x / keep_prob``, 1 − rate is first rounded to that dtype (0.8984375 for
    a bf16 ``x`` at rate 0.1); the identity at rate 0. The mask is drawn from
    ``generator``, never the global RNG. With ``cols`` = (first, width),
    ``x`` holds the last-axis columns [first, first + x.shape[-1]) of a
    tensor ``width`` wide (a tensor-parallel shard): the whole tensor's mask
    is drawn and those columns kept, so the shard is dropped as the whole
    tensor would be and the generator advances as far."""
    if rate == 0.0:
        return x
    shape = x.shape if cols is None else (*x.shape[:-1], cols[1])
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if cols is not None:
        keep = keep[..., cols[0]:cols[0] + x.shape[-1]]
    keep_prob = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / keep_prob, 0.0)


def _truncated_normal_(w: torch.Tensor, variance: float,
                       generator: Optional[torch.Generator]) -> None:
    """Flax's variance-scaling "truncated_normal": a normal truncated at
    ±2σ, with σ set so that the truncated law has ``variance``."""
    std = math.sqrt(variance) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def dense(d_in: int, d_out: int, generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` with Flax ``nn.Dense``'s initialisation: a lecun-normal
    kernel (a normal truncated at ±2σ, scaled to variance 1/fan_in) and a
    zero bias."""
    layer = nn.Linear(d_in, d_out)
    _truncated_normal_(layer.weight, 1.0 / d_in, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLPStack(nn.Module):
    """Dropout→Linear(→ReLU) stack, equivalent of `RQ-VAE/models/layers.py:7-43`:
    dropout before every Linear, the first one included; xavier-normal
    weights (Flax's truncated form) and zero biases; a ReLU between layers
    and none after the last. ``layers.<i>`` holds the Flax ``Dense_<i>``.
    Dropout runs in training mode unless ``deterministic``, its masks drawn
    from ``generator``."""

    def __init__(self, d_in: int, dims: Sequence[int], dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        sizes = [d_in, *dims]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes, sizes[1:]))
        for layer in self.layers:
            fan_in, fan_out = layer.in_features, layer.out_features
            _truncated_normal_(layer.weight, 2.0 / (fan_in + fan_out), generator)
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, x, generator: Optional[torch.Generator] = None, *,
                deterministic: bool = False):
        rate = self.dropout if self.training and not deterministic else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("training-mode dropout draws its masks from a torch.Generator: "
                             "pass generator=..., or call .eval()")
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(dropout(x, rate, generator))
            if i != last:
                x = F.relu(x)
        return x


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

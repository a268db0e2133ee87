"""RQ-VAE: an MLP autoencoder with a residual vector quantizer.

Counterpart of ``genrec_tpu/models/rqvae.py`` (semantics of
`RQ-VAE/models/{rqvae,rq,vq}.py`):
- encoder [in_dim, *layers, e_dim] and the mirrored decoder (``MLPStack``:
  xavier weights, ReLU, dropout before every Linear);
- a chain of VQ levels over successive residuals; per level, L2
  nearest-code assignment, or with Sinkhorn (center-scaled distances →
  Sinkhorn → argmax) where the level's ``sk_epsilon`` > 0; the
  straight-through estimator; loss = codebook + β·commitment, each a mean
  over the rows of ``row_mask``; rq_loss = the mean over levels;
- total loss = recon (mse or l1, masked the same way) + quant_loss_weight·rq_loss.

Codebook ``codebooks.<i>`` holds what the reference stores: the centers
plus 1/n_e (its uniform [0, 2/n_e) init shifted at use to (−1/n_e, 1/n_e));
:meth:`RQVAE.codebook` subtracts the shift. :func:`kmeans_init_codebooks`
fits every level with k-means, level by level, before training.

Dropout runs in training mode (``.train()``) with masks drawn from the
``generator`` passed to ``forward``; ``get_indices`` and ``encode`` never
drop.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from genrec_tpu_torch.configs import RQVAEConfig
from genrec_tpu_torch.models.layers import MLPStack
from genrec_tpu_torch.ops.sinkhorn import center_distance, kmeans, sinkhorn


def _sq_distances(latent: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., B, D) × (K, D) → (..., B, K) squared L2 (`RQ-VAE/models/vq.py:71-73`)."""
    return ((latent ** 2).sum(-1, keepdim=True) + (codebook ** 2).sum(1)
            - 2.0 * (latent @ codebook.T))


def _masked_mean(per_row: torch.Tensor, row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of (B,) per-row losses; ``row_mask=None`` is a plain mean."""
    if row_mask is None:
        return per_row.mean()
    w = row_mask.to(per_row.dtype)
    return (per_row * w).sum() / w.sum().clamp(min=1.0)


class RQVAE(nn.Module):
    def __init__(self, cfg: RQVAEConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = MLPStack(cfg.in_dim, tuple(cfg.layers) + (cfg.e_dim,), cfg.dropout,
                                generator)
        self.decoder = MLPStack(cfg.e_dim, tuple(reversed(cfg.layers)) + (cfg.in_dim,),
                                cfg.dropout, generator)
        self.codebooks = nn.ParameterList()
        for n_e in cfg.num_emb_list:
            cb = torch.empty(n_e, cfg.e_dim)
            with torch.no_grad():
                cb.uniform_(0.0, 2.0 / n_e, generator=generator)
            self.codebooks.append(nn.Parameter(cb))

    def codebook(self, level: int) -> torch.Tensor:
        return self.codebooks[level] - 1.0 / self.cfg.num_emb_list[level]

    def assign(self, distances: torch.Tensor, level: int, use_sk: bool) -> torch.Tensor:
        """Code indices of one level from its (..., B, K) distances: Sinkhorn's
        argmax when ``use_sk`` and the level's epsilon > 0, else argmin."""
        eps = self.cfg.sk_epsilons[level]
        if use_sk and eps > 0:
            q = sinkhorn(center_distance(distances), eps, self.cfg.sk_iters)
            return torch.argmax(q, dim=-1)
        return torch.argmin(distances, dim=-1)

    def _quantize_level(self, residual, level: int, use_sk: bool, row_mask):
        cb = self.codebook(level)
        with torch.no_grad():
            indices = self.assign(_sq_distances(residual, cb), level, use_sk)
        x_q = cb[indices]
        codebook_sq = ((x_q - residual.detach()) ** 2).mean(-1)
        commit_sq = ((x_q.detach() - residual) ** 2).mean(-1)
        loss = _masked_mean(codebook_sq + self.cfg.beta * commit_sq, row_mask)
        x_q = residual + (x_q - residual).detach()  # straight-through (vq.py:95)
        return x_q, loss, indices

    def rq(self, z, use_sk: bool = True, row_mask=None):
        """Residual quantization chain (`RQ-VAE/models/rq.py:43-55`):
        (x_q, mean of the levels' losses, (..., B, L) indices)."""
        x_q = torch.zeros_like(z)
        residual = z
        losses: List[torch.Tensor] = []
        indices: List[torch.Tensor] = []
        for level in range(len(self.cfg.num_emb_list)):
            x_res, loss, idx = self._quantize_level(residual, level, use_sk, row_mask)
            residual = residual - x_res
            x_q = x_q + x_res
            losses.append(loss)
            indices.append(idx)
        return x_q, torch.stack(losses).mean(), torch.stack(indices, dim=-1)

    def forward(self, x, *, use_sk: bool = True, row_mask=None,
                generator: Optional[torch.Generator] = None):
        """(reconstruction, rq_loss, indices); dropout in training mode."""
        z = self.encoder(x, generator)
        x_q, rq_loss, indices = self.rq(z, use_sk=use_sk, row_mask=row_mask)
        return self.decoder(x_q, generator), rq_loss, indices

    @torch.no_grad()
    def get_indices(self, x, *, use_sk: bool = False) -> torch.Tensor:
        """Greedy (or Sinkhorn) code assignment (`RQ-VAE/models/rqvae.py:67-71`)
        of a (B, in_dim) batch or a (G, B, in_dim) stack of groups, each
        group balanced on its own."""
        _, _, indices = self.rq(self.encode(x), use_sk=use_sk)
        return indices

    def encode(self, x):
        return self.encoder(x, deterministic=True)

    def compute_loss(self, out, rq_loss, x, row_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """total = recon + quant_loss_weight·rq (`RQ-VAE/models/rqvae.py:73-83`);
        ``row_mask`` (B,) keeps pad rows out of every mean."""
        if self.cfg.loss_type == "mse":
            recon = _masked_mean(((out - x) ** 2).mean(-1), row_mask)
        elif self.cfg.loss_type == "l1":
            recon = _masked_mean((out - x).abs().mean(-1), row_mask)
        else:
            raise ValueError(self.cfg.loss_type)
        return recon + self.cfg.quant_loss_weight * rq_loss, recon


@torch.no_grad()
def kmeans_init_codebooks(model: RQVAE, data: torch.Tensor, *,
                          firsts: Optional[Sequence[int]] = None,
                          generator: Optional[torch.Generator] = None) -> None:
    """Level-by-level k-means init of every codebook from ``data``, in place.

    Mirrors the reference's first-training-batch init (`vq.py:40-49,66-68`):
    each level's centers are fit on the residual left by the levels before
    it. ``firsts`` gives each level's first k-means center; else each is
    drawn from ``generator``."""
    cfg = model.cfg
    residual = model.encode(data)
    for level, n_e in enumerate(cfg.num_emb_list):
        centers = kmeans(residual, n_e, cfg.kmeans_iters,
                         first=None if firsts is None else int(firsts[level]),
                         generator=generator)
        # the stored parameter is centers + 1/n_e: codebook() gives the centers back
        model.codebooks[level].copy_(centers + 1.0 / n_e)
        idx = torch.argmin(_sq_distances(residual, centers), dim=-1)
        residual = residual - centers[idx]


def collision_rate(indices) -> float:
    """Fraction of items sharing a full code string
    (`RQ-VAE/train.py:126-151` validation metric)."""
    arr = np.asarray(indices)
    n = len(arr)
    uniq = len(np.unique(arr, axis=0))
    return (n - uniq) / max(n, 1)

"""Sinkhorn-Knopp balanced assignment and k-means on the device.

Counterpart of ``genrec_tpu/ops/sinkhorn.py``, which replaces the
reference's host-side pieces (`RQ-VAE/models/layers.py:69-108`): the
Sinkhorn of the reference's float64 torch code runs in float32 in the log
domain, and its sklearn KMeans becomes Lloyd iterations with a
farthest-point init. Both are plain tensor code (no hand kernel: the
reference runs them as plain XLA too).

:func:`center_distance` and :func:`sinkhorn` take a (B, K) matrix or a
stack (..., B, K) of them and normalize each matrix of the stack on its
own: its max and min, its row and column sums. That is what the reference's
``vmap`` over collision groups computes (``rqvae_pipeline.py:58-72``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def center_distance(distances: torch.Tensor) -> torch.Tensor:
    """Scale distances to ~[-1, 1] before Sinkhorn (RQ-VAE/models/vq.py:55-62),
    by the max and min of each (B, K) matrix."""
    max_d = distances.amax(dim=(-2, -1), keepdim=True)
    min_d = distances.amin(dim=(-2, -1), keepdim=True)
    middle = (max_d + min_d) / 2
    amplitude = max_d - middle + 1e-5
    return (distances - middle) / amplitude


def sinkhorn(distances: torch.Tensor, epsilon: float, iterations: int) -> torch.Tensor:
    """Balanced assignment matrix Q from a (..., B, K) distance matrix.

    The math of `RQ-VAE/models/layers.py:85-108` (exp(-d/eps), a global
    normalization, then alternating row (per sample, /B) and column (per
    prototype, /K) renormalizations; returned scaled by B so that rows are
    distributions), in the log domain: at the reference's eps = 0.01,
    exp(-d/eps) spans e^±100, which overflows f32, and then near-identical
    rows never split and collision repair silently does nothing.
    ``logsumexp`` keeps the whole range in f32."""
    b, k = distances.shape[-2], distances.shape[-1]
    logq = -distances / epsilon
    logq = logq - torch.logsumexp(logq.flatten(-2), dim=-1)[..., None, None]
    log_b, log_k = math.log(b), math.log(k)
    for _ in range(iterations):
        logq = logq - torch.logsumexp(logq, dim=-1, keepdim=True) - log_b
        logq = logq - torch.logsumexp(logq, dim=-2, keepdim=True) - log_k
    return torch.exp(logq + log_b)


def _pairwise_sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, D) × (K, D) → (N, K) squared L2 by the expansion
    |x|² + |c|² − 2·x·c."""
    return ((x * x).sum(1, keepdim=True) + (centers * centers).sum(1)[None, :]
            - 2.0 * (x @ centers.T))


def kmeans(x: torch.Tensor, num_clusters: int, num_iters: int = 10, *,
           first: Optional[int] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Lloyd k-means; returns (num_clusters, D) centers on ``x``'s device.

    Init: the first center is row ``first`` (drawn uniformly from
    ``generator`` when not given, the one random draw of the reference's
    ``kmeans``), then greedy farthest-point; both steps and the Lloyd
    iterations are deterministic, ties going to the first index as in JAX."""
    n, d = x.shape
    x = x.float()
    if first is None:
        first = int(torch.randint(0, n, (), generator=generator))
    centers = torch.zeros(num_clusters, d, dtype=torch.float32, device=x.device)
    centers[0] = x[first]
    for i in range(1, num_clusters):
        mind = _pairwise_sq_dists(x, centers[:i]).amin(dim=1)
        centers[i] = x[torch.argmax(mind)]
    for _ in range(num_iters):
        assign = torch.argmin(_pairwise_sq_dists(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, num_clusters).float()  # (N, K)
        counts = onehot.sum(0)[:, None]
        new = (onehot.T @ x) / counts.clamp(min=1.0)
        centers = torch.where(counts > 0, new, centers)
    return centers

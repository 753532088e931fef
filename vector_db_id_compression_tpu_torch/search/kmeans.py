"""Batched Lloyd k-means in torch.

Port of the JAX package's ``search/kmeans.py``: assignment is one [n, d] x
[d, k] matrix product per row block, the update a scatter-add. Randomness
comes from an explicit ``torch.Generator`` seeded with ``seed``, so the
centroids are reproducible on one device but are not the JAX package's
(``jax.random`` draws other numbers from the same seed).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve


def assign(x: torch.Tensor, centroids: torch.Tensor, budget: int = 2 ** 28) -> torch.Tensor:
    """Nearest centroid per row (L2) → i64[n]. Blocked over rows so that the
    [rows, k] distance slab stays under ``budget`` float32 elements."""
    n, k = x.shape[0], centroids.shape[0]
    rows = max(1, min(n, budget // max(k, 1)))
    # ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; ||x||^2 is constant per row
    c2 = (centroids * centroids).sum(dim=1)
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    for s in range(0, n, rows):
        out[s:s + rows] = torch.argmin(c2[None, :] - 2.0 * (x[s:s + rows] @ centroids.T), dim=1)
    return out


def _update(x: torch.Tensor, a: torch.Tensor, centroids: torch.Tensor,
            gen: torch.Generator) -> torch.Tensor:
    k = centroids.shape[0]
    sums = torch.zeros_like(centroids).index_add_(0, a, x)
    counts = torch.bincount(a, minlength=k).to(x.dtype)
    # empty clusters: re-seed from random data points
    fallback = x[torch.randint(0, x.shape[0], (k,), generator=gen, device=x.device)]
    return torch.where((counts > 0)[:, None], sums / counts.clamp(min=1.0)[:, None], fallback)


def train_kmeans(x, k: int, niter: int = 20, seed: int = 1234,
                 max_points_per_centroid: int = 256, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Centroids f32[k, d] on ``device`` (the card unless the caller says
    ``device="cpu"``). Training subsamples to
    ``max_points_per_centroid * k`` points (the faiss clustering default),
    with the same numpy draw as the JAX package."""
    device = resolve(device)
    x = np.asarray(x, dtype=np.float32) if not torch.is_tensor(x) else x
    cap = max_points_per_centroid * k
    if len(x) > cap:
        sel = np.random.default_rng(seed).choice(len(x), cap, replace=False)
        x = x[torch.from_numpy(sel)] if torch.is_tensor(x) else x[sel]
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    centroids = x[torch.randperm(x.shape[0], generator=gen, device=x.device)[:k]]
    for _ in range(niter):
        centroids = _update(x, assign(x, centroids), centroids, gen)
    return centroids

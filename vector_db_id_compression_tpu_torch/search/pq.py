"""Product quantizer (PQ) for IVF payload codes, in torch.

Port of the JAX package's ``search/pq.py``: M subspaces x ksub = 256
centroids, trained by k-means per subspace; encode = the nearest centroid
per subspace; decode = a gather of centroids by code; the asymmetric
distance tables (LUTs) hold the squared L2 from each query subvector to
every centroid. The centroids are an f32[M, ksub, dsub] tensor on
``device`` (the card unless the caller says ``device="cpu"``). Training
draws other numbers than the JAX package's k-means (``search/kmeans.py``),
so trained centroids differ between the packages; ``search/ivf.py``
``load_index`` carries the JAX package's across.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve
from .kmeans import assign, train_kmeans


class ProductQuantizer:
    def __init__(self, d: int, M: int, ksub: int = 256, device=DEFAULT_DEVICE):
        if M < 1 or d % M:
            raise ValueError(f"d = {d} must be a multiple of M = {M}")
        if not 1 <= ksub <= 256:
            raise ValueError("ksub must lie in [1, 256]: codes are one byte per subspace")
        self.d, self.M, self.ksub = d, M, ksub
        self.device = resolve(device)
        self.centroids: Optional[torch.Tensor] = None  # f32[M, ksub, dsub]

    @property
    def dsub(self) -> int:
        return self.d // self.M

    @property
    def code_size(self) -> int:
        return self.M  # one byte per subspace

    def _subspaces(self, x: torch.Tensor):
        return x.reshape(x.shape[0], self.M, self.dsub)

    def train(self, x, niter: int = 15, seed: int = 5678):
        """k-means per subspace (``seed + m`` for subspace m) on the rows of
        ``x`` (numpy or tensor, f32[n, d])."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        cents = torch.zeros((self.M, self.ksub, self.dsub), device=self.device)
        k = min(self.ksub, x.shape[0])
        for m in range(self.M):
            sub = x[:, m * self.dsub:(m + 1) * self.dsub]
            cents[m, :k] = train_kmeans(sub, k, niter=niter, seed=seed + m,
                                        device=self.device)
            cents[m, k:] = cents[m, :1]
        self.centroids = cents

    def encode(self, x) -> torch.Tensor:
        """u8[n, M] codes on the quantizer's device; ``assign`` blocks the
        rows so that each [rows, ksub] distance slab stays bounded."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        xs = self._subspaces(x)
        out = torch.empty((x.shape[0], self.M), dtype=torch.uint8, device=self.device)
        for m in range(self.M):
            out[:, m] = assign(xs[:, m], self.centroids[m]).to(torch.uint8)
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Reconstructions f32[..., d] of codes u8[..., M]: the centroid of
        each code, gathered per subspace."""
        codes = torch.as_tensor(codes, device=self.device).long()
        m = torch.arange(self.M, device=self.device)
        return self.centroids[m, codes].reshape(*codes.shape[:-1], self.d)

    def compute_luts(self, xq: torch.Tensor) -> torch.Tensor:
        """Asymmetric distance LUTs f32[nq, M, ksub]: squared L2 from each
        query subvector to every subspace centroid."""
        xs = self._subspaces(torch.as_tensor(xq, dtype=torch.float32, device=self.device))
        c = self.centroids
        dots = torch.einsum("qmd,mkd->qmk", xs, c)
        c2 = (c * c).sum(dim=2)    # [M, ksub]
        x2 = (xs * xs).sum(dim=2)  # [nq, M]
        return x2[:, :, None] - 2.0 * dots + c2[None, :, :]

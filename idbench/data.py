"""The benchmark's inputs, made from ``--seed`` on the device.

A clustered corpus in the manner of the port's ``bench/search_100m.py``
(``_centers_and_assignment``, ``build_clustered``): ``nlist`` Gaussian
centres, each database vector drawn around the centre the generator gave
it, and the centres handed to the index as its centroids, so that set-up
trains no k-means. The draws come from a ``torch.Generator`` on the device,
in a few large calls, and the same seed gives the same tensors, so the
reference makes them again after the window instead of keeping them.

- centres ``center_std * N(0, 1)``, f32[nlist, d];
- list sizes at fixed quantiles of the configuration's
  ``list_size_quantiles`` (``list_sizes``: the skew of a k-means index);
  the seed draws which centre owns which size and which rows each owns,
  each row its centre plus ``noise_std * N(0, 1)``, f32[n, d] (row i has
  id i). Every seed so gives the same set of list sizes but for the few
  rows (about 0.1%) that lie nearer another centre, and with it the same
  size buckets in the port: with the uniform draw of ``search_100m`` the
  longest lists differed by seed, and with them the port's buckets and its
  time a call;
- for PQ payload, ``pq_m`` codebooks of 256 sub-vectors, each a distinct
  database row's sub-vector drawn by the seed, as a k-means initialisation
  draws them, so PQ trains nothing either;
- a pool of queries: database rows drawn by the seed plus
  ``query_noise_std * N(0, 1)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

# rows drawn per call of the generator: bounds the temporary of a draw
CHUNK_ROWS = 1 << 21
KSUB = 256


@dataclass
class Inputs:
    centroids: torch.Tensor            # f32[nlist, d]
    xb: torch.Tensor                   # f32[n, d]
    queries: torch.Tensor              # f32[pool, d]
    codebooks: Optional[torch.Tensor]  # f32[pq_m, 256, d / pq_m] for PQ payload


def list_sizes(n: int, nlist: int, quantiles) -> torch.Tensor:
    """int64[nlist] summing to ``n``, in ascending order: list i takes the
    profile's quantile function (``quantiles`` of size / mean at evenly
    spaced probabilities 0 .. 1, linear between them) at (i + 0.5) / nlist,
    scaled so that the sizes sum to ``n`` (largest remainders get the rest).
    The same for every seed."""
    q = torch.tensor(quantiles, dtype=torch.float64)
    pos = (torch.arange(nlist, dtype=torch.float64) + 0.5) / nlist * (len(q) - 1)
    lo = pos.floor().long().clamp(max=len(q) - 2)
    w = q[lo] + (q[lo + 1] - q[lo]) * (pos - lo)
    share = w * (n / w.sum())
    sizes = share.floor().long()
    sizes[torch.argsort(share - sizes, descending=True, stable=True)[: n - int(sizes.sum())]] += 1
    return sizes


def make_inputs(cfg: dict, seed: int, pool: int, device) -> Inputs:
    """The inputs of configuration ``cfg`` for ``seed``, on ``device``."""
    n, d, nlist = cfg["n"], cfg["d"], cfg["nlist"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cent = torch.randn((nlist, d), generator=g, device=device) * cfg["center_std"]
    sizes = list_sizes(n, nlist, cfg["list_size_quantiles"]).to(device)
    counts = sizes[torch.randperm(nlist, generator=g, device=device)]
    owner = torch.repeat_interleave(torch.arange(nlist, device=device), counts)
    owner = owner[torch.randperm(n, generator=g, device=device)]
    xb = torch.empty((n, d), device=device)
    for s in range(0, n, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, n)
        xb[s:e] = torch.randn((e - s, d), generator=g, device=device)
        xb[s:e].mul_(cfg["noise_std"]).add_(cent[owner[s:e]])
    del owner
    codebooks = None
    if cfg["payload"] == "pq":
        m = cfg["pq_m"]
        dsub = d // m
        rows = torch.randperm(n, generator=g, device=device)[: m * KSUB].view(m, KSUB)
        codebooks = torch.stack([xb[rows[j], j * dsub:(j + 1) * dsub] for j in range(m)])
    src = torch.randint(0, n, (pool,), generator=g, device=device)
    queries = xb[src] + torch.randn((pool, d), generator=g, device=device) * cfg["query_noise_std"]
    return Inputs(cent, xb, queries, codebooks)

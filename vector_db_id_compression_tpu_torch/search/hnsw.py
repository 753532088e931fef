"""HNSW graph build and search.

Port of the JAX package's ``search/hnsw.py``: hierarchical layers with
geometric level assignment (mL = 1/ln M), built by chunked insertion, and
searched by a greedy descent of the upper layers followed by the shared
best-first pool search on layer 0. The level-0 adjacency is a plain
[N, 2M] -1-padded table, so every container of ``store/graph.py`` can stand in
for it (``search(..., graph0=...)``, the reference's replace_final_graph).

The build inserts the points in batches. Each batch descends the upper
layers greedily and runs a best-first pool search on the lower layers against
the current graph; a second pass over the batch then re-links it, now that
its points are inserted, which recovers the edges between points of one
batch. The batched steps of both walks (``_greedy_descend``, ``_ef_search``)
are torch ops on the index's device, one host sync per step. The link
assignment that follows each walk is order-dependent (each point's links
change the rows the next point reads), so it stays a loop over the batch on
the host, as in the JAX package, over the layers held as numpy arrays; it
runs in C++ (``native/hnsw_native.cpp``, g++ at first use), since a Python
loop pays its interpreter cost per point and per friend. The device keeps a
copy of each layer that is refreshed after its links change.

The build is exact against the JAX package: the levels are the same numpy
draws, and every build-time distance is summed in numpy's order
(``_numpy_sum``: pairwise, eight accumulators per block of 128), on either
device, because one ulp changes a neighbour choice. The layers, levels and
entry therefore equal the JAX package's for the same vectors and seed
(tests/test_torch_hnsw.py).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..device import DEFAULT_DEVICE, resolve
from ..store.graph import Graph
from .graph_device import _bit_of, _merge, hnsw_descend_device, search_graph_device

_INF = float("inf")


def _numpy_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of numpy's float32 ``sum``: its
    pairwise summation (sequential below 8 terms; up to 128 terms, eight
    strided accumulators combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)),
    then the tail in turn; above 128, the two halves at a multiple of 8)."""
    n = a.shape[-1]
    if n < 8:
        res = torch.full(a.shape[:-1], -0.0, dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        blocks = a[..., :m].unflatten(-1, (m // 8, 8))
        r = blocks[..., 0, :]
        for i in range(1, m // 8):
            r = r + blocks[..., i, :]
        r = r[..., 0::2] + r[..., 1::2]
        r = r[..., 0::2] + r[..., 1::2]
        res = r[..., 0] + r[..., 1]
        for i in range(m, n):
            res = res + a[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _numpy_sum(a[..., :n2]) + _numpy_sum(a[..., n2:])


def _build_dists(xq: torch.Tensor, xb: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Build-time distances f32[B, K] from each query to its candidate nodes
    i64[B, K] (-1 → inf), equal bit for bit to the JAX package's
    ``_dists_host`` (numpy) on the same vectors."""
    diff = xb[nodes.clamp(min=0)] - xq[:, None, :]
    return torch.where(nodes >= 0, _numpy_sum(diff * diff), _INF)


class HNSW:
    """HNSW index over ``xb`` (``build``) on ``device``: the card unless the
    caller says ``device="cpu"``. ``levels`` i32[N] and ``layers`` (one
    i32[N, cap] adjacency per level, cap 2M at level 0 and M above) are host
    numpy arrays, as the JAX package's; the vectors and the search run on
    the device."""

    # peak-memory cap for the per-call visited bitset (B x ceil(N/32) words):
    # past it, _ef_search splits the batch, as the JAX package does
    _VISITED_BUDGET_BYTES = 1 << 28

    def __init__(self, M: int = 16, ef_construction: int = 40, seed: int = 1234,
                 device=DEFAULT_DEVICE):
        if M < 2:
            raise ValueError(f"HNSW needs M >= 2 (mL = 1/ln(M)); got M={M}")
        self.device = resolve(device)
        self.M = M
        self.Mmax0 = 2 * M
        self.mL = 1.0 / math.log(M)
        self.ef_construction = max(ef_construction, M)
        self.seed = seed
        self.levels: Optional[np.ndarray] = None
        self.layers: List[np.ndarray] = []
        self.entry: int = 0
        self.max_level: int = -1
        self._xb: Optional[torch.Tensor] = None       # f32[N, d] on the device
        self._xb_host: Optional[np.ndarray] = None    # the same, for the link loop
        self._layers_dev: List[torch.Tensor] = []
        self._graph0: Optional[Graph] = None
        self._descend_tree = None

    def _set_vectors(self, xb) -> None:
        self._xb = torch.as_tensor(xb, dtype=torch.float32, device=self.device).contiguous()
        self._xb_host = self._xb.cpu().numpy()
        self._graph0 = None
        self._descend_tree = None

    @classmethod
    def from_arrays(cls, levels, layers, entry: int, max_level: int, M: int,
                    ef_construction: int, seed: int, xb, device=DEFAULT_DEVICE) -> "HNSW":
        """An index holding a built state (as numpy arrays: another HNSW's,
        the JAX package's, or a file's) over the vectors ``xb``."""
        h = cls(M=M, ef_construction=ef_construction, seed=seed, device=device)
        h.levels = np.asarray(levels, dtype=np.int32)
        h.layers = [np.array(layer, dtype=np.int32) for layer in layers]
        h.entry, h.max_level = int(entry), int(max_level)
        h._set_vectors(xb)
        h._layers_dev = [torch.from_numpy(layer).to(h.device) for layer in h.layers]
        return h

    # ------------------------------------------------------------------ build

    def build(self, xb, batch: int = 512) -> "HNSW":
        """Insert the rows of ``xb`` (numpy or a tensor, [N, d]) in batches
        of ``batch``, each batch twice (insert, then re-link)."""
        self._set_vectors(xb)
        N = self._xb.shape[0]
        rng = np.random.default_rng(self.seed)
        self.levels = np.minimum(
            np.floor(-np.log(rng.random(N)) * self.mL).astype(np.int32), 31)
        self.max_level = int(self.levels.max())
        self.layers = [
            np.full((N, self.Mmax0 if l == 0 else self.M), -1, dtype=np.int32)
            for l in range(self.max_level + 1)
        ]
        # on the CPU the device copy is a view of the host table
        self._layers_dev = [torch.from_numpy(layer).to(self.device) for layer in self.layers]
        self.entry = int(np.argmax(self.levels))
        inserted = torch.zeros(N, dtype=torch.bool, device=self.device)
        inserted[self.entry] = True
        order = np.arange(N)
        rest = order[order != self.entry]
        for s in range(0, len(rest), batch):
            pts = rest[s:s + batch]
            self._insert_batch(pts, inserted)
            inserted[torch.from_numpy(pts).to(self.device)] = True
            # the first pass could not see the batch's own points; re-link it
            # now that they are inserted
            self._insert_batch(pts, inserted, relink=True)
        return self

    def _greedy_descend(self, pts: np.ndarray, start, level: int, inserted: torch.Tensor,
                        xq=None) -> np.ndarray:
        """One greedy (ef=1) walk per point on ``level`` among the inserted
        nodes, from ``start`` → i64[B] (host). ``xq`` optionally supplies the
        query vectors (tests, oracles); default: the points ``pts``."""
        dev = self.device
        xb = self._xb
        cur = torch.as_tensor(np.asarray(start), dtype=torch.int64, device=dev)
        xq = xb[torch.from_numpy(np.asarray(pts)).to(dev)] if xq is None else \
            torch.as_tensor(xq, dtype=torch.float32, device=dev)
        rows = torch.arange(cur.shape[0], device=dev)
        cur_d = _build_dists(xq, xb, cur[:, None])[:, 0]
        adj = self._layers_dev[level]
        while True:
            nbrs = adj[cur].to(torch.int64)
            valid = (nbrs >= 0) & inserted[nbrs.clamp(min=0)]
            d = torch.where(valid, _build_dists(xq, xb, torch.where(valid, nbrs, 0)), _INF)
            best = torch.argmin(d, dim=1)
            bd = d[rows, best]
            improve = bd < cur_d
            if not bool(improve.any()):
                return cur.cpu().numpy()
            cur = torch.where(improve, nbrs[rows, best], cur)
            cur_d = torch.where(improve, bd, cur_d)

    def _ef_search(self, pts: np.ndarray, start: np.ndarray, level: int, ef: int,
                   inserted: torch.Tensor):
        """Batched best-first pool search of ``ef`` on one layer, among the
        inserted nodes → (ids i64[B, ef], dists f32[B, ef]), -1/inf padded,
        ordered by (distance, id); on the device."""
        B = len(pts)
        N = self._xb.shape[0]
        words = (N + 31) // 32
        chunk = max(1, self._VISITED_BUDGET_BYTES // (4 * words))
        if B > chunk:
            parts = [self._ef_search(pts[i:i + chunk], start[i:i + chunk], level, ef, inserted)
                     for i in range(0, B, chunk)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        dev = self.device
        xb = self._xb
        xq = xb[torch.from_numpy(np.asarray(pts)).to(dev)]
        start = torch.as_tensor(np.asarray(start), dtype=torch.int64, device=dev)
        rows = torch.arange(B, device=dev)
        pool_ids = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
        pool_d = torch.full((B, ef), _INF, dtype=torch.float32, device=dev)
        pool_exp = torch.zeros((B, ef), dtype=torch.bool, device=dev)
        visited = torch.zeros((B, words), dtype=torch.int32, device=dev)
        visited[rows, start // 32] = _bit_of(start)
        pool_ids[:, 0] = start
        pool_d[:, 0] = _build_dists(xq, xb, start[:, None])[:, 0]
        adj = self._layers_dev[level]
        K = adj.shape[1]
        earlier = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
        while True:
            cand = torch.where(pool_exp | (pool_ids < 0), _INF, pool_d)
            sel = torch.argmin(cand, dim=1)
            active = torch.isfinite(cand[rows, sel])
            if not bool(active.any()):
                break
            sel_nodes = torch.where(active, pool_ids[rows, sel], 0)
            pool_exp[rows, sel] |= active
            nbrs = adj[sel_nodes].to(torch.int64)
            v = nbrs.clamp(min=0)
            w = v // 32
            bit = _bit_of(v)
            seen = (visited.gather(1, w) & bit) != 0
            # in-row duplicates: only the first occurrence counts
            dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
            mask = (nbrs >= 0) & inserted[v] & ~seen & ~dup & active[:, None]
            # a row's fresh nodes are distinct and unset: adding their bits
            # sets them
            visited.scatter_add_(1, w, torch.where(mask, bit, 0))
            new_ids = torch.where(mask, nbrs, -1)
            pool_ids, pool_d, pool_exp = _merge(pool_ids, pool_d, pool_exp, new_ids,
                                                _build_dists(xq, xb, new_ids), ef)
        return pool_ids, pool_d

    def _insert_batch(self, pts: np.ndarray, inserted: torch.Tensor, relink: bool = False):
        B = len(pts)
        lvls = self.levels[pts]
        cur = np.full(B, self.entry, dtype=np.int64)
        # descend from the top: greedy on the levels above each point's level
        for l in range(self.max_level, -1, -1):
            above = np.flatnonzero(lvls < l)
            if len(above):
                cur[above] = self._greedy_descend(pts[above], cur[above], l, inserted)
            sub = np.flatnonzero(lvls >= l)
            if not len(sub):
                continue
            ids, _ = self._ef_search(pts[sub], cur[sub], l, self.ef_construction, inserted)
            Mcap = self.Mmax0 if l == 0 else self.M
            out_deg = min(self.M, Mcap)
            # link assignment and reverse links with degree-cap pruning, point
            # by point in batch order, on the host layer (native/hnsw_native.cpp)
            native.hnsw_link(self.layers[l], self._xb_host, pts, sub,
                             ids[:, :out_deg].cpu().numpy(), Mcap, relink, cur)
            if self.device.type != "cpu":
                self._layers_dev[l] = torch.from_numpy(self.layers[l]).to(self.device)

    # ----------------------------------------------------------------- search

    def level0_graph(self) -> Graph:
        """The level-0 adjacency as a ``Graph`` on the index's device."""
        if self._graph0 is None:
            self._graph0 = Graph(self.layers[0], device=self.device)
        return self._graph0

    def search(self, xq, k: int, ef: Optional[int] = None, graph0=None):
        """Descend the upper layers greedily, then pool-search layer 0 with a
        pool of ``ef`` (default 2k) → (D f32[nq, k], I i64[nq, k]) on the
        device, -1 where the pool holds fewer than k nodes. ``graph0``
        optionally substitutes a compressed container for the level-0
        adjacency."""
        xq = torch.as_tensor(xq, dtype=torch.float32, device=self.device)
        cur = hnsw_descend_device(self, xq)
        g0 = graph0 if graph0 is not None else self.level0_graph()
        return search_graph_device(g0, self._xb, xq, k, L=ef or 2 * k, entry=cur)


def get_level0_links(index: HNSW, vno: int) -> np.ndarray:
    """Level-0 friend list of one vertex (graph_static_bench_invlists.py:33-50
    restricted to level 0)."""
    row = index.layers[0][vno]
    return row[row >= 0]

"""Device-resident best-first graph search.

Port of the JAX package's ``search/graph_device.py`` for the dense graph and
every compressed container. The candidate pools, the visited bitsets and the
frontier all live on the graph's device; the JAX ``lax.while_loop`` becomes a
Python loop of torch ops that runs until no query has an unexpanded finite
candidate, capped at ``max_iters`` (one host sync per hop reads that
condition).

The per-hop neighbour fetch is the container's ``get_neighbors_batch``,
one call for the whole frontier. For ``RocGraph`` it runs the ROC decode
kernel over the frontier's lanes, and for ``RocBlockGraph`` the chained
decode kernel over the frontier's blocks, inside the traversal (the reference
decodes inside get_neighbors, altid_impl.cpp:153-165). The JAX package wraps
each fetch in a traceable provider for ``lax.while_loop``; an eager torch
loop needs none.

The results equal the host loop's (search/nsg.py:search_graph): the same pool
discipline, the same (distance, id) lexicographic order, the same in-row
duplicate suppression. A node's distance does not depend on where its
neighbour list put it, so the three containers give identical D and I.

Visited set: one bitset row per query, i32[Q, ceil(N / 32)] holding u32 bit
patterns.

``hnsw_descend_device`` is the HNSW index's upper-layer descent (the JAX
package's ``_descend``): a greedy walk per query from the top level to level
1 over compact per-level adjacency, giving each query its level-0 entry for
``search_graph_device``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch


def _bit_of(v: torch.Tensor) -> torch.Tensor:
    """1 << (v % 32) as the i32 of its u32 bit pattern."""
    return (((1 << (v % 32)) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _merge(pool_ids, pool_d, pool_exp, new_ids, new_d, L: int):
    """The best L of a pool and its new candidates (-1 ids with inf
    distances where empty), in (distance, id) lexicographic order as one
    int64 key: the bits of a non-negative float32 order as its value; an
    empty slot's id sorts last. → (ids, distances, expanded flags)."""
    all_ids = torch.cat([pool_ids, new_ids], dim=1)
    all_d = torch.cat([pool_d, new_d], dim=1)
    all_exp = torch.cat([pool_exp, torch.zeros_like(new_ids, dtype=torch.bool)], dim=1)
    id_key = torch.where(all_ids < 0, 0xFFFFFFFF, all_ids)
    key = (all_d.view(torch.int32).to(torch.int64) << 32) | id_key
    order = torch.argsort(key, dim=1, stable=True)[:, :L]
    return (torch.gather(all_ids, 1, order), torch.gather(all_d, 1, order),
            torch.gather(all_exp, 1, order))


def _search(graph, xb, xq, k: int, L: int, max_iters: int, entry: torch.Tensor):
    """→ (D f32[nq, k], I i64[nq, k], hops run). ``entry`` i64[nq]."""
    K = graph.K
    nq = xq.shape[0]
    N = xb.shape[0]
    dev = xq.device
    rows = torch.arange(nq, device=dev)
    cols = torch.arange(K, device=dev)
    inf = float("inf")

    def dists(nodes):
        diff = xb[nodes.clamp(min=0)] - xq[:, None, :]
        return torch.where(nodes >= 0, (diff * diff).sum(dim=2), inf)

    pool_ids = torch.full((nq, L), -1, dtype=torch.int64, device=dev)
    pool_d = torch.full((nq, L), inf, dtype=torch.float32, device=dev)
    pool_exp = torch.zeros((nq, L), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, (N + 31) // 32), dtype=torch.int32, device=dev)
    pool_ids[:, 0] = entry
    pool_d[:, 0] = dists(entry[:, None])[:, 0]
    visited[rows, entry // 32] = _bit_of(entry)
    earlier = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)

    it = 0
    while it < max_iters:
        cand = torch.where(pool_exp | (pool_ids < 0), inf, pool_d)
        sel = torch.argmin(cand, dim=1)
        active = torch.isfinite(cand[rows, sel])
        if not bool(active.any()):
            break
        sel_nodes = torch.where(active, pool_ids[rows, sel], 0)
        pool_exp[rows, sel] |= active

        nbrs, counts = graph.get_neighbors_batch(sel_nodes)  # [nq, K]
        nbrs = torch.where((cols[None, :] < counts[:, None]) & active[:, None],
                           nbrs.to(torch.int64), -1)
        # visited filter, then in-row duplicate suppression: the first
        # occurrence of a node in the row is kept
        v = nbrs.clamp(min=0)
        w_idx = v // 32
        bit = _bit_of(v)
        seen = (visited.gather(1, w_idx) & bit) != 0
        dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
        fresh = (nbrs >= 0) & ~seen & ~dup
        # fresh nodes of a row are distinct and unset, so adding their bits
        # sets them (integer adds commute: the result is deterministic)
        visited.scatter_add_(1, w_idx, torch.where(fresh, bit, 0))

        new_ids = torch.where(fresh, nbrs, -1)
        pool_ids, pool_d, pool_exp = _merge(pool_ids, pool_d, pool_exp, new_ids,
                                            dists(new_ids), L)
        it += 1
    return pool_d[:, :k], pool_ids[:, :k], it


def _descend(levels_tree, xb, xq, entry: int) -> torch.Tensor:
    """Greedy (ef=1) walk through the upper HNSW layers, top to level 1 →
    i64[nq] level-0 entries. ``levels_tree``: per level, top first, (nodes_l
    i64[N_l] sorted, adj_l i64[N_l, M]), the rows of the nodes at that level;
    the walk only stands on nodes of the level, so the searchsorted row
    lookup always hits. One host sync per step reads whether any query
    moved (the JAX package's ``lax.while_loop`` condition)."""
    nq = xq.shape[0]
    rows = torch.arange(nq, device=xq.device)
    cur = torch.full((nq,), entry, dtype=torch.int64, device=xq.device)
    diff = xb[cur] - xq
    cur_d = (diff * diff).sum(dim=1)
    for nodes_l, adj_l in levels_tree:
        while True:
            row = torch.searchsorted(nodes_l, cur).clamp(max=adj_l.shape[0] - 1)
            nbrs = adj_l[row]                                   # [nq, M]
            diff = xb[nbrs.clamp(min=0)] - xq[:, None, :]
            d = torch.where(nbrs >= 0, (diff * diff).sum(dim=2), float("inf"))
            best = torch.argmin(d, dim=1)
            bd = d[rows, best]
            improve = bd < cur_d
            if not bool(improve.any()):
                break
            cur = torch.where(improve, nbrs[rows, best], cur)
            cur_d = torch.where(improve, bd, cur_d)
    return cur


def hnsw_descend_device(hnsw, xq) -> torch.Tensor:
    """Per-query level-0 entry points of an HNSW index (search/hnsw.py): the
    upper-layer greedy descent on the index's device → i64[nq]. The compact
    per-level adjacency (the rows of the nodes at each level, sorted by id:
    about N / (M - 1) rows in all) is built at the first call and kept on
    the index."""
    xq = torch.as_tensor(xq, dtype=torch.float32, device=hnsw.device)
    if hnsw.max_level <= 0:
        return torch.full((xq.shape[0],), hnsw.entry, dtype=torch.int64, device=hnsw.device)
    if hnsw._descend_tree is None:
        hnsw._descend_tree = [
            (torch.from_numpy(np.flatnonzero(hnsw.levels >= l)).to(hnsw.device),
             torch.from_numpy(hnsw.layers[l][hnsw.levels >= l].astype(np.int64)).to(hnsw.device))
            for l in range(hnsw.max_level, 0, -1)]
    return _descend(hnsw._descend_tree, hnsw._xb, xq, hnsw.entry)


def search_graph_device(graph, xb, xq, k: int, L: Optional[int] = None, entry=0,
                        max_iters: int = 0):
    """Device-resident counterpart of search_graph (host loop): returns
    (D f32[nq, k], I i64[nq, k]) on the graph's device. ``graph`` is a
    ``Graph`` or any container of ``store/graph.py``; pass ``xb`` as a tensor on
    that device to avoid a copy per call. ``entry`` is one node or one per
    query (i64[nq]); ``max_iters`` caps the hops (0 → 4 * L + 32), and a
    search that reaches the cap warns and returns the pools as they stand."""
    dev = graph.device
    xq = torch.as_tensor(xq, dtype=torch.float32, device=dev)
    xb = torch.as_tensor(xb, dtype=torch.float32, device=dev)
    L = max(L or 2 * k, k)
    max_iters = max_iters or (4 * L + 32)
    entries = torch.as_tensor(entry, dtype=torch.int64, device=dev).expand(xq.shape[0])
    D, I, it = _search(graph, xb, xq, k, L, max_iters, entries.contiguous())
    if it >= max_iters:
        # the batched frontier hit the cap before every query's pool
        # converged: results may differ from the host search
        warnings.warn(
            f"search_graph_device stopped at the max_iters={max_iters} cap; "
            "results may be truncated — raise max_iters", RuntimeWarning)
    return D, I

"""Device-resident best-first graph search.

Port of the JAX package's ``search/graph_device.py`` for the dense graph and
the two ROC containers. The candidate pools, the visited bitsets and the
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
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch


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

    def bit_of(v):
        """1 << (v % 32) as the i32 of its u32 bit pattern."""
        return (((1 << (v % 32)) ^ (1 << 31)) - (1 << 31)).to(torch.int32)

    pool_ids = torch.full((nq, L), -1, dtype=torch.int64, device=dev)
    pool_d = torch.full((nq, L), inf, dtype=torch.float32, device=dev)
    pool_exp = torch.zeros((nq, L), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, (N + 31) // 32), dtype=torch.int32, device=dev)
    pool_ids[:, 0] = entry
    pool_d[:, 0] = dists(entry[:, None])[:, 0]
    visited[rows, entry // 32] = bit_of(entry)
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
        bit = bit_of(v)
        seen = (visited.gather(1, w_idx) & bit) != 0
        dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
        fresh = (nbrs >= 0) & ~seen & ~dup
        # fresh nodes of a row are distinct and unset, so adding their bits
        # sets them (integer adds commute: the result is deterministic)
        visited.scatter_add_(1, w_idx, torch.where(fresh, bit, 0))

        new_ids = torch.where(fresh, nbrs, -1)
        all_ids = torch.cat([pool_ids, new_ids], dim=1)
        all_d = torch.cat([pool_d, dists(new_ids)], dim=1)
        all_exp = torch.cat([pool_exp, torch.zeros_like(fresh)], dim=1)
        # (distance, id) lexicographic order as one int64 key: the bits of a
        # non-negative float32 order as its value; an empty slot's id sorts
        # last
        id_key = torch.where(all_ids < 0, 0xFFFFFFFF, all_ids)
        key = (all_d.view(torch.int32).to(torch.int64) << 32) | id_key
        order = torch.argsort(key, dim=1, stable=True)[:, :L]
        pool_ids = torch.gather(all_ids, 1, order)
        pool_d = torch.gather(all_d, 1, order)
        pool_exp = torch.gather(all_exp, 1, order)
        it += 1
    return pool_d[:, :k], pool_ids[:, :k], it


def search_graph_device(graph, xb, xq, k: int, L: Optional[int] = None, entry=0,
                        max_iters: int = 0):
    """Device-resident counterpart of search_graph (host loop): returns
    (D f32[nq, k], I i64[nq, k]) on the graph's device. ``graph`` is a
    ``Graph``, ``RocGraph`` or ``RocBlockGraph``; pass ``xb`` as a tensor on
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

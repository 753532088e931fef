"""NSG-style graph construction and the host-driven best-first search.

Port of the JAX package's ``search/nsg.py``. The reference delegates both to
Faiss IndexNSG and swaps compressed graphs into ``nsg.final_graph``
(altid.swig:88-92); here:

  build_nsg     exact kNN graph (blocked matrix products + top-k, self
                excluded), MRNG occlusion pruning (the NSG edge-selection
                rule) and a medoid-rooted connectivity repair, all on the
                device of ``xb``: the candidate gathers too, which the JAX
                package does on the host.
  search_graph  greedy best-first with a pool of L per query, batched over
                the queries: each hop expands one frontier node per query,
                fetches all frontier adjacency lists in ONE
                ``get_neighbors_batch`` call (the decode-inside-traversal hot
                path, altid_impl.cpp:153-165) and computes every candidate
                distance in one pass. The visited sets and the pool merge
                run on the host, as in the JAX package: this is the oracle
                that ``search/graph_device.py`` is held against. Ties break
                by (distance, id).
  search_and_trace  the same loop, also returning every node id whose
                distance was evaluated (TracingDistanceComputer,
                altid_impl.cpp:170-231).

Float32 matrix products run in full float32 (``search/__init__.py`` turns
TF32 off).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..store.graph import Graph

# cap on gathered candidate-vector elements per prune block (1 GiB of float32)
PRUNE_BUDGET = 2 ** 28


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def build_knn_graph(xb, knn: int, block: int = 1024) -> torch.Tensor:
    """Exact kNN graph (self excluded) via blocked matrix products →
    i32[N, knn] on the device of ``xb`` (a tensor; the CPU for numpy)."""
    xb = _as_f32(xb)
    N = xb.shape[0]
    b2 = (xb * xb).sum(dim=1)
    out = torch.empty((N, knn), dtype=torch.int32, device=xb.device)
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        d2 = b2[None, :] - 2.0 * (xb[lo:hi] @ xb.T)
        rows = torch.arange(hi - lo, device=xb.device)
        d2[rows, lo + rows] = float("inf")
        out[lo:hi] = torch.topk(d2, knn, dim=1, largest=False, sorted=True).indices
    return out


def _mrng_prune_block(cand_vecs, cand_d, valid, R: int) -> torch.Tensor:
    """MRNG occlusion rule over a block of nodes.

    cand_vecs f32[B, C, d] candidate vectors in ascending distance order,
    cand_d f32[B, C] their distances to the node, valid bool[B, C]. Keep
    candidate j iff no already-kept k has d(k, j) < d(node, j), at most R per
    node → keep mask bool[B, C]."""
    B, C, _ = cand_vecs.shape
    dots = torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
    n2 = (cand_vecs * cand_vecs).sum(dim=2)
    pair = n2[:, :, None] + n2[:, None, :] - 2.0 * dots  # d2(c, e)
    keep = torch.zeros((B, C), dtype=torch.bool, device=cand_vecs.device)
    count = torch.zeros(B, dtype=torch.int64, device=cand_vecs.device)
    for j in range(C):
        occ = (keep & (pair[:, :, j] < cand_d[:, j, None])).any(dim=1)
        ok = valid[:, j] & ~occ & (count < R)
        keep[:, j] = ok
        count += ok
    return keep


def build_nsg(xb, R: int, knn: Optional[int] = None, block: Optional[int] = None,
              progress: Optional[bool] = None) -> Tuple[Graph, int]:
    """NSG-style graph with max degree R on the device of ``xb`` → (Graph,
    medoid entry). ``block`` nodes are pruned at a time (default: as many
    as ``PRUNE_BUDGET`` gathered candidate elements allow); the result does
    not depend on it."""
    xb = _as_f32(xb)
    N, d = xb.shape
    if progress is None:
        progress = N >= 200_000
    log = (lambda m: print(f"  [build_nsg] {m}", flush=True)) if progress \
        else (lambda m: None)
    knn = knn or min(max(2 * R, 32), N - 1)
    block = block or max(1, PRUNE_BUDGET // (knn * d))
    t0 = time.perf_counter()
    knng = build_knn_graph(xb, knn)
    log(f"knn graph ({knn}-NN) in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    adjacency = torch.full((N, R), -1, dtype=torch.int32, device=xb.device)
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        B = hi - lo
        cand_idx = knng[lo:hi].to(torch.int64)          # [B, C]
        diff = xb[cand_idx] - xb[lo:hi, None, :]
        cand_d = (diff * diff).sum(dim=-1)
        del diff
        order = torch.argsort(cand_d, dim=1, stable=True)
        cand_idx = torch.gather(cand_idx, 1, order)
        cand_d = torch.gather(cand_d, 1, order)
        keep = _mrng_prune_block(xb[cand_idx], cand_d,
                                 torch.ones_like(cand_d, dtype=torch.bool), R)
        # kept candidates, in order, into slots 0..; slot R is a discard column
        kcum = torch.cumsum(keep, dim=1)
        slot = torch.where(keep & (kcum <= R), kcum - 1, R)
        adj_b = torch.full((B, R + 1), -1, dtype=torch.int32, device=xb.device)
        adj_b.scatter_(1, slot, torch.where(slot < R, cand_idx, -1).to(torch.int32))
        adjacency[lo:hi] = adj_b[:, :R]
    log(f"MRNG prune in {time.perf_counter() - t0:.1f}s")

    # medoid entry + connectivity fix (NSG spanning-tree repair)
    medoid = int(torch.argmin(((xb - xb.mean(dim=0)) ** 2).sum(dim=1)))
    t0 = time.perf_counter()
    adjacency = _ensure_connected(adjacency, xb, medoid)
    log(f"connectivity repair in {time.perf_counter() - t0:.1f}s")
    return Graph(adjacency), medoid


def _ensure_connected(adjacency: torch.Tensor, xb: torch.Tensor, root: int) -> torch.Tensor:
    """Attach every node that a BFS from ``root`` does not reach to its
    nearest reached node, in place; rows must hold their neighbours first
    and -1 after them (as the prune leaves them).

    The JAX package assigns the slots in a host loop over the unreached
    nodes u, ascending: u goes into its parent's first free (-1) slot, or
    overwrites slot R-1 when the row is full (u is never in the row: a
    parent is reached, so all its neighbours are). Per parent with degree
    deg, its j-th child therefore lands at deg + j while that is below R-1,
    and slot R-1 ends with the parent's last child once it is reached. That
    is what the vectorized assignment below writes."""
    N, R = adjacency.shape
    dev = adjacency.device
    # BFS by whole frontiers
    seen = torch.zeros(N, dtype=torch.bool, device=dev)
    seen[root] = True
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    while frontier.numel():
        nxt = adjacency[frontier].reshape(-1).to(torch.int64)
        nxt = nxt[nxt >= 0]
        nxt = torch.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        frontier = nxt
    unreached = torch.nonzero(~seen)[:, 0]
    if unreached.numel() == 0:
        return adjacency
    reached = torch.nonzero(seen)[:, 0]
    # nearest reached parent per unreached node, blocked
    xr = xb[reached]
    r2 = (xr * xr).sum(dim=1)
    parents = torch.empty_like(unreached)
    blk = 4096
    for s in range(0, unreached.numel(), blk):
        xu = xb[unreached[s:s + blk]]
        d2 = (xu * xu).sum(dim=1)[:, None] - 2.0 * (xu @ xr.T) + r2[None, :]
        parents[s:s + blk] = reached[torch.argmin(d2, dim=1)]
    # group the children by parent, keeping ascending u within a group
    order = torch.argsort(parents, stable=True)
    par, child = parents[order], unreached[order]
    pos = torch.arange(par.numel(), device=dev)
    start = torch.ones_like(par, dtype=torch.bool)
    start[1:] = par[1:] != par[:-1]
    last = torch.ones_like(start)
    last[:-1] = start[1:]
    j = pos - torch.cummax(torch.where(start, pos, 0), dim=0).values
    slot = (adjacency[par] >= 0).sum(dim=1) + j
    write = (slot < R - 1) | last
    adjacency[par[write], slot[write].clamp(max=R - 1)] = child[write].to(torch.int32)
    return adjacency


# ---------------------------------------------------------------------------
# host-driven best-first search (the oracle)
# ---------------------------------------------------------------------------


def _batch_dists(xq, xb, nodes):
    """d2 f32[nq, K] from each query to its candidate nodes (-1 → inf)."""
    vecs = xb[nodes.clamp(min=0)]                   # [nq, K, d]
    diff = vecs - xq[:, None, :]
    d2 = (diff * diff).sum(dim=2)
    return torch.where(nodes >= 0, d2, float("inf"))


def search_graph(graph, xb, xq, k: int, L: Optional[int] = None, entry: int = 0,
                 trace: bool = False):
    """Greedy best-first over ``graph`` (any container with
    ``get_neighbors_batch``), on the graph's device. Returns (D f32[nq, k],
    I i64[nq, k], the evaluated node ids in order or None). Pool size
    L (>= k)."""
    dev = graph.device
    xq = _as_f32(xq, dev)
    xb = _as_f32(xb, dev)
    nq = xq.shape[0]
    L = max(L or 2 * k, k)
    rows = np.arange(nq)

    pool_ids = np.full((nq, L), -1, dtype=np.int64)
    pool_d = np.full((nq, L), np.inf, dtype=np.float32)
    pool_exp = np.zeros((nq, L), dtype=bool)
    visited: List[set] = [{entry} for _ in range(nq)]
    trace_log: List[int] = [entry] * nq if trace else []

    entry_t = torch.full((nq, 1), entry, dtype=torch.int64, device=dev)
    pool_ids[:, 0] = entry
    pool_d[:, 0] = _batch_dists(xq, xb, entry_t)[:, 0].cpu().numpy()

    while True:
        # frontier: nearest unexpanded pool entry per query
        cand = np.where(pool_exp | (pool_ids < 0), np.inf, pool_d)
        sel = np.argmin(cand, axis=1)
        active = np.isfinite(cand[rows, sel])
        if not active.any():
            break
        sel_nodes = np.where(active, pool_ids[rows, sel], 0)
        pool_exp[rows, sel] |= active

        nbrs, counts = graph.get_neighbors_batch(torch.from_numpy(sel_nodes).to(dev))
        nbrs, counts = nbrs.cpu().numpy(), counts.cpu().numpy()
        K = nbrs.shape[1]
        # mask: inactive queries and already-visited nodes
        mask = np.zeros((nq, K), dtype=bool)
        for q in np.flatnonzero(active):
            for j in range(int(counts[q])):
                v = int(nbrs[q, j])
                if v not in visited[q]:
                    visited[q].add(v)
                    mask[q, j] = True
        new_ids = np.where(mask, nbrs, -1).astype(np.int64)
        d2 = _batch_dists(xq, xb, torch.from_numpy(new_ids).to(dev)).cpu().numpy()
        if trace:
            for q in range(nq):
                trace_log.extend(int(v) for v in new_ids[q][mask[q]])

        # merge new candidates into the pools, keep the best L by (dist, id)
        all_ids = np.concatenate([pool_ids, new_ids], axis=1)
        all_d = np.concatenate([pool_d, np.where(mask, d2, np.inf)], axis=1)
        all_exp = np.concatenate([pool_exp, np.zeros_like(mask)], axis=1)
        order = np.lexsort((np.where(all_ids < 0, np.iinfo(np.int64).max, all_ids),
                            all_d), axis=1)
        take = order[:, :L]
        pool_ids = np.take_along_axis(all_ids, take, axis=1)
        pool_d = np.take_along_axis(all_d, take, axis=1)
        pool_exp = np.take_along_axis(all_exp, take, axis=1)

    D = torch.from_numpy(pool_d[:, :k].copy()).to(dev)
    I = torch.from_numpy(pool_ids[:, :k].copy()).to(dev)
    return D, I, (trace_log if trace else None)


def search_and_trace(graph, xb, xq, k: int, L: Optional[int] = None, entry: int = 0):
    """Reference parity: search_NSG_and_trace (altid_impl.cpp:203-231) →
    (labels, distances, visited node ids i64)."""
    D, I, visited = search_graph(graph, xb, xq, k, L=L, entry=entry, trace=True)
    return I, D, torch.tensor(visited, dtype=torch.int64)

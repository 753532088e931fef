"""Random Edge Coding (REC): the Pólya-urn model's bits per edge, in torch.

Port of the JAX package's ``codecs/rec.py`` (the offline, static entropy
rate of a graph under one-shot bits-back edge coding; Severo et al., "Random
Edge Coding", ICML 2023, the vector-id paper's Table 3 comparison). A graph
of m edges is a sequence of 2m vertex mentions; the urn with bias alpha
gives the t-th mention to vertex v with probability (deg_t(v) + alpha) /
(t + n alpha). The sequence's probability depends only on the final degrees:

    P(seq) = [ prod_v Gamma(d_v + alpha) / Gamma(alpha) ]
             * Gamma(n alpha) / Gamma(2m + n alpha)

and bits-back recovers the m! orders of the edges (and one bit per edge for
an undirected graph):

    BPE = [ -log2 P(seq) - log2 m! - m 1{undirected} ] / m.

Edge lists are tensors (i64[m, 2]) on any device; the log-gammas are
``torch.lgamma`` in float64 on that device, over the degree histogram.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LN2 = math.log(2.0)


def degrees_from_edges(edge_array, num_nodes: int, undirected: bool = False) -> torch.Tensor:
    """Vertex mentions per node, i64[num_nodes]: every edge mentions both of
    its endpoints once (``undirected`` does not change the count)."""
    edges = torch.as_tensor(edge_array).reshape(-1)
    return torch.bincount(edges.long(), minlength=num_nodes)


@dataclass
class PolyasUrnModel:
    """The analytic Pólya-urn model, with the constructor of the external
    ``rec`` package that the reference calls (num_nodes, num_edges,
    undirected)."""

    num_nodes: int
    num_edges: int
    undirected: bool = False
    alpha: float = 1.0

    def sequence_bits(self, degrees) -> float:
        """-log2 P(the vertex-mention sequence) under the urn."""
        n, m, a = self.num_nodes, self.num_edges, self.alpha
        deg = torch.as_tensor(degrees).to(torch.float64)
        if int(deg.sum()) != 2 * m:
            raise ValueError(f"the degrees sum to {int(deg.sum())}, not 2 * num_edges = {2 * m}")
        # prod_v Gamma(d_v + alpha) / Gamma(alpha): vertices with d_v > 0 only
        nz = deg[deg > 0]
        log_num = float(torch.lgamma(nz + a).sum()) - nz.numel() * math.lgamma(a)
        log_den = math.lgamma(2 * m + n * a) - math.lgamma(n * a)
        return (log_den - log_num) / LN2

    def bits_back_savings(self) -> float:
        """log2 m! (the edges' order), plus m bits for an undirected graph
        (each edge's direction)."""
        m = self.num_edges
        return math.lgamma(m + 1) / LN2 + (m if self.undirected else 0)

    def compute_bpe(self, graph) -> tuple:
        """(total bits, bits per edge) of ``graph`` (an object with
        ``edge_array`` [m, 2])."""
        deg = degrees_from_edges(graph.edge_array, self.num_nodes)
        total = self.sequence_bits(deg) - self.bits_back_savings()
        return total, total / max(self.num_edges, 1)


@dataclass
class Graph:
    """Edge-list graph, as ``rec.definitions.Graph``."""

    edge_array: torch.Tensor
    num_nodes: int
    num_edges: int


def friend_to_edgelist_repr(graph_friends) -> torch.Tensor:
    """Adjacency [N, K] (-1 padded; a tensor, an array, or a list of friend
    arrays) → the directed edge list i64[m, 2], node by node, each node's
    friends in their order."""
    if not torch.is_tensor(graph_friends):
        rows = [torch.as_tensor(f, dtype=torch.int64).reshape(-1) for f in graph_friends]
        width = max((len(r) for r in rows), default=0)
        adj = torch.full((len(rows), width), -1, dtype=torch.int64)
        for v, r in enumerate(rows):
            adj[v, :len(r)] = r
        graph_friends = adj
    adj = graph_friends.long()
    src, col = torch.nonzero(adj >= 0, as_tuple=True)
    return torch.stack([src, adj[src, col]], dim=1)

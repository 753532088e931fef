"""Graph (NSG-style) adjacency containers with compressed neighbour lists.

Port of the JAX package's ``store/graph.py`` (reference
alt-graph-index/altid_impl.h):

  Graph          dense i32[N, K] adjacency, rows -1-padded at the end (the
                 data model of faiss::nsg::Graph<int32_t>)
  CompactBitGraph  C14: K fixed-width fields per node, terminator value N
                 after the last neighbour (altid_impl.cpp:20-51)
  EliasFanoGraph C15: each node's sorted neighbours Elias-Fano coded
                 (altid_impl.cpp:53-101); decode gives them ascending
  RocGraph       C16: one ROC state per node over its neighbour set
                 (altid_impl.cpp:103-165); decoded with the per-list decode
                 kernel
  RocBlockGraph  one state per block of ``block`` consecutive nodes, their
                 neighbour sets chained through it (slot ``block-1`` pushed
                 first, so decode emits slot 0 first); decoded with the
                 chained decode kernel. The 8-byte head and the stack-word
                 rounding are paid once per block instead of once per node;
                 fetching one node decodes its whole block.

Construction runs on the graph's device with no per-node Python loop (the
JAX package loops over the nodes): the compact graph packs every row in one
pass; each row is sorted with -1 masked to the end, then Elias-Fano coded
over the whole table in one pass, or, for ROC, checked for duplicate
neighbours and given its precision, vectorized, before one encode launch
encodes every lane. Words and streams are those of the JAX containers per
node, bit for bit (tests/test_torch_graph.py, tests/test_torch_containers.py).

Size accounting matches the reference formulas:
  compact: N * stride bytes, stride = (K*bits+7)/8, bits from
           `while((1 << bits) < N+1)`; no overhead (the terminator)
  EF:      sum of the nodes' high + low bits / 8; overhead
           2 * N * ceil(log2 N) / 8 bytes (degrees and max ids)
  ROC:     sum over lanes of (8 + 4 * stack_len) bytes, empty nodes included;
           overhead N * ceil(log2 N) / 8 bytes (the degrees)
"""

from __future__ import annotations

import math

import torch

from ..codecs import roc_device as rd
from ..codecs.elias_fano import ef_decode_all, ef_encode_rows
from ..codecs.packed_bits import packed_width
from ..codecs.roc import precision_for_max_ids_safe
from ..core.bits import fields_at, pack_fields
from ..device import resolve
from ..ops.roc_decode import RocDecoder
from ..ops.roc_encode import RocEncoder


class Graph:
    """Dense adjacency i32[N, K], each row's neighbours first and -1 after
    them, on ``device`` (default: the adjacency's own device for a tensor,
    the card for a numpy array such as the JAX package's
    ``Graph.adjacency``; ``device="cpu"`` for the CPU)."""

    def __init__(self, adjacency, device=None):
        adj = torch.as_tensor(adjacency, dtype=torch.int32,
                              device=resolve(device, adjacency))
        if adj.dim() != 2:
            raise ValueError(f"adjacency must be 2-D [N, K], got {list(adj.shape)}")
        self.adjacency = adj.contiguous()
        self.N, self.K = adj.shape
        self.device = adj.device
        self.degrees = (adj >= 0).sum(dim=1, dtype=torch.int32)

    def get_neighbors(self, i: int) -> torch.Tensor:
        row = self.adjacency[i]
        return row[row >= 0]

    def get_neighbors_batch(self, nodes):
        """(neighbours i32[Q, K] padded with -1, counts i32[Q])."""
        nodes = torch.as_tensor(nodes, dtype=torch.int64, device=self.device)
        return self.adjacency[nodes], self.degrees[nodes]


class CompressedGraph:
    """Base for compressed adjacency containers, on their graph's device."""

    def __init__(self, graph: Graph):
        self.N, self.K = graph.N, graph.K
        self.device = graph.device
        self.degrees = graph.degrees.clone()
        self.logn = math.ceil(math.log2(self.N)) if self.N > 1 else 0
        self.overhead_in_bytes = int(self.N * self.logn / 8)  # the degrees
        self.compressed_ids_size_in_bytes = 0

    def get_neighbors(self, i: int) -> torch.Tensor:
        nb, cnt = self.get_neighbors_batch(torch.tensor([i]))
        return nb[0, : int(cnt[0])]

    def get_neighbors_batch(self, nodes):
        raise NotImplementedError

    def _mask(self, vals: torch.Tensor, nodes: torch.Tensor):
        """Decoded rows → (i32[Q, K] with -1 past each count, counts)."""
        counts = self.degrees[nodes]
        cols = torch.arange(self.K, device=self.device)
        return torch.where(cols[None, :] < counts[:, None], vals, -1).to(torch.int32), counts


class CompactBitGraph(CompressedGraph):
    """Fixed-width edges: K fields of ``packed_width(N)`` bits per node, the
    value N after the last neighbour of a node with fewer than K
    (altid_impl.cpp:20-51), in ceil(K*bits/32) words per node so that the
    byte accounting matches the reference stride. Packed in one pass."""

    def __init__(self, graph: Graph):
        super().__init__(graph)
        self.overhead_in_bytes = 0  # the terminator marks each degree
        self.bits = packed_width(self.N)  # while((1<<bits) < N+1)
        self.stride = (self.K * self.bits + 7) // 8
        W = max((self.K * self.bits + 31) // 32, 1)
        cols = torch.arange(self.K, device=self.device)[None, :]
        deg = self.degrees[:, None]
        vals = torch.where(cols < deg, graph.adjacency.to(torch.int64),
                           torch.where(cols == deg, self.N, 0))
        self.words = pack_fields(vals, self.bits, W)
        self.compressed_ids_size_in_bytes = self.N * self.stride

    def get_neighbors_batch(self, nodes):
        """(neighbours i32[Q, K] padded with -1, counts i32[Q]): one field
        read per slot."""
        nodes = torch.as_tensor(nodes, dtype=torch.int64, device=self.device)
        cols = torch.arange(self.K, device=self.device)[None, :]
        return self._mask(fields_at(self.words, nodes[:, None], cols, self.bits), nodes)


class EliasFanoGraph(CompressedGraph):
    """Each node's neighbours sorted and Elias-Fano coded, one row per node,
    encoded in one pass (altid_impl.cpp:53-101); a fetch decodes the nodes'
    rows, ascending (the order change is search-neutral)."""

    def __init__(self, graph: Graph):
        super().__init__(graph)
        valid = graph.adjacency >= 0
        srt = torch.where(valid, graph.adjacency.to(torch.int64),
                          torch.iinfo(torch.int64).max).sort(dim=1).values
        self.ef = ef_encode_rows(srt, self.degrees)
        self.compressed_ids_size_in_bytes = int(self.ef.size_in_bits.sum()) // 8
        # degrees + per-node max_id (altid_impl.cpp:56-57)
        self.overhead_in_bytes = int(2 * self.N * self.logn / 8)

    def get_neighbors_batch(self, nodes):
        """(neighbours i32[Q, K] padded with -1, counts i32[Q]): one decode
        of the nodes' rows."""
        nodes = torch.as_tensor(nodes, dtype=torch.int64, device=self.device)
        return self._mask(ef_decode_all(self.ef.rows(nodes), self.K), nodes)


def neighbour_table(adjacency: torch.Tensor, empty_precision: int):
    """Per row of a -1-padded adjacency i32[M, K]: (sorted ids i64[M, K],
    ascending and zero past the degree; degrees i32[M]; safe precisions
    i32[M], with ``empty_precision`` for rows without neighbours). Raises on
    a duplicate neighbour, since ROC is lossless only for distinct symbols
    (codec.cpp:123-152 has the same constraint)."""
    valid = adjacency >= 0
    degrees = valid.sum(dim=1, dtype=torch.int32)
    srt = torch.where(valid, adjacency.to(torch.int64),
                      torch.iinfo(torch.int64).max).sort(dim=1).values
    live = torch.arange(adjacency.shape[1], device=adjacency.device)[None, :] < degrees[:, None]
    dup = ((srt[:, 1:] == srt[:, :-1]) & live[:, 1:]).any(dim=1)
    if bool(dup.any()):
        row = int(dup.nonzero()[0, 0])
        raise ValueError(f"duplicate neighbor ids in adjacency row {row}; "
                         "deduplicate the graph before ROC compression")
    srt = torch.where(live, srt, 0)
    max_id = srt.gather(1, (degrees - 1).clamp(min=0)[:, None])[:, 0]
    nonempty = degrees > 0
    prec = torch.full_like(degrees, empty_precision)
    prec[nonempty] = precision_for_max_ids_safe(max_id[nonempty])
    return srt, degrees, prec


class RocGraph(CompressedGraph):
    """Per-node ROC states over the neighbour sets, one lane per node padded
    to K, encoded in one launch; decode gives each set in its encode
    sampling order (altid_impl.cpp:103-165). Nodes without neighbours keep
    the fresh state and precision 0."""

    def __init__(self, graph: Graph):
        super().__init__(graph)
        sorted_ids, _, self.precision = neighbour_table(graph.adjacency, empty_precision=0)
        states, _ = RocEncoder.encode(sorted_ids, self.degrees, self.precision)
        self.compressed_ids_size_in_bytes = int(states.size_bytes.sum())
        self.decoder = RocDecoder(states, self.degrees, self.precision,
                                  rd.default_pool(self.K, self.device), self.K)

    def get_neighbors_batch(self, nodes):
        """(neighbours i32[Q, K] padded with -1, counts i32[Q]); one decode
        launch over the nodes' lanes."""
        nodes = torch.as_tensor(nodes, dtype=torch.int64, device=self.device)
        return self._mask(self.decoder.decode_lanes(nodes), nodes)


class RocBlockGraph(CompressedGraph):
    """One ROC state per block of ``block`` consecutive nodes, their
    neighbour sets chained through it (the JAX package's extension beyond
    C16): the head costs 64 / (block * degree) bits per edge instead of
    64 / degree, the multiset payload is unchanged (each slot keeps its own
    precision), and fetching a node decodes its block. Empty slots, the
    padding of the last block included, have length 0 and precision 1.
    ``block=1`` gives the per-node stream bit for bit."""

    def __init__(self, graph: Graph, block: int = 16):
        super().__init__(graph)
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        n_blocks = -(-self.N // self.block)
        adj = torch.full((n_blocks * self.block, self.K), -1, dtype=torch.int32,
                         device=self.device)
        adj[: self.N] = graph.adjacency
        sorted_ids, degs, prec = neighbour_table(adj, empty_precision=1)
        degs = degs.reshape(n_blocks, self.block)
        prec = prec.reshape(n_blocks, self.block)
        states = RocEncoder.encode_chained(
            sorted_ids.reshape(n_blocks, self.block, self.K), degs, prec)
        self.compressed_ids_size_in_bytes = int(states.size_bytes.sum())
        self.decoder = RocDecoder(states, degs, prec,
                                  rd.default_pool(self.block * self.K, self.device),
                                  self.K)

    def get_neighbors_batch(self, nodes):
        """(neighbours i32[Q, K] padded with -1, counts i32[Q]); one chained
        decode launch, one lane per node (its block), duplicates included:
        deduplicating the blocks first (``torch.unique``) costs a sort and a
        host sync per call and saved no decode time in the graph walk
        (PERF.md)."""
        nodes = torch.as_tensor(nodes, dtype=torch.int64, device=self.device)
        ids = self.decoder.decode_lanes(nodes // self.block)  # [Q, block, K]
        rows = ids[torch.arange(nodes.shape[0], device=self.device), nodes % self.block]
        return self._mask(rows, nodes)

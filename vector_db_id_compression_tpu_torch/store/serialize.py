"""On-disk artifact format for the compressed containers.

Port of the JAX package's ``store/serialize.py``: the same ``.npz`` files,
array for array and byte for byte, so that an artifact written by either
package loads in the other. A file per IVF container holds its codec's state
(ANS heads and stacks with lengths and precisions, Elias-Fano words and
parameters, packed words, wavelet-tree planes) and the payload codes in the
container's order (sampling order for ROC, ascending ids for Elias-Fano); a
file per graph container holds its adjacency in its codec; a file per HNSW
index holds its levels and layers. Loading rebuilds a working container or
index on ``device`` (the card unless the caller says ``device="cpu"``)
without the uncompressed lists.

The format is the JAX package's, layout and dtypes:
  - its IVF containers keep one state per size bucket (``b{bi}_*`` arrays;
    ``store.ragged.bucketize`` over the list lengths, or over the chunk
    entries' lengths for the interleaved container), each ROC bucket's
    stacks cut to ``stack_capacity(n_pad, the bucket's largest precision)``
    and each bucket's words padded to its widest row. The port keeps one
    table per container, so ``save`` cuts the table into those buckets and
    ``load`` scatters them back into list order;
  - heads are u64 and words u32 on disk; the port carries them as int64 and
    int32 bit patterns. Lengths, precisions and the Elias-Fano ``l``, ``m``
    are i32.
A stack word past its lane's ``stack_len`` is written as 0: it is no part of
the stream (an encoder may leave a popped word there). Arrays are written in
list order, so a file depends only on the container's content.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..codecs import roc_device as rd
from ..codecs.elias_fano import EliasFanoBatch
from ..codecs.packed_bits import PackedBitsBatch
from ..codecs.rrr import RRRPlanes
from ..codecs.wavelet_tree import WaveletTree, wt_index_from_words
from ..core.bits import SB_WORDS, build_bitvector_batch
from ..device import DEFAULT_DEVICE, resolve
from ..ops.roc_decode import RocDecoder
from .graph import CompactBitGraph, EliasFanoGraph, Graph, RocBlockGraph, RocGraph
from .invlists import (
    CompressedInvertedLists,
    EliasFanoInvertedLists,
    InterleavedRocInvertedLists,
    PackedBitsInvertedLists,
    RocInvertedLists,
    WaveletTreeInvertedLists,
)
from .ragged import bucketize

MAGIC = "vdbidc-tpu-v1"

_KIND = {
    RocInvertedLists: "roc",
    EliasFanoInvertedLists: "elias_fano",
    PackedBitsInvertedLists: "packed_bits",
    WaveletTreeInvertedLists: "wavelet_tree",
    InterleavedRocInvertedLists: "roc_interleaved",
}
_BY_KIND = {v: k for k, v in _KIND.items()}

_GRAPH_KIND = {
    Graph: "raw",
    CompactBitGraph: "compact",
    EliasFanoGraph: "elias_fano",
    RocGraph: "roc",
    RocBlockGraph: "roc_block",
}
_GRAPH_BY_KIND = {v: k for k, v in _GRAPH_KIND.items()}


# ---------------------------------------------------------------------------
# host arrays <-> the port's tensors
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _u32(t: torch.Tensor) -> np.ndarray:
    """Stored words (int32 bit patterns) → the u32 words they stand for."""
    return _np(t).view(np.uint32)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; u32 words as the int32 bit patterns the
    port stores, u64 as int64."""
    a = np.ascontiguousarray(a)
    view = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}.get(a.dtype)
    return torch.from_numpy(a.view(view) if view else a).to(device)


def _savez(path, arrs: dict, meta: dict) -> None:
    np.savez(path, **arrs, **{f"meta_{k}": np.array(str(v)) for k, v in meta.items()})


def _open(path, kinds: dict):
    """(the open artifact, its kind) after the magic check."""
    z = np.load(path, allow_pickle=False)
    if "meta_magic" not in z.files or str(z["meta_magic"]) != MAGIC:
        z.close()
        raise ValueError(f"{path}: not a {MAGIC} artifact")
    kind = str(z["meta_kind"])
    if kind not in kinds:
        z.close()
        raise ValueError(f"{path}: artifact kind {kind!r} is not one of {sorted(kinds)}")
    return z, kind


# ---------------------------------------------------------------------------
# ROC lane tables <-> per-bucket states
# ---------------------------------------------------------------------------


def _fit_stack(stack: np.ndarray, stack_len: np.ndarray, cap: int) -> np.ndarray:
    """Stack words u32[B, cap]: each lane's first ``stack_len`` words, then
    zeros."""
    if int(stack_len.max(initial=0)) > cap:
        raise ValueError(f"a lane's stack holds more than the capacity of {cap} words")
    out = np.zeros((len(stack), cap), dtype=np.uint32)
    w = min(cap, stack.shape[1])
    out[:, :w] = stack[:, :w]
    out[np.arange(cap)[None, :] >= stack_len[:, None]] = 0
    return out


def _states_np(dec: RocDecoder):
    """A decoder's (head u64, stack u32, stack_len, mt_ctr, precision), on
    the host."""
    st = dec.states
    return (_np(st.head).view(np.uint64), _u32(st.stack), _np(st.stack_len),
            _np(st.mt_ctr), _np(dec.precision))


def _put_bucket(arrs: dict, bi: int, bucket) -> None:
    arrs[f"b{bi}_list_ids"] = bucket.list_ids
    arrs[f"b{bi}_lengths"] = bucket.lengths
    arrs[f"b{bi}_npad"] = np.array([bucket.n_pad])


def _put_roc_buckets(arrs: dict, dec: RocDecoder, buckets) -> None:
    head, stack, stack_len, mt_ctr, prec = _states_np(dec)
    for bi, bucket in enumerate(buckets):
        rows = bucket.list_ids
        _put_bucket(arrs, bi, bucket)
        arrs[f"b{bi}_head"] = head[rows]
        arrs[f"b{bi}_stack"] = _fit_stack(stack[rows], stack_len[rows],
                                          rd.stack_capacity(bucket.n_pad, int(prec[rows].max())))
        arrs[f"b{bi}_stack_len"] = stack_len[rows]
        arrs[f"b{bi}_mt_ctr"] = mt_ctr[rows]
        arrs[f"b{bi}_prec"] = prec[rows]


def _bucket_rows(z):
    """Each bucket's rows (list numbers, or chunk entries), in bucket order."""
    return [z[f"b{bi}_list_ids"] for bi in range(int(str(z["meta_n_buckets"])))]


def _roc_decoder(z, rows, lengths: np.ndarray, device) -> RocDecoder:
    """The lane table of ``len(lengths)`` lanes that the encode kernel would
    have built for these lengths (stack capacity and pool for the longest
    lane and largest precision; lanes in no bucket empty, with the fresh
    state and precision 0), filled from the buckets' states."""
    L = len(lengths)
    n_max = max(int(lengths.max(initial=0)), 1)
    prec = np.zeros(L, dtype=np.int32)
    for bi, r in enumerate(rows):
        prec[r] = z[f"b{bi}_prec"]
    cap = rd.stack_capacity(n_max, max(int(prec.max(initial=0)), 1))
    head = np.full(L, rd.RANS_L, dtype=np.uint64)
    stack = np.zeros((L, cap), dtype=np.uint32)
    stack_len = np.zeros(L, dtype=np.int32)
    mt_ctr = np.zeros(L, dtype=np.int32)
    for bi, r in enumerate(rows):
        head[r] = z[f"b{bi}_head"]
        stack_len[r] = z[f"b{bi}_stack_len"]
        stack[r] = _fit_stack(z[f"b{bi}_stack"], stack_len[r], cap)
        mt_ctr[r] = z[f"b{bi}_mt_ctr"]
    states = rd.RocStates(head=_tensor(head, device), stack=_tensor(stack, device),
                          stack_len=_tensor(stack_len, device), mt_ctr=_tensor(mt_ctr, device),
                          err=torch.zeros(L, dtype=torch.bool, device=device))
    return RocDecoder(states, _tensor(lengths.astype(np.int32), device), _tensor(prec, device),
                      rd.default_pool(n_max, device), n_max)


# ---------------------------------------------------------------------------
# IVF containers
# ---------------------------------------------------------------------------


def _codes_to_flat(codes_all):
    offsets = np.zeros(len(codes_all) + 1, dtype=np.int64)
    for i, c in enumerate(codes_all):
        offsets[i + 1] = offsets[i] + len(c)
    flat = np.concatenate(codes_all) if offsets[-1] > 0 else np.empty(0, np.uint8)
    return flat, offsets


def _codes_from_flat(flat, offsets):
    return [flat[offsets[i]: offsets[i + 1]].copy() for i in range(len(offsets) - 1)]


def save_invlists(path: Union[str, Path], c: CompressedInvertedLists) -> None:
    """Write container ``c`` as the JAX package's artifact of its kind."""
    kind = _KIND[type(c)]
    codes_flat, codes_offsets = _codes_to_flat(c.codes_all)
    arrs = {
        "lengths": c._lengths,
        "codes_flat": codes_flat,
        "codes_offsets": codes_offsets,
        "sizes": np.array([c.compressed_ids_size_in_bytes, c.overhead_in_bytes, c.nlist,
                           c.code_size], dtype=np.int64),
    }
    meta = dict(magic=MAGIC, kind=kind)
    if kind == "roc":
        arrs["id_symbol_precision"] = c.id_symbol_precision
        buckets = bucketize(c._lengths)
        _put_roc_buckets(arrs, c.decoder, buckets)
        meta["n_buckets"] = len(buckets)
    elif kind == "roc_interleaved":
        # the chunk entries are numbered list by list, as the JAX package's
        arrs["ent_counts"] = c.n_lanes
        arrs["ent_lo"] = _np(c._lane_lo).view(np.uint64)
        arrs["ent_len"] = _np(c.decoder.lengths)
        arrs["interleave"] = np.array([-1 if c.interleave == "auto" else c.interleave],
                                      dtype=np.int64)  # -1: the "auto" policy
        arrs["id_symbol_precision"] = c.id_symbol_precision
        buckets = bucketize(arrs["ent_len"])
        _put_roc_buckets(arrs, c.decoder, buckets)
        meta["n_buckets"] = len(buckets)
    elif kind == "elias_fano":
        ef = c.ef
        high, nbits, low = _u32(ef.high.words), _np(ef.high.nbits), _u32(ef.low_words)
        l, m = _np(ef.l), _np(ef.m)
        buckets = bucketize(c._lengths)
        for bi, bucket in enumerate(buckets):
            rows = bucket.list_ids
            _put_bucket(arrs, bi, bucket)
            # the bucket's widest row, the high words padded to a superblock
            hw = max((int(nbits[rows].max()) + 31) // 32, 1)
            lw = max((int((m[rows] * l[rows]).max()) + 31) // 32, 1)
            arrs[f"b{bi}_high"] = high[rows, : -(-hw // SB_WORDS) * SB_WORDS]
            arrs[f"b{bi}_nbits"] = nbits[rows].astype(np.int32)
            arrs[f"b{bi}_low"] = low[rows, :lw]
            arrs[f"b{bi}_l"] = l[rows].astype(np.int32)
            arrs[f"b{bi}_m"] = m[rows].astype(np.int32)
        meta["n_buckets"] = len(buckets)
    elif kind == "packed_bits":
        arrs["bits"] = np.array([c.bits])
        words = _u32(c.packed.words)
        buckets = bucketize(c._lengths)
        for bi, bucket in enumerate(buckets):
            _put_bucket(arrs, bi, bucket)
            w = max((int(bucket.lengths.max()) * c.bits + 31) // 32, 1)
            arrs[f"b{bi}_words"] = words[bucket.list_ids, :w]
        meta["n_buckets"] = len(buckets)
    elif kind == "wavelet_tree":
        wt = c.wt
        if c.wt_type == 0:
            arrs["wt_words"] = _u32(wt.words)
        else:  # RRR(63)-compressed planes
            arrs["rrr_classes"] = _np(wt.classes)
            arrs["rrr_off_words"] = _u32(wt.off_words)
            arrs["rrr_sb_off_start"] = _np(wt.sb_off_start)
            arrs["rrr_sb_rank"] = _np(wt.sb_rank)
        arrs["wt_meta"] = np.array([wt.n, wt.levels, c.wt_type])
    _savez(path, arrs, meta)


def load_invlists(path: Union[str, Path], device=DEFAULT_DEVICE) -> CompressedInvertedLists:
    """The container an artifact of either package holds, on ``device``."""
    device = resolve(device)
    z, kind = _open(path, _BY_KIND)
    with z:
        cls = _BY_KIND[kind]
        c = cls.__new__(cls)
        c.device = device
        (c.compressed_ids_size_in_bytes, c.overhead_in_bytes, c.nlist,
         c.code_size) = (int(v) for v in z["sizes"])
        c._lengths = z["lengths"]
        c.codes_all = _codes_from_flat(z["codes_flat"], z["codes_offsets"])
        nlist = c.nlist
        if kind == "roc":
            c.id_symbol_precision = z["id_symbol_precision"]
            c.decoder = _roc_decoder(z, _bucket_rows(z), c._lengths, device)
        elif kind == "roc_interleaved":
            c.id_symbol_precision = z["id_symbol_precision"]
            iv = int(z["interleave"][0])
            c.interleave = "auto" if iv == -1 else iv
            ent_len, n_lanes = z["ent_len"], z["ent_counts"]
            c.decoder = _roc_decoder(z, _bucket_rows(z), ent_len, device)
            lane_start = np.zeros(nlist, dtype=np.int64)
            np.cumsum(n_lanes[:-1], out=lane_start[1:])
            # each chunk's first position in its sorted list: the lengths of
            # the list's chunks before it
            first = np.cumsum(ent_len, dtype=np.int64) - ent_len
            own = np.repeat(np.arange(nlist), n_lanes)
            c._set_lanes(z["ent_lo"], first - first[lane_start[own]], lane_start, n_lanes)
        elif kind == "elias_fano":
            nbits, l, m = (np.zeros(nlist, dtype=np.int64) for _ in range(3))
            rows = _bucket_rows(z)
            for bi, r in enumerate(rows):
                nbits[r], l[r], m[r] = z[f"b{bi}_nbits"], z[f"b{bi}_l"], z[f"b{bi}_m"]
            # the widths ef_encode_rows gives the whole table
            hw = max((int(nbits.max(initial=0)) + 31) // 32, 1)
            lw = max((int((m * l).max(initial=0)) + 31) // 32, 1)
            high = np.zeros((nlist, -(-hw // SB_WORDS) * SB_WORDS), dtype=np.uint32)
            low = np.zeros((nlist, lw), dtype=np.uint32)
            for bi, r in enumerate(rows):
                b_high, b_low = z[f"b{bi}_high"], z[f"b{bi}_low"]
                high[r, : b_high.shape[1]] = b_high
                low[r, : b_low.shape[1]] = b_low
            c.ef = EliasFanoBatch(
                high=build_bitvector_batch(_tensor(high, device), _tensor(nbits, device)),
                low_words=_tensor(low, device), l=_tensor(l, device), m=_tensor(m, device))
        elif kind == "packed_bits":
            c.bits = int(z["bits"][0])
            w = max((int(c._lengths.max(initial=0)) * c.bits + 31) // 32, 1)
            words = np.zeros((nlist, w), dtype=np.uint32)
            for bi, r in enumerate(_bucket_rows(z)):
                b_words = z[f"b{bi}_words"]
                words[r, : b_words.shape[1]] = b_words
            c.packed = PackedBitsBatch(_tensor(words, device), _tensor(c._lengths, device),
                                       c.bits)
        elif kind == "wavelet_tree":
            n, levels, c.wt_type = (int(v) for v in z["wt_meta"])
            if c.wt_type == 0:
                words = z["wt_words"].astype(np.uint32)
                c.wt = WaveletTree(_tensor(words, device),
                                   _tensor(wt_index_from_words(words), device), n, levels)
            else:
                c.wt = RRRPlanes(classes=_tensor(z["rrr_classes"], device),
                                 off_words=_tensor(z["rrr_off_words"], device),
                                 sb_off_start=_tensor(z["rrr_sb_off_start"], device),
                                 sb_rank=_tensor(z["rrr_sb_rank"], device), n=n, levels=levels)
    return c


# ---------------------------------------------------------------------------
# graph containers
# ---------------------------------------------------------------------------


def _put_roc_graph(arrs: dict, dec: RocDecoder, cap: int) -> None:
    head, stack, stack_len, mt_ctr, prec = _states_np(dec)
    arrs["head"] = head
    arrs["stack"] = _fit_stack(stack, stack_len, cap)
    arrs["stack_len"] = stack_len
    arrs["mt_ctr"] = mt_ctr
    arrs["prec"] = prec


def save_graph(path: Union[str, Path], g) -> None:
    """Write an adjacency container (``Graph``, ``CompactBitGraph``,
    ``EliasFanoGraph``, ``RocGraph``, ``RocBlockGraph``) as the JAX
    package's artifact of its kind."""
    kind = _GRAPH_KIND[type(g)]
    arrs = {
        "degrees": _np(g.degrees),
        "shape": np.array([g.N, g.K], dtype=np.int64),
        "sizes": np.array([getattr(g, "compressed_ids_size_in_bytes", 0),
                           getattr(g, "overhead_in_bytes", 0)], dtype=np.int64),
    }
    if kind == "raw":
        arrs["adjacency"] = _np(g.adjacency)
    elif kind == "compact":
        arrs["bits"] = np.array([g.bits, g.stride], dtype=np.int64)
        arrs["words"] = _u32(g.words)
    elif kind == "elias_fano":
        ef = g.ef
        arrs["high_words"] = _u32(ef.high.words)
        arrs["high_nbits"] = _np(ef.high.nbits).astype(np.int32)
        arrs["low_words"] = _u32(ef.low_words)
        arrs["l"] = _np(ef.l).astype(np.int32)
        arrs["m"] = _np(ef.m).astype(np.int32)
    elif kind == "roc":
        # the JAX package's stack capacity: precision 1 only for no nodes
        maxp = int(g.decoder.precision.max()) if g.N else 1
        _put_roc_graph(arrs, g.decoder, rd.stack_capacity(g.K, maxp))
        arrs["id_symbol_precision"] = arrs["prec"].astype(np.int64)
    elif kind == "roc_block":
        dec = g.decoder
        _put_roc_graph(arrs, dec, rd.stack_capacity(g.block * g.K, int(dec.precision.max())))
        arrs["degs"] = _np(dec.lengths)
        arrs["block"] = np.array([g.block], dtype=np.int64)
    _savez(path, arrs, dict(magic=MAGIC, kind=kind))


def load_graph(path: Union[str, Path], device=DEFAULT_DEVICE):
    """The adjacency container an artifact of either package holds, on
    ``device``."""
    device = resolve(device)
    z, kind = _open(path, _GRAPH_BY_KIND)
    with z:
        if kind == "raw":
            return Graph(z["adjacency"], device=device)
        cls = _GRAPH_BY_KIND[kind]
        g = cls.__new__(cls)
        g.N, g.K = (int(v) for v in z["shape"])
        g.device = device
        g.degrees = _tensor(z["degrees"], device)
        g.logn = math.ceil(math.log2(g.N)) if g.N > 1 else 0
        g.compressed_ids_size_in_bytes, g.overhead_in_bytes = (int(v) for v in z["sizes"])
        if kind == "compact":
            g.bits, g.stride = (int(v) for v in z["bits"])
            g.words = _tensor(z["words"], device)
        elif kind == "elias_fano":
            g.ef = EliasFanoBatch(
                high=build_bitvector_batch(_tensor(z["high_words"], device),
                                           _tensor(z["high_nbits"].astype(np.int64), device)),
                low_words=_tensor(z["low_words"], device),
                l=_tensor(z["l"].astype(np.int64), device),
                m=_tensor(z["m"].astype(np.int64), device))
        elif kind == "roc":
            g.precision = _tensor(z["prec"], device)
            g.decoder = _graph_decoder(z, g.degrees, g.precision, g.K, g.K)
        elif kind == "roc_block":
            g.block = int(z["block"][0])
            g.decoder = _graph_decoder(z, _tensor(z["degs"], device),
                                       _tensor(z["prec"], device), g.block * g.K, g.K)
    return g


def _graph_decoder(z, lengths: torch.Tensor, prec: torch.Tensor, n_symbols: int,
                   K: int) -> RocDecoder:
    """The decoder over a ROC graph's lanes, with the stack capacity and
    the pool the encode kernel gives lanes of ``n_symbols`` symbols."""
    device = lengths.device
    cap = rd.stack_capacity(n_symbols, max(int(prec.max()) if prec.numel() else 0, 1))
    stack_len = z["stack_len"]
    states = rd.RocStates(
        head=_tensor(z["head"], device),
        stack=_tensor(_fit_stack(z["stack"], stack_len, cap), device),
        stack_len=_tensor(stack_len, device), mt_ctr=_tensor(z["mt_ctr"], device),
        err=torch.zeros(len(stack_len), dtype=torch.bool, device=device))
    return RocDecoder(states, lengths, prec, rd.default_pool(n_symbols, device), K)


# ---------------------------------------------------------------------------
# HNSW index (all layers and their metadata)
# ---------------------------------------------------------------------------


def save_hnsw(path: Union[str, Path], h) -> None:
    """Write an HNSW index (``search.hnsw.HNSW``: its levels, layers, entry
    point and parameters; the vectors are the caller's to store) as the JAX
    package's ``save_hnsw`` does."""
    arrs = {
        "levels": np.asarray(h.levels),
        "meta": np.array([h.M, h.Mmax0, h.entry, h.max_level, int(h.ef_construction), h.seed],
                         dtype=np.int64),
    }
    for l, layer in enumerate(h.layers):
        arrs[f"layer{l}"] = layer
    _savez(path, arrs, dict(magic=MAGIC, kind="hnsw"))


def load_hnsw(path: Union[str, Path], xb, device=DEFAULT_DEVICE):
    """The HNSW index an artifact of either package holds, over the
    caller's vectors ``xb`` (numpy or a tensor), on ``device``."""
    from ..search.hnsw import HNSW

    device = resolve(device)
    z, _ = _open(path, {"hnsw": None})
    with z:
        M, _, entry, max_level, efc, seed = (int(v) for v in z["meta"])
        return HNSW.from_arrays(z["levels"], [z[f"layer{l}"] for l in range(max_level + 1)],
                                entry, max_level, M, efc, seed, xb, device=device)

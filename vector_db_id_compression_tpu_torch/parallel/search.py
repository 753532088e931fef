"""Sharded deferred-id-decoding IVF search on a 'lists' mesh.

Port of the JAX package's ``parallel/search.py`` ``ShardedIVF``. Each rank
owns the contiguous lists [rank * B_loc, (rank + 1) * B_loc) (nlist padded to
a multiple of the mesh size; pad lists are empty) and runs four stages per
chunk of queries, as methods so that a caller can time each:

  coarse:    the rank scores its centroid slice ([nq, d] x [d, B_loc]) and
             keeps its top nprobe; ``all_gather`` and a global merge by the
             lexicographic key (distance, list id), so the probe set does
             not depend on the mesh size;
  scan:      only the rank's probed lists, through the unsharded index's
             size buckets and scan helpers (``search/ivf.py``): the pair scan
             where 4 * nprobe < nlist_pad (the JAX package's global rule,
             which does not depend on the mesh size either), else the dense
             all-pairs scan; the PQ LUT scan past ``PQ_DECODE_BUDGET``; the
             rank's top k by (distance, label);
  merge:     ``all_gather`` of the ranks' [nq, k] shortlists, then the
             (distance, label) key, a -1 label keyed as 2^62;
  translate: each rank resolves the labels it owns, and the int64 partials
             combine with a ``psum`` (every label has one owner). ROC: the
             decode kernel over the touched local lanes
             (``RocDecoder.decode_lanes``); packed bits and Elias-Fano:
             random access on the rank's rows; the wavelet tree (plain and
             RRR): the whole tree on every rank; the raw id table otherwise
             (an interleaved ROC container's ids are decoded into it at
             construction, as the JAX package does).

Every rank takes the same branches: they follow from global metadata only
(list lengths, nlist, nprobe, the chunking), so the collectives line up.

The constructor is process-local by default: per-list metadata (lengths)
is global, and the payload and translation tables are built only for the
rank's rows, from the containers' list-order tables (one row per list).
``process_local=False`` builds every row on every rank (the JAX package's
full-array construction), kept so that a test can show that both give the
same results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs import roc_device as rd
from ..codecs.elias_fano import ef_select
from ..codecs.packed_bits import get_single
from ..codecs.wavelet_tree import wt_select, wt_select_rrr
from ..device import DEFAULT_DEVICE
from ..ops.roc_decode import RocDecoder
from ..search import ivf
from ..search.ivf import (_scan_flat_dense, _scan_flat_pairs, _scan_pq_pairs, lo_build,
                          lo_listno, lo_offset)
from ..search.pq import ProductQuantizer
from ..store.invlists import (EliasFanoInvertedLists, InvertedLists, PackedBitsInvertedLists,
                              RocInvertedLists, WaveletTreeInvertedLists)
from ..store.ragged import Bucket, bucketize
from .mesh import ListsMesh, _padded, rank_device
from .multihost import addressable_row_bounds

# the merge's key of an empty slot's label (-1): after every real label
_EMPTY_KEY = 1 << 62


def _lex_topk(dist: torch.Tensor, label: torch.Tensor, k: int):
    """The k smallest (distance, label) pairs of each row, lexicographically
    (a label of -1 keyed as 2^62): a stable sort by the label, then a stable
    sort by the distance → (distances, labels) [rows, min(k, width)]."""
    key = torch.where(label < 0, _EMPTY_KEY, label)
    by_label = torch.argsort(key, dim=1, stable=True)
    by_dist = torch.argsort(torch.gather(dist, 1, by_label), dim=1, stable=True)
    idx = torch.gather(by_label, 1, by_dist)[:, :k]
    return torch.gather(dist, 1, idx), torch.gather(label, 1, idx)


def _to(nt, device):
    """A NamedTuple of tensors, ints and such NamedTuples with its tensors
    on ``device``."""
    return type(nt)(*(x.to(device) if isinstance(x, torch.Tensor)
                      else _to(x, device) if isinstance(x, tuple) else x for x in nt))


class ShardedIVF:
    """IVF search (flat, PQ or QINCo storage) sharded over a 'lists' mesh.

    ``index`` is a trained ``search.ivf.IndexIVF`` with lists (its own device
    may be the CPU: the rank's tables go to the mesh's device); ``container``
    selects the translate: None or an ``InvertedLists`` → the raw id table;
    ``RocInvertedLists`` → the decode kernel over the touched lists; packed
    bits, Elias-Fano, the wavelet trees → their random access; any other
    container (interleaved ROC) → its ids decoded into the raw table.
    ``device``: the rank's device, which must be the mesh's; the card unless
    the caller says ``device="cpu"``.
    """

    def __init__(self, mesh: ListsMesh, index, container=None, process_local: bool = True,
                 device=DEFAULT_DEVICE):
        if index.storage not in ("flat", "pq", "qinco"):
            raise ValueError(f"unknown storage {index.storage!r}")
        dev = rank_device(device)
        if dev != mesh.device:
            raise ValueError(f"device {dev} is not the mesh's {mesh.device}")
        self.mesh, self.device = mesh, dev
        container = container if container is not None else index.invlists
        self.nlist, self.d = index.nlist, index.d
        N = mesh.size
        self.nlist_pad = -(-self.nlist // N) * N
        self.b_loc = self.nlist_pad // N
        self.n_pad = max(int(container.lengths.max(initial=0)), 1)  # the longest list
        self._lo, self._hi = addressable_row_bounds(mesh, self.nlist_pad)
        # the rows this rank builds: its own, or every row
        self._r0, r1 = (self._lo, self._hi) if process_local else (0, self.nlist_pad)
        real = np.arange(self._r0, min(r1, self.nlist))  # built rows that are lists
        R = r1 - self._r0

        # ---- coarse: the centroid rows (pad rows zero, scored +inf)
        cents = index.centroids[torch.from_numpy(real).to(index.centroids.device)]
        self._cents = _padded(cents.to(dev, torch.float32), R)

        # ---- scan: the global size buckets (every rank plans the same), each
        # cut to the built rows, so that a list is scanned in the same padded
        # shape whatever the mesh size; a global choice between
        # reconstructions and the LUT scan
        plan = bucketize(container.lengths)
        self._scan_is_float = index.decoded_scan(plan)
        cut = []
        for b in plan:
            m = (b.list_ids >= self._r0) & (b.list_ids < r1)
            if m.any():
                cut.append(Bucket(b.list_ids[m], b.lengths[m], b.n_pad))
        self._buckets, bucket_of, lane_of = index.scan_buckets(container, cut,
                                                               self._scan_is_float, dev)
        # by built row (pad rows: no bucket)
        self._bucket_of = _padded(torch.from_numpy(bucket_of[real]).to(dev), R, -1)
        self._lane_of = _padded(torch.from_numpy(lane_of[real]).to(dev), R)
        self._pq = None
        if not self._scan_is_float:
            self._pq = ProductQuantizer(self.d, index.pq.M, index.pq.ksub, device=dev)
            self._pq.centroids = index.pq.centroids.to(dev)

        # ---- translate: the rank's rows of the container's list-order table
        rows = torch.from_numpy(real).to(dev)
        if isinstance(container, RocInvertedLists):
            self._mode = "roc"
            src = container.decoder
            sel = rows.to(src.device)
            st = src.states
            # pad rows: a fresh state (head 2^31) of length 0
            self._decoder = RocDecoder(
                type(st)(head=_padded(st.head[sel].to(dev), R, rd.RANS_L),
                         stack=_padded(st.stack[sel].to(dev), R),
                         stack_len=_padded(st.stack_len[sel].to(dev), R),
                         mt_ctr=_padded(st.mt_ctr[sel].to(dev), R),
                         err=_padded(st.err[sel].to(dev), R)),
                _padded(src.lengths[sel].to(dev), R), _padded(src.precision[sel].to(dev), R),
                src.pool.to(dev), src.n_max)
        elif isinstance(container, PackedBitsInvertedLists):
            self._mode = "packed"
            pb = container.packed
            sel = rows.to(pb.words.device)
            self._packed = pb._replace(words=pb.words[sel].to(dev),
                                       lengths=pb.lengths[sel].to(dev))
        elif isinstance(container, EliasFanoInvertedLists):
            self._mode = "ef"
            self._ef = _to(container.ef.rows(rows.to(container.ef.m.device)), dev)
        elif isinstance(container, WaveletTreeInvertedLists):
            # one tree over every id, on every rank
            self._mode = "wt" if container.wt_type == 0 else "wt1"
            self._wt = _to(container.wt, dev)
            self._wt_tables = container.wt_tables.to(dev)
        else:
            self._mode = "raw"
            lens = container.lengths[real]
            if isinstance(container, InvertedLists):
                ids = (np.concatenate([container.ids[ln] for ln in real]) if len(real)
                       else np.zeros(0, np.uint64))
                ids = torch.from_numpy(ids.view(np.int64)).to(dev)
            else:  # decoded at construction (interleaved ROC)
                dec, _ = container.decode_lists(torch.from_numpy(real))
                valid = torch.arange(dec.shape[1], device=dec.device)[None, :] < \
                    torch.as_tensor(lens, device=dec.device)[:, None]
                ids = dec[valid].to(dev)
            offsets = np.zeros(len(real) + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            self._ids_flat = ids
            self._offsets = torch.from_numpy(offsets[:-1]).to(dev)

    # ------------------------------------------------------------------ API

    def _pair_scan(self, nprobe: int) -> bool:
        """Scan-path choice on the global shape, independent of the mesh
        size: a path that changed with it would change the tie order."""
        return 4 * nprobe < self.nlist_pad

    def search(self, xq, k: int, nprobe: int):
        """Deferred-decoding search → (D f32[nq, k], I i64[nq, k]) on the
        rank's device, the same on every rank; -1 and +inf for empty slots.
        Queries in chunks, so that the rank's dense-scan slab stays within
        ``SCAN_BUDGET`` elements; the pair scan bounds its own buffers, so
        its chunks are bound by the [nq, nprobe, k] candidates."""
        xq = torch.as_tensor(xq, dtype=torch.float32, device=self.device)
        nq = xq.shape[0]
        budget = ivf.SCAN_BUDGET
        nq_c = max(1, min(nq, budget // max(self.b_loc * self.n_pad, 1)))
        if self._pair_scan(nprobe):
            nq_c = max(nq_c, min(nq, budget // max(4 * nprobe * k, 1)))
        D = torch.empty((nq, k), dtype=torch.float32, device=self.device)
        I = torch.empty((nq, k), dtype=torch.int64, device=self.device)
        for s in range(0, nq, nq_c):
            D[s:s + nq_c], I[s:s + nq_c] = self._search_chunk(xq[s:s + nq_c], k, nprobe)
        return D, I

    def _search_chunk(self, xq: torch.Tensor, k: int, nprobe: int):
        probes = self._coarse(xq, nprobe)
        dist, labels = self._scan(xq, probes, k)
        D, L = self._merge(dist, labels, k)
        I = self._translate(L)
        if self._scan_is_float:
            # flat and QINCo distances omit the query norm; LUT distances
            # are the complete squared L2
            D = D + (xq * xq).sum(dim=1, keepdim=True)
        return torch.where(L >= 0, D, float("inf")), I

    # --------------------------------------------------------------- stages

    def _coarse(self, xq: torch.Tensor, nprobe: int) -> torch.Tensor:
        """Global top-``nprobe`` list numbers i64[nq, min(nprobe, nlist_pad)]
        by (distance, list id)."""
        off = self._lo - self._r0
        cents = self._cents[off:off + self.b_loc]
        gl = torch.arange(self._lo, self._hi, device=self.device)
        d2 = (cents * cents).sum(dim=1)[None, :] - 2.0 * (xq @ cents.T)
        d2 = torch.where((gl < self.nlist)[None, :], d2, float("inf"))
        loc_d, loc_i = _lex_topk(d2, gl[None, :].expand_as(d2), min(nprobe, self.b_loc))
        nq = xq.shape[0]
        cand_d = self.mesh.all_gather(loc_d).permute(1, 0, 2).reshape(nq, -1)
        cand_i = self.mesh.all_gather(loc_i).permute(1, 0, 2).reshape(nq, -1)
        return _lex_topk(cand_d, cand_i, nprobe)[1]

    def _scan(self, xq: torch.Tensor, probes: torch.Tensor, k: int):
        """The rank's probed lists → its top k (distances without the query
        norm for float scans f32[nq, k], labels (list << 32 | offset)
        i64[nq, k]; +inf and -1 past what its lists hold)."""
        nq, nprobe = probes.shape
        R = self._bucket_of.shape[0]
        mine = (probes >= self._lo) & (probes < self._hi)
        rows = (probes - self._r0).clamp(0, R - 1)
        b_of = torch.where(mine, self._bucket_of[rows], -1)
        inf = float("inf")
        cand_d = torch.full((nq, nprobe, k), inf, device=self.device)
        cand_l = torch.full((nq, nprobe, k), -1, dtype=torch.int64, device=self.device)

        def emit(q, p, ln, dists, offs):
            valid = torch.isfinite(dists)
            cand_d[q, p] = torch.where(valid, dists, inf)
            cand_l[q, p] = torch.where(valid, lo_build(ln[:, None], offs), -1)

        dense = self._scan_is_float and not self._pair_scan(nprobe)
        luts = None if self._scan_is_float else self._pq.compute_luts(xq)
        width = self.d if self._scan_is_float else self._pq.M
        for si, sb in enumerate(self._buckets):
            q_arr, p_arr = torch.nonzero(b_of == si, as_tuple=True)
            if q_arr.numel() == 0:
                continue
            lns = probes[q_arr, p_arr]
            lanes = self._lane_of[lns - self._r0]
            if dense:
                dists, offs = _scan_flat_dense(xq, sb, k)
                emit(q_arr, p_arr, lns, dists[q_arr, lanes], offs[q_arr, lanes])
                continue
            chunk = max(1, ivf.SCAN_BUDGET // (sb.n_pad * width))
            for s in range(0, q_arr.numel(), chunk):
                q, ln = q_arr[s:s + chunk], lanes[s:s + chunk]
                if self._scan_is_float:
                    dists, offs = _scan_flat_pairs(xq, sb, q, ln, k)
                else:
                    dists, offs = _scan_pq_pairs(luts, sb, q, ln, k)
                emit(q, p_arr[s:s + chunk], lns[s:s + chunk], dists, offs)
        return _lex_topk(cand_d.reshape(nq, -1), cand_l.reshape(nq, -1), k)

    def _merge(self, dist: torch.Tensor, labels: torch.Tensor, k: int):
        """Every rank's shortlist → the global top k (D, labels) [nq, k]."""
        nq = dist.shape[0]
        g_d = self.mesh.all_gather(dist).permute(1, 0, 2).reshape(nq, -1)
        g_l = self.mesh.all_gather(labels).permute(1, 0, 2).reshape(nq, -1)
        return _lex_topk(g_d, g_l, k)

    def _translate(self, labels: torch.Tensor) -> torch.Tensor:
        """Labels → ids i64 (-1 for -1): the rank resolves the labels of its
        lists, and a psum adds the ranks' partials."""
        flat = labels.reshape(-1)
        lns, offs = lo_listno(flat), lo_offset(flat)
        sel = torch.nonzero((flat >= 0) & (lns >= self._lo) & (lns < self._hi))[:, 0]
        part = torch.zeros_like(flat)
        if sel.numel():
            part[sel] = self._resolve(lns[sel], lns[sel] - self._r0, offs[sel])
        ids = self.mesh.psum(part)
        return torch.where(flat >= 0, ids, -1).reshape(labels.shape)

    def _resolve(self, lns: torch.Tensor, rows: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """Ids of labels of the rank's lists: list numbers ``lns``, their
        rows in the rank's tables, offsets."""
        if self._mode == "roc":
            touched, inv = torch.unique(rows, return_inverse=True)
            return self._decoder.decode_lanes(touched)[inv, offs]
        if self._mode == "packed":
            return get_single(self._packed, rows, offs)
        if self._mode == "ef":
            return ef_select(self._ef, rows, offs)
        if self._mode == "wt":
            return wt_select(self._wt, lns, offs, tables=self._wt_tables)
        if self._mode == "wt1":
            return wt_select_rrr(self._wt, lns, offs, tables=self._wt_tables)
        return self._ids_flat[self._offsets[rows] + offs]

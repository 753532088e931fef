"""IVF index with deferred ID decoding — the search-path integration.

Port of the JAX package's ``search/ivf.py`` for flat, PQ and QINCo storage
and the flat and HNSW coarse quantizers (reference
custom_invlists_impl.cpp:407-526 ``search_IVF_defer_id_decoding``):
  - coarse quantization → probe lists → scan the payload positionally
    (labels are (list_no << 32 | offset), ids never touched during the scan),
  - after the top-k is final, translate labels to ids, either by random
    access (one batched select over every label, for the containers that
    have it) or grouped per touched list (one ROC decode launch over the
    touched lists),
  - optionally harvest the shortlist's payload codes (+ listno prefix).

Everything is plain torch on the index's device:
  coarse:    [nq, d] x [d, nlist] matrix product + top-nprobe, or the graph
             search of an HNSW over the centroids (``quantizer="hnsw"``,
             -1 for the slots it does not reach; they probe nothing)
  flat scan: on the card (k up to ``ops/ivf_scan.py`` ``MAX_K``), the
             (query, list) slots grouped by list on the device, then per
             size bucket one launch of the grouped scan kernel (K5), which
             reads each probed list once for all its queries and writes
             each slot's k nearest into the candidates. Otherwise, per size
             bucket, a batched matrix-vector product over the
             gathered (query, list) probe pairs + masked top-k, in chunks of
             at most ``SCAN_BUDGET`` gathered payload elements; or, where the
             pairs cover at least a quarter of all (query, list) pairs of
             the bucket, the dense scan: every query against every list as
             matrix products over slabs of lists whose distances stay within
             ``SCAN_BUDGET`` elements, the probed pairs gathered after. PQ
             storage takes it over the codes' reconstructions (decoded on
             the device when the padded rows x d stay within
             ``PQ_DECODE_BUDGET``); QINCo storage over the linear
             reconstructions centroid + sum of the base codewords
  LUT scan:  PQ storage past that budget: per-query distance tables
             [nq, M, ksub], gathered by the codes of each probed list and
             summed over the M subspaces
  merge:     scatter into [nq, nprobe, k] candidates + one stable argsort

Scan storage is rebuilt from the active container's code order, so offsets
stay consistent after ROC reorders the payload codes into sampling order.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ..models.qinco import QincoCodec, params_from_leaves, params_to_leaves
from ..ops import ivf_scan
from ..store.invlists import InvertedLists
from ..store.ragged import bucketize
from ..utils import profiling
from .hnsw import HNSW
from .kmeans import assign, train_kmeans
from .pq import ProductQuantizer

# cap on gathered payload elements per scan chunk (1 GiB of float32)
SCAN_BUDGET = 2 ** 28
# PQ storage scans decoded reconstructions when the padded scan rows x d stay
# within this many float32 elements (4 GiB), else the LUT scan over the codes;
# the JAX package's rule, there switched by VDBIDC_PQ_DECODE_SCAN
PQ_DECODE_BUDGET = 2 ** 30
# queries per HNSW walk of ``add`` (the JAX package's 65,536): the walk's
# visited bitsets take ADD_CHUNK x nlist / 8 bytes
ADD_CHUNK = 65536


def lo_build(list_no, offset):
    return (list_no << 32) | offset


def lo_listno(label):
    return label >> 32


def lo_offset(label):
    return label & 0xFFFFFFFF


@dataclass
class _ScanBucket:
    lengths: torch.Tensor           # i64[B]
    payload: torch.Tensor           # float scan f32[B, n_pad, d]; LUT scan u8[B, M, n_pad]
    norms: Optional[torch.Tensor]   # float scan f32[B, n_pad], ||y||^2
    n_pad: int
    lists: torch.Tensor             # i64[B], each lane's list number


def _scan_flat_pairs(xq, sb: _ScanBucket, q_idx, lanes, k: int):
    """(query, lane) pairs → (dists f32[P, k] without the ||x||^2 term,
    offsets i64[P, k]), +inf past each list's end."""
    dots = torch.bmm(sb.payload[lanes], xq[q_idx][:, :, None])[:, :, 0]
    return _masked_topk(sb.norms[lanes] - 2.0 * dots, sb, lanes, k)


def _scan_flat_dense(xq, sb: _ScanBucket, k: int):
    """Every query against every lane of the bucket (the JAX package's
    ``_scan_flat_allpairs``) → (dists f32[nq, B, k] without the ||x||^2
    term, offsets i64[nq, B, k]), +inf past each list's end. Where most
    lanes are probed by many queries this beats the pair scan, whose gather
    copies a list's payload once per probing query: here the payload is
    read once, as [nq, d] x [d, slab * n_pad] matrix products over slabs of
    lanes that keep the distance buffer within ``SCAN_BUDGET`` elements."""
    nq, (B, n_pad, d) = xq.shape[0], sb.payload.shape
    slab = max(1, SCAN_BUDGET // (nq * n_pad))
    kk = min(k, n_pad)
    dists = torch.full((nq, B, k), float("inf"), device=xq.device)
    offs = torch.zeros((nq, B, k), dtype=torch.int64, device=xq.device)
    cols = torch.arange(n_pad, device=xq.device)[None, :]
    for s in range(0, B, slab):
        pay = sb.payload[s:s + slab]
        S = pay.shape[0]
        dots = (xq @ pay.reshape(S * n_pad, d).T).view(nq, S, n_pad)
        d2 = sb.norms[s:s + S][None] - 2.0 * dots
        d2.masked_fill_((cols >= sb.lengths[s:s + S][:, None])[None], float("inf"))
        dists[:, s:s + S, :kk], offs[:, s:s + S, :kk] = torch.topk(d2, kk, dim=2, largest=False,
                                                                   sorted=True)
    return dists, offs


def _scan_pq_pairs(luts, sb: _ScanBucket, q_idx, lanes, k: int):
    """LUT scan of (query, lane) pairs → (complete distances f32[P, k],
    offsets i64[P, k]): the sum over subspaces m of luts[q, m, code]
    (the JAX package's ``_scan_pq_bucket``), one subspace at a time so that
    the int64 gather index stays [P, n_pad]."""
    lut_p = luts[q_idx]        # [P, M, ksub]
    codes = sb.payload[lanes]  # [P, M, n_pad]
    d2 = torch.zeros((lanes.numel(), sb.n_pad), device=luts.device)
    for m in range(codes.shape[1]):
        d2 += torch.gather(lut_p[:, m], 1, codes[:, m].long())
    return _masked_topk(d2, sb, lanes, k)


def _masked_topk(d2, sb: _ScanBucket, lanes, k: int):
    """The scans' tail: +inf past each list's end, then the k smallest."""
    pad = torch.arange(sb.n_pad, device=d2.device)[None, :] >= sb.lengths[lanes][:, None]
    d2 = d2.masked_fill(pad, float("inf"))
    kk = min(k, sb.n_pad)
    dists, offs = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    if kk < k:
        dists = torch.nn.functional.pad(dists, (0, k - kk), value=float("inf"))
        offs = torch.nn.functional.pad(offs, (0, k - kk), value=0)
    return dists, offs


def _merge_candidates(cand_d, cand_l, k: int):
    """Candidates f32[nq, nprobe, k], i64[nq, nprobe, k] → the k nearest a
    query (D f32[nq, k], labels i64[nq, k]; +inf where the label is -1):
    one stable argsort over the nprobe * k candidates."""
    nq = cand_d.shape[0]
    cand_d = cand_d.reshape(nq, -1)
    cand_l = cand_l.reshape(nq, -1)
    order = torch.argsort(cand_d, dim=1, stable=True)[:, :k]
    D = torch.gather(cand_d, 1, order)
    L = torch.gather(cand_l, 1, order)
    return torch.where(L >= 0, D, float("inf")), L


class IndexIVF:
    """IVF index with flat (float32), PQ (``pq_m`` bytes) or QINCo payload
    and a flat or HNSW coarse quantizer, with pluggable compressed ID
    containers. Tensors live on ``device``: the card unless the caller says
    ``device="cpu"``.

    ``storage="qinco"`` takes ``qinco=QincoCodec(...)`` (on the same
    device): an entry is its residual's M code bytes and the float32
    ||lin_decode(codes)||^2 (``code_size`` M + 4); the scan reads the linear
    reconstructions (the list's centroid plus the base codewords), and a
    caller re-ranks the shortlist with ``qinco.decode`` of the harvested
    codes, as the JAX package's ``bench/search_ivf_qinco.py`` does.

    ``quantizer="hnsw"`` walks an HNSW (``quantizer_M`` links per node,
    ``quantizer_efSearch`` the least pool of a search) over the centroids
    instead of the matrix product, for the probes and for ``add``'s
    assignment, as Faiss's graph quantizers do (IndexIVF65536_HNSW32; the
    reference's 1B configuration). The HNSW is built lazily from
    ``centroids``, so a loaded index gets it too, and rebuilt when
    ``centroids`` is another tensor."""

    def __init__(self, d: int, nlist: int, storage: str = "flat", pq_m: int = 0,
                 nprobe: int = 1, qinco: Optional[QincoCodec] = None, quantizer: str = "flat",
                 quantizer_efSearch: int = 64, quantizer_M: int = 32, device=DEFAULT_DEVICE):
        _check_storage(storage, quantizer)
        if (storage == "qinco") != (qinco is not None):
            raise ValueError("storage='qinco' takes qinco=QincoCodec(...), no other storage does")
        self.d = d
        self.nlist = nlist
        self.storage = storage
        self.quantizer = quantizer
        self.quantizer_efSearch = quantizer_efSearch
        self.quantizer_M = quantizer_M
        self._quantizer_hnsw = None
        self._quantizer_src = None
        self.nprobe = nprobe
        self.device = resolve(device)  # an unavailable device raises here
        self.pq = ProductQuantizer(d, pq_m, device=self.device) if storage == "pq" else None
        self.qinco = qinco
        self.centroids: Optional[torch.Tensor] = None
        self.invlists: Optional[InvertedLists] = None
        self.active = None  # the container the search reads
        self.ntotal = 0
        self._scan: List[_ScanBucket] = []

    @property
    def code_size(self) -> int:
        if self.storage == "qinco":
            return self.qinco.M + 4
        return self.d * 4 if self.storage == "flat" else self.pq.code_size

    @property
    def coarse_code_size(self) -> int:
        """Bytes to encode a list number (reference encode_listno convention:
        ceil(log2(nlist) / 8))."""
        nbit = max((self.nlist - 1).bit_length(), 1)
        return (nbit + 7) // 8

    def _as_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ build

    def train(self, x, niter: int = 20, qinco_steps: int = 300):
        """Coarse centroids; the PQ codebooks (on the vectors, as the JAX
        package trains them) for PQ storage; for QINCo storage whose codec
        has no weights yet, the codec, trained on the residuals to the
        nearest centroid (``qinco_steps`` Adam steps)."""
        self.centroids = train_kmeans(x, self.nlist, niter=niter, device=self.device)
        if self.pq is not None:
            self.pq.train(x)
        if self.qinco is not None and self.qinco.model is None:
            x_dev = self._as_device(x)
            self.qinco.train(x_dev - self.centroids[assign(x_dev, self.centroids)],
                             steps=qinco_steps)

    def _ensure_quantizer(self):
        """The HNSW over the centroids, built at the first call and again
        whenever ``centroids`` is another tensor than the one it was built
        from (retraining or assignment must not leave the graph walking stale
        centroids)."""
        if self._quantizer_hnsw is None or self._quantizer_src is not self.centroids:
            self._quantizer_hnsw = HNSW(M=self.quantizer_M,
                                        ef_construction=max(2 * self.quantizer_M, 40),
                                        device=self.device).build(self.centroids)
            self._quantizer_src = self.centroids
        return self._quantizer_hnsw

    def coarse_assign(self, xq, nprobe: int) -> torch.Tensor:
        """Top-``nprobe`` list numbers per query, i64[nq, nprobe], through
        the configured quantizer; the HNSW one gives -1 for the slots past
        what its search reached, which callers treat as unprobed."""
        with profiling.span("ivf.coarse", self.device):
            xq = self._as_device(xq)
            if self.quantizer == "hnsw":
                ef = max(self.quantizer_efSearch, nprobe)
                return self._ensure_quantizer().search(xq, nprobe, ef=ef)[1]
            c = self.centroids
            # ||x - c||^2 up to the per-query constant ||x||^2
            d2 = (c * c).sum(dim=1)[None, :] - 2.0 * (xq @ c.T)
            return torch.topk(d2, nprobe, dim=1, largest=False, sorted=True).indices

    def add(self, x):
        if self.centroids is None:
            raise RuntimeError("train the index before adding")
        x_dev = self._as_device(x)
        if self.quantizer == "hnsw":
            # through the graph, in chunks that bound the walk's tables; a
            # vector the walk did not place goes to its exact nearest centroid
            a = torch.cat([self.coarse_assign(x_dev[s:s + ADD_CHUNK], 1)[:, 0]
                           for s in range(0, x_dev.shape[0], ADD_CHUNK)])
            missed = torch.nonzero(a < 0)[:, 0]
            if missed.numel():
                a[missed] = assign(x_dev[missed], self.centroids)
        else:
            a = assign(x_dev, self.centroids)
        if self.storage == "flat":
            codes = x_dev.cpu().numpy().view(np.uint8).reshape(len(a), -1)
        elif self.storage == "qinco":
            # M code bytes of the residual, then the 4 bytes of the float32
            # ||lin_decode||^2 (host numpy, the JAX package's bytes)
            qc = self.qinco.encode(x_dev - self.centroids[a]).cpu().numpy()
            norms = self.qinco.lin_norms(qc)
            codes = np.concatenate([qc, norms[:, None].view(np.uint8)], axis=1)
        else:
            codes = self.pq.encode(x_dev).cpu().numpy()
        a = a.cpu().numpy()
        # a second add appends to the lists, as Faiss does (the JAX package
        # starts fresh lists on every add)
        il = self.invlists or InvertedLists(self.nlist, self.code_size)
        order = np.argsort(a, kind="stable")
        bounds = np.searchsorted(a[order], np.arange(self.nlist + 1))
        for ln in range(self.nlist):
            members = order[bounds[ln]: bounds[ln + 1]]
            il.add_entries(ln, (members + self.ntotal).astype(np.uint64),
                           codes[members].reshape(-1))
        self.invlists = il
        self.ntotal += len(a)
        self.replace_invlists(il)

    def replace_invlists(self, container):
        """Swap the active ID container (source or compressed) and rebuild
        the scan storage in the container's code order. PQ storage scans
        reconstructions, decoded on the device, when the padded rows x d
        stay within ``PQ_DECODE_BUDGET``, else the codes through LUTs;
        QINCo storage scans the linear reconstructions, gathered on the
        device a bucket at a time."""
        self.active = container
        lengths = container.lengths
        dev = self.device
        buckets = bucketize(lengths)
        self._scan_is_float = self.decoded_scan(buckets)
        self._scan, bucket_of, lane_of = self.scan_buckets(container, buckets,
                                                           self._scan_is_float, dev)
        self._bucket_of = torch.from_numpy(bucket_of).to(dev)
        self._lane_of = torch.from_numpy(lane_of).to(dev)
        # flat tables: entry offsets per list, codes (host) for the harvest,
        # and ids for the uncompressed container's translate
        offsets = np.zeros(self.nlist + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        self._list_offsets = torch.from_numpy(offsets).to(dev)
        self._codes_offsets = offsets * self.code_size
        self._codes_flat = np.concatenate(
            [np.asarray(container.get_codes(ln), np.uint8) for ln in range(self.nlist)])
        self._ids_flat = None
        if isinstance(container, InvertedLists):
            self._ids_flat = torch.from_numpy(
                np.concatenate(container.ids).view(np.int64)).to(dev)

    def decoded_scan(self, buckets) -> bool:
        """Whether the scan over the size ``buckets`` (``store/ragged.py``)
        reads float payload: always for flat and QINCo storage; for PQ
        storage where the buckets' padded rows x d stay within
        ``PQ_DECODE_BUDGET``."""
        pad_rows = sum(len(b.list_ids) * b.n_pad for b in buckets)
        return self.pq is None or pad_rows * self.d <= PQ_DECODE_BUDGET

    def scan_buckets(self, container, buckets, decoded: bool, device):
        """The scan storage of ``container``'s lists in ``buckets`` (size
        buckets of list numbers), in its code order, on ``device``: (one
        ``_ScanBucket`` per bucket, each list's bucket i64[nlist] (-1 for a
        list in none), its lane in the bucket). ``decoded``: PQ codes as
        reconstructions (else u8[B, M, n_pad] for the LUT scan)."""
        scan = []
        bucket_of = np.full(self.nlist, -1, dtype=np.int64)
        lane_of = np.zeros(self.nlist, dtype=np.int64)
        cs = self.code_size
        for si, bucket in enumerate(buckets):
            lists = bucket.list_ids
            codes = np.zeros((len(lists), bucket.n_pad, cs), np.uint8)
            for lane, ln in enumerate(lists):
                rows = container.get_codes(int(ln)).reshape(-1, cs)
                codes[lane, : len(rows)] = rows
            bucket_of[lists] = si
            lane_of[lists] = np.arange(len(lists))
            if self.storage == "flat":
                payload = torch.from_numpy(codes.view(np.float32)).to(device)
            elif self.storage == "qinco":
                payload = self._qinco_payload(codes, lists).to(device)
            else:
                payload = torch.from_numpy(codes).to(self.device)
                payload = (self.pq.decode(payload) if decoded
                           else payload.permute(0, 2, 1).contiguous()).to(device)
            scan.append(_ScanBucket(
                lengths=torch.from_numpy(bucket.lengths.astype(np.int64)).to(device),
                payload=payload, n_pad=bucket.n_pad,
                norms=(payload * payload).sum(dim=2) if decoded else None,
                lists=torch.from_numpy(lists.astype(np.int64)).to(device)))
        return scan, bucket_of, lane_of

    def _qinco_payload(self, codes: np.ndarray, list_ids: np.ndarray) -> torch.Tensor:
        """The scan payload f32[B, n_pad, d] of a bucket's QINCo entries u8[B,
        n_pad, M + 4]: the linear reconstruction plus the list's centroid,
        added in the JAX package's order (its host ``lin_decode`` and then
        the centroid), so each entry is its float32 value there."""
        cb = self.qinco.codebooks
        c = torch.from_numpy(codes[:, :, :self.qinco.M]).to(self.device).long()
        payload = torch.zeros((*c.shape[:2], self.d), device=self.device)
        for m in range(self.qinco.M):
            payload += cb[m][c[:, :, m]]
        return payload + self.centroids[torch.from_numpy(list_ids).to(self.device)][:, None, :]

    # ----------------------------------------------------------------- search

    def search_positional(self, xq, k: int, nprobe: Optional[int] = None):
        """Scan only: (D f32[nq, k], labels i64[nq, k]) with packed
        (list_no << 32 | offset) labels, -1 for empty slots — the equivalent
        of search_preassigned(store_pairs=true)
        (custom_invlists_impl.cpp:427-428)."""
        with profiling.span("ivf.positional", self.device):
            nprobe = nprobe or self.nprobe
            xq = self._as_device(xq)
            probes = self.coarse_assign(xq, nprobe)
            with profiling.span("ivf.scan", self.device):
                # the grouped scan kernel keeps at most MAX_K nearest a slot
                if self._scan_is_float and xq.is_cuda and k <= ivf_scan.MAX_K:
                    cand_d, cand_l = self._scan_grouped(xq, probes, k)
                else:
                    cand_d, cand_l = self._scan_pairs(xq, probes, k)
            return _merge_candidates(cand_d, cand_l, k)

    def _candidates(self, nq: int, nprobe: int, k: int):
        """Empty candidates: (+inf f32[nq, nprobe, k], -1 i64[nq, nprobe, k])."""
        return (torch.full((nq, nprobe, k), float("inf"), device=self.device),
                torch.full((nq, nprobe, k), -1, dtype=torch.int64, device=self.device))

    def _scan_grouped(self, xq, probes, k: int):
        """The float buckets' scan through ``ops/ivf_scan.py`` → candidates
        (f32[nq, nprobe, k], i64[nq, nprobe, k]): the slots grouped by list
        on the device, then one ``scan_flat_grouped`` a bucket (the kernel
        K5 on the card, its plain version on the CPU); no host sync."""
        nq, nprobe = probes.shape
        cand_d, cand_l = self._candidates(nq, nprobe, k)
        x2 = (xq * xq).sum(dim=1)
        order, starts = ivf_scan.group_slots(probes, self._bucket_of)
        for sb in self._scan:
            ivf_scan.scan_flat_grouped(xq, x2, sb.payload, sb.norms, sb.lengths, sb.lists,
                                       order, starts, nprobe, k, cand_d, cand_l)
        profiling.count("scan_grouped_slots", nq * nprobe)
        return cand_d, cand_l

    def _scan_pairs(self, xq, probes, k: int):
        """The per-bucket torch scan → candidates (f32[nq, nprobe, k],
        i64[nq, nprobe, k]): each bucket's (query, probe) pairs found by a
        ``nonzero`` (a host sync), then the dense scan where they cover a
        quarter of the bucket's pairs (float payload), else the pair scan
        (float payload, or ``compute_luts`` and the LUT scan) in chunks of
        ``SCAN_BUDGET``."""
        inf = float("inf")
        nq, nprobe = probes.shape
        cand_d, cand_l = self._candidates(nq, nprobe, k)
        profiling.count("scan_grouped_slots", 0)
        luts = None
        if self._scan_is_float:
            x2 = (xq * xq).sum(dim=1)
            width = self.d
        else:
            luts = self.pq.compute_luts(xq)
            x2 = torch.zeros(nq, device=self.device)  # LUT distances are complete
            width = self.pq.M

        def emit(q, p, ln, dists, offs):
            valid = torch.isfinite(dists)
            cand_d[q, p] = torch.where(valid, dists + x2[q, None], inf)
            cand_l[q, p] = torch.where(valid, lo_build(ln[:, None], offs), -1)

        # bucket -1 for empty lists and for -1 probes (an HNSW quantizer's
        # unreached slots), which must not index the table
        b_of = torch.where(probes >= 0, self._bucket_of[probes.clamp(min=0)], -1)
        for si, sb in enumerate(self._scan):
            q_arr, p_arr = torch.nonzero(b_of == si, as_tuple=True)
            profiling.count("host_syncs")
            lns = probes[q_arr, p_arr]
            lanes = self._lane_of[lns]
            # the JAX package's rule: the dense scan pays the whole bucket's
            # top-k, so only where the pairs cover a quarter of it
            if self._scan_is_float and 4 * q_arr.numel() >= nq * sb.lengths.numel():
                dists, offs = _scan_flat_dense(xq, sb, k)
                emit(q_arr, p_arr, lns, dists[q_arr, lanes], offs[q_arr, lanes])
                continue
            chunk = max(1, SCAN_BUDGET // (sb.n_pad * width))
            for s in range(0, q_arr.numel(), chunk):
                q, p, ln = q_arr[s:s + chunk], p_arr[s:s + chunk], lns[s:s + chunk]
                if self._scan_is_float:
                    dists, offs = _scan_flat_pairs(xq, sb, q, lanes[s:s + chunk], k)
                else:
                    dists, offs = _scan_pq_pairs(luts, sb, q, lanes[s:s + chunk], k)
                emit(q, p, ln, dists, offs)
        return cand_d, cand_l

    def search_defer_id_decoding(self, xq, k: int, nprobe: Optional[int] = None,
                                 decode_1by1: Optional[bool] = None, return_codes: int = 0,
                                 include_listno: bool = False):
        """Full deferred-decoding search (reference C13 + swig wrapper B1).

        decode_1by1: translate the labels by random access (True) or grouped
        per touched list (False); None takes the active container's
        ``supports_random_access``. return_codes: 0 = no codes, nonzero =
        also return the shortlist's payload codes (2 in the reference means
        include the listno prefix — here also expressed via include_listno).
        Returns (D, I) or (D, I, codes), tensors on the index's device."""
        with profiling.span("ivf.search", self.device):
            D, L = self.search_positional(xq, k, nprobe)
            if decode_1by1 is None:
                decode_1by1 = getattr(self.active, "supports_random_access", True)
            codes = None
            if return_codes:
                codes = self._harvest_codes(L, include_listno or return_codes == 2)
            I = self._translate(L, decode_1by1)
        return (D, I) if codes is None else (D, I, codes)

    def search(self, xq, k: int, nprobe: Optional[int] = None):
        """Standard search: ids translated for every result."""
        return self.search_defer_id_decoding(xq, k, nprobe)

    # ----------------------------------------------------- translation & codes

    def _translate(self, labels: torch.Tensor, decode_1by1: bool = False) -> torch.Tensor:
        """Labels → ids: for compressed containers by one batched random
        access (``decode_1by1`` and the container supports it), else grouped
        per touched list (reference custom_invlists_impl.cpp:477-525)."""
        with profiling.span("ivf.translate", self.device):
            flat = labels.reshape(-1)
            valid = flat >= 0
            lns, offs = lo_listno(flat[valid]), lo_offset(flat[valid])
            profiling.count("host_syncs", 2)  # the two boolean-mask gathers
            if self._ids_flat is not None:
                ids = self._ids_flat[self._list_offsets[lns] + offs]
            elif decode_1by1 and self.active.supports_random_access:
                ids = self.active.get_single_ids_batch(lns, offs)
            else:
                ids = self.active.decode_select(lns, offs)
            out = flat.clone()
            out[valid] = ids
            profiling.count("host_syncs")
            return out.reshape(labels.shape)

    def _harvest_codes(self, labels: torch.Tensor, include_listno: bool) -> torch.Tensor:
        """Shortlist payload codes u8[nq, k, cs (+ listno bytes)], 0xff for
        empty slots (reference .cpp:433-462); gathered from the host code
        table."""
        cs = self.code_size
        ccs = self.coarse_code_size if include_listno else 0
        flat = labels.reshape(-1).cpu().numpy()
        out = np.full((len(flat), cs + ccs), 0xFF, dtype=np.uint8)
        valid = np.flatnonzero(flat >= 0)
        lns, offs = lo_listno(flat[valid]), lo_offset(flat[valid])
        starts = self._codes_offsets[lns] + offs * cs
        out[valid, ccs:] = self._codes_flat[starts[:, None] + np.arange(cs)]
        if ccs:
            # little-endian listno prefix (reference encode_listno)
            out[valid, :ccs] = (lns[:, None] >> (8 * np.arange(ccs))) & 0xFF
        return torch.from_numpy(out.reshape(*labels.shape, cs + ccs)).to(self.device)


def _check_storage(storage: str, quantizer: str) -> None:
    if storage not in ("flat", "pq", "qinco") or quantizer not in ("flat", "hnsw"):
        raise ValueError(f"unknown storage={storage!r} or quantizer={quantizer!r}")


def save_index(path, index: IndexIVF) -> None:
    """Write the index as the JAX package's ``search.ivf.save_index`` does,
    byte for byte: one .npz with the trained index and its uncompressed
    inverted lists (none for an index that was trained only). Compressed id
    containers are saved on their own (``store.serialize.save_invlists``)
    and swapped in after ``load_index`` with ``replace_invlists``. The file
    holds an HNSW quantizer's parameters, not its graph (the JAX package
    builds it again from the centroids; ``store.serialize.save_hnsw`` saves
    it). QINCo storage adds ``qinco_meta`` [d, M, ksub, hidden] and the
    codec's weights as ``qinco_leaf{i}``, in the order of the JAX package's
    parameter leaves (``models.qinco.params_to_leaves``)."""
    _check_storage(index.storage, index.quantizer)
    if index.centroids is None:
        raise RuntimeError("train the index before saving it")
    il = index.invlists or InvertedLists(index.nlist, index.code_size)
    lengths = il.lengths
    ids_flat = np.concatenate(il.ids) if lengths.sum() else np.zeros(0, np.uint64)
    codes_flat = np.concatenate(il.codes) if lengths.sum() else np.zeros(0, np.uint8)
    meta = dict(d=index.d, nlist=index.nlist, storage=index.storage, nprobe=index.nprobe,
                ntotal=index.ntotal, code_size=index.code_size, quantizer=index.quantizer,
                quantizer_efSearch=index.quantizer_efSearch, quantizer_M=index.quantizer_M)
    arrs = dict(centroids=index.centroids.cpu().numpy(), lengths=lengths, ids_flat=ids_flat,
                codes_flat=codes_flat, meta=np.array(json.dumps(meta)))
    if index.storage == "pq":
        arrs["pq_centroids"] = index.pq.centroids.cpu().numpy()
        arrs["pq_meta"] = np.array([index.pq.M], dtype=np.int64)
    elif index.storage == "qinco":
        q = index.qinco
        arrs["qinco_meta"] = np.array([q.d, q.M, q.ksub, q.hidden], dtype=np.int64)
        for i, leaf in enumerate(params_to_leaves(q)):
            arrs[f"qinco_leaf{i}"] = leaf
    np.savez(path, **arrs)


def load_index(path, device=DEFAULT_DEVICE) -> IndexIVF:
    """Read the .npz that ``save_index`` (of either package) writes
    (centroids, lengths, ids_flat, codes_flat, meta, and for PQ storage
    pq_centroids and pq_meta, for QINCo storage qinco_meta and the
    qinco_leaf arrays) into a port index on ``device`` holding the same
    inverted lists, codebooks and weights. Flat, PQ and QINCo storage, flat
    and HNSW quantizers (with its ``quantizer_efSearch`` and
    ``quantizer_M``)."""
    device = resolve(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        centroids = z["centroids"]
        lengths = z["lengths"]
        ids_flat = z["ids_flat"]
        codes_flat = z["codes_flat"]
        pq = (int(z["pq_meta"][0]), z["pq_centroids"]) if meta["storage"] == "pq" else None
        qinco = None
        if meta["storage"] == "qinco":
            d, M, ksub, hidden = (int(v) for v in z["qinco_meta"])
            qinco = QincoCodec(d, M, ksub=ksub, hidden=hidden, device=device)
            qinco.load_state_dict(params_from_leaves(
                [z[f"qinco_leaf{i}"] for i in range(5 * M)], d, M, ksub, hidden))
    index = IndexIVF(meta["d"], meta["nlist"], storage=meta["storage"],
                     pq_m=pq[0] if pq else 0, nprobe=meta["nprobe"], qinco=qinco,
                     quantizer=meta.get("quantizer", "flat"),
                     quantizer_efSearch=meta.get("quantizer_efSearch", 64),
                     quantizer_M=meta.get("quantizer_M", 32), device=device)
    index.centroids = torch.as_tensor(centroids, dtype=torch.float32, device=index.device)
    if pq:
        index.pq.centroids = torch.as_tensor(pq[1], dtype=torch.float32, device=index.device)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    cs = meta["code_size"]
    il = InvertedLists(meta["nlist"], cs)
    for ln in range(meta["nlist"]):
        b, e = offsets[ln], offsets[ln + 1]
        il.add_entries(ln, ids_flat[b:e], codes_flat[b * cs:e * cs])
    index.ntotal = meta["ntotal"]
    if index.ntotal > 0:
        index.invlists = il
        index.replace_invlists(il)
    return index

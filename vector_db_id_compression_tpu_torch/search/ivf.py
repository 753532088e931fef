"""IVF index with deferred ID decoding — the search-path integration.

Port of the JAX package's ``search/ivf.py`` for flat storage and the flat
coarse quantizer (reference custom_invlists_impl.cpp:407-526
``search_IVF_defer_id_decoding``):
  - coarse quantization → probe lists → scan the payload positionally
    (labels are (list_no << 32 | offset), ids never touched during the scan),
  - after the top-k is final, translate labels to ids grouped per touched
    list (one ROC decode launch over the touched lists),
  - optionally harvest the shortlist's payload codes (+ listno prefix).

Everything is plain torch on the index's device:
  coarse:    [nq, d] x [d, nlist] matrix product + top-nprobe
  flat scan: per size bucket, a batched matrix-vector product over the
             gathered (query, list) probe pairs + masked top-k, in chunks of
             at most ``SCAN_BUDGET`` gathered payload elements
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

from ..store.invlists import InvertedLists
from ..store.ragged import bucketize
from .kmeans import assign, train_kmeans

# cap on gathered payload elements per scan chunk (1 GiB of float32)
SCAN_BUDGET = 2 ** 28


def lo_build(list_no, offset):
    return (list_no << 32) | offset


def lo_listno(label):
    return label >> 32


def lo_offset(label):
    return label & 0xFFFFFFFF


@dataclass
class _ScanBucket:
    lengths: torch.Tensor  # i64[B]
    vecs: torch.Tensor     # f32[B, n_pad, d]
    norms: torch.Tensor    # f32[B, n_pad], ||y||^2
    n_pad: int


def _scan_flat_pairs(xq, sb: _ScanBucket, q_idx, lanes, k: int):
    """(query, lane) pairs → (dists f32[P, k] without the ||x||^2 term,
    offsets i64[P, k]), +inf past each list's end."""
    dots = torch.bmm(sb.vecs[lanes], xq[q_idx][:, :, None])[:, :, 0]
    d2 = sb.norms[lanes] - 2.0 * dots
    pad = torch.arange(sb.n_pad, device=d2.device)[None, :] >= sb.lengths[lanes][:, None]
    d2 = d2.masked_fill(pad, float("inf"))
    kk = min(k, sb.n_pad)
    dists, offs = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    if kk < k:
        dists = torch.nn.functional.pad(dists, (0, k - kk), value=float("inf"))
        offs = torch.nn.functional.pad(offs, (0, k - kk), value=0)
    return dists, offs


class IndexIVF:
    """IVF index with flat (float32) payload and a flat coarse quantizer,
    with pluggable compressed ID containers. Tensors live on ``device``."""

    def __init__(self, d: int, nlist: int, storage: str = "flat",
                 nprobe: int = 1, quantizer: str = "flat", device="cpu"):
        if storage != "flat" or quantizer != "flat":
            raise NotImplementedError(
                f"storage={storage!r}, quantizer={quantizer!r}: only flat "
                "storage with the flat quantizer is ported")
        self.d = d
        self.nlist = nlist
        self.nprobe = nprobe
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # an unavailable device raises here
        self.centroids: Optional[torch.Tensor] = None
        self.invlists: Optional[InvertedLists] = None
        self.active = None  # the container the search reads
        self.ntotal = 0
        self._scan: List[_ScanBucket] = []

    @property
    def code_size(self) -> int:
        return self.d * 4

    @property
    def coarse_code_size(self) -> int:
        """Bytes to encode a list number (reference encode_listno convention:
        ceil(log2(nlist) / 8))."""
        nbit = max((self.nlist - 1).bit_length(), 1)
        return (nbit + 7) // 8

    def _as_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ build

    def train(self, x, niter: int = 20):
        self.centroids = train_kmeans(x, self.nlist, niter=niter, device=self.device)

    def coarse_assign(self, xq, nprobe: int) -> torch.Tensor:
        """Top-``nprobe`` list numbers per query, i64[nq, nprobe]."""
        xq = self._as_device(xq)
        c = self.centroids
        # ||x - c||^2 up to the per-query constant ||x||^2
        d2 = (c * c).sum(dim=1)[None, :] - 2.0 * (xq @ c.T)
        return torch.topk(d2, nprobe, dim=1, largest=False, sorted=True).indices

    def add(self, x):
        if self.centroids is None:
            raise RuntimeError("train the index before adding")
        x_dev = self._as_device(x)
        a = assign(x_dev, self.centroids).cpu().numpy()
        codes = x_dev.cpu().numpy().view(np.uint8).reshape(len(a), -1)
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
        the scan storage in the container's code order."""
        self.active = container
        lengths = container.lengths
        dev = self.device
        self._scan = []
        bucket_of = np.full(self.nlist, -1, dtype=np.int64)
        lane_of = np.zeros(self.nlist, dtype=np.int64)
        for si, bucket in enumerate(bucketize(lengths)):
            vecs = np.zeros((len(bucket.list_ids), bucket.n_pad, self.d), np.float32)
            for lane, ln in enumerate(bucket.list_ids):
                rows = container.get_codes(int(ln)).view(np.float32).reshape(-1, self.d)
                vecs[lane, : len(rows)] = rows
            bucket_of[bucket.list_ids] = si
            lane_of[bucket.list_ids] = np.arange(len(bucket.list_ids))
            vecs_t = torch.from_numpy(vecs).to(dev)
            self._scan.append(_ScanBucket(
                lengths=torch.from_numpy(bucket.lengths.astype(np.int64)).to(dev),
                vecs=vecs_t, norms=(vecs_t * vecs_t).sum(dim=2), n_pad=bucket.n_pad))
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

    # ----------------------------------------------------------------- search

    def search_positional(self, xq, k: int, nprobe: Optional[int] = None):
        """Scan only: (D f32[nq, k], labels i64[nq, k]) with packed
        (list_no << 32 | offset) labels, -1 for empty slots — the equivalent
        of search_preassigned(store_pairs=true)
        (custom_invlists_impl.cpp:427-428)."""
        nprobe = nprobe or self.nprobe
        xq = self._as_device(xq)
        nq = xq.shape[0]
        probes = self.coarse_assign(xq, nprobe)
        b_of = self._bucket_of[probes]            # -1 for empty lists
        x2 = (xq * xq).sum(dim=1)
        inf = float("inf")
        cand_d = torch.full((nq, nprobe, k), inf, device=self.device)
        cand_l = torch.full((nq, nprobe, k), -1, dtype=torch.int64, device=self.device)
        for si, sb in enumerate(self._scan):
            q_arr, p_arr = torch.nonzero(b_of == si, as_tuple=True)
            lns = probes[q_arr, p_arr]
            lanes = self._lane_of[lns]
            chunk = max(1, SCAN_BUDGET // (sb.n_pad * self.d))
            for s in range(0, q_arr.numel(), chunk):
                q, p, ln = q_arr[s:s + chunk], p_arr[s:s + chunk], lns[s:s + chunk]
                dists, offs = _scan_flat_pairs(xq, sb, q, lanes[s:s + chunk], k)
                valid = torch.isfinite(dists)
                cand_d[q, p] = torch.where(valid, dists + x2[q, None], inf)
                cand_l[q, p] = torch.where(valid, lo_build(ln[:, None], offs), -1)
        cand_d = cand_d.reshape(nq, nprobe * k)
        cand_l = cand_l.reshape(nq, nprobe * k)
        order = torch.argsort(cand_d, dim=1, stable=True)[:, :k]
        D = torch.gather(cand_d, 1, order)
        L = torch.gather(cand_l, 1, order)
        return torch.where(L >= 0, D, inf), L

    def search_defer_id_decoding(self, xq, k: int, nprobe: Optional[int] = None,
                                 return_codes: int = 0, include_listno: bool = False):
        """Full deferred-decoding search (reference C13 + swig wrapper B1).

        return_codes: 0 = no codes, nonzero = also return the shortlist's
        payload codes (2 in the reference means include the listno prefix —
        here also expressed via include_listno). Returns (D, I) or
        (D, I, codes), tensors on the index's device."""
        D, L = self.search_positional(xq, k, nprobe)
        codes = None
        if return_codes:
            codes = self._harvest_codes(L, include_listno or return_codes == 2)
        I = self._translate(L)
        return (D, I) if codes is None else (D, I, codes)

    def search(self, xq, k: int, nprobe: Optional[int] = None):
        """Standard search: ids translated for every result."""
        return self.search_defer_id_decoding(xq, k, nprobe)

    # ----------------------------------------------------- translation & codes

    def _translate(self, labels: torch.Tensor) -> torch.Tensor:
        """Labels → ids; grouped per touched list for compressed containers
        (reference custom_invlists_impl.cpp:477-525)."""
        flat = labels.reshape(-1)
        valid = flat >= 0
        lns, offs = lo_listno(flat[valid]), lo_offset(flat[valid])
        if self._ids_flat is not None:
            ids = self._ids_flat[self._list_offsets[lns] + offs]
        else:
            ids = self.active.decode_select(lns, offs)
        out = flat.clone()
        out[valid] = ids
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


def load_index(path, device="cpu") -> IndexIVF:
    """Read the .npz that the JAX package's ``search.ivf.save_index`` writes
    (centroids, lengths, ids_flat, codes_flat, meta) into a port index on
    ``device`` holding the same inverted lists. Flat storage only."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        centroids = z["centroids"]
        lengths = z["lengths"]
        ids_flat = z["ids_flat"]
        codes_flat = z["codes_flat"]
    index = IndexIVF(meta["d"], meta["nlist"], storage=meta["storage"],
                     nprobe=meta["nprobe"],
                     quantizer=meta.get("quantizer", "flat"), device=device)
    index.centroids = torch.as_tensor(centroids, dtype=torch.float32, device=index.device)
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

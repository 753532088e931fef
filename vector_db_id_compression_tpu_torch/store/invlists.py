"""Inverted-list containers with compressed IDs.

Port of the JAX package's ``store/invlists.py`` (reference
custom_invlist_cpp/custom_invlists_impl.h:22-124):

  InvertedLists                — the uncompressed source container (host numpy)
  CompressedInvertedLists      — common bookkeeping and the grouped translate
  PackedBitsInvertedLists      — reference C9: fixed-width ids, O(1) random access
  RocInvertedLists             — reference C10: per-list ANS states, decoded a
                                 whole list at a time
  EliasFanoInvertedLists       — reference C11: sorted ids + Elias-Fano, O(1) select
  WaveletTreeInvertedLists     — reference C12: one wavelet tree over list_nos
                                 (plain planes, or RRR-compressed: wt_type 1)
  InterleavedRocInvertedLists  — framework extension: long lists coded as
                                 several independent chunk lanes

ROC reorders each list's payload codes into the encode sampling order and
Elias-Fano into ascending-id order; the wavelet tree needs ascending ids per
list and leaves the codes as they are. ``compressed_ids_size_in_bytes``
counts what each reference constructor counts; ``overhead_in_bytes`` what a
container stores beyond it (select directories, interleaved envelopes).

Each container keeps one table for the whole index: a lane (row) per list,
or per chunk of one, instead of the JAX package's size buckets. Decoding any
set of lists is one pass (one decode launch for ROC), and the random-access
containers (``supports_random_access``) answer a batch of (list, offset)
labels with one batched select (``get_single_ids_batch``).
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import numpy as np
import torch

from ..codecs import roc_device as rd
from ..codecs.elias_fano import ef_decode_all, ef_encode_rows, ef_select
from ..codecs.packed_bits import get_single, pack_lists, packed_width, unpack_all
from ..codecs.roc import precision_for_max_id_safe
from ..codecs.roc_interleaved import chunk_plan
from ..codecs.rrr import rrr_encode_planes
from ..codecs.wavelet_tree import (
    build_wavelet_tree,
    wt_path_tables,
    wt_planes,
    wt_select,
    wt_select_rrr,
)
from ..core.bits import directory_entries
from ..device import DEFAULT_DEVICE, resolve
from ..ops.roc_decode import RocDecoder
from ..ops.roc_encode import RocEncoder
from ..utils import profiling
from .ragged import pad_lists


class InvertedLists:
    """Uncompressed ragged inverted lists (ids + payload codes), on the host."""

    def __init__(self, nlist: int, code_size: int):
        self.nlist = nlist
        self.code_size = code_size
        self.ids: List[np.ndarray] = [np.empty(0, dtype=np.uint64) for _ in range(nlist)]
        self.codes: List[np.ndarray] = [np.empty(0, dtype=np.uint8) for _ in range(nlist)]

    def add_entries(self, list_no: int, ids: np.ndarray, codes: np.ndarray):
        ids = np.asarray(ids, dtype=np.uint64)
        self.ids[list_no] = np.concatenate([self.ids[list_no], ids])
        self.codes[list_no] = np.concatenate([self.codes[list_no], np.asarray(codes, np.uint8)])

    @property
    def lengths(self) -> np.ndarray:
        return np.array([len(v) for v in self.ids], dtype=np.int64)

    def get_codes(self, list_no: int) -> np.ndarray:
        return self.codes[list_no]


class CompressedInvertedLists:
    """Base: common bookkeeping and the grouped translate over
    ``decode_lists``. ``overhead_in_bytes`` counts what a container stores
    beyond the reference's per-list streams (the interleaved lanes'
    envelopes). Its tensors live on ``device``: the card unless the caller
    says ``device="cpu"``."""

    supports_random_access = False

    def __init__(self, il: InvertedLists, device=DEFAULT_DEVICE):
        self.nlist = il.nlist
        self.code_size = il.code_size
        self.device = resolve(device)
        self._lengths = il.lengths.copy()
        self.compressed_ids_size_in_bytes = 0
        self.overhead_in_bytes = 0
        self.codes_all: List[np.ndarray] = []

    def list_size(self, list_no: int) -> int:
        return int(self._lengths[list_no])

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    def get_codes(self, list_no: int) -> np.ndarray:
        return self.codes_all[list_no]

    def decode_lists(self, list_nos) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode several lists → (ids i64[Q, max_len] zero-padded, lengths
        i64[Q]), on the container's device."""
        raise NotImplementedError

    def get_single_ids_batch(self, list_nos, offsets) -> torch.Tensor:
        """Ids of (list, offset) labels by O(1) random access → i64[n], on
        the container's device (``supports_random_access`` containers)."""
        raise NotImplementedError(f"{type(self).__name__} has no O(1) random access")

    def get_single_id(self, list_no: int, offset: int) -> int:
        """One id by (list, offset), through ``get_single_ids_batch``."""
        if not self.supports_random_access:
            raise NotImplementedError(f"{type(self).__name__} has no O(1) random access")
        return int(self.get_single_ids_batch(torch.tensor([list_no]), torch.tensor([offset]))[0])

    def decode_select(self, list_nos, offsets) -> torch.Tensor:
        """Grouped deferred translate (reference custom_invlists_impl.cpp:
        477-525): decode each touched list once, then gather the labels'
        offsets on the device → ids i64[n]."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)
        if list_nos.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        touched, inv = torch.unique(list_nos, return_inverse=True)
        profiling.count("host_syncs")
        decoded, _ = self.decode_lists(touched)
        return decoded[inv, offsets]

    def get_ids(self, list_no: int) -> torch.Tensor:
        ids, lens = self.decode_lists(torch.tensor([list_no]))
        return ids[0, : int(lens[0])]


def sorted_lane_table(il: InvertedLists, codec: str = "ROC"):
    """One lane per list: (sorted ids u64[nlist, n_max] zero-padded, per-list
    stable argsort permutations). The port carries ids in int64, so an id of
    2^63 or more raises."""
    lengths = il.lengths
    n_max = max(int(lengths.max(initial=0)), 1)
    sorted_ids = np.zeros((il.nlist, n_max), dtype=np.uint64)
    perms = []
    for ln in range(il.nlist):
        v = il.ids[ln]
        perm = np.argsort(v, kind="stable")
        perms.append(perm)
        sorted_ids[ln, : len(v)] = v[perm]
        if len(v) and int(v.max()) >= 1 << 63:
            raise ValueError(f"{codec} ids must be < 2^63")
    return sorted_ids, perms


def roc_lane_table(il: InvertedLists):
    """One ROC lane per list: (sorted ids u64[nlist, n_max] zero-padded,
    lengths i32[nlist], safe precisions i32[nlist], per-list argsort
    permutations) — the encode kernel's input for the whole index."""
    lengths = il.lengths
    sorted_ids, perms = sorted_lane_table(il)
    prec = np.zeros(il.nlist, dtype=np.int32)
    for ln in np.flatnonzero(lengths):
        prec[ln] = precision_for_max_id_safe(int(sorted_ids[ln, lengths[ln] - 1]))
    return sorted_ids, lengths.astype(np.int32), prec, perms


class RocInvertedLists(CompressedInvertedLists):
    """Per-list ANS states on ``device``; a list decodes only whole, so the
    deferred search uses the grouped translate (as the reference: no
    get_single_id). ``decoder`` decodes any subset of the lists in one
    launch."""

    def __init__(self, il: InvertedLists, device=DEFAULT_DEVICE):
        super().__init__(il, device)
        sorted_ids, lengths, prec, perms = roc_lane_table(il)
        self.id_symbol_precision = prec.astype(np.int64)
        dev = self.device
        lengths_t = torch.from_numpy(lengths).to(dev)
        prec_t = torch.from_numpy(prec).to(dev)
        states, order = RocEncoder.encode(
            torch.from_numpy(sorted_ids.view(np.int64)).to(dev), lengths_t, prec_t)
        order = order.cpu().numpy()
        # payload codes reordered to the encode sampling order
        self.codes_all = [
            _reorder_codes(il.codes[ln], perms[ln][order[ln, : lengths[ln]]],
                           il.code_size)
            for ln in range(il.nlist)
        ]
        size = states.size_bytes.cpu().numpy()
        self.compressed_ids_size_in_bytes = int(size[lengths > 0].sum())
        n_max = sorted_ids.shape[1]
        self.decoder = RocDecoder(states, lengths_t, prec_t,
                                  rd.default_pool(n_max, dev), n_max)

    def decode_lists(self, list_nos):
        """One decode launch over the given lists (ids in sampling order)."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        lens = self.decoder.lengths[list_nos].to(torch.int64)
        max_len = max(int(lens.max()) if lens.numel() else 0, 1)
        profiling.count("host_syncs")
        return self.decoder.decode_lanes(list_nos)[:, :max_len], lens


class InterleavedLaneTable(NamedTuple):
    """The chunk entries of an interleaved container, one ROC lane each,
    numbered list by list and chunk by chunk: entry ``lane_start[ln] + s``
    is chunk s of list ln."""

    ids: np.ndarray          # u64[E, n_max] rebased chunk ids, ascending, 0-padded
    lengths: np.ndarray      # i32[E]
    precision: np.ndarray    # i32[E]
    lo: np.ndarray           # u64[E] chunk minima (0 for one-chunk lists)
    starts: np.ndarray       # i64[E] the chunk's first position in its sorted list
    lane_start: np.ndarray   # i64[nlist] first entry of each list
    n_lanes: np.ndarray      # i64[nlist] chunks per list (0 for an empty list)
    perms: List[np.ndarray]  # per-list argsort permutations
    list_precision: np.ndarray  # i64[nlist] safe precision of each list's ids


# the auto policy's chunk length: per-id decode cost is U-shaped in lane
# length; the JAX package's codec_scale sweep put the optimum near 512 on the
# TPU
AUTO_CHUNK_TARGET = 512


def interleaved_lane_table(il: InvertedLists, interleave="auto",
                           interleave_min: int = 4096) -> InterleavedLaneTable:
    """The encode kernel's input for ``InterleavedRocInvertedLists``: every
    list cut into S chunks by the policy (``"auto"``: S = ceil(n / 512) for
    n > 768, else 1; an integer: S = interleave for lists of at least
    max(interleave_min, interleave) ids, else 1). One-chunk lists keep their
    full ids and list precision, the reference's single-stream format;
    longer ones follow ``chunk_plan``."""
    auto = interleave == "auto"
    if not auto and not (isinstance(interleave, (int, np.integer)) and interleave >= 1):
        raise ValueError(f"interleave must be 'auto' or an integer >= 1, got {interleave!r}")
    chunks, prec, lo, starts, perms = [], [], [], [], []
    n_lanes = np.zeros(il.nlist, dtype=np.int64)
    list_prec = np.zeros(il.nlist, dtype=np.int64)
    for ln in range(il.nlist):
        v = il.ids[ln]
        perm = np.argsort(v, kind="stable")
        perms.append(perm)
        if len(v) == 0:
            continue
        sv = v[perm]
        if int(sv[-1]) >= 1 << 63:
            raise ValueError("ROC ids must be < 2^63")
        list_prec[ln] = precision_for_max_id_safe(int(sv[-1]))
        if auto:
            t = AUTO_CHUNK_TARGET
            S = -(-len(v) // t) if len(v) > (3 * t) // 2 else 1
        else:
            S = interleave if len(v) >= max(interleave_min, interleave) else 1
        if S == 1:
            chunks.append(sv)
            prec.append(list_prec[ln])
            lo.append(0)
            starts.append(0)
        else:
            _, bounds, lo_s, prec_s, rebased = chunk_plan(sv, S)
            chunks += rebased
            prec += prec_s.tolist()
            lo += lo_s.tolist()
            starts += bounds[:-1].tolist()
        n_lanes[ln] = S
    lane_start = np.zeros(il.nlist, dtype=np.int64)
    np.cumsum(n_lanes[:-1], out=lane_start[1:])
    n_max = max((len(c) for c in chunks), default=1)
    ids = (pad_lists(chunks, n_max, dtype=np.uint64) if chunks
           else np.zeros((0, n_max), np.uint64))
    return InterleavedLaneTable(
        ids=ids, lengths=np.array([len(c) for c in chunks], dtype=np.int32),
        precision=np.array(prec, dtype=np.int32), lo=np.array(lo, dtype=np.uint64),
        starts=np.array(starts, dtype=np.int64), lane_start=lane_start, n_lanes=n_lanes,
        perms=perms, list_precision=list_prec)


class InterleavedRocInvertedLists(CompressedInvertedLists):
    """ROC container whose long lists are coded as several independent
    lanes (``codecs/roc_interleaved.py``): a decode chain of at most about
    1.5 chunk targets instead of the list's length. Short lists keep the
    bit-exact single-stream format. Envelope per lane of a chunked list: 8B
    lo + 4B length + 1B precision, counted in ``overhead_in_bytes``.

    Port of the JAX package's container of the same name with one flat lane
    table of chunk entries (``interleaved_lane_table``) instead of size
    buckets: one encode launch at build, one decode launch over the touched
    lists' chunk lanes per grouped translate. Each lane's stream is the JAX
    entry's (MT counters start at 0 per lane).

    ``interleave="auto"`` (the default) chunks each list past 1.5 x
    ``AUTO_CHUNK_TARGET`` into S = ceil(n / AUTO_CHUNK_TARGET) lanes; an
    integer ``interleave`` with ``interleave_min`` splits lists of at least
    max(interleave_min, interleave) ids into exactly ``interleave`` chunks.
    """

    AUTO_CHUNK_TARGET = AUTO_CHUNK_TARGET

    def __init__(self, il: InvertedLists, interleave="auto", interleave_min: int = 4096,
                 device=DEFAULT_DEVICE):
        super().__init__(il, device)
        self.interleave = interleave
        t = interleaved_lane_table(il, interleave, interleave_min)
        self.id_symbol_precision = t.list_precision
        dev = self.device
        lengths_t = torch.from_numpy(t.lengths).to(dev)
        prec_t = torch.from_numpy(t.precision).to(dev)
        states, order = RocEncoder.encode(
            torch.from_numpy(t.ids.view(np.int64)).to(dev), lengths_t, prec_t)
        order = order.cpu().numpy()
        # payload codes reordered by the concatenation of the list's chunk
        # sampling orders (positions in the sorted list → original index)
        self.codes_all = []
        for ln in range(il.nlist):
            ents = range(t.lane_start[ln], t.lane_start[ln] + t.n_lanes[ln])
            pos = np.concatenate([t.starts[e] + order[e, : t.lengths[e]] for e in ents]
                                 or [np.empty(0, np.int64)])
            self.codes_all.append(_reorder_codes(il.codes[ln], t.perms[ln][pos],
                                                 il.code_size))
        size = states.size_bytes.cpu().numpy()
        self.compressed_ids_size_in_bytes = int(size.sum())
        self.overhead_in_bytes = int(13 * t.n_lanes[t.n_lanes > 1].sum())
        n_max = t.ids.shape[1]
        self.decoder = RocDecoder(states, lengths_t, prec_t, rd.default_pool(n_max, dev),
                                  n_max)
        self._set_lanes(t.lo, t.starts, t.lane_start, t.n_lanes)

    def _set_lanes(self, lo, starts, lane_start, n_lanes):
        """The lane table's bookkeeping on the device, from host arrays: each
        lane's minimum ``lo`` u64[E] and first position ``starts`` i64[E] in
        its sorted list, each list's first lane and lane count i64[nlist]."""
        dev = self.device
        self.n_lanes = n_lanes
        self._lane_lo = torch.from_numpy(lo.view(np.int64)).to(dev)
        self._lane_first = torch.from_numpy(starts).to(dev)
        self._lane_start = torch.from_numpy(lane_start).to(dev)
        self._n_lanes = torch.from_numpy(n_lanes).to(dev)
        self._list_len = torch.from_numpy(self._lengths).to(dev)

    def _lanes_of(self, list_nos: torch.Tensor):
        """Chunk lanes of the given lists, list by list → (row of each lane's
        list in ``list_nos``, the lanes, each list's first row among them)."""
        counts = self._n_lanes[list_nos]
        rows = torch.repeat_interleave(torch.arange(list_nos.numel(), device=self.device),
                                       counts)
        # it reads the output's length and checks that no count is negative
        profiling.count("host_syncs", 2)
        first = torch.cumsum(counts, 0) - counts
        lanes = (self._lane_start[list_nos][rows]
                 + torch.arange(rows.numel(), device=self.device) - first[rows])
        return rows, lanes, first

    def decode_lists(self, list_nos):
        """One decode launch over the given lists' chunk lanes → (ids
        i64[Q, max_len] in lane-concatenated sampling order, zero-padded;
        lengths i64[Q])."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        lens = self._list_len[list_nos]
        max_len = max(int(lens.max()) if lens.numel() else 0, 1)
        profiling.count("host_syncs")
        rows, lanes, _ = self._lanes_of(list_nos)
        ids = self.decoder.decode_lanes(lanes) + self._lane_lo[lanes][:, None]
        j = torch.arange(ids.shape[1], device=self.device)[None, :]
        valid = j < self.decoder.lengths[lanes][:, None]
        cols = self._lane_first[lanes][:, None] + j
        out = torch.zeros((list_nos.numel(), max_len), dtype=torch.int64, device=self.device)
        out[rows[:, None].expand_as(cols)[valid], cols[valid]] = ids[valid]
        profiling.count("host_syncs", 3)  # the three boolean-mask gathers
        return out, lens

    def decode_select(self, list_nos, offsets):
        """Grouped translate: one decode launch over the touched lists'
        chunk lanes, then each (list, offset) mapped to its chunk s and
        in-chunk position jj in closed form (the first n % S chunks hold one
        more id; as the JAX package's ``_interleaved_translate_call``, which
        reads ``llen - 1 - jj`` because its kernel emits in reverse: this
        decoder emits in sampling order, so it reads jj)."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)
        if list_nos.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        touched, inv = torch.unique(list_nos, return_inverse=True)
        profiling.count("host_syncs")
        _, lanes, first = self._lanes_of(touched)
        decoded = self.decoder.decode_lanes(lanes)
        n = self._list_len[list_nos]
        S = self._n_lanes[list_nos].clamp(min=1)
        base, r = n // S, n % S
        t = r * (base + 1)
        in_big = offsets < t
        s = torch.where(in_big, offsets // (base + 1),
                        r + (offsets - t) // base.clamp(min=1))
        jj = offsets - torch.where(in_big, s * (base + 1), t + (s - r) * base)
        return decoded[first[inv] + s, jj] + self._lane_lo[self._lane_start[list_nos] + s]


class PackedBitsInvertedLists(CompressedInvertedLists):
    """Reference C9 (custom_invlists_impl.cpp:64-118): every id in
    ``packed_width(ntotal)`` bits, one row of packed words per list, packed
    on the device in one pass. Ids must be < ntotal; codes keep their
    order."""

    supports_random_access = True

    def __init__(self, il: InvertedLists, device=DEFAULT_DEVICE):
        super().__init__(il, device)
        ntotal = int(self._lengths.sum())
        self.bits = packed_width(ntotal)
        for ids in il.ids:
            if len(ids) and not (ids < ntotal).all():
                raise ValueError("ids must be < ntotal")  # reference FAISS_THROW
        self.codes_all = [c.copy() for c in il.codes]
        self.packed = pack_lists(il.ids, self.bits, self.device)
        self.compressed_ids_size_in_bytes = int(self.packed.size_in_bytes_per_list.sum())

    def decode_lists(self, list_nos):
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        lens = self.packed.lengths[list_nos]
        max_len = max(int(lens.max()) if lens.numel() else 0, 1)
        profiling.count("host_syncs")
        sub = self.packed._replace(words=self.packed.words[list_nos], lengths=lens)
        return unpack_all(sub, max_len), lens

    def get_single_ids_batch(self, list_nos, offsets):
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)
        return get_single(self.packed, list_nos, offsets)


class EliasFanoInvertedLists(CompressedInvertedLists):
    """Reference C11 (custom_invlists_impl.cpp:229-339): each list's ids
    sorted and Elias-Fano coded, encoded on the device in one pass over the
    padded table (one row per list); codes reordered by each list's stable
    argsort. ``compressed_ids_size_in_bytes`` sums the lists' high and low
    bits, then divides by 8 (as the reference, .cpp:282);
    ``overhead_in_bytes`` is the select directory, one i32 per 512 high
    bits of each nonempty list, which the reference leaves out."""

    supports_random_access = True

    def __init__(self, il: InvertedLists, device=DEFAULT_DEVICE):
        super().__init__(il, device)
        sorted_ids, perms = sorted_lane_table(il, "Elias-Fano")
        self.codes_all = [_reorder_codes(il.codes[ln], perms[ln], il.code_size)
                          for ln in range(il.nlist)]
        self.ef = ef_encode_rows(torch.from_numpy(sorted_ids.view(np.int64)).to(self.device),
                                 torch.from_numpy(self._lengths).to(self.device))
        self.compressed_ids_size_in_bytes = int(self.ef.size_in_bits.sum()) // 8
        high_bits = self.ef.high.nbits.cpu().numpy()[self._lengths > 0]
        self.overhead_in_bytes = 4 * sum(directory_entries(h) for h in high_bits)

    def decode_lists(self, list_nos):
        """The lists' ids, ascending → (i64[Q, max_len] zero-padded, lengths)."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        lens = self.ef.m[list_nos]
        max_len = max(int(lens.max()) if lens.numel() else 0, 1)
        profiling.count("host_syncs")
        return ef_decode_all(self.ef.rows(list_nos), max_len), lens

    def get_single_ids_batch(self, list_nos, offsets):
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)
        return ef_select(self.ef, list_nos, offsets)


class WaveletTreeInvertedLists(CompressedInvertedLists):
    """Reference C12 (custom_invlists_impl.cpp:346-397): one wavelet tree
    over list_nos[id], so (list, offset) is a select of the offset-th
    occurrence of the list's number. Ids per list must be ascending and
    below ntotal (the reference asserts it, .cpp:357-362); codes keep their
    order.

    wt_type 0 = plain bit planes (sdsl wt_int<bit_vector> parity), its
    directory counted in ``compressed_ids_size_in_bytes`` as the JAX package
    does; wt_type 1 = RRR(63)-compressed planes (wt_int<rrr_vector<63>>),
    smaller, with a slower select, its directory in ``overhead_in_bytes``."""

    supports_random_access = True

    def __init__(self, il: InvertedLists, wt_type: int = 0, device=DEFAULT_DEVICE):
        super().__init__(il, device)
        if wt_type not in (0, 1):
            raise ValueError(f"wt_type must be 0 or 1, got {wt_type!r}")
        self.wt_type = wt_type
        ntotal = int(self._lengths.sum())
        list_nos = np.zeros(ntotal, dtype=np.uint32)
        for list_no, ids in enumerate(il.ids):
            if len(ids) == 0:
                continue
            if not (np.diff(ids.astype(np.int64)) > 0).all():
                raise ValueError("ids must be ascending")
            if int(ids[-1]) >= ntotal:
                raise ValueError("ids must be < ntotal")
            list_nos[ids] = list_no
        self.codes_all = [c.copy() for c in il.codes]
        if wt_type == 0:
            self.wt = build_wavelet_tree(list_nos, il.nlist, self.device)
            self.compressed_ids_size_in_bytes = (
                self.wt.size_in_bits + self.wt.index_size_in_bits) // 8
        else:
            self.wt = rrr_encode_planes(wt_planes(list_nos, il.nlist), self.device)
            self.compressed_ids_size_in_bytes = self.wt.payload_bits // 8
            self.overhead_in_bytes = self.wt.index_bits // 8

    @property
    def wt_tables(self) -> torch.Tensor:
        """Per-symbol walk tables (``wt_path_tables``) from the list lengths —
        the symbol histogram — on the container's device, built once."""
        t = self.__dict__.get("_wt_tables")
        if t is None:
            t = torch.from_numpy(wt_path_tables(self._lengths, self.wt.levels)).to(self.device)
            self.__dict__["_wt_tables"] = t
        return t

    def _select(self, sym: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        select = wt_select if self.wt_type == 0 else wt_select_rrr
        return select(self.wt, sym, offs, tables=self.wt_tables)

    def decode_lists(self, list_nos):
        """The lists' ids, ascending → (i64[Q, max_len] zero-padded, lengths):
        one select per (list, offset)."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        lens = torch.from_numpy(self._lengths).to(self.device)[list_nos]
        max_len = max(int(lens.max()) if lens.numel() else 0, 1)
        profiling.count("host_syncs")
        offs = torch.arange(max_len, device=self.device)[None, :]
        sym = list_nos[:, None].expand(-1, max_len)
        vals = self._select(sym, torch.minimum(offs, (lens[:, None] - 1).clamp(min=0)).expand_as(sym))
        return torch.where(offs < lens[:, None], vals, 0), lens

    def get_single_ids_batch(self, list_nos, offsets):
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)
        return self._select(list_nos, offsets)

    def decode_select(self, list_nos, offsets):
        """The grouped translate is the batched select here, as in the JAX
        package (the tree has no per-list decode to share)."""
        return self.get_single_ids_batch(list_nos, offsets)


def _reorder_codes(codes_flat: np.ndarray, order: np.ndarray, code_size: int) -> np.ndarray:
    if code_size == 0 or len(codes_flat) == 0:
        return np.empty(0, dtype=np.uint8)
    return codes_flat.reshape(-1, code_size)[order].reshape(-1).copy()


# method name → container factory, each taking (il, device=...): the
# reference's registry (bench_invlists.py:19-25) plus the RRR and
# interleaved variants, with the JAX package's keys
AVAILABLE_COMPRESSED_IVFS = {
    "packed-bits": PackedBitsInvertedLists,
    "roc": RocInvertedLists,
    "elias-fano": EliasFanoInvertedLists,
    "wavelet-tree": partial(WaveletTreeInvertedLists, wt_type=0),
    "wavelet-tree-1": partial(WaveletTreeInvertedLists, wt_type=1),
    "roc-interleaved": InterleavedRocInvertedLists,
}

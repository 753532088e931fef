"""Inverted-list containers with compressed IDs.

Port of the JAX package's ``store/invlists.py`` for the ROC path
(reference custom_invlist_cpp/custom_invlists_impl.h:22-124):

  InvertedLists                — the uncompressed source container (host numpy)
  CompressedInvertedLists      — common bookkeeping and the grouped translate
  RocInvertedLists             — reference C10: per-list ANS states, decoded a
                                 whole list at a time
  InterleavedRocInvertedLists  — framework extension: long lists coded as
                                 several independent chunk lanes

ROC reorders each list's payload codes into the encode sampling order, and
``compressed_ids_size_in_bytes`` counts what the reference constructor counts
(8 bytes of head plus 4 per stack word, for every nonempty list or chunk).

Each ROC container keeps one flat lane table for the whole index (a lane is a
list, or a chunk of one): one encode launch at build, and one decode launch
over the touched lists' lanes per grouped translate, whatever the lengths.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..codecs import roc_device as rd
from ..codecs.roc import precision_for_max_id_safe
from ..codecs.roc_interleaved import chunk_plan
from ..device import DEFAULT_DEVICE, resolve
from ..ops.roc_decode import RocDecoder
from ..ops.roc_encode import RocEncoder
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

    def get_single_id(self, list_no: int, offset: int) -> int:
        """One id by (list, offset); a container with O(1) random access
        (``supports_random_access``) overrides this."""
        raise NotImplementedError(f"{type(self).__name__} has no O(1) random access")

    def decode_select(self, list_nos, offsets) -> torch.Tensor:
        """Grouped deferred translate (reference custom_invlists_impl.cpp:
        477-525): decode each touched list once, then gather the labels'
        offsets on the device → ids i64[n]."""
        list_nos = torch.as_tensor(list_nos, dtype=torch.int64, device=self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.int64, device=self.device)
        if list_nos.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        touched, inv = torch.unique(list_nos, return_inverse=True)
        decoded, _ = self.decode_lists(touched)
        return decoded[inv, offsets]

    def get_ids(self, list_no: int) -> torch.Tensor:
        ids, lens = self.decode_lists(torch.tensor([list_no]))
        return ids[0, : int(lens[0])]


def roc_lane_table(il: InvertedLists):
    """One ROC lane per list: (sorted ids u64[nlist, n_max] zero-padded,
    lengths i32[nlist], safe precisions i32[nlist], per-list argsort
    permutations) — the encode kernel's input for the whole index."""
    lengths = il.lengths
    n_max = max(int(lengths.max(initial=0)), 1)
    sorted_ids = np.zeros((il.nlist, n_max), dtype=np.uint64)
    prec = np.zeros(il.nlist, dtype=np.int32)
    perms = []
    for ln in range(il.nlist):
        v = il.ids[ln]
        perm = np.argsort(v, kind="stable")
        perms.append(perm)
        sorted_ids[ln, : len(v)] = v[perm]
        if len(v):
            if int(v.max()) >= 1 << 63:
                raise ValueError("ROC ids must be < 2^63")
            prec[ln] = precision_for_max_id_safe(int(v.max()))
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
        self.n_lanes = t.n_lanes
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
        self._lane_lo = torch.from_numpy(t.lo.view(np.int64)).to(dev)
        self._lane_first = torch.from_numpy(t.starts).to(dev)
        self._lane_start = torch.from_numpy(t.lane_start).to(dev)
        self._n_lanes = torch.from_numpy(t.n_lanes).to(dev)
        self._list_len = torch.from_numpy(self._lengths).to(dev)

    def _lanes_of(self, list_nos: torch.Tensor):
        """Chunk lanes of the given lists, list by list → (row of each lane's
        list in ``list_nos``, the lanes, each list's first row among them)."""
        counts = self._n_lanes[list_nos]
        rows = torch.repeat_interleave(torch.arange(list_nos.numel(), device=self.device),
                                       counts)
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
        rows, lanes, _ = self._lanes_of(list_nos)
        ids = self.decoder.decode_lanes(lanes) + self._lane_lo[lanes][:, None]
        j = torch.arange(ids.shape[1], device=self.device)[None, :]
        valid = j < self.decoder.lengths[lanes][:, None]
        cols = self._lane_first[lanes][:, None] + j
        out = torch.zeros((list_nos.numel(), max_len), dtype=torch.int64, device=self.device)
        out[rows[:, None].expand_as(cols)[valid], cols[valid]] = ids[valid]
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


def _reorder_codes(codes_flat: np.ndarray, order: np.ndarray, code_size: int) -> np.ndarray:
    if code_size == 0 or len(codes_flat) == 0:
        return np.empty(0, dtype=np.uint8)
    return codes_flat.reshape(-1, code_size)[order].reshape(-1).copy()

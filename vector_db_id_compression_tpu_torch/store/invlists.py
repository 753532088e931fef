"""Inverted-list containers with compressed IDs.

Port of the JAX package's ``store/invlists.py`` for the ROC path
(reference custom_invlist_cpp/custom_invlists_impl.h:22-124):

  InvertedLists             — the uncompressed source container (host numpy)
  CompressedInvertedLists   — common bookkeeping and the grouped translate
  RocInvertedLists          — reference C10: per-list ANS states, decoded a
                              whole list at a time

ROC reorders each list's payload codes into the encode sampling order, and
``compressed_ids_size_in_bytes`` counts what the reference constructor counts
(8 bytes of head plus 4 per stack word, for every nonempty list).

The ROC container keeps one flat lane table for the whole index (lane = list
number): one encode launch at build, and one decode launch over the touched
lists per grouped translate, whatever the lists' lengths.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..codecs import roc_device as rd
from ..codecs.roc import precision_for_max_id_safe
from ..ops.roc_decode import RocDecoder
from ..ops.roc_encode import RocEncoder


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
    ``decode_lists``."""

    def __init__(self, il: InvertedLists, device="cpu"):
        self.nlist = il.nlist
        self.code_size = il.code_size
        self.device = torch.device(device)
        self._lengths = il.lengths.copy()
        self.compressed_ids_size_in_bytes = 0
        self.codes_all: List[np.ndarray] = []

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    def get_codes(self, list_no: int) -> np.ndarray:
        return self.codes_all[list_no]

    def decode_lists(self, list_nos) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode several lists → (ids i64[Q, max_len] zero-padded, lengths
        i64[Q]), on the container's device."""
        raise NotImplementedError

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

    def __init__(self, il: InvertedLists, device="cpu"):
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


def _reorder_codes(codes_flat: np.ndarray, order: np.ndarray, code_size: int) -> np.ndarray:
    if code_size == 0 or len(codes_flat) == 0:
        return np.empty(0, dtype=np.uint8)
    return codes_flat.reshape(-1, code_size)[order].reshape(-1).copy()

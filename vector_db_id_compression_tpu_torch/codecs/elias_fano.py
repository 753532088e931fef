"""Elias-Fano monotone-sequence codec, batched for device decode.

Port of the JAX package's ``codecs/elias_fano.py``, parameter-compatible
with the reference's modified succinct elias_fano (elias_fano.hpp:16-283):
  - low-bit width  l = floor(log2(n // m)) for m>0 and n//m>0 else 0, where
    n = universe (max id) and m = element count (elias_fano.hpp:28);
  - low bits: m*l bits, each id's low l bits LSB-first (elias_fano.hpp:35-46);
  - high bits: bitvector of (m+1) + (n >> l) + 1 bits with a set bit at
    (id >> l) + i for the i-th id (elias_fano.hpp:43);
  - select(k) = ((select1(high, k) - k) << l) | low[k] (elias_fano.hpp:141-145);
  - reported compressed size = high_bits + low_bits in bits.

``ef_encode_list`` encodes one list on the host (numpy, as the JAX package);
``ef_encode_rows`` encodes a whole padded table of sorted rows on the device
in one pass, with the same words per row — the containers' build (the JAX
package loops over lists or graph nodes in Python). ``EliasFanoBatch`` holds
one row per list: the high bits with the sampled select directory of
``core.bits``, the low fields, l and m. ``ef_select`` answers (lane, k)
queries; ``ef_decode_all`` decodes whole rows by one cumsum over the high
bits and a scatter of each set bit to its rank (the JAX package's scatter
form; its count form gives the same ids).

Ids are carried in int64 and must be < 2^63, so l <= 62.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.bits import (
    BitVectorBatch,
    build_bitvector_batch,
    np_pack_fixed,
    np_set_bits,
    pack_fields,
    read_field,
    select1_batch,
    set_bits,
    u32,
)


def ef_low_width(universe: int, m: int) -> int:
    """floor(log2(universe // m)) — reference elias_fano.hpp:28."""
    if m == 0 or universe // m == 0:
        return 0
    return (universe // m).bit_length() - 1


class EFList(NamedTuple):
    """One encoded list (host arrays)."""

    high_words: np.ndarray  # u32
    low_words: np.ndarray   # u32
    l: int
    m: int
    universe: int
    high_bits: int

    @property
    def size_in_bits(self) -> int:
        return self.high_bits + self.m * self.l


def ef_encode_list(sorted_ids: np.ndarray) -> EFList:
    """Encode one ascending id list. Vectorized, no per-element loop."""
    ids = np.asarray(sorted_ids, dtype=np.uint64)
    m = len(ids)
    if m == 0:
        return EFList(np.zeros(1, np.uint32), np.zeros(1, np.uint32), 0, 0, 0, 0)
    universe = int(ids[-1])
    l = ef_low_width(universe, m)
    high_bits = (m + 1) + (universe >> l) + 1
    positions = (ids >> np.uint64(l)).astype(np.int64) + np.arange(m, dtype=np.int64)
    high_words = np_set_bits(positions, high_bits)
    low_words = np_pack_fixed(ids & np.uint64((1 << l) - 1), l)
    return EFList(high_words, low_words, l, m, universe, high_bits)


class EliasFanoBatch(NamedTuple):
    """B encoded lists padded to common word counts, on one device."""

    high: BitVectorBatch   # words i32[B, HW]
    low_words: torch.Tensor  # i32[B, LW] stored u32 words
    l: torch.Tensor        # i64[B]
    m: torch.Tensor        # i64[B]

    @property
    def size_in_bits(self) -> torch.Tensor:
        """Per row: high bits + m * l (the reference's accounting)."""
        return self.high.nbits + self.m * self.l

    def rows(self, lanes: torch.Tensor) -> "EliasFanoBatch":
        """The sub-batch of rows ``lanes``."""
        h = self.high
        return EliasFanoBatch(BitVectorBatch(h.words[lanes], h.sb_prefix[lanes], h.nbits[lanes]),
                              self.low_words[lanes], self.l[lanes], self.m[lanes])


def batch_ef_lists(lists: Sequence[EFList], device) -> EliasFanoBatch:
    """Host-encoded lists → one padded batch on ``device``."""
    B = len(lists)
    hw = max(max(len(e.high_words) for e in lists), 1)
    lw = max(max(len(e.low_words) for e in lists), 1)
    high = np.zeros((B, hw), dtype=np.uint32)
    low = np.zeros((B, lw), dtype=np.uint32)
    for b, e in enumerate(lists):
        high[b, : len(e.high_words)] = e.high_words
        low[b, : len(e.low_words)] = e.low_words

    def t(a):
        return torch.from_numpy(a).to(device)

    return EliasFanoBatch(
        high=build_bitvector_batch(t(high.view(np.int32)), t(np.array([e.high_bits for e in lists]))),
        low_words=t(low.view(np.int32)),
        l=t(np.array([e.l for e in lists], np.int64)),
        m=t(np.array([e.m for e in lists], np.int64)),
    )


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 (0 for 0), exactly (a float log2
    rounds near powers of two past 2^53)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> n) >= (1 << s)
        n = n + torch.where(big, s, 0)
    return n + ((x >> n) > 0).to(torch.int64)


def ef_encode_rows(ids: torch.Tensor, m: torch.Tensor) -> EliasFanoBatch:
    """Encode each row of ``ids`` i64[R, C] (its first m[r] entries
    ascending, ids < 2^63) on the device → the batch whose row r holds the
    words of ``ef_encode_list(ids[r, :m[r]])``, zero-padded; a row with
    m = 0 has l = 0 and no high bits."""
    R, C = ids.shape
    dev = ids.device
    m = m.to(torch.int64)
    cols = torch.arange(C, device=dev)[None, :]
    live = cols < m[:, None]
    ids = torch.where(live, ids, 0)
    universe = ids.gather(1, (m - 1).clamp(min=0)[:, None])[:, 0]
    l = (bit_length(universe // m.clamp(min=1)) - 1).clamp(min=0)
    high_bits = torch.where(m > 0, (m + 1) + (universe >> l) + 1, 0)
    hw = max(int((high_bits.max() if R else 0) + 31) // 32, 1)
    lw = max(int((m * l).max() if R else 0) + 31, 32) // 32
    high = set_bits((ids >> l[:, None]) + cols, live, hw)
    low = pack_fields(ids, l, lw)
    return EliasFanoBatch(high=build_bitvector_batch(high, high_bits), low_words=low, l=l, m=m)


def _low_fields_dyn(words: torch.Tensor, l: torch.Tensor, lane: torch.Tensor,
                    k: torch.Tensor) -> torch.Tensor:
    """Read the k-th l[lane]-bit LSB-first field; per-lane dynamic width
    (l <= 62). Three-word window covers any (offset, width)."""
    W = words.shape[1]
    lw = l[lane]
    start = k.to(torch.int64) * lw
    w0, off = start >> 5, start & 31

    def word(t):
        return u32(words[lane, t.clamp(0, W - 1)])

    return read_field(word(w0), word(w0 + 1), word(w0 + 2), off, lw)


def ef_select(ef: EliasFanoBatch, lane: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """select(k) per (lane, k) query — reference elias_fano.hpp:141-145."""
    lane, k = lane.to(torch.int64), k.to(torch.int64)
    high_pos = select1_batch(ef.high, lane, k)
    low = _low_fields_dyn(ef.low_words, ef.l, lane, k)
    return ((high_pos - k) << ef.l[lane]) | low


# ---------------------------------------------------------------------------
# secondary op surface (reference elias_fano.hpp:147-208): rank as a
# fixed-depth binary search over ef_select (the sequence is sorted, so
# rank(pos) == lower_bound(ids, pos)), as in the JAX package
# ---------------------------------------------------------------------------

_RANK_STEPS = 35  # ceil(log2(2^34)) — covers any m the u32-word layout can hold


def ef_rank(ef: EliasFanoBatch, lane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Number of elements with value < pos (reference elias_fano.hpp:146-167;
    pos == universe+1 returns m as the reference's pos==size() branch does)."""
    lane, pos = lane.to(torch.int64), pos.to(torch.int64)
    m = ef.m[lane]
    lo = torch.zeros_like(m)
    hi = m
    for _ in range(_RANK_STEPS):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = ef_select(ef, lane, torch.minimum(mid, (m - 1).clamp(min=0)))
        go_right = v < pos
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def ef_predecessor1(ef: EliasFanoBatch, lane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Largest element <= pos (reference elias_fano.hpp:169-171; as there,
    the caller must ensure one exists — k is clamped at 0 here)."""
    k = ef_rank(ef, lane, pos.to(torch.int64) + 1) - 1
    return ef_select(ef, lane, k.clamp(min=0))


def ef_successor1(ef: EliasFanoBatch, lane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Smallest element >= pos (reference elias_fano.hpp:173-175; caller must
    ensure one exists — k is clamped at m-1 here)."""
    k = ef_rank(ef, lane, pos)
    return ef_select(ef, lane, torch.minimum(k, (ef.m[lane.to(torch.int64)] - 1).clamp(min=0)))


def ef_delta(ef: EliasFanoBatch, lane: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """select(n) - select(n-1), select(0) for n == 0 (elias_fano.hpp:178-194)."""
    cur = ef_select(ef, lane, n)
    prev = ef_select(ef, lane, (n - 1).clamp(min=0))
    return torch.where(n > 0, cur - prev, cur)


def ef_select_range(ef: EliasFanoBatch, lane: torch.Tensor, n: torch.Tensor):
    """(select(n), select(n+1)) pairs (elias_fano.hpp:197-207; requires
    n+1 < m as the reference asserts)."""
    return ef_select(ef, lane, n), ef_select(ef, lane, n + 1)


def ef_decode_all(ef: EliasFanoBatch, n_max: int) -> torch.Tensor:
    """Decode every lane's full list → i64[B, n_max], zero-padded: one
    cumsum over the high bits gives each set bit's rank, and each set bit
    below ``nbits`` with rank < n_max is scattered to its rank's slot (the
    batched form of the reference's select_enumerator sweep,
    elias_fano.hpp:210-261)."""
    B, HW = ef.high.words.shape
    dev = ef.low_words.device
    P = HW * 32
    bits = ((u32(ef.high.words)[:, :, None] >> torch.arange(32, device=dev)) & 1).reshape(B, P)
    ranks = torch.cumsum(bits, dim=1) - bits  # exclusive: rank of each set bit
    pos = torch.arange(P, device=dev)[None, :].expand(B, P)
    valid = (bits == 1) & (ranks < n_max) & (pos < ef.high.nbits[:, None])
    # other bits write to a spill column n_max, dropped after
    high_pos = torch.zeros((B, n_max + 1), dtype=torch.int64, device=dev)
    high_pos.scatter_(1, torch.where(valid, ranks, n_max), pos)
    high_pos = high_pos[:, :n_max]
    k = torch.arange(n_max, device=dev)[None, :].expand(B, n_max)
    lane = torch.arange(B, device=dev)[:, None].expand(B, n_max)
    low = _low_fields_dyn(ef.low_words, ef.l, lane, k)
    vals = ((high_pos - k) << ef.l[:, None]) | low
    return torch.where(k < ef.m[:, None], vals, 0)

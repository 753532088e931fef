"""RRR(63) compressed bitvectors with device rank/select.

Port of the JAX package's ``codecs/rrr.py``: the wavelet-tree invlists'
``wt_type 1`` wraps its bit planes in ``sdsl::rrr_vector<63>``
(custom_invlists_impl.cpp:367-373). The layout:

  - blocks of 63 bits, each stored as a 6-bit *class* (its popcount k) plus
    a ceil(log2(C(63,k)))-bit *offset* (the block's combinatorial rank among
    the 63-bit words of popcount k);
  - a sampled superblock directory (SB_BLOCKS = 16 blocks = 1008 bits per
    entry): cumulative rank and cumulative offset-bit start per superblock;
    within a superblock both are recovered from the stored classes;
  - device rank/select: the block from the rank directory, then the block
    unranked on the fly by a 63-step loop over the binomial table, each step
    a handful of elementwise torch ops over the query batch.

Build is host numpy (vectorized over blocks; the only Python loops run over
the 63 in-block positions and the offset widths). Offsets are < C(63, 31) <
2^60 and a block's bits < 2^63, so int64 carries both.
"""

from __future__ import annotations

import functools
from math import comb
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.bits import popcount64, read_field, u32

BLOCK = 63
SB_BLOCKS = 16                 # blocks per superblock directory entry
SB_BITS = SB_BLOCKS * BLOCK    # 1008 payload bits per entry

# binomial table C[n][k] for n,k <= 63; C(63,31) ~ 9.16e17 < 2^63
_C = np.zeros((BLOCK + 1, BLOCK + 1), dtype=np.int64)
for _n in range(BLOCK + 1):
    for _k in range(_n + 1):
        _C[_n, _k] = comb(_n, _k)

# offset field width per class
OFF_BITS = np.array(
    [int(_C[BLOCK, k] - 1).bit_length() if 0 < k < BLOCK else 0
     for k in range(BLOCK + 1)],
    dtype=np.int32,
)


class RRRPlanes(NamedTuple):
    """L stacked RRR bitvectors (one per wavelet-tree level), on one device."""

    classes: torch.Tensor       # i32[L, NB] block popcounts, NB a SB_BLOCKS multiple
    off_words: torch.Tensor     # i32[L, OW] packed offset fields (stored u32)
    sb_off_start: torch.Tensor  # i64[L, NSB] bit-start of each superblock's offsets
    sb_rank: torch.Tensor       # i64[L, NSB] inclusive popcount through superblock
    n: int                      # bits per plane
    levels: int

    @property
    def payload_bits(self) -> int:
        """Exact RRR payload: 6 class bits + offset bits per block."""
        cls = self.classes.cpu().numpy()
        return int(6 * cls.size + OFF_BITS[cls].sum())

    @property
    def index_bits(self) -> int:
        """Sampled directory (SDSL superblock-pointer parity): one
        (rank, offset-start) pair per SB_BLOCKS blocks, counted at the
        widths a tight packing needs."""
        nsb = self.sb_rank.shape[1]
        rank_w = max(int(self.n).bit_length(), 1)
        top = int(self.sb_off_start.max()) if self.sb_off_start.numel() else 1
        start_w = max(max(top, 1).bit_length(), 1)
        return self.levels * nsb * (rank_w + start_w)


def _block_offsets_host(blocks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """blocks u8[NB, 63] -> (classes i32[NB], offsets i64[NB]):
    combinatorial rank of each block among 63-bit words of its popcount."""
    k_rem = blocks.sum(axis=1).astype(np.int64)
    classes = k_rem.astype(np.int32)
    off = np.zeros(blocks.shape[0], dtype=np.int64)
    for i in range(BLOCK):
        ones = blocks[:, i] == 1
        # choosing a 1 at position i skips the C(BLOCK-1-i, k_rem) patterns
        # with a 0 there
        off[ones] += _C[BLOCK - 1 - i, np.clip(k_rem[ones], 0, BLOCK)]
        k_rem[ones] -= 1
    return classes, off


def rrr_encode_planes(planes: np.ndarray, device) -> RRRPlanes:
    """planes u8[L, n] of 0/1 -> stacked RRR vectors on ``device``."""
    planes = np.asarray(planes, dtype=np.uint8)
    L, n = planes.shape
    NSB = max((n + SB_BITS - 1) // SB_BITS, 1)
    NB = NSB * SB_BLOCKS
    padded = np.zeros((L, NB * BLOCK), dtype=np.uint8)
    padded[:, :n] = planes
    blocks = padded.reshape(L, NB, BLOCK)

    classes = np.zeros((L, NB), dtype=np.int32)
    offsets = np.zeros((L, NB), dtype=np.int64)
    for l in range(L):
        classes[l], offsets[l] = _block_offsets_host(blocks[l])

    widths = OFF_BITS[classes]                       # i32[L, NB]
    off_start = np.zeros((L, NB), dtype=np.int64)
    off_start[:, 1:] = np.cumsum(widths, axis=1)[:, :-1]
    total_bits = int(widths.sum(axis=1).max()) if NB else 0
    OW = max((total_bits + 31) // 32, 1)
    bitarr = np.zeros((L, OW * 32), dtype=np.uint8)
    for j in range(int(widths.max(initial=0))):
        sel = widths > j                             # [L, NB]
        bitarr[np.nonzero(sel)[0], off_start[sel] + j] = (offsets[sel] >> j) & 1
    # pack LSB-first into u32 words
    weights = (1 << np.arange(32, dtype=np.uint32))
    off_words = (bitarr.reshape(L, OW, 32).astype(np.uint32)
                 * weights[None, None, :]).sum(axis=2, dtype=np.uint32)

    # sampled directory: per-superblock offset start + inclusive rank
    sb_off_start = off_start[:, ::SB_BLOCKS].copy()
    sb_rank = np.cumsum(classes.reshape(L, NSB, SB_BLOCKS).sum(axis=2, dtype=np.int64), axis=1)

    def t(a):
        return torch.from_numpy(a).to(device)

    return RRRPlanes(classes=t(classes), off_words=t(off_words.view(np.int32)),
                     sb_off_start=t(sb_off_start), sb_rank=t(sb_rank), n=n, levels=L)


# ---------------------------------------------------------------------------
# device block decode (combinatorial unranking)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(binomial table i64[64, 64], offset widths i64[64]) on ``device``,
    copied there once."""
    return torch.from_numpy(_C).to(device), torch.from_numpy(OFF_BITS.astype(np.int64)).to(device)


def _class_window(rrr: RRRPlanes, level: int, sb: torch.Tensor) -> torch.Tensor:
    """Each query's superblock of classes → i64[Q, SB_BLOCKS]."""
    NSB = rrr.classes.shape[1] // SB_BLOCKS
    return rrr.classes[level].reshape(NSB, SB_BLOCKS)[sb].to(torch.int64)


def _block_start_and_rank(rrr: RRRPlanes, level: int, blk: torch.Tensor):
    """(offset bit-start, exclusive rank) of each queried block, recovered
    from the sampled directory + the class window."""
    sb = blk // SB_BLOCKS
    rel = blk - sb * SB_BLOCKS
    cls = _class_window(rrr, level, sb)                     # [Q, S]
    widths = _tables(blk.device)[1][cls]
    before = torch.arange(SB_BLOCKS, device=blk.device) < rel[:, None]
    start = rrr.sb_off_start[level, sb] + torch.where(before, widths, 0).sum(dim=1)
    rank_before_sb = torch.where(sb > 0, rrr.sb_rank[level, (sb - 1).clamp(min=0)], 0)
    rank = rank_before_sb + torch.where(before, cls, 0).sum(dim=1)
    return start, rank


def _read_offset(rrr: RRRPlanes, level: int, start: torch.Tensor,
                 width: torch.Tensor) -> torch.Tensor:
    """Read each queried block's packed offset field (``width`` <= 60 bits
    at bit ``start`` of the level's offset words) -> i64[Q]."""
    w, s = start >> 5, start & 31
    OW = rrr.off_words.shape[1]

    def word(t):
        return u32(rrr.off_words[level, t.clamp(0, OW - 1)])

    return read_field(word(w), word(w + 1), word(w + 2), s, width)


def _unrank_bits(off0: torch.Tensor, k0: torch.Tensor) -> torch.Tensor:
    """Combinatorially unrank offsets -> i64[Q] bitmasks (bit i = position i):
    63 dependent steps, each taking a 1 at position i where the remaining
    offset reaches C(BLOCK-1-i, k)."""
    C = _tables(off0.device)[0]
    off, k = off0, k0
    bits = torch.zeros_like(off0)
    for i in range(BLOCK):
        c = C[BLOCK - 1 - i][k]
        take = (off >= c) & (k > 0)
        off = torch.where(take, off - c, off)
        bits = bits | torch.where(take, 1 << i, 0)
        k = k - take.to(torch.int64)
    return bits


def _decode_blocks(rrr: RRRPlanes, level: int, blk: torch.Tensor) -> torch.Tensor:
    """Unrank queried blocks -> i64[Q] bitmasks (bit i = position i)."""
    start, _ = _block_start_and_rank(rrr, level, blk)
    k0 = rrr.classes[level, blk].to(torch.int64)
    return _unrank_bits(_read_offset(rrr, level, start, _tables(blk.device)[1][k0]), k0)


def rrr_rank1(rrr: RRRPlanes, level: int, pos: torch.Tensor) -> torch.Tensor:
    """Set bits strictly below pos; pos i64[Q]."""
    NB = rrr.classes.shape[1]
    blk = (pos // BLOCK).clamp(0, NB - 1)
    _, before = _block_start_and_rank(rrr, level, blk)
    m = (pos - blk * BLOCK).clamp(max=BLOCK)
    bits = _decode_blocks(rrr, level, blk)
    return before + popcount64(bits & ((1 << m) - 1))


def _select_in_block(bits: torch.Tensor, j: torch.Tensor, invert: torch.Tensor) -> torch.Tensor:
    """(j+1)-th set bit, or clear bit where ``invert``, of each 63-bit block."""
    b = (bits[:, None] >> torch.arange(BLOCK, device=bits.device)) & 1
    b = torch.where(invert[:, None], 1 - b, b)
    cum = torch.cumsum(b, dim=1)
    return torch.argmax((cum == j[:, None] + 1).to(torch.int32), dim=1)


def rrr_select_merged(rrr: RRRPlanes, level: int, k: torch.Tensor,
                      invert: torch.Tensor) -> torch.Tensor:
    """select1, or select0 where ``invert``, of the (k+1)-th bit on a level:
    the superblock by searchsorted over the polarity's rank directory (zeros
    through a superblock = (sb+1)*SB_BITS - ones), the block by a cumsum over
    the class window (zeros per block = BLOCK - class), then one offset read,
    one unranking and the in-block scan for the whole batch."""
    p1 = rrr.sb_rank[level]
    NSB = p1.shape[0]
    p0 = (torch.arange(NSB, device=k.device) + 1) * SB_BITS - p1
    sb = torch.where(invert, torch.searchsorted(p0, k + 1, side="left"),
                     torch.searchsorted(p1, k + 1, side="left")).clamp(0, NSB - 1)
    prev = (sb - 1).clamp(min=0)
    before_sb = torch.where(sb > 0, torch.where(invert, p0[prev], p1[prev]), 0)

    cls = _class_window(rrr, level, sb)                       # [Q, S]
    cum = torch.cumsum(torch.where(invert[:, None], BLOCK - cls, cls), dim=1)
    rel = (cum <= (k - before_sb)[:, None]).sum(dim=1).clamp(0, SB_BLOCKS - 1)
    before = before_sb + torch.where(rel > 0, cum.gather(1, (rel - 1).clamp(min=0)[:, None])[:, 0],
                                     0)
    # class and offset start of the target block, from the window
    widths = _tables(k.device)[1][cls]
    in_sb = torch.arange(SB_BLOCKS, device=k.device) < rel[:, None]
    start = rrr.sb_off_start[level, sb] + torch.where(in_sb, widths, 0).sum(dim=1)
    k_cls = cls.gather(1, rel[:, None])[:, 0]
    width = widths.gather(1, rel[:, None])[:, 0]
    bits = _unrank_bits(_read_offset(rrr, level, start, width), k_cls)
    blk = sb * SB_BLOCKS + rel
    return blk * BLOCK + _select_in_block(bits, k - before, invert)


def rrr_select1(rrr: RRRPlanes, level: int, k: torch.Tensor) -> torch.Tensor:
    return rrr_select_merged(rrr, level, k, torch.zeros_like(k, dtype=torch.bool))


def rrr_select0(rrr: RRRPlanes, level: int, k: torch.Tensor) -> torch.Tensor:
    return rrr_select_merged(rrr, level, k, torch.ones_like(k, dtype=torch.bool))

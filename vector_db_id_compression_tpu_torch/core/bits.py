"""Bit-vector plumbing: packing, rank/select over batched packed bitvectors.

Port of the JAX package's ``core/bits.py`` (the reference's succinct
primitives and Faiss BitstringReader/Writer semantics,
custom_invlists_impl.cpp:35-58).

Canonical layout: a bitstream is a little-endian sequence of u32 words, bit
j of the stream is bit (j % 32) of word (j // 32), and fixed-width fields are
written LSB-first. On the host the words are numpy u32; on the device they
are int32 tensors holding the u32 bit patterns (torch has no unsigned
arithmetic on the CPU), widened to non-negative int64 (``u32``) wherever they
are shifted, compared or counted.

Host side: the vectorized numpy packers of the JAX package. Device side:
rank/select over batches of packed bitvectors with a sampled superblock
directory, one cumulative popcount per ``SB_WORDS`` words (one i32 per 512
bits): ``select1(k)`` finds the superblock in the directory, then the word by
a popcount cumsum over the superblock's 16-word window, then the bit in the
word; ``rank1`` adds the directory entry and a masked popcount of the
window. Every query of a batch takes the same path. torch has no popcount,
so ``popcount32`` is the SWAR count on int64 carriers. ``pack_fields`` and
``set_bits`` are the device packers that build a whole table of rows in one
pass (the JAX package packs one list at a time on the host).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# superblock size: 16 u32 words = 512 bits per directory entry
SB_WORDS = 16
SB_BITS = SB_WORDS * 32
U32 = 0xFFFFFFFF
I64_MAX = torch.iinfo(torch.int64).max

# ---------------------------------------------------------------------------
# host (numpy) packing
# ---------------------------------------------------------------------------


def np_pack_fixed(values: np.ndarray, width: int, total_bits: int | None = None) -> np.ndarray:
    """Pack ``values`` as consecutive ``width``-bit fields, LSB-first, into a
    uint32 word array. Vectorized (no Python loop over elements)."""
    values = np.asarray(values, dtype=np.uint64)
    m = len(values)
    if total_bits is None:
        total_bits = m * width
    nwords = (total_bits + 31) // 32
    if width == 0 or m == 0:
        return np.zeros(nwords, dtype=np.uint32)
    bits = ((values[:, None] >> np.arange(width, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)
    flat = np.zeros(nwords * 32, dtype=np.uint8)
    flat[: m * width] = bits.reshape(-1)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (flat.reshape(nwords, 32).astype(np.uint32) * weights).sum(axis=1).astype(np.uint32)


def np_unpack_fixed(words: np.ndarray, width: int, count: int) -> np.ndarray:
    """Inverse of np_pack_fixed → uint64[count]."""
    if width == 0:
        return np.zeros(count, dtype=np.uint64)
    words = np.asarray(words, dtype=np.uint32)
    flat = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)).reshape(-1)
    bits = flat[: count * width].reshape(count, width).astype(np.uint64)
    return (bits << np.arange(width, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)


def np_set_bits(positions: np.ndarray, nbits: int) -> np.ndarray:
    """Bitvector with 1s at ``positions`` (distinct), packed uint32 words."""
    nwords = (nbits + 31) // 32
    words = np.zeros(nwords, dtype=np.uint32)
    positions = np.asarray(positions, dtype=np.int64)
    np.bitwise_or.at(words, positions >> 5, (np.uint32(1) << (positions & 31).astype(np.uint32)))
    return words


# ---------------------------------------------------------------------------
# device (torch) word arithmetic
# ---------------------------------------------------------------------------


def u32(words: torch.Tensor) -> torch.Tensor:
    """Stored words (int32 bit patterns) → their u32 values as int64."""
    return words.to(torch.int64) & U32


def as_words(values: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 → the int32 bit patterns the tables store."""
    return ((values ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value (int64 in [0, 2^32)), SWAR."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64."""
    return popcount32(x & U32) + popcount32(x >> 32)


def low_mask(width) -> torch.Tensor | int:
    """(1 << width) - 1 for widths 0..63 (an int or a tensor of them)."""
    if isinstance(width, torch.Tensor):
        return torch.where(width >= 63, I64_MAX, (1 << width.clamp(max=62)) - 1)
    return I64_MAX if width >= 63 else (1 << width) - 1


def read_field(lo, hi, h2, off, width):
    """Bits [off, off + width) of the 96-bit value h2:hi:lo (u32 values in
    int64; off < 32, width <= 63), as a non-negative int64.

    Built from the 32-bit words, never by shifting ``lo | hi << 32`` right:
    in int64 that value is negative when hi's top bit is set, and its right
    shift would fill the field's top bits with ones."""
    val = (lo >> off) | (hi << (32 - off)) | torch.where(off > 0, h2 << (64 - off).clamp(max=63), 0)
    return val & low_mask(width)


def pack_fields(vals: torch.Tensor, width, nwords: int) -> torch.Tensor:
    """Pack each row of ``vals`` i64[R, C] as consecutive ``width``-bit fields,
    LSB-first (``width``: an int or i64[R], each <= 63; each value's low
    ``width`` bits are kept) → stored words i32[R, nwords]. Row r equals
    ``np_pack_fixed(vals[r], width_r)`` zero-padded to ``nwords``."""
    R, C = vals.shape
    dev = vals.device
    width = torch.as_tensor(width, dtype=torch.int64, device=dev).expand(R)[:, None]
    v = vals & low_mask(width)
    start = torch.arange(C, device=dev)[None, :] * width
    w0, off = start >> 5, start & 31
    # a field of at most 63 bits at an offset below 32 spans at most 3 words
    parts = ((v << off) & U32, (v >> (32 - off)) & U32,
             torch.where(off > 0, v >> (64 - off).clamp(max=63), 0) & U32)
    words = torch.zeros((R, nwords + 3), dtype=torch.int64, device=dev)
    for j, part in enumerate(parts):
        # fields do not overlap, so adding their parts sets their bits
        words.scatter_add_(1, (w0 + j).clamp(max=nwords + 2), part)
    return as_words(words[:, :nwords])


def set_bits(positions: torch.Tensor, valid: torch.Tensor, nwords: int) -> torch.Tensor:
    """Per row, a bitvector with 1s at the ``valid`` entries of ``positions``
    i64[R, C] (distinct within a row) → stored words i32[R, nwords]. Row r
    equals ``np_set_bits`` of its valid positions, zero-padded."""
    R = positions.shape[0]
    pos = torch.where(valid, positions, 0)
    words = torch.zeros((R, nwords), dtype=torch.int64, device=positions.device)
    words.scatter_add_(1, pos >> 5, torch.where(valid, 1 << (pos & 31), 0))
    return as_words(words)


# ---------------------------------------------------------------------------
# device rank/select over batched packed bitvectors
# ---------------------------------------------------------------------------


class BitVectorBatch(NamedTuple):
    """B packed bitvectors, word-padded to a superblock multiple, with a
    sampled-popcount select/rank directory.

    words:     i32[B, W]   stored u32 words; W is a multiple of SB_WORDS
    sb_prefix: i64[B, SB]  cumulative popcount *through* each superblock
                           (inclusive), SB = W // SB_WORDS
    nbits:     i64[B]      logical lengths
    """

    words: torch.Tensor
    sb_prefix: torch.Tensor
    nbits: torch.Tensor

    @property
    def total_ones(self) -> torch.Tensor:
        return self.sb_prefix[:, -1]


def directory_entries(nbits: int) -> int:
    """Directory entries a bitvector of ``nbits`` logical bits needs — the
    per-list overhead accounting unit (one i32 per entry)."""
    return max((int(nbits) + SB_BITS - 1) // SB_BITS, 1)


def build_bitvector_batch(words: torch.Tensor, nbits: torch.Tensor) -> BitVectorBatch:
    """``words`` i32[B, W] (stored u32 words), padded here to a superblock
    multiple, and the directory over them."""
    B, W = words.shape
    Wp = ((W + SB_WORDS - 1) // SB_WORDS) * SB_WORDS
    if Wp != W:
        words = torch.nn.functional.pad(words, (0, Wp - W))
    pops = popcount32(u32(words))
    sb = torch.cumsum(pops.reshape(B, Wp // SB_WORDS, SB_WORDS).sum(dim=2), dim=1)
    return BitVectorBatch(words, sb, torch.as_tensor(nbits, dtype=torch.int64,
                                                     device=words.device))


def select_in_word(word: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Position of the (k+1)-th set bit within each u32 value (k 0-based),
    0 where the word has fewer set bits."""
    bits = (word[..., None] >> torch.arange(32, device=word.device)) & 1
    cum = torch.cumsum(bits, dim=-1)
    return torch.argmax((cum == k[..., None] + 1).to(torch.int32), dim=-1)


def _window(words: torch.Tensor, lane: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """One superblock's SB_WORDS-word window per query → u32 values i64[Q, S]."""
    widx = sb[:, None] * SB_WORDS + torch.arange(SB_WORDS, device=sb.device)
    return u32(words[lane[:, None], widx])


def _before(cum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cum[q, idx[q] - 1], or 0 where idx[q] is 0."""
    prev = cum.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0]
    return torch.where(idx > 0, prev, 0)


def select1_batch(bv: BitVectorBatch, lane: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Bit position of the (k+1)-th set bit (k 0-based) in bitvector ``lane``,
    vectorized over parallel query tensors ``lane``/``k`` of equal shape."""
    shape = k.shape
    lane, k = lane.reshape(-1).to(torch.int64), k.reshape(-1).to(torch.int64)
    sbp = bv.sb_prefix[lane]                                  # [Q, SB]
    # first superblock whose inclusive prefix exceeds k
    sb = (sbp <= k[:, None]).sum(dim=1).clamp(0, bv.sb_prefix.shape[1] - 1)
    before_sb = _before(sbp, sb)
    win = _window(bv.words, lane, sb)                         # [Q, S]
    cum = torch.cumsum(popcount32(win), dim=1)
    rel = (cum <= (k - before_sb)[:, None]).sum(dim=1).clamp(0, SB_WORDS - 1)
    before = before_sb + _before(cum, rel)
    word = win.gather(1, rel[:, None])[:, 0]
    return ((sb * SB_WORDS + rel) * 32 + select_in_word(word, k - before)).reshape(shape)


def rank1_batch(bv: BitVectorBatch, lane: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Count of set bits strictly below ``pos``."""
    shape = pos.shape
    lane, pos = lane.reshape(-1).to(torch.int64), pos.reshape(-1).to(torch.int64)
    word_idx = pos >> 5
    # pos == 32*W (rank of the whole vector) lands one superblock past the
    # end; clamp — the full-window masks then count the whole last superblock
    sb = (word_idx // SB_WORDS).clamp(max=bv.sb_prefix.shape[1] - 1)
    before_sb = torch.where(sb > 0, bv.sb_prefix[lane, (sb - 1).clamp(min=0)], 0)
    win = _window(bv.words, lane, sb)
    g = sb[:, None] * SB_WORDS + torch.arange(SB_WORDS, device=pos.device)
    part = (1 << (pos & 31)[:, None]) - 1
    mask = torch.where(g < word_idx[:, None], U32, torch.where(g == word_idx[:, None], part, 0))
    return (before_sb + popcount32(win & mask).sum(dim=1)).reshape(shape)


def fields_at(words: torch.Tensor, lane: torch.Tensor, idx: torch.Tensor,
              width: int) -> torch.Tensor:
    """The ``idx``-th LSB-first ``width``-bit fields (width <= 32) of rows
    ``lane`` of the stored words i32[B, W]; ``lane`` broadcasts against
    ``idx`` → non-negative i64 of their broadcast shape."""
    if width > 32:
        raise ValueError("get_fixed_fields supports widths <= 32 bits")
    if width == 0:
        return torch.zeros(torch.broadcast_shapes(lane.shape, idx.shape), dtype=torch.int64,
                           device=words.device)
    start = idx.to(torch.int64) * width
    w0, off = start >> 5, start & 31
    lo = u32(words[lane, w0])
    # width <= 32 and off < 32, so two words always cover the field
    hi = u32(words[lane, (w0 + 1).clamp(max=words.shape[1] - 1)])
    return read_field(lo, hi, torch.zeros_like(lo), off, width)


def get_fixed_fields(words: torch.Tensor, width: int, idx: torch.Tensor) -> torch.Tensor:
    """Read the ``idx``-th LSB-first ``width``-bit fields from stored words
    i32[B, W]; idx i64[B, Q] per-lane query offsets → i64[B, Q].

    Equivalent of the reference's bit-offset BitstringReader
    (custom_invlists_impl.cpp:35-58), vectorized over queries."""
    lane = torch.arange(words.shape[0], device=words.device)[:, None]
    return fields_at(words, lane, idx, width)

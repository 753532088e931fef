"""Wavelet tree over the cluster-assignment string.

Port of the JAX package's ``codecs/wavelet_tree.py``. The reference inverts
the IVF: it builds the length-ntotal string ``list_nos[id] = list_no`` and
wraps it in an SDSL ``wt_int`` (plain bitvector or rrr_vector<63>-compressed),
so ``get_single_id(list_no, offset)`` is ``wt.select(offset+1, list_no)``
(custom_invlists_impl.cpp:346-392).

A levelwise balanced tree built for batched queries:

  build (host, numpy): the level-l sequence is the stable sort of the symbols
    by their top-l bits; each level stores one packed bitvector of its bit
    plane and a sampled superblock popcount directory (one cumulative count
    per SB_WORDS = 32 words, one entry per 1024 bits);
  select (device): the two-sweep walk (a top-down pass of ranks finds the
    node interval along the symbol's bit path, a bottom-up pass lifts the
    leaf offset through select0/select1), or, with ``wt_path_tables``, the
    bottom-up pass alone. Rank and select find the superblock in the
    directory (``torch.searchsorted``; the JAX package's dense two-level
    search gives the same superblock), then the word by a popcount cumsum
    over the superblock's window, then the bit.

Levels L = ceil(log2(sigma)) (at least 1); payload L * ntotal bits plus the
directory. Positions come back as int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.bits import np_pack_fixed, popcount32, select_in_word, u32

# superblock: 32 u32 words = 1024 bits per directory entry
SB_WORDS = 32
SB_BITS = SB_WORDS * 32


class WaveletTree(NamedTuple):
    words: torch.Tensor      # i32[L, W] packed bit planes (stored u32), W a SB_WORDS multiple
    sb_prefix: torch.Tensor  # i64[L, SB] inclusive popcount through superblock
    n: int                   # sequence length
    levels: int

    @property
    def size_in_bits(self) -> int:
        """Payload bits (bit planes only), the plain-wt accounting of the
        reference (index overhead reported separately)."""
        return self.levels * self.n

    @property
    def index_size_in_bits(self) -> int:
        """Sampled directory: one 32-bit entry per superblock per level."""
        entries_per_level = max((self.n + SB_BITS - 1) // SB_BITS, 1)
        return self.levels * entries_per_level * 32


def wt_levels(sigma: int) -> int:
    """Number of bit planes for alphabet size sigma (>=1 symbol)."""
    return max(1, int(sigma - 1).bit_length()) if sigma > 1 else 1


def wt_index_from_words(words: np.ndarray) -> np.ndarray:
    """Superblock directory i64[L, SB] from packed planes u32[L, W] (W
    padded to a SB_WORDS multiple)."""
    L, W = words.shape
    pops = np.bitwise_count(words.astype(np.uint32)).astype(np.int64)
    return np.cumsum(pops.reshape(L, W // SB_WORDS, SB_WORDS).sum(axis=2), axis=1)


def wt_planes(symbols: np.ndarray, sigma: int) -> np.ndarray:
    """The raw bit planes u8[L, n] of the levelwise tree (for RRR storage)."""
    symbols = np.asarray(symbols, dtype=np.uint32)
    L = wt_levels(sigma)
    planes = np.zeros((L, len(symbols)), dtype=np.uint8)
    for l in range(L):
        # level-l sequence = stable sort by top-l bits
        seq = symbols if l == 0 else symbols[np.argsort(symbols >> (L - l), kind="stable")]
        planes[l] = (seq >> (L - 1 - l)) & 1
    return planes


def build_wavelet_tree(symbols: np.ndarray, sigma: int, device) -> WaveletTree:
    """Host build, then the tables to ``device``. ``symbols``: u32[n] values
    in [0, sigma)."""
    planes = wt_planes(symbols, sigma)
    L, n = planes.shape
    W = max((n + SB_BITS - 1) // SB_BITS, 1) * SB_WORDS
    words = np.stack([np_pack_fixed(p, 1, total_bits=W * 32) for p in planes])
    sb = wt_index_from_words(words)
    return WaveletTree(torch.from_numpy(words.view(np.int32)).to(device),
                       torch.from_numpy(sb).to(device), n, L)


# ---------------------------------------------------------------------------
# device rank/select on one level
# ---------------------------------------------------------------------------


def _window(wt: WaveletTree, level: int, sb: torch.Tensor) -> torch.Tensor:
    """Each query's superblock window → u32 values i64[Q, SB_WORDS]."""
    SB = wt.words.shape[1] // SB_WORDS
    return u32(wt.words[level].reshape(SB, SB_WORDS)[sb])


def _before(cum: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """cum[q, idx[q] - 1] where idx[q] > 0, else 0."""
    return torch.where(idx > 0, cum.gather(1, (idx - 1).clamp(min=0)[:, None])[:, 0], 0)


def _rank1(wt: WaveletTree, level: int, pos: torch.Tensor) -> torch.Tensor:
    """Set bits strictly below pos on a level; pos i64[Q]."""
    word_idx = pos >> 5
    SB = wt.sb_prefix.shape[1]
    sb = (word_idx // SB_WORDS).clamp(max=SB - 1)
    before = torch.where(sb > 0, wt.sb_prefix[level, (sb - 1).clamp(min=0)], 0)
    win = _window(wt, level, sb)
    g = sb[:, None] * SB_WORDS + torch.arange(SB_WORDS, device=pos.device)
    part = (1 << (pos & 31)[:, None]) - 1
    mask = torch.where(g < word_idx[:, None], 0xFFFFFFFF,
                       torch.where(g == word_idx[:, None], part, 0))
    return before + popcount32(win & mask).sum(dim=1)


def _ones_and_zeros(wt: WaveletTree, level: int):
    """(ones, zeros) through each superblock of a level: the zeros directory
    derives from the ones directory, (sb+1)*SB_BITS - ones."""
    p1 = wt.sb_prefix[level]
    return p1, (torch.arange(p1.shape[0], device=p1.device) + 1) * SB_BITS - p1


def _select_merged(wt: WaveletTree, level: int, k: torch.Tensor,
                   invert: torch.Tensor) -> torch.Tensor:
    """select1, or select0 where ``invert``, of the (k+1)-th bit on a level:
    the first superblock whose count exceeds k (searchsorted over the
    polarity's directory), the word by a popcount cumsum over the window
    (complemented for zeros), then the bit."""
    p1, p0 = _ones_and_zeros(wt, level)
    SB = p1.shape[0]
    sb1 = torch.searchsorted(p1, k + 1, side="left")
    sb0 = torch.searchsorted(p0, k + 1, side="left")
    sb = torch.where(invert, sb0, sb1).clamp(0, SB - 1)
    prev = (sb - 1).clamp(min=0)
    before_sb = torch.where(sb > 0, torch.where(invert, p0[prev], p1[prev]), 0)
    win = _window(wt, level, sb)
    win = torch.where(invert[:, None], win ^ 0xFFFFFFFF, win)
    cum = torch.cumsum(popcount32(win), dim=1)
    rel = (cum <= (k - before_sb)[:, None]).sum(dim=1).clamp(0, SB_WORDS - 1)
    before = before_sb + _before(cum, rel)
    word = win.gather(1, rel[:, None])[:, 0]
    return (sb * SB_WORDS + rel) * 32 + select_in_word(word, k - before)


def _select1(wt: WaveletTree, level: int, k: torch.Tensor) -> torch.Tensor:
    """Position of the (k+1)-th set bit (k 0-based)."""
    return _select_merged(wt, level, k, torch.zeros_like(k, dtype=torch.bool))


def _select0(wt: WaveletTree, level: int, k: torch.Tensor) -> torch.Tensor:
    """Position of the (k+1)-th clear bit (k 0-based)."""
    return _select_merged(wt, level, k, torch.ones_like(k, dtype=torch.bool))


# ---------------------------------------------------------------------------
# wavelet-tree select: position of the (offset+1)-th occurrence of symbol
# ---------------------------------------------------------------------------


def wt_path_tables(symbol_counts: np.ndarray, L: int) -> np.ndarray:
    """Static per-symbol walk tables i64[2^L, L, 3].

    The top-down sweep of the select walk depends only on the symbol, and
    node boundaries in a levelwise tree are prefix histograms of the symbol
    distribution (for the IVF tree: the list lengths), so it precomputes.
    Entry [s, l] = (r0_lo, r1_lo, child_lo) for the level-l node on s's
    path: rank0/rank1 of plane l at the node start, and the start of the
    child node the path descends into (at the last level, the first
    position of symbol s's block of occurrences)."""
    counts = np.asarray(symbol_counts, dtype=np.int64)
    sigma_pad = 1 << L
    if len(counts) > sigma_pad:
        raise ValueError(f"{len(counts)} symbols exceed 2^{L}")
    hist = np.zeros(sigma_pad, np.int64)
    hist[: len(counts)] = counts
    # hists[w][p] = #symbols whose width-w prefix == p
    hists = [None] * (L + 1)
    hists[L] = hist
    for w in range(L - 1, -1, -1):
        hists[w] = hists[w + 1].reshape(-1, 2).sum(axis=1)

    out = np.zeros((sigma_pad, L, 3), np.int64)
    sym = np.arange(sigma_pad, dtype=np.int64)
    for l in range(L):
        p = sym >> (L - l)                      # level-l node = width-l prefix
        # ones of plane l inside node q = hists[l+1][2q+1]; node starts tile
        # the level in prefix order, so rank at a node start is a cumsum
        c_lo = np.concatenate(([0], np.cumsum(hists[l])))
        c_r1 = np.concatenate(([0], np.cumsum(hists[l + 1][1::2])))
        c_child = np.concatenate(([0], np.cumsum(hists[l + 1])))
        lo = c_lo[p]
        r1_lo = c_r1[p]
        out[:, l, 0] = lo - r1_lo               # r0_lo
        out[:, l, 1] = r1_lo
        out[:, l, 2] = c_child[sym >> (L - 1 - l)]
    return out


def _wt_select_tables(L: int, select_merged, tables: torch.Tensor,
                      symbol: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Bottom-up-only select walk with the path tables: one row gather
    [Q, L, 3] replaces every rank of the top-down sweep, and each level runs
    one merged select with per-query polarity."""
    t = tables[symbol]                          # [Q, L, 3]
    p = t[:, L - 1, 2] + offset                 # leaf position
    for l in reversed(range(L)):
        zero = ((symbol >> (L - 1 - l)) & 1) == 0
        j = p - t[:, l, 2]
        k = torch.where(zero, t[:, l, 0], t[:, l, 1]) + j
        p = select_merged(l, k, zero)
    return p


def _wt_select_generic(n: int, L: int, rank1, select0, select1,
                       symbol: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """The two-sweep select walk, parameterized over the level primitives
    (plain bit planes or RRR-compressed planes — codecs/rrr.py)."""
    Q = offset.shape[0]
    # top-down: node interval [lo, hi) along the bit path; remember per level
    # the branch bit, rank0/rank1 at the node start and the child start
    lo = torch.zeros_like(offset)
    hi = torch.full_like(offset, n)
    per_level = []
    for l in range(L):
        b = (symbol >> (L - 1 - l)) & 1
        r1_both = rank1(l, torch.cat([lo, hi]))  # one batched rank for both ends
        r1_lo, r1_hi = r1_both[:Q], r1_both[Q:]
        r0_lo = lo - r1_lo
        z = (hi - r1_hi) - r0_lo  # zeros inside [lo, hi)
        child_lo = torch.where(b == 0, lo, lo + z)
        child_hi = torch.where(b == 0, lo + z, hi)
        per_level.append((b, r0_lo, r1_lo, child_lo))
        lo, hi = child_lo, child_hi

    # bottom-up: lift the in-leaf offset through select at each level
    p = lo + offset
    for l in reversed(range(L)):
        b, r0_lo, r1_lo, child_lo = per_level[l]
        j = p - child_lo
        p = torch.where(b == 0, select0(l, r0_lo + j), select1(l, r1_lo + j))
    return p


def _walk(planes, rank1, select0, select1, select_merged, symbol, offset, tables):
    """Shared front of ``wt_select`` and ``wt_select_rrr`` over ``planes``
    (each level's primitives take it first): queries of any shape, as int64,
    through the table walk or the two-sweep walk."""
    shape = offset.shape
    symbol = symbol.reshape(-1).to(torch.int64)
    offset = offset.reshape(-1).to(torch.int64)
    if tables is not None:
        out = _wt_select_tables(planes.levels, lambda l, k, inv: select_merged(planes, l, k, inv),
                                tables, symbol, offset)
    else:
        out = _wt_select_generic(planes.n, planes.levels, lambda l, pos: rank1(planes, l, pos),
                                 lambda l, k: select0(planes, l, k),
                                 lambda l, k: select1(planes, l, k), symbol, offset)
    return out.reshape(shape)


def wt_select(wt: WaveletTree, symbol: torch.Tensor, offset: torch.Tensor,
              tables: torch.Tensor | None = None) -> torch.Tensor:
    """Vectorized over query tensors: global position (the vector id) of the
    (offset+1)-th occurrence of ``symbol`` (0-based offset) — the reference's
    wt.select(offset+1, list_no) (custom_invlists_impl.cpp:377-379).

    With ``tables`` (wt_path_tables, on the tree's device) the top-down rank
    sweep is replaced by one table gather and only the L bottom-up selects
    run; without, the classic two-sweep walk."""
    return _walk(wt, _rank1, _select0, _select1, _select_merged, symbol, offset, tables)


def wt_select_rrr(rrr, symbol: torch.Tensor, offset: torch.Tensor,
                  tables: torch.Tensor | None = None) -> torch.Tensor:
    """wt_select over RRR(63)-compressed bit planes (wt_type 1 —
    sdsl::wt_int<rrr_vector<63>> parity, custom_invlists_impl.cpp:367-373)."""
    from .rrr import rrr_rank1, rrr_select0, rrr_select1, rrr_select_merged

    return _walk(rrr, rrr_rank1, rrr_select0, rrr_select1, rrr_select_merged, symbol, offset,
                 tables)

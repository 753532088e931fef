"""Lane-batched ROC codec in plain torch — lists as lanes.

Port of the JAX package's ``codecs/roc_device.py``. The ANS chain is
sequential within a list but independent across lists, so a batch of B
padded lists advances in lockstep through one Python loop of dense torch ops
over the lane dimension. These two functions are the plain versions of the
two CUDA kernels (``ops/roc_encode.py``, ``ops/roc_decode.py``): the CPU
tests hold them bit-exact against the JAX codec, and the kernels are held
bit-exact against them.

Bit-exactness: each lane reproduces the reference stream exactly (same 64-bit
head arithmetic, same 32-bit stack words in the same order, same
MT19937(1234) initial-bits draws from a shared pool).

Unsigned arithmetic: torch has no shift, add, compare or division for
uint32/uint64 on CPU, so the u64 head is carried in int64 and the u32 words
as int64 values in [0, 2^32). That is sound because every step that can
grow the head spills a word first, so the head and every intermediate stay
below 2^63 — with one exception: three spill thresholds equal exactly 2^63 at
edge cases (a
power-of-two modulus in ``_pop_mod``, modulus 1 in ``_push_mod``, a p = 0
slice in ``_push_symbol``) and would wrap negative in int64. Those compare
the head's high 32-bit word with the threshold's instead (``head >> 32 >=
t`` is ``head >= t << 32`` for integer t). Ids must be < 2^63.

State layout per batch of B lists:
  head:      i64[B]       u64 rANS head (value < 2^63)
  stack:     i32[B, cap]  bottom-to-top u32 stack words, as i32 bit patterns
  stack_len: i32[B]
  mt_ctr:    i32[B]       pool words drawn so far
  err:       bool[B]      stack overflow / pool exhaustion
The pool is the shared MT19937(1234) output as i32 bit patterns.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..core.mt19937 import mt19937_pool

RANS_L = 1 << 31
_MASK32 = 0xFFFFFFFF


class RocStates(NamedTuple):
    """Batched ANS states for B lists (layout in the module docstring)."""

    head: torch.Tensor
    stack: torch.Tensor
    stack_len: torch.Tensor
    mt_ctr: torch.Tensor
    err: torch.Tensor

    @property
    def size_bytes(self) -> torch.Tensor:
        """Per-list compressed size, matching reference codec.h:42-44."""
        return 8 + 4 * self.stack_len.to(torch.int64)


def fresh_states(batch: int, cap: int, device="cpu") -> RocStates:
    return RocStates(
        head=torch.full((batch,), RANS_L, dtype=torch.int64, device=device),
        stack=torch.zeros((batch, cap), dtype=torch.int32, device=device),
        stack_len=torch.zeros(batch, dtype=torch.int32, device=device),
        mt_ctr=torch.zeros(batch, dtype=torch.int32, device=device),
        err=torch.zeros(batch, dtype=torch.bool, device=device),
    )


@lru_cache(maxsize=16)
def _pool_bits(count: int) -> np.ndarray:
    pool = mt19937_pool(count=count).view(np.int32)
    pool.flags.writeable = False
    return pool


def default_pool(n_max: int, device="cpu") -> torch.Tensor:
    """MT19937(1234) pool sized for encode+decode of lists up to n_max, as
    i32 bit patterns (the numpy draws are cached; each call copies)."""
    return torch.tensor(_pool_bits(n_max + 64), device=device)


def stack_capacity(n_max: int, max_precision: int) -> int:
    """Per-list stack bound: pushes add <= precision bits per element (spilled
    in 32-bit words), plus slack for pop-side spills. Overflow is detected at
    run time via the err flag (never silent)."""
    return (n_max * max_precision + 31) // 32 + max(16, n_max // 8)


def n_slices_for(max_precision: int) -> int:
    """Count of active 16-bit symbol slices for a batch."""
    return max(1, -(-int(max_precision) // 16))


def digit_bits_for(n_max: int) -> int:
    """Digit width of the JAX codec's u64 long division for a modulus below
    n_max. The torch codec divides int64 natively and the CUDA kernels divide
    u64 natively; this keeps the JAX codec's limit visible to callers."""
    if n_max < (1 << 16):
        return 16
    if n_max < (1 << 24):
        return 8
    raise ValueError("lists longer than 2^24 are not supported per bucket")


# ---------------------------------------------------------------------------
# working state: the head in int64, stack words and pool as u32 values in
# int64, updated in place (a private copy of the caller's RocStates)
# ---------------------------------------------------------------------------


class _Lanes:
    def __init__(self, st: RocStates, pool: torch.Tensor):
        self.head = st.head.to(torch.int64).clone()
        self.stack = st.stack.to(torch.int64) & _MASK32
        self.stack_len = st.stack_len.to(torch.int64).clone()
        self.mt_ctr = st.mt_ctr.to(torch.int64).clone()
        self.err = st.err.clone()
        self.pool = pool.to(torch.int64) & _MASK32
        self.rows = torch.arange(self.head.shape[0], device=self.head.device)

    def states(self) -> RocStates:
        w = self.stack
        return RocStates(
            head=self.head,
            stack=torch.where(w >= RANS_L, w - (1 << 32), w).to(torch.int32),
            stack_len=self.stack_len.to(torch.int32),
            mt_ctr=self.mt_ctr.to(torch.int32),
            err=self.err,
        )

    def push(self, word, mask):
        """Push one u32 word on every lane where ``mask``."""
        cap = self.stack.shape[1]
        idx = self.stack_len.clamp(0, cap - 1)
        old = self.stack[self.rows, idx]
        self.stack[self.rows, idx] = torch.where(mask, word, old)
        self.err |= mask & (self.stack_len >= cap)
        self.stack_len += mask.to(torch.int64)

    def pop(self, take):
        """One u32 refill word per lane: stack top if nonempty, else the
        pool at ``mt_ctr``; state advances only where ``take``."""
        cap, n_pool = self.stack.shape[1], self.pool.shape[0]
        has = self.stack_len > 0
        top = self.stack[self.rows, (self.stack_len - 1).clamp(0, cap - 1)]
        pooled = self.pool[self.mt_ctr.clamp(0, n_pool - 1)]
        from_pool = take & ~has
        self.stack_len -= (take & has).to(torch.int64)
        self.err |= from_pool & (self.mt_ctr >= n_pool)
        self.mt_ctr += from_pool.to(torch.int64)
        return torch.where(has, top, pooled)


# ---------------------------------------------------------------------------
# rANS primitives, vectorized over lanes (reference codec.cpp:21-121)
# ---------------------------------------------------------------------------


def _pop_mod(st: _Lanes, nmax, active):
    """pop_with_finer_precision (codec.cpp:21-42). ``nmax`` i64[B]."""
    nm = nmax.clamp(min=1)
    head0 = st.head
    q32 = RANS_L // nm
    # head >= nm * q32 << 32, on the high word (nm * q32 == 2^31 for a
    # power-of-two nm, i.e. a threshold of 2^63)
    spill = ((head0 >> 32) >= nm * q32) & active
    st.push(head0 & _MASK32, spill)
    head0 = torch.where(spill, head0 >> 32, head0)
    q, cfs = head0 // nm, head0 % nm
    refill = (head0 < RANS_L) & active
    word = st.pop(refill)
    head = torch.where(refill, word | (q << 32), q)
    st.head = torch.where(active, head, st.head)
    return torch.where(active, cfs, torch.zeros_like(cfs))


def _push_mod(st: _Lanes, value, nmax: int, active):
    """push_with_finer_precision (codec.cpp:44-63) with one modulus for all
    lanes (decode step i pushes modulo i + 1)."""
    head0 = st.head
    # head >= q32 << 32, on the high word (q32 == 2^31 for nmax == 1)
    spill = ((head0 >> 32) >= RANS_L // nmax) & active
    st.push(head0 & _MASK32, spill)
    head0 = torch.where(spill, head0 >> 32, head0)
    head = head0 * nmax + value
    refill = (head < RANS_L) & active
    word = st.pop(refill)
    head = torch.where(refill, (head << 32) | word, head)
    st.head = torch.where(active, head, st.head)


def _slice_lowers(n_slices: int):
    """Active 16-bit slice offsets. Slices with clamped precision 0 for every
    lane are exact no-ops on any valid stream, so callers pass
    n_slices = ceil(max_precision / 16)."""
    return (0, 16, 32, 48)[:n_slices]


def _push_symbol(st: _Lanes, symbol, precision, active, n_slices: int):
    """codec_push (codec.cpp:92-105): 16-bit slices, low slice first."""
    for lower in _slice_lowers(n_slices):
        p = (precision - lower).clamp(0, 16)
        s = (symbol >> lower) & 0xFFFF
        # head >= (RANS_L >> p) << 32, on the high word (2^63 for p == 0)
        spill = ((st.head >> 32) >= (torch.full_like(p, RANS_L) >> p)) & active
        st.push(st.head & _MASK32, spill)
        head0 = torch.where(spill, st.head >> 32, st.head)
        st.head = torch.where(active, (head0 << p) + s, st.head)


def _pop_symbol(st: _Lanes, precision, active, n_slices: int):
    """codec_pop (codec.cpp:107-121): high slice first."""
    symbol = torch.zeros_like(st.head)
    for lower in reversed(_slice_lowers(n_slices)):
        p = (precision - lower).clamp(0, 16)
        cfs = st.head & ((torch.ones_like(p) << p) - 1)
        h = st.head >> p
        refill = (h < RANS_L) & active
        word = st.pop(refill)
        h = torch.where(refill, (h << 32) | word, h)
        st.head = torch.where(active, h, st.head)
        symbol = torch.where(active, (symbol << 16) | cfs, symbol)
    return symbol


# ---------------------------------------------------------------------------
# full ROC encode / decode over a padded batch
# ---------------------------------------------------------------------------


def roc_encode_batch(sorted_ids, lengths, precision, pool, states: RocStates,
                     n_slices: int = 4):
    """Encode B lists in lockstep.

    Args:
      sorted_ids: i64[B, n_max] — each lane's ids ascending in [0:len),
        padding arbitrary beyond.
      lengths: i32[B] true list sizes; precision: i32[B] per-lane bit widths.
      pool: i32[P] MT19937 pool bits; states: fresh (or resumed) RocStates.

    Returns (states, order) where order: i32[B, n_max] gives, per lane, the
    index into the lane's sorted ids emitted at step i (-1 past its length);
    payload codes must be reordered by it (custom_invlists_impl.cpp:178-193).
    """
    B, n_max = sorted_ids.shape
    dev = sorted_ids.device
    lengths = lengths.to(torch.int64)
    precision = precision.to(torch.int64)
    st = _Lanes(states, pool)
    cols = torch.arange(n_max, device=dev)
    alive = (cols[None, :] < lengths[:, None]).to(torch.int32)
    order = torch.full((B, n_max), -1, dtype=torch.int32, device=dev)
    for i in range(int(lengths.max()) if B else 0):
        active = i < lengths
        k = _pop_mod(st, lengths - i, active)
        # select the k-th (0-based) remaining element per lane
        hit = torch.cumsum(alive, dim=1) == (k + 1)[:, None]
        pos = hit.to(torch.int32).argmax(dim=1)
        symbol = sorted_ids[st.rows, pos]
        alive[st.rows, pos] = torch.where(active, 0, alive[st.rows, pos])
        _push_symbol(st, symbol, precision, active, n_slices)
        order[:, i] = torch.where(active, pos, -1).to(torch.int32)
    return st.states(), order


def roc_decode_batch(states: RocStates, lengths, precision, pool, n_max: int,
                     n_slices: int = 4):
    """Decode B lists in lockstep; inverse of ``roc_encode_batch``.

    Returns (ids, states): ids i64[B, n_max] in encode sampling order
    (matching reordered payload codes), zero-padded beyond each lane's length.
    """
    B = lengths.shape[0]
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    precision = precision.to(torch.int64)
    st = _Lanes(states, pool)
    syms = torch.zeros((B, n_max), dtype=torch.int64, device=dev)
    for i in range(int(lengths.max()) if B else 0):
        active = i < lengths
        symbol = _pop_symbol(st, precision, active, n_slices)
        # rank among previously decoded symbols (count of strictly smaller)
        rank = (syms[:, :i] < symbol[:, None]).sum(dim=1)
        syms[:, i] = symbol
        _push_mod(st, rank, i + 1, active)
    # decode step i yields sampling-order slot len-1-i
    j = torch.arange(n_max, device=dev)[None, :]
    src = (lengths[:, None] - 1 - j).clamp(0, n_max - 1)
    ids = torch.gather(syms, 1, src)
    ids = torch.where(j < lengths[:, None], ids, torch.zeros_like(ids))
    return ids, st.states()

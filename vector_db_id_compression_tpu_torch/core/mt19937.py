"""Bit-exact MT19937 (the 32-bit Mersenne Twister).

The reference ANS state draws pseudo-random "initial bits" from a
``std::mt19937`` seeded with 1234 whenever its 32-bit stack underflows
(reference: custom_invlist_cpp/codec.h:16-40). Bit-exact stream equality with
the reference therefore requires a bit-exact MT19937. This is the standard
Matsumoto–Nishimura algorithm; ``std::mt19937`` and ``numpy.random.MT19937``
implement the identical sequence for a 32-bit integer seed.

We expose two things:
  - ``MT19937``: a tiny stateful generator for the host (numpy) code path.
  - ``mt19937_pool(seed, count)``: the first ``count`` outputs as a numpy
    array. Device codecs consume initial bits from this pool via a per-lane
    counter, because draw counts are data-dependent and tiny while the pool
    is cheap to precompute.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)

DEFAULT_SEED = 1234  # reference: custom_invlist_cpp/codec.h:18 (ANSState(): mt(1234))


class MT19937:
    """Minimal bit-exact MT19937 producing the std::mt19937 sequence."""

    __slots__ = ("_state", "_index")

    def __init__(self, seed: int = DEFAULT_SEED):
        state = np.empty(_N, dtype=np.uint32)
        state[0] = np.uint32(seed)
        for i in range(1, _N):
            prev = state[i - 1]
            state[i] = np.uint32(
                (np.uint64(1812433253) * np.uint64(prev ^ (prev >> np.uint32(30)))
                 + np.uint64(i)) & np.uint64(0xFFFFFFFF)
            )
        self._state = state
        self._index = _N  # force twist on first draw

    def _twist(self) -> None:
        # Staged vectorization: within each stage every read of a *new* value
        # comes from an earlier stage, and every read of an *old* value is a
        # slot the stage has not yet overwritten.
        s = self._state

        def _mix(hi_src, lo_src):
            y = (hi_src & _UPPER_MASK) | (lo_src & _LOWER_MASK)
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
            return (y >> np.uint32(1)) ^ mag

        new = np.empty_like(s)
        # i in [0, N-M): mt[i+M] still old, mt[i+1] still old
        new[: _N - _M] = s[_M:] ^ _mix(s[: _N - _M], s[1 : _N - _M + 1])
        # i in [N-M, N-1): mt[i+M-N] is new; that source overlaps this range,
        # so process in (N-M)-wide blocks — each block only reads completed ones
        step = _N - _M
        for lo in range(step, _N - 1, step):
            hi = min(lo + step, _N - 1)
            new[lo:hi] = new[lo - step : hi - step] ^ _mix(s[lo:hi], s[lo + 1 : hi + 1])
        # i = N-1: mt[M-1] new, mt[0] new
        new[_N - 1] = new[_M - 1] ^ _mix(s[_N - 1 : _N], new[0:1])[0]
        self._state = new
        self._index = 0

    def __call__(self) -> int:
        if self._index >= _N:
            self._twist()
        y = self._state[self._index]
        self._index += 1
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        return int(y)

    def clone(self) -> "MT19937":
        out = MT19937.__new__(MT19937)
        out._state = self._state.copy()
        out._index = self._index
        return out


def mt19937_pool(seed: int = DEFAULT_SEED, count: int = 1024) -> np.ndarray:
    """First ``count`` outputs of MT19937(seed) as uint32 ndarray."""
    gen = MT19937(seed)
    return np.array([gen() for _ in range(count)], dtype=np.uint32)

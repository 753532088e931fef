"""Order statistics over multisets of symbols.

Copied from the JAX package's ``core/order_stats.py`` (numpy and Python
only), so that the port's host ROC codec (``codecs/roc.py``) needs no import
of that package.

The ROC codec needs two dual operations (reference uses an unbalanced BST with
subtree-size counts, fenwick_tree_cpp/src/fenwick_tree.h:42-140):

  encode side:  select-and-remove the k-th smallest remaining element from a
                multiset known upfront;
  decode side:  insert a symbol and return its rank (count of strictly
                smaller elements already inserted).

We use array/rank-space structures instead of pointer trees — the encode-side
multiset is known upfront, so sort once and keep a Fenwick binary indexed tree
of presence counts over rank space; select is O(log n) by binary lifting. This
shape also maps directly onto the batched device implementation (dense
cumsum/compare over lanes) in ``codecs.roc_device``.

Note: the reference codec is only lossless for *distinct* symbols — with
duplicates, the encoder pops an index anywhere in the [start, start+freq)
range but the decoder can only push back ``start``, corrupting the state
(codec.cpp:123-152). All uses (IVF ids, graph adjacency) are distinct. The
classes here still support multiplicities so the tree semantics can be tested
standalone like the reference's fenwick_tree tests.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple

import numpy as np


class FenwickOrderStats:
    """Fenwick (BIT) presence/multiplicity counts over a fixed sorted domain.

    Built from the full multiset (encode side). ``select_remove(k)`` returns
    (domain_index, symbol) for the k-th smallest remaining element (0-based)
    and decrements its count.
    """

    def __init__(self, sorted_unique: np.ndarray, counts: Sequence[int]):
        self.domain = np.asarray(sorted_unique)
        n = len(self.domain)
        self._n = n
        # binary lifting needs the highest power of two <= n
        self._log = max(n.bit_length() - 1, 0)
        self._tree = [0] * (n + 1)
        self._total = 0
        for i, c in enumerate(counts):
            if c:
                self._add(i, int(c))

    @classmethod
    def from_multiset(cls, values: np.ndarray) -> "FenwickOrderStats":
        uniq, counts = np.unique(np.asarray(values), return_counts=True)
        return cls(uniq, counts.tolist())

    def _add(self, i: int, delta: int) -> None:
        self._total += delta
        i += 1
        while i <= self._n:
            self._tree[i] += delta
            i += i & (-i)

    def __len__(self) -> int:
        return self._total

    def rank(self, i: int) -> int:
        """Count of elements with domain index < i."""
        s = 0
        while i > 0:
            s += self._tree[i]
            i -= i & (-i)
        return s

    def select_remove(self, k: int) -> Tuple[int, int]:
        """Remove and return (domain_index, symbol) of the k-th smallest
        remaining element, 0-based. Binary lifting over the BIT."""
        if not (0 <= k < self._total):
            raise IndexError(f"select_remove({k}) of {self._total} elements")
        pos = 0
        rem = k
        step = 1 << self._log
        while step:
            nxt = pos + step
            if nxt <= self._n and self._tree[nxt] <= rem:
                rem -= self._tree[nxt]
                pos = nxt
            step >>= 1
        # pos = number of leading domain slots whose cumulative count <= k
        self._add(pos, -1)
        return pos, int(self.domain[pos])

    def reverse_lookup_then_remove(self, k: int) -> Tuple[int, int, int]:
        """Reference-shaped variant (fenwick_tree.h reverse_lookup_then_remove,
        exercised at tests/test_fenwick_tree.cpp:80-135): remove the k-th
        smallest and return the Range triple (symbol, start, freq) where
        start = count of strictly smaller elements and freq = the symbol's
        multiplicity *before* this removal."""
        if not (0 <= k < self._total):
            raise IndexError(f"reverse_lookup_then_remove({k}) of {self._total}")
        pos = 0
        rem = k
        step = 1 << self._log
        while step:
            nxt = pos + step
            if nxt <= self._n and self._tree[nxt] <= rem:
                rem -= self._tree[nxt]
                pos = nxt
            step >>= 1
        start = self.rank(pos)
        freq = self.rank(pos + 1) - start
        self._add(pos, -1)
        return int(self.domain[pos]), start, freq

    def inorder_traversal(self) -> List[int]:
        """Remaining multiset in sorted order (reference inorder_traversal)."""
        out: List[int] = []
        for i in range(self._n):
            out.extend([int(self.domain[i])] * (self.rank(i + 1) - self.rank(i)))
        return out


class InsertRank:
    """Decode-side dual: insert symbols one at a time, return rank.

    ``insert(symbol)`` returns the number of strictly smaller elements present
    before this insert — exactly the ``Range.start`` the reference decoder
    pushes back (codec.cpp:147-149). Backed by a sorted Python list with
    C-speed bisect/insort.
    """

    def __init__(self):
        self._sorted: List[int] = []

    def insert(self, symbol: int) -> int:
        r = bisect.bisect_left(self._sorted, symbol)
        self._sorted.insert(r, symbol)
        return r

    def insert_then_forward_lookup(self, symbol: int) -> Tuple[int, int, int]:
        """Reference-shaped variant (fenwick_tree.h insert_then_forward_lookup,
        tests/test_fenwick_tree.cpp:16-78): insert and return the Range triple
        (symbol, start, freq) with freq = multiplicity *after* the insert."""
        start = self.insert(symbol)
        freq = bisect.bisect_right(self._sorted, symbol) - start
        return symbol, start, freq

    def __len__(self) -> int:
        return len(self._sorted)

    def as_sorted(self) -> List[int]:
        return list(self._sorted)

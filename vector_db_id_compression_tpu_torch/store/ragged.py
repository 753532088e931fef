"""Size-bucketed batching of ragged lists.

Copied from the JAX package's ``store/ragged.py`` (numpy only). Lists are
grouped into geometric size buckets, each padded to its ceiling, with the
padding waste bounded. The port's IVF scan storage (``search/ivf.py``) keeps
one padded payload tensor per bucket; the ROC container needs no buckets (one
kernel launch covers lanes of any length).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Bucket:
    """Lists of similar length, padded to ``n_pad``."""

    list_ids: np.ndarray  # i64[B] original list numbers
    lengths: np.ndarray   # i32[B]
    n_pad: int


def bucketize(lengths: Sequence[int], growth: float = 2.0, min_pad: int = 8,
              max_waste: float = 1.35, abs_slack: float = 0.04) -> List[Bucket]:
    """Group list indices into size buckets (empty lists dropped).

    Each bucket grows one member at a time (in length order) while its
    padded-slot waste stays under ``max_waste`` (padded slots / true slots),
    so n_pad stays near each bucket's own lengths and the number of buckets
    stays O(log(max_len)/log(growth)).

    ``abs_slack`` is a global budget of extra padded slots (a fraction of the
    total true slots) spent after that pass on merging small buckets into
    their larger neighbour, cheapest merge first: the ratio rule alone
    strands distribution tails in near-empty buckets, and every bucket costs
    one more scan launch per search."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nonempty = np.flatnonzero(lengths > 0)
    if len(nonempty) == 0:
        return []
    order = nonempty[np.argsort(lengths[nonempty], kind="stable")]
    sorted_lens = lengths[order]
    csum = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(sorted_lens, out=csum[1:])
    # two-pointer greedy: extend the bucket one member at a time (cap = the
    # new member's length) while waste stays bounded; growing the cap
    # multiplicatively would give one bucket per distinct length near the
    # distribution's mode.
    spans: List[Tuple[int, int, int]] = []  # (lo, hi, cap) over `order`
    lo = 0
    n = len(order)
    while lo < n:
        hi = lo + 1
        cap = max(int(sorted_lens[lo]), min_pad)
        while hi < n:
            cand = max(int(sorted_lens[hi]), min_pad)
            if (hi + 1 - lo) * cand > max_waste * int(csum[hi + 1] - csum[lo]):
                break
            cap = cand
            hi += 1
        spans.append((lo, hi, cap))
        lo = hi

    # merge pass: absorbing span i into its larger right neighbor costs
    # (hi_i - lo_i) * (cap_{i+1} - cap_i) extra padded slots; apply
    # cheapest merges while the global budget lasts
    slack = int(abs_slack * int(csum[-1]))
    while len(spans) > 1:
        costs = [
            (spans[i][1] - spans[i][0]) * (spans[i + 1][2] - spans[i][2])
            for i in range(len(spans) - 1)
        ]
        i = int(np.argmin(costs))
        if costs[i] > slack:
            break
        slack -= costs[i]
        spans[i] = (spans[i][0], spans[i + 1][1], spans[i + 1][2])
        del spans[i + 1]

    buckets: List[Bucket] = []
    for lo, hi, cap in spans:
        ids = order[lo:hi]
        buckets.append(
            Bucket(
                list_ids=ids.copy(),
                lengths=lengths[ids].astype(np.int32),
                n_pad=cap,
            )
        )
    return buckets


def pad_lists(
    arrays: Sequence[np.ndarray], n_pad: int, dtype=None, fill=0
) -> np.ndarray:
    """[B, n_pad] padded stack of 1-D arrays."""
    B = len(arrays)
    dtype = dtype or arrays[0].dtype
    out = np.full((B, n_pad), fill, dtype=dtype)
    for b, a in enumerate(arrays):
        out[b, : len(a)] = a
    return out

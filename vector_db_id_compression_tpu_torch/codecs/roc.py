"""ROC — Random Order Coding of an unordered set of IDs (bits-back rANS).

The symbol-precision rules and the host codec, copied from the JAX package's
``codecs/roc.py``, and the safe rule over a tensor of ids (for the graph
containers, which take one precision per node on the device). The
lane-batched codec is ``codecs/roc_device.py``.

Host codec (numpy and Python ints, the exact oracle; reference
custom_invlist_cpp/codec.cpp:123-152). Encode, per list:
    for i in 0..n-1:
        idx    = pop_mod(state, n - i)            # sample w/o replacement
        symbol = idx-th order statistic of the remaining ids; remove it
        push_symbol(state, symbol, precision)
Decode is the exact inverse; the decoded order equals the encode sampling
order, so payload codes reordered at encode time line up.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.mt19937 import DEFAULT_SEED
from ..core.order_stats import FenwickOrderStats, InsertRank
from ..core.rans import RansState, pop_mod, pop_symbol, push_mod, push_symbol


def precision_for_max_id(max_id: int) -> int:
    """ceil(log2(max_id)) for max_id >= 1, as the reference computes it
    (custom_invlists_impl.cpp:163-164, altid_impl.cpp:125).

    Equals (max_id - 1).bit_length(): a power-of-two max_id gets a precision
    that cannot represent max_id itself — reproduced verbatim for
    bit-exactness; container layers use ``precision_for_max_id_safe``.
    """
    if max_id < 1:
        raise ValueError("max_id must be >= 1 (reference behavior is undefined)")
    return (max_id - 1).bit_length()


def precision_for_max_id_safe(max_id: int) -> int:
    """Smallest precision that can represent ``max_id`` itself.

    Identical to ``precision_for_max_id`` except when max_id is an exact
    power of two, where the reference formula under-allocates and the codec
    silently corrupts the maximum id (codec_push drops bits above
    ``precision``: codec.cpp:92-105). Containers use this variant.
    """
    if max_id < 1:
        raise ValueError("max_id must be >= 1")
    return max_id.bit_length()


def precision_for_max_ids_safe(max_ids: torch.Tensor) -> torch.Tensor:
    """``precision_for_max_id_safe`` of every element of an int64 tensor of
    ids in [1, 2^63) → i32 tensor of the same shape (the bit length, counted
    by exact integer compares)."""
    if max_ids.numel() and int(max_ids.min()) < 1:
        raise ValueError("max_id must be >= 1")
    powers = torch.ones(63, dtype=torch.int64, device=max_ids.device) << torch.arange(
        63, device=max_ids.device)
    return (max_ids[..., None] >= powers).sum(dim=-1, dtype=torch.int32)


def roc_encode(ids: np.ndarray, precision: int, state: Optional[RansState] = None,
               seed: int = DEFAULT_SEED) -> tuple[RansState, np.ndarray]:
    """Encode distinct ``ids`` into an ANS state.

    Returns (state, order): ``order[i]`` is the index into ``ids`` of the
    element emitted at step i — the permutation that payload codes must be
    reordered by so that decode order matches storage order
    (custom_invlists_impl.cpp:178-193).
    """
    ids = np.asarray(ids, dtype=np.uint64)
    n = len(ids)
    if state is None:
        state = RansState(seed)
    sort_perm = np.argsort(ids, kind="stable")
    tree = FenwickOrderStats(ids[sort_perm], np.ones(n, dtype=np.int64))
    order = np.empty(n, dtype=np.int64)
    for i in range(n):
        idx = pop_mod(state, n - i)
        pos, symbol = tree.select_remove(idx)
        push_symbol(state, symbol, precision)
        order[i] = sort_perm[pos]
    return state, order


def roc_decode(state: RansState, n: int, precision: int) -> np.ndarray:
    """Decode ``n`` ids, mutating ``state`` (clone first to keep it).

    Output order equals the encode sampling order (codec.cpp:150: the i-th
    decoded symbol lands at data[n-1-i], so data[j] is encode step j's
    symbol).
    """
    out = np.empty(n, dtype=np.uint64)
    tree = InsertRank()
    for i in range(n):
        symbol = pop_symbol(state, precision)
        start = tree.insert(symbol)
        push_mod(state, start, i + 1)
        out[n - i - 1] = symbol
    return out

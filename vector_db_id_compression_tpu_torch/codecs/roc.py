"""ROC — Random Order Coding of an unordered set of IDs (bits-back rANS).

The symbol-precision rules, copied from the JAX package's ``codecs/roc.py``,
and the safe rule over a tensor of ids (for the graph containers, which take
one precision per node on the device). The lane-batched codec is
``codecs/roc_device.py``.
"""

from __future__ import annotations

import torch


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

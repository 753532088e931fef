"""ROC — Random Order Coding of an unordered set of IDs (bits-back rANS).

The symbol-precision rules, copied from the JAX package's ``codecs/roc.py``
(numpy only). The lane-batched codec is ``codecs/roc_device.py``.
"""

from __future__ import annotations


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

"""Packed fixed-width bits — the baseline ID codec.

Port of the JAX package's ``codecs/packed_bits.py`` (reference
custom_invlists_impl.cpp:64-118): width = the smallest b with
2**b >= ntotal + 1; ids written LSB-first back to back; O(1) random access by
bit offset. ``PackedBitsBatch`` holds one row of packed words per list, and
both the full decode and random access are a two-word gather and shift
(``core.bits.fields_at``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.bits import fields_at, get_fixed_fields, pack_fields
from ..store.ragged import pad_lists


def packed_width(ntotal: int) -> int:
    """Smallest b with 2**b >= ntotal + 1 (reference custom_invlists_impl.cpp:68-70)."""
    bits = 0
    while (1 << bits) < ntotal + 1:
        bits += 1
    return bits


class PackedBitsBatch(NamedTuple):
    words: torch.Tensor    # i32[B, W] stored u32 words
    lengths: torch.Tensor  # i64[B]
    width: int

    @property
    def size_in_bytes_per_list(self) -> np.ndarray:
        """Reference accounting: (ls*bits+7)/8 bytes per list
        (custom_invlists_impl.cpp:82-84)."""
        ls = self.lengths.cpu().numpy()
        return (ls * self.width + 7) // 8


def pack_lists(id_lists: Sequence[np.ndarray], width: int, device) -> PackedBitsBatch:
    """One row per list (ids < 2**width), packed on ``device`` in one pass."""
    lengths = np.array([len(v) for v in id_lists], dtype=np.int64)
    n_max = int(lengths.max(initial=0))
    W = max((n_max * width + 31) // 32, 1)
    ids = (pad_lists([np.asarray(v, np.uint64) for v in id_lists], max(n_max, 1))
           if len(id_lists) else np.zeros((0, 1), np.uint64))
    vals = torch.from_numpy(ids.view(np.int64)).to(device)
    return PackedBitsBatch(pack_fields(vals, width, W), torch.from_numpy(lengths).to(device),
                           width)


def unpack_all(pb: PackedBitsBatch, n_max: int) -> torch.Tensor:
    """Decode every lane → i64[B, n_max], zero-padded."""
    idx = torch.arange(n_max, device=pb.words.device)[None, :].expand(pb.words.shape[0], n_max)
    vals = get_fixed_fields(pb.words, pb.width, idx)
    return torch.where(idx < pb.lengths[:, None], vals, 0)


def get_single(pb: PackedBitsBatch, lane: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """O(1) random access, vectorized over (lane, offset) query pairs —
    the reference's get_single_id (custom_invlists_impl.cpp:108-113)."""
    return fields_at(pb.words, lane.to(torch.int64), offset, pb.width)

"""Interleaved ROC — S-lane parallel coding of ONE long ID list.

Port of the JAX package's ``codecs/roc_interleaved.py``. The reference
decodes a list strictly sequentially (the ANS state threads through every
element: codec.cpp:140-152). This framework extension splits a list into S
independent streams that encode and decode as S lanes of one kernel launch:

  1. sort the ids; cut them into S contiguous chunks of near-equal size (the
     first n % S chunks one longer), so the partition costs no side
     information beyond the S chunk minima;
  2. rebase each chunk to its minimum and code it with the chunk's own safe
     precision (1 for a chunk of at most one id); the per-symbol saving of
     about log2(S) cancels, to first order, the bits-back loss of coding S
     small multisets instead of one big one;
  3. each chunk is an ordinary ROC stream, bit-exact with the single-stream
     format at S = 1 and lo = 0. The envelope per lane is (head, stack, lo,
     n_s, prec).

``chunk_plan`` is the one definition of that chunk contract, shared with
``store/invlists.py`` ``InterleavedRocInvertedLists``. Encode runs
``RocEncoder.encode`` and decode ``RocDecoder`` (the CUDA kernels on CUDA
tensors, their plain versions on CPU tensors). Decoded output order is the
lane-concatenated sampling order; ``interleaved_encode`` returns the
matching permutation, so payload codes can be co-reordered exactly as the
single-stream container does (custom_invlists_impl.cpp:188-193).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ..ops.roc_decode import RocDecoder
from ..ops.roc_encode import RocEncoder
from ..store.ragged import pad_lists
from . import roc_device as rd
from .roc import precision_for_max_id_safe


class InterleavedRoc(NamedTuple):
    """Envelope for one list coded as S lanes."""

    states: rd.RocStates      # S-lane batch, on the device that coded it
    lane_lengths: np.ndarray  # i32[S]
    lane_lo: np.ndarray       # u64[S] chunk minima (subtracted before coding)
    lane_prec: np.ndarray     # i32[S] per-chunk symbol precision

    @property
    def n(self) -> int:
        return int(self.lane_lengths.sum())

    @property
    def size_bytes(self) -> int:
        """Stream bytes + envelope accounting: per lane 8B head + 4B/stack
        word (reference codec.h:42-44) + 8B lo + 4B length + 1B precision."""
        stream = int(self.states.size_bytes.sum())
        return stream + len(self.lane_lengths) * (8 + 4 + 1)


def partition_sizes(n: int, S: int) -> np.ndarray:
    """Near-equal chunk sizes, deterministic (first n % S chunks get +1)."""
    base = n // S
    sizes = np.full(S, base, dtype=np.int64)
    sizes[: n % S] += 1
    return sizes


def chunk_plan(sorted_ids: np.ndarray, S: int):
    """The chunk contract of S-lane interleaving (sizes, minima, rebase,
    precision), shared by the codec below and the container.

    Returns (sizes i64[S], bounds i64[S+1], lo u64[S], prec i32[S],
    rebased list[S] of u64 chunks)."""
    sorted_ids = np.asarray(sorted_ids, dtype=np.uint64)
    sizes = partition_sizes(len(sorted_ids), S)
    bounds = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    lo = np.zeros(S, dtype=np.uint64)
    prec = np.zeros(S, dtype=np.int32)
    rebased = []
    for s in range(S):
        chunk = sorted_ids[bounds[s]: bounds[s + 1]]
        lo[s] = chunk[0] if len(chunk) else np.uint64(0)
        rb = chunk - lo[s]
        prec[s] = precision_for_max_id_safe(int(rb[-1])) if len(chunk) > 1 else 1
        rebased.append(rb)
    return sizes, bounds, lo, prec, rebased


def interleaved_encode(ids: np.ndarray, S: int,
                       device=DEFAULT_DEVICE) -> Tuple[InterleavedRoc, np.ndarray]:
    """Encode distinct u64 ``ids`` (< 2^63) as S lanes on ``device`` (the
    card unless the caller says ``device="cpu"``), in one encode launch.
    Returns (envelope, order): ``order[i]`` is the original index of the
    element at decoded position i (lane-concatenated decode order)."""
    ids = np.asarray(ids, dtype=np.uint64)
    n = len(ids)
    if not n >= S >= 1:
        raise ValueError(f"need n >= S >= 1, got n={n}, S={S}")
    if int(ids.max()) >= 1 << 63:
        raise ValueError("ROC ids must be < 2^63")
    sort_perm = np.argsort(ids, kind="stable")
    sizes, bounds, lo, prec, rebased = chunk_plan(ids[sort_perm], S)
    n_max = int(sizes.max())
    dev = resolve(device)
    table = pad_lists(rebased, n_max, dtype=np.uint64).view(np.int64)
    states, order = RocEncoder.encode(
        torch.from_numpy(table).to(dev), torch.from_numpy(sizes.astype(np.int32)).to(dev),
        torch.from_numpy(prec).to(dev))
    order = order.cpu().numpy()
    # lane-local sampling order (over the sorted chunk) → original index
    global_order = np.concatenate([sort_perm[bounds[s] + order[s, : sizes[s]]]
                                   for s in range(S)])
    return InterleavedRoc(states, sizes.astype(np.int32), lo, prec), global_order


def interleaved_decode(env: InterleavedRoc) -> np.ndarray:
    """Decode all S lanes in one launch; returns ids in lane-concatenated
    sampling order (matching ``interleaved_encode``'s permutation)."""
    dev = env.states.head.device
    n_max = int(env.lane_lengths.max())
    dec = RocDecoder(env.states, torch.from_numpy(env.lane_lengths).to(dev),
                     torch.from_numpy(env.lane_prec).to(dev), rd.default_pool(n_max, dev),
                     n_max)
    ids = dec.decode().cpu().numpy().view(np.uint64)
    return np.concatenate([ids[s, :n] + env.lane_lo[s]
                           for s, n in enumerate(env.lane_lengths)]).astype(np.uint64)

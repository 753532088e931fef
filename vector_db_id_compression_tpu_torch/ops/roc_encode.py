"""ROC encode: the CUDA kernel ``csrc/roc_encode.cu`` and its plain version.

Replaces the JAX package's ``ops/roc_encode_pallas.py``, and the XLA scan
``codecs/roc_device.py::roc_encode_chained`` that builds the chained graph
container. ``RocEncoder.encode`` takes a batch of lanes (one lane = one list
of sorted ids) and returns the ROC states and the sampling-order permutation;
``RocEncoder.encode_chained`` takes S lists per lane and threads them through
one state per lane. On CUDA tensors both launch the kernel; on CPU tensors
they run the plain version, ``codecs/roc_device.roc_encode_batch`` or
``roc_encode_chained``. There is no other route: a tensor on any other device
raises, and a CUDA launch that fails raises.
"""

from __future__ import annotations

import torch

from ..codecs import roc_device as rd
from ._build import check_launch, lane_stride, load_library


def _check_lane_table(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name} must be int32{list(shape)} on {device}, got "
                         f"{t.dtype}{list(t.shape)} on {t.device}")


class RocEncoder:
    """Batched ROC encoder; ``launches`` counts CUDA launches of ``encode``
    and ``chained_launches`` those of ``encode_chained``."""

    launches = 0
    chained_launches = 0

    @staticmethod
    def supports(max_precision: int, n_max: int) -> bool:
        """Envelope: ids of up to 63 bits, lists shorter than 2^31."""
        return 0 <= max_precision <= 63 and 0 <= n_max < (1 << 31)

    @staticmethod
    def encode(sorted_ids: torch.Tensor, lengths: torch.Tensor,
               precision: torch.Tensor):
        """sorted_ids i64[B, n_max] (ascending in [0, len) per lane), lengths
        and precision i32[B], all on one device → (RocStates, order
        i32[B, n_max]). Raises on stack overflow or pool exhaustion."""
        if sorted_ids.dtype != torch.int64 or sorted_ids.dim() != 2:
            raise ValueError("sorted_ids must be a 2-D int64 tensor")
        return _encode(sorted_ids[:, None], lengths, precision, chained=False)

    @staticmethod
    def encode_chained(sorted_ids: torch.Tensor, lengths: torch.Tensor,
                       precision: torch.Tensor) -> rd.RocStates:
        """S multisets per lane through one state, slot S-1 first (so that
        chained decode emits slot 0 first): sorted_ids i64[B, S, n_max]
        (ascending in [0, lengths[b, s]) per slot), lengths and precision
        i32[B, S], all on one device → RocStates. The MT19937 pool and the
        stack capacity are sized for S * n_max symbols per lane. Raises on
        stack overflow or pool exhaustion."""
        if sorted_ids.dtype != torch.int64 or sorted_ids.dim() != 3:
            raise ValueError("sorted_ids must be a 3-D int64 tensor")
        states, _ = _encode(sorted_ids, lengths, precision, chained=True)
        return states


def _encode(sorted_ids, lengths, precision, chained: bool):
    """sorted_ids i64[B, S, n_max], lengths and precision i32[B, S] (or i32[B]
    with S = 1 when not chained) → (RocStates, order or None)."""
    B, S, n_max = sorted_ids.shape
    device = sorted_ids.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"ROC encode runs on cpu or cuda tensors, not {device}")
    shape = (B, S) if chained else (B,)
    _check_lane_table("lengths", lengths, shape, device)
    _check_lane_table("precision", precision, shape, device)
    lengths, precision = lengths.reshape(B, S), precision.reshape(B, S)
    max_precision = int(precision.max()) if lengths.numel() else 0
    if not RocEncoder.supports(max_precision, n_max):
        raise ValueError(f"ROC encode supports precision <= 63 and lists "
                         f"< 2^31, got {max_precision}, {n_max}")
    cap = rd.stack_capacity(S * n_max, max(max_precision, 1))
    n_slices = rd.n_slices_for(max_precision)
    pool = rd.default_pool(S * n_max, device)
    order = None
    if device.type == "cpu":
        fresh = rd.fresh_states(B, cap, device)
        if chained:
            states = rd.roc_encode_chained(sorted_ids, lengths, precision, pool,
                                           fresh, n_slices)
        else:
            states, order = rd.roc_encode_batch(sorted_ids[:, 0], lengths[:, 0],
                                                precision[:, 0], pool, fresh, n_slices)
    else:
        states, order = _launch(sorted_ids.contiguous(), lengths.contiguous(),
                                precision.contiguous(), pool, cap, n_slices, chained)
    if bool(states.err.any()):
        raise RuntimeError("ROC encode: stack overflow or MT19937 pool "
                           "exhausted")
    return states, order


def _launch(sorted_ids, lengths, precision, pool, cap: int, n_slices: int,
            chained: bool):
    lib = load_library()
    B, S, n_max = sorted_ids.shape
    device = sorted_ids.device
    i32 = dict(dtype=torch.int32, device=device)
    head = torch.empty(B, dtype=torch.int64, device=device)
    stack = torch.zeros((B, cap), **i32)
    stack_len = torch.empty(B, **i32)
    mt_ctr = torch.empty(B, **i32)
    err = torch.empty(B, **i32)
    order = None if chained else torch.empty((B, n_max), **i32)
    stride = lane_stride(B)
    tree = torch.empty((n_max + 1, stride), **i32)
    with torch.cuda.device(device):
        code = lib.roc_encode_launch(
            sorted_ids.data_ptr(), lengths.data_ptr(), precision.data_ptr(), B, S,
            stride, n_max, pool.data_ptr(), pool.numel(), n_slices, tree.data_ptr(),
            head.data_ptr(), stack.data_ptr(), cap, stack_len.data_ptr(),
            mt_ctr.data_ptr(), None if order is None else order.data_ptr(),
            err.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "ROC encode")
    if chained:
        RocEncoder.chained_launches += 1
    else:
        RocEncoder.launches += 1
    states = rd.RocStates(head=head, stack=stack, stack_len=stack_len,
                          mt_ctr=mt_ctr, err=err != 0)
    return states, order

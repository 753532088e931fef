"""ROC encode: the CUDA kernel ``csrc/roc_encode.cu`` and its plain version.

Replaces the JAX package's ``ops/roc_encode_pallas.py``. ``RocEncoder.encode``
takes a batch of lanes (one lane = one list of sorted ids) and returns the
ROC states and the sampling-order permutation. On CUDA tensors it launches
the kernel; on CPU tensors it runs the plain version,
``codecs/roc_device.roc_encode_batch``. There is no other route: a tensor on
any other device raises, and a CUDA launch that fails raises.
"""

from __future__ import annotations

import torch

from ..codecs import roc_device as rd
from ._build import check_launch, lane_stride, load_library


def _check_lane_vector(name: str, t: torch.Tensor, B: int, device) -> None:
    if t.dtype != torch.int32 or t.shape != (B,) or t.device != device:
        raise ValueError(f"{name} must be int32[{B}] on {device}, got "
                         f"{t.dtype}{list(t.shape)} on {t.device}")


class RocEncoder:
    """Batched ROC encoder; ``launches`` counts CUDA kernel launches."""

    launches = 0

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
        B, n_max = sorted_ids.shape
        device = sorted_ids.device
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"ROC encode runs on cpu or cuda tensors, not {device}")
        _check_lane_vector("lengths", lengths, B, device)
        _check_lane_vector("precision", precision, B, device)
        max_precision = int(precision.max()) if B else 0
        if not RocEncoder.supports(max_precision, n_max):
            raise ValueError(f"ROC encode supports precision <= 63 and lists "
                             f"< 2^31, got {max_precision}, {n_max}")
        cap = rd.stack_capacity(n_max, max(max_precision, 1))
        n_slices = rd.n_slices_for(max_precision)
        pool = rd.default_pool(n_max, device)
        if device.type == "cpu":
            states, order = rd.roc_encode_batch(
                sorted_ids, lengths, precision, pool,
                rd.fresh_states(B, cap, device), n_slices)
        else:
            states, order = _launch(sorted_ids.contiguous(), lengths.contiguous(),
                                    precision.contiguous(), pool, cap, n_slices)
        if bool(states.err.any()):
            raise RuntimeError("ROC encode: stack overflow or MT19937 pool "
                               "exhausted")
        return states, order


def _launch(sorted_ids, lengths, precision, pool, cap: int, n_slices: int):
    lib = load_library()
    B, n_max = sorted_ids.shape
    device = sorted_ids.device
    i32 = dict(dtype=torch.int32, device=device)
    head = torch.empty(B, dtype=torch.int64, device=device)
    stack = torch.zeros((B, cap), **i32)
    stack_len = torch.empty(B, **i32)
    mt_ctr = torch.empty(B, **i32)
    err = torch.empty(B, **i32)
    order = torch.empty((B, n_max), **i32)
    stride = lane_stride(B)
    tree = torch.empty((n_max + 1, stride), **i32)
    with torch.cuda.device(device):
        code = lib.roc_encode_launch(
            sorted_ids.data_ptr(), lengths.data_ptr(), precision.data_ptr(), B,
            stride, n_max, pool.data_ptr(), pool.numel(), n_slices, tree.data_ptr(),
            head.data_ptr(), stack.data_ptr(), cap, stack_len.data_ptr(),
            mt_ctr.data_ptr(), order.data_ptr(), err.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "ROC encode")
    RocEncoder.launches += 1
    states = rd.RocStates(head=head, stack=stack, stack_len=stack_len,
                          mt_ctr=mt_ctr, err=err != 0)
    return states, order

"""ROC decode: the CUDA kernel ``csrc/roc_decode.cu`` and its plain version.

Replaces the JAX package's ``ops/roc_pallas.py`` (plain mode S = 1).
``RocDecoder`` holds a table of encoded lanes on one device; ``decode()``
decodes every lane and ``decode_lanes(idx)`` the lanes named by an index
tensor, in one launch either way. Output is always in encode sampling order.
On CUDA tensors it launches the kernel; on CPU tensors it runs the plain
version, ``codecs/roc_device.roc_decode_batch``. There is no other route: a
tensor on any other device raises, and a CUDA launch that fails raises.
"""

from __future__ import annotations

import torch

from ..codecs import roc_device as rd
from ._build import check_launch, lane_stride, load_library


class RocDecoder:
    """Prepared ROC decoder over a lane table; ``launches`` counts CUDA kernel
    launches of all decoders."""

    launches = 0

    @staticmethod
    def supports(max_precision: int, n_max: int) -> bool:
        """Envelope: ids of up to 63 bits, lists shorter than 2^31."""
        return 0 <= max_precision <= 63 and 0 <= n_max < (1 << 31)

    def __init__(self, states: rd.RocStates, lengths: torch.Tensor,
                 precision: torch.Tensor, pool: torch.Tensor, n_max: int):
        """``states`` as ``RocEncoder.encode`` returns them; lengths and
        precision i32[L]; pool the i32 MT19937 pool bits; n_max >= every
        length. Everything on one device."""
        self.device = states.head.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"ROC decode runs on cpu or cuda tensors, not {self.device}")
        L = states.head.shape[0]
        expect = {"head": (states.head, torch.int64, (L,)),
                  "stack_len": (states.stack_len, torch.int32, (L,)),
                  "mt_ctr": (states.mt_ctr, torch.int32, (L,)),
                  "lengths": (lengths, torch.int32, (L,)),
                  "precision": (precision, torch.int32, (L,))}
        for name, (t, dtype, shape) in expect.items():
            if t.dtype != dtype or tuple(t.shape) != shape or t.device != self.device:
                raise ValueError(f"{name} must be {dtype}{list(shape)} on "
                                 f"{self.device}, got {t.dtype}"
                                 f"{list(t.shape)} on {t.device}")
        if (states.stack.dtype != torch.int32 or states.stack.dim() != 2
                or states.stack.shape[0] != L or pool.dtype != torch.int32):
            raise ValueError("stack must be int32[L, cap] and pool int32[P]")
        max_precision = int(precision.max()) if L else 0
        if L and int(lengths.max()) > n_max:
            raise ValueError("n_max is below the longest lane")
        if not self.supports(max_precision, n_max):
            raise ValueError(f"ROC decode supports precision <= 63 and lists "
                             f"< 2^31, got {max_precision}, {n_max}")
        self.states = rd.RocStates(*(t.contiguous() for t in states))
        self.lengths = lengths.contiguous()
        self.precision = precision.contiguous()
        self.pool = pool.to(self.device).contiguous()
        self.n_max = n_max
        self.n_slices = rd.n_slices_for(max_precision)

    def decode(self) -> torch.Tensor:
        """Every lane → ids i64[L, n_max], zero-padded past each length."""
        L = self.states.head.shape[0]
        return self.decode_lanes(torch.arange(L, device=self.device))

    def decode_lanes(self, idx: torch.Tensor) -> torch.Tensor:
        """Lanes ``idx`` (an integer tensor) → ids i64[len(idx), n_max]."""
        idx = idx.to(device=self.device, dtype=torch.int64).contiguous()
        L = self.states.head.shape[0]
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= L):
            raise IndexError(f"lane indices must lie in [0, {L})")
        if self.device.type == "cpu":
            sub = rd.RocStates(*(t[idx] for t in self.states))
            ids, final = rd.roc_decode_batch(
                sub, self.lengths[idx], self.precision[idx], self.pool,
                self.n_max, self.n_slices)
            err = final.err
        else:
            ids, err = self._launch(idx)
        if bool(err.any()):
            raise RuntimeError("ROC decode: stack overflow or MT19937 pool "
                               "exhausted")
        return ids

    def _launch(self, idx: torch.Tensor):
        lib = load_library()
        Q = idx.numel()
        cap = self.states.stack.shape[1]
        device = self.device
        ids = torch.empty((Q, self.n_max), dtype=torch.int64, device=device)
        err = torch.empty(Q, dtype=torch.int32, device=device)
        # decode pops and spills: it runs on a scratch copy of each stack
        stride = lane_stride(Q)
        scratch = torch.empty((cap, stride), dtype=torch.int32, device=device)
        syms = torch.empty((self.n_max, stride), dtype=torch.int64, device=device)
        st = self.states
        with torch.cuda.device(device):
            code = lib.roc_decode_launch(
                st.head.data_ptr(), st.stack.data_ptr(), cap,
                st.stack_len.data_ptr(), st.mt_ctr.data_ptr(),
                self.lengths.data_ptr(), self.precision.data_ptr(),
                idx.data_ptr(), Q, stride, self.pool.data_ptr(), self.pool.numel(),
                self.n_slices, self.n_max, scratch.data_ptr(), syms.data_ptr(),
                ids.data_ptr(), err.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        check_launch(lib, code, "ROC decode")
        RocDecoder.launches += 1
        return ids, err

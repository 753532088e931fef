"""Two probes of the ROC decode step: CUDA kernels and their plain versions.

Replaces the JAX package's profiling probes ``tools/profiling/
profile_pallas.py`` (K3, a dependent gather) and ``profile_pallas2.py`` (K4,
one decode step's shape). They lie on no search path; they time pieces of the
decode kernel's step on the card (``chip_smoke.py``): K3 the dependent-load
latency of its refill, K4 the serial chain plus the O(i) rank pass, to set
beside the decode kernel's own time per step.

``ProbeGather.run`` and ``ProbeDecodeStep.run`` launch the kernels
``csrc/probe_gather.cu`` and ``csrc/probe_decode_step.cu`` on CUDA tensors and
run the plain versions, ``probe_gather_plain`` and ``probe_decode_step_plain``,
on CPU tensors; a tensor on any other device raises, and a CUDA launch that
fails raises. Each class counts its CUDA launches in ``launches``.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

STEPS = 1100  # the probes' step count
_MASK32 = 0xFFFFFFFF


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values → the i32 that two's-complement wrapping gives."""
    return (((x & _MASK32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def probe_gather_plain(win: torch.Tensor, idx: torch.Tensor, steps: int = STEPS):
    """K3 in torch: ``steps`` times idx = (idx + (win[b, idx] & 1)) % W.
    win i32[B, W], idx i32[B, 1] → i32[B, 1]."""
    W = win.shape[1]
    rows = torch.arange(win.shape[0], device=win.device)
    cur = idx[:, 0].to(torch.int64)
    for _ in range(steps):
        cur = (cur + (win[rows, cur] & 1).to(torch.int64)) % W
    return cur.to(torch.int32)[:, None]


def probe_decode_step_plain(buf: torch.Tensor, p: torch.Tensor, steps: int = STEPS):
    """K4 in torch (the step is written out in ``csrc/probe_decode_step.cu``).
    buf i32[capp, B], p i32[1, B] → emit i32[steps, B]; buf is not written
    (the steps work on a copy)."""
    capp, B = buf.shape
    dev = buf.device
    work = buf.to(torch.int64).clone()
    syms = torch.zeros((steps, B), dtype=torch.int64, device=dev)
    emit = torch.empty((steps, B), dtype=torch.int32, device=dev)
    lanes = torch.arange(B, device=dev)
    p = p[0].to(torch.int64)
    pmask = (1 << p) - 1
    ptr = torch.full((B,), capp // 2, dtype=torch.int64, device=dev)
    x = _wrap32(p * 7).to(torch.int64)  # the current value, as a signed i32
    for i in range(steps):
        src_ok = (ptr >= 1) & (ptr <= capp)
        w = torch.where(src_ok, work[(ptr - 1).clamp(0, capp - 1), lanes], 0)
        dst_ok = (ptr >= 0) & (ptr < capp)
        dst = ptr.clamp(0, capp - 1)
        work[dst, lanes] = torch.where(dst_ok, x, work[dst, lanes])
        rank = (syms[:i] < x[None, :]).sum(dim=0)
        syms[i] = x
        q = (1 << 30) // (i + 1)
        srl = (x & _MASK32) >> p
        emit[i] = _wrap32(w + rank + q + pmask + srl)
        ptr = ptr + (w & 1) - (rank & 1)
        x = _wrap32(x + w + rank).to(torch.int64)
    return emit


def _check(name: str, t: torch.Tensor, dim: int, device=None) -> torch.device:
    if t.dtype != torch.int32 or t.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D int32 tensor, got "
                         f"{t.dtype}{list(t.shape)}")
    if t.device.type not in ("cpu", "cuda") or (device is not None and t.device != device):
        raise ValueError(f"the probes run on one cpu or cuda device, got {name} "
                         f"on {t.device}")
    return t.device


class ProbeGather:
    """K3 (``csrc/probe_gather.cu``); ``launches`` counts CUDA launches."""

    launches = 0

    @staticmethod
    def run(win: torch.Tensor, idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
        """win i32[B, W] (u32 bit patterns), idx i32[B, 1] in [0, W) →
        i32[B, 1]."""
        device = _check("win", win, 2)
        _check("idx", idx, 2, device)
        B, W = win.shape
        if idx.shape != (B, 1):
            raise ValueError(f"idx must be int32[{B}, 1]")
        if B and (int(idx.min()) < 0 or int(idx.max()) >= W):
            raise ValueError(f"idx must lie in [0, {W})")
        if device.type == "cpu":
            return probe_gather_plain(win, idx, steps)
        lib = load_library()
        win, idx = win.contiguous(), idx.contiguous()
        out = torch.empty((B, 1), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            code = lib.probe_gather_launch(
                win.data_ptr(), idx.data_ptr(), B, W, steps, out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        check_launch(lib, code, "gather probe")
        ProbeGather.launches += 1
        return out


class ProbeDecodeStep:
    """K4 (``csrc/probe_decode_step.cu``); ``launches`` counts CUDA
    launches."""

    launches = 0

    @staticmethod
    def run(buf: torch.Tensor, p: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
        """buf i32[capp, B], p i32[1, B] with shifts in [0, 32) → emit
        i32[steps, B]. buf is not written."""
        device = _check("buf", buf, 2)
        _check("p", p, 2, device)
        capp, B = buf.shape
        if p.shape != (1, B):
            raise ValueError(f"p must be int32[1, {B}]")
        if B and (int(p.min()) < 0 or int(p.max()) >= 32):
            raise ValueError("p must lie in [0, 32)")
        if device.type == "cpu":
            return probe_decode_step_plain(buf, p, steps)
        lib = load_library()
        buf, p = buf.contiguous(), p.contiguous()
        i32 = dict(dtype=torch.int32, device=device)
        emit = torch.empty((steps, B), **i32)
        scratch = torch.empty((capp, B), **i32)
        syms = torch.empty((steps, B), **i32)
        with torch.cuda.device(device):
            code = lib.probe_decode_step_launch(
                buf.data_ptr(), p.data_ptr(), capp, B, steps, scratch.data_ptr(),
                syms.data_ptr(), emit.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        check_launch(lib, code, "decode-step probe")
        ProbeDecodeStep.launches += 1
        return emit

"""Probes of the ROC kernels' steps: CUDA kernels and their plain versions.

Replaces the JAX package's profiling probes ``tools/profiling/
profile_pallas.py`` (K3, a dependent gather) and ``profile_pallas2.py`` (K4,
one decode step's shape). They lie on no search path; they time pieces of the
decode kernel's step on the card (``chip_smoke.py``): K3 the dependent-load
latency of its refill, K4 the serial chain plus the O(i) rank pass, to set
beside the decode kernel's own time per step.

``ProbeChain`` replaces no TPU kernel: it runs the ROC codec's own serial
chain with no rank or select work (``csrc/probe_chain.cu``), one lane on one
thread, to measure the floor of a step of both ROC kernels.

``ProbeGather.run``, ``ProbeDecodeStep.run``, ``ProbeChain.decode`` and
``ProbeChain.encode`` launch the kernels ``csrc/probe_gather.cu``,
``csrc/probe_decode_step.cu`` and ``csrc/probe_chain.cu`` on CUDA tensors and
run the plain versions (``probe_gather_plain``, ``probe_decode_step_plain``,
``chain_decode_plain``, ``chain_encode_plain``) on CPU tensors; a tensor on
any other device raises, and a CUDA launch that fails raises. Each class
counts its CUDA launches in ``launches``. K3 and K4 keep their rows' and
lanes' state in shared memory: a shape whose state does not fit one block
raises on either device (``gather_fits``, ``decode_step_fits``).

``step_latency_cycles`` reads, with the card's clock, the cycles of the links
that bound a step of K4 (``chip_smoke.py`` ``probe_latency_bounds``).
"""

from __future__ import annotations

import torch

from ..codecs import roc_device as rd
from ._build import SHARED_BYTES_PER_BLOCK, check_launch, load_library

STEPS = 1100  # the probes' step count
_MASK32 = 0xFFFFFFFF
GATHER_ROWS = 32  # K3's rows a block (csrc/probe_lane.cuh kGatherRows)


def gather_fits(W: int) -> bool:
    """Whether K3's block of GATHER_ROWS windows of W words fits its shared
    memory."""
    return 4 * GATHER_ROWS * W <= SHARED_BYTES_PER_BLOCK


def decode_step_fits(capp: int, steps: int) -> bool:
    """Whether one K4 lane (its buf copy, symbols and emits:
    csrc/probe_lane.cuh decode_step_lane_bytes) fits a block's shared
    memory."""
    return 4 * (capp + 2 * steps) <= SHARED_BYTES_PER_BLOCK


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
    """K4 in torch (the step is written out in ``csrc/probe_lane.cuh``
    ``decode_steps``).
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
        i32[B, 1]. W at most what ``gather_fits``."""
        device = _check("win", win, 2)
        _check("idx", idx, 2, device)
        B, W = win.shape
        if idx.shape != (B, 1):
            raise ValueError(f"idx must be int32[{B}, 1]")
        if not gather_fits(W):
            raise ValueError(f"a window of {W} words does not fit the gather probe's shared "
                             f"memory ({SHARED_BYTES_PER_BLOCK} bytes a block of "
                             f"{GATHER_ROWS} rows: W <= "
                             f"{SHARED_BYTES_PER_BLOCK // (4 * GATHER_ROWS)})")
        if B and (int(idx.min()) < 0 or int(idx.max()) >= W):
            raise ValueError(f"idx must lie in [0, {W})")
        if device.type == "cpu":
            return probe_gather_plain(win, idx, steps)
        return ProbeGather.launch(win.contiguous(), idx.contiguous(), steps)

    @staticmethod
    def launch(win: torch.Tensor, idx: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
        """The kernel's launch alone, on inputs that ``run`` has checked
        (contiguous, on one card); for timing the kernel without the
        checks' synchronisations."""
        lib = load_library()
        B, W = win.shape
        out = torch.empty((B, 1), dtype=torch.int32, device=win.device)
        with torch.cuda.device(win.device):
            code = lib.probe_gather_launch(
                win.data_ptr(), idx.data_ptr(), B, W, steps, out.data_ptr(),
                torch.cuda.current_stream(win.device).cuda_stream)
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
        i32[steps, B]. buf is not written. capp and steps at most what
        ``decode_step_fits``."""
        device = _check("buf", buf, 2)
        _check("p", p, 2, device)
        capp, B = buf.shape
        if p.shape != (1, B):
            raise ValueError(f"p must be int32[1, {B}]")
        if not decode_step_fits(capp, steps):
            raise ValueError(f"a lane of {capp} buffer words and {steps} steps does not fit "
                             f"the decode-step probe's shared memory: 4 (capp + 2 steps) "
                             f"<= {SHARED_BYTES_PER_BLOCK} bytes")
        if B and (int(p.min()) < 0 or int(p.max()) >= 32):
            raise ValueError("p must lie in [0, 32)")
        if device.type == "cpu":
            return probe_decode_step_plain(buf, p, steps)
        return ProbeDecodeStep.launch(buf.contiguous(), p.contiguous(), steps)

    @staticmethod
    def launch(buf: torch.Tensor, p: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
        """The kernel's launch alone, on inputs that ``run`` has checked."""
        lib = load_library()
        capp, B = buf.shape
        emit = torch.empty((steps, B), dtype=torch.int32, device=buf.device)
        with torch.cuda.device(buf.device):
            code = lib.probe_decode_step_launch(
                buf.data_ptr(), p.data_ptr(), capp, B, steps, SHARED_BYTES_PER_BLOCK,
                emit.data_ptr(), torch.cuda.current_stream(buf.device).cuda_stream)
        check_launch(lib, code, "decode-step probe")
        ProbeDecodeStep.launches += 1
        return emit


def step_latency_cycles(device="cuda", iters: int = 4096) -> dict:
    """SM cycles of one link of dependent chains on one warp of the card
    (``csrc/probe_decode_step.cu`` ``probe_step_latency_kernel``, read with
    clock64()): two ways a rank can feed K4's next value, ``rank_reduce``
    (a compare, ``__reduce_add_sync`` of the counts, an add) and
    ``rank_ballot`` (a compare, ``__ballot_sync`` and its population count,
    an add); ``shared_load``, one dependent shared-memory load; and
    ``sm_mhz``, the SM clock that the first chain ran at (its cycles over its
    time on the global timer). A reading of the card's clock: there is no
    plain version, and a CPU device raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the step latencies are read on a card, not on {device}")
    lib = load_library()
    seed = torch.arange(33, dtype=torch.int32, device=device) * 7919 - 100_000
    cycles = torch.zeros(4, dtype=torch.int64, device=device)
    sink = torch.empty(32, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        code = lib.probe_step_latency_launch(
            iters, seed.data_ptr(), cycles.data_ptr(), sink.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "step-latency probe")
    reduce, load, ns, ballot = cycles.tolist()
    return {"rank_reduce": reduce / iters, "rank_ballot": ballot / iters,
            "shared_load": load / iters, "sm_mhz": reduce / ns * 1e3}


def decode_ranks(ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The rank that the ROC decode computes at each step: ids i64[B, n_max]
    in encode sampling order (as the decode returns them), lengths i32[B] →
    i32[B, n_max], step i's count of the earlier steps' smaller symbols (the
    decode runs the sampling order backwards), zero past each length. Holds
    B x n_max^2 booleans."""
    B, n_max = ids.shape
    j = torch.arange(n_max, device=ids.device)
    lengths = lengths.to(torch.int64)[:, None]
    steps = ids.gather(1, (lengths - 1 - j).clamp(0, max(n_max - 1, 0)))
    earlier = torch.ones((n_max, n_max), dtype=torch.bool, device=ids.device).tril(-1)
    ranks = ((steps[:, None, :] < steps[:, :, None]) & earlier).sum(dim=2)
    return torch.where(j < lengths, ranks, 0).to(torch.int32)


def chain_decode_plain(states: rd.RocStates, lengths, precision, ranks, pool, n_slices: int):
    """The decode chain in torch, each step's rank given: RocStates of B
    lanes, lengths and precision i32[B], ranks i32[B, n_max] → (symbols
    i64[B, n_max] in decode order, zero past each length; err bool[B])."""
    B, n_max = ranks.shape
    st = rd._Lanes(states, pool)
    lengths, precision = lengths.to(torch.int64), precision.to(torch.int64)
    syms = torch.zeros((B, n_max), dtype=torch.int64, device=ranks.device)
    for i in range(int(lengths.max()) if B else 0):
        active = i < lengths
        syms[:, i] = rd._pop_symbol(st, precision, active, n_slices)
        rd._push_mod(st, ranks[:, i].to(torch.int64), i + 1, active)
    return syms, st.err


def chain_encode_plain(ids, lengths, precision, pool, cap: int, n_slices: int) -> rd.RocStates:
    """The encode chain in torch, each step's id given: ids i64[B, n_max] in
    sampling order, lengths and precision i32[B] → the RocStates of fresh
    lanes that pushed them."""
    B, n_max = ids.shape
    st = rd._Lanes(rd.fresh_states(B, cap, ids.device), pool)
    lengths, precision = lengths.to(torch.int64), precision.to(torch.int64)
    for i in range(int(lengths.max()) if B else 0):
        active = i < lengths
        rd._pop_mod(st, lengths - i, active)
        rd._push_symbol(st, ids[:, i], precision, active, n_slices)
    return st.states()


def _check_lanes(ids: torch.Tensor, lengths: torch.Tensor, precision: torch.Tensor):
    """ids [B, n_max] and i32[B] lengths and precision on one cpu or cuda
    device → (device, the largest precision)."""
    device = _check("lengths", lengths, 1)
    _check("precision", precision, 1, device)
    if ids.dim() != 2 or ids.shape[0] != lengths.shape[0] or ids.device != device:
        raise ValueError(f"expected [{lengths.shape[0]}, n_max] on {device}, got "
                         f"{list(ids.shape)} on {ids.device}")
    if lengths.numel() and int(lengths.max()) > ids.shape[1]:
        raise ValueError("a lane is longer than n_max")
    return device, int(precision.max()) if lengths.numel() else 0


class ProbeChain:
    """The ROC chain with no rank or select work (``csrc/probe_chain.cu``),
    one lane per block, run on one thread; ``launches`` counts CUDA
    launches."""

    launches = 0

    @staticmethod
    def decode(states: rd.RocStates, lengths: torch.Tensor, precision: torch.Tensor,
               ranks: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
        """RocStates of B per-list lanes (as ``RocEncoder.encode`` returns
        them), lengths and precision i32[B], ranks i32[B, n_max] (each step's
        rank, ``decode_ranks``), pool the i32 MT19937 bits of the encode →
        symbols i64[B, n_max] in decode order, zero past each length."""
        device, maxp = _check_lanes(ranks, lengths, precision)
        _check("ranks", ranks, 2, device)
        B, n_max = ranks.shape
        n_slices = rd.n_slices_for(maxp)
        if device.type == "cpu":
            syms, err = chain_decode_plain(states, lengths, precision, ranks, pool, n_slices)
        else:
            lib = load_library()
            st = rd.RocStates(*(t.contiguous() for t in states))
            lengths, precision = lengths.contiguous(), precision.contiguous()
            ranks, pool = ranks.contiguous(), pool.to(device).contiguous()
            syms = torch.empty((B, n_max), dtype=torch.int64, device=device)
            err = torch.empty(B, dtype=torch.int32, device=device)
            with torch.cuda.device(device):
                code = lib.probe_chain_decode_launch(
                    st.head.data_ptr(), st.stack.data_ptr(), st.stack.shape[1],
                    st.stack_len.data_ptr(), st.mt_ctr.data_ptr(), lengths.data_ptr(),
                    precision.data_ptr(), ranks.data_ptr(), B, n_max, pool.data_ptr(),
                    pool.numel(), n_slices, syms.data_ptr(), err.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
            check_launch(lib, code, "chain probe (decode)")
            ProbeChain.launches += 1
        if bool(err.any()):
            raise RuntimeError("chain probe: stack overflow or MT19937 pool exhausted")
        return syms

    @staticmethod
    def encode(ids: torch.Tensor, lengths: torch.Tensor,
               precision: torch.Tensor) -> rd.RocStates:
        """ids i64[B, n_max]: each lane's ids in sampling order (the sorted
        ids that ``RocEncoder.encode``'s order picks, step by step), lengths
        and precision i32[B] → RocStates, as ``RocEncoder.encode`` returns
        them."""
        device, maxp = _check_lanes(ids, lengths, precision)
        if ids.dtype != torch.int64:
            raise ValueError("ids must be int64")
        B, n_max = ids.shape
        cap, n_slices = rd.stack_capacity(n_max, max(maxp, 1)), rd.n_slices_for(maxp)
        pool = rd.default_pool(n_max, device)
        if device.type == "cpu":
            states = chain_encode_plain(ids, lengths, precision, pool, cap, n_slices)
        else:
            lib = load_library()
            ids, lengths, precision = ids.contiguous(), lengths.contiguous(), precision.contiguous()
            i32 = dict(dtype=torch.int32, device=device)
            head = torch.empty(B, dtype=torch.int64, device=device)
            stack = torch.zeros((B, cap), **i32)
            stack_len, mt_ctr, err = (torch.empty(B, **i32) for _ in range(3))
            with torch.cuda.device(device):
                code = lib.probe_chain_encode_launch(
                    ids.data_ptr(), lengths.data_ptr(), precision.data_ptr(), B, n_max,
                    pool.data_ptr(), pool.numel(), n_slices, head.data_ptr(),
                    stack.data_ptr(), cap, stack_len.data_ptr(), mt_ctr.data_ptr(),
                    err.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
            check_launch(lib, code, "chain probe (encode)")
            ProbeChain.launches += 1
            states = rd.RocStates(head=head, stack=stack, stack_len=stack_len, mt_ctr=mt_ctr,
                                  err=err != 0)
        if bool(states.err.any()):
            raise RuntimeError("chain probe: stack overflow or MT19937 pool exhausted")
        return states

"""Profiling and tracing helpers.

Port of the JAX package's ``utils/profiling.py``:

  - :func:`device_trace`: a context manager around ``torch.profiler`` that
    writes a Chrome trace of the enclosed block (the card's kernels and
    copies as well as the host's ops where a card is present) into
    ``logdir`` (open it in chrome://tracing or Perfetto);
  - :func:`throughput`: wall-clock throughput of a computation, each run
    synchronised with the card when its result lies there (torch returns
    before the card has finished).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def device_trace(logdir):
    """Profile the enclosed block; yields the profiler and writes its Chrome
    trace to ``logdir/trace.json`` (``logdir`` is created)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def _sync(out) -> None:
    """Wait for the card where ``out`` (a tensor, or a tuple or list of
    them) lies on it."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for t in outs:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def throughput(fn: Callable[[], object], items: int, repeats: int = 3,
               warmup: int = 1) -> Tuple[float, float]:
    """(items per second, seconds) for the best of ``repeats`` runs of
    ``fn``, after ``warmup`` runs; each run ends when its result is ready."""
    for _ in range(warmup):
        _sync(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn())
        best = min(best, time.perf_counter() - t0)
    return items / best, best

"""Host-clock timing for the drivers: the port's calls return before the
card has finished, so every timed call ends in a synchronisation with the
device (the JAX drivers' calls returned numpy arrays and were synchronous)."""

from __future__ import annotations

import sys
import time

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device) -> None:
    """Wait for ``device`` when it is a card (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seconds(fn, device):
    """(seconds of ``fn()`` to the end of its device work, its result)."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out

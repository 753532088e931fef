"""Reduction of a torch.profiler Chrome trace to the device's busy time,
the device operations by name, and the idle gaps by what the host was doing.

The arithmetic of the port's ``bench/table4.py`` ``search_profile`` (idle
share = 1 - device time / wall), with the device time taken as the union
of the device operations' intervals, so that overlapping operations count
once.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# trace categories of work on the device, and of the host's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")
# how many of the host's events before a gap are searched for one around it
HOST_LOOKBACK = 256
TOP = 10


@dataclass
class Trace:
    busy_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)  # (name, s), top TOP
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)   # (host op, s), top TOP
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name -> (count, s)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path, mark: str) -> Trace:
    """The ``Trace`` of the Chrome trace at ``path`` inside the span named
    ``mark`` (times in the trace in microseconds): the device operations
    that start in it, and the gaps between them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, marks = [], [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur, name = float(e["ts"]), float(e["dur"]), str(e.get("name", ""))
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur, name))
        elif cat in HOST_CATEGORIES:
            host.append((ts, ts + dur, name))
        elif cat == "user_annotation" and name == mark:
            marks.append((ts, ts + dur))
    lo = min((s for s, _ in marks), default=float("-inf"))
    hi = max((e for _, e in marks), default=float("inf"))
    for s, e, name in device:
        if lo <= s < hi:
            kernels[name][0] += 1
            kernels[name][1] += (e - s) * 1e-6
    busy = _merged([(s, min(e, hi)) for s, e, _ in device if lo <= s < hi])
    out = Trace(busy_s=sum(e - s for s, e in busy) * 1e-6,
                kernels={k: (c, s) for k, (c, s) in kernels.items()})
    out.device_ops = sorted(((k, s) for k, (c, s) in kernels.items()),
                            key=lambda kv: -kv[1])[:TOP]
    # gaps between the device's busy intervals inside the span
    if not marks:
        lo, hi = (busy[0][0], busy[-1][1]) if busy else (0.0, 0.0)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    by_name = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        j = bisect.bisect_right(starts, mid) - 1
        name = "host, no op"
        for i in range(j, max(-1, j - HOST_LOOKBACK), -1):
            if host[i][1] >= mid:  # the latest-starting op around mid: the innermost
                name = host[i][2]
                break
        by_name[name] += (e - s) * 1e-6
    out.idle_gaps = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return out

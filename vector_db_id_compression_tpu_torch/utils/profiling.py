"""Profiling and tracing helpers.

  - :func:`device_trace`: a context manager around ``torch.profiler`` that
    writes a Chrome trace of the enclosed block (the card's kernels and
    copies as well as the host's ops where a card is present) into
    ``logdir`` (open it in chrome://tracing or Perfetto);
  - :class:`span` and :func:`count`: the program's own spans and counters,
    recorded only while a ``torch.profiler`` session records (the flag
    ``torch.autograd.profiler._is_profiler_enabled``, which the profiler's
    ``start`` sets and ``stop`` clears). Off, a span tests that flag and
    nothing more. On, a span is a ``record_function`` range in the Chrome
    trace, beside the kernels on the profiler's clock, and a record in
    memory: its name, its parent span, the sequence number of the search it
    belongs to, the host clock at entry and exit, and on a CUDA device a
    pair of CUDA events on the current stream. A count is added to the
    innermost open span. So a block run under :func:`device_trace` (or any
    ``torch.profiler`` session) gets the spans in its trace and in
    :func:`summary`;
  - :func:`summary`, :func:`records`, :func:`reset`: the newest records,
    reduced per span name over the newest searches, read, or cleared.

The search path's spans (``search/ivf.py``, ``ops/roc_decode.py``):

  ivf.search        IndexIVF.search_defer_id_decoding (a root: it starts a
                    search's sequence number)
    ivf.positional  IndexIVF.search_positional; its self time is the probe
                    bookkeeping and the merge
      ivf.coarse    IndexIVF.coarse_assign (the HNSW quantizer's walk too)
      ivf.scan      compute_luts (LUT path) and the scan of every bucket
    ivf.translate   IndexIVF._translate; its self time is the masks,
                    ``unique``, the gather and the scatter
      roc.decode    RocDecoder.decode_lanes: K1's launch and its error check

and the counters ``host_syncs``, added at each place on that path where the
host waits for the device, and ``scan_grouped_slots``, in ``ivf.scan``: the
(query, probe) slots that the grouped scan kernel (K5) took in a search, 0
where the search took the per-bucket torch scan.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# the newest span records kept (a search of the IVF path opens six)
RECORDS = 16384


@contextlib.contextmanager
def device_trace(logdir):
    """Profile the enclosed block; yields the profiler and writes its Chrome
    trace to ``logdir/trace.json`` (``logdir`` is created). The program's
    spans are in the trace and in :func:`summary`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class SpanRecord:
    """One span as recorded: ``parent`` is the enclosing span's record
    (None for a root), ``seq`` the sequence number of its root, host clock
    ``t0_ns``/``t1_ns`` (``perf_counter_ns``), ``events`` the CUDA events
    at entry and exit (None off the card), ``counts`` the counts made while
    it was the innermost open span."""

    __slots__ = ("name", "parent", "seq", "t0_ns", "t1_ns", "events", "counts", "_range")

    def __init__(self, name: str, parent: Optional["SpanRecord"], seq: int):
        self.name = name
        self.parent = parent
        self.seq = seq
        self.t0_ns = self.t1_ns = 0
        self.events = None
        self.counts: Dict[str, int] = {}
        self._range = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


class _Recorder:
    """The records of this process: a bounded buffer of the newest, the
    open spans of each thread, the last sequence number given."""

    def __init__(self, size: int):
        self.records: deque = deque(maxlen=size)
        self.local = threading.local()
        self.seqs = itertools.count(1)

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def open(self, name: str, device: Optional[torch.device]) -> SpanRecord:
        stack = self.stack()
        parent = stack[-1] if stack else None
        rec = SpanRecord(name, parent, parent.seq if parent is not None else next(self.seqs))
        rec._range = record_function(name)
        rec._range.__enter__()
        rec.t0_ns = time.perf_counter_ns()
        if device is not None and device.type == "cuda":
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(device))
        stack.append(rec)
        self.records.append(rec)
        return rec

    def close(self, rec: SpanRecord, device: Optional[torch.device]) -> None:
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(device))
        rec.t1_ns = time.perf_counter_ns()
        self.stack().pop()
        rec._range.__exit__(None, None, None)
        rec._range = None


_RECORDER = _Recorder(RECORDS)


class span:
    """``with span(name, device):`` times the block as the span ``name``
    while a profiler records (module docstring); ``device`` the one its work
    runs on, whose current stream takes the CUDA events."""

    __slots__ = ("name", "device", "rec")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.device = device
        self.rec = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rec = _RECORDER.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            _RECORDER.close(self.rec, self.device)
            self.rec = None
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span, while a
    profiler records; a count outside every span is not kept."""
    if _autograd_profiler._is_profiler_enabled:
        stack = _RECORDER.stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def records() -> List[SpanRecord]:
    """The records kept, oldest first (closed or still open)."""
    return list(_RECORDER.records)


def reset() -> None:
    """Drop every record kept."""
    _RECORDER.records.clear()


@dataclass
class SpanStats:
    """Totals of one span name: how many, their stream time between the CUDA
    events (None off the card), their host time, and the same less the part
    their child spans cover (self time); ``counts`` made inside them."""

    count: int = 0
    stream_ms: Optional[float] = None
    host_ms: float = 0.0
    self_stream_ms: Optional[float] = None
    self_host_ms: float = 0.0
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def ms(self) -> float:
        """Stream time on the card, the host clock off it."""
        return self.host_ms if self.stream_ms is None else self.stream_ms

    @property
    def self_ms(self) -> float:
        return self.self_host_ms if self.self_stream_ms is None else self.self_stream_ms


@dataclass
class Summary:
    """:func:`summary`'s result: ``searches`` sequence numbers read, their
    spans by name, and every count over them by name."""

    searches: int = 0
    spans: Dict[str, SpanStats] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)


def summary(searches: Optional[int] = None) -> Summary:
    """The closed records of the newest ``searches`` sequence numbers (all
    kept, if None), per span name. Waits once for the card where a record
    has CUDA events; each event's time is read against the first one, so
    that a child's time never exceeds its parent's."""
    recs = [r for r in _RECORDER.records if r.t1_ns]
    seqs = sorted({r.seq for r in recs})
    if searches is not None:
        seqs = seqs[-searches:] if searches > 0 else []
    keep = set(seqs)
    recs = [r for r in recs if r.seq in keep]
    timed = [r for r in recs if r.events is not None]
    stamp = {}
    if timed:
        torch.cuda.synchronize()
        first = timed[0].events[0]
        for r in timed:
            stamp[r] = (first.elapsed_time(r.events[0]), first.elapsed_time(r.events[1]))
    child_host: Dict[SpanRecord, float] = {}
    child_stream: Dict[SpanRecord, float] = {}
    for r in recs:
        if r.parent is not None:
            child_host[r.parent] = child_host.get(r.parent, 0.0) + r.host_ms
            if r in stamp:
                child_stream[r.parent] = (child_stream.get(r.parent, 0.0)
                                          + stamp[r][1] - stamp[r][0])
    out = Summary(searches=len(seqs))
    for r in recs:
        st = out.spans.setdefault(r.name, SpanStats())
        st.count += 1
        st.host_ms += r.host_ms
        st.self_host_ms += r.host_ms - child_host.get(r, 0.0)
        if r in stamp:
            ms = stamp[r][1] - stamp[r][0]
            st.stream_ms = (st.stream_ms or 0.0) + ms
            st.self_stream_ms = (st.self_stream_ms or 0.0) + ms - child_stream.get(r, 0.0)
        for name, n in r.counts.items():
            st.counts[name] = st.counts.get(name, 0) + n
            out.counts[name] = out.counts.get(name, 0) + n
    return out

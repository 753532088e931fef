"""One run of one cell: set-up, a timed window, the check, the result line.

Everything that belongs to one configuration, one kind of index
(``kinds/``), one traffic mix or one metric is found by name (see
``__main__.py``); this file holds what all cells share.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, List, Optional

import torch

from . import check
from .kinds import NAMES as KIND_NAMES
from .roofline import peaks_of
from .trace import reduce_trace

ROOT = Path(__file__).resolve().parent.parent
# the set-up clock where /proc gives no process start
_T0 = time.perf_counter()
# top-level module names that no run may have loaded when it prints its result
BANNED_MODULES = ("jax", "jaxlib", "flax", "vector_db_id_compression_tpu")


# ------------------------------------------------------------------ the cell

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path
    kind: ModuleType


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    file, the kind of index that it names (``idbench/kinds/<kind>.py``), its
    traffic file ``idbench/traffic/<traffic>.json``, and the metrics it
    reports: end-to-end ones whose ``workloads`` name it (or that have
    none), per-layer ones whose ``workloads`` name it (or, without the key,
    whose ``moves`` it reports)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    if "kind" not in config:
        raise SystemExit(f"{cfg_entry['file']} has no key 'kind' (the kind of index: a file "
                         f"idbench/kinds/<kind>.py)")
    path = root / "idbench" / "kinds" / f"{config['kind']}.py"
    if not path.exists():
        raise SystemExit(f"{cfg_entry['file']} names the kind {config['kind']!r}, and there "
                         f"is no {path.relative_to(root)}")
    kind = _load(path, f"idbench_kind_{config['kind']}")
    missing = [n for n in KIND_NAMES if not hasattr(kind, n)]
    if missing:
        raise SystemExit(f"the kind {config['kind']!r} defines no {', '.join(missing)}")
    traffic = json.loads((root / "idbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer, root, kind)


def reader_path(root: Path, kind: str, name: str) -> Path:
    """``root/idbench/<kind>/<name>.py``, or where there is none and the
    name has a suffix (``positional_ms.batch``), the reader of the name
    without it (``positional_ms.py``): one reader serves every traffic mix."""
    path = root / "idbench" / kind / f"{name}.py"
    if not path.exists() and "." in name:
        path = root / "idbench" / kind / f"{name.rsplit('.', 1)[0]}.py"
    return path


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, kind: str, name: str) -> Callable:
    """``read`` of the reader at ``reader_path``."""
    return _load(reader_path(root, kind, name), f"idbench_{kind}_{name}").read


# --------------------------------------------------------------------- clocks

def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux: /proc, 10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------- window

@dataclass
class Window:
    calls: int = 0
    queries: int = 0
    seconds: float = 0.0
    latencies: List[float] = field(default_factory=list)  # s, one per call
    sample: List[tuple] = field(default_factory=list)     # (pool start, the call's output)


def warm_up(kind: ModuleType, index, cfg: dict, traffic: dict, queries: torch.Tensor,
            device) -> None:
    """``warmup_calls`` calls of the traffic's own shapes, from the pool's
    start, before the window."""
    nq = traffic["queries_per_call"]
    for c in range(traffic["warmup_calls"]):
        s = (c * nq) % queries.shape[0]
        kind.call(index, cfg, traffic, queries[s:s + nq])
    sync(device)


def run_window(kind: ModuleType, index, cfg: dict, traffic: dict, queries: torch.Tensor,
               seconds: float, seed: int, device: torch.device, spans=None,
               profiler=None) -> Window:
    """Closed loop, one client: the kind's ``call`` on the pool's next
    ``queries_per_call`` queries (cycling), wait for the device, repeat
    until ``seconds`` have passed. Keeps a reservoir of ``check_calls``
    calls' outputs, drawn from the seed, for the check."""
    nq = traffic["queries_per_call"]
    pool = queries.shape[0]
    rng = random.Random(seed)
    keep = traffic["check_calls"]
    w = Window()
    t_start = time.perf_counter()
    while True:
        s = (w.calls * nq) % pool
        if spans is not None and profiler is not None:
            spans.recording = profiler.recording(w.calls)
        t0 = time.perf_counter()
        out = kind.call(index, cfg, traffic, queries[s:s + nq])
        sync(device)
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        w.calls += 1
        w.queries += nq
        if len(w.sample) < keep:
            w.sample.append((s, out))
        else:
            j = rng.randrange(w.calls)
            if j < keep:
                w.sample[j] = (s, out)
        if profiler is not None:
            profiler.step(w.calls)
        if t1 - t_start >= seconds:
            break
    w.seconds = t1 - t_start
    lat = torch.tensor(w.latencies, dtype=torch.float64) * 1e3
    q = torch.quantile(lat, torch.tensor([0.5, 0.9, 0.95, 0.99, 1.0], dtype=torch.float64)).tolist()
    parts = [part for part in lat.tensor_split(4) if part.numel()]
    quarters = [float(torch.quantile(part, 0.95)) for part in parts]
    rates = [1e3 * nq * part.numel() / float(part.sum()) for part in parts]
    print(f"window: {w.calls} calls, {w.queries} queries in {w.seconds:.3f} s; latency ms "
          f"p50 {q[0]:.4f} p90 {q[1]:.4f} p95 {q[2]:.4f} p99 {q[3]:.4f} max {q[4]:.4f}; "
          f"p95 by quarter {' '.join(f'{x:.4f}' for x in quarters)}; queries/s by quarter "
          f"{' '.join(f'{x:.1f}' for x in rates)}", file=sys.stderr)
    return w


class Profiler:
    """torch.profiler (the host's and the device's activity) started by hand
    before call ``trace_warmup_calls`` of the window, and the next
    ``trace_calls`` calls marked by a ``record_function`` span that the
    reduction keeps to; then stopped, its Chrome trace written to a
    temporary directory and reduced there. (A profiler schedule stepped each
    call slowed a 13.7 ms call to 24.1 ms on the card; started by hand, to
    14.8.)"""

    MARK = "idbench.traced"

    def __init__(self, traffic: dict, device: torch.device):
        self.first = traffic["trace_warmup_calls"]
        self.active = traffic["trace_calls"]
        self.cuda = device.type == "cuda"
        self.tmp = tempfile.TemporaryDirectory()
        self.path = Path(self.tmp.name) / "trace.json"
        self.prof = self.mark = None
        self.t_first = self.window_s = None

    def recording(self, call: int) -> bool:
        """Whether call ``call`` is one of the marked calls."""
        return self.first <= call < self.first + self.active

    def step(self, calls_done: int) -> None:
        """After ``calls_done`` calls: start, mark, or stop."""
        from torch.profiler import ProfilerActivity, profile, record_function

        if calls_done == 0 and self.prof is None:
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
        if calls_done == self.first:
            self.mark = record_function(self.MARK)
            self.mark.__enter__()
            self.t_first = time.perf_counter()
        if calls_done == self.first + self.active and self.mark is not None:
            self.window_s = time.perf_counter() - self.t_first
            self.mark.__exit__(None, None, None)
            self.prof.stop()
            self.prof.export_chrome_trace(str(self.path))
            self.mark = None

    def finish(self):
        """(the marked calls' reduced trace or None, their host seconds)."""
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
            self.prof.stop()
        try:
            if self.window_s is None or not self.path.exists():
                return None, None
            return reduce_trace(self.path, self.MARK), self.window_s
        finally:
            self.tmp.cleanup()


# ------------------------------------------------------------------------ run

def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def banned_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED_MODULES))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        fault: Optional[Callable] = None) -> dict:
    """One run; returns the result object (``correct`` ... ``check``).
    ``fault``, for the tests: called with the built index before the window,
    to break the timed path underneath."""
    cfg, traffic, kind = cell.config, cell.traffic, cell.kind
    inputs = kind.make_inputs(cfg, seed, traffic["pool"], device)
    queries = inputs.queries
    index = kind.build(cfg, inputs, device)
    del inputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if fault is not None:
        fault(index)
    warm_up(kind, index, cfg, traffic, queries, device)
    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - _T0
    spans = kind.Spans(index, device) if trace else None
    profiler = Profiler(traffic, device) if trace else None
    if profiler is not None:
        profiler.step(0)
    w = run_window(kind, index, cfg, traffic, queries, seconds, seed, device, spans, profiler)
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu",
                     "count": 1,
                     "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                           if device.type == "cuda" else 0)}
    run_ns = SimpleNamespace(queries=w.queries, seconds=w.seconds, latencies=w.latencies,
                             setup_s=setup_s)
    metrics = {}
    breakdown = None
    if trace:
        tr, window_s = profiler.finish()
        ctx = SimpleNamespace(
            trace=tr, window_s=window_s, traced_calls=profiler.active,
            untraced_ms=[1e3 * t for t in w.latencies[profiler.first + profiler.active:]],
            peaks=peaks_of(result_device["kind"]), **spans.context())
        for m in cell.per_layer:
            v = reader(cell.root, "metrics", m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None and window_s:
            result_device["busy_s"] = tr.busy_s
            result_device["window_s"] = window_s
            breakdown = {"device_ops": [[n, s] for n, s in tr.device_ops],
                         "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
        del ctx
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": reader(cell.root, "end_to_end", m["name"])(run_ns),
                                  "unit": m["unit"]}
    sample = w.sample
    del index, spans, w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = kind.Reference(cfg, seed, traffic["pool"], device).judge(traffic, sample)
    out = {"correct": check.passed(verdict), "attempted": run_ns.queries,
           "failed": verdict["failed"], "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if device.type == "cuda":
        out["card"] = power_limit()
    out["check"] = {n: {"value": verdict[n][0], "limit": verdict[n][1]}
                    for n in check.numbers(verdict)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m idbench", description="one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    return emit(out)


def emit(out: dict) -> int:
    """The result line last on standard output and the compared numbers last
    on standard error; or, where a banned module is loaded by now, after the
    window, the per-layer readers and the reference, no result and the exit
    code 1."""
    found = banned_loaded()
    if found:
        print(f"loaded before the result: {', '.join(found)}; no result", file=sys.stderr)
        return 1
    print(f"correct {out['correct']}: {out['failed']} sampled queries break a limit; "
          f"card {out.get('card')}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0

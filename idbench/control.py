"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python3 -m idbench.control --config <config> --seeds 1 2 ... \
        --control-seeds 1 2 3 --seconds 1.5

For each seed, on the card: the configuration's inputs and the port's
index, as a run builds them, through the configuration's kind
(``kinds/<kind>.py``); for every traffic mix of a cell of this
configuration in ``BENCHMARK.json``, a short window at the cell's own load
through the harness's window, and its sampled results judged by the
kind's reference (the program's reading: the lower end of each limit).
For the control seeds, the kind's control (for IVF the reference in TF32:
operands of every dot product rounded to TF32, as a tensor core with TF32
enabled takes them) put in the program's place, on the same sampled
queries, and judged the same way (the upper end). One JSON line per seed
and mix; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from . import check
from .harness import ROOT, load_cell, run_window, warm_up


def readings(cfg: dict, cells: list, seed: int, seconds: float, control: bool,
             device: torch.device) -> list:
    """[{cell, seed, program: {number: reading}, control: {...} or None}]."""
    kind = cells[0].kind
    pool = max(c.traffic["pool"] for c in cells)
    t0 = time.perf_counter()
    inputs = kind.make_inputs(cfg, seed, pool, device)
    queries = inputs.queries
    index = kind.build(cfg, inputs, device)
    del inputs
    t_build = time.perf_counter() - t0
    samples = {}
    for c in cells:
        warm_up(kind, index, cfg, c.traffic, queries, device)
        w = run_window(kind, index, cfg, c.traffic, queries, seconds, seed, device)
        samples[c.name] = w.sample
    del index
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = kind.Reference(cfg, seed, pool, device)
    t_ref = ref.seconds["reference"]
    out = []
    for c in cells:
        sample = samples[c.name]
        t2 = time.perf_counter()
        prog = ref.judge(c.traffic, sample)
        row = {"cell": c.name, "seed": seed,
               "queries": len(sample) * c.traffic["queries_per_call"],
               "program": {n: prog[n][0] for n in check.numbers(prog)}, "control": None,
               "build_s": t_build, "reference_s": t_ref + time.perf_counter() - t2}
        if control:
            cv = ref.control(c.traffic, sample)
            row["control"] = {n: cv[n][0] for n in check.numbers(cv)}
            row["control_correct"] = check.passed(cv)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m idbench.control", description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [load_cell(w["name"]) for w in bench["workloads"] if w["config"] == args.config]
    cfg = cells[0].config
    rows = []
    for seed in args.seeds:
        for row in readings(cfg, cells, seed, args.seconds, seed in args.control_seeds, device):
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    for c in cells:
        mine = [r for r in rows if r["cell"] == c.name]
        for n in mine[0]["program"] if mine else ():
            lower = max(r["program"][n] for r in mine)
            ctl = [r["control"][n] for r in mine if r["control"] is not None]
            print(f"{c.name} {n}: lower (program, {len(mine)} seeds) {lower!r}; upper "
                  f"(control, {len(ctl)} seeds) {min(ctl) if ctl else None!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The paper's Table 4 run on the card: its gates and its profile.

The run itself is ``search_ivf_qinco`` (P5): one ``--todo train add``, then
one ``--todo search`` per ``--id_compression`` mode over the same index
(``chip_bench.sh table4``, the counterpart of the JAX package's
``tools/run_table4.sh``). This module reads what those runs wrote and
measures what their JSON does not hold:

  - ``check FILE...``: the runs' ``search_results.json`` files, one per
    mode, of one index. Fails (exit 1) unless every run's recalls are the
    same in every mode (the id codecs are lossless), ``none`` holds 64
    bits/id, ``packed-bits`` exactly ``packed_width(ntotal)`` (24 at 10^7
    ids) and every other codec fewer. Prints one row per mode: bits/id,
    ``comp_time``, ``t_search`` and ``t_rerank`` (mean, min), recalls.
  - ``profile --workdir W``: ``add`` again from the saved index's
    training, each stage timed on its own (assignment, QINCo encode, the
    host norms, the per-list build, the scan storage), and whether the lists
    it builds equal the saved ones; then, for ``roc`` and
    ``wavelet-tree-1``, one search at the operating point of the workdir's
    last search (its ``search_results.json``) and its re-rank under
    ``torch.profiler``: wall and device ms, the idle share (1 - device /
    wall), the kernels with the most device time, and each part of the
    search timed alone, and for ``roc`` the calls of its two kernels (the
    encode of every list, the decode of the touched lists). One JSON object
    to stdout (and ``--out``).

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.table4 check W/*.json
    python -m vector_db_id_compression_tpu_torch.bench.table4 profile --workdir W
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..codecs.packed_bits import packed_width
from ..device import DEFAULT_DEVICE, resolve
from ._timing import log, seconds

PROFILED_MODES = ("roc", "wavelet-tree-1")


def failures(outs: dict) -> list:
    """What breaks the gates in ``outs`` (mode → a ``search_results.json``
    of one index): each a line of text; none when all hold."""
    bad = []
    ntotal = {o["ntotal"] for o in outs.values()}
    if len(ntotal) != 1:
        return [f"the runs hold different indexes: ntotal {sorted(ntotal)}"]
    width = packed_width(ntotal.pop())
    ref_mode, ref = next(iter(outs.items()))
    want = [(r["parameters"], r["recalls"]) for r in ref["results"]]
    for mode, o in outs.items():
        got = [(r["parameters"], r["recalls"]) for r in o["results"]]
        if got != want:
            bad.append(f"{mode}: recalls or runs differ from {ref_mode}'s")
        bits = o["bits_per_id"]
        if mode == "none" and bits != 64.0:
            bad.append(f"none: {bits} bits/id, not 64")
        elif mode == "packed-bits" and bits != width:
            bad.append(f"packed-bits: {bits} bits/id, not {width}")
        elif mode not in ("none", "packed-bits") and not bits < width:
            bad.append(f"{mode}: {bits} bits/id, not below {width}")
    return bad


def summary(outs: dict) -> list:
    """One line per mode and operating point: bits/id, comp_time, t_search
    and t_rerank mean and min over the runs (s), recalls."""
    lines = []
    for mode, o in outs.items():
        for s in o["sweep"]:
            if s.get("skipped"):
                continue
            p = s["parameters"]
            lines.append(
                f"{mode:15s} nprobe {p['nprobe']:4d} nshort {p['nshort']:4d}: bits/id "
                f"{o['bits_per_id']!r}, comp_time {o['comp_time']!r} s, t_search "
                f"{s['t_search']!r} (min {s['t_search_min']!r}), t_rerank {s['t_rerank']!r} "
                f"(min {s['t_rerank_min']!r}), runs {s['runs']}, recalls {s['recalls']}")
    return lines


def check(paths) -> int:
    outs = {}
    for p in paths:
        o = json.loads(Path(p).read_text())
        outs[o["args"]["id_compression"]] = o
    for line in summary(outs):
        print(line)
    bad = failures(outs)
    for line in bad:
        print(f"FAIL {line}")
    print(f"table4 check: {len(outs)} modes, " + ("FAILED" if bad else "all gates hold"))
    return 1 if bad else 0


def _stage(spans: dict, name: str, fn, device):
    """``fn`` wrapped so that each call adds its seconds (to the end of its
    device work) to ``spans[name]``."""
    def run(*a, **kw):
        t, out = seconds(lambda: fn(*a, **kw), device)
        spans[name] = spans.get(name, 0.0) + t
        return out
    return run


def add_stages(path: Path, xb: np.ndarray, device) -> dict:
    """``add`` of ``xb`` into the index saved at ``path``, its lists
    dropped first, each stage timed alone: the assignment, the QINCo encode,
    the host norms, the scan storage (``replace_invlists``), and the rest
    (the transfers and the per-list build); and whether the lists equal the
    saved ones (the encode is the same on a second run)."""
    from ..search import ivf

    index = ivf.load_index(path, device=device)
    saved = index.invlists
    index.invlists, index.active, index.ntotal, index._scan = None, None, 0, []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    spans = {}
    assign = ivf.assign
    ivf.assign = _stage(spans, "assign", assign, device)
    q = index.qinco
    q.encode = _stage(spans, "encode", q.encode, device)
    q.lin_norms = _stage(spans, "lin_norms", q.lin_norms, device)
    index.replace_invlists = _stage(spans, "scan_storage", index.replace_invlists, device)
    try:
        total, _ = seconds(lambda: index.add(xb), device)
    finally:
        ivf.assign = assign
    il = index.invlists
    same = bool(np.array_equal(il.lengths, saved.lengths) and all(
        np.array_equal(a, b) and np.array_equal(c, e)
        for a, b, c, e in zip(il.ids, saved.ids, il.codes, saved.codes)))
    out = {"total_s": total, **{f"{k}_s": v for k, v in spans.items()},
           "rest_s": total - sum(spans.values()), "lists_equal_saved": same,
           "ntotal": index.ntotal}
    if cuda:
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def _median_ms(fn, device, reps: int = 5) -> float:
    """Median ms of ``reps`` calls of ``fn`` after a warm-up, each to the end
    of its device work."""
    seconds(fn, device)
    return float(np.median([seconds(fn, device)[0] for _ in range(reps)])) * 1e3


def search_profile(index, container, mode: str, xq, nprobe: int, nshort: int, k: int,
                   device) -> dict:
    """One search of the operating point with ``container`` swapped in,
    its re-rank, under ``torch.profiler`` (CUDA activity on a card), and its
    parts timed alone (host clock to the end of the device work, medians of
    5 after a warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .search_ivf_qinco import rerank

    index.replace_invlists(container)
    one_by_one = mode != "roc"  # the driver's policy (reference :417)

    def search():
        return index.search_defer_id_decoding(xq, nshort, nprobe=nprobe,
                                              decode_1by1=one_by_one, return_codes=2)

    def both():
        _, I, codes = search()
        return rerank(index, xq, I, codes, k)

    seconds(both, device)
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        wall = seconds(both, device)[0] * 1e3
    times = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    device_ms = sum(times.values())
    launches = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    _, L = index.search_positional(xq, nshort, nprobe)
    _, I, codes = search()
    touched = torch.unique(L[L >= 0] >> 32)
    kernels = {}
    if mode == "roc":
        # the two ROC kernels' calls at this index's shapes: the encode of
        # every list (the container's build) and the decode of the lists
        # one search's translate touches
        from ..ops.roc_encode import RocEncoder
        from ..store.invlists import roc_lane_table

        sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
        lanes = [torch.from_numpy(a).to(device)
                 for a in (sorted_ids.view(np.int64), lengths, prec)]
        kernels = {"roc_encode_all_lists_ms": _median_ms(lambda: RocEncoder.encode(*lanes),
                                                         device),
                   "roc_decode_touched_ms": _median_ms(
                       lambda: container.decoder.decode_lanes(touched), device)}
    return {
        "mode": mode, "wall_ms": wall, "device_ms": device_ms,
        "idle_share": 1 - device_ms / wall if cuda else None,
        "device_ops": launches,
        "top_kernels_ms": dict(sorted(times.items(), key=lambda kv: -kv[1])[:5]),
        "search_ms": _median_ms(search, device),
        "positional_ms": _median_ms(lambda: index.search_positional(xq, nshort, nprobe),
                                    device),
        "harvest_ms": _median_ms(lambda: index._harvest_codes(L, True), device),
        "translate_ms": _median_ms(lambda: index._translate(L, one_by_one), device),
        "rerank_ms": _median_ms(lambda: rerank(index, xq, I, codes, k), device),
        "touched_lists": int(touched.numel()), **kernels,
    }


def profile_run(workdir, device) -> dict:
    """``add_stages`` and ``search_profile`` of the run in ``workdir``: its
    saved index, and the data set and operating point of its last search
    (``search_results.json``)."""
    from ..search.ivf import load_index
    from ..store.invlists import AVAILABLE_COMPRESSED_IVFS
    from .datasets import get_dataset

    dev = resolve(device)
    path = Path(workdir) / "qinco_index.npz"
    run = json.loads((Path(workdir) / "search_results.json").read_text())["args"]
    nprobe, nshort = run["nprobe"][0], run["nshort"][0]
    ds = get_dataset(run["dataset"], run["fb_ssnpp_dir"], synth_scale=run["synth_scale"],
                     device=dev)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "add": add_stages(path, ds.get_database(), dev)}
    log(f"[table4] add: {out['add']}")
    index = load_index(path, device=dev)
    xq = torch.as_tensor(ds.get_queries(), dtype=torch.float32, device=dev)
    for mode in PROFILED_MODES:
        c = AVAILABLE_COMPRESSED_IVFS[mode](index.invlists, device=dev)
        out[mode] = search_profile(index, c, mode, xq, nprobe, nshort, run["k"], dev)
        log(f"[table4] {mode}: {out[mode]}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="gate the runs' search_results.json files")
    c.add_argument("files", nargs="+")
    f = sub.add_parser("profile", help="add's stages, and the search under torch.profiler")
    f.add_argument("--workdir", required=True)
    f.add_argument("--out", default=None)
    f.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.cmd == "check":
        return check(args.files)
    out = profile_run(args.workdir, args.device)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

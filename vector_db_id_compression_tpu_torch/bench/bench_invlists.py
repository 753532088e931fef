"""IVF online benchmark — reference P1 parity
(``custom_invlist_cpp/bench_invlists.py:1-147``); port of the JAX package's
``bench/bench_invlists.py``.

For a dataset and an ``IVF{nlist},{Flat|PQ{M}}`` factory string: build the
index, compress the ID lists with every codec, then time ``k=20`` searches at
``nprobe ∈ {1, 4, 16}`` for each method and record search time, compressed ID
size, and codec overhead to CSV (one row per (method, nprobe), the JAX
package's columns in its order). Each timed search ends in a synchronisation
with the device.

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.bench_invlists \
        --dataset synthetic --index IVF256,Flat --runs 10 --out res.csv

It runs on the card unless given ``--device cpu``. It also accepts the
reference's positional form ``<dataset_idx> <index_str> [fb_ssnpp_dir]``.
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
from typing import Dict, List

import numpy as np

from ..device import DEFAULT_DEVICE, resolve
from ..search.ivf import IndexIVF
from ..store.invlists import AVAILABLE_COMPRESSED_IVFS
from ._timing import seconds

METHODS = ["ref", "packed-bits", "elias-fano", "roc", "wavelet-tree",
           "wavelet-tree-1"]


def parse_index_str(s: str):
    m = re.fullmatch(r"IVF(\d+),(Flat|PQ(\d+))", s)
    if not m:
        raise ValueError(f"unsupported index string {s!r} "
                         "(expected IVF<nlist>,Flat or IVF<nlist>,PQ<M>)")
    nlist = int(m.group(1))
    if m.group(2) == "Flat":
        return nlist, "flat", 0
    return nlist, "pq", int(m.group(3))


def build_index(ds, index_str: str, niter: int = 20, device=DEFAULT_DEVICE) -> IndexIVF:
    nlist, storage, pq_m = parse_index_str(index_str)
    index = IndexIVF(ds.d, nlist, storage=storage, pq_m=pq_m, device=device)
    index.train(ds.get_train(), niter=niter)
    index.add(ds.get_database())
    return index


def _fused_times(sh, xq, k: int, nprobe: int, pipeline: int = 8):
    """(one_shot_s, sustained_s) of the sharded search
    (``parallel.search.ShardedIVF`` on a mesh of one without a group):
    one-shot is the best of 3 calls, each to its synchronisation; sustained
    is the marginal time of ``pipeline`` back-to-back ``search`` calls ended
    by one synchronisation, less one call, over ``pipeline - 1``. The JAX
    package pipelines its compiled program instead (``sh._compiled``, which
    the port does not have); the port's search syncs with the host inside
    (list selection), so the queue hides less."""
    dev = sh.device
    xq_d = np.asarray(xq, np.float32)
    seconds(lambda: sh.search(xq_d, k, nprobe), dev)  # warm-up
    one = min(seconds(lambda: sh.search(xq_d, k, nprobe), dev)[0] for _ in range(3))
    t1 = seconds(lambda: sh.search(xq_d, k, nprobe), dev)[0]
    tK = seconds(lambda: [sh.search(xq_d, k, nprobe) for _ in range(pipeline)], dev)[0]
    return one, max((tK - t1) / (pipeline - 1), 1e-9)


def run_bench(ds, index_str: str, runs: int = 100, k: int = 20,
              nprobes=(1, 4, 16), methods: List[str] = METHODS,
              out_csv: str = "bench_invlists_out.csv",
              fused: bool = False, device=DEFAULT_DEVICE) -> List[Dict]:
    dev = resolve(device)
    print(f"dataset {ds}  index {index_str}", flush=True)
    index = build_index(ds, index_str, device=dev)
    xq = ds.get_queries()
    gt = ds.get_groundtruth(k)
    source = index.invlists

    # pre-build every compressed container (reference bench_invlists.py:90-93)
    containers = {"ref": source}
    build_time = {"ref": 0.0}
    for m, fac in AVAILABLE_COMPRESSED_IVFS.items():
        if m not in methods:
            continue
        build_time[m], containers[m] = seconds(lambda: fac(source, device=dev), dev)
        print(f"  built {m} in {build_time[m]:.2f}s", flush=True)

    fused_sh = {}
    if fused and index.storage in ("flat", "qinco", "pq"):
        from ..parallel.mesh import make_lists_mesh
        from ..parallel.search import ShardedIVF

        mesh = make_lists_mesh(1, device=dev)
        for m in methods:
            index.replace_invlists(containers[m])
            fused_sh[m] = ShardedIVF(mesh, index, containers[m], device=dev)

    rows = []
    for m in methods:
        c = containers[m]
        index.replace_invlists(c)
        # decode_1by1 set per container capability — the reference hardcodes
        # the same policy per method (bench_invlists.py:103)
        decode_1by1 = getattr(c, "supports_random_access", True)
        ids_size = getattr(c, "compressed_ids_size_in_bytes",
                           index.ntotal * 8)
        overhead = getattr(c, "overhead_in_bytes", 0)

        def search():
            return index.search_defer_id_decoding(xq, k, nprobe=nprobe,
                                                  decode_1by1=decode_1by1)

        for nprobe in nprobes:
            seconds(search, dev)  # warm-up
            times = []
            I = None
            for _ in range(runs):
                t, (_, I) = seconds(search, dev)
                times.append(t)
            I = I.cpu().numpy()
            recall = float((I[:, :1] == gt[:, :1]).sum()) / len(xq)
            row = dict(
                method=m, nprobe=nprobe, k=k, nq=len(xq),
                dt_search=float(np.median(times)),
                dt_search_min=float(np.min(times)),
                ids_size=int(ids_size), overhead_size=int(overhead),
                bits_per_id=8.0 * ids_size / max(index.ntotal, 1),
                recall_1=recall, build_time=build_time[m],
                dataset=str(ds), index=index_str, runs=runs,
            )
            if m in fused_sh:
                one, sus = _fused_times(fused_sh[m], xq, k, nprobe)
                row["dt_fused"] = one
                row["dt_fused_sustained"] = sus
            rows.append(row)
            extra = (f" fused={row['dt_fused']*1e3:7.2f}ms "
                     f"sustained={row['dt_fused_sustained']*1e3:7.2f}ms"
                     if m in fused_sh else "")
            print(f"  {m:15s} nprobe={nprobe:3d} "
                  f"dt={row['dt_search']*1e3:8.2f}ms "
                  f"bits/id={row['bits_per_id']:6.2f} R@1={recall:.3f}"
                  f"{extra}", flush=True)
            # rewrite the CSV after every point so partial sweeps survive
            # (reference bench_invlists.py:141-146)
            with open(out_csv, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)
    return rows


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from .datasets import get_dataset

    # reference positional form: <dataset_idx> <index_str> [fb_ssnpp_dir]
    if argv and argv[0].isdigit():
        ds = get_dataset(int(argv[0]), argv[2] if len(argv) > 2 else None)
        return run_bench(ds, argv[1])

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "sift1m", "deep1m", "fb_ssnpp"])
    p.add_argument("--index", default="IVF256,Flat")
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--nprobe", type=int, nargs="+", default=[1, 4, 16])
    p.add_argument("--methods", nargs="+", default=METHODS)
    p.add_argument("--fb_ssnpp_dir", default=None)
    p.add_argument("--synth_scale", type=float, default=1.0)
    p.add_argument("--out", default="bench_invlists_out.csv")
    p.add_argument("--fused", action="store_true",
                   help="also time the sharded search (parallel.search) on a "
                        "mesh of one, with back-to-back sustained timing")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the index lives and searches (default: the card)")
    a = p.parse_args(argv)

    dev = resolve(a.device)
    ds = get_dataset(a.dataset, a.fb_ssnpp_dir, synth_scale=a.synth_scale, device=dev)
    return run_bench(ds, a.index, runs=a.runs, k=a.k, nprobes=tuple(a.nprobe),
                     methods=a.methods, out_csv=a.out, fused=a.fused, device=dev)


if __name__ == "__main__":
    main()

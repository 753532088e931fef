"""HNSW online benchmark — the graph-index twin of the P2 driver applied to
the HNSW family (reference B2's replace_final_graph surface,
altid.swig:88-92, exercised on HNSW level 0); port of the JAX package's
``bench/hnsw_bench.py``.

Build an HNSW index, then for each level-0 adjacency container
{ref, compact, elias-fano, roc, roc-block} swap it in via
``HNSW.search(graph0=...)``, time k-NN searches (the upper-layer descent and
the level-0 walk on the device, ``search/graph_device.py``), and record
search time + compressed adjacency size to CSV.

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.hnsw_bench \
        --dataset synthetic --synth_scale 0.04 --M 16 --runs 10

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from typing import List

import numpy as np

from ..device import DEFAULT_DEVICE, resolve
from ..search.hnsw import HNSW
from ..store.graph import CompactBitGraph, EliasFanoGraph, RocBlockGraph, RocGraph
from ._timing import seconds

METHOD_MAP = {
    "ref": lambda g: g,
    "compact": CompactBitGraph,
    "elias-fano": EliasFanoGraph,
    "roc": RocGraph,
    "roc-block": lambda g: RocBlockGraph(g, block=16),
}

METHODS = ["ref", "compact", "elias-fano", "roc", "roc-block"]


def run_bench(ds, M: int = 16, runs: int = 10, k: int = 10, ef: int = 48,
              methods: List[str] = METHODS,
              out_csv: str = "hnsw_bench_out.csv", device=DEFAULT_DEVICE):
    dev = resolve(device)
    xb = ds.get_database()
    xq = ds.get_queries()
    gt = ds.get_groundtruth(k)
    print(f"dataset {ds}  HNSW M={M} ef={ef}", flush=True)
    t0 = time.time()
    hnsw = HNSW(M=M, ef_construction=max(40, 2 * M), device=dev).build(xb)
    base = hnsw.level0_graph()
    num_edges = int((base.adjacency >= 0).sum())
    print(f"  built in {time.time()-t0:.1f}s, {num_edges} level-0 edges, "
          f"{hnsw.max_level + 1} levels", flush=True)

    rows = []
    for m in methods:
        build_time, g0 = seconds(lambda: METHOD_MAP[m](base), dev)
        if m == "ref":
            ids_size, overhead = base.adjacency.numel() * 4, 0
        else:
            ids_size = g0.compressed_ids_size_in_bytes
            overhead = g0.overhead_in_bytes

        def search():
            return hnsw.search(xq, k, ef=ef, graph0=g0)[1]

        seconds(search, dev)  # warm-up
        times = []
        I = None
        for _ in range(runs):
            t, I = seconds(search, dev)
            times.append(t)
        I = I.cpu().numpy()
        recall = float((I[:, :1] == gt[:, :1]).sum()) / len(xq)
        row = dict(
            method=m, M=M, ef=ef, k=k, nq=len(xq), nb=len(xb),
            dt_search=float(np.median(times)),
            dt_search_min=float(np.min(times)),
            ids_size=int(ids_size), overhead_size=int(overhead),
            bits_per_edge=8.0 * ids_size / max(num_edges, 1),
            recall_1=recall, build_time=build_time,
            dataset=str(ds), runs=runs,
        )
        rows.append(row)
        print(f"  {m:12s} dt={row['dt_search']*1e3:8.2f}ms "
              f"bits/edge={row['bits_per_edge']:6.2f} R@1={recall:.3f}",
              flush=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "sift1m", "deep1m", "fb_ssnpp"])
    p.add_argument("--M", type=int, default=16)
    p.add_argument("--ef", type=int, default=48)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--methods", nargs="+", default=METHODS)
    p.add_argument("--fb_ssnpp_dir", default=None)
    p.add_argument("--synth_scale", type=float, default=1.0)
    p.add_argument("--out", default="hnsw_bench_out.csv")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the index lives and searches (default: the card)")
    a = p.parse_args(sys.argv[1:] if argv is None else argv)

    from .datasets import get_dataset

    dev = resolve(a.device)
    ds = get_dataset(a.dataset, a.fb_ssnpp_dir, synth_scale=a.synth_scale, device=dev)
    return run_bench(ds, M=a.M, runs=a.runs, k=a.k, ef=a.ef, methods=a.methods,
                     out_csv=a.out, device=dev)


if __name__ == "__main__":
    main()

"""NSG online (dynamic) benchmark — reference P2 parity
(``alt-graph-index/graph_dynamic_bench_invlists.py:1-148``); port of the JAX
package's ``bench/graph_dynamic_bench.py``.

Build an NSG-style graph with a given max degree, then for each adjacency
container {ref, compact, elias-fano, roc, roc-block} swap it in (the
analogue of ``nsg.replace_final_graph``, ``altid.swig:88-92``), time k-NN
searches on the device (``search/graph_device.py``; ``roc`` decodes each hop's
lists with the ROC decode kernel, ``roc-block`` with its chained mode), and
record search time + compressed adjacency size to CSV.

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.graph_dynamic_bench \
        --dataset synthetic --max-degree 32 --runs 10

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from typing import List

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ..search import graph_device as gd
from ..search.graph_device import search_graph_device
from ..search.nsg import build_nsg, search_graph
from ..store.graph import CompactBitGraph, EliasFanoGraph, RocBlockGraph, RocGraph
from ._timing import seconds

METHOD_MAP = {
    "ref": lambda g: g,
    "compact": CompactBitGraph,
    "elias-fano": EliasFanoGraph,
    "roc": RocGraph,
    # framework extension: chained ANS per 16-node block amortizes the
    # 8-byte per-node head that dominates ROC's rate at NSG degrees
    "roc-block": lambda g: RocBlockGraph(g, block=16),
}

METHODS = ["ref", "compact", "elias-fano", "roc", "roc-block"]


def _sustained_device(g, xb, xq, k, medoid, pipeline: int = 8):
    """Marginal time of ``pipeline`` back-to-back device traversals
    (``graph_device._search``, the walk ``search_graph_device`` runs) ended
    by one synchronisation, less one traversal, over ``pipeline - 1``. The
    port's walk reads its stop condition on the host every hop, so the queue
    hides little here."""
    dev = g.device
    L = 2 * k
    max_iters = 4 * L + 32
    xq_d = torch.as_tensor(np.asarray(xq, np.float32), device=dev)
    entries = torch.full((len(xq_d),), int(medoid), dtype=torch.int64, device=dev)

    def walk():
        return gd._search(g, xb, xq_d, k, L, max_iters, entries)

    seconds(walk, dev)  # warm
    t1 = seconds(walk, dev)[0]
    tK = seconds(lambda: [walk() for _ in range(pipeline)], dev)[0]
    return max((tK - t1) / (pipeline - 1), 1e-9)


def run_bench(ds, max_degree: int, runs: int = 100, k: int = 10,
              methods: List[str] = METHODS,
              out_csv: str = "graph_dynamic_bench_out.csv",
              host_search: bool = False, device=DEFAULT_DEVICE):
    """``host_search`` switches to the per-hop host loop (``search_graph``);
    the default is the device traversal (identical results —
    tests/test_torch_graph.py)."""
    dev = resolve(device)
    xb = torch.as_tensor(ds.get_database(), dtype=torch.float32, device=dev)
    xq = ds.get_queries()
    gt = ds.get_groundtruth(k)
    print(f"dataset {ds}  NSG{max_degree}", flush=True)
    t0 = time.time()
    base, medoid = build_nsg(xb, R=max_degree, device=dev)
    adjacency = base.adjacency
    num_edges = int((adjacency >= 0).sum())
    print(f"  graph built in {time.time()-t0:.1f}s, {num_edges} edges",
          flush=True)

    rows = []
    for m in methods:
        build_time, g = seconds(lambda: METHOD_MAP[m](base), dev)
        if m == "ref":
            # raw int32 adjacency (what faiss stores); reference models
            # compact as log2(nb)/8*num_edges (graph_dynamic_bench:33-34)
            ids_size = adjacency.numel() * 4
            overhead = 0
        else:
            ids_size = g.compressed_ids_size_in_bytes
            overhead = g.overhead_in_bytes

        if host_search:
            search = lambda: search_graph(g, xb, xq, k, entry=medoid)[1]  # noqa: E731
        else:
            search = lambda: search_graph_device(g, xb, xq, k,  # noqa: E731
                                                 entry=medoid)[1]
        seconds(search, dev)  # warm-up
        times = []
        I = None
        for _ in range(runs):
            t, I = seconds(search, dev)
            times.append(t)
        sustained = (np.nan if host_search
                     else _sustained_device(g, xb, xq, k, medoid))
        I = I.cpu().numpy()
        recall = float((I[:, :1] == gt[:, :1]).sum()) / len(xq)
        row = dict(
            method=m, max_degree=max_degree, k=k, nq=len(xq),
            dt_search=float(np.median(times)),
            dt_search_sustained=float(sustained),
            ids_size=int(ids_size), overhead_size=int(overhead),
            bits_per_edge=8.0 * ids_size / max(num_edges, 1),
            recall_1=recall, build_time=build_time,
            dataset=str(ds), runs=runs,
        )
        rows.append(row)
        print(f"  {m:12s} dt={row['dt_search']*1e3:8.2f}ms "
              f"sustained={sustained*1e3:8.2f}ms "
              f"bits/edge={row['bits_per_edge']:6.2f} R@1={recall:.3f}",
              flush=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from .datasets import get_dataset

    if argv and argv[0].isdigit():  # reference positional form
        ds = get_dataset(int(argv[0]), argv[2] if len(argv) > 2 else None)
        return run_bench(ds, int(argv[1]))

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "sift1m", "deep1m", "fb_ssnpp"])
    p.add_argument("--max-degree", type=int, default=32)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--methods", nargs="+", default=METHODS)
    p.add_argument("--fb_ssnpp_dir", default=None)
    p.add_argument("--synth_scale", type=float, default=1.0)
    p.add_argument("--host-search", action="store_true",
                   help="use the per-hop host loop instead of the device "
                        "traversal")
    p.add_argument("--out", default="graph_dynamic_bench_out.csv")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the graph lives and searches (default: the card)")
    a = p.parse_args(argv)

    dev = resolve(a.device)
    ds = get_dataset(a.dataset, a.fb_ssnpp_dir, synth_scale=a.synth_scale, device=dev)
    return run_bench(ds, a.max_degree, runs=a.runs, k=a.k, methods=a.methods,
                     out_csv=a.out, host_search=a.host_search, device=dev)


if __name__ == "__main__":
    main()

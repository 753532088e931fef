"""Offline (static) graph compression benchmark — reference P3 parity
(``graph_static_bench_invlists.py:1-126``); port of the JAX package's
``bench/graph_static_bench.py``.

Builds NSG and HNSW graphs over a dataset (on the device), converts the
friend lists to a directed edge list, and reports bits-per-edge for:

  - ``rec``: the analytic Pólya-urn Random-Edge-Coding rate (codecs/rec.py —
    self-contained equivalent of the external ``rec`` package the reference
    imports),
  - plus (framework extension) the online containers' achieved rates
    (compact / elias-fano / roc) on the same adjacency, so online and offline
    numbers land in one CSV.

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.graph_static_bench \
        --dataset synthetic --max-degree 32

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

import torch

from ..codecs.rec import Graph as EdgeGraph
from ..codecs.rec import PolyasUrnModel, friend_to_edgelist_repr
from ..device import DEFAULT_DEVICE, resolve
from ..search.hnsw import HNSW
from ..search.nsg import build_nsg
from ..store.graph import CompactBitGraph, EliasFanoGraph, Graph, RocGraph


def build_graphs(ds, max_degree: int, device=DEFAULT_DEVICE):
    """(name, adjacency i32[N, K] -1-padded, on ``device``) for NSG and HNSW
    level 0."""
    dev = resolve(device)
    xb = torch.as_tensor(ds.get_database(), dtype=torch.float32, device=dev)
    out = []
    t0 = time.time()
    nsg_graph, _ = build_nsg(xb, R=max_degree, device=dev)
    out.append((f"NSG{max_degree},Flat", nsg_graph.adjacency))
    print(f"  NSG built in {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    hnsw = HNSW(M=max_degree, device=dev).build(xb)
    out.append((f"HNSW{max_degree},Flat", hnsw.level0_graph().adjacency))
    print(f"  HNSW built in {time.time()-t0:.1f}s", flush=True)
    return out


def run_bench(ds, max_degree: int, out_csv: str = "graph_static_bench_out.csv",
              online_rates: bool = True, device=DEFAULT_DEVICE):
    print(f"dataset {ds}", flush=True)
    results = []
    for index_str, adjacency in build_graphs(ds, max_degree, device):
        edges = friend_to_edgelist_repr(adjacency)
        g = EdgeGraph(edge_array=edges, num_nodes=len(adjacency),
                      num_edges=len(edges))
        model = PolyasUrnModel(g.num_nodes, g.num_edges, undirected=False)
        _, bpe = model.compute_bpe(g)
        results.append(dict(index_str=index_str, comp_method="rec",
                            dataset=str(ds), nb=ds.nb, nt=ds.nt,
                            bpe=float(bpe), num_edges=g.num_edges))
        print(results[-1], flush=True)

        if online_rates:
            base = Graph(adjacency)
            for name, fac in (("compact", CompactBitGraph),
                              ("elias-fano", EliasFanoGraph),
                              ("roc", RocGraph)):
                cg = fac(base)
                bpe_c = 8.0 * (cg.compressed_ids_size_in_bytes
                               + cg.overhead_in_bytes) / max(g.num_edges, 1)
                results.append(dict(index_str=index_str, comp_method=name,
                                    dataset=str(ds), nb=ds.nb, nt=ds.nt,
                                    bpe=float(bpe_c), num_edges=g.num_edges))
                print(results[-1], flush=True)

        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
            w.writeheader()
            w.writerows(results)
    return results


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
    p.add_argument("--fb_ssnpp_dir", default=None)
    p.add_argument("--synth_scale", type=float, default=1.0)
    p.add_argument("--out", default="graph_static_bench_out.csv")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the graphs are built (default: the card)")
    a = p.parse_args(argv)
    dev = resolve(a.device)
    ds = get_dataset(a.dataset, a.fb_ssnpp_dir, synth_scale=a.synth_scale, device=dev)
    return run_bench(ds, a.max_degree, out_csv=a.out, device=dev)


if __name__ == "__main__":
    main()

"""Zuckerli-baseline prep — reference P4 parity
(``zuckerli-baseline/generate_graph_edgelists.py:1-96``); port of the JAX
package's ``bench/generate_graph_edgelists.py``.

Builds NSG and HNSW graphs and writes their directed edge lists as plain-text
``.el`` files (one ``src dst`` pair per line) for an external zuckerli
encoder, the interchange format the reference pipeline consumes
(``zuckerli-baseline/README.md:23-51``); for the same graph the files are the
JAX package's byte for byte.

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.generate_graph_edgelists \
        --dataset synthetic --max-degree 32 --outdir edgelists/

It builds on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..codecs.rec import friend_to_edgelist_repr
from ..device import DEFAULT_DEVICE, resolve
from .graph_static_bench import build_graphs


def write_edgelist(path: Path, edges):
    """``edges`` [m, 2] (a tensor or an array) as ``src dst`` lines."""
    edges = np.asarray(edges.cpu() if hasattr(edges, "cpu") else edges, dtype=np.int64)
    with open(path, "w") as f:
        f.write("".join(f"{u} {v}\n" for u, v in edges.tolist()))


def run(ds, max_degree: int, outdir: str, device=DEFAULT_DEVICE):
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    for index_str, adjacency in build_graphs(ds, max_degree, device):
        edges = friend_to_edgelist_repr(adjacency)
        name = index_str.replace(",", "_")
        path = out / f"{type(ds).__name__}_{name}.el"
        write_edgelist(path, edges)
        print(f"wrote {path} ({len(edges)} edges)", flush=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "sift1m", "deep1m", "fb_ssnpp"])
    p.add_argument("--max-degree", type=int, default=32)
    p.add_argument("--outdir", default="edgelists")
    p.add_argument("--fb_ssnpp_dir", default=None)
    p.add_argument("--synth_scale", type=float, default=1.0)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the graphs are built (default: the card)")
    a = p.parse_args(argv)
    from .datasets import get_dataset

    dev = resolve(a.device)
    ds = get_dataset(a.dataset, a.fb_ssnpp_dir, synth_scale=a.synth_scale, device=dev)
    run(ds, a.max_degree, a.outdir, device=dev)


if __name__ == "__main__":
    main()

"""100M-id IVF search point — the stepping stone to the reference's 1B
headline (reference README.md:161-197, bigann1B IVF1M_8x8); port of
the JAX package's ``bench/search_100m.py``.

Workload: a generator-assigned synthetic IVF — ``nlist`` Gaussian centers,
each database point drawn FROM its center, so the coarse assignment is
exact by construction (no 100M x nlist assignment product). Recall against
exact blocked ground truth (``datasets.knn_l2`` on the device, the database
streamed a slab at a time) is meaningful because the data is clustered.

Storage is PQ``--M`` bytes per id scanned through the LUT byte path: the
driver sets ``search.ivf.PQ_DECODE_BUDGET`` to 0 while it runs (the JAX
package's ``VDBIDC_PQ_DECODE_SCAN=0``; at 100M ids the decoded-f32 scan
would need 12.8 GB of payload, the byte path holds 1.6 GB) and checks that
the index took it. ID containers under test: none (raw 64-bit), roc,
elias-fano by default; ``METHODS``, the JAX package's recorded matrix
(results/search_100m_tpu.json), adds packed-bits, roc-interleaved and the
two wavelet trees — deferred decoding, grouped or random-access translation
per container capability. The oracle is recall PARITY across containers
(IDs are lossless) plus the redo-averaged t_search, each search
synchronised with the device. Each container's build logs the process's
peak resident memory.

    python -m vector_db_id_compression_tpu_torch.bench.search_100m \
        --ntotal 100000000 --nlist 65536 --methods none packed-bits elias-fano \
        roc roc-interleaved wavelet-tree wavelet-tree-1 \
        --out results/search_100m_h100.json

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ._timing import log, seconds

# every id container, in the order of the JAX package's recorded matrix
METHODS = ["none", "packed-bits", "elias-fano", "roc", "roc-interleaved", "wavelet-tree",
           "wavelet-tree-1"]


def _centers_and_assignment(ntotal, nlist, d, seed):
    """(the generator, centroids f32[nlist, d], assignment i32[ntotal]): the
    corpus's first draws."""
    rng = np.random.default_rng(seed)
    cent = (rng.standard_normal((nlist, d)) * 4.0).astype(np.float32)
    assignment = rng.integers(0, nlist, size=ntotal).astype(np.int32)
    return rng, cent, assignment


def build_clustered(ntotal, nlist, d, nq, seed):
    """Generator-assigned clustered corpus, chunked to bound peak memory.
    Returns (centroids f32[nlist, d], assignment i32[ntotal], xb f32[ntotal,
    d], xq f32[nq, d]); the JAX package's arrays."""
    rng, cent, assignment = _centers_and_assignment(ntotal, nlist, d, seed)
    xb = np.empty((ntotal, d), np.float32)
    C = 4_000_000
    for s in range(0, ntotal, C):
        e = min(s + C, ntotal)
        xb[s:e] = cent[assignment[s:e]] + rng.standard_normal(
            (e - s, d)).astype(np.float32)
    qi = rng.integers(0, ntotal, size=nq)
    xq = xb[qi] + 0.05 * rng.standard_normal((nq, d)).astype(np.float32)
    return cent, assignment, xb, xq


def fill_lists(assignment, nlist, codes=None, code_size=0):
    """The inverted lists of ``assignment``, filled one list at a time from
    the sorted assignment as the JAX package does (the port's InvertedLists
    appends per list); each vector's ``codes`` row beside its id, or no
    payload."""
    from ..store.invlists import InvertedLists

    il = InvertedLists(nlist, code_size)
    order = np.argsort(assignment, kind="stable")
    bounds = np.searchsorted(assignment[order], np.arange(nlist + 1))
    for ln in range(nlist):
        members = order[bounds[ln]: bounds[ln + 1]]
        il.add_entries(ln, members.astype(np.uint64),
                       codes[members].reshape(-1) if codes is not None
                       else np.empty(0, np.uint8))
    return il


def clustered_lists(ntotal, nlist, d=32, seed=7):
    """The id lists of ``main``'s index (its defaults' d and seed), without
    drawing the vectors."""
    return fill_lists(_centers_and_assignment(ntotal, nlist, d, seed)[2], nlist)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ntotal", type=int, default=100_000_000)
    p.add_argument("--nlist", type=int, default=65536)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--M", type=int, default=16)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--nprobe", type=int, nargs="+", default=[16, 64])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--methods", nargs="+",
                   default=["none", "roc", "elias-fano"])
    p.add_argument("--out", default="results/search_100m_h100.json")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the index lives and searches (default: the card)")
    args = p.parse_args(argv)

    from ..search import ivf
    from ..store.invlists import AVAILABLE_COMPRESSED_IVFS
    from .datasets import knn_l2

    dev = resolve(args.device)
    log(f"device: {dev}")
    t0 = time.time()
    cent, assignment, xb, xq = build_clustered(
        args.ntotal, args.nlist, args.d, args.nq, args.seed)
    log(f"corpus built in {time.time()-t0:.0f}s "
        f"({xb.nbytes/2**30:.1f} GiB)")

    t0 = time.time()
    gt = knn_l2(xq, xb, 1, device=dev)
    log(f"exact GT in {time.time()-t0:.0f}s")

    # ---- index: centroids + generator assignment, PQ codes --------------
    index = ivf.IndexIVF(args.d, args.nlist, storage="pq", pq_m=args.M, device=dev)
    index.centroids = torch.from_numpy(cent).to(dev)
    t, _ = seconds(lambda: index.pq.train(
        xb[:: max(args.ntotal // 1_000_000, 1)][:1_000_000]), dev)
    log(f"pq trained in {t:.0f}s")
    t0 = time.time()
    codes = np.empty((args.ntotal, index.pq.code_size), np.uint8)
    C = 4_000_000
    for s in range(0, args.ntotal, C):
        e = min(s + C, args.ntotal)
        codes[s:e] = index.pq.encode(xb[s:e]).cpu().numpy()
    log(f"pq encoded in {time.time()-t0:.0f}s")

    t0 = time.time()
    il = fill_lists(assignment, args.nlist, codes, index.code_size)
    index.invlists = il
    index.ntotal = args.ntotal
    log(f"invlists built in {time.time()-t0:.0f}s")
    del codes, xb

    rows = []
    budget = ivf.PQ_DECODE_BUDGET
    ivf.PQ_DECODE_BUDGET = 0  # the LUT byte scan
    try:
        for m in args.methods:
            if m == "none":
                container, ids_size = il, args.ntotal * 8
            else:
                t, container = seconds(lambda: AVAILABLE_COMPRESSED_IVFS[m](il, device=dev),
                                       dev)
                peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
                log(f"{m}: compressed in {t:.0f}s, "
                    f"{container.compressed_ids_size_in_bytes} bytes; peak RSS {peak:.1f} GiB")
                ids_size = container.compressed_ids_size_in_bytes
            t, _ = seconds(lambda: index.replace_invlists(container), dev)
            if index._scan_is_float:
                raise AssertionError(f"{m}: the index took the decoded scan, not the LUT scan")
            log(f"{m}: scan storage (LUT byte scan) in {t:.0f}s")
            decode_1by1 = getattr(container, "supports_random_access", True)
            for nprobe in args.nprobe:
                def search():
                    return index.search_defer_id_decoding(
                        xq, args.k, nprobe=nprobe, decode_1by1=decode_1by1)[1]

                seconds(search, dev)  # warm-up
                ts, I = [], None
                for _ in range(args.runs):
                    t, I = seconds(search, dev)
                    ts.append(t)
                I = I.cpu().numpy()
                r1 = float((I[:, :1] == gt[:, :1]).sum()) / len(xq)
                row = dict(method=m, nprobe=nprobe, k=args.k, nq=args.nq,
                           ntotal=args.ntotal, nlist=args.nlist,
                           t_search=float(np.mean(ts)),
                           t_search_min=float(np.min(ts)), runs=args.runs,
                           ids_size=int(ids_size),
                           bits_per_id=8.0 * ids_size / args.ntotal,
                           recall_1=r1)
                rows.append(row)
                log(f"{m:12s} nprobe={nprobe:3d} "
                    f"t={row['t_search']*1e3:8.1f}ms "
                    f"min={row['t_search_min']*1e3:8.1f}ms "
                    f"bits/id={row['bits_per_id']:6.2f} R@1={r1:.3f}")
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1)
    finally:
        ivf.PQ_DECODE_BUDGET = budget
    print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

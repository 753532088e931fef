"""Coarse-quantizer study at large nlist: the flat matrix product vs the
HNSW graph; port of the JAX package's ``bench/quantizer_bench.py``.

The reference's 1B operating point quantizes 1M centroids through an HNSW
(--quantizer_efSearch 64, reference README.md:174-176) because CPU
brute force over 1M centroids is prohibitive. This bench measures the same
trade on the device for ``--nlist`` centroids: per-1000-query coarse time for

  - flat: one [nq, d] x [d, nlist] product + top-nprobe,
  - hnsw: the graph quantizer (IndexIVF quantizer='hnsw') at several
    efSearch values,

plus the probe-set overlap of hnsw vs the exact flat coarse (the recall
proxy: overlapping probe sets => identical downstream candidates) and the
top-1 agreement. Writes one JSON with build time, per-path timings, and
overlaps. Each timed call ends in a synchronisation with the device.
``--dump-probes PATH`` also saves the flat coarse's probes, i64[nq,
nprobe], as a ``.npy`` for a check against an exact top-nprobe
(``bench/recorded.py check --quantizer``); the JSON keeps the JAX
package's keys.

    python -m vector_db_id_compression_tpu_torch.bench.quantizer_bench \
        --nlist 262144 --out results/quantizer_262k_h100.json

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ._timing import log, seconds


def draw(nlist, d, nq, seed):
    """(centroids f32[nlist, d], queries f32[nq, d]): the bench's standard
    normal draws, the JAX package's arrays."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    return cents, rng.standard_normal((nq, d)).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nlist", type=int, default=262144)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--nprobe", type=int, default=64)
    p.add_argument("--ef", type=int, nargs="+", default=[64, 128, 256])
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--skip-hnsw", action="store_true",
                   help="flat-product point only (the 1M-centroid study)")
    p.add_argument("--out", default="results/quantizer_262k_h100.json")
    p.add_argument("--dump-probes", metavar="PATH",
                   help="save the flat coarse's probes i64[nq, nprobe] (.npy)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the quantizers live and search (default: the card)")
    args = p.parse_args(argv)

    from ..search.ivf import IndexIVF

    dev = resolve(args.device)
    log(f"device: {dev}")
    cents, xq = draw(args.nlist, args.d, args.nq, args.seed)
    cents_d = torch.from_numpy(cents).to(dev)

    flat = IndexIVF(args.d, args.nlist, device=dev)
    flat.centroids = cents_d
    t_build = None
    if not args.skip_hnsw:
        hq = IndexIVF(args.d, args.nlist, quantizer="hnsw",
                      quantizer_M=args.M, device=dev)
        hq.centroids = cents_d
        t_build, _ = seconds(hq._ensure_quantizer, dev)
        log(f"hnsw quantizer built over {args.nlist} centroids "
            f"in {t_build:.0f}s")

    def timed(fn):
        seconds(fn, dev)  # warm-up
        ts = []
        out = None
        for _ in range(args.runs):
            t, out = seconds(fn, dev)
            ts.append(t)
        return out.cpu().numpy(), float(np.mean(ts)), float(np.min(ts))

    pf, t_flat, t_flat_min = timed(
        lambda: flat.coarse_assign(xq, args.nprobe))
    log(f"flat coarse: {t_flat*1e3:.0f} ms mean / {t_flat_min*1e3:.0f} min "
        f"per {args.nq}q top-{args.nprobe}")
    if args.dump_probes:
        np.save(args.dump_probes, pf)

    rows = dict(nlist=args.nlist, d=args.d, nq=args.nq, nprobe=args.nprobe,
                hnsw_M=args.M,
                hnsw_build_s=(round(t_build, 1) if t_build else None),
                flat_ms=round(t_flat * 1e3, 1),
                flat_ms_min=round(t_flat_min * 1e3, 1), hnsw=[])
    for ef in (args.ef if not args.skip_hnsw else []):
        hq.quantizer_efSearch = ef
        ph, t_h, t_h_min = timed(lambda: hq.coarse_assign(xq, args.nprobe))
        overlap = float(np.mean([
            len(np.intersect1d(a[a >= 0], b)) / args.nprobe
            for a, b in zip(ph, pf)]))
        # top-1 agreement: the assignment the add path would use
        top1 = float(np.mean(ph[:, 0] == pf[:, 0]))
        rows["hnsw"].append(dict(
            ef=ef, ms=round(t_h * 1e3, 1), ms_min=round(t_h_min * 1e3, 1),
            probe_overlap=round(overlap, 4), top1_agree=round(top1, 4)))
        log(f"hnsw ef={ef:4d}: {t_h*1e3:.0f} ms mean, overlap "
            f"{overlap:.3f}, top1 agree {top1:.3f}")

    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()

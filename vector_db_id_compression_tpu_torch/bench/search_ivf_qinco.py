"""Large-scale QINCo IVF pipeline — reference P5 parity
(``custom_invlist_cpp/search_ivf_qinco.py:1-531``); port of the JAX
package's ``bench/search_ivf_qinco.py``.

Three phases, each resumable from ``workdir/qinco_index.npz``, which
``search.ivf.save_index`` writes in the JAX package's format byte for byte
(so a workdir written by either package resumes in the other):

  - ``train``:  k-means coarse quantizer + QINCo neural residual codec
                (search_ivf_qinco.py:38-118);
  - ``add``:    encode the database, build the inverted lists (:126-177);
  - ``search``: deferred-ID-decoding search returning shortlist codes, QINCo
                neural decode of the shortlist, exact L2 re-rank, recall@1/10/100
                + timing JSON (:185-315). ``--id_compression`` selects the ID
                codec (:384-388, :502-524); ``--defer_id_decoding`` and the
                ``id_decoding_1by1 = comp != "roc"`` policy (:417) match.

The search and the re-rank run on the device; each timed call ends in a
synchronisation with it.

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.search_ivf_qinco \
        --todo train add search --dataset synthetic --nlist 256 --M 8 \
        --id_compression roc --defer_id_decoding --nshort 100 --k 10

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ..models.qinco import QincoCodec
from ..search.ivf import IndexIVF
from ..search.ivf import load_index as _load_index
from ..search.ivf import save_index as _save_index
from ..store.invlists import AVAILABLE_COMPRESSED_IVFS
from ._timing import seconds

COMPRESSIONS = {"none": None, **AVAILABLE_COMPRESSED_IVFS}


def _index_path(workdir: Path) -> Path:
    return workdir / "qinco_index.npz"


def run_train(ds, args, workdir: Path) -> IndexIVF:
    xt = ds.get_train()
    qinco = QincoCodec(ds.d, args.M, ksub=args.ksub, hidden=args.hidden,
                       seed=args.seed, device=args.device)
    index = IndexIVF(ds.d, args.nlist, storage="qinco", qinco=qinco, device=args.device)
    t, _ = seconds(lambda: index.train(xt, niter=args.kmeans_niter,
                                       qinco_steps=args.qinco_steps), index.device)
    print(f"[train] done in {t:.1f}s", flush=True)
    _save_index(_index_path(workdir), index)
    return index


def load_index(args, workdir: Path) -> IndexIVF:
    return _load_index(_index_path(workdir), device=args.device)


def run_add(ds, args, workdir: Path):
    index = load_index(args, workdir)
    t, _ = seconds(lambda: index.add(ds.get_database()), index.device)
    print(f"[add] {index.ntotal} vectors in {t:.1f}s", flush=True)
    _save_index(_index_path(workdir), index)


class OperatingPoints:
    """Pareto frontier over (recall, time) with monotone-bounds pruning — the
    faiss OperatingPointsWithRanges analogue the reference sweeps with
    (search_ivf_qinco.py:221-246). Both recall and time are assumed monotone
    nondecreasing in every parameter (nprobe, nshort)."""

    def __init__(self, param_names):
        self.param_names = list(param_names)
        self.measured = []  # (param tuple, perf, time)

    def _tuple(self, params):
        return tuple(params[n] for n in self.param_names)

    def add_operating_point(self, params, perf, t):
        self.measured.append((self._tuple(params), perf, t))

    def predict_bounds(self, params):
        """(max_perf, min_time) bounds for an unmeasured point, from measured
        points that dominate / are dominated by it component-wise."""
        c = self._tuple(params)
        max_perf = float("inf")
        min_time = 0.0
        for p, perf, t in self.measured:
            if all(a >= b for a, b in zip(p, c)):
                max_perf = min(max_perf, perf)
            if all(a <= b for a, b in zip(p, c)):
                min_time = max(min_time, t)
        return max_perf, min_time

    def is_pareto_optimal(self, max_perf, min_time):
        """False when a measured point already beats the candidate's best
        case on both axes — then the candidate can be skipped."""
        return not any(
            perf >= max_perf and t <= min_time for _, perf, t in self.measured
        )


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def rerank(index: IndexIVF, xq: torch.Tensor, I: torch.Tensor, codes: torch.Tensor,
           k: int):
    """Exact re-rank of a shortlist (reference :263-296): the list number
    from the codes' little-endian prefix bytes, the QINCo decode of the
    residual plus the list's centroid, exact L2 to the query (+inf for an
    empty slot), the k best, ties in shortlist order → (D f32[nq, k], ids
    i64[nq, k]) on the index's device."""
    pfx = index.coarse_code_size
    M = index.qinco.M
    flat_codes = codes.reshape(-1, codes.shape[-1])
    listnos = torch.zeros(flat_codes.shape[0], dtype=torch.int64, device=codes.device)
    for b in range(pfx):
        listnos |= flat_codes[:, b].to(torch.int64) << (8 * b)
    listnos = listnos.clamp(0, index.nlist - 1)  # 0xff fill on empties
    # an empty slot's 0xff codes may lie past ksub; its distance is +inf
    qcodes = torch.where(I.reshape(-1, 1) >= 0, flat_codes[:, pfx:pfx + M], 0)
    dec = index.qinco.decode(qcodes) + index.centroids[listnos]
    diff = dec.reshape(xq.shape[0], I.shape[1], -1) - xq[:, None, :]
    d2 = torch.where(I >= 0, (diff * diff).sum(dim=2), float("inf"))
    order = torch.argsort(d2, dim=1, stable=True)[:, :k]
    return torch.gather(d2, 1, order), torch.gather(I, 1, order)


def run_search(ds, args, workdir: Path):
    index = load_index(args, workdir)
    dev = index.device
    source = index.invlists

    # swap in the requested ID compression (reference :502-524)
    fac = COMPRESSIONS[args.id_compression]
    comp_time = 0.0
    ids_size = index.ntotal * 8
    if fac is not None:
        comp_time, container = seconds(lambda: fac(source, device=dev), dev)
        ids_size = container.compressed_ids_size_in_bytes
        print(f"[search] compressed ids size {ids_size} "
              f"compressed in {comp_time:.3f}s", flush=True)
        index.replace_invlists(container)
    decode_1by1 = args.id_compression not in ("roc",)  # reference :417

    xq = ds.get_queries()
    xq_d = torch.as_tensor(xq, dtype=torch.float32, device=dev)
    gt = ds.get_groundtruth(100)
    k = args.k

    def shortlist(nprobe, nshort):
        if args.defer_id_decoding:
            _, I, codes = index.search_defer_id_decoding(
                xq_d, nshort, nprobe=nprobe, decode_1by1=decode_1by1,
                return_codes=2)
        else:
            # one scan: positional labels -> translate + harvest (the
            # non-deferred baseline still pays per-result translation; it
            # must not pay a second full scan)
            _, L = index.search_positional(xq_d, nshort, nprobe)
            I = index._translate(L, decode_1by1)
            codes = index._harvest_codes(L, True)
        return I, codes

    def one_run(nprobe, nshort):
        t_search, (I, codes) = seconds(lambda: shortlist(nprobe, nshort), dev)
        t_rerank, (_, I_rr) = seconds(lambda: rerank(index, xq_d, I, codes, k), dev)
        return I_rr.cpu().numpy(), t_search, t_rerank

    def recalls_of(I_rr):
        return {
            str(r): float((I_rr[:, :r] == gt[:, :1]).sum()) / len(xq)
            for r in (1, 10, 100) if r <= k
        }

    # operating-point grid (reference op.add_range("nprobe"/"nshort"),
    # :221-232); scalar args run the single point the old schema expects
    nprobes = _as_list(args.nprobe)
    nshorts = _as_list(args.nshort)
    grid = [dict(nprobe=int(np_), nshort=int(ns))
            for np_ in nprobes for ns in nshorts]
    n_autotune = getattr(args, "n_autotune", 0)
    if n_autotune and len(grid) > n_autotune:
        rs = np.random.RandomState(123)  # reference :233
        grid = [grid[i] for i in rs.choice(len(grid), n_autotune,
                                           replace=False)]

    op = OperatingPoints(["nprobe", "nshort"])
    one_run(grid[0]["nprobe"], grid[0]["nshort"])  # warm-up
    results = []
    sweep = []
    for params in grid:
        if n_autotune:
            max_perf, min_time = op.predict_bounds(params)
            if not op.is_pareto_optimal(max_perf, min_time):
                print(f"[search] {params} SKIP (dominated: "
                      f"{max_perf=:.3f} {min_time=:.3f})", flush=True)
                sweep.append(dict(parameters=params, skipped=True))
                continue
        ts_runs, tr_runs = [], []
        for run in range(args.runs):
            I_rr, t_search, t_rerank = one_run(params["nprobe"],
                                               params["nshort"])
            recalls = recalls_of(I_rr)
            row = dict(run=run, parameters=params, t_search=t_search,
                       t_rerank=t_rerank, recalls=recalls)
            results.append(row)
            ts_runs.append(t_search)
            tr_runs.append(t_rerank)
            print(f"[search] {params} run {run}: search {t_search:.3f}s "
                  f"rerank {t_rerank:.3f}s recalls {recalls}", flush=True)
        op.add_operating_point(params, recalls["1"], t_search + t_rerank)
        # redo-averaging discipline (reference --redo_search N averaged):
        # the sweep row carries mean AND min over the warm redos
        sweep.append(dict(parameters=params, skipped=False,
                          t_search=float(np.mean(ts_runs)),
                          t_search_min=float(np.min(ts_runs)),
                          t_rerank=float(np.mean(tr_runs)),
                          t_rerank_min=float(np.min(tr_runs)),
                          runs=len(ts_runs), recalls=recalls))

    out = dict(args={k_: v for k_, v in vars(args).items()},
               ids_size=int(ids_size),
               comp_time=comp_time, ntotal=index.ntotal,
               bits_per_id=8.0 * ids_size / max(index.ntotal, 1),
               results=results, sweep=sweep)
    out_path = workdir / "search_results.json"
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out)[:2000], flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--todo", nargs="+", default=["train", "add", "search"],
                   choices=["train", "add", "search"])
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "sift1m", "deep1m", "fb_ssnpp"])
    p.add_argument("--fb_ssnpp_dir", default=None)
    p.add_argument("--synth_scale", type=float, default=1.0)
    p.add_argument("--workdir", default="qinco_work")
    p.add_argument("--nlist", type=int, default=256)
    p.add_argument("--M", type=int, default=8)
    p.add_argument("--ksub", type=int, default=256)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--kmeans_niter", type=int, default=20)
    p.add_argument("--qinco_steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--id_compression", default="none",
                   choices=list(COMPRESSIONS))
    p.add_argument("--defer_id_decoding", action="store_true")
    p.add_argument("--nprobe", type=int, nargs="+", default=[16],
                   help="one value = single point; several = sweep range")
    p.add_argument("--nshort", type=int, nargs="+", default=[100])
    p.add_argument("--n_autotune", type=int, default=0,
                   help="sample this many grid points with Pareto pruning "
                        "(reference --n_autotune, :353); 0 = run full grid")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the index lives and searches (default: the card)")
    args = p.parse_args(argv)

    from .datasets import get_dataset

    resolve(args.device)
    ds = get_dataset(args.dataset, args.fb_ssnpp_dir,
                     synth_scale=args.synth_scale, device=args.device)
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    out = None
    if "train" in args.todo:
        run_train(ds, args, workdir)
    if "add" in args.todo:
        run_add(ds, args, workdir)
    if "search" in args.todo:
        out = run_search(ds, args, workdir)
    return out


if __name__ == "__main__":
    main()

"""Multi-device scaling bench — the BASELINE.md "≥80% N-device scaling
efficiency" metric; port of the JAX package's ``bench/scaling.py``.

The unit of parallelism is the inverted list, sharded over a 'lists' mesh
(``parallel/mesh.py``). Because each list's ANS chain is strictly sequential
(codec.cpp:140-152), wall time is set by the number of *scan steps* (max
list length), not the lane count, so the meaningful experiment is **weak
scaling**: N devices process N× the lists in the time one device takes for
its share,

  efficiency(N) = T(1 device, B lists) / T(N devices, N*B lists)

reported for the sharded ROC encode and decode (the ROC kernels on the
card), plus a device-count-invariance assert on the N-device artifact (the
§2.4 determinism contract). ``--search`` weak-scales ``ShardedIVF`` instead,
asserting at every scale that the N-device search equals a 1-device mesh's
over the same database; ``--phases`` times its four stages.

The JAX package builds an in-process mesh of N devices. Here a mesh of N is
N ranks of torch.distributed (``parallel/multihost.py`` ``initialize``, from
torchrun's variables): ``--devices`` takes sub-groups of the first N ranks
of the launched world (``dist.new_group``), and one process without a group
is the mesh of one. Ranks outside a mesh wait for it. Rank 0 prints the
result.

    python -m vector_db_id_compression_tpu_torch.bench.scaling --devices 1
    torchrun --nproc_per_node 4 -m vector_db_id_compression_tpu_torch.bench.scaling \
        --devices 1 2 4

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE
from ..parallel import multihost
from ..parallel.mesh import ListsMesh, make_lists_mesh, rank_device
from ._timing import log, seconds


def _time(fn, runs: int, device) -> float:
    seconds(fn, device)  # warm
    return min(seconds(fn, device)[0] for _ in range(runs))


def _stage_time(fn, runs: int, device) -> float:
    """Least seconds of ``fn`` over ``runs`` after a warm-up: between CUDA
    events on a card (the device's time of the stage, not the host's), on
    the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return _time(fn, runs, device)
    with torch.cuda.device(device):
        fn()
        best = float("inf")
        for _ in range(runs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best


def make_lists(n_lists: int, ids_per_list: int, seed: int):
    """IVF-shaped workload: ``n_lists`` lists of ~``ids_per_list`` uniform
    ids each (every list drawn over its own dense id range so per-list
    precision is constant across scales); the JAX package's arrays."""
    from ..codecs.roc import precision_for_max_id_safe

    # per-list generators so list ln's content is independent of n_lists —
    # the weak-scaling runs then share their leading lists across mesh sizes
    # and the determinism assert can compare shard-0 artifacts directly
    id_range = ids_per_list * 16
    n_max_bound = int(ids_per_list * 1.1) + 1
    lengths = np.empty(n_lists, dtype=np.int32)
    members_all = []
    for ln in range(n_lists):
        r = np.random.default_rng(seed * 1_000_003 + ln)
        m = int(r.integers(int(ids_per_list * 0.9), n_max_bound))
        members_all.append(
            np.sort(r.choice(id_range, size=m, replace=False)
                    ).astype(np.uint64))
        lengths[ln] = m
    n_max = int(lengths.max())
    ids = np.zeros((n_lists, n_max), dtype=np.uint64)
    prec = np.ones(n_lists, dtype=np.int32)
    for ln, members in enumerate(members_all):
        ids[ln, : len(members)] = members
        prec[ln] = precision_for_max_id_safe(int(members[-1]))
    return ids, lengths, prec, int(lengths.sum())


def _world():
    """(world size, this rank) of the default group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def lists_mesh(N: int, device):
    """The mesh of the first ``N`` ranks of the world on this rank's
    ``device``, or None on a rank outside it; the mesh of one has no group.
    Every rank calls this for every N in the same order (``dist.new_group``
    is collective)."""
    world, rank = _world()
    group = dist.new_group(list(range(N))) if 1 < N < world else None
    if rank >= N:
        return None
    return ListsMesh(0, 1, device) if N == 1 else make_lists_mesh(N, device, group=group)


def _barrier():
    if _world()[0] > 1:
        dist.barrier()


def run(lists_per_device: int, ids_per_list: int, seed: int, runs: int,
        device_counts, device=DEFAULT_DEVICE):
    from ..codecs import roc_device as rd
    from ..parallel.mesh import sharded_roc_decode, sharded_roc_encode

    world, rank = _world()
    dev = rank_device(device)
    device_counts = [n for n in device_counts if n <= world]
    if rank == 0:
        log(f"ranks: {world} on {dev.type}; meshes {device_counts}; "
            f"{lists_per_device} lists/device x ~{ids_per_list} ids/list")

    rows = []
    base_t = {}
    shard0 = None  # 1-device artifact of the first shard's lists
    for N in device_counts:
        mesh = lists_mesh(N, dev)
        if mesh is None:
            _barrier()
            continue
        B = lists_per_device * N
        ids, lengths, prec, ntotal = make_lists(B, ids_per_list, seed)
        cap = rd.stack_capacity(int(lengths.max()), int(prec.max()))
        n_max = ids.shape[1]
        # on the rank's device before anything is timed, as the JAX driver
        # puts them on its devices: the timed calls copy nothing from the host
        ids_t, len_t, prec_t = (torch.as_tensor(a, device=dev)
                                for a in (ids.view(np.int64), lengths, prec))

        def enc():
            st, _ = sharded_roc_encode(mesh, ids_t, len_t, prec_t, cap)
            return st

        t_enc = _time(enc, runs, dev)
        states = enc()

        # determinism: every mesh size encodes shard-0's lists (the first
        # lists_per_device rows, identical across scales by construction of
        # make_lists) to the same streams as the 1-device mesh
        head0 = states.head[:lists_per_device].cpu()
        slen0 = states.stack_len[:lists_per_device].cpu()
        if shard0 is None:
            shard0 = (head0, slen0)
        elif not (torch.equal(head0, shard0[0]) and torch.equal(slen0, shard0[1])):
            raise AssertionError(f"the {N}-device mesh encodes shard 0 otherwise than "
                                 f"the {base_t['n_devices']}-device mesh")

        def dec():
            return sharded_roc_decode(mesh, states, len_t, prec_t, n_max)

        t_dec = _time(dec, runs, dev)

        row = {"n_devices": N, "n_lists": B, "ntotal": ntotal,
               "encode_s": round(t_enc, 4), "decode_s": round(t_dec, 4),
               "encode_mids_s": round(ntotal / t_enc / 1e6, 3),
               "decode_mids_s": round(ntotal / t_dec / 1e6, 3)}
        if not base_t:
            base_t = dict(row)
            if N != 1 and rank == 0:
                log(f"warning: efficiency baseline is N={N}, not 1 "
                    "(pass --devices starting at 1 for T(1)/T(N))")
        row["eff_vs"] = base_t["n_devices"]  # baseline N the effs divide by
        for key in ("encode", "decode"):
            row[f"{key}_eff"] = round(base_t[f"{key}_s"] / row[f"{key}_s"], 3)
        rows.append(row)
        if rank == 0:
            log(f"N={N}: {B:5d} lists  encode {t_enc*1e3:7.1f} ms "
                f"({row['encode_mids_s']:7.2f} Mids/s, eff {row['encode_eff']:.2f})"
                f"  decode {t_dec*1e3:7.1f} ms "
                f"({row['decode_mids_s']:7.2f} Mids/s, eff {row['decode_eff']:.2f})")
        _barrier()
    return rows


def run_search(lists_per_device: int, ids_per_list: int, d: int, nq: int,
               k: int, nprobe: int, seed: int, runs: int, device_counts,
               method: str = "roc", phases: bool = False, device=DEFAULT_DEVICE):
    """Weak-scale the sharded search (``parallel.search.ShardedIVF``): the
    database grows N× with the mesh (lists_per_device lists per shard), the
    queries stay fixed — ideal weak scaling keeps query latency flat while
    capacity grows N×. Asserts at every scale that the N-device mesh returns
    the same (D, I) as a 1-device mesh over the SAME database. ``phases``
    times each of the four stages alone (CUDA events on a card), on inputs
    computed beforehand, and the whole search; the JAX package differences
    cumulative programs instead, which can give a stage a negative time."""
    from ..parallel.search import ShardedIVF
    from ..search.ivf import IndexIVF
    from ..store.invlists import AVAILABLE_COMPRESSED_IVFS

    world, rank = _world()
    dev = rank_device(device)
    device_counts = [n for n in device_counts if n <= world]
    rng = np.random.default_rng(seed)
    rows = []
    base_t = {}
    for N in device_counts:
        nlist = lists_per_device * N
        nb = nlist * ids_per_list
        xb = rng.standard_normal((nb, d)).astype(np.float32)
        xq = rng.standard_normal((nq, d)).astype(np.float32)
        mesh = lists_mesh(N, dev)
        if mesh is None:
            _barrier()
            continue
        index = IndexIVF(d, nlist, device=dev)
        index.train(xb[: min(nb, 20 * nlist)], niter=2)
        index.add(xb)
        cont = (index.invlists if method == "ref"
                else AVAILABLE_COMPRESSED_IVFS[method](index.invlists, device=dev))
        if method != "ref":
            index.replace_invlists(cont)
        sh = ShardedIVF(mesh, index, cont, device=dev)
        xq_d = torch.from_numpy(xq).to(dev)

        def q():
            return sh.search(xq_d, k, nprobe)

        t = _time(lambda: q()[1], runs, dev)
        D, I = q()
        # device-count invariance on the same database
        D1, I1 = ShardedIVF(ListsMesh(0, 1, dev), index, cont, device=dev).search(
            xq_d, k, nprobe)
        if not torch.equal(I, I1):
            raise AssertionError(f"the {N}-device search's labels differ from one device's")
        torch.testing.assert_close(D, D1, rtol=1e-5, atol=1e-5)

        row = {"n_devices": N, "nlist": nlist, "ntotal": nb,
               "search_s": round(t, 4),
               "qps": round(nq / t, 1)}

        if phases:
            # each stage alone, on the previous stage's output computed
            # beforehand (every rank runs the same stages in step: they hold
            # collectives); the cumulative times are their running sums
            probes = sh._coarse(xq_d, nprobe)
            dist_, labels = sh._scan(xq_d, probes, k)
            _, L = sh._merge(dist_, labels, k)
            stage = {"coarse": _stage_time(lambda: sh._coarse(xq_d, nprobe), runs, dev),
                     "scan": _stage_time(lambda: sh._scan(xq_d, probes, k), runs, dev),
                     "merge": _stage_time(lambda: sh._merge(dist_, labels, k), runs, dev),
                     "translate": _stage_time(lambda: sh._translate(L), runs, dev)}
            cum = dict(zip(("coarse", "scan", "merge"), np.cumsum(list(stage.values()))))
            cum["full"] = _stage_time(lambda: q()[1], runs, dev)
            row["phase_cum_s"] = {s: round(float(v), 4) for s, v in cum.items()}
            row["phase_s"] = {s: round(v, 4) for s, v in stage.items()}
            if rank == 0:
                log(f"    phases (each stage alone): {row['phase_s']}")

        if not base_t:
            base_t = dict(row)
        row["eff_vs"] = base_t["n_devices"]
        row["search_eff"] = round(base_t["search_s"] / row["search_s"], 3)
        rows.append(row)
        if rank == 0:
            log(f"N={N}: ntotal={nb:7d}  search {t*1e3:7.1f} ms "
                f"({row['qps']:8.1f} q/s, eff {row['search_eff']:.2f}) "
                f"[N-dev == 1-dev checked]")
        _barrier()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lists-per-device", type=int, default=None,
                   help="default 256; with --search 64")
    p.add_argument("--ids-per-list", type=int, default=None,
                   help="default 500; with --search 200")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--search", action="store_true",
                   help="weak-scale the sharded search instead of the codec "
                        "(smaller defaults: see --search-*)")
    p.add_argument("--search-method", default="roc")
    p.add_argument("--search-d", type=int, default=16)
    p.add_argument("--search-nq", type=int, default=64)
    p.add_argument("--search-k", type=int, default=10)
    p.add_argument("--search-nprobe", type=int, default=8)
    p.add_argument("--phases", action="store_true",
                   help="with --search: time each stage "
                        "(coarse/scan/merge/translate) alone per mesh size")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="each rank's device (default: a card)")
    args = p.parse_args(argv)

    t0 = time.time()
    multihost.initialize(device=args.device)
    world, rank = _world()
    dev = rank_device(args.device)
    # the JAX package's --search clamps the two sizes to 64 and 200 even
    # where they are given; here a size given is taken as given
    lists, ids = (64, 200) if args.search else (256, 500)
    lists = lists if args.lists_per_device is None else args.lists_per_device
    ids = ids if args.ids_per_list is None else args.ids_per_list
    if args.search:
        rows = run_search(
            lists, ids,
            args.search_d, args.search_nq, args.search_k,
            args.search_nprobe, args.seed, args.runs, args.devices,
            method=args.search_method, phases=args.phases, device=dev)
        out = {
            "platform": dev.type,
            "host_cores": os.cpu_count(),
            "ranks": world,
            "mode": "weak_scaling_search",
            "method": args.search_method,
            "note": ("database grows Nx with the mesh; ideal weak scaling "
                     "keeps latency flat. Ranks that share a card or the "
                     "host contend for it."),
            "rows": rows,
        }
    else:
        rows = run(lists, ids, args.seed,
                   args.runs, args.devices, device=dev)
        out = {
            "platform": dev.type,
            "host_cores": os.cpu_count(),
            "ranks": world,
            "mode": "weak_scaling",
            "lists_per_device": lists,
            "ids_per_list": ids, "rows": rows,
        }
    if world > 1:
        dist.destroy_process_group()
    if rank == 0:
        log(f"done in {time.time() - t0:.1f}s")
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

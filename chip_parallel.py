#!/usr/bin/env python3
"""The sharded IVF search with one NCCL rank per card, under torchrun.

    torchrun --nproc_per_node 4 chip_parallel.py [--seed 7]

Rank 0 builds IVF1024,Flat over ``chip_smoke.py``'s data (1,000,000 vectors
of d = 128 from the seeded mixture, 1000 queries, k = 10, nprobe = 16) with
RocInvertedLists on its card, searches the queries unsharded and as a
one-rank ShardedIVF, and saves the index and the container. After a barrier
every rank loads both onto its host, encodes its quarter of the lists
(``sharded_roc_encode``) and builds its rows on its own card, and the ranks
search together over NCCL. Rank 0 fails the run unless the gathered states
equal the container's bit for bit and the sharded search equals the one-rank
search under the near-tie rule; it prints each stage's time on both meshes,
the D differences, and each rank's launches and peak device memory. With
``--device cpu --nb N`` the same runs on gloo ranks on the CPU, at a small
size, as a rehearsal (host-clock times).
"""

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs


def ms(fn, reps: int = 5) -> float:
    """Median ms of ``fn`` after a warm-up: CUDA events on the card, the
    host clock on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return cs.median_ms(fn, reps)
    fn()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nb", type=int, default=cs.NB)
    args = parser.parse_args()

    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.parallel import multihost
    from vector_db_id_compression_tpu_torch.parallel.mesh import ListsMesh, sharded_roc_encode
    from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index, save_index
    from vector_db_id_compression_tpu_torch.store.invlists import (RocInvertedLists,
                                                                   roc_lane_table)
    from vector_db_id_compression_tpu_torch.store.serialize import load_invlists, save_invlists

    multihost.initialize(device=args.device)
    mesh = multihost.global_lists_mesh(device=args.device)
    dev, rank = mesh.device, mesh.rank
    if rank == 0:
        print(f"[nccl] {mesh.size} ranks, backend {mesh.backend}, torch {torch.__version__}",
              flush=True)
        if dev.type == "cuda":
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True, timeout=60).stdout.strip(), flush=True)
    xq = torch.from_numpy(cs.draw(args.seed, cs.NQ, args.seed + 3)).to(dev)
    # one directory for every rank: rank 0's, sent as its name
    name = [tempfile.mkdtemp(prefix="chip_parallel_") if rank == 0 else None]
    dist.broadcast_object_list(name, src=0)
    work = Path(name[0])
    one = None
    if rank == 0:
        xb = cs.draw(args.seed, args.nb, args.seed + 2)
        xt = cs.draw(args.seed, min(cs.NT, args.nb), args.seed + 1)
        index = IndexIVF(cs.D, cs.NLIST, device=dev)
        index.train(xt)
        index.add(xb)
        roc = RocInvertedLists(index.invlists, device=dev)
        index.replace_invlists(roc)
        D0, I0 = index.search_defer_id_decoding(xq, k=cs.K, nprobe=cs.NPROBE)
        t_unsharded = ms(lambda: index.search_defer_id_decoding(xq, k=cs.K, nprobe=cs.NPROBE))
        one_sh = ShardedIVF(ListsMesh(0, 1, dev), index, roc, device=dev)
        D1, I1 = one_sh.search(xq, cs.K, cs.NPROBE)
        one = cs.stage_times(one_sh, xq, timer=ms)
        del one_sh
        built = [t.cpu() for t in roc.decoder.states[:4]]
        save_index(work / "index.npz", index)
        save_invlists(work / "roc.npz", roc)
        del index, roc
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    RocEncoder.launches = RocDecoder.launches = 0
    t0 = time.perf_counter()
    index = load_index(work / "index.npz", device="cpu")
    roc = load_invlists(work / "roc.npz", device="cpu")
    load_s = time.perf_counter() - t0
    ids, lengths, prec, _ = roc_lane_table(index.invlists)
    states, _ = sharded_roc_encode(mesh, torch.from_numpy(ids.view(np.int64)),
                                   torch.from_numpy(lengths), torch.from_numpy(prec),
                                   roc.decoder.states.stack.shape[1])
    sh = ShardedIVF(mesh, index, roc, device=dev)
    D4, I4 = sh.search(xq, cs.K, cs.NPROBE)
    launches = [RocEncoder.launches, RocDecoder.launches]
    many = cs.stage_times(sh, xq, timer=ms)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else 0.0
    report = mesh.all_gather(torch.tensor([*launches, peak, load_s], dtype=torch.float64,
                                          device=dev)).cpu()
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return
    shutil.rmtree(work)
    for a, b, what in zip(states[:4], built, ("head", "stack", "stack_len", "mt_ctr")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"sharded_roc_encode: {what} differs from the container's")
    differ = cs.assert_near_ties("sharded against one rank", D4, I4, D1, I1, 1e-4, 1e-3)
    cs.assert_near_ties("one rank against unsharded", D1, I1, D0, I0, 1e-5, 1e-5)
    d_abs = (D4 - D1).abs().cpu()
    if dev.type == "cuda" and bool((report[:, :2] < 1).any()):
        raise AssertionError(f"a rank launched no kernel: {report[:, :2].tolist()}")
    print(f"[nccl] {mesh.size} ranks: states == the container's; I == the one rank's under the "
          f"near-tie rule ({differ} labels at near ties); D differs in {int((d_abs > 0).sum())} "
          f"of {d_abs.numel()} entries, by {float(d_abs.max()):.6g} at most", flush=True)
    print(f"[nccl] unsharded search {t_unsharded:.2f} ms; one rank "
          + json.dumps({k: round(v, 3) for k, v in one.items()})
          + f"; {mesh.size} ranks " + json.dumps({k: round(v, 3) for k, v in many.items()})
          + " (ms: medians of 5 after a warm-up)", flush=True)
    for r, row in enumerate(report.tolist()):
        print(f"[nccl] rank {r}: launches encode {int(row[0])}, decode {int(row[1])}; peak "
              f"device memory {row[2]:.0f} MiB; load {row[3]:.2f} s", flush=True)


if __name__ == "__main__":
    main()

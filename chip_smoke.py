#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths (``vector_db_id_compression_tpu_torch``) once
each, at SIFT1M's shape: 1,000,000 synthetic database vectors of d = 128
(float32) and 1000 queries, k = 10. The IVF path: an IVF with 1024 lists and
flat payload, nprobe = 16, the ids of every inverted list ROC-compressed and
decoded only after the top-k is final (deferred id decoding). The graph path:
an NSG graph of degree R = 32 over the same database, searched on the card
with its adjacency dense, ROC-compressed per node, and ROC-compressed in
chained blocks of 16 nodes, decoded inside the traversal. Phases:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds the kernels from csrc/ (one process per source)
  3. kernels  each ROC kernel against its plain torch version on seeded
              batches: 256 lists (lengths 1..1500), and 64 lanes of 16
              chained slots (lengths 0..32); ids up to 2^20 and 2^32 - 1;
              bit-equal or the run fails
  4. main     train, add, search uncompressed, swap in the ROC container,
              search again; the ROC search must return the uncompressed
              search's rows (ids are lossless); both kernels must have been
              launched by that path; then bits/id and phase times
  5. graph    build_nsg on the card, the two ROC graphs, and the search with
              each of the three containers: identical I and D or the run
              fails; every ROC kernel must have been launched by this phase;
              the host-loop search (search_graph, a separate walk) must give
              the same I on 32 queries; then bits/edge, hops, recall and
              search times
  6. probes   the two decode-step probes against their plain versions
  7. timing   each kernel beside its plain version at its paths' shapes:
              both ROC kernels at the IVF shapes and at the graph's (per node
              and chained), bit-equal or the run fails

The line before the last is a JSON object with each kernel's launch count
(from the phases that drive it, counted from 0 just before each), its error
against the plain version and its time beside the plain version's; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, it exits nonzero and prints no result.

Usage: python3 chip_smoke.py [--seed N]
"""

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

NB, NT, NQ, D = 1_000_000, 100_000, 1000, 128
NLIST, K, NPROBE = 1024, 10, 16
GRAPH_R, GRAPH_BLOCK = 32, 16
NQ_HOST = 32  # queries the host-loop search checks the device walk on


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn):
    """(milliseconds between CUDA events around fn, fn's result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def median_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up
    return float(np.median([cuda_ms(fn)[0] for _ in range(reps)]))


def max_abs_err(got, want) -> float:
    """Largest absolute difference between tensors (or the tensors of two
    tuples). Integer tensors that differ count at least 1: float64 does not
    hold every int64, so a difference in a 64-bit head could round to 0."""
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [(got, want)]
    err = 0.0
    for g, w in pairs:
        g, w = g.cpu(), w.cpu()
        if g.numel() and not torch.equal(g, w):
            diff = float((g.double() - w.double()).abs().max())
            err = max(err, diff if g.is_floating_point() else max(diff, 1.0))
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda}: {name}, "
        f"{torch.cuda.device_count()} device(s); nvidia-smi name, power limit:")
    log(smi.splitlines()[0])
    return name


def phase_build():
    from vector_db_id_compression_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.LIBRARY} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in _build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def kernel_batch(seed: int):
    """256 lists: lengths 1..1500 with every power of two up to 1024, half
    the lanes with ids < 2^20, half with ids up to 2^32 - 1."""
    from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe

    rng = np.random.default_rng(seed)
    B = 256
    lengths = rng.integers(1, 1501, B)
    lengths[:12] = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 1500]
    ids = np.zeros((B, int(lengths.max())), np.uint64)
    prec = np.zeros(B, np.int32)
    for b, n in enumerate(lengths):
        top = 2**20 if b % 2 else 2**32
        v = rng.choice(top - 1, size=n, replace=False).astype(np.uint64) + 1
        if b % 4 == 0:
            v[0] = top - 1  # the largest id of the range
            v = np.unique(v)
            while len(v) < n:
                v = np.unique(np.append(v, rng.integers(1, top, n - len(v), dtype=np.uint64)))
        ids[b, :n] = np.sort(v)
        prec[b] = precision_for_max_id_safe(int(ids[b, n - 1]))
    return (torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths.astype(np.int32)),
            torch.from_numpy(prec))


def phase_kernels(seed: int):
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder

    ids, lengths, prec = kernel_batch(seed)
    cuda = torch.device("cuda")
    st_k, order_k = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    torch.cuda.synchronize()
    st_p, order_p = RocEncoder.encode(ids, lengths, prec)  # plain version, CPU
    for field, got, want in zip(st_k._fields, st_k, st_p):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"ROC encode kernel: {field} differs from the plain version")
    if not torch.equal(order_k.cpu(), order_p):
        raise AssertionError("ROC encode kernel: order differs from the plain version")
    n_max = ids.shape[1]
    ids_k = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda), rd.default_pool(n_max, cuda),
                       n_max).decode()
    torch.cuda.synchronize()
    ids_p = RocDecoder(st_p, lengths, prec, rd.default_pool(n_max), n_max).decode()
    if not torch.equal(ids_k.cpu(), ids_p):
        raise AssertionError("ROC decode kernel: ids differ from the plain version")
    for b, n in enumerate(lengths.tolist()):
        if not torch.equal(ids_p[b, :n].sort().values, ids[b, :n]):
            raise AssertionError(f"ROC decode: lane {b} is not its id set")
    stack_words = int(st_k.stack_len.sum())
    log(f"[kernels] 256 lists, lengths 1..{int(lengths.max())}, precision "
        f"{int(prec.min())}..{int(prec.max())}: encode kernel == plain (head, "
        f"{stack_words} stack words, stack_len, mt_ctr, order), decode kernel == "
        f"plain == input ids; max_abs_err 0")

    ids, lengths, prec = chained_batch(seed)
    st_k = RocEncoder.encode_chained(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    torch.cuda.synchronize()
    L, S, n_max = ids.shape
    maxp, pool = int(prec.max()), rd.default_pool(S * n_max)
    st_p = rd.roc_encode_chained(ids, lengths, prec, pool,
                                 rd.fresh_states(L, rd.stack_capacity(S * n_max, maxp)),
                                 rd.n_slices_for(maxp))
    for field, got, want in zip(st_k._fields, st_k, st_p):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"chained ROC encode kernel: {field} differs from the "
                                 "plain version")
    ids_k = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda), pool.to(cuda), n_max).decode()
    torch.cuda.synchronize()
    ids_p, _ = rd.roc_decode_chained(st_p, lengths, prec, pool, n_max, rd.n_slices_for(maxp))
    if not torch.equal(ids_k.cpu(), ids_p):
        raise AssertionError("chained ROC decode kernel: ids differ from the plain version")
    for b, s in np.ndindex(L, S):
        n = int(lengths[b, s])
        if not torch.equal(ids_p[b, s, :n].sort().values, ids[b, s, :n]):
            raise AssertionError(f"chained ROC decode: lane {b} slot {s} is not its id set")
    log(f"[kernels] {L} lanes x {S} chained slots, lengths 0..{int(lengths.max())}, "
        f"precision {int(prec.min())}..{maxp}: chained encode kernel == plain (head, "
        f"{int(st_k.stack_len.sum())} stack words, stack_len, mt_ctr), chained decode "
        f"kernel == plain == input ids; max_abs_err 0")


def chained_batch(seed: int):
    """64 lanes of 16 chained slots: lengths 0..32 with 0, 1 and every power
    of two among them; half the lanes with ids < 2^20, half with ids up to
    2^32 - 1, the largest id of the range in some slots; empty slots get
    precision 1, as the graph container gives them."""
    from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe

    rng = np.random.default_rng(seed + 100)
    L, S, n_max = 64, 16, 32
    lengths = rng.integers(0, n_max + 1, (L, S))
    lengths.flat[:8] = [0, 1, 2, 4, 8, 16, 32, 0]
    ids = np.zeros((L, S, n_max), np.uint64)
    prec = np.ones((L, S), np.int32)
    for b, s in np.ndindex(L, S):
        n = lengths[b, s]
        if n == 0:
            continue
        top = 2**20 if b % 2 else 2**32
        v = rng.choice(top - 2, size=n, replace=False).astype(np.uint64) + 1
        if s % 4 == 0:
            v[0] = top - 1  # the largest id of the range
        ids[b, s, :n] = np.sort(v)
        prec[b, s] = precision_for_max_id_safe(int(ids[b, s, n - 1]))
    return (torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths.astype(np.int32)),
            torch.from_numpy(prec))


def make_data(seed: int):
    """Gaussian mixture as the JAX package's bench/datasets.py
    SyntheticDataset: 32 centres scaled by 4, unit noise."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((32, D)).astype(np.float32) * 4.0

    def draw(n, r):
        return (cent[r.integers(0, 32, n)] + r.standard_normal((n, D))).astype(np.float32)

    return (draw(NT, np.random.default_rng(seed + 1)), draw(NB, np.random.default_rng(seed + 2)),
            draw(NQ, np.random.default_rng(seed + 3)))


def phase_main(xt, xb, xq):
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
    from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

    # ---- the main path, through the user-facing entry points; the kernels'
    # launch counts are read from this window only
    RocEncoder.launches = 0
    RocDecoder.launches = 0
    index = IndexIVF(d=D, nlist=NLIST, storage="flat", device="cuda")
    t_train, _ = cuda_ms(lambda: index.train(xt))
    t_add, _ = cuda_ms(lambda: index.add(xb))
    D0, I0 = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    t_roc, roc = cuda_ms(lambda: RocInvertedLists(index.invlists, device="cuda"))
    index.replace_invlists(roc)
    D1, I1 = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    torch.cuda.synchronize()
    launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches}
    # ----

    if I1.shape != (NQ, K) or D1.shape != (NQ, K):
        raise AssertionError(f"result shapes {tuple(I1.shape)}, {tuple(D1.shape)}")
    if not bool(torch.isfinite(D1).all()) or int(I1.min()) < 0 or int(I1.max()) >= NB:
        raise AssertionError("non-finite distances or ids out of range")
    if not torch.equal(I1.sort(dim=1).values, I0.sort(dim=1).values):
        raise AssertionError("ROC search rows differ from the uncompressed search")
    torch.testing.assert_close(D1, D0, rtol=1e-4, atol=1e-3)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    bits_per_id = roc.compressed_ids_size_in_bytes * 8 / index.ntotal
    lengths = index.invlists.lengths
    log(f"[main] IVF{NLIST},Flat over {index.ntotal} ids (list lengths "
        f"{lengths.min()}..{lengths.max()}, mean {lengths.mean():.0f}): ROC search == "
        f"uncompressed search on {NQ} queries (sorted I rows equal, D within "
        f"rtol 1e-4 atol 1e-3); launches {launches}")
    log(f"[main] bits/id {bits_per_id:.4f} (ROC {roc.compressed_ids_size_in_bytes} bytes "
        f"for {index.ntotal} ids; 64 bits/id uncompressed)")

    # exact search on the side: full probe on a few queries vs brute force
    xq_d = torch.from_numpy(xq).cuda()
    xb_d = torch.from_numpy(xb).cuda()
    d2 = (xq_d * xq_d).sum(1, keepdim=True) + (xb_d * xb_d).sum(1)[None] - 2.0 * xq_d @ xb_d.T
    D_bf, I_bf = torch.topk(d2, K + 1, dim=1, largest=False)
    recall = float((I1[:, :, None] == I_bf[:, None, :K]).any(2).float().mean())
    I_bf = I_bf[:, :K]
    Df, If = index.search(xq[:32], K, nprobe=NLIST)
    torch.testing.assert_close(Df, D_bf[:32, :K], rtol=1e-4, atol=1e-3)
    tie = (D_bf[:32, K] - D_bf[:32, K - 1]).abs() <= 1e-3 + 1e-4 * D_bf[:32, K].abs()
    same = (If.sort(1).values == I_bf[:32, :K].sort(1).values).all(1)
    if not bool((same | tie).all()):
        raise AssertionError("full-probe search differs from brute force")
    log(f"[main] full probe == brute force on 32 queries; recall@{K} of nprobe={NPROBE} "
        f"vs brute force: {recall:.4f}")
    del xb_d, d2

    t_pos = median_ms(lambda: index.search_positional(xq, K, NPROBE))
    _, L = index.search_positional(xq, K, NPROBE)
    t_tr = median_ms(lambda: index._translate(L))
    t_search = median_ms(lambda: index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE))
    touched = int(torch.unique(L[L >= 0] >> 32).numel())
    log(f"[main] CUDA-event ms: train {t_train:.1f}, add {t_add:.1f}, ROC encode "
        f"(container build) {t_roc:.1f}; search ({NQ} queries, median of 5) "
        f"{t_search:.2f} = positional {t_pos:.2f} + translate {t_tr:.2f} "
        f"({touched} touched lists decoded)")
    return index, roc, launches, I_bf[:, :K]


def recalls(I, I_bf):
    """(recall@1: the true nearest neighbour ranked first, as the JAX graph
    bench's R@1; recall@10: the share of the true top 10 found)."""
    r1 = float((I[:, 0] == I_bf[:, 0]).float().mean())
    r10 = float((I[:, :, None] == I_bf[:, None, :]).any(2).float().mean())
    return r1, r10


def phase_graph(xb, xq, I_bf):
    """NSG R=32 over the [main] database, the two ROC graphs, and the search
    with all three containers, through the user-facing entry points. Returns
    (the graph, the two ROC graphs, this phase's launch counts, the nearest
    node found per query: one fetch's worth of nodes for the timing)."""
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
    from vector_db_id_compression_tpu_torch.search.nsg import build_nsg, search_graph
    from vector_db_id_compression_tpu_torch.store.graph import RocBlockGraph, RocGraph

    xb_d = torch.from_numpy(xb).cuda()
    xq_d = torch.from_numpy(xq).cuda()
    # ---- the graph path; the kernels' launch counts are read from this
    # window only
    RocEncoder.launches = RocEncoder.chained_launches = 0
    RocDecoder.launches = RocDecoder.chained_launches = 0
    t0 = time.perf_counter()
    g, medoid = build_nsg(xb_d, R=GRAPH_R, progress=True)
    torch.cuda.synchronize()
    t_nsg = time.perf_counter() - t0
    edges = int(g.degrees.sum())
    t_roc, roc = cuda_ms(lambda: RocGraph(g))
    t_blk, blk = cuda_ms(lambda: RocBlockGraph(g, block=GRAPH_BLOCK))
    results, capped = {}, {}
    for name, container in (("Graph", g), ("RocGraph", roc), ("RocBlockGraph", blk)):
        before = RocDecoder.launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results[name] = search_graph_device(container, xb_d, xq_d, k=K, entry=medoid)
        torch.cuda.synchronize()
        capped[name] = any("max_iters" in str(w.message) for w in caught)
        if name == "RocGraph":
            hops = RocDecoder.launches - before  # one decode launch per hop
    launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches,
                "roc_encode_chained": RocEncoder.chained_launches,
                "roc_decode_chained": RocDecoder.chained_launches}
    # ----

    log(f"[graph] NSG R={GRAPH_R} over {g.N} vectors on the card in {t_nsg:.1f} s: "
        f"{edges} edges (mean degree {edges / g.N:.2f}), medoid {medoid}")
    D0, I0 = results["Graph"]
    if I0.shape != (NQ, K) or not bool(torch.isfinite(D0).all()) or int(I0.min()) < 0:
        raise AssertionError("graph search: bad shape, non-finite distances or empty slots")
    for name, (D1, I1) in results.items():
        if not (torch.equal(I1, I0) and torch.equal(D1, D0)):
            raise AssertionError(f"graph search with {name}: I or D differs from the "
                                 "dense graph's")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the graph path was not launched: {launches}")
    log(f"[graph] search of {NQ} queries, k={K}, L={2 * K}, entry medoid: I and D "
        f"identical for Graph, RocGraph, RocBlockGraph(block={GRAPH_BLOCK}); "
        f"launches {launches}")
    # a second witness: the host-loop search (its own pool merge and visited
    # sets, held against the JAX package in tests/test_torch_graph.py) on the
    # first queries; D within rtol 1e-5, since its distance batches have
    # another shape than the device walk's
    t0 = time.perf_counter()
    Dh, Ih, _ = search_graph(g, xb_d, xq_d[:NQ_HOST], k=K, entry=medoid)
    t_host = time.perf_counter() - t0
    if not torch.equal(Ih, I0[:NQ_HOST]):
        raise AssertionError("host-loop search_graph differs from search_graph_device")
    torch.testing.assert_close(Dh, D0[:NQ_HOST], rtol=1e-5, atol=1e-5)
    log(f"[graph] host-loop search_graph on {NQ_HOST} queries ({t_host:.1f} s): I "
        f"identical to search_graph_device's, D within rtol 1e-5")
    for name, c, t in (("RocGraph", roc, t_roc), ("RocBlockGraph", blk, t_blk)):
        log(f"[graph] {name}: built in {t:.1f} ms (CUDA events), "
            f"compressed_ids_size_in_bytes {c.compressed_ids_size_in_bytes}, "
            f"overhead_in_bytes {c.overhead_in_bytes}, bits/edge "
            f"{c.compressed_ids_size_in_bytes * 8 / edges:.4f} "
            f"({(c.compressed_ids_size_in_bytes + c.overhead_in_bytes) * 8 / edges:.4f} "
            f"with the degrees; 32 for the raw int32 adjacency)")
    r1, r10 = recalls(I0, I_bf)
    log(f"[graph] {hops} hops (decode launches of one RocGraph search), max_iters "
        f"cap hit: {capped}; recall@1 {r1:.4f}, recall@{K} {r10:.4f} against brute force")
    times = {name: median_ms(lambda c=c: search_graph_device(c, xb_d, xq_d, k=K, entry=medoid))
             for name, c in (("Graph", g), ("RocGraph", roc), ("RocBlockGraph", blk))}
    log("[graph] search ms (CUDA events, median of 5 after a warm-up): "
        + ", ".join(f"{name} {t:.2f}" for name, t in times.items()))
    return g, roc, blk, launches, I0[:, 0]


def phase_probes(seed: int):
    """K3 and K4 on the card against their plain versions, on the inputs the
    probe files draw (seeded here). Returns the two kernels' JSON entries."""
    from vector_db_id_compression_tpu_torch.ops.probes import (
        STEPS, ProbeDecodeStep, ProbeGather, probe_decode_step_plain, probe_gather_plain)

    rng = np.random.default_rng(seed + 200)
    win = torch.from_numpy(rng.integers(0, 2**31, (256, 128)).astype(np.uint32).view(np.int32))
    idx = torch.zeros((256, 1), dtype=torch.int32)
    buf = torch.from_numpy(rng.integers(0, 2**31, (896, 256)).astype(np.int32))
    p = (torch.arange(256, dtype=torch.int32) % 17)[None, :]
    cuda = torch.device("cuda")
    args3, args4 = (win.to(cuda), idx.to(cuda)), (buf.to(cuda), p.to(cuda))
    # ---- the probes' own run; launch counts from this window only
    ProbeGather.launches = ProbeDecodeStep.launches = 0
    got3, got4 = ProbeGather.run(*args3), ProbeDecodeStep.run(*args4)
    torch.cuda.synchronize()
    launches = {"probe_gather": ProbeGather.launches,
                "probe_decode_step": ProbeDecodeStep.launches}
    # ----
    entries = []
    for name, got, plain_fn, args, cpu_args, run, src, replaces in (
            ("probe_gather", got3, probe_gather_plain, args3, (win, idx), ProbeGather.run,
             "probe_gather.cu", "tools/profiling/profile_pallas.py:20"),
            ("probe_decode_step", got4, probe_decode_step_plain, args4, (buf, p),
             ProbeDecodeStep.run, "probe_decode_step.cu", "tools/profiling/profile_pallas2.py:34")):
        if not torch.equal(got.cpu(), plain_fn(*cpu_args)):
            raise AssertionError(f"{name} kernel differs from its plain version on the CPU")
        ms = median_ms(lambda: run(*args))
        plain_ms, want = cuda_ms(lambda: plain_fn(*args))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} kernel differs from its plain version on the card")
        log(f"[probes] {name}: {STEPS} steps, kernel == plain (on the CPU and on the card), "
            f"kernel {ms:.4f} ms ({ms * 1e3 / STEPS:.4f} us/step; CUDA-event median of 5 "
            f"after a warm-up) vs plain {plain_ms:.1f} ms (one run on the card)")
        entries.append({"name": name, "route": "cuda",
                        "source": f"vector_db_id_compression_tpu_torch/csrc/{src}",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "us_per_step": ms * 1e3 / STEPS})
    return entries


def time_kernels(index, roc, launches):
    """Each kernel beside its plain version, on the card, at the main path's
    shapes: encode of every list of the index, decode of every list."""
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.store.invlists import roc_lane_table

    sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
    cuda = torch.device("cuda")
    ids_t = torch.from_numpy(sorted_ids.view(np.int64)).to(cuda)
    len_t, prec_t = torch.from_numpy(lengths).to(cuda), torch.from_numpy(prec).to(cuda)
    B, n_max = ids_t.shape
    maxp = int(prec.max())
    n_slices = rd.n_slices_for(maxp)
    pool = rd.default_pool(n_max, cuda)

    enc_ms = median_ms(lambda: RocEncoder.encode(ids_t, len_t, prec_t), reps=3)
    st_k, order_k = RocEncoder.encode(ids_t, len_t, prec_t)
    enc_plain_ms, (st_p, order_p) = cuda_ms(lambda: rd.roc_encode_batch(
        ids_t, len_t, prec_t, pool, rd.fresh_states(B, rd.stack_capacity(n_max, maxp), cuda),
        n_slices))
    enc_err = max_abs_err((*st_k, order_k), (*st_p, order_p))

    dec_ms = median_ms(lambda: roc.decoder.decode(), reps=3)
    ids_k = roc.decoder.decode()
    dec_plain_ms, (ids_p, _) = cuda_ms(lambda: rd.roc_decode_batch(
        st_k, len_t, prec_t, pool, n_max, n_slices))
    dec_err = max_abs_err(ids_k, ids_p)
    if enc_err or dec_err:
        raise AssertionError(f"kernel vs plain at the main path's shapes: encode "
                             f"{enc_err}, decode {dec_err}")
    max_len = int(lengths.max())
    log(f"[timing] {B} lists, n_max {n_max}: encode kernel {enc_ms:.3f} ms vs plain "
        f"{enc_plain_ms:.1f} ms; decode kernel {dec_ms:.3f} ms ({dec_ms * 1e3 / max_len:.4f} "
        f"us per step of the longest list, {max_len} steps) vs plain {dec_plain_ms:.1f} "
        f"ms (kernel: CUDA-event median of 3 after a warm-up; plain: one run on the card)")
    return [
        {"name": "roc_encode", "route": "cuda",
         "source": "vector_db_id_compression_tpu_torch/csrc/roc_encode.cu",
         "replaces": "vector_db_id_compression_tpu/ops/roc_encode_pallas.py:75",
         "launches": launches["roc_encode"], "max_abs_err": enc_err,
         "ms": enc_ms, "plain_ms": enc_plain_ms},
        {"name": "roc_decode", "route": "cuda",
         "source": "vector_db_id_compression_tpu_torch/csrc/roc_decode.cu",
         "replaces": "vector_db_id_compression_tpu/ops/roc_pallas.py:93",
         "launches": launches["roc_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms},
    ]


def time_graph_kernels(g, roc, blk, nodes, launches):
    """Both ROC kernels beside their plain versions at the graph path's
    shapes: the chained decode of one fetch (the block of one node per query)
    and of all 62,500 blocks, the chained encode of every block, the per-node
    encode of every node and the per-node decode of one fetch. Returns (the
    per-node kernels' graph-shape numbers by kernel, the chained kernels'
    JSON entries)."""
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.store.graph import neighbour_table

    dec = blk.decoder
    n_blocks, Kg = dec.states.head.shape[0], g.K
    adj = torch.full((n_blocks * GRAPH_BLOCK, Kg), -1, dtype=torch.int32, device=g.device)
    adj[: g.N] = g.adjacency
    sorted_ids, degs, prec = neighbour_table(adj, empty_precision=1)
    ids3 = sorted_ids.reshape(n_blocks, GRAPH_BLOCK, Kg)
    degs = degs.reshape(n_blocks, GRAPH_BLOCK)
    prec = prec.reshape(n_blocks, GRAPH_BLOCK)
    maxp = int(prec.max())
    n_slices, pool = rd.n_slices_for(maxp), rd.default_pool(GRAPH_BLOCK * Kg, g.device)

    enc_ms = median_ms(lambda: RocEncoder.encode_chained(ids3, degs, prec), reps=3)
    st_k = RocEncoder.encode_chained(ids3, degs, prec)
    enc_plain_ms, st_p = cuda_ms(lambda: rd.roc_encode_chained(
        ids3, degs, prec, pool,
        rd.fresh_states(n_blocks, rd.stack_capacity(GRAPH_BLOCK * Kg, maxp), g.device),
        n_slices))
    enc_err = max(max_abs_err(tuple(st_k), tuple(st_p)),
                  max_abs_err(tuple(st_k), tuple(dec.states)))

    blocks = nodes // GRAPH_BLOCK
    fetch_ms = median_ms(lambda: dec.decode_lanes(blocks))
    sub = rd.RocStates(*(t[blocks] for t in dec.states))
    fetch_plain_ms, (ids_p, _) = cuda_ms(lambda: rd.roc_decode_chained(
        sub, degs[blocks], prec[blocks], pool, Kg, n_slices))
    fetch_err = max_abs_err(dec.decode_lanes(blocks), ids_p)
    all_ms = median_ms(lambda: dec.decode(), reps=3)
    all_plain_ms, (all_p, _) = cuda_ms(lambda: rd.roc_decode_chained(
        dec.states, degs, prec, pool, Kg, n_slices))
    dec_err = max(fetch_err, max_abs_err(dec.decode(), all_p))
    if enc_err or dec_err:
        raise AssertionError(f"chained kernels vs plain at the graph's shapes: encode "
                             f"{enc_err}, decode {dec_err}")

    # the per-node kernels of RocGraph: encode of every node, decode of one
    # fetch; both against the plain version and the container's own streams
    ids_n, degs_n, prec_n = neighbour_table(g.adjacency, empty_precision=0)
    maxp_n = int(prec_n.max())
    slices_n, pool_n = rd.n_slices_for(maxp_n), rd.default_pool(Kg, g.device)
    node_enc_ms = median_ms(lambda: RocEncoder.encode(ids_n, degs_n, prec_n), reps=3)
    st_nk, _ = RocEncoder.encode(ids_n, degs_n, prec_n)
    node_enc_plain_ms, (st_np, _) = cuda_ms(lambda: rd.roc_encode_batch(
        ids_n, degs_n, prec_n, pool_n,
        rd.fresh_states(g.N, rd.stack_capacity(Kg, max(maxp_n, 1)), g.device), slices_n))
    node_enc_err = max(max_abs_err(tuple(st_nk), tuple(st_np)),
                       max_abs_err(tuple(roc.decoder.states), tuple(st_np)))
    lane_ms = median_ms(lambda: roc.decoder.decode_lanes(nodes))
    sub_n = rd.RocStates(*(t[nodes] for t in st_np))
    lane_plain_ms, (lane_p, _) = cuda_ms(lambda: rd.roc_decode_batch(
        sub_n, degs_n[nodes], prec_n[nodes], pool_n, Kg, slices_n))
    lane_err = max_abs_err(roc.decoder.decode_lanes(nodes), lane_p)
    if node_enc_err or lane_err:
        raise AssertionError(f"per-node kernels vs plain at the graph's shapes: encode "
                             f"{node_enc_err}, decode {lane_err}")
    steps = int(degs[blocks].sum(dim=1).max())
    log(f"[timing] graph, {n_blocks} blocks of {GRAPH_BLOCK} nodes, K {Kg}: chained encode "
        f"kernel {enc_ms:.3f} ms vs plain {enc_plain_ms:.1f} ms; chained decode of one "
        f"fetch ({blocks.numel()} blocks, {fetch_ms * 1e3 / steps:.4f} us per step of the "
        f"longest block, {steps} steps) kernel {fetch_ms:.3f} ms vs plain "
        f"{fetch_plain_ms:.1f} ms, of all {n_blocks} blocks kernel {all_ms:.3f} ms vs "
        f"plain {all_plain_ms:.1f} ms (kernel: CUDA-event median after a warm-up; plain: "
        f"one run on the card)")
    log(f"[timing] graph, RocGraph, {g.N} nodes, K {Kg}: per-node encode kernel "
        f"{node_enc_ms:.3f} ms vs plain {node_enc_plain_ms:.1f} ms; per-node decode of one "
        f"fetch ({nodes.numel()} lanes) kernel {lane_ms:.3f} ms vs plain "
        f"{lane_plain_ms:.1f} ms; both == plain == the container's streams")
    per_node = {"roc_encode": {"max_abs_err": node_enc_err, "graph_ms": node_enc_ms,
                               "graph_plain_ms": node_enc_plain_ms},
                "roc_decode": {"max_abs_err": lane_err, "graph_fetch_ms": lane_ms,
                               "graph_fetch_plain_ms": lane_plain_ms}}
    return per_node, [
        {"name": "roc_encode_chained", "route": "cuda",
         "source": "vector_db_id_compression_tpu_torch/csrc/roc_encode.cu",
         "replaces": "vector_db_id_compression_tpu/codecs/roc_device.py:341",
         "launches": launches["roc_encode_chained"], "max_abs_err": enc_err,
         "ms": enc_ms, "plain_ms": enc_plain_ms},
        {"name": "roc_decode_chained", "route": "cuda",
         "source": "vector_db_id_compression_tpu_torch/csrc/roc_decode.cu",
         "replaces": "vector_db_id_compression_tpu/ops/roc_pallas.py:376",
         "launches": launches["roc_decode_chained"], "max_abs_err": dec_err,
         "ms": fetch_ms, "plain_ms": fetch_plain_ms,
         "all_blocks_ms": all_ms, "all_blocks_plain_ms": all_plain_ms},
    ]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()

    name = phase_device()
    import vector_db_id_compression_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        sys.exit("chip_smoke: run from a checkout that holds vector_db_id_compression_tpu_torch")
    phase_build()
    phase_kernels(args.seed)
    t0 = time.perf_counter()
    xt, xb, xq = make_data(args.seed)
    log(f"[main] data: {NT} train, {NB} database, {NQ} query vectors of d={D} "
        f"(seed {args.seed}) in {time.perf_counter() - t0:.1f} s on the host")
    index, roc, main_launches, I_bf = phase_main(xt, xb, xq)
    g, roc_g, blk, graph_launches, nodes = phase_graph(xb, xq, I_bf)
    probes = phase_probes(args.seed)
    per_node, chained = time_graph_kernels(g, roc_g, blk, nodes, graph_launches)
    kernels = time_kernels(index, roc, main_launches) + chained + probes
    # a kernel that both paths run counts its launches in both, and its error
    # is the larger of its two paths'
    for entry in kernels[:2]:
        name_ = entry["name"]
        entry["launches"] = main_launches[name_] + graph_launches[name_]
        entry["launches_by_phase"] = {"main": main_launches[name_],
                                      "graph": graph_launches[name_]}
        extra = per_node[name_]
        entry.update(extra, max_abs_err=max(entry["max_abs_err"], extra["max_abs_err"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

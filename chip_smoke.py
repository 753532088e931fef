#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths (``vector_db_id_compression_tpu_torch``) once
each, at SIFT1M's shape: 1,000,000 synthetic database vectors of d = 128
(float32) and 1000 queries, k = 10. The IVF paths: an IVF with 1024 lists,
nprobe = 16, the ids of every inverted list ROC-compressed and decoded only
after the top-k is final (deferred id decoding), once with flat payload and
once with 16-byte PQ codes (IVF1024,PQ16) and the long lists' ids coded as
interleaved chunk lanes; and the flat index with the paper's other id codecs
(packed bits, Elias-Fano, wavelet tree) translated by random access. The
graph path: an NSG graph of degree R = 32 over the same database, searched on
the card with its adjacency dense, ROC-compressed per node, ROC-compressed in
chained blocks of 16 nodes, packed in fixed-width fields and Elias-Fano
coded, decoded inside the traversal. Then every index, container and graph
of those paths goes through the artifact format: saved, stamped, verified,
loaded onto the card and searched again. The HNSW path: IVF65536_HNSW32,Flat
over the same database (an HNSW of M = 32 over the 65,536 centroids as the
coarse quantizer, nprobe = 64), with the ids ROC-compressed per list and the
quantizer's level-0 graph in the five containers. The QINCo path:
IVF65536,QINCo16x8 over the same database (a neural residual codec of 16
one-byte codes per vector), a shortlist of 100 at nprobe 64 with raw ids and
with each of the six id containers, re-ranked through the codec's decoder. The sharded path: the flat and PQ
indexes searched through ``parallel/`` on torch.distributed, first as one
NCCL rank, then as four gloo ranks sharing the card. Phases:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds the kernels from csrc/ (one process per source)
  3. kernels  each ROC kernel against its plain torch version on seeded
              batches: 256 lists (lengths 1..1500), and 64 lanes of 16
              chained slots (lengths 0..32); ids up to 2^20 and 2^32 - 1;
              and 3 lists with one of 30,000 ids below 2^40, past both
              kernels' shared-memory threshold, so that each runs its
              global-memory layout; bit-equal or the run fails
  4. main     train, add, search uncompressed, swap in the ROC container,
              search again; the ROC search must return the uncompressed
              search's rows (ids are lossless); both kernels must have been
              launched by that path; the full-probe search (nprobe 1024,
              every size bucket through the dense all-pairs scan) must equal
              brute force on the 1000 queries up to ties; two more k-means
              trainings at the index's shape must give its centroids bit
              for bit (the sum per cluster is in a fixed order); then bits/id and
              phase times, and each search under torch.profiler (wall and
              device ms, idle share, the kernels with the most device time)
  5. codecs   the paper's other IVF id codecs on main's index: packed bits,
              Elias-Fano and the wavelet tree with plain and with RRR planes,
              each built on the card; every list recovered by decode_lists,
              and the search with either translate (random access, grouped)
              identical to the uncompressed search in I and D; then bits/id
              (payload and overhead), build ms, each translate's ms and device
              launches (torch.profiler), search ms. Plain torch: no kernel of
              this path is written by hand
  6. pq       IVF1024,PQ16: train, add, search uncompressed (the decoded-
              reconstruction scan), swap in RocInvertedLists and then
              InterleavedRocInvertedLists and search each, then the LUT scan
              over the interleaved container: each equal to the uncompressed
              search under the near-tie rule (D within tolerance, labels
              differ only where D ties: equal codes tie exactly and ROC
              reorders them); every list's ids recovered by the interleaved
              decode; both kernels launched in this phase; then bits/id,
              recall and times (profiled as in main)
  7. graph    build_nsg on the card, the two ROC graphs, the compact-bit and
              Elias-Fano graphs, and the search with each of the five
              containers: identical I and D or the run fails; every ROC
              kernel must have been launched by this phase; the host-loop
              search (search_graph, a separate walk) must give
              the same I on 32 queries; then bits/edge (with REC's, the
              Polya-urn model of codecs/rec.py, beside the ROC graphs'), hops,
              recall and search times
  8. serialize  the artifact format on what the earlier phases built: the
              flat index (save_index) with its ROC, packed-bits, Elias-Fano
              and both wavelet-tree containers, the PQ16 index with its
              RocInvertedLists and interleaved containers, and the five NSG
              graphs (save_invlists, save_graph); each file stamped and
              verified, loaded onto the card (the index into a fresh
              IndexIVF, each container swapped in with replace_invlists) and
              searched: I and D identical to the search before the save, the
              loaded ROC states equal to the built ones, and each loaded
              object written again byte-equal to its file, or the run fails;
              the decode kernel runs on the loaded states; then file bytes,
              save, stamp, verify, load and search ms (a loaded graph's
              beside its built graph's, timed in turns), and bits/id (or
              bits/edge) after the round trip
  9. parallel one NCCL rank on the card (multihost.initialize, world size
              1): the sharded ROC encode of main's 1024 lists (bit-equal to
              the container's states), the sharded decode (every list
              recovered) and the size psum (the host sum), and ShardedIVF
              over main's index with the raw lists and each of the six
              containers and over pq's index with RocInvertedLists (decoded
              and LUT scans), each equal to the unsharded search under the
              near-tie rule (D within 1e-5 relative), with the four stages'
              times; then four gloo ranks sharing the card, each its own
              process, loading the flat index and its ROC container from
              files, encoding its quarter of the lists and searching: the
              gathered states bit-equal to the one rank's, (D, I) the one
              rank's under the near-tie rule, both kernels launched in every
              rank; each rank's peak device memory and times
 10. hnsw     IVF65536_HNSW32,Flat: k-means over 2^21 training vectors of
              the same mixture (32 per centroid), the HNSW quantizer built
              over the centroids on the card, add through it, search with
              the uncompressed lists and RocInvertedLists, the level-0 graph
              as the five containers and HNSW.search through each; it fails
              unless the ROC search equals the uncompressed one, every vector
              lies in exactly one list, its HNSW top-1 (the exact nearest
              centroid for a miss), the device walk equals the host oracle
              (greedy descent, host search_graph per query) on 32 queries
              up to near ties, the five level-0 searches are identical, every
              ROC kernel ran, and the HNSW (save_hnsw) and the index
              (save_index) loaded search as before; then the build, add and
              search times (the coarse walk with its hops, the scan, the
              translate; the flat quantizer beside), bits/id and bits/edge,
              recall and the probes' overlap with the exact top 64
 11. qinco    IVF65536,QINCo16x8 (M 16, ksub 256, hidden 256; the paper's
              Table 4 point, cut to the 10^6 database): [hnsw]'s centroids,
              the codec trained on its training vectors' residuals (RQ init,
              300 Adam steps of 256), add (encode), the search with
              return_codes=2 and a shortlist of 100 at nprobe 64, re-ranked
              through the neural decoder, then the same with each of the six
              id containers of AVAILABLE_COMPRESSED_IVFS (packed bits, ROC,
              Elias-Fano, the wavelet tree plain and RRR, interleaved ROC;
              translated by random access but for ROC, as search_ivf_qinco
              runs them); it fails unless each container's search returns
              the uncompressed shortlist (ids and codes) and the same
              re-ranked ids, every list's ids come back from each
              container, both ROC kernels ran, the card's encode and decode
              equal the CPU's on 4096 vectors (codes but for near ties,
              decode within 1e-4), and the index saved and loaded searches
              and re-ranks as before; then each container's bits/id, build,
              translate and search ms and its ROC kernel launches, the
              training, encode, add and search times (positional, harvest,
              translate, re-rank), recall of the
              re-ranked and the linear ranking, the idle share, the file
 12. bench    the experiment drivers of bench/ (the JAX package's bench/),
              each through its main() on the card, outputs in a temporary
              directory: P1 (bench_invlists, IVF1024,Flat over 10^6 vectors
              of d 32, the six id methods at nprobe 1, 4, 16) and the codec
              alone at 10^7 ids in 65,536 lists (codec_scale) and P2
              (graph_dynamic_bench, NSG R 32 over 10^6, five containers)
              at the JAX package's recorded runs' sizes; P3 and P4 (graph_static_bench,
              generate_graph_edgelists), hnsw_bench, P5 (search_ivf_qinco:
              train, add, search with raw and ROC ids), wt_translate_bench
              (plain and RRR planes), quantizer_bench, search_100m (all
              seven id containers) and scaling (one rank) cut to sizes
              that fit (BENCH_ARGS). Gates:
              the drivers' own checks (round trips, oracles, invariance),
              recall equal across a driver's id containers, 64 bits/id
              for P1's raw lists and fewer for every id codec, search_100m's
              packed bits at its width plus list padding and every other
              codec below, the ROC
              shortlist and re-rank of P5 equal the uncompressed ones, the
              ROC kernels launched by every driver that reaches them (in
              search_100m, by roc and by roc-interleaved), and 256 of codec_scale's lanes
              through both kernels equal to their plain versions
 13. probes   the two decode-step probes against their plain versions on
              the CPU and on the card, then each kernel's own time (its
              launches queued behind a spin of the card) and its wrapper
              call's (with the input checks), K4 at 1, 275, 550 and 1100
              steps, and the clock64() readings that bound a step of each:
              a dependent shared load, two rank links (a compare, a warp
              reduction of counts or a ballot and its count, an add), and
              the SM clock
 14. chain    the chain probe (the codec's serial chain, no rank or select
              work, one lane on one thread) over the flat index's longest
              list, against the codec's streams and its plain version: the
              time of a step of the chain, the floor of a step of both ROC
              kernels
 15. timing   each kernel beside its plain version at its paths' shapes:
              both ROC kernels at the IVF shapes, over the PQ index's chunk
              entries, at the graph's (per node and chained), at [hnsw]'s
              (its 65,536 lists, its level-0 graph) and at [qinco]'s (its
              65,536 lists, the lists one search touches), bit-equal
              or the run fails; the native host codec over the PQ index's
              1024 lists, equal to the kernels' streams or the run fails;
              then one line per kernel with its time, its bound, its chain
              bound (the longest lane's steps times the chain probe's step)
              and its launches per search or build

The line before the last is a JSON object with each kernel's launch count
(from the phases that drive it, counted from 0 just before each), its error
against the plain version, its time beside the plain version's, its bound
(``bound_ms``: the larger of the bytes it must move over the H100's 3.35
TB/s and its operations over the 67 T/s scalar rate, from this run's inputs;
``bound_by`` says which), ``ms_timed`` (``call``: ``ms`` timed the
wrapper's call, as for the ROC kernels; ``launch``: the launch alone, queued
behind a spin of the card, as for the probes), for the probes
``latency_bound_ms`` (their dependent steps times a step's least latency) and
``call_ms`` (the wrapper's call with its input checks), for the ROC kernels
``chain_bound_ms``, ``launches_by_phase`` (``bench``: the experiment
drivers' launches) and
``library_ms`` (null: no single PyTorch call
decodes or encodes an ROC stream); the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device, or outside a checkout of the
repository, it exits nonzero and prints no result.

Usage: python3 chip_smoke.py [--seed N] (the [parallel] phase starts its four
ranks as ``chip_smoke.py --parallel-rank R --parallel-dir DIR``)
"""

import argparse
import io
import json
import subprocess
import sys
import tempfile
import time
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

NB, NT, NQ, D = 1_000_000, 100_000, 1000, 128
NLIST, K, NPROBE = 1024, 10, 16
PQ_M = 16
GRAPH_R, GRAPH_BLOCK = 32, 16
NQ_HOST = 32  # queries the host-loop search checks the device walk on
# [hnsw]: IVF65536_HNSW32,Flat, Faiss's index guideline for 1M-10M vectors,
# the JAX package's quantizer defaults (M 32, efSearch 64); 32 training
# vectors per centroid (Faiss asks for at least 30)
HNSW_NLIST, HNSW_NPROBE, HNSW_M, HNSW_EF = 65536, 64, 32, 64
HNSW_NT = 2 ** 21
# [qinco]: IVF65536,QINCo16x8 at nprobe 64, shortlist 100 (the paper's Table 4
# BigANN10M point, IVF65k_16x8; the JAX package's own run of it: M 16, ksub
# 256, hidden 256, 300 Adam steps of its default batch of 256); the card's
# codec is held against the CPU's on QINCO_CHECK vectors
QINCO_M, QINCO_KSUB, QINCO_HIDDEN, QINCO_STEPS, QINCO_BATCH = 16, 256, 256, 300, 256
QINCO_NPROBE, QINCO_NSHORT, QINCO_CHECK = 64, 100, 4096
# [parallel]: gloo ranks sharing the one card (NCCL takes one rank per card),
# and how long they may take
PARALLEL_RANKS, PARALLEL_TIMEOUT_S = 4, 600
# [bench]: the experiment drivers' arguments. P1 and the codec at the JAX
# package's recorded runs (results/bench_invlists_synthetic1m_tpu.csv: d 32,
# 10^6 vectors, IVF1024,Flat; results/codec_scale_tpu.jsonl row 1: 10^7 ids in
# 65,536 lists, JAX_CODEC_SCALE_BITS bits/id); P2 at the 10^6 of
# results/graph_dynamic_bench_synthetic1m_tpu.csv; P3, P4 and HNSW at the JAX
# runs' nb = 4000, P5 at results/search_ivf_qinco_synthetic100k_tpu.json's;
# the rest cut to the phase's budget (their full runs: chip_bench.sh)
BENCH_SEED = 7  # codec_scale's --seed
JAX_CODEC_SCALE_BITS = 18.4686
BENCH_ARGS = {
    "bench_invlists": ["--synth_scale", "10", "--index", "IVF1024,Flat",
                       "--nprobe", "1", "4", "16", "--runs", "5"],
    "codec_scale": ["--ntotal", "10000000", "--nlist", "65536", "--runs", "3"],
    "codec_scale_sample": (10_000_000, 65536, 512),
    "graph_dynamic_bench": ["--synth_scale", "10", "--max-degree", "32", "--runs", "3"],
    "graph_static": ["--synth_scale", "0.04", "--max-degree", "16"],
    "hnsw_bench": ["--synth_scale", "0.04", "--M", "16"],
    "search_ivf_qinco": ["--synth_scale", "1", "--nlist", "256", "--M", "8", "--hidden", "128",
                         "--qinco_steps", "300"],
    "search_ivf_qinco_search": ["--nprobe", "32", "--nshort", "100", "--k", "100"],
    "wt_translate_bench": ["--ntotal", "1000000", "--nlist", "8192", "--runs", "3"],
    "quantizer_bench": ["--nlist", "8192", "--runs", "3"],
    "search_100m": ["--ntotal", "1000000", "--nlist", "4096", "--runs", "3"],
    "scaling": ["--devices", "1", "--runs", "3"],
}
# the H100 SXM's peaks (NVIDIA's data sheet): HBM bytes/s, and float32
# operations/s outside the tensor cores, the table's scalar rate, for the
# kernels' integer compares
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# the latency of one dependent shared-memory load on Hopper, in SM cycles
# (Luo et al., "Benchmarking and Dissecting the Nvidia Hopper GPU
# Architecture", 2024); the probes' bounds take the lesser of it and the
# card's own clock64() reading (probe_latency_bounds)
SHARED_LOAD_CYCLES = 29
# spin cycles (torch.cuda._sleep, about 1 ms) queued before a kernel's timed
# launches, so that the host's launch time hides behind it
SPIN_CYCLES = 2_000_000


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


def kernel_ms(fn, launches: int = 10, reps: int = 5) -> float:
    """The card's ms per call of ``fn``: CUDA events around ``launches``
    back-to-back calls queued behind a spin of the card, so that the events
    time the kernels and not the host's launches (median of ``reps``, after
    a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def host_s(fn):
    """(host-clock seconds of ``fn`` synchronised with the card, its result)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def timed(spans: dict, name: str, fn):
    """``fn`` wrapped to add its host-clock seconds (synchronised with the
    card) to ``spans[name]``."""
    def run(*args, **kwargs):
        t, out = host_s(lambda: fn(*args, **kwargs))
        spans[name] = spans.get(name, 0.0) + t
        return out
    return run


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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` and does ``ops`` operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def order_stat_ops(lens) -> float:
    """Operations of the order statistics that ROC coding of lists of
    ``lens`` needs, whatever a kernel's own method: ceil(log2 n) per step of
    a list of n, as the native host codec's insert-rank treap (decode) and
    Fenwick select (encode) take (native/roc_native.cpp)."""
    lens = lens.to(torch.float64)
    return float((lens * torch.log2(lens.clamp(min=1)).ceil()).sum())


def decode_bound(decoder, idx):
    """Bound of decoding the lanes ``idx`` of ``decoder``: the lanes' heads,
    stack words, counters, lengths and precisions read once, the ids
    i64[Q, S, n_max] written once; operations: ``order_stat_ops``."""
    st = decoder.states
    lens = decoder.lengths.reshape(st.head.shape[0], -1)[idx].to(torch.int64)
    Q, S = lens.shape
    nbytes = (Q * (8 + 4 + 4 + 8 + 4) + Q * S * 8 + 4 * int(st.stack_len[idx].sum())
              + Q * S * decoder.n_max * 8)
    return bound(nbytes, order_stat_ops(lens))


def encode_bound(lengths, states, n_max: int, with_order: bool):
    """Bound of encoding lanes of ``lengths`` i32[B] or [B, S]: their ids
    (8 bytes each), lengths and precisions read once; heads, stack words,
    counters and the sampling order written once; operations:
    ``order_stat_ops``."""
    lens = lengths.reshape(lengths.shape[0], -1).to(torch.int64)
    B, S = lens.shape
    nbytes = (8 * int(lens.sum()) + 8 * B * S + B * (8 + 4 + 4 + 4)
              + 4 * int(states.stack_len.sum()) + (4 * B * n_max if with_order else 0))
    return bound(nbytes, order_stat_ops(lens))


def longest_steps(lengths, idx=None) -> int:
    """Steps of the longest lane of ``lengths`` i32[L] or [L, S] (the slots
    of a chained lane in turn), over the lanes ``idx`` or all."""
    lens = lengths.reshape(lengths.shape[0], -1)
    lens = lens if idx is None else lens[idx]
    return int(lens.sum(dim=1).max())


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, work, ms_timed="call",
                 **extra):
    """One kernel's entry of the JSON line (``work`` = (bound_ms,
    bound_by)). ``ms_timed`` says what ``ms`` timed: ``call``, the wrapper's
    call (CUDA events around one call, ``median_ms``), or ``launch``, the
    launch alone (``kernel_ms``)."""
    return {"name": name, "route": "cuda",
            "source": f"vector_db_id_compression_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "ms_timed": ms_timed, "plain_ms": plain_ms, "bound_ms": work[0],
            "bound_by": work[1], "library_ms": None, **extra}


def assert_near_ties(what, D_got, I_got, D_ref, I_ref, rtol, atol):
    """D within rtol/atol, and a label may differ from the reference's only
    where the reference's distance ties (within the tolerance) with its
    neighbour in the row, or at the last slot with the other's distance."""
    D_got, I_got, D_ref, I_ref = (t.cpu() for t in (D_got, I_got, D_ref, I_ref))
    torch.testing.assert_close(D_got, D_ref, rtol=rtol, atol=atol)

    def close(a, b):
        return (a - b).abs() <= atol + rtol * b.abs()

    k = I_ref.shape[1]
    for i, j in torch.nonzero(I_got != I_ref).tolist():
        left = j > 0 and bool(close(D_ref[i, j], D_ref[i, j - 1]))
        right = bool(close(D_ref[i, j], D_ref[i, j + 1] if j + 1 < k else D_got[i, j]))
        if not (left or right):
            raise AssertionError(f"{what}: query {i} slot {j}: label differs without a near tie")
    return int((I_got != I_ref).sum())


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

    # a lane past the shared-memory threshold: both kernels' global layout
    from vector_db_id_compression_tpu_torch.ops import _build
    from vector_db_id_compression_tpu_torch.ops.roc_encode import encode_layout

    ids, lengths, prec = long_batch(seed)
    n_max = ids.shape[1]
    enc_bytes, enc_shared = encode_layout(n_max)
    st_k, order_k = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    dec = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda), rd.default_pool(n_max, cuda), n_max)
    sym_bytes, dec_bytes, warps = dec.layout()
    if enc_shared or warps:
        raise AssertionError("the long batch did not take both kernels' global layout")
    ids_k = dec.decode()
    torch.cuda.synchronize()
    st_p, order_p = RocEncoder.encode(ids, lengths, prec)
    for field, got, want in zip(st_k._fields, st_k, st_p):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"ROC encode kernel, global layout: {field} differs")
    if not torch.equal(order_k.cpu(), order_p):
        raise AssertionError("ROC encode kernel, global layout: order differs")
    ids_p = RocDecoder(st_p, lengths, prec, rd.default_pool(n_max), n_max).decode()
    if not torch.equal(ids_k.cpu(), ids_p):
        raise AssertionError("ROC decode kernel, global layout: ids differ")
    for b, n in enumerate(lengths.tolist()):
        if not torch.equal(ids_p[b, :n].sort().values, ids[b, :n]):
            raise AssertionError(f"ROC decode, global layout: lane {b} is not its id set")
    limit = _build.SHARED_BYTES_PER_BLOCK
    log(f"[kernels] {len(lengths)} lists, lengths {lengths.tolist()}, precision "
        f"{int(prec.min())}..{int(prec.max())}, past the shared-memory threshold "
        f"({limit} bytes per block): encode in the global layout ({enc_bytes} bytes a lane, "
        f"{32 * enc_bytes} per block of 32), decode in the global layout ({dec_bytes} bytes "
        f"a lane, u{8 * sym_bytes} symbols); encode kernel == plain (head, stack, "
        f"stack_len, mt_ctr, order), decode kernel == plain == input ids; max_abs_err 0")


def long_batch(seed: int):
    """3 lists, one of 30,000 ids below 2^40 (u64 symbols): past the
    encode's shared-memory threshold (about 29,000 ids) and the decode's
    (about 17,000 at this precision)."""
    from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe

    rng = np.random.default_rng(seed + 300)
    sizes = [30000, 2, 700]
    ids = np.zeros((len(sizes), max(sizes)), np.uint64)
    prec = np.zeros(len(sizes), np.int32)
    for b, n in enumerate(sizes):
        v = np.sort(rng.choice(2**40 - 1, size=n, replace=False).astype(np.uint64) + 1)
        ids[b, :n] = v
        prec[b] = precision_for_max_id_safe(int(v[-1]))
    return (torch.from_numpy(ids.view(np.int64)), torch.from_numpy(np.array(sizes, np.int32)),
            torch.from_numpy(prec))


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


# SHA-256 of the arrays this script drew with its own copy of the mixture
# before it took bench/datasets.py, at seed 7 (train, database, query,
# [hnsw]'s training set): the port's SyntheticDataset must give them bit for
# bit, so that every phase's numbers stay comparable with earlier runs
DATA_SHA256 = {
    "xt": "8c06ea1cbd41cdc3d8f1548d8707c30ef871d3e2b7768876c32845029f444aff",
    "xb": "a5216d0c25992c479a517a79a0fe1740d6e37208345431d22696b0691d063ba7",
    "xq": "c0ba7c1fa3b3fed0924fee77c420c4ffb758146bf23fea5fa0fcd61372997345",
    "xt_hnsw": "34e8cf3d60183bf11f18e998d74137d9e9f766c1eae6c508b222c1396bbf335d",
}


def make_data(seed: int):
    """The port's SyntheticDataset at SIFT1M's shape (the JAX package's
    mixture: 32 centres scaled by 4, unit noise; training, database and
    query sets drawn with seed + 1, + 2, + 3) and [hnsw]'s 2^21 training
    vectors of the same mixture (seed + 4). At seed 7 each array must hash
    to ``DATA_SHA256``. Returns (xt, xb, xq, xt_hnsw)."""
    import hashlib

    from vector_db_id_compression_tpu_torch.bench.datasets import SyntheticDataset

    ds = SyntheticDataset(D, NT, NB, NQ, seed=seed, device="cuda")
    arrays = {"xt": ds.get_train(), "xb": ds.get_database(), "xq": ds.get_queries(),
              "xt_hnsw": ds.draw(HNSW_NT, seed + 4)}
    if seed == 7:
        for name, a in arrays.items():
            if hashlib.sha256(a.tobytes()).hexdigest() != DATA_SHA256[name]:
                raise AssertionError(f"SyntheticDataset's {name} is not the array of earlier runs")
    return tuple(arrays.values())


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
    kmeans_reproducible(xt, index.centroids)

    # exact search on the side: full probe on a few queries vs brute force
    xq_d = torch.from_numpy(xq).cuda()
    xb_d = torch.from_numpy(xb).cuda()
    d2 = (xq_d * xq_d).sum(1, keepdim=True) + (xb_d * xb_d).sum(1)[None] - 2.0 * xq_d @ xb_d.T
    D_bf, I_bf = torch.topk(d2, K + 1, dim=1, largest=False)
    recall = float((I1[:, :, None] == I_bf[:, None, :K]).any(2).float().mean())
    I_bf = I_bf[:, :K]
    # full probe: every bucket takes the dense scan, and the search is exact
    paths, (Df, If) = scan_paths(lambda: index.search(xq, K, nprobe=NLIST))
    torch.testing.assert_close(Df, D_bf[:, :K], rtol=1e-4, atol=1e-3)
    tie = (D_bf[:, K] - D_bf[:, K - 1]).abs() <= 1e-3 + 1e-4 * D_bf[:, K].abs()
    same = (If.sort(1).values == I_bf.sort(1).values).all(1)
    if not bool((same | tie).all()):
        raise AssertionError("full-probe search differs from brute force")
    if paths["pairs"] or len(paths["dense"]) != len(index._scan):
        raise AssertionError(f"full probe: not every bucket took the dense scan: {paths}")
    full_ms = median_ms(lambda: index.search(xq, K, nprobe=NLIST))
    log(f"[main] full probe (nprobe {NLIST}) == brute force on {NQ} queries (D within rtol "
        f"1e-4 atol 1e-3, sorted I rows equal or a tie at slot {K}; rows with a tie "
        f"{int(tie.sum())}, rows that differ {int((~same).sum())}); buckets by scan: dense "
        f"{len(paths['dense'])}, pairs {len(paths['pairs'])} of {len(index._scan)}; recall@{K} "
        f"of nprobe={NPROBE} vs brute force: {recall:.4f}")
    del xb_d, d2

    times = {}
    for name, container in (("uncompressed", index.invlists), ("ROC", roc)):
        index.replace_invlists(container)
        times[name] = search_times(index, xq, f"flat {name}")
    log(f"[main] CUDA-event ms: train {t_train:.1f}, add {t_add:.1f}, ROC encode "
        f"(container build) {t_roc:.1f}; search ({NQ} queries, median of 5 after a warm-up) "
        "= positional + translate: " + "; ".join(
            f"{name} {t[0]:.2f} = {t[1]:.2f} + {t[2]:.2f} ({t[3]} touched lists)"
            for name, t in times.items())
        + f"; full probe (nprobe {NLIST}, ROC, dense scan) {full_ms:.2f}")
    return index, roc, launches, I_bf[:, :K]


def kmeans_reproducible(xt, centroids) -> None:
    """Two more trainings of [main]'s coarse quantizer (train_kmeans at the
    index's shape and defaults) must give its centroids bit for bit: the
    update sums each cluster in a fixed order (search/kmeans.py
    cluster_sums), where a float scatter-add on the card sums in the order
    its atomics arrive."""
    from vector_db_id_compression_tpu_torch.search.kmeans import train_kmeans

    ms, again = cuda_ms(lambda: train_kmeans(xt, NLIST, device="cuda"))
    third = train_kmeans(xt, NLIST, device="cuda")
    for c in (again, third):
        if not torch.equal(c, centroids):
            raise AssertionError(f"k-means on the card differs from run to run: max "
                                 f"|difference| {max_abs_err(c, centroids)}")
    log(f"[main] k-means reproducible: two more train_kmeans calls ({NT} x {D} into {NLIST}, "
        f"{ms:.1f} ms each) == the index's centroids bit for bit")


def scan_paths(fn):
    """(the scan buckets, by identity, that ``fn``'s searches sent through
    the dense and through the pair scan of ``search/ivf.py``, fn's result)."""
    from vector_db_id_compression_tpu_torch.search import ivf

    seen = {"dense": set(), "pairs": set()}
    dense, pairs = ivf._scan_flat_dense, ivf._scan_flat_pairs

    def dense_spy(xq, sb, k):
        seen["dense"].add(id(sb))
        return dense(xq, sb, k)

    def pairs_spy(xq, sb, *args):
        seen["pairs"].add(id(sb))
        return pairs(xq, sb, *args)

    ivf._scan_flat_dense, ivf._scan_flat_pairs = dense_spy, pairs_spy
    try:
        out = fn()
    finally:
        ivf._scan_flat_dense, ivf._scan_flat_pairs = dense, pairs
    return seen, out


def device_ops(fn):
    """(kernels, copies and memsets, their device ms) of one call of ``fn``
    on the card, from torch.profiler after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = sum(e.count for e in ops if e.key.startswith(("Memcpy", "Memset")))
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    return sum(e.count for e in ops) - copies, copies, device_ms


def phase_codecs(index, roc, xq):
    """The paper's other IVF id codecs on the [main] index, through the
    user-facing entry points: PackedBitsInvertedLists, EliasFanoInvertedLists
    and WaveletTreeInvertedLists (wt_type 0 and 1) built on the card from the
    index's lists; each must recover every list and give the uncompressed
    search's I and D exactly with either translate (the lists are ascending,
    so no container reorders one). Leaves ``roc`` active, as [timing] reads
    the ROC search's launches. Returns the containers by name."""
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.store.invlists import AVAILABLE_COMPRESSED_IVFS

    cuda = torch.device("cuda")
    il = index.invlists
    lengths = il.lengths
    n = index.ntotal
    src = torch.zeros((NLIST, int(lengths.max())), dtype=torch.int64)
    for ln in range(NLIST):
        src[ln, : lengths[ln]] = torch.from_numpy(il.ids[ln].view(np.int64))
    src = src.cuda()
    index.replace_invlists(il)
    D0, I0 = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    _, L = index.search_positional(xq, K, NPROBE)
    labels = int((L >= 0).sum())
    lns, offs = L[L >= 0] >> 32, L[L >= 0] & 0xFFFFFFFF
    # ---- this path runs no hand-written kernel (plain torch, ROADMAP Queue
    # A 4); the ROC kernels' counts over it stay 0
    RocEncoder.launches = RocDecoder.launches = 0
    out, built = {}, {}
    for name in ("packed-bits", "elias-fano", "wavelet-tree", "wavelet-tree-1"):
        t_build, c = cuda_ms(lambda: AVAILABLE_COMPRESSED_IVFS[name](il, device=cuda))
        for lo in range(0, NLIST, 128):
            lists = torch.arange(lo, lo + 128, device=cuda)
            ids, lens = c.decode_lists(lists)
            if not (torch.equal(lens.cpu(), torch.from_numpy(lengths[lo:lo + 128]))
                    and torch.equal(ids, src[lo:lo + 128, : ids.shape[1]])):
                raise AssertionError(f"{name}: decode_lists of lists {lo}..{lo + 127} differs "
                                     "from the source lists")
        index.replace_invlists(c)
        for one_by_one in (True, False):
            D1, I1 = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE,
                                                    decode_1by1=one_by_one)
            if not (torch.equal(I1, I0) and torch.equal(D1, D0)):
                raise AssertionError(f"{name} search (decode_1by1={one_by_one}): I or D "
                                     "differs from the uncompressed search")
        r = {"payload_bits_per_id": c.compressed_ids_size_in_bytes * 8 / n,
             "overhead_bits_per_id": c.overhead_in_bytes * 8 / n, "build_ms": t_build}
        for mode, one_by_one in (("random_access", True), ("grouped", False)):
            r[f"translate_{mode}_ms"] = median_ms(lambda: index._translate(L, one_by_one))
            r[f"translate_{mode}_ops"] = device_ops(lambda: index._translate(L, one_by_one))
        # the select alone (ef_select, wt_select, wt_select_rrr, the packed
        # fields read) over the labels, without the translate's label split
        r["select_ms"] = median_ms(lambda: c.get_single_ids_batch(lns, offs))
        r["select_ops"] = device_ops(lambda: c.get_single_ids_batch(lns, offs))
        r["search_ms"] = median_ms(lambda: index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE))
        profile_search(index, xq, f"flat {name}")
        out[name] = r
        built[name] = c
    torch.cuda.synchronize()
    launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches}
    # ----
    index.replace_invlists(roc)
    log(f"[codecs] IVF{NLIST},Flat over {n} ids (ascending lists): PackedBits, EliasFano, "
        f"WaveletTree(0), WaveletTree(1) built on the card; every list recovered by "
        f"decode_lists; search at nprobe {NPROBE} with decode_1by1 true and false: I and D "
        f"identical to the uncompressed search; hand-written kernels launched on this path "
        f"(none expected): {launches}")

    def ops(r, key):
        kernels, copies, device_ms = r[f"{key}_ops"]
        return (f"{r[f'{key}_ms']:.3f} ms ({kernels} kernels, {copies} copies/memsets, "
                f"device busy {device_ms:.3f} ms)")

    for name, r in out.items():
        log(f"[codecs] {name}: bits/id {r['payload_bits_per_id']:.4f} payload + "
            f"{r['overhead_bits_per_id']:.4f} overhead; build {r['build_ms']:.1f} ms; translate "
            f"of {labels} labels: random access {ops(r, 'translate_random_access')}, grouped "
            f"{ops(r, 'translate_grouped')}; the select alone {ops(r, 'select')}; search "
            f"{r['search_ms']:.2f} ms (CUDA-event medians of 5 after a warm-up; launches and "
            f"device time from torch.profiler)")
    return built


def search_times(index, xq, what: str, nprobe: int = NPROBE):
    """(search, positional, translate ms: CUDA-event medians of 5 after a
    warm-up; lists touched by the translate) for the active container; logs
    its search's profile as ``what``."""
    t_pos = median_ms(lambda: index.search_positional(xq, K, nprobe))
    _, L = index.search_positional(xq, K, nprobe)
    t_tr = median_ms(lambda: index._translate(L))
    t_search = median_ms(lambda: index.search_defer_id_decoding(xq, k=K, nprobe=nprobe))
    profile_search(index, xq, what, nprobe=nprobe)
    return t_search, t_pos, t_tr, int(torch.unique(L[L >= 0] >> 32).numel())


def profile_search(index, xq, what: str, reps: int = 3, nprobe: int = NPROBE) -> None:
    """torch.profiler over ``reps`` searches of the active container; logs,
    per search: wall ms (host clock), device ms (the kernels' self times),
    the idle share (1 - device / wall) and the three kernels with the most
    device time."""
    profile_fn(lambda: index.search_defer_id_decoding(xq, k=K, nprobe=nprobe), f"{what} search",
               reps)


def profile_fn(fn, what: str, reps: int = 3):
    """``profile_search`` for any call ``fn``; returns its idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    # device-side events only: the CPU ops that launch them carry their time too
    times = {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    device = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:3]
    log(f"[profile] {what} (torch.profiler, {reps} calls): wall {wall:.2f} ms, "
        f"device {device:.2f} ms, idle share {1 - device / wall:.2f}; most device time: "
        + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in top))
    return 1 - device / wall


def phase_pq(xt, xb, xq, I_bf, flat_max_len: int):
    """IVF1024,PQ16 at nprobe 16 with the RocInvertedLists and the
    interleaved containers, through the user-facing entry points. Returns
    (the index, the two containers, this phase's launch counts)."""
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search import ivf
    from vector_db_id_compression_tpu_torch.store.invlists import (
        InterleavedRocInvertedLists, RocInvertedLists)

    budget = ivf.PQ_DECODE_BUDGET
    # ---- the PQ path; the kernels' launch counts are read from this window
    RocEncoder.launches = 0
    RocDecoder.launches = 0
    index = ivf.IndexIVF(d=D, nlist=NLIST, storage="pq", pq_m=PQ_M, device="cuda")
    t_train, _ = cuda_ms(lambda: index.train(xt))
    t_add, _ = cuda_ms(lambda: index.add(xb))
    decoded_default = index._scan_is_float
    results = {"uncompressed": index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)}
    t_roc, roc = cuda_ms(lambda: RocInvertedLists(index.invlists, device="cuda"))
    index.replace_invlists(roc)
    results["RocInvertedLists"] = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    t_il, il = cuda_ms(lambda: InterleavedRocInvertedLists(index.invlists, device="cuda"))
    index.replace_invlists(il)
    results["interleaved"] = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    ivf.PQ_DECODE_BUDGET = 0
    index.replace_invlists(il)
    results["interleaved, LUT scan"] = index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    ivf.PQ_DECODE_BUDGET = budget
    ids, lens = il.decode_lists(torch.arange(NLIST, device="cuda"))
    torch.cuda.synchronize()
    launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches}
    # ----

    if not decoded_default or index._scan_is_float:
        raise AssertionError("the decoded scan is not the default at this size, or the "
                             "budget of 0 did not select the LUT scan")
    D0, I0 = results["uncompressed"]
    if I0.shape != (NQ, K) or not bool(torch.isfinite(D0).all()):
        raise AssertionError("PQ search: bad shape or non-finite distances")
    differ = {}
    for name, (D1, I1) in results.items():
        if int(I1.min()) < 0 or int(I1.max()) >= NB:
            raise AssertionError(f"PQ search with {name}: ids out of range")
        # the LUT scan sums 16 subspace distances, the decoded scan takes
        # |y|^2 - 2 x.y + |x|^2 over terms near 2000: a wider atol
        atol = 1e-2 if "LUT" in name else 1e-3
        differ[name] = assert_near_ties(f"PQ search with {name}", D1, I1, D0, I0, 1e-4, atol)
    if min(launches.values()) < 2:
        raise AssertionError(f"a kernel of the PQ path was launched less than twice: {launches}")
    # every list's ids, as a multiset, from the interleaved decode
    lengths = index.invlists.lengths
    big = torch.iinfo(torch.int64).max
    cols = torch.arange(ids.shape[1], device="cuda")[None, :]
    got = torch.where(cols < lens[:, None], ids, big).sort(dim=1).values
    src = np.full((NLIST, ids.shape[1]), big, dtype=np.int64)
    for ln in range(NLIST):
        src[ln, : lengths[ln]] = np.sort(index.invlists.ids[ln].view(np.int64))
    if not torch.equal(got.cpu(), torch.from_numpy(src)):
        raise AssertionError("interleaved decode_lists: a list's ids differ from the source")
    E, n_max = il.decoder.states.head.shape[0], il.decoder.n_max
    log(f"[pq] IVF{NLIST},PQ{PQ_M} over {index.ntotal} ids: list lengths {lengths.min()}.."
        f"{lengths.max()} (mean {lengths.mean():.0f}; the flat index's longest: "
        f"{flat_max_len}); interleaved: {E} chunk entries, n_max {n_max}, "
        f"{int((il.n_lanes > 1).sum())} lists chunked (S {int(il.n_lanes.max())} at most)")
    log(f"[pq] on {NQ} queries, k={K}, nprobe={NPROBE}: RocInvertedLists, interleaved "
        f"(decoded scan) and interleaved (LUT scan) == uncompressed (decoded scan) under the "
        f"near-tie rule (D rtol 1e-4, atol 1e-3; 1e-2 for the LUT scan); labels at near "
        f"ties: {differ}; every list's ids recovered by interleaved decode_lists; "
        f"launches {launches}")
    n = index.ntotal
    log(f"[pq] bits/id: RocInvertedLists {roc.compressed_ids_size_in_bytes * 8 / n:.4f}, "
        f"interleaved {il.compressed_ids_size_in_bytes * 8 / n:.4f} "
        f"({(il.compressed_ids_size_in_bytes + il.overhead_in_bytes) * 8 / n:.4f} with its "
        f"overhead_in_bytes {il.overhead_in_bytes})")
    rec = {name: recalls(I1, I_bf)[1] for name, (_, I1) in results.items()}
    log(f"[pq] recall@{K} against brute force: " + ", ".join(f"{k_} {v:.4f}"
                                                          for k_, v in rec.items()))
    log(f"[pq] CUDA-event ms: train {t_train:.1f} (coarse + {PQ_M} codebooks), add {t_add:.1f} "
        f"(PQ encode included), RocInvertedLists build {t_roc:.1f}, interleaved build "
        f"{t_il:.1f}")
    times = {}
    for name, container, scan_budget in (("uncompressed", index.invlists, budget),
                                         ("RocInvertedLists", roc, budget),
                                         ("interleaved", il, budget),
                                         ("interleaved, LUT scan", il, 0)):
        ivf.PQ_DECODE_BUDGET = scan_budget
        index.replace_invlists(container)
        times[name] = search_times(index, xq, f"PQ {name}")
    ivf.PQ_DECODE_BUDGET = budget
    log(f"[pq] search ms ({NQ} queries, median of 5 after a warm-up) = positional + "
        "translate: " + "; ".join(f"{name} {t[0]:.2f} = {t[1]:.2f} + {t[2]:.2f} ({t[3]} "
                                  f"touched lists)" for name, t in times.items()))
    return index, roc, il, launches


def recalls(I, I_bf):
    """(recall@1: the true nearest neighbour ranked first, as the JAX graph
    bench's R@1; recall@10: the share of the true top 10 found)."""
    r1 = float((I[:, 0] == I_bf[:, 0]).float().mean())
    r10 = float((I[:, :, None] == I_bf[:, None, :]).any(2).float().mean())
    return r1, r10


def phase_graph(xb, xq, I_bf):
    """NSG R=32 over the [main] database, the two ROC graphs, the compact
    and Elias-Fano graphs, and the search with all five containers, through
    the user-facing entry points. Returns (the five containers by name, the
    medoid, the dense graph's search (D, I), this phase's launch counts, the
    nearest node found per query: one fetch's worth of nodes for the timing,
    the chained kernels' launches per search or build)."""
    from vector_db_id_compression_tpu_torch.codecs.rec import Graph as RecGraph
    from vector_db_id_compression_tpu_torch.codecs.rec import (PolyasUrnModel,
                                                               friend_to_edgelist_repr)
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
    from vector_db_id_compression_tpu_torch.search.nsg import build_nsg, search_graph
    from vector_db_id_compression_tpu_torch.store.graph import (
        CompactBitGraph, EliasFanoGraph, RocBlockGraph, RocGraph)

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
    before = RocEncoder.chained_launches
    t_blk, blk = cuda_ms(lambda: RocBlockGraph(g, block=GRAPH_BLOCK))
    per_unit = {"roc_encode_chained": RocEncoder.chained_launches - before}
    t_cb, cb = cuda_ms(lambda: CompactBitGraph(g))
    t_ef, efg = cuda_ms(lambda: EliasFanoGraph(g))
    containers = (("Graph", g), ("RocGraph", roc), ("RocBlockGraph", blk),
                  ("CompactBitGraph", cb), ("EliasFanoGraph", efg))
    results, capped = {}, {}
    for name, container in containers:
        before = RocDecoder.launches, RocDecoder.chained_launches
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results[name] = search_graph_device(container, xb_d, xq_d, k=K, entry=medoid)
        torch.cuda.synchronize()
        capped[name] = any("max_iters" in str(w.message) for w in caught)
        if name == "RocGraph":
            hops = RocDecoder.launches - before[0]  # one decode launch per hop
        if name == "RocBlockGraph":
            per_unit["roc_decode_chained"] = RocDecoder.chained_launches - before[1]
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
        f"identical for Graph, RocGraph, RocBlockGraph(block={GRAPH_BLOCK}), "
        f"CompactBitGraph, EliasFanoGraph; launches {launches}")
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
    for name, c, t in (("RocGraph", roc, t_roc), ("RocBlockGraph", blk, t_blk),
                       ("CompactBitGraph", cb, t_cb), ("EliasFanoGraph", efg, t_ef)):
        log(f"[graph] {name}: built in {t:.1f} ms (CUDA events), "
            f"compressed_ids_size_in_bytes {c.compressed_ids_size_in_bytes}, "
            f"overhead_in_bytes {c.overhead_in_bytes}, bits/edge "
            f"{c.compressed_ids_size_in_bytes * 8 / edges:.4f} "
            f"({(c.compressed_ids_size_in_bytes + c.overhead_in_bytes) * 8 / edges:.4f} "
            f"with overhead_in_bytes; 32 for the raw int32 adjacency)")
    # the paper's Table 3: REC's bits/edge (the Polya-urn model of the edge
    # list, directed) beside the two ROC graphs'
    t0 = time.perf_counter()
    edge_list = friend_to_edgelist_repr(g.adjacency)
    _, rec_bpe = PolyasUrnModel(g.N, edges).compute_bpe(RecGraph(edge_list, g.N, edges))
    t_rec = (time.perf_counter() - t0) * 1e3
    if edge_list.shape != (edges, 2) or not 0 < rec_bpe < 32:
        raise AssertionError(f"REC: {tuple(edge_list.shape)} edges, {rec_bpe} bits/edge")
    log(f"[graph] REC (Polya urn, directed, codecs/rec.py) over the {edges} edges: "
        f"{rec_bpe:.4f} bits/edge ({t_rec:.1f} ms, host clock); RocGraph "
        f"{roc.compressed_ids_size_in_bytes * 8 / edges:.4f}, RocBlockGraph "
        f"{blk.compressed_ids_size_in_bytes * 8 / edges:.4f} (+ overhead "
        f"{blk.overhead_in_bytes * 8 / edges:.4f})")
    r1, r10 = recalls(I0, I_bf)
    log(f"[graph] {hops} hops (decode launches of one RocGraph search), max_iters "
        f"cap hit: {capped}; recall@1 {r1:.4f}, recall@{K} {r10:.4f} against brute force")
    times = {name: median_ms(lambda c=c: search_graph_device(c, xb_d, xq_d, k=K, entry=medoid))
             for name, c in containers}
    log("[graph] search ms (CUDA events, median of 5 after a warm-up): "
        + ", ".join(f"{name} {t:.2f}" for name, t in times.items()))
    per_unit["roc_decode"] = hops
    return dict(containers), medoid, (D0, I0), launches, I0[:, 0], per_unit


def roc_states_equal(loaded, built) -> bool:
    """Two ROC decoders hold the same streams: heads, stack lengths, MT
    counters, lane lengths and precisions equal, and each lane's stack words
    up to its length (past it an encoder may leave popped words)."""
    a, b = loaded.states, built.states
    if a.stack.shape != b.stack.shape:
        return False
    cols = torch.arange(a.stack.shape[1], device=a.stack.device)[None, :]
    live = cols < b.stack_len[:, None]
    pairs = ((a.head, b.head), (a.stack_len, b.stack_len), (a.mt_ctr, b.mt_ctr),
             (loaded.lengths, built.lengths), (loaded.precision, built.precision),
             (torch.where(live, a.stack, 0), torch.where(live, b.stack, 0)))
    return all(torch.equal(x, y) for x, y in pairs)


def round_trip(path: Path, what: str, obj, save, load):
    """``save(path, obj)``, stamp, verify, ``load(path)``; the loaded object
    written again must equal the first file byte for byte. Deletes the
    file. Returns (its bytes and the host-clock ms of save, stamp,
    verify and load, the load synchronised with the card; the loaded
    object)."""
    from vector_db_id_compression_tpu_torch.utils import stamp_artifact, verify_artifact

    t0 = time.perf_counter()
    save(path, obj)
    t_save = time.perf_counter()
    first = path.read_bytes()
    t1 = time.perf_counter()
    stamp_artifact(path)
    t_stamp = time.perf_counter()
    ok = verify_artifact(path)
    t_verify = time.perf_counter()
    if not ok:
        raise AssertionError(f"{what}: verify_artifact is False after stamp_artifact")
    nbytes = path.stat().st_size
    t2 = time.perf_counter()
    loaded = load(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter()
    buf = io.BytesIO()
    save(buf, loaded)
    if buf.getvalue() != first:
        raise AssertionError(f"{what}: the loaded object written again differs from its file")
    path.unlink()
    return {"bytes": nbytes, "save_ms": (t_save - t0) * 1e3, "stamp_ms": (t_stamp - t1) * 1e3,
            "verify_ms": (t_verify - t_stamp) * 1e3, "load_ms": (t_load - t2) * 1e3}, loaded


def phase_serialize(ivfs, graphs, medoid, graph_ref, xb, xq):
    """The artifact format on what the earlier phases built. ``ivfs``:
    (name, index, {container name: (container, the decode_1by1 values its
    phase searched with)}); ``graphs``: name → graph container;
    ``graph_ref``: the dense graph's search (D, I), which every graph gave
    in [graph]. Each index is saved (save_index) and loaded into a fresh
    IndexIVF on the card, each container saved and loaded and swapped into
    it, each graph saved and loaded; each must search as before the save.
    Returns this phase's launch counts: the decode kernel runs on the loaded
    states only."""
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
    from vector_db_id_compression_tpu_torch.search.ivf import load_index, save_index
    from vector_db_id_compression_tpu_torch.store.serialize import (
        load_graph, load_invlists, save_graph, save_invlists)

    cuda = torch.device("cuda")
    # the searches before the save, with the built containers, and their ms
    before, before_ms = {}, {}
    for iname, index, containers in ivfs:
        active = index.active
        for cname, (c, modes) in containers.items():
            index.replace_invlists(c)
            before[iname, cname] = {m: index.search_defer_id_decoding(
                xq, k=K, nprobe=NPROBE, decode_1by1=m) for m in modes}
            before_ms[iname, cname] = median_ms(lambda: index.search_defer_id_decoding(
                xq, k=K, nprobe=NPROBE, decode_1by1=modes[0]))
        index.replace_invlists(active)
    xb_d, xq_d = torch.from_numpy(xb).to(cuda), torch.from_numpy(xq).to(cuda)
    rows = []
    # ---- the serialize path; the kernels' launch counts are read from this
    # window only
    RocEncoder.launches = RocEncoder.chained_launches = 0
    RocDecoder.launches = RocDecoder.chained_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "artifact.npz"
        for iname, index, containers in ivfs:
            r, loaded_index = round_trip(path, f"{iname} index", index, save_index,
                                         lambda p: load_index(p, device=cuda))
            rows.append((f"{iname} index ({index.ntotal} ids)", r, ""))
            for cname, (c, modes) in containers.items():
                what = f"{iname} {cname}"
                r, lc = round_trip(path, what, c, save_invlists,
                                   lambda p: load_invlists(p, device=cuda))
                if hasattr(c, "decoder") and not roc_states_equal(lc.decoder, c.decoder):
                    raise AssertionError(f"{what}: the loaded ROC states differ from the built")
                loaded_index.replace_invlists(lc)
                for m, (D0, I0) in before[iname, cname].items():
                    D1, I1 = loaded_index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE,
                                                                   decode_1by1=m)
                    if not (torch.equal(I1, I0) and torch.equal(D1, D0)):
                        raise AssertionError(f"{what} (decode_1by1={m}): the loaded index's "
                                             "search differs from the search before the save")
                r["search_ms"] = median_ms(lambda: loaded_index.search_defer_id_decoding(
                    xq, k=K, nprobe=NPROBE, decode_1by1=modes[0]))
                r["built_ms"] = before_ms[iname, cname]
                bits = [x.compressed_ids_size_in_bytes * 8 / index.ntotal for x in (c, lc)]
                if bits[0] != bits[1] or lc.overhead_in_bytes != c.overhead_in_bytes:
                    raise AssertionError(f"{what}: bits/id {bits} differ after the round trip")
                rows.append((what, r, f"bits/id {bits[1]:.4f} (before the save {bits[0]:.4f})"))
                del lc
            del loaded_index
        edges = int(graphs["Graph"].degrees.sum())
        for gname, gc in graphs.items():
            r, lg = round_trip(path, f"graph {gname}", gc, save_graph,
                               lambda p: load_graph(p, device=cuda))
            if hasattr(gc, "decoder") and not roc_states_equal(lg.decoder, gc.decoder):
                raise AssertionError(f"graph {gname}: the loaded ROC states differ from the built")
            D1, I1 = search_graph_device(lg, xb_d, xq_d, k=K, entry=medoid)
            if not (torch.equal(I1, graph_ref[1]) and torch.equal(D1, graph_ref[0])):
                raise AssertionError(f"graph {gname}: the loaded graph's search differs")
            # the loaded and the built graph's search in turns: built, loaded,
            # loaded, built; the built graph's launches do not count (they
            # decode the built states)
            t = []
            for x in (gc, lg, lg, gc):
                counts = RocDecoder.launches, RocDecoder.chained_launches
                t.append(median_ms(lambda: search_graph_device(x, xb_d, xq_d, k=K,
                                                               entry=medoid)))
                if x is gc:
                    RocDecoder.launches, RocDecoder.chained_launches = counts
            r["search_ms"], r["built_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            size = [getattr(x, "compressed_ids_size_in_bytes", 4 * x.N * x.K) for x in (gc, lg)]
            if size[0] != size[1]:
                raise AssertionError(f"graph {gname}: size {size} differs after the round trip")
            rows.append((f"graph {gname}", r, f"bits/edge {size[1] * 8 / edges:.4f}"
                         + (" (the dense int32 table)" if gname == "Graph" else "")))
            del lg
    torch.cuda.synchronize()
    launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches,
                "roc_encode_chained": RocEncoder.chained_launches,
                "roc_decode_chained": RocDecoder.chained_launches}
    # ----
    if launches["roc_decode"] < 1 or launches["roc_decode_chained"] < 1:
        raise AssertionError(f"the decode kernel did not run on the loaded states: {launches}")
    log(f"[serialize] {len(rows)} artifacts (the format of the JAX package, MAGIC "
        f"vdbidc-tpu-v1): every verify_artifact True after stamp_artifact; every loaded "
        f"index, container and graph searched as before the save (I and D identical, both "
        f"translates where the codec has two), loaded ROC states == built, each loaded object "
        f"written again == its file; launches {launches}")
    for what, r, extra in rows:
        log(f"[serialize] {what}: {r['bytes']} bytes; save {r['save_ms']:.1f}, stamp "
            f"{r['stamp_ms']:.1f}, verify {r['verify_ms']:.1f}, load {r['load_ms']:.1f} ms "
            f"(host clock, the load synchronised with the card)"
            + (f"; search {r['search_ms']:.2f} ms loaded, {r['built_ms']:.2f} built (CUDA-event "
               f"medians of 5 after a warm-up; {'in turns' if 'graph' in what else 'the built before the save'})"
               if "search_ms" in r else "") + (f"; {extra}" if extra else ""))
    return launches


def stage_times(sh, xq_d, timer=median_ms) -> dict:
    """``timer``'s ms (by default CUDA-event medians of 5 after a warm-up) of
    a ShardedIVF's four stages on one chunk of ``xq_d``, each on the
    previous stage's output, and of its whole search, at k = K and nprobe =
    NPROBE. The stages hold collectives: every rank calls this in step."""
    probes = sh._coarse(xq_d, NPROBE)
    dist, labels = sh._scan(xq_d, probes, K)
    _, L = sh._merge(dist, labels, K)
    return {"coarse": timer(lambda: sh._coarse(xq_d, NPROBE)),
            "scan": timer(lambda: sh._scan(xq_d, probes, K)),
            "merge": timer(lambda: sh._merge(dist, labels, K)),
            "translate": timer(lambda: sh._translate(L)),
            "search": timer(lambda: sh.search(xq_d, K, NPROBE))}


def phase_parallel(index, roc, codecs, pq_index, pq_roc, xq):
    """``parallel/`` on torch.distributed over the [main] and [pq] indexes.
    One NCCL rank on the card (multihost.initialize, world size 1): the
    sharded ROC encode of the 1024 lists (bit-equal to the container's
    states), the sharded decode (every list recovered), the size psum (the
    host sum), and ShardedIVF over IVF1024,Flat with the raw lists and every
    container of AVAILABLE_COMPRESSED_IVFS and over IVF1024,PQ16 with
    RocInvertedLists through the decoded and the LUT scans, each equal to
    the unsharded search under the near-tie rule (D within 1e-5 relative);
    then four gloo ranks on the same card (``parallel_rank``), each loading
    the flat index and its ROC container from files, encoding its quarter
    and searching: states bit-equal to the one rank's, I and D under the
    near-tie rule (the differences in D reported), both kernels launched in
    every rank.
    Returns the one rank's launch counts."""
    import torch.distributed as dist

    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.parallel import multihost
    from vector_db_id_compression_tpu_torch.parallel.mesh import (
        sharded_roc_decode, sharded_roc_encode, sharded_size_accounting)
    from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu_torch.search import ivf
    from vector_db_id_compression_tpu_torch.store.invlists import (
        AVAILABLE_COMPRESSED_IVFS, roc_lane_table)
    from vector_db_id_compression_tpu_torch.store.serialize import save_invlists

    cuda = torch.device("cuda", 0)
    xq_d = torch.from_numpy(xq).to(cuda)
    flat = {"raw": index.invlists, "roc": roc, **codecs}
    flat["roc-interleaved"] = AVAILABLE_COMPRESSED_IVFS["roc-interleaved"](index.invlists,
                                                                          device=cuda)
    assert sorted(flat) == sorted(["raw", *AVAILABLE_COMPRESSED_IVFS])
    # the unsharded searches, each with its container's default translate,
    # and their ms; then the indexes' containers as they were
    active = index.active, pq_index.active
    budget = ivf.PQ_DECODE_BUDGET
    cases = [("flat " + name, index, c, budget) for name, c in flat.items()]
    cases += [("PQ roc decoded", pq_index, pq_roc, budget), ("PQ roc LUT", pq_index, pq_roc, 0)]
    ref, ref_ms = {}, {}
    for name, idx, c, scan_budget in cases:
        ivf.PQ_DECODE_BUDGET = scan_budget
        idx.replace_invlists(c)
        ref[name] = idx.search_defer_id_decoding(xq_d, k=K, nprobe=NPROBE)
        ref_ms[name] = median_ms(lambda: idx.search_defer_id_decoding(xq_d, k=K, nprobe=NPROBE))
    ivf.PQ_DECODE_BUDGET = budget
    index.replace_invlists(active[0])
    pq_index.replace_invlists(active[1])
    sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
    ids_t, lens_t, prec_t = (torch.from_numpy(a).to(cuda)
                             for a in (sorted_ids.view(np.int64), lengths, prec))
    built = roc.decoder.states
    cap = built.stack.shape[1]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t_init, _ = host_s(lambda: multihost.initialize(
            init_method=f"file://{tmp / 'pg_init'}", world_size=1, rank=0, device=cuda))
        try:
            mesh = multihost.global_lists_mesh(device=cuda)
            if (mesh.size, mesh.backend) != (1, "nccl"):
                raise AssertionError(f"not one NCCL rank: {mesh}")
            # ---- the parallel path on one rank; the kernels' launch counts
            # are read from this window only
            RocEncoder.launches = RocDecoder.launches = 0
            t_enc, (states, order) = host_s(lambda: sharded_roc_encode(mesh, ids_t, lens_t,
                                                                       prec_t, cap))
            t_dec, decoded = host_s(lambda: sharded_roc_decode(mesh, states, lens_t, prec_t,
                                                               sorted_ids.shape[1]))
            nbytes, nids = sharded_size_accounting(mesh, states, lens_t)
            sharded, got, build_ms = {}, {}, {}
            for name, idx, c, scan_budget in cases:
                ivf.PQ_DECODE_BUDGET = scan_budget
                try:
                    build_ms[name], sharded[name] = host_s(lambda: ShardedIVF(
                        mesh, idx, c, device=cuda))
                finally:
                    ivf.PQ_DECODE_BUDGET = budget
                got[name] = sharded[name].search(xq_d, K, NPROBE)
            torch.cuda.synchronize()
            launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches}
            # ----
            if [sh._scan_is_float for sh in sharded.values()][-2:] != [True, False]:
                raise AssertionError("the PQ cases did not take the decoded and the LUT scan")
            stages = {name: stage_times(sh, xq_d) for name, sh in sharded.items()}
        finally:
            dist.destroy_process_group()
        del sharded
        if any(not torch.equal(a, b) for a, b in zip(states[:4], built[:4])) or bool(
                states.err.any()):
            raise AssertionError("sharded_roc_encode: states differ from RocInvertedLists'")
        big = torch.iinfo(torch.int64).max
        valid = torch.arange(ids_t.shape[1], device=cuda)[None, :] < lens_t[:, None]
        if not torch.equal(torch.where(valid, decoded, big).sort(dim=1).values,
                           torch.where(valid, ids_t, big)):
            raise AssertionError("sharded_roc_decode: a list's ids differ from the source")
        host_bytes = int(np.where(lengths > 0, 8 + 4 * built.stack_len.cpu().numpy(), 0).sum())
        if (int(nbytes), int(nids)) != (host_bytes, index.ntotal) or \
                host_bytes != roc.compressed_ids_size_in_bytes:
            raise AssertionError(f"sharded_size_accounting {int(nbytes)}, {int(nids)} != the "
                                 f"host's {host_bytes}, {index.ntotal}")
        differ = {name: assert_near_ties(f"[parallel] one rank, {name}", *got[name], *ref[name],
                                         1e-5, 1e-5) for name, *_ in cases}
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the parallel path was not launched: {launches}")
        log(f"[parallel] one NCCL rank on the card (bring-up {t_init:.2f} s): "
            f"sharded_roc_encode of {NLIST} lists == the RocInvertedLists states (head, stack, "
            f"stack_len, mt_ctr; {t_enc * 1e3:.1f} ms host clock), sharded_roc_decode recovers "
            f"every list ({t_dec * 1e3:.1f} ms), sharded_size_accounting {int(nbytes)} bytes, "
            f"{int(nids)} ids == the host sum; ShardedIVF == the unsharded search on {NQ} "
            f"queries, k={K}, nprobe={NPROBE} (near-tie rule, D rtol 1e-5) for every case, "
            f"labels at near ties {differ}; launches {launches}")
        for name, *_ in cases:
            t = stages[name]
            log(f"[parallel] {name}: build {build_ms[name] * 1e3:.1f} ms (host clock); "
                f"sharded search {t['search']:.2f} ms = coarse {t['coarse']:.2f} + scan "
                f"{t['scan']:.2f} + merge {t['merge']:.2f} + translate {t['translate']:.2f} "
                f"(stages alone); unsharded search {ref_ms[name]:.2f} ms (CUDA-event medians "
                f"of 5 after a warm-up)")

        # ---- four gloo ranks sharing the card, each its own process
        from vector_db_id_compression_tpu_torch.search.ivf import save_index

        t_save, _ = host_s(lambda: (save_index(tmp / "index.npz", index),
                                    save_invlists(tmp / "roc.npz", roc)))
        np.save(tmp / "xq.npy", xq)
        t0 = time.perf_counter()
        procs = []
        for r in range(PARALLEL_RANKS):
            out = open(tmp / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(r),
                 "--parallel-dir", str(tmp)],
                stdout=out, stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent)),
                out))
        try:
            for p, _ in procs:
                p.wait(timeout=PARALLEL_TIMEOUT_S)
        finally:
            for p, out in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
        wall = time.perf_counter() - t0
        for r, (p, _) in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"[parallel] rank {r} of {PARALLEL_RANKS} failed "
                                     f"(rc {p.returncode}):\n"
                                     + (tmp / f"rank{r}.log").read_text()[-4000:])
        reports = [json.loads((tmp / f"rank{r}.json").read_text())
                   for r in range(PARALLEL_RANKS)]
        z = np.load(tmp / "rank0.npz")
        for key in ("head", "stack", "stack_len", "mt_ctr"):
            if not np.array_equal(z[key], getattr(states, key).cpu().numpy()):
                raise AssertionError(f"four ranks: gathered {key} differs from the one rank's")
        D4, I4 = torch.from_numpy(z["D"]), torch.from_numpy(z["I"])
        D1, I1 = (t.cpu() for t in got["flat roc"])
        # cuBLAS picks its batched matrix-vector kernel by the batch count,
        # and a rank of four holds a quarter of the (query, list) pairs: the
        # dot products may round otherwise, by a few ulps of |x|^2 and |y|^2,
        # which D = |y|^2 - 2 x.y + |x|^2 subtracts; so the near-tie rule
        # at [main]'s tolerance, and the differences reported
        differ4 = assert_near_ties("[parallel] four ranks against one", D4, I4, D1, I1, 1e-4,
                                   1e-3)
        d_abs = (D4 - D1).abs()
        d_rel = float((d_abs / D1.abs()).max())
        for r, rep in enumerate(reports):
            if min(rep["launches"].values()) < 1:
                raise AssertionError(f"four ranks: rank {r} launched no kernel: {rep}")
            if not rep["same_as_rank0"]:
                raise AssertionError(f"four ranks: rank {r}'s D, I differ from rank 0's")
    log(f"[parallel] {PARALLEL_RANKS} gloo ranks sharing one card (collectives staged through "
        f"the host; not a multi-GPU speed): each loaded the flat index and its ROC container "
        f"(saved in {t_save:.1f} s), encoded its {NLIST // PARALLEL_RANKS} lists and searched "
        f"{NQ} queries; gathered states == the one rank's, I == the one rank's under the "
        f"near-tie rule (D rtol 1e-4, atol 1e-3; {differ4} labels at near ties); D differs "
        f"in {int((d_abs > 0).sum())} of {d_abs.numel()} entries, by {float(d_abs.max()):.6g} "
        f"at most ({d_rel:.3g} relative); wall {wall:.1f} s for the four processes")
    for r, rep in enumerate(reports):
        log(f"[parallel] rank {r}: launches {rep['launches']}, peak device memory "
            f"{rep['peak_mib']:.0f} MiB, load {rep['load_s']:.2f} s, encode "
            f"{rep['encode_ms']:.1f} ms, build {rep['build_s']:.2f} s, search "
            f"{rep['search_ms']:.1f} ms (host clock, median of 3 after a warm-up), in all "
            f"{rep['wall_s']:.1f} s")
    return launches


def parallel_rank(rank: int, directory: Path) -> None:
    """One of the ``PARALLEL_RANKS`` gloo ranks of ``phase_parallel`` on
    cuda:0: loads the flat index and its ROC container from ``directory``
    onto the host, encodes its quarter of the lists (sharded_roc_encode) and
    searches the queries (ShardedIVF, its rows on the card); rank 0 writes
    the gathered states and (D, I), every rank its launches, peak device
    memory and times."""
    import torch.distributed as dist

    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.parallel import multihost
    from vector_db_id_compression_tpu_torch.parallel.mesh import sharded_roc_encode
    from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
    from vector_db_id_compression_tpu_torch.search.ivf import load_index
    from vector_db_id_compression_tpu_torch.store.invlists import roc_lane_table
    from vector_db_id_compression_tpu_torch.store.serialize import load_invlists

    cuda = torch.device("cuda", 0)
    t0 = time.perf_counter()
    multihost.initialize(init_method=f"file://{directory / 'pg4_init'}",
                         world_size=PARALLEL_RANKS, rank=rank, backend="gloo", device=cuda,
                         timeout=timedelta(seconds=PARALLEL_TIMEOUT_S))
    try:
        mesh = multihost.global_lists_mesh(device=cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        RocEncoder.launches = RocDecoder.launches = 0
        load_s, (index, roc) = host_s(lambda: (load_index(directory / "index.npz", device="cpu"),
                                               load_invlists(directory / "roc.npz", device="cpu")))
        sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
        cap = roc.decoder.states.stack.shape[1]
        enc_s, (states, _) = host_s(lambda: sharded_roc_encode(
            mesh, torch.from_numpy(sorted_ids.view(np.int64)), torch.from_numpy(lengths),
            torch.from_numpy(prec), cap))
        build_s, sh = host_s(lambda: ShardedIVF(mesh, index, roc, device=cuda))
        xq = torch.from_numpy(np.load(directory / "xq.npy")).to(cuda)
        D, I = sh.search(xq, K, NPROBE)
        launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches}
        search_ms = float(np.median([host_s(lambda: sh.search(xq, K, NPROBE))[0] * 1e3
                                     for _ in range(4)][1:]))
        # every rank holds the same (D, I) after the collectives
        same = all(torch.equal(g[0], g[r]) for g in (mesh.all_gather(D), mesh.all_gather(I))
                   for r in range(mesh.size))
        if rank == 0:
            np.savez(directory / "rank0.npz", D=D.cpu().numpy(), I=I.cpu().numpy(),
                     **{k: getattr(states, k).cpu().numpy()
                        for k in ("head", "stack", "stack_len", "mt_ctr")})
        report = dict(launches=launches, same_as_rank0=same,
                      peak_mib=torch.cuda.max_memory_allocated(cuda) / 2 ** 20, load_s=load_s,
                      encode_ms=enc_s * 1e3, build_s=build_s, search_ms=search_ms,
                      wall_s=time.perf_counter() - t0)
        (directory / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def phase_hnsw(xt, xb, xq, I_bf):
    """IVF65536_HNSW32,Flat over the [main] database: train on ``xt``, build
    the HNSW quantizer over the centroids, add through it, search with the
    uncompressed lists and RocInvertedLists; the quantizer's level-0 graph
    in the five containers, each searched by HNSW.search(graph0=...). Fails
    unless the ROC search equals the uncompressed one, every vector lands in
    its HNSW top-1 list (or the exact nearest for a miss), the device walk
    equals the host oracle on 32 queries, the five level-0 searches are
    identical and the saved and loaded index and HNSW search as before.
    Returns (the index, its ROC container, the HNSW, its ROC graphs, the
    nearest node found per query, this phase's launch counts, the chained
    kernels' launches per search or build)."""
    from vector_db_id_compression_tpu_torch import native
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.graph_device import (hnsw_descend_device,
                                                                        search_graph_device)
    from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index, save_index
    from vector_db_id_compression_tpu_torch.search.kmeans import assign
    from vector_db_id_compression_tpu_torch.search.nsg import search_graph
    from vector_db_id_compression_tpu_torch.store.graph import (
        CompactBitGraph, EliasFanoGraph, RocBlockGraph, RocGraph)
    from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists
    from vector_db_id_compression_tpu_torch.store.serialize import load_hnsw, save_hnsw

    cuda = torch.device("cuda")
    xq_d, xb_d = torch.from_numpy(xq).to(cuda), torch.from_numpy(xb).to(cuda)

    # ---- the [hnsw] path, through the user-facing entry points; the
    # kernels' launch counts are read from this window only
    RocEncoder.launches = RocEncoder.chained_launches = 0
    RocDecoder.launches = RocDecoder.chained_launches = 0
    index = IndexIVF(D, HNSW_NLIST, storage="flat", nprobe=HNSW_NPROBE, quantizer="hnsw",
                     quantizer_M=HNSW_M, quantizer_efSearch=HNSW_EF, device=cuda)
    t_train, _ = host_s(lambda: index.train(xt))
    # add builds the quantizer lazily; built here first to time it apart,
    # with its host link loop (C++) timed on its own
    link, link_s = native.hnsw_link, []

    def timed_link(*args):
        t0 = time.perf_counter()
        link(*args)
        link_s.append(time.perf_counter() - t0)

    native.hnsw_link = timed_link
    t_quant, h = host_s(index._ensure_quantizer)
    native.hnsw_link = link
    # the walk's top-1 for each vector, recorded as add asks for it (gate 2)
    walked, coarse_assign = [], index.coarse_assign

    def recording(x, nprobe):
        probes = coarse_assign(x, nprobe)
        walked.append(probes[:, 0].clone())
        return probes

    index.coarse_assign = recording
    t_add, _ = host_s(lambda: index.add(xb))
    del index.coarse_assign
    D0, I0 = index.search(xq, K)
    t_roc, roc = cuda_ms(lambda: RocInvertedLists(index.invlists, device=cuda))
    index.replace_invlists(roc)
    D1, I1 = index.search(xq, K)
    g0 = h.level0_graph()
    t_rg, rg = cuda_ms(lambda: RocGraph(g0))
    before = RocEncoder.chained_launches
    t_blk, blk = cuda_ms(lambda: RocBlockGraph(g0, block=GRAPH_BLOCK))
    per_unit = {"roc_encode_chained": RocEncoder.chained_launches - before}
    t_cb, cb = cuda_ms(lambda: CompactBitGraph(g0))
    t_ef, efg = cuda_ms(lambda: EliasFanoGraph(g0))
    containers = {"Graph": g0, "RocGraph": rg, "RocBlockGraph": blk,
                  "CompactBitGraph": cb, "EliasFanoGraph": efg}
    level0 = {}
    for name, c in containers.items():
        before = RocDecoder.launches, RocDecoder.chained_launches
        level0[name] = h.search(xq_d, HNSW_NPROBE, ef=HNSW_EF, graph0=c)
        torch.cuda.synchronize()
        if name == "RocGraph":
            hops = RocDecoder.launches - before[0]  # one decode launch per hop
        if name == "RocBlockGraph":
            per_unit["roc_decode_chained"] = RocDecoder.chained_launches - before[1]
    launches = {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches,
                "roc_encode_chained": RocEncoder.chained_launches,
                "roc_decode_chained": RocDecoder.chained_launches}
    # ----
    if min(launches.values()) < 1:
        raise AssertionError(f"[hnsw] a kernel of the path was not launched: {launches}")

    N0 = h.levels.shape[0]
    per_level = [int((h.levels >= l).sum()) for l in range(h.max_level + 1)]
    edges = int((h.layers[0] >= 0).sum())
    log(f"[hnsw] IVF{HNSW_NLIST}_HNSW{HNSW_M},Flat: k-means of {len(xt)} training vectors "
        f"{t_train:.1f} s; HNSW quantizer over the {N0} centroids {t_quant:.1f} s, of which "
        f"the host link loop {sum(link_s):.1f} s in {len(link_s)} calls and the walks on the "
        f"card the rest (M {h.M}, ef_construction {h.ef_construction}, seed {h.seed}): "
        f"{h.max_level + 1} "
        f"levels, nodes per level {per_level}, entry {h.entry}, level-0 edges {edges} "
        f"(mean degree {edges / N0:.2f} of {h.Mmax0}); add of {index.ntotal} vectors "
        f"{t_add:.1f} s (host clock, synchronised)")
    # gate 2: every vector in exactly one list, its HNSW top-1 (exact nearest
    # for a miss); the walk again over the first chunk gives the same top-1
    lengths = index.invlists.lengths
    ids = np.concatenate(index.invlists.ids).view(np.int64)
    if not np.array_equal(np.sort(ids), np.arange(NB)):
        raise AssertionError("[hnsw] the lists do not hold every vector exactly once")
    got = np.empty(NB, dtype=np.int64)
    got[ids] = np.repeat(np.arange(HNSW_NLIST), lengths)
    top1 = torch.cat(walked)
    again = index.coarse_assign(xb_d[:len(walked[0])], 1)[:, 0]
    if top1.shape != (NB,) or not torch.equal(again, walked[0]):
        raise AssertionError("[hnsw] add did not walk every vector once, or a second walk "
                             "of its first chunk differs")
    missed = torch.nonzero(top1 < 0)[:, 0]
    want = top1.clone()
    if missed.numel():
        want[missed] = assign(xb_d[missed], index.centroids)
    if not np.array_equal(got, want.cpu().numpy()):
        raise AssertionError("[hnsw] a vector's list is not its HNSW top-1 (or exact nearest)")
    log(f"[hnsw] add: every vector in exactly one list, its HNSW top-1 (in {len(walked)} "
        f"walks; a second walk of the first {len(walked[0])} gives the same); misses (-1, "
        f"assigned to the exact nearest centroid) {missed.numel()}; list lengths "
        f"{lengths.min()}..{lengths.max()} (mean {lengths.mean():.2f}, "
        f"{int((lengths == 0).sum())} empty)")
    # gate 1: the ROC search equals the uncompressed one
    if I1.shape != (NQ, K) or not bool(torch.isfinite(D1).all()) or int(I1.min()) < 0:
        raise AssertionError("[hnsw] search: bad shape, non-finite distances or empty slots")
    if not torch.equal(I1.sort(dim=1).values, I0.sort(dim=1).values):
        raise AssertionError("[hnsw] ROC search rows differ from the uncompressed search")
    torch.testing.assert_close(D1, D0, rtol=1e-4, atol=1e-3)
    log(f"[hnsw] RocInvertedLists search == uncompressed search on {NQ} queries, nprobe "
        f"{HNSW_NPROBE} (sorted I rows equal, D within rtol 1e-4 atol 1e-3; D identical: "
        f"{torch.equal(D1, D0)}); bits/id {roc.compressed_ids_size_in_bytes * 8 / NB:.4f} "
        f"(built in {t_roc:.1f} ms)")
    # gate 4: the five level-0 containers give identical I and D
    Dg, Ig = level0["Graph"]
    for name, (Dc, Ic) in level0.items():
        if not (torch.equal(Ic, Ig) and torch.equal(Dc, Dg)):
            raise AssertionError(f"[hnsw] HNSW.search with graph0={name}: I or D differs")
    for name, c, t in (("RocGraph", rg, t_rg), ("RocBlockGraph", blk, t_blk),
                       ("CompactBitGraph", cb, t_cb), ("EliasFanoGraph", efg, t_ef)):
        log(f"[hnsw] level 0 as {name}: built in {t:.1f} ms (CUDA events), bits/edge "
            f"{c.compressed_ids_size_in_bytes * 8 / edges:.4f} + overhead "
            f"{c.overhead_in_bytes * 8 / edges:.4f}")
    log(f"[hnsw] HNSW.search of {NQ} queries (k {HNSW_NPROBE}, ef {HNSW_EF}) over the "
        f"centroids: I and D identical with graph0 = Graph, RocGraph, "
        f"RocBlockGraph(block={GRAPH_BLOCK}), CompactBitGraph, EliasFanoGraph; {hops} hops; "
        f"launches {launches}")
    # gate 3: the device walk against the host oracle on NQ_HOST queries
    entries = hnsw_descend_device(h, xq_d[:NQ_HOST])
    cur = np.full(NQ_HOST, h.entry, dtype=np.int64)
    everyone = torch.ones(N0, dtype=torch.bool, device=cuda)
    for lv in range(h.max_level, 0, -1):
        cur = h._greedy_descend(np.arange(NQ_HOST), cur, lv, everyone, xq=xq_d[:NQ_HOST])
    if not np.array_equal(entries.cpu().numpy(), cur):
        raise AssertionError("[hnsw] hnsw_descend_device differs from the host greedy descent")
    host = [search_graph(g0, h._xb, xq_d[i:i + 1], HNSW_NPROBE, L=HNSW_EF, entry=int(cur[i]))
            for i in range(NQ_HOST)]
    Dh, Ih = torch.cat([r[0] for r in host]), torch.cat([r[1] for r in host])
    ties = assert_near_ties("[hnsw] device walk vs host oracle", Dg[:NQ_HOST], Ig[:NQ_HOST],
                            Dh, Ih, 1e-5, 1e-5)
    log(f"[hnsw] on {NQ_HOST} queries the device walk (hnsw_descend_device + "
        f"search_graph_device) == the host oracle (greedy descent + host search_graph per "
        f"query from its entry): entries identical, I and D under the near-tie rule (rtol "
        f"1e-5; labels at near ties {ties})")

    # times: the coarse walk, the scan, the translate; the flat quantizer beside
    coarse_ms = median_ms(lambda: index.coarse_assign(xq, HNSW_NPROBE))
    times = {}
    for name, container in (("uncompressed", index.invlists), ("RocInvertedLists", roc)):
        index.replace_invlists(container)
        times[name] = search_times(index, xq, f"IVF{HNSW_NLIST}_HNSW{HNSW_M} {name}",
                                   HNSW_NPROBE)
    probes = index.coarse_assign(xq, HNSW_NPROBE)
    rec = {"HNSW quantizer": recalls(I1, I_bf)[1]}
    index.quantizer = "flat"
    flat_ms = median_ms(lambda: index.coarse_assign(xq, HNSW_NPROBE))
    exact = index.coarse_assign(xq, HNSW_NPROBE)
    for name, container in (("uncompressed", index.invlists), ("RocInvertedLists", roc)):
        index.replace_invlists(container)
        times[f"{name}, flat quantizer"] = search_times(
            index, xq, f"IVF{HNSW_NLIST},Flat (flat quantizer) {name}", HNSW_NPROBE)
    rec["flat quantizer"] = recalls(index.search(xq, K)[1], I_bf)[1]
    index.quantizer = "hnsw"
    overlap = float((probes[:, :, None] == exact[:, None, :]).any(2).float().mean())
    log(f"[hnsw] coarse ms (CUDA-event medians of 5 after a warm-up, {NQ} queries, top "
        f"{HNSW_NPROBE}): HNSW walk {coarse_ms:.2f} ({hops} hops), flat product "
        f"{flat_ms:.2f}; probes of the HNSW walk in the exact top-{HNSW_NPROBE}: "
        f"{overlap:.4f}; recall@{K} against brute force: " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in rec.items()))
    log(f"[hnsw] search ms ({NQ} queries, nprobe {HNSW_NPROBE}, median of 5 after a warm-up) "
        "= positional (coarse + scan) + translate: " + "; ".join(
            f"{name} {t[0]:.2f} = {t[1]:.2f} + {t[2]:.2f} ({t[3]} touched lists)"
            for name, t in times.items()))
    l0_ms = {name: median_ms(lambda c=c: h.search(xq_d, HNSW_NPROBE, ef=HNSW_EF, graph0=c))
             for name, c in containers.items()}
    log(f"[hnsw] level-0 search ms (HNSW.search, {NQ} queries, k {HNSW_NPROBE}, CUDA-event "
        "medians of 5 after a warm-up): " + ", ".join(f"{n} {t:.2f}" for n, t in l0_ms.items()))

    # gate 6: the HNSW and the index saved, loaded and searched as before
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "artifact.npz"
        r_h, lh = round_trip(path, "[hnsw] HNSW", h, save_hnsw,
                             lambda p: load_hnsw(p, index.centroids, device=cuda))
        Dl, Il = lh.search(xq_d, HNSW_NPROBE, ef=HNSW_EF)
        if not (torch.equal(Il, Ig) and torch.equal(Dl, Dg)):
            raise AssertionError("[hnsw] the loaded HNSW searches otherwise than the built")
        r_i, li = round_trip(path, "[hnsw] index", index, save_index,
                             lambda p: load_index(p, device=cuda))
        # the file holds the quantizer's parameters; its graph is the HNSW file's
        li._quantizer_hnsw, li._quantizer_src = lh, li.centroids
        Dli, Ili = li.search(xq, K)
        if not (torch.equal(Ili, I0) and torch.equal(Dli, D0)):
            raise AssertionError("[hnsw] the loaded index searches otherwise than the built")
    for what, r in (("HNSW (save_hnsw)", r_h), ("index (save_index)", r_i)):
        log(f"[hnsw] {what}: {r['bytes']} bytes; save {r['save_ms']:.1f}, stamp "
            f"{r['stamp_ms']:.1f}, verify {r['verify_ms']:.1f}, load {r['load_ms']:.1f} ms (host "
            f"clock); loaded and searched: I and D identical to the built")
    index.replace_invlists(roc)
    return index, roc, containers, Ig[:, 0], launches, per_unit


def qinco_code_ties(codec, x, got, want, tie: float = 1e-5) -> int:
    """Code rows ``got`` and ``want`` u8[n, M] of the vectors ``x`` (CPU
    tensors): equal, or the first step at which a row differs is a near tie
    under ``codec``'s model (on the CPU): the two chosen candidates'
    distances within ``tie`` relative. Raises otherwise; returns the rows
    that differ."""
    rows = torch.nonzero((got != want).any(dim=1))[:, 0].tolist()
    model = codec.model
    with torch.no_grad():
        for r in rows:
            m = int(torch.nonzero(got[r] != want[r])[0, 0])
            x_hat = torch.zeros((1, x.shape[1]))
            for j in range(m):
                x_hat = x_hat + model.steps[j].selected(x_hat, want[r:r + 1, j].long())
            d2 = ((model.steps[m](x_hat)[0] - (x[r] - x_hat)) ** 2).sum(-1)
            a, b = float(d2[int(got[r, m])]), float(d2[int(want[r, m])])
            if abs(a - b) > tie * max(abs(a), abs(b)):
                raise AssertionError(f"[qinco] vector {r}: codes differ at step {m} without a "
                                     f"near tie ({a} against {b})")
    return len(rows)


def qinco_lists_recovered(name, c, index) -> None:
    """Every list's ids from the container ``c`` (``decode_lists`` over all
    of [qinco]'s lists, each sorted) equal the index's source lists, or the
    run fails."""
    cuda = torch.device("cuda")
    lengths = index.invlists.lengths
    big = torch.iinfo(torch.int64).max
    src = torch.full((HNSW_NLIST, max(int(lengths.max()), 1)), big, dtype=torch.int64)
    for ln in np.flatnonzero(lengths):
        src[ln, : lengths[ln]] = torch.from_numpy(np.sort(index.invlists.ids[ln].view(np.int64)))
    src = src.to(cuda)
    for lo in range(0, HNSW_NLIST, 16384):
        hi = min(lo + 16384, HNSW_NLIST)
        ids, lens = c.decode_lists(torch.arange(lo, hi, device=cuda))
        cols = torch.arange(ids.shape[1], device=cuda)[None, :]
        got = torch.where(cols < lens[:, None], ids, big).sort(dim=1).values
        if not (torch.equal(lens.cpu(), torch.from_numpy(lengths[lo:hi]))
                and torch.equal(got, src[lo:hi, : got.shape[1]])):
            raise AssertionError(f"[qinco] {name}: the ids of lists {lo}..{hi - 1} differ from "
                                 "the source lists")


def phase_qinco(seed: int, xt, centroids, xb, xq, I_bf):
    """IVF65536,QINCo16x8 with the flat quantizer over the [main] database,
    the shortlist re-ranked through the neural decoder: the paper's Table 4
    operating point (BigANN10M, IVF65k_16x8, nprobe 64, nshort 100), cut to
    the same 10^6 database vectors as every phase (the run's time limit). The
    65,536 centroids are [hnsw]'s k-means (over ``xt``, 2^21 vectors of the
    mixture), assigned directly; the codec is trained on ``xt``'s residuals
    to them, as ``IndexIVF.train`` trains it after its k-means. Then add,
    the search with the uncompressed lists and then with each container of
    ``AVAILABLE_COMPRESSED_IVFS`` (the shortlist's codes harvested; the
    translate by random access except for ``roc``, as ``search_ivf_qinco``
    runs it), each re-ranked; fails unless every container's search returns
    the uncompressed search's shortlist and re-ranked ids, every list's ids
    come back from each container, both ROC kernels ran, the card's codec
    equals the CPU's on QINCO_CHECK vectors, and the index saved and loaded
    searches as before. Returns (the index, its ROC container, this phase's
    launch counts)."""
    from vector_db_id_compression_tpu_torch.bench.search_ivf_qinco import rerank
    from vector_db_id_compression_tpu_torch.models.qinco import QincoCodec
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index, save_index
    from vector_db_id_compression_tpu_torch.search.kmeans import assign
    from vector_db_id_compression_tpu_torch.store.invlists import AVAILABLE_COMPRESSED_IVFS

    cuda = torch.device("cuda")
    xq_d = torch.from_numpy(xq).to(cuda)
    xt_d = torch.from_numpy(xt).to(cuda)
    resid = xt_d - centroids[assign(xt_d, centroids)]
    del xt_d
    spans = {}

    def search(one_by_one=None):
        return index.search_defer_id_decoding(xq, QINCO_NSHORT, nprobe=QINCO_NPROBE,
                                              decode_1by1=one_by_one, return_codes=2)

    def counts():
        return {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches}

    # ---- the [qinco] path, through the user-facing entry points; the
    # kernels' launch counts are read from this window only
    RocEncoder.launches = RocDecoder.launches = 0
    codec = QincoCodec(D, QINCO_M, QINCO_KSUB, QINCO_HIDDEN, seed=seed, device=cuda)
    index = IndexIVF(D, HNSW_NLIST, storage="qinco", nprobe=QINCO_NPROBE, qinco=codec,
                     device=cuda)
    index.centroids = centroids
    codec._rq_init = timed(spans, "rq_init", codec._rq_init)
    t_train, _ = host_s(lambda: codec.train(resid, steps=QINCO_STEPS, batch_size=QINCO_BATCH))
    del codec._rq_init
    codec.encode = timed(spans, "encode", codec.encode)
    t_add, _ = host_s(lambda: index.add(xb))
    del codec.encode
    D0, I0, C0 = search()
    R0 = rerank(index, xq_d, I0, C0, K)
    modes = {}
    for name, make in AVAILABLE_COMPRESSED_IVFS.items():
        before = counts()
        t_build, c = cuda_ms(lambda: make(index.invlists, device=cuda))
        index.replace_invlists(c)
        one_by_one = name != "roc"  # search_ivf_qinco's policy (reference :417)
        Dm, Im, Cm = search(one_by_one)
        modes[name] = {"container": c, "build_ms": t_build, "one_by_one": one_by_one,
                       "out": (Dm, Im, Cm), "rerank": rerank(index, xq_d, Im, Cm, K)}
        torch.cuda.synchronize()
        modes[name]["launches"] = {k: n - before[k] for k, n in counts().items()}
    launches = counts()
    # ----
    if min(launches.values()) < 1:
        raise AssertionError(f"[qinco] a kernel of the path was not launched: {launches}")
    lengths = index.invlists.lengths
    log(f"[qinco] IVF{HNSW_NLIST},QINCo{QINCO_M}x{QINCO_KSUB.bit_length() - 1} (hidden "
        f"{QINCO_HIDDEN}) over {index.ntotal} vectors, [hnsw]'s centroids: codec trained on "
        f"{len(xt)} residuals in {t_train:.1f} s (RQ init {spans['rq_init']:.1f} s, "
        f"{QINCO_STEPS} Adam steps of {QINCO_BATCH} {t_train - spans['rq_init']:.1f} s, final "
        f"loss {codec.loss:.4f}); add {t_add:.1f} s, of which encode {spans['encode']:.1f} s "
        f"({index.ntotal / spans['encode']:.0f} vectors/s); list lengths {lengths.min()}.."
        f"{lengths.max()} (mean {lengths.mean():.2f}, {int((lengths == 0).sum())} empty); "
        f"code bytes per vector {index.code_size} ({QINCO_M} codes + 4 norm); launches "
        f"{launches} (host clock, synchronised)")

    # gate 1: every container's search returns the uncompressed shortlist
    # (the same entries' codes) and the same re-ranked ids; gate 2: every
    # list's ids from every container
    width = index.coarse_code_size + index.code_size
    o0 = I0.argsort(dim=1)
    rows = torch.arange(NQ, device=cuda)[:, None]
    _, L = index.search_positional(xq, QINCO_NSHORT, QINCO_NPROBE)
    labels = int((L >= 0).sum())
    for name, m in (("uncompressed", {"out": (D0, I0, C0)}), *modes.items()):
        Dx, Ix, Cx = m["out"]
        if (Ix.shape != (NQ, QINCO_NSHORT) or Cx.shape != (NQ, QINCO_NSHORT, width)
                or int(Ix.max()) >= NB or not bool(torch.isfinite(Dx[Ix >= 0]).all())):
            raise AssertionError(f"[qinco] {name} search: bad shapes, ids or distances")
    for name, m in modes.items():
        c, (Dx, Ix, Cx) = m["container"], m["out"]
        o1 = Ix.argsort(dim=1)
        if not (torch.equal(I0.gather(1, o0), Ix.gather(1, o1))
                and torch.equal(C0[rows, o0], Cx[rows, o1])):
            raise AssertionError(f"[qinco] the {name} search's shortlist (ids or codes) differs "
                                 "from the uncompressed search's")
        torch.testing.assert_close(Dx, D0, rtol=1e-4, atol=1e-3)
        ties = assert_near_ties(f"[qinco] re-rank after the {name} search", *m["rerank"], *R0,
                                1e-6, 1e-6)
        qinco_lists_recovered(name, c, index)
        index.replace_invlists(c)
        translate_ms = median_ms(lambda: index._translate(L, m["one_by_one"]))
        kernels, copies, device_ms = device_ops(lambda: index._translate(L, m["one_by_one"]))
        search_ms = median_ms(lambda: search(m["one_by_one"]))
        how = ("random access" if m["one_by_one"] and c.supports_random_access else "grouped")
        log(f"[qinco] {name} (nprobe {QINCO_NPROBE}, shortlist {QINCO_NSHORT}, return_codes=2, "
            f"{how} translate) == uncompressed: the same ids and entry codes per row, D within "
            f"rtol 1e-4 atol 1e-3 (identical: {torch.equal(Dx, D0)}); re-ranked top {K} equal "
            f"under the near-tie rule, rtol 1e-6 (labels at near ties {ties}); every list's ids "
            f"recovered by decode_lists; bits/id {c.compressed_ids_size_in_bytes * 8 / NB:.4f} + "
            f"overhead {c.overhead_in_bytes * 8 / NB:.4f}; built in {m['build_ms']:.1f} ms; "
            f"translate of {labels} labels {translate_ms:.3f} ms ({kernels} kernels, {copies} "
            f"copies/memsets, device busy {device_ms:.3f} ms); search {search_ms:.2f} ms "
            f"(CUDA-event medians of 5 after a warm-up); ROC kernel launches in its path "
            f"{m['launches']}")
    roc = modes["roc"]["container"]
    index.replace_invlists(roc)
    D1, I1, C1 = modes["roc"]["out"]
    R1 = modes["roc"]["rerank"]
    del modes

    # gate 3: the card's codec against the same weights on the CPU
    cpu = QincoCodec(D, QINCO_M, QINCO_KSUB, QINCO_HIDDEN, device="cpu").load_state_dict(
        {k: v.cpu() for k, v in codec.model.state_dict().items()})
    xs = xb[:QINCO_CHECK] - centroids[assign(torch.from_numpy(xb[:QINCO_CHECK]).to(cuda),
                                             centroids)].cpu().numpy()
    t_cpu, codes_cpu = host_s(lambda: cpu.encode(xs))
    codes_card = codec.encode(xs).cpu()
    differ = qinco_code_ties(cpu, torch.from_numpy(xs), codes_card, codes_cpu)
    rec_err = float((codec.decode(codes_card).cpu() - cpu.decode(codes_card)).abs().max())
    if rec_err > 1e-4:
        raise AssertionError(f"[qinco] decode on the card vs the CPU: max error {rec_err}")
    log(f"[qinco] the card's codec == the CPU's on {QINCO_CHECK} residuals: codes equal but "
        f"{differ} rows (each at a near tie, 1e-5 relative), decode max abs error {rec_err:.2e} "
        f"(<= 1e-4); CPU encode {t_cpu:.1f} s")

    # reports: the search's parts, the re-rank, recall, the idle share
    _, L = index.search_positional(xq, QINCO_NSHORT, QINCO_NPROBE)
    pos_ms = median_ms(lambda: index.search_positional(xq, QINCO_NSHORT, QINCO_NPROBE))
    harvest_ms = median_ms(lambda: index._harvest_codes(L, True))
    translate_ms = median_ms(lambda: index._translate(L))
    search_ms = median_ms(search)
    rerank_ms = median_ms(lambda: rerank(index, xq_d, I1, C1, K))
    idle = profile_fn(lambda: rerank(index, xq_d, *search()[1:], K),
                      f"IVF{HNSW_NLIST},QINCo{QINCO_M} ROC search + re-rank")
    rec = {"re-ranked": recalls(R1[1], I_bf), f"linear (the scan's top {K})": recalls(I1[:, :K],
                                                                                      I_bf)}
    hit = float((R1[1] == I_bf[:, :1]).any(1).float().mean())
    log(f"[qinco] ms ({NQ} queries, CUDA-event medians of 5 after a warm-up): search "
        f"{search_ms:.2f} = positional {pos_ms:.2f} + harvest {harvest_ms:.2f} + translate "
        f"{translate_ms:.2f} ({int(torch.unique(L[L >= 0] >> 32).numel())} touched lists); "
        f"re-rank {rerank_ms:.2f} ({NQ * QINCO_NSHORT} decodes); idle share of search + "
        f"re-rank {idle:.2f}; recall@1, recall@{K} against brute force: " + ", ".join(
            f"{name} {r[0]:.4f}, {r[1]:.4f}" for name, r in rec.items())
        + f"; the true nearest in the re-ranked top {K}: {hit:.4f}")

    # gate 4: the index saved, loaded and searched as before (the file holds
    # the uncompressed lists)
    with tempfile.TemporaryDirectory() as tmp:
        r, li = round_trip(Path(tmp) / "artifact.npz", "[qinco] index", index, save_index,
                           lambda p: load_index(p, device=cuda))
    Dl, Il, Cl = li.search_defer_id_decoding(xq, QINCO_NSHORT, nprobe=QINCO_NPROBE,
                                             return_codes=2)
    Rl = rerank(li, xq_d, Il, Cl, K)
    if not all(torch.equal(a, b) for a, b in ((Dl, D0), (Il, I0), (Cl, C0), *zip(Rl, R0))):
        raise AssertionError("[qinco] the loaded index searches or re-ranks otherwise")
    log(f"[qinco] index (save_index, QINCo weights as {5 * QINCO_M} leaves): {r['bytes']} "
        f"bytes; save {r['save_ms']:.1f}, stamp {r['stamp_ms']:.1f}, verify "
        f"{r['verify_ms']:.1f}, load {r['load_ms']:.1f} ms (host clock); loaded and searched: "
        f"D, I, codes and the re-rank identical to the built index's")
    return index, roc, launches


def time_qinco_kernels(index, roc, xq):
    """Both ROC kernels beside their plain versions over [qinco]'s 65,536
    lists (``lane_kernels_vs_plain_by_bucket``), and the decode of the lists
    one search's translate touches. Returns the numbers by kernel (keys
    prefixed ``qinco_``)."""
    from vector_db_id_compression_tpu_torch.store.invlists import roc_lane_table

    sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
    enc_ms, enc_plain_ms, enc_err, dec_ms, dec_plain_ms, dec_err = \
        lane_kernels_vs_plain_by_bucket(sorted_ids, lengths, prec, roc.decoder)
    if enc_err or dec_err:
        raise AssertionError(f"kernels vs plain at [qinco]'s {HNSW_NLIST} lists: encode "
                             f"{enc_err}, decode {dec_err}")
    _, L = index.search_positional(xq, QINCO_NSHORT, QINCO_NPROBE)
    touched = torch.unique(L[L >= 0] >> 32)
    touched_ms = median_ms(lambda: roc.decoder.decode_lanes(touched))
    log(f"[timing] qinco, {HNSW_NLIST} lists, n_max {sorted_ids.shape[1]}: encode kernel "
        f"{enc_ms:.3f} ms vs plain {enc_plain_ms:.1f} ms; decode kernel {dec_ms:.3f} ms vs "
        f"plain {dec_plain_ms:.1f} ms (plain: by size bucket, summed); decode of the "
        f"{touched.numel()} lists one search touches {touched_ms:.3f} ms; both == plain == the "
        f"container's streams")
    return {"roc_encode": {"max_abs_err": enc_err, "qinco_lists_ms": enc_ms,
                           "qinco_lists_plain_ms": enc_plain_ms},
            "roc_decode": {"max_abs_err": dec_err, "qinco_lists_ms": dec_ms,
                           "qinco_lists_plain_ms": dec_plain_ms,
                           "qinco_touched_lists": touched.numel(),
                           "qinco_touched_ms": touched_ms,
                           "qinco_touched_bound_ms": decode_bound(roc.decoder, touched)[0]}}


def time_hnsw_kernels(index, roc, level0, nodes, launches, per_unit, chain):
    """The ROC kernels beside their plain versions at [hnsw]'s shapes: encode
    and decode of the 65,536 lists, and the level-0 graph's per-node and
    chained kernels (``time_graph_kernels``: every node's or block's encode,
    the lanes and blocks of one hop's frontier). Returns, by kernel, its
    numbers at these shapes (keys prefixed ``hnsw_``). ``level0``: the
    level-0 containers by name."""
    from vector_db_id_compression_tpu_torch.store.invlists import roc_lane_table
    from vector_db_id_compression_tpu_torch.store.ragged import bucketize

    sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
    enc_ms, enc_plain_ms, enc_err, dec_ms, dec_plain_ms, dec_err = \
        lane_kernels_vs_plain_by_bucket(sorted_ids, lengths, prec, roc.decoder)
    if enc_err or dec_err:
        raise AssertionError(f"kernels vs plain at the {HNSW_NLIST} lists: encode {enc_err}, "
                             f"decode {dec_err}")
    log(f"[timing] hnsw, {HNSW_NLIST} lists, n_max {sorted_ids.shape[1]}: encode kernel "
        f"{enc_ms:.3f} ms vs plain {enc_plain_ms:.1f} ms; decode kernel {dec_ms:.3f} ms vs "
        f"plain {dec_plain_ms:.1f} ms (kernels: the whole table, CUDA-event medians; plain: "
        f"its {len(bucketize(lengths)) + 1} size buckets, one run each, summed); both == "
        f"plain == the container's streams")
    per_node, chained = time_graph_kernels(level0["Graph"], level0["RocGraph"],
                                           level0["RocBlockGraph"], nodes, launches, per_unit,
                                           chain, label="hnsw level 0")
    out = {"roc_encode": {"max_abs_err": max(enc_err, per_node["roc_encode"]["max_abs_err"]),
                          "hnsw_lists_ms": enc_ms, "hnsw_lists_plain_ms": enc_plain_ms,
                          "hnsw_level0_ms": per_node["roc_encode"]["graph_ms"],
                          "hnsw_level0_plain_ms": per_node["roc_encode"]["graph_plain_ms"]},
           "roc_decode": {"max_abs_err": max(dec_err, per_node["roc_decode"]["max_abs_err"]),
                          "hnsw_lists_ms": dec_ms, "hnsw_lists_plain_ms": dec_plain_ms,
                          "hnsw_fetch_ms": per_node["roc_decode"]["graph_fetch_ms"],
                          "hnsw_fetch_plain_ms": per_node["roc_decode"]["graph_fetch_plain_ms"]}}
    for e in chained:
        out[e["name"]] = {"max_abs_err": e["max_abs_err"], "hnsw_ms": e["ms"],
                          "hnsw_plain_ms": e["plain_ms"], "hnsw_bound_ms": e["bound_ms"],
                          "hnsw_launches_per_unit": e.get("launches_per_search",
                                                          e.get("launches_per_build"))}
    return out


def bench_launches():
    """The four ROC kernels' launch counts as they stand."""
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder

    return {"roc_encode": RocEncoder.launches, "roc_decode": RocDecoder.launches,
            "roc_encode_chained": RocEncoder.chained_launches,
            "roc_decode_chained": RocDecoder.chained_launches}


def codec_scale_sample(args, lanes: int = 256, seed: int = 0):
    """``codec_scale``'s workload and lanes (its own numpy functions) for
    ``args`` [ntotal, nlist, chunk target]; ``lanes`` of them drawn with
    ``seed`` encoded by the encode kernel and by its plain version (CPU),
    then decoded by the decode kernel and by its plain version: states and
    ids equal, or the run fails. Returns the lanes' count and max length."""
    from vector_db_id_compression_tpu_torch.bench import codec_scale
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder

    ntotal, nlist, chunk = args
    ids, lengths, prec = codec_scale.build_workload(ntotal, nlist, BENCH_SEED)
    ent, ent_len, ent_prec, *_ = codec_scale.build_entries(ids, lengths, prec, "auto", chunk)
    rows = np.sort(np.random.default_rng(seed).choice(len(ent), lanes, replace=False))
    n_max = int(ent_len[rows].max())
    ids_t = torch.from_numpy(codec_scale.padded_entries(ent, rows, n_max))
    len_t, prec_t = torch.from_numpy(ent_len[rows]), torch.from_numpy(ent_prec[rows])
    cuda = torch.device("cuda")
    st_k, order_k = RocEncoder.encode(ids_t.to(cuda), len_t.to(cuda), prec_t.to(cuda))
    st_p, order_p = RocEncoder.encode(ids_t, len_t, prec_t)
    for field, got, want in zip(st_k._fields, (*st_k, order_k), (*st_p, order_p)):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"[bench] codec_scale lanes: encode kernel's {field} differs "
                                 "from the plain version")
    pool = rd.default_pool(n_max)
    got = RocDecoder(st_k, len_t.to(cuda), prec_t.to(cuda), pool.to(cuda), n_max).decode()
    want = RocDecoder(st_p, len_t, prec_t, pool, n_max).decode()
    if not torch.equal(got.cpu(), want):
        raise AssertionError("[bench] codec_scale lanes: decode kernel's ids differ from the "
                             "plain version")
    return lanes, n_max


def phase_bench():
    """The experiment drivers (``vector_db_id_compression_tpu_torch/bench/``),
    each through its ``main(argv)`` with ``--device cuda``, their outputs in a
    temporary directory: the P1 IVF bench and the codec at full size (the
    JAX package's recorded runs, results/*_tpu.*), the rest at the sizes of
    ``BENCH_ARGS``. Gates: every driver's own checks (round trips, oracles,
    invariance asserts), recall equal across every id container of a driver,
    64 bits/id for P1's raw lists and fewer for every id codec, the ROC
    QINCo shortlist and re-rank equal the uncompressed ones, and the ROC kernels launched by the
    drivers that reach them; then ``codec_scale``'s lanes held against the
    plain versions. Returns the drivers' launches by kernel; the numbers
    are logged."""
    from vector_db_id_compression_tpu_torch.bench import (
        bench_invlists, codec_scale, generate_graph_edgelists, graph_dynamic_bench,
        graph_static_bench, hnsw_bench, quantizer_bench, scaling, search_100m,
        search_ivf_qinco, wt_translate_bench)
    from vector_db_id_compression_tpu_torch.bench.datasets import get_dataset
    from vector_db_id_compression_tpu_torch.bench.search_ivf_qinco import rerank
    from vector_db_id_compression_tpu_torch.codecs.packed_bits import packed_width
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.ivf import load_index
    from vector_db_id_compression_tpu_torch.store.invlists import (AVAILABLE_COMPRESSED_IVFS,
                                                                   RocInvertedLists)

    cuda = torch.device("cuda")
    spent, found = {}, {}

    def drive(name, module, argv):
        """``module.main(argv)`` on the card, its host-clock seconds and
        its launches by kernel."""
        before = bench_launches()
        t0 = time.perf_counter()
        out = module.main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        spent[name] = round(time.perf_counter() - t0, 1)
        after = bench_launches()
        return out, {k: after[k] - before[k] for k in after}

    def equal_recall(what, rows, key="nprobe"):
        by = {}
        for r in rows:
            by.setdefault(r.get(key), set()).add(r["recall_1"])
        if any(len(v) != 1 for v in by.values()):
            raise AssertionError(f"[bench] {what}: recall_1 differs between id containers: {by}")
        return {k: v.pop() for k, v in by.items()}

    def need(what, got, kernels):
        if min(got[k] for k in kernels) < 1:
            raise AssertionError(f"[bench] {what}: a kernel of its path was not launched: {got}")

    RocEncoder.launches = RocEncoder.chained_launches = 0
    RocDecoder.launches = RocDecoder.chained_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ---- P1 at the JAX run's size
        rows, got = drive("bench_invlists", bench_invlists, [
            "--dataset", "synthetic", *BENCH_ARGS["bench_invlists"],
            "--out", str(tmp / "ivf.csv")])
        need("bench_invlists", got, ["roc_encode", "roc_decode"])
        recall = equal_recall("bench_invlists", rows)
        for r in rows:
            # the raw lists hold 64 bits an id, every id codec fewer
            if (r["bits_per_id"] == 64.0) != (r["method"] == "ref"):
                raise AssertionError(f"[bench] bench_invlists {r['method']}: "
                                     f"{r['bits_per_id']} bits/id")
        found["bench_invlists"] = {"recall_1": recall, "launches": got, "rows": [
            {k: r[k] for k in ("method", "nprobe", "dt_search", "bits_per_id", "ids_size",
                               "overhead_size", "build_time")} for r in rows]}
        log(f"[bench] bench_invlists IVF1024,Flat over 10^6 (d 32), 6 methods: recall@1 "
            f"{recall} equal across them; launches {got}")
        for r in rows:
            log(f"[bench]   {r['method']:15s} nprobe {r['nprobe']:3d}: {r['dt_search'] * 1e3:.3f} "
                f"ms (median of {r['runs']}), {r['bits_per_id']:.4f} bits/id, overhead "
                f"{r['overhead_size']} B, build {r['build_time']:.3f} s")

        # ---- the codec alone at 10M ids in 65,536 lists
        row, got = drive("codec_scale", codec_scale, BENCH_ARGS["codec_scale"])
        need("codec_scale", got, ["roc_encode", "roc_decode"])
        found["codec_scale"] = {**row, "launches": got}
        log(f"[bench] codec_scale {row['ntotal']} ids, {row['nlist']} lists, {row['lanes']} "
            f"lanes (n_max {row['lane_n_max']}): every lane round-trips; {row['bits_per_id']} "
            f"bits/id (the JAX package's recorded run: {JAX_CODEC_SCALE_BITS}, "
            f"{'equal' if row['bits_per_id'] == JAX_CODEC_SCALE_BITS else 'DIFFERENT'}); "
            f"decode {row['decode_mids_s']} Mids/s (one-shot with the ids' transfer "
            f"{row['decode_oneshot_mids_s']}), encode {row['encode_mids_s']} Mids/s, host "
            f"build {row['host_encode_s']} s; launches {got}")

        # ---- P2: NSG R = 32, the five adjacency containers
        rows, got = drive("graph_dynamic_bench", graph_dynamic_bench, [
            *BENCH_ARGS["graph_dynamic_bench"], "--out", str(tmp / "g.csv")])
        need("graph_dynamic_bench", got, list(got))
        recall = equal_recall("graph_dynamic_bench", rows, key="max_degree")
        found["graph_dynamic_bench"] = {"recall_1": recall, "launches": got, "rows": [
            {k: r[k] for k in ("method", "dt_search", "dt_search_sustained", "bits_per_edge",
                               "build_time")} for r in rows]}
        log(f"[bench] graph_dynamic_bench NSG32 ({BENCH_ARGS['graph_dynamic_bench']}): recall@1 "
            f"{recall} equal across the five containers; launches {got}")
        for r in rows:
            log(f"[bench]   {r['method']:10s}: {r['dt_search'] * 1e3:.3f} ms (sustained "
                f"{r['dt_search_sustained'] * 1e3:.3f}), {r['bits_per_edge']:.4f} bits/edge")

        # ---- P3 and P4 at the JAX runs' nb = 4000, R = 16
        rows, _ = drive("graph_static_bench", graph_static_bench, [
            *BENCH_ARGS["graph_static"], "--out", str(tmp / "s.csv")])
        drive("generate_graph_edgelists", generate_graph_edgelists, [
            *BENCH_ARGS["graph_static"], "--outdir", str(tmp / "el")])
        rec = {r["index_str"]: r for r in rows if r["comp_method"] == "rec"}
        for index_str, r in rec.items():
            el = tmp / "el" / f"SyntheticDataset_{index_str.replace(',', '_')}.el"
            n_lines = len(el.read_text().splitlines())
            if n_lines != r["num_edges"] or not 0 < r["bpe"] < 64:
                raise AssertionError(f"[bench] {index_str}: {n_lines} edge lines, "
                                     f"{r['num_edges']} edges, {r['bpe']} bits/edge")
        found["graph_static_bench"] = [
            {k: r[k] for k in ("index_str", "comp_method", "bpe", "num_edges")} for r in rows]
        log("[bench] graph_static_bench, generate_graph_edgelists: " + "; ".join(
            f"{r['index_str']} {r['comp_method']} {r['bpe']:.4f}" for r in rows)
            + " bits/edge; the .el files hold every edge")

        # ---- HNSW level 0 in the five containers
        rows, got = drive("hnsw_bench", hnsw_bench, [*BENCH_ARGS["hnsw_bench"],
                                                     "--out", str(tmp / "h.csv")])
        need("hnsw_bench", got, list(got))
        recall = equal_recall("hnsw_bench", rows, key="M")
        found["hnsw_bench"] = {"recall_1": recall, "launches": got, "rows": [
            {k: r[k] for k in ("method", "dt_search", "bits_per_edge")} for r in rows]}
        log(f"[bench] hnsw_bench: recall@1 {recall} equal across the five containers; " + "; ".join(
            f"{r['method']} {r['dt_search'] * 1e3:.3f} ms {r['bits_per_edge']:.4f} bits/edge"
            for r in rows) + f"; launches {got}")

        # ---- P5: train and add once, search with raw and ROC ids
        work = tmp / "qinco"
        q_args = [*BENCH_ARGS["search_ivf_qinco"], "--workdir", str(work)]
        _, got_train = drive("search_ivf_qinco train add", search_ivf_qinco,
                             [*q_args, "--todo", "train", "add"])
        out, got = {}, {}
        for comp in ("none", "roc"):
            out[comp], got[comp] = drive(f"search_ivf_qinco search {comp}", search_ivf_qinco, [
                *q_args, "--todo", "search", "--id_compression", comp, "--defer_id_decoding",
                *BENCH_ARGS["search_ivf_qinco_search"]])
        need("search_ivf_qinco roc", got["roc"], ["roc_encode", "roc_decode"])
        recalls = {c: o["sweep"][0]["recalls"] for c, o in out.items()}
        # the shortlist itself, through the driver's index, under [qinco]'s
        # rule: the same ids and codes (ROC reorders entries of equal codes,
        # which tie exactly), the re-rank equal but at near ties
        index = load_index(work / "qinco_index.npz", device=cuda)
        xq_d = torch.from_numpy(get_dataset("synthetic", synth_scale=1.0,
                                            device=cuda).get_queries()).to(cuda)
        nprobe, nshort, k = 32, 100, 100
        D0, I0, C0 = index.search_defer_id_decoding(xq_d, nshort, nprobe=nprobe,
                                                    return_codes=2)
        index.replace_invlists(RocInvertedLists(index.invlists, device=cuda))
        D1, I1, C1 = index.search_defer_id_decoding(xq_d, nshort, nprobe=nprobe,
                                                    decode_1by1=False, return_codes=2)
        o0, o1 = I0.argsort(dim=1), I1.argsort(dim=1)
        rows_ = torch.arange(I0.shape[0], device=cuda)[:, None]
        if not (torch.equal(I0.gather(1, o0), I1.gather(1, o1))
                and torch.equal(C0[rows_, o0], C1[rows_, o1])):
            raise AssertionError("[bench] search_ivf_qinco: the ROC shortlist (ids or codes) "
                                 "differs from the uncompressed one")
        torch.testing.assert_close(D1, D0, rtol=1e-4, atol=1e-3)
        ties = assert_near_ties("[bench] search_ivf_qinco re-rank", *rerank(index, xq_d, I1, C1, k),
                                *rerank(index, xq_d, I0, C0, k), 1e-6, 1e-6)
        del index
        found["search_ivf_qinco"] = {
            c: {k_: o[k_] for k_ in ("bits_per_id", "comp_time", "ids_size")}
            | {"sweep": o["sweep"], "launches": got[c]} for c, o in out.items()}
        found["search_ivf_qinco"]["train_add_launches"] = got_train
        log(f"[bench] search_ivf_qinco (nlist 256, M 8, hidden 128, 300 steps; nprobe 32, "
            f"nshort 100, k 100): recalls {recalls}; the ROC shortlist (ids, codes) == "
            f"uncompressed, its re-rank too ({ties} labels at near ties); " + "; ".join(
                f"{c}: search {o['sweep'][0]['t_search'] * 1e3:.3f} ms, re-rank "
                f"{o['sweep'][0]['t_rerank'] * 1e3:.3f} ms, {o['bits_per_id']:.4f} bits/id"
                for c, o in out.items()) + f"; launches {got}")

        # ---- the wavelet-tree translate, plain and RRR planes
        found["wt_translate_bench"] = []
        for wt_type in ("0", "1"):
            row, _ = drive(f"wt_translate_bench {wt_type}", wt_translate_bench,
                           [*BENCH_ARGS["wt_translate_bench"], "--wt-type", wt_type])
            found["wt_translate_bench"].append(row)
            log(f"[bench] wt_translate_bench wt_type {wt_type}: Q {row['Q']}, {row['levels']} "
                f"levels, oracle holds; e2e {row['e2e_ms']} ms, select on the card "
                f"{row['select_chip_ms']} ms, floor {row['floor_ms']} ms")

        # ---- the coarse quantizers
        row, _ = drive("quantizer_bench", quantizer_bench, [
            *BENCH_ARGS["quantizer_bench"], "--out", str(tmp / "quantizer.json")])
        found["quantizer_bench"] = row
        log(f"[bench] quantizer_bench nlist {row['nlist']}: HNSW build {row['hnsw_build_s']} s, "
            f"flat {row['flat_ms']} ms; " + "; ".join(
                f"ef {h['ef']} {h['ms']} ms overlap {h['probe_overlap']} top-1 "
                f"{h['top1_agree']}" for h in row["hnsw"]))

        # ---- the 100M driver, cut, over all seven id containers (the JAX
        # package's recorded matrix); each container's launches counted from
        # its build to the next one's
        marks, factories = {}, dict(AVAILABLE_COMPRESSED_IVFS)

        def marked(m, make):
            def build(il, **kw):
                marks[m] = bench_launches()
                return make(il, **kw)
            return build

        AVAILABLE_COMPRESSED_IVFS.update({m: marked(m, f) for m, f in factories.items()})
        try:
            rows, got = drive("search_100m", search_100m, [
                *BENCH_ARGS["search_100m"], "--methods", *search_100m.METHODS,
                "--out", str(tmp / "s100m.json")])
        finally:
            AVAILABLE_COMPRESSED_IVFS.update(factories)
        built = [m for m in search_100m.METHODS if m != "none"]
        ends = [marks[m] for m in built[1:]] + [bench_launches()]
        per_method = {m: {k: e[k] - marks[m][k] for k in e} for m, e in zip(built, ends)}
        for m in ("roc", "roc-interleaved"):
            need(f"search_100m {m}", per_method[m], ["roc_encode", "roc_decode"])
        if [r["method"] for r in rows[::2]] != search_100m.METHODS:
            raise AssertionError(f"[bench] search_100m: rows {[r['method'] for r in rows]}")
        recall = equal_recall("search_100m", rows)
        # packed bits: packed_width(ntotal) bits an id and each list's words'
        # padding (fewer than 32 bits a list); every other codec fewer
        ntotal, nlist = rows[0]["ntotal"], rows[0]["nlist"]
        width = packed_width(ntotal)
        bits = {r["method"]: r["bits_per_id"] for r in rows}
        if not (width <= bits["packed-bits"] < width + 32 * nlist / ntotal and bits["none"] == 64
                and all(b < bits["packed-bits"] for m, b in bits.items()
                        if m not in ("none", "packed-bits"))):
            raise AssertionError(f"[bench] search_100m bits/id {bits}, packed width {width}")
        found["search_100m"] = {"recall_1": recall, "launches": got,
                                "launches_by_method": per_method, "rows": [
            {k: r[k] for k in ("method", "nprobe", "t_search", "t_search_min", "bits_per_id")}
            for r in rows]}
        log(f"[bench] search_100m ({BENCH_ARGS['search_100m']}, the LUT byte scan, seven id "
            f"containers): recall@1 {recall} equal across them; packed bits "
            f"{bits['packed-bits']} bits/id (width {width}), every other codec fewer; " + "; ".join(
                f"{r['method']} nprobe {r['nprobe']} {r['t_search'] * 1e3:.3f} ms "
                f"{r['bits_per_id']:.4f} bits/id" for r in rows)
            + f"; launches {got}, of roc {per_method['roc']}, of roc-interleaved "
            f"{per_method['roc-interleaved']}")

        # ---- weak scaling on one rank: the codec, and the sharded search
        codec, got = drive("scaling", scaling, BENCH_ARGS["scaling"])
        need("scaling", got, ["roc_encode", "roc_decode"])
        search, _ = drive("scaling --search", scaling,
                          [*BENCH_ARGS["scaling"], "--search", "--phases"])
        found["scaling"] = {"codec": codec["rows"], "search": search["rows"], "launches": got}
        log(f"[bench] scaling, one rank: {codec['rows']}; search {search['rows']}")

    launches = bench_launches()
    n_lanes, n_max = codec_scale_sample(BENCH_ARGS["codec_scale_sample"])
    log(f"[bench] codec_scale: {n_lanes} of its lanes (n_max {n_max}) through both kernels "
        f"== their plain versions (states, order, ids)")
    found["spent_s"] = spent
    log(f"[bench] host-clock s by driver: {spent}; in all {sum(spent.values()):.1f} s")
    log(f"[bench] numbers: {json.dumps(found)}")
    return launches


def probe_inputs(seed: int):
    """The inputs the probe files draw, seeded here, on the CPU: ((win, idx)
    for K3, (buf, p) for K4)."""
    rng = np.random.default_rng(seed + 200)
    win = torch.from_numpy(rng.integers(0, 2**31, (256, 128)).astype(np.uint32).view(np.int32))
    idx = torch.zeros((256, 1), dtype=torch.int32)
    buf = torch.from_numpy(rng.integers(0, 2**31, (896, 256)).astype(np.int32))
    p = (torch.arange(256, dtype=torch.int32) % 17)[None, :]
    return (win, idx), (buf, p)


def phase_probes(seed: int):
    """K3 and K4 on the card against their plain versions, on
    ``probe_inputs``. Returns the two kernels' JSON entries."""
    from vector_db_id_compression_tpu_torch.ops.probes import (
        STEPS, ProbeDecodeStep, ProbeGather, probe_decode_step_plain, probe_gather_plain)

    (win, idx), (buf, p) = probe_inputs(seed)
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
    for name, got, plain_fn, args, cpu_args, cls, src, replaces in (
            ("probe_gather", got3, probe_gather_plain, args3, (win, idx), ProbeGather,
             "probe_gather.cu", "tools/profiling/profile_pallas.py:21"),
            ("probe_decode_step", got4, probe_decode_step_plain, args4, (buf, p),
             ProbeDecodeStep, "probe_decode_step.cu", "tools/profiling/profile_pallas2.py:35")):
        if not torch.equal(got.cpu(), plain_fn(*cpu_args)):
            raise AssertionError(f"{name} kernel differs from its plain version on the CPU")
        ms = kernel_ms(lambda: cls.launch(*args))
        call_ms = median_ms(lambda: cls.run(*args))
        plain_ms, want = cuda_ms(lambda: plain_fn(*args))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} kernel differs from its plain version on the card")
        log(f"[probes] {name}: {STEPS} steps, kernel == plain (on the CPU and on the card), "
            f"kernel {ms:.4f} ms ({ms * 1e3 / STEPS:.4f} us/step; CUDA-event median of 5 "
            f"runs of 10 launches queued behind a spin), the wrapper's call {call_ms:.4f} ms "
            f"(with its input checks; median of 5), plain {plain_ms:.1f} ms (one run on the "
            f"card)")
        B = cpu_args[0].shape[0 if name == "probe_gather" else 1]
        # K3: each row's window read, one gather per step; K4: buf read, the
        # emits written, the ranks' order statistics
        work = (bound(win.numel() * 4 + 8 * B, STEPS * B) if name == "probe_gather" else
                bound(buf.numel() * 4 + 4 * B + STEPS * B * 4,
                      order_stat_ops(torch.full((B,), STEPS))))
        extra = {}
        if name == "probe_decode_step":
            # K4's time against its steps: how a step's cost grows with the
            # symbols each thread holds (a thread holds about i / 32 at step i)
            extra["steps_scan_ms"] = {n: kernel_ms(lambda n=n: cls.launch(*args, n))
                                      for n in (1, 275, 550, STEPS)}
        entries.append(kernel_entry(name, src, replaces, launches[name], err, ms, plain_ms,
                                    work, ms_timed="launch", us_per_step=ms * 1e3 / STEPS,
                                    call_ms=call_ms, **extra))
    return entries


def phase_chain(index, roc):
    """The chain probe over the flat index's longest list, one lane on one
    thread: its decode chain given the ranks the decode computes, its encode
    chain given the ids in sampling order, each held against the codec's own
    streams and against its plain version. Returns (decode, encode) us per
    step: the floor of a step of either ROC kernel, for the chain half of
    their bounds."""
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.probes import ProbeChain, decode_ranks
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder

    cuda = torch.device("cuda")
    lengths = roc.decoder.lengths
    b = int(torch.argmax(lengths))
    n = int(lengths[b])
    ids = torch.from_numpy(np.sort(index.invlists.ids[b]).view(np.int64))[None].to(cuda)
    len_t, prec_t = lengths[b:b + 1], roc.decoder.precision[b:b + 1]
    st, order = RocEncoder.encode(ids, len_t, prec_t)
    in_order = ids.gather(1, order.long())
    enc_ms = median_ms(lambda: ProbeChain.encode(in_order, len_t, prec_t))
    st_c = ProbeChain.encode(in_order, len_t, prec_t)
    st_p = ProbeChain.encode(in_order.cpu(), len_t.cpu(), prec_t.cpu())
    enc_err = max(max_abs_err(tuple(st_c), tuple(st)), max_abs_err(tuple(st_c), tuple(st_p)))

    decoded = roc.decoder.decode_lanes(torch.tensor([b], device=cuda))[:, :n]
    ranks, pool = decode_ranks(decoded, len_t), rd.default_pool(n, cuda)
    dec_ms = median_ms(lambda: ProbeChain.decode(st, len_t, prec_t, ranks, pool))
    syms = ProbeChain.decode(st, len_t, prec_t, ranks, pool)
    plain = ProbeChain.decode(rd.RocStates(*(t.cpu() for t in st)), len_t.cpu(), prec_t.cpu(),
                              ranks.cpu(), pool.cpu())
    dec_err = max(max_abs_err(syms, decoded.flip(1)), max_abs_err(syms, plain))
    if enc_err or dec_err:
        raise AssertionError(f"chain probe vs the codec and its plain version: encode "
                             f"{enc_err}, decode {dec_err}")
    dec_us, enc_us = dec_ms * 1e3 / n, enc_ms * 1e3 / n
    log(f"[chain] chain probe over the longest list ({n} ids, precision {int(prec_t)}), one "
        f"lane on one thread, no rank or select work: decode chain {dec_ms:.4f} ms "
        f"({dec_us:.4f} us/step), encode chain {enc_ms:.4f} ms ({enc_us:.4f} us/step) "
        f"(CUDA-event medians of 5 after a warm-up, launch and staging included); "
        f"== the codec's streams and the plain version, max_abs_err 0")
    return dec_us, enc_us


def probe_latency_bounds(entries) -> None:
    """Each probe's latency bound (``latency_bound_ms``): its STEPS
    dependent steps times the least time of one step, in SM cycles at the
    card's maximum SM clock (nvidia-smi). A step of K3 waits at least for
    one dependent shared-memory load (S: the lesser of SHARED_LOAD_CYCLES,
    published, and the card's clock64() reading of a chain of them). In K4
    the next value x' = x + w + rank waits for the rank of x, at least a
    compare, a warp-wide reduction and an add (``R``: the lesser of the
    card's clock64() readings of two such chains, a warp reduction of counts
    and a ballot with its population count, ops/probes.py
    step_latency_cycles), so a step takes at least R cycles, however the
    rank's work is spread over threads (on one warp or more: at least one
    reduction deep). The next gather's dependent load would raise the floor
    of two steps to R + S only where S exceeded R, and a shared load (about
    23 cycles) is below a rank link (40 or more): R alone is the floor. The
    bytes-and-operations bound (``bound_ms``) is far below either: a chain
    of dependent steps is bound by its latency."""
    from vector_db_id_compression_tpu_torch.ops.probes import STEPS, step_latency_cycles

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    cyc = step_latency_cycles()
    rank = min(cyc["rank_reduce"], cyc["rank_ballot"])
    load = min(SHARED_LOAD_CYCLES, cyc["shared_load"])
    log(f"[probes] clock64() readings on one warp (4096 links each): a rank link (compare, "
        f"__reduce_add_sync, add) {cyc['rank_reduce']:.2f} cycles, (compare, __ballot_sync "
        f"and __popc, add) {cyc['rank_ballot']:.2f} (R: the lesser), a dependent shared load "
        f"{cyc['shared_load']:.2f} cycles (published: {SHARED_LOAD_CYCLES}; the bounds take "
        f"the lesser, {load:.2f}); the SM clock they ran at {cyc['sm_mhz']:.0f} MHz (global "
        f"timer), the maximum {mhz:.0f} MHz")
    step_cycles = {"probe_gather": load, "probe_decode_step": rank}
    why = {"probe_gather": f"{load:.2f} cycles, a dependent shared load (S)",
           "probe_decode_step": f"R = {rank:.2f} cycles, the lesser rank link"}
    for e in entries:
        name = e["name"]
        e["latency_bound_ms"] = STEPS * step_cycles[name] / (mhz * 1e3)
        e["latency_step_cycles"] = step_cycles[name]
        e["sm_mhz"] = cyc["sm_mhz"]
        log(f"[probes] {name}: latency bound {STEPS} steps x {why[name]} at the {mhz:.0f} MHz "
            f"maximum SM clock = {e['latency_bound_ms']:.4f} ms; the kernel takes "
            f"{e['ms'] / e['latency_bound_ms']:.2f}x it, the wrapper's call "
            f"{e['call_ms'] / e['latency_bound_ms']:.2f}x; at the clock read, the kernel's "
            f"{e['ms'] * cyc['sm_mhz'] * 1e3 / STEPS:.1f} cycles a step")
        scan = e.get("steps_scan_ms")
        if scan:
            ns = sorted(scan)
            log(f"[probes] {name} at {', '.join(str(n) for n in ns)} steps: "
                + ", ".join(f"{scan[n]:.4f}" for n in ns) + " ms; cycles a step at the clock "
                "read, between: " + ", ".join(
                    f"{a}..{b} {(scan[b] - scan[a]) * cyc['sm_mhz'] * 1e3 / (b - a):.1f} (a "
                    f"thread holds {a / 32:.0f}..{b / 32:.0f} symbols)"
                    for a, b in zip(ns, ns[1:])))


def lane_kernels_vs_plain(sorted_ids, lengths, prec, decoder):
    """The per-list ROC kernels beside their plain versions on the card,
    over one lane table (numpy, as ``roc_lane_table`` gives it) that a
    container's ``decoder`` was built from: encode and decode of every lane.
    Returns (encode ms, plain ms, error; decode ms, plain ms, error); the
    encode error also holds the kernel against the container's streams."""
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder

    cuda = torch.device("cuda")
    ids_t = torch.from_numpy(sorted_ids.view(np.int64)).to(cuda)
    len_t, prec_t = torch.from_numpy(lengths).to(cuda), torch.from_numpy(prec).to(cuda)
    B, n_max = ids_t.shape
    maxp = int(prec.max())
    n_slices, pool = rd.n_slices_for(maxp), rd.default_pool(n_max, cuda)
    enc_ms = median_ms(lambda: RocEncoder.encode(ids_t, len_t, prec_t), reps=3)
    st_k, order_k = RocEncoder.encode(ids_t, len_t, prec_t)
    enc_plain_ms, (st_p, order_p) = cuda_ms(lambda: rd.roc_encode_batch(
        ids_t, len_t, prec_t, pool, rd.fresh_states(B, rd.stack_capacity(n_max, maxp), cuda),
        n_slices))
    enc_err = max(max_abs_err((*st_k, order_k), (*st_p, order_p)),
                  max_abs_err(tuple(st_k), tuple(decoder.states)))
    dec_ms = median_ms(decoder.decode, reps=3)
    dec_plain_ms, (ids_p, _) = cuda_ms(lambda: rd.roc_decode_batch(
        st_k, len_t, prec_t, pool, n_max, n_slices))
    dec_err = max_abs_err(decoder.decode(), ids_p)
    return enc_ms, enc_plain_ms, enc_err, dec_ms, dec_plain_ms, dec_err


def lane_kernels_vs_plain_by_bucket(sorted_ids, lengths, prec, decoder):
    """As ``lane_kernels_vs_plain``, for lanes of very unequal lengths: the
    kernels run over the whole table (the path's one launch each), their
    plain versions over each size bucket of it (``store.ragged.bucketize``,
    the empty lanes as one more group). A lane's stream does not depend on
    the other lanes, and a plain version's work grows with the lanes times
    the padded length squared, so one list of thousands of ids among 65,536
    short ones would hold its plain run over the whole table for minutes.
    Each bucket's states are held against the kernel's rows of that bucket
    (stack words up to each lane's stack length), its decode against the
    kernel's. Returns (encode ms, plain ms summed over the buckets, error;
    decode ms, plain ms, error)."""
    from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.store.ragged import bucketize

    cuda = torch.device("cuda")
    ids_t = torch.from_numpy(sorted_ids.view(np.int64)).to(cuda)
    len_t, prec_t = torch.from_numpy(lengths).to(cuda), torch.from_numpy(prec).to(cuda)
    maxp = int(prec.max())
    n_slices = rd.n_slices_for(maxp)
    enc_ms = median_ms(lambda: RocEncoder.encode(ids_t, len_t, prec_t), reps=3)
    st_k, order_k = RocEncoder.encode(ids_t, len_t, prec_t)
    dec_ms = median_ms(decoder.decode, reps=3)
    ids_k = decoder.decode()
    enc_err = max_abs_err(tuple(st_k), tuple(decoder.states))
    dec_err, enc_plain_ms, dec_plain_ms = 0.0, 0.0, 0.0
    groups = [(b.list_ids, b.n_pad) for b in bucketize(lengths)]
    groups.append((np.flatnonzero(lengths == 0), 1))
    for rows, n in groups:
        lanes = torch.from_numpy(rows).to(cuda)
        pool = rd.default_pool(n, cuda)
        cap = rd.stack_capacity(n, maxp)
        t, (st_p, order_p) = cuda_ms(lambda: rd.roc_encode_batch(
            ids_t[lanes, :n], len_t[lanes], prec_t[lanes], pool,
            rd.fresh_states(len(rows), cap, cuda), n_slices))
        enc_plain_ms += t
        sub = rd.RocStates(*(x[lanes] for x in st_k))
        sub = sub._replace(stack=sub.stack[:, :cap])
        live = torch.arange(cap, device=cuda)[None, :] < st_p.stack_len[:, None]
        in_list = torch.arange(n, device=cuda)[None, :] < len_t[lanes][:, None]
        enc_err = max(enc_err, max_abs_err(
            (sub.head, sub.stack_len, sub.mt_ctr, sub.err, torch.where(live, sub.stack, 0),
             torch.where(in_list, order_k[lanes, :n], 0)),
            (st_p.head, st_p.stack_len, st_p.mt_ctr, st_p.err, torch.where(live, st_p.stack, 0),
             torch.where(in_list, order_p, 0))))
        t, (ids_p, _) = cuda_ms(lambda: rd.roc_decode_batch(
            sub, len_t[lanes], prec_t[lanes], pool, n, n_slices))
        dec_plain_ms += t
        dec_err = max(dec_err, max_abs_err(ids_k[lanes, :n], ids_p))
    return enc_ms, enc_plain_ms, enc_err, dec_ms, dec_plain_ms, dec_err


def time_kernels(index, roc, launches, xq, chain):
    """Each kernel beside its plain version, on the card, at the main path's
    shapes: encode of every list of the index, decode of every list, and
    the decode of the lists one search's translate touches; then each
    kernel's launches in one search (decode) or one container build
    (encode). ``chain``: the chain probe's (decode, encode) us per step."""
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.store.invlists import (RocInvertedLists,
                                                                   roc_lane_table)

    sorted_ids, lengths, prec, _ = roc_lane_table(index.invlists)
    enc_ms, enc_plain_ms, enc_err, dec_ms, dec_plain_ms, dec_err = lane_kernels_vs_plain(
        sorted_ids, lengths, prec, roc.decoder)
    if enc_err or dec_err:
        raise AssertionError(f"kernel vs plain at the main path's shapes: encode "
                             f"{enc_err}, decode {dec_err}")
    B, n_max = sorted_ids.shape
    max_len = int(lengths.max())
    _, L = index.search_positional(xq, K, NPROBE)
    touched = torch.unique(L[L >= 0] >> 32)
    touched_ms = median_ms(lambda: roc.decoder.decode_lanes(touched))
    RocDecoder.launches = 0
    index.search_defer_id_decoding(xq, k=K, nprobe=NPROBE)
    torch.cuda.synchronize()
    per_search = RocDecoder.launches
    RocEncoder.launches = 0
    RocInvertedLists(index.invlists, device="cuda")
    per_build = RocEncoder.launches
    dec = roc.decoder
    dec_us, enc_us = chain
    touched_steps = longest_steps(dec.lengths, touched)
    log(f"[timing] {B} lists, n_max {n_max}: encode kernel {enc_ms:.3f} ms vs plain "
        f"{enc_plain_ms:.1f} ms; decode kernel {dec_ms:.3f} ms ({dec_ms * 1e3 / max_len:.4f} "
        f"us per step of the longest list, {max_len} steps) vs plain {dec_plain_ms:.1f} "
        f"ms; decode of the {touched.numel()} lists one search touches {touched_ms:.3f} ms "
        f"(kernel: CUDA-event median after a warm-up; plain: one run on the card)")
    all_lanes = torch.arange(B, device="cuda")
    return [
        kernel_entry("roc_encode", "roc_encode.cu",
                     "vector_db_id_compression_tpu/ops/roc_encode_pallas.py:75",
                     launches["roc_encode"], enc_err, enc_ms, enc_plain_ms,
                     encode_bound(dec.lengths, dec.states, n_max, with_order=True),
                     launches_per_build=per_build, chain_step_us=enc_us,
                     chain_bound_ms=max_len * enc_us / 1e3),
        kernel_entry("roc_decode", "roc_decode.cu",
                     "vector_db_id_compression_tpu/ops/roc_pallas.py:93",
                     launches["roc_decode"], dec_err, dec_ms, dec_plain_ms,
                     decode_bound(dec, all_lanes), launches_per_search=per_search,
                     touched_lists=touched.numel(), touched_ms=touched_ms,
                     touched_bound_ms=decode_bound(dec, touched)[0], chain_step_us=dec_us,
                     chain_bound_ms=max_len * dec_us / 1e3,
                     touched_chain_bound_ms=touched_steps * dec_us / 1e3),
    ]


def time_pq_kernels(index, roc, il, chain):
    """Both ROC kernels beside their plain versions over every chunk entry
    of the PQ index's interleaved container (held also against the
    container's own streams), and the native host codec over the index's
    1024 lists, held against the kernels' streams. ``chain``: the chain
    probe's (decode, encode) us per step. Returns the numbers by kernel."""
    from vector_db_id_compression_tpu_torch import native
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.store.invlists import (
        interleaved_lane_table, roc_lane_table)

    cuda = torch.device("cuda")
    t = interleaved_lane_table(index.invlists)
    E, n_max = t.ids.shape
    enc_ms, enc_plain_ms, enc_err, dec_ms, dec_plain_ms, dec_err = lane_kernels_vs_plain(
        t.ids, t.lengths, t.precision, il.decoder)
    if enc_err or dec_err:
        raise AssertionError(f"kernels vs plain over the chunk entries: encode {enc_err}, "
                             f"decode {dec_err}")
    log(f"[timing] PQ index, interleaved: {E} chunk entries, n_max {n_max}: encode kernel "
        f"{enc_ms:.3f} ms vs plain {enc_plain_ms:.1f} ms; decode kernel {dec_ms:.3f} ms "
        f"({dec_ms * 1e3 / n_max:.4f} us per step of the longest entry) vs plain "
        f"{dec_plain_ms:.1f} ms; both == plain == the container's streams")

    # the native host codec over the 1024 lists, against the kernels' streams
    lists = index.invlists.ids
    sorted_ids, lengths, prec, perms = roc_lane_table(index.invlists)
    st, order = RocEncoder.encode(torch.from_numpy(sorted_ids.view(np.int64)).to(cuda),
                                  torch.from_numpy(lengths).to(cuda),
                                  torch.from_numpy(prec).to(cuda))
    t0 = time.perf_counter()
    native.load_library()
    t_build = time.perf_counter() - t0
    threads = native.default_threads()
    t0 = time.perf_counter()
    heads, stacks, lens, orders, mt = native.roc_encode_lists(lists, prec)
    nat_enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    decoded = native.roc_decode_lists(heads, stacks, lens, lengths, prec)
    nat_dec_ms = (time.perf_counter() - t0) * 1e3
    head, stack, stack_len, mt_ctr = (x.cpu().numpy() for x in st[:4])
    order = order.cpu().numpy()
    kernel_ids = roc.decoder.decode().cpu().numpy()
    same = (np.array_equal(heads.view(np.int64), head) and np.array_equal(lens, stack_len)
            and np.array_equal(mt.view(np.int32), mt_ctr)
            and torch.equal(st.stack, roc.decoder.states.stack))
    for ln in range(NLIST):
        n, w = int(lengths[ln]), int(lens[ln])
        same = (same and np.array_equal(stacks[ln, :w].view(np.int32), stack[ln, :w])
                and np.array_equal(orders[ln], perms[ln][order[ln, :n]])
                and np.array_equal(decoded[ln].view(np.int64), kernel_ids[ln, :n]))
    if not same:
        raise AssertionError("native host codec: heads, stacks, orders or decoded ids differ "
                             "from the kernels'")
    log(f"[timing] native host codec (g++ build {t_build:.1f} s), {NLIST} lists, "
        f"{index.ntotal} ids, {threads} threads: encode {nat_enc_ms:.1f} ms, decode "
        f"{nat_dec_ms:.1f} ms (host clock); heads, stacks, MT draws, orders and decoded "
        f"ids == the kernels'")
    steps = int(t.lengths.max())
    return {"roc_encode": {"max_abs_err": enc_err, "chunk_entries_ms": enc_ms,
                           "chunk_entries_plain_ms": enc_plain_ms,
                           "chunk_entries_chain_bound_ms": steps * chain[1] / 1e3,
                           "native_host_ms": nat_enc_ms, "native_threads": threads},
            "roc_decode": {"max_abs_err": dec_err, "chunk_entries_ms": dec_ms,
                           "chunk_entries_plain_ms": dec_plain_ms,
                           "chunk_entries_chain_bound_ms": steps * chain[0] / 1e3,
                           "native_host_ms": nat_dec_ms, "native_threads": threads}}


def time_graph_kernels(g, roc, blk, nodes, launches, per_unit, chain, label="graph"):
    """Both ROC kernels beside their plain versions at the graph path's
    shapes: the chained decode of one fetch (the block of one node per query)
    and of all 62,500 blocks, the chained encode of every block, the per-node
    encode of every node and the per-node decode of one fetch. Returns (the
    per-node kernels' graph-shape numbers by kernel, the chained kernels'
    JSON entries). ``per_unit``: the chained kernels' launches per graph
    search (decode) and per container build (encode); ``chain``: the chain
    probe's (decode, encode) us per step; ``label`` names the graph in the
    log."""
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
        raise AssertionError(f"chained kernels vs plain at the {label}'s shapes: encode "
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
        raise AssertionError(f"per-node kernels vs plain at the {label}'s shapes: encode "
                             f"{node_enc_err}, decode {lane_err}")
    dec_us, enc_us = chain
    steps = longest_steps(degs, blocks)
    log(f"[timing] {label}, {n_blocks} blocks of {GRAPH_BLOCK} nodes, K {Kg}: chained encode "
        f"kernel {enc_ms:.3f} ms vs plain {enc_plain_ms:.1f} ms; chained decode of one "
        f"fetch ({blocks.numel()} blocks, {fetch_ms * 1e3 / steps:.4f} us per step of the "
        f"longest block, {steps} steps) kernel {fetch_ms:.3f} ms vs plain "
        f"{fetch_plain_ms:.1f} ms, of all {n_blocks} blocks kernel {all_ms:.3f} ms vs "
        f"plain {all_plain_ms:.1f} ms (kernel: CUDA-event median after a warm-up; plain: "
        f"one run on the card)")
    log(f"[timing] {label}, RocGraph, {g.N} nodes, K {Kg}: per-node encode kernel "
        f"{node_enc_ms:.3f} ms vs plain {node_enc_plain_ms:.1f} ms; per-node decode of one "
        f"fetch ({nodes.numel()} lanes) kernel {lane_ms:.3f} ms vs plain "
        f"{lane_plain_ms:.1f} ms; both == plain == the container's streams")
    per_node = {"roc_encode": {"max_abs_err": node_enc_err, "graph_ms": node_enc_ms,
                               "graph_plain_ms": node_enc_plain_ms,
                               "graph_chain_bound_ms": longest_steps(degs_n) * enc_us / 1e3},
                "roc_decode": {"max_abs_err": lane_err, "graph_fetch_ms": lane_ms,
                               "graph_fetch_plain_ms": lane_plain_ms,
                               "graph_fetch_chain_bound_ms":
                                   longest_steps(degs_n, nodes) * dec_us / 1e3}}
    return per_node, [
        kernel_entry("roc_encode_chained", "roc_encode.cu",
                     "vector_db_id_compression_tpu/codecs/roc_device.py:341",
                     launches["roc_encode_chained"], enc_err, enc_ms, enc_plain_ms,
                     encode_bound(degs, st_k, Kg, with_order=False),
                     launches_per_build=per_unit["roc_encode_chained"], chain_step_us=enc_us,
                     chain_bound_ms=longest_steps(degs) * enc_us / 1e3),
        kernel_entry("roc_decode_chained", "roc_decode.cu",
                     "vector_db_id_compression_tpu/ops/roc_pallas.py:376",
                     launches["roc_decode_chained"], dec_err, fetch_ms, fetch_plain_ms,
                     decode_bound(dec, blocks),
                     launches_per_search=per_unit["roc_decode_chained"],
                     all_blocks_ms=all_ms, all_blocks_plain_ms=all_plain_ms,
                     all_blocks_bound_ms=decode_bound(
                         dec, torch.arange(n_blocks, device=g.device))[0],
                     chain_step_us=dec_us, chain_bound_ms=steps * dec_us / 1e3,
                     all_blocks_chain_bound_ms=longest_steps(degs) * dec_us / 1e3),
    ]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=7)
    # a rank of [parallel]'s four-rank run, started by that phase
    parser.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--parallel-dir", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.parallel_rank is not None:
        parallel_rank(args.parallel_rank, args.parallel_dir)
        return

    name = phase_device()
    import vector_db_id_compression_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != Path(__file__).resolve().parent:
        sys.exit("chip_smoke: run from a checkout that holds vector_db_id_compression_tpu_torch")
    # host-clock seconds of each phase, for the run's time budget
    spent, clock = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        spent[phase], clock[0] = round(now - clock[0], 1), now

    phase_build()
    phase_kernels(args.seed)
    lap("build, kernels")
    t0 = time.perf_counter()
    xt, xb, xq, xt_h = make_data(args.seed)
    log(f"[main] data (bench/datasets.py SyntheticDataset): {NT} train, {NB} database, {NQ} "
        f"query vectors of d={D}, and [hnsw]'s {HNSW_NT} training vectors (seed {args.seed}), "
        f"in {time.perf_counter() - t0:.1f} s on the host"
        + ("; each array == the earlier runs' (SHA-256)" if args.seed == 7 else ""))
    index, roc, main_launches, I_bf = phase_main(xt, xb, xq)
    lap("main")
    codecs = phase_codecs(index, roc, xq)
    lap("codecs")
    pq_index, pq_roc, pq_il, pq_launches = phase_pq(xt, xb, xq, I_bf,
                                                    int(index.invlists.lengths.max()))
    lap("pq")
    graphs, medoid, graph_ref, graph_launches, nodes, per_unit = phase_graph(xb, xq, I_bf)
    lap("graph")
    g, roc_g, blk = graphs["Graph"], graphs["RocGraph"], graphs["RocBlockGraph"]
    ser_launches = phase_serialize(
        [("flat", index, {"ROC": (roc, (None,)),
                          **{name: (c, (True, False)) for name, c in codecs.items()}}),
         ("PQ", pq_index, {"RocInvertedLists": (pq_roc, (None,)),
                           "interleaved": (pq_il, (None,))})],
        graphs, medoid, graph_ref, xb, xq)
    lap("serialize")
    par_launches = phase_parallel(index, roc, codecs, pq_index, pq_roc, xq)
    del codecs
    lap("parallel")
    hnsw_index, hnsw_roc, level0, hnsw_nodes, hnsw_launches, hnsw_per_unit = phase_hnsw(
        xt_h, xb, xq, I_bf)
    lap("hnsw")
    qinco_index, qinco_roc, qinco_launches = phase_qinco(args.seed, xt_h, hnsw_index.centroids,
                                                         xb, xq, I_bf)
    del xt_h
    lap("qinco")
    bench_launches_ = phase_bench()
    lap("bench")
    probes = phase_probes(args.seed)
    probe_latency_bounds(probes)
    chain = phase_chain(index, roc)
    per_node, chained = time_graph_kernels(g, roc_g, blk, nodes, graph_launches, per_unit,
                                           chain)
    per_chunk = time_pq_kernels(pq_index, pq_roc, pq_il, chain)
    per_hnsw = time_hnsw_kernels(hnsw_index, hnsw_roc, level0, hnsw_nodes, hnsw_launches,
                                 hnsw_per_unit, chain)
    per_qinco = time_qinco_kernels(qinco_index, qinco_roc, xq)
    kernels = time_kernels(index, roc, main_launches, xq, chain) + chained + probes
    lap("probes, chain, timing")
    log(f"[time] host-clock s by phase: {spent}; in all {sum(spent.values()):.1f} s")
    # a kernel that several paths run counts its launches in each, and its
    # error is the largest of its paths'
    by_phase = {"main": main_launches, "pq": pq_launches, "graph": graph_launches,
                "serialize": ser_launches, "parallel": par_launches, "hnsw": hnsw_launches,
                "qinco": qinco_launches, "bench": bench_launches_}
    for entry in kernels[:4]:
        name_ = entry["name"]
        entry["launches_by_phase"] = {ph: n[name_] for ph, n in by_phase.items() if name_ in n}
        entry["launches"] = sum(entry["launches_by_phase"].values())
        extra = per_hnsw[name_]
        entry.update(extra, max_abs_err=max(entry["max_abs_err"], extra["max_abs_err"]))
    for entry in kernels[:2]:
        name_ = entry["name"]
        for extra in (per_node[name_], per_chunk[name_], per_qinco[name_]):
            entry.update(extra, max_abs_err=max(entry["max_abs_err"], extra["max_abs_err"]))
    entries = {e["name"]: e for e in kernels}
    entries["roc_decode"]["graph_launches_per_search"] = per_unit["roc_decode"]
    for e in kernels:
        per = ("per search", e["launches_per_search"]) if "launches_per_search" in e else (
            ("per build", e["launches_per_build"]) if "launches_per_build" in e else
            ("probe", "off the main path"))
        chain_bound = (f", chain bound {e['chain_bound_ms']:.4f} ms "
                       f"({e['ms'] / e['chain_bound_ms']:.2f}x)" if "chain_bound_ms" in e else "")
        log(f"[timing] {e['name']}: {e['ms']:.4f} ms (timed: the {e['ms_timed']}), bound "
            f"{e['bound_ms']:.5f} ms by {e['bound_by']} ({e['ms'] / e['bound_ms']:.0f}x the "
            f"bound){chain_bound}, plain {e['plain_ms']:.1f} ms, no single PyTorch call; launches {e['launches']} in the "
            f"paths' runs, {per[1]} {per[0]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

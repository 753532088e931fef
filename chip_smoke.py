#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path (``vector_db_id_compression_tpu_torch``) once, at
SIFT1M's shape: 1,000,000 synthetic database vectors of d = 128 (float32), an
IVF with 1024 lists and flat payload, 1000 queries, k = 10, nprobe = 16. The
ids of every inverted list are ROC-compressed and the search decodes them
only after the top-k is final (deferred id decoding). Phases, one line each:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds the two ROC kernels from csrc/
  3. kernels  each kernel against its plain torch version on a seeded batch
              of 256 lists (lengths 1..1500, ids up to 2^20 and 2^32 - 1):
              bit-equal or the run fails
  4. main     train, add, search uncompressed, swap in the ROC container,
              search again; the ROC search must return the uncompressed
              search's rows (ids are lossless); both kernels must have been
              launched by that path; then bits/id and phase times

The line before the last is a JSON object with each kernel's launch count
(from the main path), its error against the plain version and its time
beside the plain version's at the main path's shapes; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits nonzero and prints no result.

Usage: python3 chip_smoke.py [--seed N]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NB, NT, NQ, D = 1_000_000, 100_000, 1000, 128
NLIST, K, NPROBE = 1024, 10, 16


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
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [(got, want)]
    return max(float((g.cpu().double() - w.cpu().double()).abs().max()) if g.numel() else 0.0
               for g, w in pairs)


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


def make_data(seed: int):
    """Gaussian mixture as the JAX package's bench/datasets.py
    SyntheticDataset: 32 centres scaled by 4, unit noise."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((32, D)).astype(np.float32) * 4.0

    def draw(n, r):
        return (cent[r.integers(0, 32, n)] + r.standard_normal((n, D))).astype(np.float32)

    return (draw(NT, np.random.default_rng(seed + 1)), draw(NB, np.random.default_rng(seed + 2)),
            draw(NQ, np.random.default_rng(seed + 3)))


def phase_main(seed: int):
    from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
    from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
    from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
    from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

    t0 = time.perf_counter()
    xt, xb, xq = make_data(seed)
    log(f"[main] data: {NT} train, {NB} database, {NQ} query vectors of d={D} "
        f"(seed {seed}) in {time.perf_counter() - t0:.1f} s on the host")

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
    return index, roc, launches


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
    log(f"[timing] {B} lists, n_max {n_max}: encode kernel {enc_ms:.3f} ms vs plain "
        f"{enc_plain_ms:.1f} ms; decode kernel {dec_ms:.3f} ms vs plain {dec_plain_ms:.1f} "
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
    index, roc, launches = phase_main(args.seed)
    kernels = time_kernels(index, roc, launches)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

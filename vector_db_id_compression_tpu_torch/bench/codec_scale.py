"""Codec scale bench: batched ROC encode+decode at reference scale and above;
port of the JAX package's ``bench/codec_scale.py``.

The reference validates its codec at n=65k ids (test_codec.cpp:54-106) and
runs the full pipeline at 10M-1B ids (README.md:139-197). This driver runs
the *codec layer alone* at arbitrary scale — an IVF-shaped workload of
``--ntotal`` uniform ids over ``--nlist`` lists — and reports:

  - host build (the native C++ batch encoder, or the device encoder where
    the native codec cannot be built; the log says which ran) wall time +
    stream bits/id,
  - decode of EVERY list on the device by the ROC decode kernel
    (``ops/roc_decode.py`` ``RocDecoder``; its plain version on the CPU):
    one-shot latency including the id transfer to the host, and the
    whole-batch throughput measured with the output reduced to a scalar on
    the device (kernel time, not a transfer); every lane's ids are checked
    against the workload,
  - the device encode throughput of the ROC encode kernel
    (``ops/roc_encode.py`` ``RocEncoder``) over the first lane group, its
    states checked against the host build's.

Long-list routing (``--interleave auto``, the default): lists longer than
1.5x ``--chunk-target`` are split into S contiguous sorted-value chunks via
the interleaved-ROC chunk plan (codecs/roc_interleaved.py), turning one
n-step chain into S independent (n/S)-length lanes that decode in lockstep.
``--interleave off`` reproduces the strict single-stream reference format.

Very large batches decode in ``--lane-chunk`` lane groups (each group is one
decoder; groups are length-sorted so every group has a tight n_max) — this
bounds device memory at 1B-id scale. A kernel that fails to build or launch
fails the run: there is no fallback.

Prints one JSON row per invocation (the JAX driver's keys):

    python -m vector_db_id_compression_tpu_torch.bench.codec_scale \
        --ntotal 10000000 --nlist 65536

It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve
from ._timing import log, seconds


def build_workload(ntotal: int, nlist: int, seed: int):
    """Uniform IVF-shaped id lists (same generator family as bench.py and
    the reference harness): returns (ids u64[nlist, n_max] ascending-padded,
    lengths i32[nlist], prec i32[nlist]); the JAX package's arrays."""
    from ..codecs.roc import precision_for_max_id_safe

    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, nlist, size=ntotal)
    order = np.argsort(assignment, kind="stable")  # members stay ascending
    lengths = np.bincount(assignment, minlength=nlist).astype(np.int32)
    del assignment
    bounds = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(lengths, out=bounds[1:])
    n_max = int(lengths.max())
    ids = np.zeros((nlist, n_max), dtype=np.uint64)
    rows = np.repeat(np.arange(nlist, dtype=np.int64), lengths)
    cols = np.arange(ntotal, dtype=np.int64) - bounds[rows]
    ids[rows, cols] = order.astype(np.uint64)
    # per-list max member = last element of each (ascending) group
    prec = np.ones(nlist, dtype=np.int32)
    nz = lengths > 0
    maxs = np.zeros(nlist, dtype=np.int64)
    maxs[nz] = order[bounds[1:][nz] - 1]
    prec[nz] = [precision_for_max_id_safe(int(m)) for m in maxs[nz]]
    return ids, lengths, prec


def build_entries(ids, lengths, prec, mode: str, chunk_target: int):
    """Expand lists into codec lanes ("entries"). ``mode`` 'off': one entry
    per list, reference single-stream format. 'auto': lists longer than
    1.5x chunk_target are cut into S = ceil(n / chunk_target) sorted-value
    chunks (interleaved-ROC chunk plan — shared contract with the
    container, codecs/roc_interleaved.py:chunk_plan).

    Returns (ent_arrays list[u64[]], ent_len i32[E], ent_prec i32[E],
    ent_lo u64[E], ent_list i64[E], ent_bound i64[E] chunk start within the
    list, extra_lanes int)."""
    from ..codecs.roc_interleaved import chunk_plan

    nlist = len(lengths)
    ent_arrays, ent_len, ent_prec, ent_lo, ent_list, ent_bound = \
        [], [], [], [], [], []
    extra = 0
    thresh = int(1.5 * chunk_target)
    for ln in range(nlist):
        n = int(lengths[ln])
        if n == 0:
            continue
        row = ids[ln, :n]
        if mode == "auto" and n > thresh:
            S = -(-n // chunk_target)
            sizes, bnds, lo, pr, rebased = chunk_plan(row, S)
            for s in range(S):
                ent_arrays.append(rebased[s])
                ent_len.append(int(sizes[s]))
                ent_prec.append(int(pr[s]))
                ent_lo.append(lo[s])
                ent_list.append(ln)
                ent_bound.append(int(bnds[s]))
            extra += S - 1
        else:
            ent_arrays.append(row)
            ent_len.append(n)
            ent_prec.append(int(prec[ln]))
            ent_lo.append(np.uint64(0))
            ent_list.append(ln)
            ent_bound.append(0)
    return (ent_arrays, np.asarray(ent_len, np.int32),
            np.asarray(ent_prec, np.int32), np.asarray(ent_lo, np.uint64),
            np.asarray(ent_list, np.int64), np.asarray(ent_bound, np.int64),
            extra)


def padded_entries(ent_arrays, rows, width: int) -> np.ndarray:
    """The entries ``rows`` as i64[len(rows), width], zero-padded (ids are
    below 2^63)."""
    pad = np.zeros((len(rows), width), np.int64)
    for i, e in enumerate(rows):
        a = ent_arrays[e]
        pad[i, : len(a)] = a.view(np.int64)
    return pad


def native_available() -> bool:
    """Whether the native C++ codec builds here (g++ at first use)."""
    from .. import native

    try:
        native.load_library()
    except RuntimeError as e:
        log(f"native codec unavailable: {e}")
        return False
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ntotal", type=int, default=10_000_000)
    p.add_argument("--nlist", type=int, default=8192)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--interleave", choices=["auto", "off"], default="auto",
                   help="auto: chunk lists past 1.5x --chunk-target into "
                        "interleaved lanes; off: strict single-stream "
                        "reference format")
    p.add_argument("--chunk-target", type=int, default=512,
                   help="target chunk length for auto interleaving (per-id "
                        "decode cost is U-shaped in lane length)")
    p.add_argument("--lane-chunk", type=int, default=262144,
                   help="decode at most this many lanes per decoder (bounds "
                        "device memory at 1B scale)")
    p.add_argument("--skip-device-encode", action="store_true")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the kernels run (default: the card)")
    args = p.parse_args(argv)

    from .. import native
    from ..codecs import roc_device as rd
    from ..ops.roc_decode import RocDecoder
    from ..ops.roc_encode import RocEncoder

    dev = resolve(args.device)
    log(f"device: {dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    t0 = time.time()
    ids, lengths, prec = build_workload(args.ntotal, args.nlist, args.seed)
    n_max_list = int(lengths.max())
    log(f"workload: ntotal={args.ntotal} nlist={args.nlist} "
        f"n_max={n_max_list} prec_max={int(prec.max())} "
        f"built in {time.time()-t0:.1f}s")

    t0 = time.time()
    (ent_arrays, ent_len, ent_prec, ent_lo, ent_list, ent_bound,
     extra_lanes) = build_entries(
        ids, lengths, prec, args.interleave, args.chunk_target)
    E = len(ent_arrays)
    n_max = int(ent_len.max())
    log(f"entries: {E} lanes (extra from chunking: {extra_lanes}), "
        f"lane n_max={n_max}, planned in {time.time()-t0:.1f}s")

    # ---- host build: the native C++ batch encoder (bit-exact with the
    # kernels — tests/test_torch_host_codec.py), else the device encoder ----
    cap = rd.stack_capacity(n_max, int(ent_prec.max()))
    use_native = native_available()
    t0 = time.time()
    if use_native:
        heads, stacks, lens, _, mt = native.roc_encode_lists(
            ent_arrays, ent_prec, cap=cap)
        states_np = (heads.view(np.int64), stacks.view(np.int32), lens,
                     mt.astype(np.int32))
    else:
        st, _ = RocEncoder.encode(
            torch.from_numpy(padded_entries(ent_arrays, range(E), n_max)).to(dev),
            torch.from_numpy(ent_len).to(dev), torch.from_numpy(ent_prec).to(dev))
        states_np = tuple(t.cpu().numpy() for t in (st.head, st.stack, st.stack_len,
                                                     st.mt_ctr))
    t_enc_host = time.time() - t0
    heads, stacks, lens_np, mt_np = states_np
    stream_bytes = int(8 * E + 4 * lens_np.astype(np.int64).sum())
    # envelope for chunked lanes: 8B lo + 4B length + 1B precision per
    # EXTRA lane (same accounting as InterleavedRoc.size_bytes)
    env_bytes = 13 * extra_lanes
    bits_per_id = 8.0 * (stream_bytes + env_bytes) / args.ntotal
    log(f"host build: {'native C++ encoder' if use_native else 'device encoder'}")
    log(f"encode (host native={use_native}): {t_enc_host:.1f}s "
        f"-> {args.ntotal/t_enc_host/1e6:.1f} Mids/s, "
        f"{bits_per_id:.3f} bits/id (envelope {env_bytes} B)")

    # ---- decode on the device, in length-sorted lane groups --------------
    sort_order = np.argsort(-ent_len, kind="stable")
    groups = [sort_order[g: g + args.lane_chunk]
              for g in range(0, E, args.lane_chunk)]

    def build_group(rows):
        r = torch.from_numpy(rows)
        st = rd.RocStates(
            head=torch.from_numpy(heads)[r].to(dev),
            stack=torch.from_numpy(stacks)[r].to(dev),
            stack_len=torch.from_numpy(lens_np)[r].to(dev),
            mt_ctr=torch.from_numpy(mt_np)[r].to(dev),
            err=torch.zeros(len(rows), dtype=torch.bool, device=dev))
        g_nmax = max(int(ent_len[rows].max()), 1)
        return RocDecoder(st, torch.from_numpy(ent_len[rows]).to(dev),
                          torch.from_numpy(ent_prec[rows]).to(dev),
                          rd.default_pool(g_nmax, dev), g_nmax)

    def want_of(e):
        """Entry e's ids: the list slice it covers, rebased by its lo."""
        n = int(ent_len[e])
        return ids[ent_list[e], ent_bound[e]: ent_bound[e] + n] - ent_lo[e]

    total_dec_s = 0.0
    total_oneshot_s = 0.0
    rate_largest = None
    for gi, rows in enumerate(groups):
        dec = build_group(rows)
        g_ids = int(ent_len[rows].astype(np.int64).sum())

        # spot-check the round trip on a few lanes before timing
        probe = np.asarray([0, len(rows) // 2, len(rows) - 1])
        got = dec.decode_lanes(torch.from_numpy(probe)).cpu().numpy()
        for i, r in enumerate(probe):
            e = int(rows[r])
            n = int(ent_len[e])
            np.testing.assert_array_equal(
                np.sort(got[i, :n].astype(np.uint64)), np.sort(want_of(e)))

        # one-shot latency incl. the id transfer to host
        ts = []
        out = None
        for _ in range(args.runs):
            t, out = seconds(lambda: dec.decode().cpu(), dev)
            ts.append(t)
        total_oneshot_s += min(ts)
        # every lane of the group: its ids, in any order, are its entry's
        out = out.numpy()
        for i, e in enumerate(rows):
            n = int(ent_len[e])
            if not np.array_equal(np.sort(out[i, :n].astype(np.uint64)), want_of(e)):
                raise AssertionError(f"lane {int(e)} (list {int(ent_list[e])}) does not "
                                     "decode to its ids")
        del out

        # group kernel throughput: output reduced to a scalar ON DEVICE so
        # the sync doesn't time a multi-hundred-MB host transfer
        step = max(len(rows) // 64, 1)

        def decode_reduced():
            o = dec.decode()
            return o[0, 0] + o[-1, -1] + o[::step, 0].sum()

        seconds(decode_reduced, dev)  # warm
        g_s = min(seconds(decode_reduced, dev)[0] for _ in range(args.runs))
        total_dec_s += g_s
        log(f"group {gi}: {len(rows)} lanes, {g_ids} ids, "
            f"n_max={dec.n_max}: {g_s*1e3:.1f} ms "
            f"-> {g_ids/g_s/1e6:.1f} Mids/s; every lane round-trips")
        if gi == 0:
            rate_largest = g_ids / g_s
        del dec

    dec_rate = args.ntotal / total_dec_s
    log(f"decode on {dev} (scalar-reduced sync, {len(groups)} group(s)): "
        f"{total_dec_s*1e3:.1f} ms -> {dec_rate/1e6:.1f} Mids/s")
    log(f"decode one-shot total (incl. id pulls): {total_oneshot_s*1e3:.1f} "
        f"ms -> {args.ntotal/total_oneshot_s/1e6:.1f} Mids/s")

    # ---- device encode over the first (longest-lane) lane group ----------
    enc_rate = None
    if (not args.skip_device_encode
            and min(E, args.lane_chunk) * n_max <= (1 << 28)):
        rows = sort_order[: min(E, args.lane_chunk)]
        e_ids = int(ent_len[rows].astype(np.int64).sum())
        ids_t = torch.from_numpy(padded_entries(ent_arrays, rows, n_max)).to(dev)
        len_t = torch.from_numpy(ent_len[rows]).to(dev)
        prec_t = torch.from_numpy(ent_prec[rows]).to(dev)
        st, _ = RocEncoder.encode(ids_t, len_t, prec_t)
        # the device streams are the host build's
        r = torch.from_numpy(rows)
        w = min(st.stack.shape[1], stacks.shape[1])
        for name, got, want in (("head", st.head, torch.from_numpy(heads)[r]),
                                ("stack_len", st.stack_len, torch.from_numpy(lens_np)[r]),
                                ("mt_ctr", st.mt_ctr, torch.from_numpy(mt_np)[r]),
                                ("stack", st.stack[:, :w], torch.from_numpy(stacks)[r][:, :w])):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"device encode: {name} differs from the host build")

        def encode_reduced():
            s, _ = RocEncoder.encode(ids_t, len_t, prec_t)
            return s.head[0] + s.head[-1] + s.stack_len.sum()

        seconds(encode_reduced, dev)
        t = min(seconds(encode_reduced, dev)[0] for _ in range(args.runs))
        enc_rate = e_ids / t
        log(f"encode on {dev} ({len(rows)} lanes): {t*1e3:.1f} ms "
            f"-> {enc_rate/1e6:.1f} Mids/s; streams == the host build's")

    row = {
        "ntotal": args.ntotal, "nlist": args.nlist, "n_max": n_max_list,
        "interleave": args.interleave, "lanes": E,
        "lane_n_max": n_max,
        "bits_per_id": round(bits_per_id, 4),
        "host_encode_s": round(t_enc_host, 3),
        "decode_oneshot_mids_s": round(
            args.ntotal / total_oneshot_s / 1e6, 2),
        "decode_mids_s": round(dec_rate / 1e6, 2),
        "decode_mids_s_largest_group": (
            round(rate_largest / 1e6, 2) if rate_largest else None),
        "encode_mids_s": (round(enc_rate / 1e6, 2) if enc_rate else None),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()

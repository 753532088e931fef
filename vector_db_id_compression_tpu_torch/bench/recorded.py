"""The JAX package's last recorded runs on the card: their gates, and the
ROC kernels at their lane shapes.

The runs themselves are the drivers' (``chip_bench.sh recorded``):
``search_100m`` at 10^8 ids over 65,536 lists (seven id codecs) and 262,144
lists, P1 with IVF1024,PQ16 and with IVF128,Flat at 10^6, the flat coarse
quantizer over 1,048,576 centroids, ``codec_scale`` at 3 x 10^7 ids and the
small P1, P2 and P5 runs. This module reads what they wrote and measures
what their outputs do not hold:

  - ``check``: fails (exit 1) unless every gate holds, and prints one row
    per method.
      * ``--search-100m OUT RECORD``: every (method, nprobe) row of the
        record is in OUT and none other; ``method``, ``nprobe``, ``k``,
        ``nq``, ``ntotal``, ``nlist``, ``ids_size`` and ``bits_per_id``
        equal the record's exactly (the corpus and its lists are the JAX
        package's draws); ``recall_1`` is the same for every method at a
        nprobe (the ids are lossless).
      * ``--p1 CSV``: ``recall_1`` the same for every method at a nprobe;
        ``ref`` 64 bits/id; ``packed-bits``, where present, at least
        ``packed_width(ntotal)`` and below it plus each list's word padding
        (under 32 bits a list); every other codec below packed-bits (or
        below ``packed_width``). Not compared with the record: the port's
        k-means draws its own numbers, so its lists differ.
      * ``--codec-scale OUT RECORD``: each row's ``bits_per_id`` and
        ``n_max`` equal the one recorded row of its ``ntotal`` and
        ``nlist``.
      * ``--quantizer OUT PROBES``: ``hnsw`` empty, ``flat_ms`` present, and
        the first ``QUANTIZER_QUERIES`` queries' probes (``quantizer_bench
        --dump-probes``) equal a float64 top-nprobe over the same draws
        under the near-tie rule of ``tests/test_torch_ivf.py``.
  - ``lanes``: the ``roc`` and ``roc-interleaved`` containers of one index's
    lists (P1's ``--index`` at ``--synth_scale``, or ``search_100m``'s
    lists of ``--ntotal`` ids in ``--nlist``): the lanes, their longest,
    the layout each kernel takes for them (bytes a lane, lanes a block in
    shared memory), the encode kernel over every lane and the decode kernel
    over every lane (CUDA-event medians after a warm-up), their launches,
    their bound by bytes, and the chain probe's step over the longest lane,
    or over as many of its ids as the probe holds (the chain bound). Gates: the kernel's states equal the container's,
    every lane decodes to its ids, the chain probe equals the codec, the
    bits/id equal ``--csv``'s rows where given, and with ``--plain`` both
    kernels equal their plain versions (``codecs/roc_device.py``) bit for
    bit over every lane, once, outside the timed calls. One JSON object to
    stdout (and ``--out``).

Usage::

    python -m vector_db_id_compression_tpu_torch.bench.recorded check \\
        --search-100m OUT/search_100m_h100.json results/search_100m_tpu.json \\
        --p1 OUT/bench_invlists_synthetic1m_pq16_h100.csv \\
        --codec-scale OUT/codec_scale_30m.jsonl results/codec_scale_tpu.jsonl \\
        --quantizer OUT/quantizer_1m_flat_h100.json OUT/quantizer_1m_probes.npy
    python -m vector_db_id_compression_tpu_torch.bench.recorded lanes \\
        --index IVF128,Flat --synth_scale 10 --plain --out OUT/lanes_ivf128.json
    python -m vector_db_id_compression_tpu_torch.bench.recorded lanes \\
        --ntotal 100000000 --nlist 262144 --out OUT/lanes_100m_262k.json

``lanes`` runs on the card unless given ``--device cpu`` (then without
layouts, timed on the host clock).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..codecs.packed_bits import packed_width
from ..device import DEFAULT_DEVICE, resolve
from ._timing import log, seconds, sync

SEARCH_100M_EXACT = ("method", "nprobe", "k", "nq", "ntotal", "nlist", "ids_size",
                     "bits_per_id")
# the near-tie rule's tolerances (tests/test_torch_ivf.py)
RTOL, ATOL = 1e-5, 1e-4
QUANTIZER_QUERIES = 16
QUANTIZER_SEED = 3  # quantizer_bench's default --seed
# the H100 SXM's HBM rate and float32 rate outside the tensor cores (NVIDIA's
# data sheet), as chip_smoke.py bounds the kernels
HBM_BYTES_PER_S, SCALAR_OPS_PER_S = 3.35e12, 67e12


def recall_failures(rows) -> list:
    by = {}
    for r in rows:
        by.setdefault(r["nprobe"], set()).add(r["recall_1"])
    return [f"nprobe {n}: recall_1 differs across methods: {sorted(v)}"
            for n, v in by.items() if len(v) != 1]


def search_100m_failures(rows, record) -> list:
    """What breaks the gates of a ``search_100m`` output against its record."""
    got = {(r["method"], r["nprobe"]): r for r in rows}
    want = {(r["method"], r["nprobe"]): r for r in record}
    bad = [] if set(got) == set(want) else [
        f"rows {sorted(got)}, the record's {sorted(want)}"]
    for key in sorted(set(got) & set(want), key=str):
        for field in SEARCH_100M_EXACT:
            if got[key][field] != want[key][field]:
                bad.append(f"{key[0]} nprobe {key[1]}: {field} {got[key][field]!r}, the "
                           f"record's {want[key][field]!r}")
    return bad + recall_failures(rows)


def p1_failures(rows) -> list:
    """What breaks the gates of one P1 CSV (its rows as ``csv`` reads them)."""
    from .bench_invlists import parse_index_str

    bad = recall_failures(rows)
    bits = {}
    for r in rows:
        bits.setdefault(r["method"], set()).add(float(r["bits_per_id"]))
    if bits.get("ref") != {64.0}:
        return bad + [f"ref: {bits.get('ref')} bits/id, not 64"]
    ref = next(r for r in rows if r["method"] == "ref")
    ntotal = int(ref["ids_size"]) // 8
    nlist = parse_index_str(ref["index"])[0]
    width = packed_width(ntotal)
    bad += [f"{m}: bits/id differ across its rows: {sorted(b)}"
            for m, b in bits.items() if len(b) != 1]
    below = width
    if "packed-bits" in bits:
        below = max(bits["packed-bits"])
        # each list's words end in fewer than 32 unused bits
        if not width <= below < width + 32 * nlist / ntotal:
            bad.append(f"packed-bits: {below} bits/id, not in [{width}, "
                       f"{width} + 32 x {nlist} / {ntotal})")
    for m, b in bits.items():
        if m not in ("ref", "packed-bits") and not max(b) < below:
            bad.append(f"{m}: {sorted(b)} bits/id, not below {below}")
    return bad


def codec_scale_failures(rows, record) -> list:
    bad = [] if rows else ["no rows"]
    for r in rows:
        match = [x for x in record if (x["ntotal"], x["nlist"]) == (r["ntotal"], r["nlist"])]
        if len(match) != 1:
            bad.append(f"ntotal {r['ntotal']} nlist {r['nlist']}: {len(match)} recorded rows")
            continue
        for field in ("bits_per_id", "n_max"):
            if r[field] != match[0][field]:
                bad.append(f"ntotal {r['ntotal']} nlist {r['nlist']}: {field} {r[field]!r}, "
                           f"the record's {match[0][field]!r}")
    return bad


def near_tie_failures(what, d_ref, i_ref, d_got, i_got) -> list:
    """The near-tie rule over one query's ranking: ``i_got`` may differ from
    ``i_ref`` only where the reference distances on either side lie within
    the tolerance (at the last slot, beside the got candidate's)."""
    def close(a, b):
        return abs(a - b) <= ATOL + RTOL * abs(b)

    if not np.allclose(d_got, d_ref, rtol=RTOL, atol=ATOL):
        return [f"{what}: distances differ from the exact ones"]
    k = len(i_ref)
    for j in np.flatnonzero(i_got != i_ref):
        left = j > 0 and close(d_ref[j], d_ref[j - 1])
        right = close(d_ref[j], d_ref[j + 1] if j + 1 < k else d_got[j])
        if not (left or right):
            return [f"{what} slot {j}: {i_got[j]}, exactly {i_ref[j]}, without a near tie"]
    return []


def quantizer_failures(out: dict, probes: np.ndarray, seed: int) -> list:
    """The flat quantizer's record: no HNSW, a flat time, and its probes
    against a float64 top-nprobe of the same draws (``quantizer_bench.draw``)
    over the first ``QUANTIZER_QUERIES`` queries."""
    from .quantizer_bench import draw

    bad = []
    if out.get("hnsw") != []:
        bad.append(f"hnsw: {out.get('hnsw')!r}, not []")
    if not isinstance(out.get("flat_ms"), (int, float)):
        bad.append(f"flat_ms: {out.get('flat_ms')!r}")
    if probes.shape != (out["nq"], out["nprobe"]):
        return bad + [f"probes of shape {probes.shape}, not {(out['nq'], out['nprobe'])}"]
    cents, xq = draw(out["nlist"], out["d"], out["nq"], seed)
    c = cents.astype(np.float64)
    q = xq[:QUANTIZER_QUERIES].astype(np.float64)
    # ||x - c||^2 up to the per-query constant ||x||^2, as coarse_assign ranks
    d2 = (c * c).sum(axis=1)[None, :] - 2.0 * (q @ c.T)
    for i, row in enumerate(d2):
        exact = np.argsort(row, kind="stable")[:out["nprobe"]]
        bad += near_tie_failures(f"quantizer query {i}", row[exact], exact, row[probes[i]],
                                 probes[i])
    return bad


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.startswith("{")]


def check(args) -> int:
    bad = []
    for out, rec in args.search_100m or []:
        rows = json.loads(Path(out).read_text())
        for r in rows:
            print(f"search_100m nlist {r['nlist']:7d} {r['method']:15s} nprobe {r['nprobe']:3d}: "
                  f"bits/id {r['bits_per_id']!r}, ids_size {r['ids_size']}, t_search "
                  f"{r['t_search']!r} (min {r['t_search_min']!r}), recall_1 {r['recall_1']}")
        bad += [f"{out}: {b}" for b in search_100m_failures(
            rows, json.loads(Path(rec).read_text()))]
    for path in args.p1 or []:
        rows = read_csv(path)
        for r in rows:
            print(f"P1 {r['index']} {r['method']:15s} nprobe {r['nprobe']:>3s}: bits/id "
                  f"{r['bits_per_id']}, dt_search {r['dt_search']}, recall_1 {r['recall_1']}")
        bad += [f"{path}: {b}" for b in p1_failures(rows)]
    for out, rec in args.codec_scale or []:
        rows = read_jsonl(out)
        for r in rows:
            print(f"codec_scale ntotal {r['ntotal']} nlist {r['nlist']}: bits/id "
                  f"{r['bits_per_id']}, n_max {r['n_max']}, lanes {r.get('lanes')}")
        bad += [f"{out}: {b}" for b in codec_scale_failures(rows, read_jsonl(rec))]
    for out, probes in args.quantizer or []:
        o = json.loads(Path(out).read_text())
        print(f"quantizer nlist {o['nlist']} nprobe {o['nprobe']}: flat {o.get('flat_ms')} ms "
              f"(min {o.get('flat_ms_min')})")
        bad += [f"{out}: {b}" for b in quantizer_failures(o, np.load(probes), QUANTIZER_SEED)]
    for line in bad:
        print(f"FAIL {line}")
    print("recorded check: " + ("FAILED" if bad else "all gates hold"))
    return 1 if bad else 0


def _ms(fn, device, reps: int = 5) -> float:
    """Median ms of ``fn`` after a warm-up: CUDA events on a card, the host
    clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            times.append(seconds(fn, device)[0] * 1e3)
    return float(np.median(times))


def _bound(nbytes: float, lens: np.ndarray):
    """(ms, by): the larger of the bytes over the HBM rate and the order
    statistics' operations, n ceil(log2 n) a lane of n, over the scalar
    rate (chip_smoke.py's ``bound``)."""
    lens = lens.astype(np.float64)
    ops = float((lens * np.ceil(np.log2(np.maximum(lens, 1)))).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_table(name, il):
    """(ids u64[B, n_max] ascending, zero-padded; lengths i32[B]; precision
    i32[B]): the encode kernel's input for container ``name``."""
    from ..store.invlists import interleaved_lane_table, roc_lane_table

    if name == "roc":
        return roc_lane_table(il)[:3]
    t = interleaved_lane_table(il)
    return t.ids, t.lengths, t.precision


def chain_us(ids_t, len_t, prec_t, b: int):
    """The chain probe over lane ``b`` (``ops/probes.py`` ``ProbeChain``),
    each checked against the codec's own stream: (decode, encode) us a step
    and the ids it ran. The probe holds a lane's symbols and stack in shared
    memory, so a lane too long for it is probed by its smallest ids (a list
    of their own, at the lane's precision); its launch and staging then
    spread over fewer steps, so the step it gives errs long."""
    from ..codecs import roc_device as rd
    from ..ops._build import SHARED_BYTES_PER_BLOCK
    from ..ops.probes import ProbeChain, decode_ranks
    from ..ops.roc_decode import RocDecoder
    from ..ops.roc_encode import RocEncoder

    dev = ids_t.device
    n, p = int(len_t[b]), int(prec_t[b])
    # the probe's decode buffers (probe_chain.cu): 12 bytes a symbol, the stack
    while n * 12 + 4 * rd.stack_capacity(n, p) > SHARED_BYTES_PER_BLOCK:
        n = n * 3 // 4
    lane, p1 = ids_t[b:b + 1, :n], prec_t[b:b + 1]
    l1 = torch.full((1,), n, dtype=torch.int32, device=dev)
    st, order = RocEncoder.encode(lane, l1, p1)
    in_order = lane.gather(1, order.long())
    enc_ms = _ms(lambda: ProbeChain.encode(in_order, l1, p1), dev)
    if not all(torch.equal(a, b_) for a, b_ in zip(ProbeChain.encode(in_order, l1, p1), st)):
        raise AssertionError(f"chain probe encode of lane {b} differs from the codec's")
    pool = rd.default_pool(n, dev)
    decoded = RocDecoder(st, l1, p1, pool, n).decode()[:, :n]
    ranks = decode_ranks(decoded, l1)
    dec_ms = _ms(lambda: ProbeChain.decode(st, l1, p1, ranks, pool), dev)
    if not torch.equal(ProbeChain.decode(st, l1, p1, ranks, pool), decoded.flip(1)):
        raise AssertionError(f"chain probe decode of lane {b} differs from the codec's")
    return dec_ms * 1e3 / n, enc_ms * 1e3 / n, n


def container_lanes(name, il, dev, plain: bool) -> dict:
    """One container's lanes through both kernels (``lanes``)."""
    from ..codecs import roc_device as rd
    from ..ops.roc_decode import RocDecoder
    from ..ops.roc_encode import RocEncoder, encode_layout
    from ..store.invlists import AVAILABLE_COMPRESSED_IVFS

    enc0 = RocEncoder.launches
    build_s, c = seconds(lambda: AVAILABLE_COMPRESSED_IVFS[name](il, device=dev), dev)
    enc_per_build = RocEncoder.launches - enc0
    ids, lengths, prec = lane_table(name, il)
    B, n_max = ids.shape
    ids_t = torch.from_numpy(ids.view(np.int64)).to(dev)
    len_t, prec_t = torch.from_numpy(lengths).to(dev), torch.from_numpy(prec).to(dev)
    dec = c.decoder
    st, order = RocEncoder.encode(ids_t, len_t, prec_t)
    if not all(torch.equal(a, b) for a, b in zip(st, dec.states)):
        raise AssertionError(f"{name}: the encode kernel's states differ from the container's")
    enc_ms = _ms(lambda: RocEncoder.encode(ids_t, len_t, prec_t), dev)
    dec_ms = _ms(dec.decode, dev)
    dec0 = RocDecoder.launches
    got = dec.decode()
    sync(dev)
    dec_per_call = RocDecoder.launches - dec0
    # every lane's ids come back (in sampling order: compared sorted)
    valid = torch.arange(n_max, device=dev)[None, :] < len_t[:, None]
    top = torch.iinfo(torch.int64).max
    if not torch.equal(torch.sort(torch.where(valid, got, top), dim=1).values,
                       torch.where(valid, ids_t, top)):
        raise AssertionError(f"{name}: a lane does not decode to its ids")
    b = int(np.argmax(lengths))
    dec_us, enc_us, probed = chain_us(ids_t, len_t, prec_t, b)
    n_ids = int(lengths.astype(np.int64).sum())
    words = int(st.stack_len.to(torch.int64).sum())
    # each kernel's inputs read once and outputs written once: ids (8 B),
    # length and precision (8 B a lane), head, stack length and counter
    # (16 B a lane) and the stack words; the encode's order (4 B a slot),
    # the decode's ids (8 B a slot)
    enc_bound = _bound(8 * n_ids + 24 * B + 4 * words + 4 * B * n_max, lengths)
    dec_bound = _bound(24 * B + 4 * words + 8 * B * n_max, lengths)
    out = {"lanes": B, "lane_n_max": n_max, "ids": n_ids, "precision_max": int(prec.max()),
           "bits_per_id": 8.0 * c.compressed_ids_size_in_bytes / n_ids,
           "overhead_size": int(getattr(c, "overhead_in_bytes", 0)), "build_s": build_s,
           "encode_ms": enc_ms, "decode_ms": dec_ms,
           "encode_launches_per_build": enc_per_build, "decode_launches_per_call": dec_per_call,
           "encode_bound_ms": enc_bound[0], "encode_bound_by": enc_bound[1],
           "decode_bound_ms": dec_bound[0], "decode_bound_by": dec_bound[1],
           "longest_lane": int(lengths[b]), "chain_probe_ids": probed,
           "chain_decode_us_step": dec_us,
           "chain_encode_us_step": enc_us,
           "chain_decode_bound_ms": int(lengths[b]) * dec_us / 1e3,
           "chain_encode_bound_ms": int(lengths[b]) * enc_us / 1e3}
    if dev.type == "cuda":
        lane_bytes, shared = encode_layout(n_max)
        sym_bytes, dec_lane_bytes, per_block = dec.layout()
        out["encode_layout"] = {"lane_bytes": lane_bytes, "shared": shared}
        out["decode_layout"] = {"symbol_bytes": sym_bytes, "lane_bytes": dec_lane_bytes,
                                "lanes_per_block_in_shared": per_block}
    if plain:
        maxp = int(prec.max())
        n_slices, pool = rd.n_slices_for(maxp), rd.default_pool(n_max, dev)
        t_enc, (st_p, order_p) = seconds(lambda: rd.roc_encode_batch(
            ids_t, len_t, prec_t, pool, rd.fresh_states(B, rd.stack_capacity(n_max, maxp), dev),
            n_slices), dev)
        t_dec, (ids_p, _) = seconds(lambda: rd.roc_decode_batch(
            st, len_t, prec_t, pool, n_max, n_slices), dev)
        enc_equal = all(torch.equal(a, b_) for a, b_ in zip((*st, order), (*st_p, order_p)))
        dec_equal = torch.equal(got, ids_p)
        out["plain"] = {"encode_s": t_enc, "decode_s": t_dec, "encode_equal": enc_equal,
                        "decode_equal": dec_equal}
        if not (enc_equal and dec_equal):
            raise AssertionError(f"{name}: kernels vs plain versions: encode equal {enc_equal}, "
                                 f"decode equal {dec_equal}")
    return out


def lanes(args) -> dict:
    dev = resolve(args.device)
    t0 = time.time()
    if args.index:
        from .bench_invlists import build_index
        from .datasets import get_dataset

        ds = get_dataset("synthetic", synth_scale=args.synth_scale, device=dev)
        il = build_index(ds, args.index, device=dev).invlists
        source = f"P1 {args.index} over {ds}"
    else:
        from .search_100m import clustered_lists

        il = clustered_lists(args.ntotal, args.nlist)
        source = f"search_100m's lists: {args.ntotal} ids in {args.nlist} lists"
    lens = il.lengths
    log(f"{source}: lists of {int(lens.min())}..{int(lens.max())} ids, built in "
        f"{time.time() - t0:.0f} s")
    out = {"source": source, "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                        else "cpu"),
           "list_len_max": int(lens.max()), "list_len_mean": float(lens.mean()),
           "containers": {}}
    want = {}
    if args.csv:
        want = {r["method"]: float(r["bits_per_id"]) for r in read_csv(args.csv)}
    for name in ("roc", "roc-interleaved"):
        c = container_lanes(name, il, dev, args.plain)
        out["containers"][name] = c
        log(f"{name}: {json.dumps(c)}")
        if name in want and c["bits_per_id"] != want[name]:
            raise AssertionError(f"{name}: {c['bits_per_id']} bits/id, {args.csv}'s "
                                 f"{want[name]}: not the run's lists")
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check")
    c.add_argument("--search-100m", nargs=2, action="append", metavar=("OUT", "RECORD"))
    c.add_argument("--p1", action="append", metavar="CSV")
    c.add_argument("--codec-scale", nargs=2, action="append", metavar=("OUT", "RECORD"))
    c.add_argument("--quantizer", nargs=2, action="append", metavar=("OUT", "PROBES"))
    ln = sub.add_parser("lanes")
    src = ln.add_mutually_exclusive_group(required=True)
    src.add_argument("--index", help="P1's index string, e.g. IVF128,Flat")
    src.add_argument("--ntotal", type=int, help="search_100m's ids")
    ln.add_argument("--synth_scale", type=float, default=1.0)
    ln.add_argument("--nlist", type=int, default=65536)
    ln.add_argument("--csv", help="the P1 run's CSV: its bits/id must be the containers'")
    ln.add_argument("--plain", action="store_true",
                    help="also hold both kernels against their plain versions")
    ln.add_argument("--out")
    ln.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.cmd == "check":
        return check(args)
    lanes(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

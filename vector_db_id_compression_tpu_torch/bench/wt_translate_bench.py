"""Wavelet-tree translate decomposition at the Table-4 shape; port of the
JAX package's ``bench/wt_translate_bench.py``.

The deferred-decoding search translates its nshort-per-query shortlist
labels 1-by-1 with a wavelet-tree select (the reference pays the same
per-result wt.select at custom_invlists_impl.cpp:377-379). This driver
isolates that translate at the Table-4 shape — Q = nq x nshort select queries
against a wavelet tree over ``--ntotal`` ids in ``--nlist`` lists — and
decomposes it into:

  - ``select_chip_ms``: the select walk alone on the device
    (``codecs/wavelet_tree.py`` ``wt_select``, or ``wt_select_rrr`` for
    ``--wt-type 1``), output reduced to a scalar on the device (no transfer);
  - ``e2e_ms``: the container's ``get_single_ids_batch`` end to end
    (label upload + the walk + id pull — what the search path pays);
  - ``floor_ms``: a trivial torch op with the same output shape, timed the
    same way (this machine's launch + transfer floor for this shape);

so e2e ≈ floor + chip tells launch/transfer-bound from walk-bound. The
selected ids are checked: each is the offset-th member of its list.

    python -m vector_db_id_compression_tpu_torch.bench.wt_translate_bench \
        --ntotal 10000000 --nlist 65536 --wt-type 0 \
        --out results/wt_translate_10m65k_h100.json

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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ntotal", type=int, default=10_000_000)
    p.add_argument("--nlist", type=int, default=65536)
    p.add_argument("--nq", type=int, default=1000)
    p.add_argument("--nshort", type=int, default=200)
    p.add_argument("--wt-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the tree lives and the walk runs (default: the card)")
    args = p.parse_args(argv)

    from ..codecs.wavelet_tree import wt_select, wt_select_rrr
    from ..store.invlists import InvertedLists, WaveletTreeInvertedLists
    from .codec_scale import build_workload

    dev = resolve(args.device)
    log(f"device: {dev}")
    t0 = time.time()
    ids, lengths, prec = build_workload(args.ntotal, args.nlist, args.seed)
    il = InvertedLists(args.nlist, 0)
    for ln in range(args.nlist):
        il.add_entries(ln, ids[ln, : lengths[ln]], np.zeros(0, np.uint8))
    log(f"workload in {time.time()-t0:.0f}s")
    t, cont = seconds(lambda: WaveletTreeInvertedLists(il, wt_type=args.wt_type,
                                                       device=dev), dev)
    log(f"wt built in {t:.0f}s ({cont.compressed_ids_size_in_bytes} B)")

    # Table-4-shaped labels: nq queries x nshort shortlist entries, each a
    # (list_no, offset) pair drawn over the length distribution
    rng = np.random.default_rng(args.seed + 1)
    Q = args.nq * args.nshort
    lns = rng.integers(0, args.nlist, size=Q)
    nz = lengths[lns] > 0
    lns = np.where(nz, lns, int(np.argmax(lengths)))
    offs = (rng.random(Q) * lengths[lns]).astype(np.int64)

    # e2e: what the deferred-decoding search path pays per translate
    def e2e():
        return cont.get_single_ids_batch(torch.from_numpy(lns),
                                         torch.from_numpy(offs)).cpu()

    got = seconds(e2e, dev)[1].numpy()  # warm
    # oracle: the selected id must be the offs-th member of its list
    np.testing.assert_array_equal(got.astype(np.uint64), ids[lns, offs])
    e2e_s = min(seconds(e2e, dev)[0] for _ in range(args.runs))

    # on the device: the same walk, scalar-reduced
    wt = cont.wt
    levels = wt.levels
    tab = cont.wt_tables
    sel = wt_select if args.wt_type == 0 else wt_select_rrr
    sy_d = torch.from_numpy(lns).to(dev)
    of_d = torch.from_numpy(offs).to(dev)
    step = max(Q // 64, 1)

    def chip():
        out = sel(wt, sy_d, of_d, tables=tab)
        return out[0] + out[-1] + out[::step].sum()

    seconds(chip, dev)
    chip_s = min(seconds(chip, dev)[0] for _ in range(args.runs))

    # launch + transfer floor for the e2e output shape (Q int64 ids)
    shp = torch.zeros(Q, dtype=torch.int64, device=dev)
    seconds(lambda: (shp + 1).cpu(), dev)
    floor_s = min(seconds(lambda: (shp + 1).cpu(), dev)[0] for _ in range(args.runs))

    row = {
        "ntotal": args.ntotal, "nlist": args.nlist, "wt_type": args.wt_type,
        "Q": Q, "levels": levels,
        "e2e_ms": round(e2e_s * 1e3, 2),
        "select_chip_ms": round(chip_s * 1e3, 2),
        "floor_ms": round(floor_s * 1e3, 2),
        "per_select_us_chip": round(chip_s / Q * 1e6, 3),
        "per_select_us_e2e": round(e2e_s / Q * 1e6, 3),
    }
    log(f"e2e {row['e2e_ms']} ms | chip {row['select_chip_ms']} ms | "
        f"floor {row['floor_ms']} ms | "
        f"{row['per_select_us_chip']} us/select on {dev}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()

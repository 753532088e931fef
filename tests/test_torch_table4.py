"""P5 (``search_ivf_qinco``) under every ``--id_compression`` mode: the
paper's Table 4 protocol (one trained and added index, one search per id
codec, as the JAX package's ``tools/run_table4.sh`` runs it) at the tiny
fixture of ``test_torch_bench_ivf.py``, the port's driver against the JAX
package's.

The JAX driver trains and adds once; both drivers then resume from that
workdir's ``qinco_index.npz`` and search it in each mode. Each search's
shortlist (D, I, codes) is read where the driver calls
``search_defer_id_decoding``. ``ids_size`` and ``bits_per_id`` equal the
JAX driver's exactly, and the shortlist equals the JAX driver's under the
near-tie rule of ``test_torch_ivf.py``. The id codecs are lossless: in
every mode the port's shortlist and its re-rank hold the raw ids' distances
and entries (list and codes) exactly, and its recalls are the raw ids'
wherever its re-ranked ids are. At this size many entries of one list share
their codes and tie exactly; ROC stores each list in its sampling order, so
it may keep the other of two such entries and move a recall, as the JAX
driver's ROC run does too (ROADMAP Queue C)."""

import hashlib
import json

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.bench import datasets as jax_datasets
from vector_db_id_compression_tpu.bench import search_ivf_qinco as jax_qinco
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu_torch.bench import datasets, search_ivf_qinco, table4
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index
from test_torch_bench_ivf import QINCO_ARGS
from test_torch_ivf import assert_same_results

MODES = ("none", "packed-bits", "elias-fano", "roc", "wavelet-tree", "wavelet-tree-1")
SEARCH = ["--todo", "search", "--defer_id_decoding", "--nprobe", "4", "--nshort", "20",
          "--k", "10"]


def _search(driver, index_cls, argv):
    """(the driver's output, the shortlist D, I, codes of its last search
    as numpy) for ``driver.main(argv)``."""
    seen = []
    search = index_cls.search_defer_id_decoding

    def record(self, *a, **kw):
        out = search(self, *a, **kw)
        seen.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(index_cls, "search_defer_id_decoding", record)
        driver.main(argv)
    work = argv[argv.index("--workdir") + 1]
    with open(f"{work}/search_results.json") as f:
        res = json.load(f)
    return res, tuple(np.asarray(t) for t in seen[-1])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One index, trained and added by the JAX driver."""
    work = tmp_path_factory.mktemp("table4")
    jax_qinco.main([*QINCO_ARGS, "--workdir", str(work), "--todo", "train", "add"])
    return work


@pytest.fixture(scope="module")
def port_none(workdir):
    return _search(search_ivf_qinco, IndexIVF,
                   [*QINCO_ARGS, *SEARCH, "--workdir", str(workdir), "--id_compression",
                    "none", "--device", "cpu"])


def entry_codes(workdir, I):
    """The index's entry of each id in ``I`` (i64[nq, k], -1 for an empty
    slot), as the harvest returns it: its list number's little-endian
    bytes, then its code bytes; 0xff for an empty slot."""
    with np.load(workdir / "qinco_index.npz") as z:
        lengths, ids, codes = z["lengths"], z["ids_flat"].astype(np.int64), z["codes_flat"]
        nlist = len(z["centroids"])
    cs = len(codes) // len(ids)
    ccs = ((nlist - 1).bit_length() + 7) // 8
    listno = np.repeat(np.arange(nlist), lengths)
    row = np.empty(len(ids), dtype=np.int64)
    row[ids] = np.arange(len(ids))
    table = np.concatenate([(listno[:, None] >> (8 * np.arange(ccs))).astype(np.uint8),
                            codes.reshape(-1, cs)], axis=1)
    out = np.full((*I.shape, ccs + cs), 0xFF, dtype=np.uint8)
    out[I >= 0] = table[row[I[I >= 0]]]
    return out


@pytest.mark.parametrize("mode", MODES)
def test_search_ivf_qinco_mode_equals_jax(workdir, port_none, mode):
    argv = [*QINCO_ARGS, *SEARCH, "--workdir", str(workdir), "--id_compression", mode]
    res_j, (D_j, I_j, _) = _search(jax_qinco, JaxIndexIVF, argv)
    res, (D, I, codes) = _search(search_ivf_qinco, IndexIVF, [*argv, "--device", "cpu"])
    res_none, (D_none, I_none, codes_none) = port_none
    for key in ("ids_size", "bits_per_id", "ntotal"):
        assert res[key] == res_j[key], key
    # lossless: the raw ids' shortlist, its distances and entries exactly;
    # ROC reorders each list's entries, so an id may differ between two
    # entries that are the same to the index (one list, the same codes),
    # which tie exactly; every entry's codes are its own
    np.testing.assert_array_equal(D, D_none)
    np.testing.assert_array_equal(codes, codes_none)
    np.testing.assert_array_equal(codes, entry_codes(workdir, I))
    assert_same_results(D, I, D_j, I_j)
    # the re-rank, as the driver runs it: the raw ids' top k up to such
    # entries, and the same recalls wherever its ids are the same
    xq = torch.from_numpy(datasets.get_dataset("synthetic", synth_scale=0.02,
                                               device="cpu").get_queries())
    index = load_index(workdir / "qinco_index.npz", device="cpu")
    D_rr, I_rr = (t.numpy() for t in search_ivf_qinco.rerank(
        index, xq, torch.from_numpy(I), torch.from_numpy(codes), 10))
    D_rr0, I_rr0 = (t.numpy() for t in search_ivf_qinco.rerank(
        index, xq, torch.from_numpy(I_none), torch.from_numpy(codes_none), 10))
    np.testing.assert_array_equal(D_rr, D_rr0)
    np.testing.assert_array_equal(entry_codes(workdir, I_rr), entry_codes(workdir, I_rr0))
    if np.array_equal(I_rr, I_rr0):
        assert [r["recalls"] for r in res["results"]] == \
            [r["recalls"] for r in res_none["results"]]
    else:
        assert mode == "roc"  # the only codec that reorders a list's entries


def test_table4_profile_of_the_workdir(workdir, port_none):
    """``table4 profile`` on the CPU: ``add`` again, stage by stage, writes
    the saved lists (the JAX driver's add) exactly, and the ROC and RRR
    wavelet-tree searches at the workdir's operating point are timed part
    by part (no idle share without a card)."""
    out = table4.profile_run(workdir, "cpu")
    add = out["add"]
    assert add["lists_equal_saved"] and add["ntotal"] == port_none[0]["ntotal"]
    assert add["encode_s"] > 0 and abs(sum(v for k, v in add.items() if k.endswith("_s")
                                           and k != "total_s") - add["total_s"]) < 1e-9
    for mode in table4.PROFILED_MODES:
        assert out[mode]["idle_share"] is None and out[mode]["touched_lists"] > 0
        assert all(out[mode][f"{part}_ms"] > 0
                   for part in ("search", "positional", "harvest", "translate", "rerank"))
    assert out["roc"]["roc_encode_all_lists_ms"] > 0 and out["roc"]["roc_decode_touched_ms"] > 0


def test_table4_dataset_sha256_equals_jax():
    """The synthetic mixture the run draws (``get_dataset("synthetic",
    synth_scale=...)``; Table 4 takes 100: 10^6 training, 10^7 database,
    1000 query vectors of d 32) hashes as the JAX package's at the fixture's
    scale."""
    def digests(ds):
        return [hashlib.sha256(a.tobytes()).hexdigest()
                for a in (ds.get_train(), ds.get_database(), ds.get_queries())]

    ours = datasets.get_dataset("synthetic", synth_scale=0.02, device="cpu")
    ref = jax_datasets.get_dataset("synthetic", synth_scale=0.02)
    assert digests(ours) == digests(ref)


def _out(mode, bits, recall=0.5, ntotal=10_000_000):
    return {"ntotal": ntotal, "bits_per_id": bits, "args": {"id_compression": mode},
            "results": [{"run": 0, "parameters": {"nprobe": 128, "nshort": 200},
                         "recalls": {"1": recall}}]}


GOOD = {"none": 64.0, "packed-bits": 24.0, "elias-fano": 17.5, "roc": 18.1,
        "wavelet-tree": 16.5, "wavelet-tree-1": 16.3}


@pytest.mark.parametrize("mode, bits, recall, failed", [
    (None, None, None, []),
    ("roc", 18.1, 0.501, ["roc: recalls or runs differ from none's"]),
    ("none", 63.9, 0.5, ["none: 63.9 bits/id, not 64"]),
    ("packed-bits", 24.0001, 0.5, ["packed-bits: 24.0001 bits/id, not 24"]),
    ("wavelet-tree-1", 24.0, 0.5, ["wavelet-tree-1: 24.0 bits/id, not below 24"]),
])
def test_table4_gates(mode, bits, recall, failed):
    """``table4.failures``, the gates of ``chip_bench.sh table4``: recalls
    equal in every mode at every run, 64 bits/id raw, exactly
    ceil(log2(ntotal + 1)) packed, fewer for every other codec."""
    outs = {m: _out(m, b) for m, b in GOOD.items()}
    if mode:
        outs[mode] = _out(mode, bits, recall)
    assert table4.failures(outs) == failed

"""``bench/recorded.py``: the gates of the JAX package's last recorded runs
on the card (``check``), each passing on good rows and failing on one bad
field, and the ROC kernels' lane report (``lanes``) on the CPU, where the
wrappers run their plain versions. The P1 gates read the JAX package's
recorded CSVs (``results/bench_invlists_synthetic*_tpu.csv``), which hold
them too."""

import copy
import csv
import json
from pathlib import Path

import numpy as np
import pytest

from vector_db_id_compression_tpu_torch.bench import quantizer_bench, recorded

REPO = Path(__file__).resolve().parent.parent
P1_RECORDS = sorted(REPO.glob("results/bench_invlists_synthetic*_tpu.csv"))


def search_100m_rows():
    rows = []
    for m, ids_size, r1 in (("none", 16000, (0.8, 1.0)), ("packed-bits", 3400, (0.8, 1.0)),
                            ("roc", 2900, (0.8, 1.0))):
        for nprobe, recall in zip((16, 64), r1):
            rows.append(dict(method=m, nprobe=nprobe, k=20, nq=10, ntotal=2000, nlist=64,
                             t_search=0.01, t_search_min=0.009, runs=5, ids_size=ids_size,
                             bits_per_id=8.0 * ids_size / 2000, recall_1=recall))
    return rows


def test_search_100m_gates():
    record = search_100m_rows()
    assert recorded.search_100m_failures(copy.deepcopy(record), record) == []
    for field, value in (("ids_size", 2901), ("bits_per_id", 11.6004), ("nlist", 63),
                         ("k", 10), ("recall_1", 0.7)):
        rows = copy.deepcopy(record)
        rows[5][field] = value  # roc at nprobe 64
        assert recorded.search_100m_failures(rows, record), field
    # a method missing from the matrix fails the run; it is not dropped
    assert recorded.search_100m_failures(copy.deepcopy(record)[:-2], record)


@pytest.mark.parametrize("path", P1_RECORDS, ids=lambda p: p.stem)
def test_p1_gates(path):
    rows = recorded.read_csv(path)
    assert recorded.p1_failures(rows) == []
    for method, field, value in (("ref", "bits_per_id", "63.9"),
                                 ("roc", "recall_1", "0.001"),
                                 ("roc", "bits_per_id", "99.0"),
                                 ("packed-bits", "bits_per_id", "19.5"),
                                 ("packed-bits", "bits_per_id", "21.0")):
        bad = copy.deepcopy(rows)
        hits = [r for r in bad if r["method"] == method]
        if not hits:  # the long-list run holds no packed-bits
            continue
        hits[-1][field] = value
        assert recorded.p1_failures(bad), (method, field, value)


def test_codec_scale_gates(tmp_path):
    record = [{"ntotal": 30000000, "nlist": 65536, "n_max": 546, "bits_per_id": 17.6938},
              {"ntotal": 10000000, "nlist": 65536, "n_max": 207, "bits_per_id": 18.4686}]
    row = {"ntotal": 30000000, "nlist": 65536, "n_max": 546, "bits_per_id": 17.6938,
           "lanes": 65536}
    assert recorded.codec_scale_failures([row], record) == []
    for field, value in (("bits_per_id", 17.6939), ("n_max", 545), ("nlist", 4096)):
        assert recorded.codec_scale_failures([{**row, field: value}], record), field
    assert recorded.codec_scale_failures([], record)
    # rows are read from the lines of a .jsonl that start with "{"
    path = tmp_path / "c.jsonl"
    path.write_text("=== a command ===\n" + json.dumps(row) + "\n")
    assert recorded.read_jsonl(path) == [row]


def test_quantizer_gates(tmp_path):
    argv = ["--nlist", "3000", "--nq", "40", "--nprobe", "32", "--runs", "1", "--skip-hnsw",
            "--out", str(tmp_path / "q.json"), "--dump-probes", str(tmp_path / "p.npy"),
            "--device", "cpu"]
    out = quantizer_bench.main(argv)
    probes = np.load(tmp_path / "p.npy")
    assert probes.shape == (40, 32) and out == json.loads((tmp_path / "q.json").read_text())
    assert recorded.quantizer_failures(out, probes, seed=3) == []
    swapped = probes.copy()
    swapped[3, [0, 20]] = swapped[3, [20, 0]]  # far apart: no near tie
    assert recorded.quantizer_failures(out, swapped, seed=3)
    outside = probes.copy()
    outside[5, 10] = next(c for c in range(3000) if c not in set(probes[5]))
    assert recorded.quantizer_failures(out, outside, seed=3)
    assert recorded.quantizer_failures({**out, "hnsw": [{"ef": 64}]}, probes, seed=3)
    assert recorded.quantizer_failures({k: v for k, v in out.items() if k != "flat_ms"},
                                       probes, seed=3)
    assert recorded.quantizer_failures(out, probes, seed=4)  # other draws


def test_check_command(tmp_path, capsys):
    record = search_100m_rows()
    (tmp_path / "rec.json").write_text(json.dumps(record))
    (tmp_path / "out.json").write_text(json.dumps(record))
    argv = ["check", "--search-100m", str(tmp_path / "out.json"), str(tmp_path / "rec.json"),
            "--p1", str(P1_RECORDS[0])]
    assert recorded.main(argv) == 0
    assert capsys.readouterr().out.strip().endswith("all gates hold")
    record[0]["ids_size"] += 1
    (tmp_path / "out.json").write_text(json.dumps(record))
    assert recorded.main(argv) == 1
    assert "FAIL" in capsys.readouterr().out


def test_lanes_on_the_cpu(tmp_path, monkeypatch):
    """``lanes`` over search_100m's lists of 1,600 ids in 2 lists (800 each,
    past 1.5 x AUTO_CHUNK_TARGET): ROC holds a lane a list, interleaved ROC
    two; both round-trip and equal their plain versions (on the CPU the
    wrappers run the plain versions, so this checks the command's
    bookkeeping; each timed call runs once). With the shared memory cut to
    4 KiB the chain probe takes a prefix of the longest lane, as it does on
    the card for IVF128's lists of up to about 31,000 ids."""
    from vector_db_id_compression_tpu_torch.ops import _build

    monkeypatch.setattr(recorded, "_ms", lambda fn, device, reps=5: (fn(), 1.0)[1])
    monkeypatch.setattr(_build, "SHARED_BYTES_PER_BLOCK", 4096)
    assert recorded.main(["lanes", "--ntotal", "1600", "--nlist", "2", "--plain", "--device",
                          "cpu", "--out", str(tmp_path / "l.json")]) == 0
    out = json.loads((tmp_path / "l.json").read_text())
    roc, inter = out["containers"]["roc"], out["containers"]["roc-interleaved"]
    assert (roc["lanes"], inter["lanes"]) == (2, 4) and roc["ids"] == inter["ids"] == 1600
    assert roc["plain"]["encode_equal"] and roc["plain"]["decode_equal"]
    assert inter["plain"]["encode_equal"] and inter["plain"]["decode_equal"]
    assert inter["overhead_size"] == 13 * 4 and roc["longest_lane"] == out["list_len_max"]
    assert 0 < roc["chain_probe_ids"] < roc["longest_lane"]
    assert roc["chain_decode_bound_ms"] == roc["longest_lane"] * roc["chain_decode_us_step"] / 1e3
    with open(tmp_path / "p1.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["method", "bits_per_id"])
        w.writeheader()
        w.writerow({"method": "roc", "bits_per_id": roc["bits_per_id"] + 1})
    with pytest.raises(AssertionError, match="not the run's lists"):
        recorded.main(["lanes", "--ntotal", "1600", "--nlist", "2", "--device", "cpu",
                       "--csv", str(tmp_path / "p1.csv")])

"""The port's own spans and counter on the IVF search path
(``utils/profiling.py``), on the CPU at a tiny size (about 10 s in all):

- without a profiler a search records nothing and never enters
  ``record_function``;
- under ``device_trace`` a search gives the six spans with their parents,
  one sequence number a search, children inside their parents, self times
  of at least 0, and each span in the Chrome trace;
- ``host_syncs`` a search is the number of size-bucket passes plus the
  translate's fixed sites;
- the benchmark's readers of the spans and the counter
  (``idbench/metrics/``) over a traced tiny cell of ``idbench``.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from idbench import harness
from vector_db_id_compression_tpu_torch.search import ivf
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
from vector_db_id_compression_tpu_torch.store.invlists import (
    InterleavedRocInvertedLists,
    RocInvertedLists,
)
from vector_db_id_compression_tpu_torch.utils import device_trace, profiling

REPO = Path(__file__).resolve().parent.parent
PARENT = {"ivf.search": None, "ivf.positional": "ivf.search", "ivf.coarse": "ivf.positional",
          "ivf.scan": "ivf.positional", "ivf.translate": "ivf.search",
          "roc.decode": "ivf.translate"}
D, NLIST, NB, NQ, K, NPROBE = 8, 16, 600, 6, 5, 4
# the translate's sites a search: the two boolean-mask gathers and the
# scatter of _translate, then the container's (ROC: unique, the longest
# list, K1's error check; interleaved ROC: unique, repeat_interleave's two,
# the error check)
FIXED_SYNCS = {"uncompressed": 3, "roc": 6, "roc-interleaved": 7}
CONTAINERS = {
    "uncompressed": lambda il: il,
    "roc": lambda il: RocInvertedLists(il, device="cpu"),
    "roc-interleaved": lambda il: InterleavedRocInvertedLists(il, interleave=4, interleave_min=16,
                                                              device="cpu"),
}


@pytest.fixture(scope="module")
def data():
    """Clusters of skewed sizes (one centre in four takes most rows), so
    that the lists fall into more than one size bucket."""
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((NLIST, D)).astype(np.float32) * 3.0
    weight = np.where(np.arange(NLIST) % 4 == 0, 6.0, 1.0)
    owner = rng.choice(NLIST, size=NB, p=weight / weight.sum())
    xb = (cent[owner] + rng.standard_normal((NB, D))).astype(np.float32)
    xq = (cent[rng.integers(0, NLIST, NQ)] + rng.standard_normal((NQ, D))).astype(np.float32)
    return xb, xq


def _index(xb, container="roc", storage="flat"):
    index = IndexIVF(D, NLIST, storage=storage, pq_m=4 if storage == "pq" else 0, device="cpu")
    index.train(xb)
    index.add(xb)
    index.replace_invlists(CONTAINERS[container](index.invlists))
    assert len(index._scan) >= 2
    return index


def test_no_profiler_records_nothing(data, monkeypatch):
    xb, xq = data
    index = _index(xb)
    profiling.reset()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    index.search(xq, K, nprobe=NPROBE)
    profiling.count("host_syncs")
    assert profiling.records() == []
    assert profiling.summary().counts == {} and profiling.summary().spans == {}


@pytest.mark.parametrize("storage", ["flat", "pq-lut"])
def test_spans_of_a_search(data, tmp_path, monkeypatch, storage):
    xb, xq = data
    if storage == "pq-lut":
        # the LUT scan, reached at this size only by lowering the budget
        monkeypatch.setattr(ivf, "PQ_DECODE_BUDGET", 0)
    index = _index(xb, storage="flat" if storage == "flat" else "pq")
    assert index._scan_is_float == (storage == "flat")
    profiling.reset()
    with device_trace(tmp_path):
        index.search(xq, K, nprobe=NPROBE)
        index.search(xq[:1], K, nprobe=NPROBE)
    recs = profiling.records()
    assert sorted(r.name for r in recs) == sorted(list(PARENT) * 2)
    assert len({r.seq for r in recs}) == 2
    for r in recs:
        assert (r.parent.name if r.parent else None) == PARENT[r.name]
        assert r.t0_ns <= r.t1_ns and r.events is None
        if r.parent is not None:
            assert r.parent.seq == r.seq
            assert r.parent.t0_ns <= r.t0_ns and r.t1_ns <= r.parent.t1_ns
    s = profiling.summary()
    assert s.searches == 2 and set(s.spans) == set(PARENT)
    for st in s.spans.values():
        assert st.count == 2 and st.stream_ms is None and st.self_ms >= 0
        assert st.self_ms <= st.ms
    positional = s.spans["ivf.positional"]
    assert s.spans["ivf.coarse"].ms + s.spans["ivf.scan"].ms <= positional.ms
    assert s.spans["roc.decode"].ms <= s.spans["ivf.translate"].ms
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(PARENT) <= annotations


@pytest.mark.parametrize("container", sorted(FIXED_SYNCS))
def test_host_syncs_a_search(data, container):
    xb, xq = data
    index = _index(xb, container)
    profiling.reset()
    with _recording():
        index.search(xq, K, nprobe=NPROBE)
    s = profiling.summary(1)
    assert s.searches == 1
    assert s.spans["ivf.scan"].counts["host_syncs"] == len(index._scan)
    assert s.counts["host_syncs"] == len(index._scan) + FIXED_SYNCS[container]


def _recording():
    """A profiler session that records the host only and writes nothing."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


TINY = dict(n=1000, d=16, nlist=16, nprobe=4, center_std=0.5,
            limits={"dist_err": 1e-5, "rank_gap": 1e-5})
TINY_TRAFFIC = dict(pool=200, queries_per_call=10, warmup_calls=1, check_calls=2,
                    trace_warmup_calls=1, trace_calls=3)
# the window's seconds: it must hold the trace's four calls on a loaded CPU
WINDOW_S = 2.0
READERS = ("coarse_ms", "scan_ms", "decode_ms", "host_syncs")


def test_readers_over_a_traced_tiny_cell(tmp_path):
    """``harness.run`` with the trace on, over a copy of the benchmark with
    a tiny configuration, traffic mix and cell added to the new readers'
    ``workloads``: the readers read the program's records of the traced
    calls."""
    shutil.copytree(REPO / "idbench", tmp_path / "idbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "idbench/configs/sift1m-ivf1024-flat-roc.json").read_text())
    cfg.update(TINY, name="tiny")
    (tmp_path / "idbench/configs/tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "idbench/traffic/batch1000.json").read_text())
    traffic.update(TINY_TRAFFIC, name="tiny-batch")
    (tmp_path / "idbench/traffic/tiny-batch.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "tiny", "source": "test", "file": "idbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.batch", "config": "tiny", "traffic": "tiny-batch",
                               "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in {f"{r}.batch" for r in READERS}:
            m["workloads"].append("tiny.batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    profiling.reset()
    out = harness.run(harness.load_cell("tiny.batch", tmp_path), 2 ** 33 + 7, WINDOW_S, True,
                      torch.device("cpu"))
    assert out["correct"], out["check"]
    got = {name.split(".")[0]: m["value"] for name, m in out["metrics"].items()}
    s = profiling.summary(TINY_TRAFFIC["trace_calls"])
    assert s.searches == TINY_TRAFFIC["trace_calls"]
    per_search = {"coarse_ms": s.spans["ivf.coarse"].ms, "scan_ms": s.spans["ivf.scan"].ms,
                  "decode_ms": s.spans["roc.decode"].ms, "host_syncs": s.counts["host_syncs"]}
    for r in READERS:
        assert got[r] == pytest.approx(per_search[r] / s.searches) and got[r] > 0
    assert got["coarse_ms"] + got["scan_ms"] <= s.spans["ivf.positional"].ms / s.searches

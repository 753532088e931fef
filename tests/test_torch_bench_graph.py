"""The port's graph experiment drivers against the JAX package's: P2
(``graph_dynamic_bench``), P3 (``graph_static_bench``), P4
(``generate_graph_edgelists``) and ``hnsw_bench``.

The NSG and HNSW builds of the port equal the JAX package's
(tests/test_torch_graph.py, tests/test_torch_hnsw.py), so the drivers are
compared directly, on the JAX package's own fixture
(tests/test_bench_drivers.py:24): the same edges, bits per edge and recall,
and ``.el`` files equal byte for byte. Every port driver runs with
``--device cpu``.
"""

import csv

import numpy as np
import pytest

from vector_db_id_compression_tpu.bench import datasets as jax_datasets
from vector_db_id_compression_tpu.bench import generate_graph_edgelists as jax_el
from vector_db_id_compression_tpu.bench import graph_dynamic_bench as jax_dynamic
from vector_db_id_compression_tpu.bench import graph_static_bench as jax_static
from vector_db_id_compression_tpu.bench import hnsw_bench as jax_hnsw
from vector_db_id_compression_tpu_torch.bench import (datasets, generate_graph_edgelists,
                                                      graph_dynamic_bench, graph_static_bench,
                                                      hnsw_bench)

TINY = (8, 500, 1500, 30)


@pytest.fixture(scope="module")
def tiny():
    return datasets.SyntheticDataset(*TINY, device="cpu"), jax_datasets.SyntheticDataset(*TINY)


def header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_graph_dynamic_bench_equals_jax(tiny, tmp_path):
    ds, ds_j = tiny
    rows = graph_dynamic_bench.run_bench(ds, 8, runs=1, k=5, out_csv=str(tmp_path / "p.csv"),
                                         device="cpu")
    ref = jax_dynamic.run_bench(ds_j, 8, runs=1, k=5, out_csv=str(tmp_path / "j.csv"))
    assert header(tmp_path / "p.csv") == header(tmp_path / "j.csv")
    assert [r["method"] for r in rows] == [r["method"] for r in ref] == graph_dynamic_bench.METHODS
    for r, rj in zip(rows, ref):
        for key in ("max_degree", "k", "nq", "ids_size", "overhead_size", "bits_per_edge",
                    "recall_1", "dataset", "runs"):
            assert r[key] == rj[key], (r["method"], key)
        assert r["dt_search"] > 0 and r["dt_search_sustained"] > 0
    assert len({r["recall_1"] for r in rows}) == 1  # lossless adjacency


def test_graph_dynamic_bench_host_search(tiny, tmp_path):
    """``--host-search`` walks with the host loop: the same recall, no
    sustained time."""
    ds, _ = tiny
    device = graph_dynamic_bench.run_bench(ds, 8, runs=1, k=5, methods=["ref", "roc"],
                                           out_csv=str(tmp_path / "d.csv"), device="cpu")
    host = graph_dynamic_bench.run_bench(ds, 8, runs=1, k=5, methods=["ref", "roc"],
                                         out_csv=str(tmp_path / "h.csv"), host_search=True,
                                         device="cpu")
    assert [r["recall_1"] for r in host] == [r["recall_1"] for r in device]
    assert all(np.isnan(r["dt_search_sustained"]) for r in host)


def test_graph_static_bench_equals_jax(tiny, tmp_path):
    ds, ds_j = tiny
    rows = graph_static_bench.run_bench(ds, 8, out_csv=str(tmp_path / "p.csv"), device="cpu")
    ref = jax_static.run_bench(ds_j, 8, out_csv=str(tmp_path / "j.csv"))
    assert header(tmp_path / "p.csv") == header(tmp_path / "j.csv")
    assert len(rows) == len(ref) == 8
    for r, rj in zip(rows, ref):
        for key in ("index_str", "comp_method", "dataset", "nb", "nt", "num_edges"):
            assert r[key] == rj[key], key
        # REC's float64 log-gamma sums in another order (tests/test_torch_rec.py)
        assert r["bpe"] == pytest.approx(rj["bpe"], rel=1e-12), (r["index_str"], r["comp_method"])


def test_generate_graph_edgelists_byte_equal(tiny, tmp_path):
    ds, ds_j = tiny
    generate_graph_edgelists.run(ds, 8, str(tmp_path / "p"), device="cpu")
    jax_el.run(ds_j, 8, str(tmp_path / "j"))
    names = sorted(p.name for p in (tmp_path / "p").glob("*.el"))
    assert names == sorted(p.name for p in (tmp_path / "j").glob("*.el")) == [
        "SyntheticDataset_HNSW8_Flat.el", "SyntheticDataset_NSG8_Flat.el"]
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_generate_graph_edgelists_main(tmp_path):
    generate_graph_edgelists.main(["--synth_scale", "0.01", "--max-degree", "6",
                                   "--outdir", str(tmp_path), "--device", "cpu"])
    files = sorted(tmp_path.glob("*.el"))
    assert len(files) == 2
    u, v = files[0].read_text().splitlines()[0].split()
    assert u.isdigit() and v.isdigit()


def test_hnsw_bench_equals_jax(tiny, tmp_path):
    ds, ds_j = tiny
    rows = hnsw_bench.run_bench(ds, M=8, runs=1, k=5, ef=24, out_csv=str(tmp_path / "p.csv"),
                                device="cpu")
    ref = jax_hnsw.run_bench(ds_j, M=8, runs=1, k=5, ef=24, out_csv=str(tmp_path / "j.csv"))
    assert header(tmp_path / "p.csv") == header(tmp_path / "j.csv")
    assert [r["method"] for r in rows] == [r["method"] for r in ref] == hnsw_bench.METHODS
    for r, rj in zip(rows, ref):
        for key in ("M", "ef", "k", "nq", "nb", "ids_size", "overhead_size", "bits_per_edge",
                    "recall_1", "dataset", "runs"):
            assert r[key] == rj[key], (r["method"], key)
    assert len({r["recall_1"] for r in rows}) == 1

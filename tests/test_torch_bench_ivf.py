"""The port's IVF experiment drivers against the JAX package's: P1
(``bench_invlists``), P5 (``search_ivf_qinco``), ``search_100m``,
``quantizer_bench`` and ``scaling``.

k-means draws other numbers in the two packages (port ``search/kmeans.py``),
so the columns that depend on the index are compared on the same index: the
JAX driver's index is saved with its ``save_index`` and carried into the port
driver through ``load_index`` (``build_index`` patched), and P5 resumes from
the other package's ``qinco_index.npz``. Every port driver runs with
``--device cpu``; the ranks of ``scaling`` are subprocesses that import no
jax.
"""

import csv
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.bench import bench_invlists as jax_bench
from vector_db_id_compression_tpu.bench import datasets as jax_datasets
from vector_db_id_compression_tpu.bench import quantizer_bench as jax_quantizer
from vector_db_id_compression_tpu.bench import scaling as jax_scaling
from vector_db_id_compression_tpu.bench import search_100m as jax_100m
from vector_db_id_compression_tpu.bench import search_ivf_qinco as jax_qinco
from vector_db_id_compression_tpu.search.ivf import load_index as jax_load_index
from vector_db_id_compression_tpu.search.ivf import save_index as jax_save_index
from vector_db_id_compression_tpu_torch.bench import (bench_invlists, datasets, quantizer_bench,
                                                      scaling, search_100m, search_ivf_qinco)
from vector_db_id_compression_tpu_torch.search.ivf import load_index
from test_torch_ivf import assert_same_results

REPO = Path(__file__).resolve().parent.parent
TINY = (8, 500, 1500, 30)  # the JAX package's fixture, tests/test_bench_drivers.py:24


def read_csv(path):
    with open(path) as f:
        r = csv.DictReader(f)
        return r.fieldnames, list(r)


def _p1_on_the_same_index(tmp_path, monkeypatch, index_str, nprobes, **kw):
    """P1 through both drivers on one index the JAX package built → (port
    rows, JAX rows as read back from the CSVs, the port's index)."""
    ds_j = jax_datasets.SyntheticDataset(*TINY)
    ds = datasets.SyntheticDataset(*TINY, device="cpu")
    jidx = jax_bench.build_index(ds_j, index_str)
    jax_save_index(tmp_path / "index.npz", jidx)
    monkeypatch.setattr(jax_bench, "build_index", lambda *a, **kw: jidx)
    monkeypatch.setattr(bench_invlists, "build_index",
                        lambda *a, **kw: load_index(tmp_path / "index.npz", device="cpu"))
    ours = bench_invlists.run_bench(ds, index_str, runs=1, nprobes=nprobes,
                                    out_csv=str(tmp_path / "port.csv"), device="cpu", **kw)
    ref = jax_bench.run_bench(ds_j, index_str, runs=1, nprobes=nprobes,
                              out_csv=str(tmp_path / "jax.csv"), **kw)
    cols, rows = read_csv(tmp_path / "port.csv")
    cols_j, rows_j = read_csv(tmp_path / "jax.csv")
    assert cols == cols_j and len(rows) == len(rows_j) == len(ours) == len(ref)
    for r, rj in zip(rows, rows_j):
        for key in ("method", "nprobe", "k", "nq", "ids_size", "overhead_size", "bits_per_id",
                    "recall_1", "dataset", "index", "runs"):
            assert r[key] == rj[key], (r["method"], r["nprobe"], key)
    # ids are lossless: one recall per nprobe
    assert len({(r["nprobe"], r["recall_1"]) for r in rows}) == len(nprobes)
    return rows, load_index(tmp_path / "index.npz", device="cpu")


@pytest.mark.parametrize("index_str", ["IVF8,Flat", "IVF8,PQ4"])
def test_bench_invlists_equals_jax_on_the_same_index(tmp_path, monkeypatch, index_str):
    rows, _ = _p1_on_the_same_index(tmp_path, monkeypatch, index_str, (1, 4))
    assert len(rows) == 12


def test_bench_invlists_chunked_lists_equal_jax(tmp_path, monkeypatch):
    """P1 over one list of TINY's 1,500 ids (IVF1,Flat), past 1.5 x
    ``AUTO_CHUNK_TARGET``: ``roc-interleaved`` codes it as several lanes
    (the long-list run, IVF128 over 10^6, at a size the CPU holds), and its
    sizes and recall equal the JAX driver's."""
    from vector_db_id_compression_tpu_torch.store.invlists import (AUTO_CHUNK_TARGET,
                                                                   InterleavedRocInvertedLists)

    rows, index = _p1_on_the_same_index(tmp_path, monkeypatch, "IVF1,Flat", (1,),
                                        methods=["ref", "roc", "roc-interleaved"])
    assert [r["method"] for r in rows] == ["ref", "roc", "roc-interleaved"]
    (n,) = index.invlists.lengths
    assert n == TINY[2] > 3 * AUTO_CHUNK_TARGET // 2
    lanes = InterleavedRocInvertedLists(index.invlists, device="cpu").n_lanes
    assert lanes.tolist() == [-(-n // AUTO_CHUNK_TARGET)] and lanes[0] >= 2


def test_bench_invlists_fused_columns(tmp_path):
    """``--fused`` adds the sharded search's one-shot and sustained times
    (a mesh of one without a group)."""
    rows = bench_invlists.main(["--synth_scale", "0.02", "--index", "IVF8,Flat", "--runs", "1",
                                "--nprobe", "2", "--methods", "ref", "roc", "--fused",
                                "--out", str(tmp_path / "f.csv"), "--device", "cpu"])
    cols, _ = read_csv(tmp_path / "f.csv")
    assert cols[-2:] == ["dt_fused", "dt_fused_sustained"]
    assert all(r["dt_fused"] > 0 and r["dt_fused_sustained"] > 0 for r in rows)
    assert rows[0]["recall_1"] == rows[1]["recall_1"]


QINCO_ARGS = ["--dataset", "synthetic", "--synth_scale", "0.02", "--nlist", "16", "--M", "4",
              "--ksub", "32", "--hidden", "32", "--qinco_steps", "60", "--runs", "1"]
QINCO_SEARCH = ["--id_compression", "roc", "--defer_id_decoding", "--nprobe", "4",
                "--nshort", "20", "--k", "10"]


def _shortlists(path_p, path_j, xq):
    """The port's and the JAX package's searches of their indexes (D, I,
    codes, as numpy), and the re-rank of the JAX shortlist by the port's
    ``rerank`` and by the JAX driver's numpy lines
    (bench/search_ivf_qinco.py:150-168) → (port shortlist, JAX shortlist,
    port re-rank, JAX re-rank)."""
    index = load_index(path_p, device="cpu")
    jindex = jax_load_index(path_j)
    xq_t = torch.from_numpy(xq)
    port = tuple(t.numpy() for t in index.search_defer_id_decoding(
        xq_t, 20, nprobe=4, return_codes=2))
    jax = tuple(np.asarray(t) for t in jindex.search_defer_id_decoding(
        xq, 20, nprobe=4, return_codes=2))
    _, I, codes = jax
    rr_port = tuple(t.numpy() for t in search_ivf_qinco.rerank(
        index, xq_t, torch.from_numpy(I), torch.from_numpy(codes), 10))
    pfx, M = jindex.coarse_code_size, jindex.qinco.M
    flat = codes.reshape(-1, codes.shape[-1])
    listnos = np.zeros(len(flat), dtype=np.int64)
    for b in range(pfx):
        listnos |= flat[:, b].astype(np.int64) << (8 * b)
    listnos = np.clip(listnos, 0, jindex.nlist - 1)
    dec = (np.asarray(jindex.qinco.decode(flat[:, pfx:pfx + M].astype(np.int32)))
           + np.asarray(jindex.centroids)[listnos]).reshape(len(xq), 20, -1)
    d2 = np.where(I >= 0, ((dec - xq[:, None, :]) ** 2).sum(axis=2), np.inf)
    order = np.argsort(d2, axis=1)[:, :10]
    rr_jax = np.take_along_axis(d2, order, axis=1), np.take_along_axis(I, order, axis=1)
    return port, jax, rr_port, rr_jax


def test_search_ivf_qinco_resumes_across_packages(tmp_path):
    """A workdir the JAX package trained resumes in the port (add, search)
    and one the port trained resumes in the JAX package: each package's add
    of the same trained index writes the same lists and codes; the two
    searches give the same shortlist, and the two re-ranks of one shortlist
    the same ids, under the near-tie rule. At this size many entries share
    their codes (M 4, ksub 32) and tie exactly, in the shortlist's cut and
    in the re-rank, where the port keeps the shortlist's order and the JAX
    driver's np.argsort does not: the drivers' recalls may differ there, at
    exact ties only."""
    xq = jax_datasets.get_dataset("synthetic", synth_scale=0.02).get_queries()
    out = {}
    for trainer in ("jax", "port"):
        train = tmp_path / trainer / "train"
        if trainer == "jax":
            jax_qinco.main([*QINCO_ARGS, "--workdir", str(train), "--todo", "train"])
        else:
            search_ivf_qinco.main([*QINCO_ARGS, "--workdir", str(train), "--todo", "train",
                                   "--device", "cpu"])
        for runner in ("jax", "port"):
            work = tmp_path / trainer / runner
            work.mkdir()
            shutil.copy(train / "qinco_index.npz", work / "qinco_index.npz")
            argv = [*QINCO_ARGS, *QINCO_SEARCH, "--workdir", str(work), "--todo", "add", "search"]
            if runner == "jax":
                jax_qinco.main(argv)
                res = json.loads((work / "search_results.json").read_text())
            else:
                res = search_ivf_qinco.main([*argv, "--device", "cpu"])
                assert res == json.loads((work / "search_results.json").read_text())
            out[trainer, runner] = res, work / "qinco_index.npz"
    for trainer in ("jax", "port"):
        (res_j, path_j), (res_p, path_p) = out[trainer, "jax"], out[trainer, "port"]
        with np.load(path_j) as a, np.load(path_p) as b:
            for key in ("lengths", "ids_flat", "codes_flat", "centroids"):
                assert np.array_equal(a[key], b[key]), (trainer, key)
        for key in ("ids_size", "ntotal", "bits_per_id"):
            assert res_p[key] == res_j[key], (trainer, key)
        assert set(res_p["sweep"][0]["recalls"]) == set(res_j["sweep"][0]["recalls"])
        assert set(res_p["args"]) - set(res_j["args"]) == {"device"}
        port, jax, rr_port, rr_jax = _shortlists(path_p, path_j, xq)
        assert_same_results(*port[:2], *jax[:2])
        assert_same_results(*rr_port, *rr_jax)


def test_search_ivf_qinco_operating_points_and_resume_error(tmp_path):
    work = tmp_path / "q"
    with pytest.raises(FileNotFoundError, match="qinco_index"):
        search_ivf_qinco.main([*QINCO_ARGS, "--workdir", str(work), "--todo", "search",
                               "--device", "cpu"])
    res = search_ivf_qinco.main([*QINCO_ARGS, "--workdir", str(work), "--device", "cpu",
                                 "--todo", "train", "add", "search", "--nprobe", "1", "2", "4",
                                 "--nshort", "10", "20", "--n_autotune", "4", "--k", "10"])
    assert len(res["sweep"]) == 4
    run = [s for s in res["sweep"] if not s["skipped"]]
    assert run and all(s["t_search"] > 0 and s["runs"] == 1 for s in run)
    op = search_ivf_qinco.OperatingPoints(["nprobe", "nshort"])
    ref = jax_qinco.OperatingPoints(["nprobe", "nshort"])
    for p, perf, t in (({"nprobe": 2, "nshort": 10}, 0.5, 1.0),
                       ({"nprobe": 4, "nshort": 20}, 0.7, 2.0)):
        op.add_operating_point(p, perf, t)
        ref.add_operating_point(p, perf, t)
    for p in ({"nprobe": 1, "nshort": 10}, {"nprobe": 4, "nshort": 10},
              {"nprobe": 8, "nshort": 40}):
        assert op.predict_bounds(p) == ref.predict_bounds(p)
        assert op.is_pareto_optimal(*op.predict_bounds(p)) == \
            ref.is_pareto_optimal(*ref.predict_bounds(p))


def test_search_100m_tiny_equals_jax(tmp_path, monkeypatch, capsys):
    # the JAX driver sets the variable with setdefault; restored after the test
    monkeypatch.setenv("VDBIDC_PQ_DECODE_SCAN", "0")
    argv = ["--ntotal", "20000", "--nlist", "64", "--nq", "50", "--M", "8", "--runs", "1",
            "--methods", *search_100m.METHODS]
    from vector_db_id_compression_tpu_torch.search import ivf

    budget = ivf.PQ_DECODE_BUDGET
    rows = search_100m.main([*argv, "--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert ivf.PQ_DECODE_BUDGET == budget  # restored
    assert rows == json.loads((tmp_path / "port.json").read_text())
    jax_100m.main([*argv, "--out", str(tmp_path / "jax.json")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert [list(r) for r in rows] == [list(r) for r in ref]
    assert [r["method"] for r in rows[::2]] == search_100m.METHODS  # all seven
    by = {}
    for r, rj in zip(rows, ref):
        # the id lists are the generator's in both: equal sizes
        for key in ("method", "nprobe", "k", "nq", "ntotal", "nlist", "ids_size",
                    "bits_per_id"):
            assert r[key] == rj[key], key
        by.setdefault(r["nprobe"], set()).add(r["recall_1"])
    assert all(len(v) == 1 for v in by.values())  # lossless ids
    cent, assignment, xb, xq = search_100m.build_clustered(2000, 16, 8, 10, 3)
    for a, b in zip((cent, assignment, xb, xq), jax_100m.build_clustered(2000, 16, 8, 10, 3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_quantizer_bench_tiny_equals_jax(tmp_path):
    argv = ["--nlist", "300", "--nq", "40", "--runs", "1", "--ef", "32", "64"]
    ours = quantizer_bench.main([*argv, "--out", str(tmp_path / "p.json"), "--device", "cpu"])
    jax_quantizer.main([*argv, "--out", str(tmp_path / "j.json")])
    ref = json.loads((tmp_path / "j.json").read_text())
    assert ours == json.loads((tmp_path / "p.json").read_text())
    assert list(ours) == list(ref) and len(ours["hnsw"]) == len(ref["hnsw"]) == 2
    for key in ("nlist", "d", "nq", "nprobe", "hnsw_M"):
        assert ours[key] == ref[key]
    for h, hj in zip(ours["hnsw"], ref["hnsw"]):
        # the same graph (the HNSW build equals JAX's); a probe may differ at
        # a near tie of the two packages' distance sums
        assert h["ef"] == hj["ef"]
        assert abs(h["probe_overlap"] - hj["probe_overlap"]) <= 0.01
        assert abs(h["top1_agree"] - hj["top1_agree"]) <= 1 / 40
    flat = quantizer_bench.main([*argv, "--skip-hnsw", "--out", str(tmp_path / "f.json"),
                                 "--device", "cpu"])
    assert flat["hnsw"] == [] and flat["hnsw_build_s"] is None


def test_scaling_one_rank_bit_equal_to_jax():
    """The in-process run (one process, no group: the mesh of one) encodes
    the JAX package's lists to the JAX package's streams on its 1-device
    mesh."""
    rows = scaling.run(16, 40, 7, 1, [1, 2, 4], device="cpu")
    ref = jax_scaling.run(16, 40, 7, 1, [1])
    assert len(rows) == 1 and list(rows[0]) == list(ref[0])
    for key in ("n_devices", "n_lists", "ntotal", "eff_vs", "encode_eff", "decode_eff"):
        assert rows[0][key] == ref[0][key]
    ids, lengths, prec, ntotal = scaling.make_lists(16, 40, 7)
    ids_j, lengths_j, prec_j, ntotal_j = jax_scaling.make_lists(16, 40, 7)
    assert np.array_equal(ids, ids_j) and np.array_equal(lengths, lengths_j)
    assert np.array_equal(prec, prec_j) and ntotal == ntotal_j

    import jax.numpy as jnp

    from vector_db_id_compression_tpu.codecs import roc_device as jrd
    from vector_db_id_compression_tpu.parallel import mesh as jmesh
    from vector_db_id_compression_tpu_torch.parallel.mesh import (make_lists_mesh,
                                                                  sharded_roc_encode)

    cap = jrd.stack_capacity(int(lengths.max()), int(prec.max()))
    st, order = sharded_roc_encode(make_lists_mesh(1, device="cpu"),
                                   torch.from_numpy(ids.view(np.int64)),
                                   torch.from_numpy(lengths), torch.from_numpy(prec), cap)
    st_j, _ = jmesh.sharded_roc_encode(jmesh.make_lists_mesh(1), jnp.asarray(ids),
                                       jnp.asarray(lengths), jnp.asarray(prec), cap)
    assert np.array_equal(st.head.numpy().view(np.uint64), np.asarray(st_j.head))
    assert np.array_equal(st.stack_len.numpy(), np.asarray(st_j.stack_len))
    assert np.array_equal(st.stack.numpy().view(np.uint32), np.asarray(st_j.stack))


def test_scaling_search_one_rank(capsys):
    out = scaling.main(["--devices", "1", "--search", "--phases", "--lists-per-device", "8",
                        "--ids-per-list", "20", "--runs", "1", "--device", "cpu"])
    assert out == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (row,) = out["rows"]
    assert set(row["phase_s"]) == {"coarse", "scan", "merge", "translate"}
    assert row["phase_cum_s"]["full"] > 0 and out["mode"] == "weak_scaling_search"


def test_scaling_phases_are_stage_times(monkeypatch):
    """Each stage is timed alone, so none is negative, and the cumulative
    times are the stages' running sums. Differences of cumulative minima (the
    JAX driver's way) went negative on the card (the merge -0.0008 s); here a
    coarse stage that gets faster call by call, as a card's clocks and caches
    warm up, would make them negative every time."""
    from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF

    real_coarse, calls = ShardedIVF._coarse, [0]

    def coarse(self, xq, nprobe):
        calls[0] += 1
        time.sleep(max(0.0, 0.1 - 0.005 * calls[0]))
        return real_coarse(self, xq, nprobe)

    monkeypatch.setattr(ShardedIVF, "_coarse", coarse)
    rows = scaling.run_search(16, 30, 8, 32, 10, 4, 7, 3, [1], phases=True, device="cpu")
    for row in rows:
        stages, cum = row["phase_s"], row["phase_cum_s"]
        assert all(isinstance(v, float) and v >= 0 for v in stages.values()), stages
        assert set(cum) == {"coarse", "scan", "merge", "full"} and cum["full"] > 0
        running = np.cumsum([stages[s] for s in ("coarse", "scan", "merge")])
        np.testing.assert_allclose([cum[s] for s in ("coarse", "scan", "merge")], running,
                                   atol=2e-4)


def test_scaling_codec_tensors_on_the_rank_device(monkeypatch):
    """``run`` hands the sharded encode and decode tensors that already lie on
    the rank's device, so the timed calls copy no ids from the host. The
    rank's device is made the meta device here, which no CPU tensor is on;
    the encode runs on CPU copies of the same lists."""
    from vector_db_id_compression_tpu_torch.parallel import mesh as mesh_mod

    meta, cpu = torch.device("meta"), torch.device("cpu")
    real_encode = mesh_mod.sharded_roc_encode
    seen = []

    def encode(mesh, ids, lengths, prec, cap):
        seen.append(("encode", mesh.device, ids.device, lengths.device, prec.device))
        ids_h, len_h, prec_h, _ = scaling.make_lists(ids.shape[0], 40, 7)
        return real_encode(mesh_mod.ListsMesh(0, 1, cpu), torch.from_numpy(ids_h.view(np.int64)),
                           torch.from_numpy(len_h), torch.from_numpy(prec_h), cap)

    def decode(mesh, states, lengths, prec, n_max):
        seen.append(("decode", mesh.device, lengths.device, prec.device))
        time.sleep(0.001)  # a time the driver can divide by

    monkeypatch.setattr(scaling, "rank_device", lambda device: meta)
    monkeypatch.setattr(mesh_mod, "sharded_roc_encode", encode)
    monkeypatch.setattr(mesh_mod, "sharded_roc_decode", decode)
    (row,) = scaling.run(16, 40, 7, 2, [1], device="cpu")
    assert {s[0] for s in seen} == {"encode", "decode"} and len(seen) >= 4
    assert all(d == meta for s in seen for d in s[1:]), seen
    assert row["ntotal"] == scaling.make_lists(16, 40, 7)[3]


def test_scaling_search_takes_given_sizes_as_given(capsys):
    """Sizes given with --search are taken as given (the JAX package clamps
    them to 64 lists and 200 ids); left out, they are its 64 and 200."""
    out = scaling.main(["--devices", "1", "--search", "--lists-per-device", "66",
                        "--ids-per-list", "201", "--search-nq", "8", "--runs", "1",
                        "--device", "cpu"])
    (row,) = out["rows"]
    assert (row["nlist"], row["ntotal"]) == (66, 66 * 201)
    out = scaling.main(["--devices", "1", "--search", "--search-d", "4", "--search-nq", "8",
                        "--runs", "1", "--device", "cpu"])
    assert (out["rows"][0]["nlist"], out["rows"][0]["ntotal"]) == (64, 64 * 200)
    capsys.readouterr()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(args, world: int) -> list:
    """The driver run as ``world`` gloo ranks (subprocesses) → their stdouts."""
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vector_db_id_compression_tpu_torch.bench.scaling", *args],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [o for o, _ in outs]


def test_scaling_sub_group_of_three_ranks():
    """Three ranks, meshes of 1 and 2: the mesh of 2 is a sub-group of the
    world and rank 2 waits outside both; the invariance assert holds."""
    outs = _ranks(["--devices", "1", "2", "--lists-per-device", "8", "--ids-per-list", "30",
                   "--runs", "1", "--device", "cpu"], 3)
    out = json.loads(outs[0].strip().splitlines()[-1])
    assert out["ranks"] == 3 and [r["n_devices"] for r in out["rows"]] == [1, 2]
    assert [r["n_lists"] for r in out["rows"]] == [8, 16]
    assert outs[1].strip() == outs[2].strip() == ""


@pytest.mark.parametrize("mode", [[], ["--search", "--phases"]])
def test_scaling_two_gloo_ranks_equal_one(mode):
    """Two ranks (subprocesses, gloo on the CPU): meshes of 1 and 2, the
    driver's invariance asserts (shard 0's streams, the 2-rank search
    against a 1-rank mesh over the same database) hold, and the mesh of one
    equals the in-process run."""
    args = ["--devices", "1", "2", "--lists-per-device", "8", "--ids-per-list", "30",
            "--runs", "1", *mode, "--device", "cpu"]
    outs = _ranks(args, 2)
    out = json.loads(outs[0].strip().splitlines()[-1])
    assert outs[1].strip() == ""  # rank 0 prints
    assert out["ranks"] == 2 and [r["n_devices"] for r in out["rows"]] == [1, 2]
    if mode:
        one = scaling.run_search(8, 30, 16, 64, 10, 8, 7, 1, [1], device="cpu")
        assert out["rows"][0]["ntotal"] == one[0]["ntotal"]
    else:
        one = scaling.run(8, 30, 7, 1, [1], device="cpu")
        assert out["rows"][0]["ntotal"] == one[0]["ntotal"]
        assert out["rows"][1]["n_lists"] == 16

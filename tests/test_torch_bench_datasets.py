"""The port's experiment drivers against the JAX package's: the datasets, the
codec-scale driver and the wavelet-tree translate driver.

Every port driver runs with ``--device cpu`` (``device="cpu"``). The
synthetic arrays, the codec workload and its lanes are numpy on both sides
and must be bit-equal; the ground truth is computed by the port with torch
and by the JAX package with XLA, which sum in another order, so it is held
to the near-tie rule: where the ids differ, their distances recomputed in
float64 agree within 1e-5 relative.
"""

import json

import numpy as np
import pytest

from vector_db_id_compression_tpu.bench import codec_scale as jax_codec_scale
from vector_db_id_compression_tpu.bench import datasets as jax_datasets
from vector_db_id_compression_tpu.bench import wt_translate_bench as jax_wt
from vector_db_id_compression_tpu_torch.bench import codec_scale, datasets
from vector_db_id_compression_tpu_torch.bench import wt_translate_bench

TINY = (8, 500, 1500, 30)  # the JAX package's fixture, tests/test_bench_drivers.py:24


def write_fvecs(path, x):
    x = np.asarray(x, np.float32)
    rec = np.empty((x.shape[0], x.shape[1] + 1), np.int32)
    rec[:, 0] = x.shape[1]
    rec[:, 1:] = x.view(np.int32)
    rec.tofile(path)


def write_ivecs(path, x):
    x = np.asarray(x, np.int32)
    rec = np.empty((x.shape[0], x.shape[1] + 1), np.int32)
    rec[:, 0] = x.shape[1]
    rec[:, 1:] = x
    rec.tofile(path)


def assert_knn_near_ties(xq, xb, got, want, rtol=1e-5):
    """Equal ids, or ids whose float64 distances agree within ``rtol``."""
    xq, xb = xq.astype(np.float64), xb.astype(np.float64)

    def d64(ids):
        return ((xb[ids] - xq[:, None, :]) ** 2).sum(axis=2)

    assert got.shape == want.shape
    differ = got != want
    np.testing.assert_allclose(d64(got)[differ], d64(want)[differ], rtol=rtol)


@pytest.mark.parametrize("args", [TINY, (32, 500, 1000, 50, 7), (5, 10, 20, 3, 99, 4)])
def test_synthetic_arrays_bit_equal(args):
    ours = datasets.SyntheticDataset(*args, device="cpu")
    ref = jax_datasets.SyntheticDataset(*args)
    for get in ("get_train", "get_database", "get_queries"):
        a, b = getattr(ours, get)(), getattr(ref, get)()
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), get
    assert str(ours) == str(ref)


def test_draw_is_the_mixture_chip_smoke_drew():
    """``draw`` is the formula chip_smoke.py used for its own copy of the
    mixture before it took this module (centres of ``seed``, a draw of
    ``draw_seed``), so its arrays, hashed in chip_smoke.py, stay the earlier
    runs'."""
    d, seed = 16, 7
    ds = datasets.SyntheticDataset(d, 5, 5, 5, seed=seed, device="cpu")
    cent = np.random.default_rng(seed).standard_normal((32, d)).astype(np.float32) * 4.0
    for n, draw_seed in ((300, seed + 4), (40, seed + 1)):
        r = np.random.default_rng(draw_seed)
        want = (cent[r.integers(0, 32, n)] + r.standard_normal((n, d))).astype(np.float32)
        assert np.array_equal(ds.draw(n, draw_seed), want)
    assert np.array_equal(ds.draw(5, seed + 1), ds.get_train())


@pytest.mark.parametrize("scale", [0.02, 0.5, 1.0, 3.0])
def test_get_dataset_table_and_scale(scale):
    ours = datasets.get_dataset("synthetic", synth_scale=scale, device="cpu")
    ref = jax_datasets.get_dataset("synthetic", synth_scale=scale)
    assert (ours.d, ours.nt, ours.nb, ours.nq) == (ref.d, ref.nt, ref.nb, ref.nq)
    assert np.array_equal(ours.get_queries(), ref.get_queries())
    assert type(datasets.get_dataset(0, device="cpu")).__name__ == "SyntheticDataset"
    with pytest.raises(ValueError):
        datasets.get_dataset("nope", device="cpu")


def test_knn_l2_equals_jax_under_near_ties():
    ds = datasets.SyntheticDataset(*TINY, device="cpu")
    ref = jax_datasets.SyntheticDataset(*TINY)
    got, want = ds.get_groundtruth(10), ref.get_groundtruth(10)
    assert_knn_near_ties(ds.get_queries(), ds.get_database(), got, np.asarray(want))
    # the JAX package's own check: the first neighbour is the nearest
    d_all = ((ds.get_database() - ds.get_queries()[0]) ** 2).sum(1)
    assert d_all[got[0, 0]] == d_all.min()


@pytest.mark.parametrize("block,budget", [(7, 7 * 100), (4096, 2 ** 28), (16, 16 * 9)])
def test_knn_l2_double_blocking(block, budget):
    """Query blocks and database slabs (slabs of budget // block rows, the
    k best of each merged) give the unblocked answer."""
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((700, 6)).astype(np.float32)
    xq = rng.standard_normal((45, 6)).astype(np.float32)
    got = datasets.knn_l2(xq, xb, 5, block=block, budget=budget, device="cpu")
    want = np.asarray(jax_datasets.knn_l2(xq, xb, 5))
    assert got.dtype == np.int64 and got.shape == (45, 5)
    assert_knn_near_ties(xq, xb, got, want)


def test_file_readers_and_adapters(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    xt = rng.standard_normal((200, 8)).astype(np.float32)
    xb = rng.standard_normal((400, 8)).astype(np.float32)
    xq = rng.standard_normal((20, 8)).astype(np.float32)
    gt = rng.integers(0, 400, (20, 10)).astype(np.int32)
    for name in ("sift", "deep"):
        write_fvecs(tmp_path / f"{name}_learn.fvecs", xt)
        write_fvecs(tmp_path / f"{name}_base.fvecs", xb)
        write_fvecs(tmp_path / f"{name}_query.fvecs", xq)
        write_ivecs(tmp_path / f"{name}_groundtruth.ivecs", gt)
    assert np.array_equal(datasets.read_fvecs(tmp_path / "sift_base.fvecs"), xb)
    assert np.array_equal(datasets.read_ivecs(tmp_path / "sift_groundtruth.ivecs"), gt)
    # bvecs: 4-byte dimension, then d bytes per record
    xb8 = rng.integers(0, 256, (30, 8)).astype(np.uint8)
    rec = np.empty((30, 12), np.uint8)
    rec[:, :4] = np.frombuffer(np.int32(8).tobytes(), np.uint8)
    rec[:, 4:] = xb8
    rec.tofile(tmp_path / "x.bvecs")
    for limit in (None, 7):
        got = datasets.read_bvecs(tmp_path / "x.bvecs", limit)
        assert np.array_equal(got, jax_datasets.read_bvecs(tmp_path / "x.bvecs", limit))
        assert got.dtype == np.float32 and len(got) == (limit or 30)

    ds = datasets.DatasetSIFT1M(root=str(tmp_path))
    assert (ds.nb, ds.d, ds.nq, ds.nt) == (400, 8, 20, 200)
    assert np.array_equal(ds.get_groundtruth(5), gt[:, :5])
    monkeypatch.setenv("DEEP1M_DIR", str(tmp_path))
    deep = datasets.get_dataset("deep1m", device="cpu")
    assert isinstance(deep, datasets.DatasetDeep1M) and np.array_equal(deep.get_train(), xt)
    np.save(tmp_path / "database1M.npy", xb)
    np.save(tmp_path / "queries.npy", xq)
    np.save(tmp_path / "ground_truth1M.npy", gt)
    fb = datasets.get_dataset(3, fb_ssnpp_dir=str(tmp_path), device="cpu")
    ref = jax_datasets.get_dataset(3, fb_ssnpp_dir=str(tmp_path))
    assert (fb.nb, fb.d, fb.nq, fb.nt) == (ref.nb, ref.d, ref.nq, ref.nt)
    assert np.array_equal(fb.get_train(), ref.get_train())
    assert np.array_equal(fb.get_groundtruth(3), ref.get_groundtruth(3))


@pytest.mark.parametrize("make", [
    lambda p: datasets.DatasetSIFT1M(root=str(p / "nope")),
    lambda p: datasets.DatasetDeep1M(root=str(p / "nope")),
    lambda p: datasets.DatasetFBSsnpp(basedir=str(p / "nope")),
])
def test_missing_files_raise(tmp_path, make):
    with pytest.raises(FileNotFoundError):
        make(tmp_path)


@pytest.mark.parametrize("ntotal,nlist,mode,chunk", [
    (3000, 16, "auto", 512), (3000, 4, "auto", 128), (3000, 4, "off", 128), (20000, 7, "auto", 300),
])
def test_codec_workload_and_lanes_bit_equal(ntotal, nlist, mode, chunk):
    ids, lengths, prec = codec_scale.build_workload(ntotal, nlist, 7)
    ids_j, lengths_j, prec_j = jax_codec_scale.build_workload(ntotal, nlist, 7)
    for a, b in ((ids, ids_j), (lengths, lengths_j), (prec, prec_j)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ours = codec_scale.build_entries(ids, lengths, prec, mode, chunk)
    ref = jax_codec_scale.build_entries(ids_j, lengths_j, prec_j, mode, chunk)
    assert len(ours[0]) == len(ref[0])
    for a, b in zip(ours[0], ref[0]):
        assert np.array_equal(a, b)
    for a, b in zip(ours[1:6], ref[1:6]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[6] == ref[6]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["--ntotal", "3000", "--nlist", "16", "--runs", "1"],
    # JAX's interleave-routing case (tests/test_bench_drivers.py:106-136):
    # long lists chunked into extra lanes, decoded in groups of 8 lanes
    ["--ntotal", "3000", "--nlist", "4", "--runs", "1", "--chunk-target", "128",
     "--lane-chunk", "8"],
])
def test_codec_scale_equals_jax(capsys, argv):
    row = codec_scale.main([*argv, "--device", "cpu"])
    assert _last_json(capsys) == row
    jax_codec_scale.main([*argv, "--skip-device-encode"])
    ref = _last_json(capsys)
    for key in ("ntotal", "nlist", "n_max", "interleave", "lanes", "lane_n_max", "bits_per_id"):
        assert row[key] == ref[key], key
    # the rates are rounded to 0.01 Mids/s, and 3000 ids on a loaded CPU can
    # round to 0.0: this is no speed check (the card's rates are checked in
    # chip_smoke.py [bench])
    for key in ("decode_mids_s", "encode_mids_s"):
        assert isinstance(row[key], float) and row[key] >= 0, key
    if "--lane-chunk" in argv:
        assert row["lanes"] > 4 and row["lane_n_max"] <= 2 * 128


def test_codec_scale_device_encoder_branch(capsys, monkeypatch):
    """Without the native codec the host build is the device encoder (its
    plain version here), with the same streams."""
    argv = ["--ntotal", "2000", "--nlist", "8", "--runs", "1", "--device", "cpu"]
    native = codec_scale.main(argv)
    monkeypatch.setattr(codec_scale, "native_available", lambda: False)
    device = codec_scale.main(argv)
    assert device["bits_per_id"] == native["bits_per_id"]
    assert "host build: device encoder" in capsys.readouterr().err


@pytest.mark.parametrize("wt_type", ["0", "1"])
def test_wt_translate_equals_jax(capsys, wt_type):
    argv = ["--ntotal", "4000", "--nlist", "32", "--nq", "16", "--nshort", "8", "--runs", "1",
            "--wt-type", wt_type]
    row = wt_translate_bench.main([*argv, "--device", "cpu"])  # asserts its oracle
    assert _last_json(capsys) == row
    jax_wt.main(argv)
    ref = _last_json(capsys)
    for key in ("ntotal", "nlist", "wt_type", "Q", "levels"):
        assert row[key] == ref[key], key
    assert row["e2e_ms"] > 0 and row["select_chip_ms"] > 0

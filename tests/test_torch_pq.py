"""The port's PQ storage (``search/pq.py``, ``IndexIVF(storage="pq")``)
against the JAX package's.

A small IVF-PQ index is built and trained in JAX (d = 16, nlist = 16, M = 4,
nb = 4000, nq = 40), saved with the JAX ``save_index`` and loaded into the
port with ``load_index``: the port's k-means draws other numbers than
``jax.random``, so the trained parameters are carried across rather than
retrained. Both scans are compared: the decoded-reconstruction scan (the
default at these sizes in both packages) and the LUT scan (forced in JAX by
``VDBIDC_PQ_DECODE_SCAN=0``, in the port by ``PQ_DECODE_BUDGET = 0``).

Tolerances: distances agree to rtol=1e-5, atol=1e-4 (float32 sums in
another order), and labels under the near-tie rule of
``tests/test_torch_ivf.py``. PQ makes exact ties common (two entries with
the same code have the same distance), and ROC reorders each list's codes,
so labels are never compared as sorted rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_ivf import _close, assert_same_results
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import save_index
from vector_db_id_compression_tpu.store import invlists as jinv
from vector_db_id_compression_tpu_torch.search import ivf as tivf
from vector_db_id_compression_tpu_torch.search.pq import ProductQuantizer
from vector_db_id_compression_tpu_torch.store import invlists as tinv

D, NLIST, M, NB, NQ, K, NPROBE = 16, 16, 4, 4000, 40, 10, 4
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((8, D)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 8, NB)] + rng.standard_normal((NB, D))).astype(np.float32)
    xq = (cent[rng.integers(0, 8, NQ)] + rng.standard_normal((NQ, D))).astype(np.float32)
    return xb, xq


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """(JAX IVF-PQ index, the port's index loaded from its .npz)."""
    xb, _ = data
    jidx = JaxIndexIVF(D, NLIST, storage="pq", pq_m=M)
    jidx.train(xb)
    jidx.add(xb)
    path = tmp_path_factory.mktemp("ivfpq") / "index.npz"
    save_index(path, jidx)
    return jidx, tivf.load_index(path, device="cpu")


@pytest.fixture(scope="module")
def containers(indexes):
    """{name: (JAX container, port container)} over the same lists; the
    interleaved ones split every list (about 250 ids) into 4 chunks."""
    jidx, tidx = indexes
    kw = dict(interleave=4, interleave_min=64)
    return {
        "uncompressed": (jidx.invlists, tidx.invlists),
        "roc": (jinv.RocInvertedLists(jidx.invlists), tinv.RocInvertedLists(tidx.invlists, device="cpu")),
        "interleaved": (jinv.InterleavedRocInvertedLists(jidx.invlists, **kw),
                        tinv.InterleavedRocInvertedLists(tidx.invlists, **kw, device="cpu")),
    }


@pytest.fixture(params=["decoded", "lut"])
def scan(request, monkeypatch, indexes):
    """Select the scan in both packages; returns a function that swaps a
    container pair in (the scan storage is rebuilt on the swap)."""
    if request.param == "lut":
        monkeypatch.setenv("VDBIDC_PQ_DECODE_SCAN", "0")
        monkeypatch.setattr(tivf, "PQ_DECODE_BUDGET", 0)
    jidx, tidx = indexes

    def use(pair):
        jidx.replace_invlists(pair[0])
        tidx.replace_invlists(pair[1])
        assert jidx._scan_is_float == tidx._scan_is_float == (request.param == "decoded")
        return jidx, tidx

    yield use
    monkeypatch.undo()
    jidx.replace_invlists(jidx.invlists)
    tidx.replace_invlists(tidx.invlists)


def test_load_index_holds_the_pq(indexes):
    jidx, tidx = indexes
    assert tidx.storage == "pq" and tidx.code_size == jidx.code_size == M
    np.testing.assert_array_equal(tidx.pq.centroids.numpy(), jidx.pq.centroids)
    np.testing.assert_array_equal(tidx.centroids.numpy(), jidx.centroids)
    for ln in range(NLIST):
        np.testing.assert_array_equal(tidx.invlists.ids[ln], jidx.invlists.ids[ln])
        np.testing.assert_array_equal(tidx.invlists.codes[ln], jidx.invlists.codes[ln])


def test_compute_luts_match_jax(data, indexes):
    _, xq = data
    jidx, tidx = indexes
    want = np.asarray(jidx.pq.compute_luts(jnp.asarray(xq)))
    got = tidx.pq.compute_luts(torch.from_numpy(xq)).numpy()
    assert got.shape == (NQ, M, 256)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encode_matches_jax_up_to_ties(data, indexes):
    """Codes equal, except where a subvector's two candidate centroids are
    equidistant within the tolerance."""
    xb, _ = data
    jidx, tidx = indexes
    got = tidx.pq.encode(torch.from_numpy(xb)).numpy()
    want = jidx.pq.encode(xb)
    assert got.dtype == np.uint8 and got.shape == (NB, M)
    rows, ms = np.nonzero(got != want)
    assert len(rows) <= NB * M // 100
    cents = jidx.pq.centroids
    sub = xb.reshape(NB, M, -1)[rows, ms].astype(np.float64)
    d_got = ((sub - cents[ms, got[rows, ms]]) ** 2).sum(-1)
    d_want = ((sub - cents[ms, want[rows, ms]]) ** 2).sum(-1)
    assert _close(d_got, d_want).all()


def test_decode_is_exact(indexes):
    jidx, tidx = indexes
    codes = np.random.default_rng(3).integers(0, 256, (500, M)).astype(np.uint8)
    np.testing.assert_array_equal(tidx.pq.decode(torch.from_numpy(codes)).numpy(),
                                  jidx.pq.decode(codes))


def test_port_training_is_as_good_as_jax(data, indexes):
    """The port's own PQ training: the reconstruction error of its
    codebooks within 10% of the JAX codebooks' on the same data."""
    xb, _ = data
    jidx, _ = indexes
    pq = ProductQuantizer(D, M, device="cpu")
    pq.train(xb)
    x = torch.from_numpy(xb)
    mse = float(((pq.decode(pq.encode(x)) - x) ** 2).sum(1).mean())
    ref = float(((jidx.pq.decode(jidx.pq.encode(xb)) - xb) ** 2).sum(1).mean())
    assert pq.centroids.shape == (M, 256, D // M)
    assert mse <= 1.1 * ref, (mse, ref)


def test_positional_search_matches_jax(data, containers, scan):
    _, xq = data
    jidx, tidx = scan(containers["uncompressed"])
    D_ref, L_ref = jidx.search_positional(xq, K, nprobe=NPROBE)
    D_got, L_got = tidx.search_positional(xq, K, nprobe=NPROBE)
    assert_same_results(D_got, L_got, D_ref, L_ref)


@pytest.mark.parametrize("name", ["uncompressed", "roc", "interleaved"])
def test_deferred_search_matches_jax(data, containers, scan, name):
    _, xq = data
    jidx, tidx = scan(containers[name])
    D_ref, I_ref = jidx.search_defer_id_decoding(xq, K, nprobe=NPROBE)
    D_got, I_got = tidx.search_defer_id_decoding(xq, K, nprobe=NPROBE)
    assert_same_results(D_got, I_got, D_ref, I_ref)


@pytest.mark.parametrize("name", ["roc", "interleaved"])
def test_return_codes_match_jax(data, containers, scan, name):
    _, xq = data
    jidx, tidx = scan(containers[name])
    _, I_ref, c_ref = jidx.search_defer_id_decoding(xq, K, nprobe=NPROBE, return_codes=2,
                                                    include_listno=True)
    _, I_got, c_got = tidx.search_defer_id_decoding(xq, K, nprobe=NPROBE, return_codes=2,
                                                    include_listno=True)
    assert c_got.shape == (NQ, K, M + 1)
    same = I_got.numpy() == I_ref
    assert same.mean() > 0.9
    np.testing.assert_array_equal(c_got.numpy()[same], c_ref[same])


def test_lut_scan_equals_decoded_scan(data, indexes, containers, monkeypatch):
    """Both scans compute ||x - x_hat||^2: equal D, I up to ties, on the
    interleaved container."""
    _, xq = data
    _, tidx = indexes
    tidx.replace_invlists(containers["interleaved"][1])
    D_dec, I_dec = tidx.search(xq, K, nprobe=NPROBE)
    monkeypatch.setattr(tivf, "PQ_DECODE_BUDGET", 0)
    tidx.replace_invlists(containers["interleaved"][1])
    assert not tidx._scan_is_float
    D_lut, I_lut = tidx.search(xq, K, nprobe=NPROBE)
    monkeypatch.undo()
    tidx.replace_invlists(tidx.invlists)
    assert_same_results(D_lut, I_lut, D_dec.numpy(), I_dec.numpy())


@pytest.mark.parametrize("name", ["roc", "interleaved"])
def test_base_attributes_match_jax(containers, name):
    """overhead_in_bytes, supports_random_access, list_size and
    get_single_id, as the JAX base class has them."""
    jc, tc = containers[name]
    assert tc.overhead_in_bytes == jc.overhead_in_bytes
    assert tc.supports_random_access is jc.supports_random_access is False
    assert [tc.list_size(ln) for ln in range(NLIST)] == [jc.list_size(ln) for ln in range(NLIST)]
    for c in (tc, jc):
        with pytest.raises(NotImplementedError, match="random access"):
            c.get_single_id(0, 0)
    assert (tc.overhead_in_bytes > 0) == (name == "interleaved")


@pytest.mark.parametrize("storage", ["flat", "pq"])
def test_two_adds_equal_one(data, indexes, storage):
    """A second add appends to the lists (as Faiss does; the JAX package
    rebuilds them, ROADMAP Queue C): two adds give the lists of one add of
    the concatenation."""
    xb, _ = data
    jidx, tidx = indexes
    indexes_ = []
    for batches in ([xb], [xb[:1500], xb[1500:]]):
        idx = tivf.IndexIVF(D, NLIST, storage=storage, pq_m=M if storage == "pq" else 0,
                             device="cpu")
        idx.centroids = tidx.centroids.clone()
        if storage == "pq":
            idx.pq.centroids = tidx.pq.centroids.clone()
        for x in batches:
            idx.add(x)
        indexes_.append(idx)
    one, two = indexes_
    assert one.ntotal == two.ntotal == NB
    for ln in range(NLIST):
        np.testing.assert_array_equal(two.invlists.ids[ln], one.invlists.ids[ln])
        np.testing.assert_array_equal(two.invlists.codes[ln], one.invlists.codes[ln])
    assert sum(len(v) for v in two.invlists.ids) == NB


def test_pq_scan_choice_follows_the_budget(indexes, monkeypatch):
    _, tidx = indexes
    assert tidx._scan_is_float  # 16 lists of about 250 rows x 16 floats
    monkeypatch.setattr(tivf, "PQ_DECODE_BUDGET", 0)
    tidx.replace_invlists(tidx.invlists)
    assert not tidx._scan_is_float and tidx._scan[0].payload.dtype == torch.uint8
    monkeypatch.undo()
    tidx.replace_invlists(tidx.invlists)
    assert tidx._scan_is_float and tidx._scan[0].payload.dtype == torch.float32

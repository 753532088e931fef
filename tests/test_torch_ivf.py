"""The port's IVF index and ROC container against the JAX package's.

A small flat index is built in JAX (d = 16, nlist = 32, nb = 5000, nq = 50),
saved with the JAX ``save_index`` and loaded into the port with its
``load_index``, so both hold identical inverted lists. Then the ROC
containers must agree exactly (size, code order, decoded ids), and the
searches must agree up to float summation order.

Tolerances: distances agree to rtol=1e-5, atol=1e-4, because torch and XLA
sum the dot products in another order. Near-tie rule: a label may differ
from the JAX label only where the distances on either side of it lie within
that tolerance — the two packages then rank two almost equidistant vectors
in the other order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vector_db_id_compression_tpu.search import kmeans as jkmeans
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import save_index
from vector_db_id_compression_tpu.store.invlists import RocInvertedLists as JaxRoc
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index
from vector_db_id_compression_tpu_torch.search.kmeans import assign, train_kmeans
from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

D, NLIST, NB, NQ, K, NPROBE = 16, 32, 5000, 50, 10, 4
RTOL, ATOL = 1e-5, 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    return np.abs(a - b) <= atol + rtol * np.abs(b)


def assert_same_results(D_port, I_port, D_ref, I_ref, rtol=RTOL, atol=ATOL):
    """D within tolerance; I equal under the near-tie rule (module doc)."""
    D_port, I_port = np.asarray(D_port), np.asarray(I_port)
    k = I_ref.shape[1]
    finite = np.isfinite(D_ref)
    np.testing.assert_array_equal(np.isfinite(D_port), finite)
    np.testing.assert_allclose(D_port[finite], D_ref[finite], rtol=rtol, atol=atol)
    for i, j in zip(*np.nonzero(I_port != I_ref)):
        left = j > 0 and _close(D_ref[i, j], D_ref[i, j - 1], rtol, atol)
        # at the last slot, the port's own candidate is the one beyond JAX's k
        right = _close(D_ref[i, j], D_ref[i, j + 1] if j + 1 < k else D_port[i, j],
                       rtol, atol)
        assert left or right, f"query {i} slot {j}: label differs without a near tie"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((8, D)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 8, NB)] + rng.standard_normal((NB, D))).astype(np.float32)
    xq = (cent[rng.integers(0, 8, NQ)] + rng.standard_normal((NQ, D))).astype(np.float32)
    return xb, xq


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """(JAX index, port index loaded from the JAX index's .npz)."""
    xb, _ = data
    jidx = JaxIndexIVF(D, NLIST, storage="flat")
    jidx.train(xb)
    jidx.add(xb)
    path = tmp_path_factory.mktemp("ivf") / "index.npz"
    save_index(path, jidx)
    return jidx, load_index(path, device="cpu")


@pytest.fixture(scope="module")
def rocs(indexes):
    jidx, tidx = indexes
    return JaxRoc(jidx.invlists), RocInvertedLists(tidx.invlists, device="cpu")


def _with_container(index, container):
    """Swap a container in and return a restore callback."""
    previous = index.active
    index.replace_invlists(container)
    return lambda: index.replace_invlists(previous)


def test_load_index_holds_the_same_lists(indexes):
    jidx, tidx = indexes
    np.testing.assert_array_equal(tidx.centroids.numpy(), jidx.centroids)
    assert tidx.ntotal == jidx.ntotal == NB
    for ln in range(NLIST):
        np.testing.assert_array_equal(tidx.invlists.ids[ln], jidx.invlists.ids[ln])
        np.testing.assert_array_equal(tidx.invlists.codes[ln], jidx.invlists.codes[ln])


def test_roc_container_size_and_code_order(rocs):
    jroc, troc = rocs
    assert troc.compressed_ids_size_in_bytes == jroc.compressed_ids_size_in_bytes
    np.testing.assert_array_equal(troc.id_symbol_precision, jroc.id_symbol_precision)
    for ln in range(NLIST):
        # byte-equal codes: the same sampling order in both packages
        np.testing.assert_array_equal(troc.get_codes(ln), jroc.get_codes(ln))


def test_roc_decode_lists_matches_jax(rocs):
    jroc, troc = rocs
    lists = np.arange(NLIST)
    jids, jlens = jroc.decode_lists(lists)
    tids, tlens = troc.decode_lists(torch.from_numpy(lists))
    np.testing.assert_array_equal(tlens.numpy(), jlens)
    np.testing.assert_array_equal(tids.numpy().view(np.uint64), jids)
    np.testing.assert_array_equal(troc.get_ids(3).numpy().view(np.uint64),
                                  jroc.get_ids(3))


def test_roc_decode_select_matches_jax(rocs):
    jroc, troc = rocs
    rng = np.random.default_rng(1)
    lens = jroc.lengths
    lns = rng.choice(np.flatnonzero(lens > 0), 300)
    offs = (rng.random(300) * lens[lns]).astype(np.int64)
    want = jroc.decode_select(lns, offs)
    got = troc.decode_select(torch.from_numpy(lns), torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_positional_search_matches_jax(data, indexes):
    _, xq = data
    jidx, tidx = indexes
    D_ref, L_ref = jidx.search_positional(xq, K, nprobe=NPROBE)
    D_got, L_got = tidx.search_positional(xq, K, nprobe=NPROBE)
    assert_same_results(D_got, L_got, D_ref, L_ref)


def test_uncompressed_search_matches_jax(data, indexes):
    _, xq = data
    jidx, tidx = indexes
    D_ref, I_ref = jidx.search(xq, K, nprobe=NPROBE)
    D_got, I_got = tidx.search(xq, K, nprobe=NPROBE)
    assert_same_results(D_got, I_got, D_ref, I_ref)


def test_roc_deferred_search_matches_jax(data, indexes, rocs):
    _, xq = data
    jidx, tidx = indexes
    restore_j = _with_container(jidx, rocs[0])
    restore_t = _with_container(tidx, rocs[1])
    try:
        D_ref, I_ref = jidx.search_defer_id_decoding(xq, K, nprobe=NPROBE)
        D_got, I_got = tidx.search_defer_id_decoding(xq, K, nprobe=NPROBE)
    finally:
        restore_j()
        restore_t()
    assert_same_results(D_got, I_got, D_ref, I_ref)


def test_roc_search_equals_uncompressed(data, indexes, rocs):
    """The reference's end-to-end oracle (tests/test_ivf.py): ids are
    lossless, so the ROC search returns the uncompressed search's rows."""
    _, xq = data
    _, tidx = indexes
    D_ref, I_ref = tidx.search(xq, K, nprobe=NPROBE)
    restore = _with_container(tidx, rocs[1])
    try:
        D_roc, I_roc = tidx.search(xq, K, nprobe=NPROBE)
    finally:
        restore()
    np.testing.assert_allclose(D_roc.numpy(), D_ref.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.sort(I_roc.numpy(), 1), np.sort(I_ref.numpy(), 1))


def test_full_probe_matches_brute_force(data, indexes):
    """Probing every list is exact search: float64 brute force, with the
    float32 tolerance of tests/test_ivf.py and the near-tie rule."""
    xb, xq = data
    _, tidx = indexes
    d2 = ((xq[:, None, :].astype(np.float64) - xb[None]) ** 2).sum(-1)
    I_bf = np.argsort(d2, axis=1, kind="stable")[:, :K]
    D_bf = np.take_along_axis(d2, I_bf, 1)
    D_got, I_got = tidx.search(xq, K, nprobe=NLIST)
    assert_same_results(D_got, I_got, D_bf, I_bf, rtol=1e-4, atol=1e-3)


def test_return_codes_match_jax(data, indexes, rocs):
    _, xq = data
    jidx, tidx = indexes
    restore_j = _with_container(jidx, rocs[0])
    restore_t = _with_container(tidx, rocs[1])
    try:
        _, I_ref, c_ref = jidx.search_defer_id_decoding(
            xq[:8], K, nprobe=NPROBE, return_codes=2, include_listno=True)
        _, I_got, c_got = tidx.search_defer_id_decoding(
            xq[:8], K, nprobe=NPROBE, return_codes=2, include_listno=True)
    finally:
        restore_j()
        restore_t()
    same = I_got.numpy() == I_ref
    assert same.mean() > 0.9
    np.testing.assert_array_equal(c_got.numpy()[same], c_ref[same])


def test_add_assigns_like_jax(data, indexes):
    """The port's add puts each vector in the list JAX's kmeans.assign picks
    on the same centroids, except where two centroids are near-equidistant."""
    xb, _ = data
    jidx, _ = indexes
    port = IndexIVF(D, NLIST, device="cpu")
    port.centroids = torch.tensor(jidx.centroids)
    port.add(xb)
    got = np.empty(NB, np.int64)
    for ln in range(NLIST):
        got[port.invlists.ids[ln].astype(np.int64)] = ln
    want = np.asarray(jkmeans.assign(jnp.asarray(xb), jnp.asarray(jidx.centroids)))
    d2 = ((xb[:, None, :].astype(np.float64) - jidx.centroids[None]) ** 2).sum(-1)
    rows = np.arange(NB)
    differ = got != want
    assert differ.mean() < 0.01
    assert _close(d2[rows, got], d2[rows, want])[differ].all()


def test_train_kmeans_reduces_inertia(data):
    xb, _ = data
    x = torch.from_numpy(xb)

    def inertia(c):
        return float(((x - c[assign(x, c)]) ** 2).sum())

    one = train_kmeans(xb, NLIST, niter=1, device="cpu")
    twenty = train_kmeans(xb, NLIST, niter=20, device="cpu")
    assert twenty.shape == (NLIST, D) and bool(torch.isfinite(twenty).all())
    assert inertia(twenty) <= inertia(one)

"""The port's HNSW and HNSW coarse quantizer against the JAX package's, on
the CPU.

Inputs are made with numpy from seeds and handed to both packages.

- Build: levels, entry, max_level and every layer equal JAX's exactly, on
  the fixture of tests/test_hnsw.py (N = 600, d = 12, M = 12, batch 64) and
  on one with several levels (N = 400, d = 16, M = 4, batch 32): the levels
  are the same numpy draws and every build-time distance is summed in
  numpy's order, so no neighbour choice differs.
- Build-time distances: the torch slab and the native link loop's distances
  equal numpy's (JAX ``_dists_host``, ``HNSW._pair_d``) bit for bit.
- Descent: ``hnsw_descend_device`` gives JAX's level-0 entries on a
  ``from_arrays`` copy of JAX's index.
- Search: the dense level 0 and the four compressed containers give JAX's
  dense search (the JAX package's own tests hold its containers to it):
  distances to rtol 1e-5, since torch and XLA sum the squared differences in
  another order; labels under the near-tie rule of tests/test_torch_graph.py.
- IndexIVF(quantizer="hnsw"), flat and PQ storage, JAX's centroids (and
  codebooks) copied in: the same probes, the same lists after ``add``
  (misses included), the same search with RocInvertedLists under the near-tie
  rule of tests/test_torch_ivf.py; -1 probes probe nothing, as in JAX.
- Files: save_hnsw and save_index of an HNSW-quantizer index are JAX's byte
  for byte, and each package loads the other's.
"""

import json

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.search import hnsw as jhnsw
from vector_db_id_compression_tpu.search.graph_device import (
    hnsw_descend_device as jax_descend)
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import load_index as jax_load_index
from vector_db_id_compression_tpu.search.ivf import save_index as jax_save_index
from vector_db_id_compression_tpu.store import serialize as jser
from vector_db_id_compression_tpu_torch import native
from vector_db_id_compression_tpu_torch.search.graph_device import hnsw_descend_device
from vector_db_id_compression_tpu_torch.search.hnsw import HNSW, _build_dists, get_level0_links
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index, save_index
from vector_db_id_compression_tpu_torch.store import serialize as tser
from vector_db_id_compression_tpu_torch.store.graph import (CompactBitGraph, EliasFanoGraph, Graph,
                                                           RocBlockGraph, RocGraph)
from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists
from vector_db_id_compression_tpu_torch.utils import device_trace

from test_torch_ivf import assert_same_results

# (N, d, M, batch, seed): tests/test_hnsw.py's fixture, and one with M = 4
# (mL = 1/ln 4: several levels)
BUILDS = {"test_hnsw": (600, 12, 12, 64, 11), "levels": (400, 16, 4, 32, 5)}
NQ, K, EF = 25, 5, 48
RTOL = 1e-5


@pytest.fixture(scope="module", params=sorted(BUILDS))
def built(request):
    """(xb, xq, JAX's HNSW, the port's HNSW built from the same vectors)."""
    N, d, M, batch, seed = BUILDS[request.param]
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(N, d)).astype(np.float32)
    xq = rng.normal(size=(NQ, d)).astype(np.float32)
    j = jhnsw.HNSW(M=M, ef_construction=40).build(xb, batch=batch)
    t = HNSW(M=M, ef_construction=40, device="cpu").build(xb, batch=batch)
    return xb, xq, j, t


def copy_of(j) -> HNSW:
    """The port's index over JAX's built state."""
    return HNSW.from_arrays(j.levels, j.layers, j.entry, j.max_level, j.M, j.ef_construction,
                            j.seed, j._xb, device="cpu")


def test_build_equals_jax(built):
    _, _, j, t = built
    np.testing.assert_array_equal(t.levels, j.levels)
    assert (t.entry, t.max_level, t.Mmax0, t.ef_construction) == (
        j.entry, j.max_level, j.Mmax0, j.ef_construction)
    assert len(t.layers) == len(j.layers) == j.max_level + 1
    for tl, jl in zip(t.layers, j.layers):
        assert tl.dtype == jl.dtype
        np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(get_level0_links(t, 7), jhnsw.get_level0_links(j, 7))


@pytest.mark.parametrize("d", [12, 128])
def test_build_distances_equal_numpy(d):
    rng = np.random.default_rng(d)
    xb = (rng.standard_normal((300, d)) * rng.uniform(0.5, 50, (300, 1))).astype(np.float32)
    xq = rng.standard_normal((40, d)).astype(np.float32)
    nodes = rng.integers(-1, 300, (40, 33))
    want = jhnsw._dists_host(xq, xb, nodes)
    got = _build_dists(torch.from_numpy(xq), torch.from_numpy(xb), torch.from_numpy(nodes))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the native link loop's pair distances, as JAX's HNSW._pair_d
    j = jhnsw.HNSW(M=4)
    j._xb = xb
    for v in (0, 17, 299):
        cand = nodes[v % 40]
        np.testing.assert_array_equal(native.hnsw_pair_dists(xb, v, cand),
                                      j._pair_d(v, cand).astype(np.float32))


def test_descend_equals_jax(built):
    xb, xq, j, _ = built
    t = copy_of(j)
    got = hnsw_descend_device(t, xq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_descend(j, xq)))
    # the host oracle: the greedy descent level by level
    cur = np.full(NQ, t.entry, dtype=np.int64)
    everyone = torch.ones(len(xb), dtype=torch.bool)
    for lv in range(t.max_level, 0, -1):
        cur = t._greedy_descend(np.arange(NQ), cur, lv, everyone, xq=xq)
    np.testing.assert_array_equal(got.numpy(), cur)


def assert_near_ties(D_port, I_port, D_ref, I_ref):
    """D within RTOL; a label may differ only where JAX's distances on either
    side of it lie within RTOL (tests/test_torch_graph.py)."""
    D_port, I_port = np.asarray(D_port), np.asarray(I_port)
    np.testing.assert_allclose(D_port, D_ref, rtol=RTOL)
    for i, j in zip(*np.nonzero(I_port != I_ref)):
        near = [np.isclose(D_ref[i, j], D_ref[i, jj], rtol=RTOL)
                for jj in (j - 1, j + 1) if 0 <= jj < I_ref.shape[1]]
        assert any(near), f"query {i} slot {j}: label differs without a near tie"


CONTAINERS = {
    "Graph": None,
    "RocGraph": RocGraph,
    "RocBlockGraph": lambda g: RocBlockGraph(g, block=4),
    "CompactBitGraph": CompactBitGraph,
    "EliasFanoGraph": EliasFanoGraph,
}


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_search_equals_jax(built, name):
    xb, xq, j, _ = built
    t = copy_of(j)
    make = CONTAINERS[name]
    g0 = None if make is None else make(t.level0_graph())
    D, I = t.search(xq, K, ef=EF, graph0=g0)
    D_ref, I_ref = j.search(xq, K, ef=EF)
    assert_near_ties(D.numpy(), I.numpy(), np.asarray(D_ref), np.asarray(I_ref))


def test_m_validation():
    with pytest.raises(ValueError):
        HNSW(M=1, device="cpu")


# ------------------------------------------------------------ the quantizer

D, NLIST, NB, NQ_IVF, NPROBE = 16, 64, 3000, 30, 4


@pytest.fixture(scope="module")
def ivf_data():
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((8, D)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 8, NB)] + rng.standard_normal((NB, D))).astype(np.float32)
    xq = (cent[rng.integers(0, 8, NQ_IVF)] + rng.standard_normal((NQ_IVF, D))).astype(np.float32)
    return xb, xq


def make_pair(xb, storage: str, add: bool = True, patch=None):
    """(JAX index, port index) with quantizer="hnsw" and M = 8: JAX trained,
    its centroids (and codebooks) copied into the port; both add ``xb``,
    through ``patch(index, coarse_assign)`` in place of coarse_assign where
    given."""
    kw = dict(storage=storage, pq_m=4 if storage == "pq" else 0, nprobe=NPROBE,
              quantizer="hnsw", quantizer_M=8)
    j = JaxIndexIVF(D, NLIST, **kw)
    j.train(xb)
    t = IndexIVF(D, NLIST, **kw, device="cpu")
    t.centroids = torch.from_numpy(np.array(j.centroids))
    if storage == "pq":
        t.pq.centroids = torch.from_numpy(np.array(j.pq.centroids))
    if patch is not None:
        for index in (j, t):
            index.coarse_assign = patch(index.coarse_assign)
    if add:
        j.add(xb)
        t.add(xb)
    return j, t


@pytest.fixture(scope="module", params=["flat", "pq"])
def ivf_pair(request, ivf_data):
    return make_pair(ivf_data[0], request.param)


def assert_same_lists(j, t):
    for ln in range(NLIST):
        np.testing.assert_array_equal(t.invlists.ids[ln], j.invlists.ids[ln])


def test_hnsw_quantizer_graph_and_probes_equal_jax(ivf_data, ivf_pair):
    _, xq = ivf_data
    j, t = ivf_pair
    jq, tq = j._ensure_quantizer(), t._ensure_quantizer()
    for tl, jl in zip(tq.layers, jq.layers):
        np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(t.coarse_assign(xq, NPROBE).numpy(),
                                  np.asarray(j.coarse_assign(xq, NPROBE)))
    # the graph is rebuilt for another centroids tensor, and only then
    assert t._ensure_quantizer() is tq
    t.centroids = t.centroids.clone()
    assert t._ensure_quantizer() is not tq


def test_hnsw_quantizer_add_and_search_equal_jax(ivf_data, ivf_pair):
    _, xq = ivf_data
    j, t = ivf_pair
    assert_same_lists(j, t)
    D_ref, I_ref = j.search(xq, 10, nprobe=NPROBE)
    t.replace_invlists(RocInvertedLists(t.invlists, device="cpu"))
    D, I = t.search(xq, 10, nprobe=NPROBE)
    t.replace_invlists(t.invlists)
    assert_same_results(D.numpy(), I.numpy(), np.asarray(D_ref), np.asarray(I_ref))


def test_hnsw_quantizer_add_assigns_misses_exactly_as_jax(ivf_data):
    """Vectors the walk does not place (-1, forced here for every 7th) go to
    their exact nearest centroid in both packages."""
    def patch(coarse_assign):
        def patched(x, nprobe):
            p = coarse_assign(x, nprobe)
            p = p.clone() if isinstance(p, torch.Tensor) else np.array(p)
            p[::7] = -1
            return p
        return patched

    j, t = make_pair(ivf_data[0], "flat", patch=patch)
    assert_same_lists(j, t)
    assert sum(len(ids) for ids in t.invlists.ids) == NB


def test_hnsw_quantizer_minus_one_probes_drop_as_jax(ivf_data, ivf_pair):
    """nprobe past nlist: the HNSW search returns -1 for the slots it does not
    reach; they probe nothing (a wrapped -1 would probe the last list)."""
    _, xq = ivf_data
    j, t = ivf_pair
    probes = t.coarse_assign(xq, NLIST + 16)
    np.testing.assert_array_equal(probes.numpy(), np.asarray(j.coarse_assign(xq, NLIST + 16)))
    assert bool((probes < 0).any())
    for k in (10, 400):
        D_ref, I_ref = j.search(xq, k, nprobe=NLIST + 16)
        D, I = t.search(xq, k, nprobe=NLIST + 16)
        assert_same_results(D.numpy(), I.numpy(), np.asarray(D_ref), np.asarray(I_ref))


def test_minus_one_probes_probe_nothing(ivf_data, monkeypatch):
    """The flat quantizer's probes with every other slot forced to -1 search
    as JAX's with the same probes."""
    xb, xq = ivf_data
    j = JaxIndexIVF(D, NLIST, storage="flat", nprobe=8)
    j.train(xb)
    j.add(xb)
    t = IndexIVF(D, NLIST, nprobe=8, device="cpu")
    t.centroids = torch.from_numpy(np.array(j.centroids))
    t.add(xb)
    for index in (j, t):
        def patched(x, nprobe, coarse_assign=index.coarse_assign):
            p = coarse_assign(x, nprobe)
            p = p.clone() if isinstance(p, torch.Tensor) else np.array(p)
            p[:, 1::2] = -1
            return p
        monkeypatch.setattr(index, "coarse_assign", patched)
    D_ref, I_ref = j.search(xq, 10, nprobe=8)
    D_t, I_t = t.search(xq, 10, nprobe=8)
    assert_same_results(D_t.numpy(), I_t.numpy(), np.asarray(D_ref), np.asarray(I_ref))


# ------------------------------------------------------------------- files


def test_hnsw_files_equal_jax(tmp_path, ivf_data):
    """save_hnsw and save_index (quantizer_M = 8) write JAX's bytes; each
    package loads the other's file and searches as the saved index."""
    xb, xq = ivf_data
    j, t = make_pair(xb, "flat")
    jq, tq = j._ensure_quantizer(), t._ensure_quantizer()
    for name, jsave, tsave, jobj, tobj in (
            ("hnsw", jser.save_hnsw, tser.save_hnsw, jq, tq),
            ("index", jax_save_index, save_index, j, t)):
        jpath, tpath = tmp_path / f"jax_{name}.npz", tmp_path / f"port_{name}.npz"
        jsave(jpath, jobj)
        tsave(tpath, tobj)
        assert tpath.read_bytes() == jpath.read_bytes(), name
    cent = t.centroids
    th = tser.load_hnsw(tmp_path / "jax_hnsw.npz", cent, device="cpu")
    jh = jser.load_hnsw(tmp_path / "port_hnsw.npz", np.asarray(j.centroids))
    for a, b in zip(th.layers, jq.layers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jh.levels, tq.levels)
    D0, I0 = tq.search(xq, NPROBE, ef=64)
    D1, I1 = th.search(xq, NPROBE, ef=64)
    assert torch.equal(I1, I0) and torch.equal(D1, D0)
    ti = load_index(tmp_path / "jax_index.npz", device="cpu")
    ji = jax_load_index(tmp_path / "port_index.npz")
    assert (ti.quantizer, ti.quantizer_M, ti.quantizer_efSearch) == ("hnsw", 8, 64)
    assert (ji.quantizer, ji.quantizer_M) == ("hnsw", 8)
    assert_same_lists(j, ti)
    D_ref, I_ref = ji.search(xq, 10)
    D, I = ti.search(xq, 10)
    assert torch.equal(D, t.search(xq, 10)[0])
    assert_same_results(D.numpy(), I.numpy(), np.asarray(D_ref), np.asarray(I_ref))


def test_load_hnsw_rejects_other_kinds(tmp_path):
    path = tmp_path / "graph.npz"
    tser.save_graph(path, Graph(np.array([[1], [0]], np.int32), device="cpu"))
    with pytest.raises(ValueError, match="hnsw"):
        tser.load_hnsw(path, np.zeros((2, 4), np.float32), device="cpu")


# --------------------------------------------------------------- profiling


def test_device_trace_records_program_spans(tmp_path, ivf_data):
    """``device_trace`` writes the block's Chrome trace, and with it the
    program's spans: the search's, and the coarse span around the HNSW
    quantizer's walk."""
    xb, xq = ivf_data
    index = IndexIVF(D, NLIST, nprobe=NPROBE, quantizer="hnsw", quantizer_M=8, device="cpu")
    index.train(xb)
    index.add(xb)
    with device_trace(tmp_path / "trace") as prof:
        (torch.ones(256, 256) @ torch.ones(256, 256)).sum()
        index.search(xq, K)
    assert prof is not None
    trace = tmp_path / "trace" / "trace.json"
    assert trace.stat().st_size > 0
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"ivf.search", "ivf.coarse"} <= set(spans)
    assert spans["ivf.search"]["ts"] <= spans["ivf.coarse"]["ts"]

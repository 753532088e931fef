"""The port's artifact format against the JAX package's, on the CPU.

``store/serialize.py`` (every IVF container kind, both wavelet-tree types,
every graph kind), ``search/ivf.py`` ``save_index`` (flat, PQ and QINCo
storage) and ``utils/integrity.py`` must write the JAX package's files byte
for byte from the same content, and each package must load the other's
files. For each kind, on lists of a few
hundred ids (nlist 16, some lists empty, one of a single id, one long enough
for several size buckets), on 3 ids, and on none:
  - the port's file is byte-equal to the JAX package's for the same lists;
  - the JAX file loads in the port with the built container's state tables,
    sizes, lengths, codes, ``get_ids``, ``decode_lists``, ``decode_select``
    and (random access) ``get_single_ids_batch``;
  - the port's file loads in JAX with the port container's sizes, lengths,
    codes and ids: JAX's ``decode_lists`` and grouped ``decode_select`` for
    the ROC kinds (every call touches every nonempty list, so JAX compiles
    its decode once per size bucket), its ``get_single_ids_batch`` over
    every id for the random-access kinds (JAX's full decode of those is an
    eager program that takes seconds per bucket shape on the CPU).
Graphs the same with ``get_neighbors_batch`` over every node, and the walk
over a loaded graph gives the built graph's I and D. ``save_index`` over the
flat and PQ indexes of ``test_torch_containers.py`` and ``test_torch_pq.py``
(the same data, so that JAX compiles the same shapes): byte-equal, loadable
both ways; the port's loaded index with a loaded container (ROC, interleaved
ROC) searches exactly as the built pair, and as JAX's loaded index under the
near-tie rule of ``test_torch_ivf.py``. The checksums equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ivf import assert_same_results
from vector_db_id_compression_tpu.models.qinco import QincoCodec as JaxQincoCodec
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import load_index as jax_load_index
from vector_db_id_compression_tpu.search.ivf import save_index as jax_save_index
from vector_db_id_compression_tpu.store import graph as jgraph
from vector_db_id_compression_tpu.store import invlists as jinv
from vector_db_id_compression_tpu.store import serialize as jser
from vector_db_id_compression_tpu.utils import integrity as jint
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index, save_index
from vector_db_id_compression_tpu_torch.store import graph as tgraph
from vector_db_id_compression_tpu_torch.store import invlists as tinv
from vector_db_id_compression_tpu_torch.store import serialize as tser
from vector_db_id_compression_tpu_torch.utils import integrity as tint

NLIST, CS = 16, 4
# registry keys, and the interleaved container with its integer policy
# (4 chunks for lists of 16 ids or more)
IVF_KINDS = sorted(tinv.AVAILABLE_COMPRESSED_IVFS) + ["roc-interleaved-4"]


def u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


def source_lists(which: str):
    """(JAX, port) InvertedLists, code_size 4, holding the same ids and
    codes; ids ascending per list and below ntotal (packed bits and the
    wavelet tree need both). "full": 400 ids, list 0 empty, list 1 the one
    id 7, list 2 160 ids (a bucket of its own), the rest drawn over lists
    3..15; "few": ids 0 and 2 in list 5 and 1 in list 9; "empty": none."""
    rng = np.random.default_rng(17)
    if which == "full":
        assign = rng.integers(3, NLIST, 400)
        assign[rng.choice(np.arange(8, 400), 160, replace=False)] = 2
        assign[7] = 1
    else:
        assign = np.array([5, 9, 5] if which == "few" else [], dtype=np.int64)
    codes = rng.integers(0, 256, (len(assign), CS), dtype=np.uint8)
    pair = []
    for mod in (jinv, tinv):
        il = mod.InvertedLists(NLIST, CS)
        for ln in range(NLIST):
            ids = np.flatnonzero(assign == ln)
            il.add_entries(ln, ids.astype(np.uint64), codes[ids].reshape(-1))
        pair.append(il)
    return pair


def make_containers(name: str, jil, til):
    if name == "roc-interleaved-4":
        kw = dict(interleave=4, interleave_min=16)
        return (jinv.InterleavedRocInvertedLists(jil, **kw),
                tinv.InterleavedRocInvertedLists(til, **kw, device="cpu"))
    return (jinv.AVAILABLE_COMPRESSED_IVFS[name](jil),
            tinv.AVAILABLE_COMPRESSED_IVFS[name](til, device="cpu"))


def state_tables(c) -> dict:
    """The tensors that hold a port container's state, by name; a ROC
    stack's words past each lane's stack_len are no part of the stream and
    read as 0 here."""
    if hasattr(c, "decoder"):
        st = c.decoder.states
        cols = torch.arange(st.stack.shape[1])[None, :]
        out = {"head": st.head, "stack_len": st.stack_len, "mt_ctr": st.mt_ctr,
               "stack": torch.where(cols < st.stack_len[:, None], st.stack, 0),
               "lengths": c.decoder.lengths, "precision": c.decoder.precision}
        for name in ("_lane_lo", "_lane_first", "_lane_start", "_n_lanes", "_list_len"):
            if hasattr(c, name):
                out[name] = getattr(c, name)
        return out
    if hasattr(c, "packed"):
        return {"words": c.packed.words, "lengths": c.packed.lengths}
    if hasattr(c, "ef"):
        ef = c.ef
        return {"high": ef.high.words, "dir": ef.high.sb_prefix, "nbits": ef.high.nbits,
                "low": ef.low_words, "l": ef.l, "m": ef.m}
    return dict(zip(c.wt._fields[:-2], tuple(c.wt)[:-2]))


def labels_of(lengths: np.ndarray):
    """(lists, offsets): both ends and a middle offset of every nonempty
    list, shuffled."""
    lns, offs = [], []
    for ln in np.flatnonzero(lengths > 0):
        n = int(lengths[ln])
        take = sorted({0, n // 2, n - 1})
        lns += [ln] * len(take)
        offs += take
    perm = np.random.default_rng(3).permutation(len(lns))
    return np.array(lns, np.int64)[perm], np.array(offs, np.int64)[perm]


def assert_loaded_equal(loaded, built):
    """A container the port loaded holds and answers what the built one
    does."""
    assert type(loaded) is type(built)
    for attr in ("compressed_ids_size_in_bytes", "overhead_in_bytes", "nlist", "code_size"):
        assert getattr(loaded, attr) == getattr(built, attr), attr
    np.testing.assert_array_equal(loaded.lengths, built.lengths)
    for attr in ("id_symbol_precision", "n_lanes"):
        if hasattr(built, attr):
            np.testing.assert_array_equal(getattr(loaded, attr), getattr(built, attr))
    assert getattr(loaded, "interleave", None) == getattr(built, "interleave", None)
    got, want = state_tables(loaded), state_tables(built)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    for ln in range(built.nlist):
        np.testing.assert_array_equal(loaded.get_codes(ln), built.get_codes(ln))
        assert torch.equal(loaded.get_ids(ln), built.get_ids(ln))
    lists = torch.arange(built.nlist)
    for g, w in zip(loaded.decode_lists(lists), built.decode_lists(lists)):
        assert torch.equal(g, w)
    lns, offs = (torch.from_numpy(a) for a in labels_of(built.lengths))
    assert torch.equal(loaded.decode_select(lns, offs), built.decode_select(lns, offs))
    if built.supports_random_access:
        assert torch.equal(loaded.get_single_ids_batch(lns, offs),
                           built.get_single_ids_batch(lns, offs))


def assert_jax_loaded_equal(jl, built):
    """A container JAX loaded from the port's file answers what the port's
    built one does."""
    assert type(jl).__name__ == type(built).__name__
    for attr in ("compressed_ids_size_in_bytes", "overhead_in_bytes", "nlist", "code_size"):
        assert getattr(jl, attr) == getattr(built, attr), attr
    np.testing.assert_array_equal(jl.lengths, built.lengths)
    for ln in range(built.nlist):
        np.testing.assert_array_equal(jl.get_codes(ln), built.get_codes(ln))
    lists = np.arange(built.nlist)
    tids, tlens = built.decode_lists(torch.from_numpy(lists))
    if built.supports_random_access:
        # every id of every list by random access (JAX's decode_lists and
        # grouped decode_select of these containers decode with an eager
        # program that takes seconds per bucket shape on the CPU)
        lns = np.repeat(lists, built.lengths)
        offs = np.concatenate([np.arange(n) for n in built.lengths] + [np.zeros(0, np.int64)])
        if len(lns):
            np.testing.assert_array_equal(jl.get_single_ids_batch(lns, offs),
                                          u64(tids)[lns, offs])
    else:
        jids, jlens = jl.decode_lists(lists)
        np.testing.assert_array_equal(jlens, tlens.numpy())
        np.testing.assert_array_equal(jids, u64(tids))
        lns, offs = labels_of(built.lengths)
        if len(lns):
            want = built.decode_select(torch.from_numpy(lns), torch.from_numpy(offs))
            np.testing.assert_array_equal(jl.decode_select(lns, offs), u64(want))


@pytest.mark.parametrize("which", ["full", "few", "empty"])
@pytest.mark.parametrize("name", IVF_KINDS)
def test_invlists_artifact_matches_jax(tmp_path, name, which):
    jc, tc = make_containers(name, *source_lists(which))
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jser.save_invlists(jpath, jc)
    tser.save_invlists(tpath, tc)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert_loaded_equal(tser.load_invlists(jpath, device="cpu"), tc)
    assert_jax_loaded_equal(jser.load_invlists(tpath), tc)


# ------------------------------------------------------------------- graphs

GN, GK = 300, 10
GRAPH_KINDS = ["Graph", "CompactBitGraph", "EliasFanoGraph", "RocGraph", "RocBlockGraph"]


@pytest.fixture(scope="module")
def graph_pair():
    """(JAX Graph, port Graph) over one adjacency: every node has 1..K
    distinct neighbours, none of them node 0 (ROC cannot code a set whose
    largest id is 0), -1 padded; vectors and queries for a walk."""
    rng = np.random.default_rng(31)
    adj = np.full((GN, GK), -1, np.int32)
    deg = rng.integers(1, GK + 1, GN)
    deg[:3] = [1, GK, GK - 1]
    for i in range(GN):
        adj[i, : deg[i]] = rng.choice(np.arange(1, GN), deg[i], replace=False)
    xb = rng.standard_normal((GN, 6)).astype(np.float32)
    xq = rng.standard_normal((10, 6)).astype(np.float32)
    return jgraph.Graph(adj), tgraph.Graph(adj, device="cpu"), xb, xq


def make_graphs(name: str, jg, tg):
    if name == "Graph":
        return jg, tg
    if name == "RocBlockGraph":
        return jgraph.RocBlockGraph(jg, block=8), tgraph.RocBlockGraph(tg, block=8)
    return getattr(jgraph, name)(jg), getattr(tgraph, name)(tg)


@pytest.mark.parametrize("name", GRAPH_KINDS)
def test_graph_artifact_matches_jax(tmp_path, graph_pair, name):
    jg0, tg0, xb, xq = graph_pair
    jg, tg = make_graphs(name, jg0, tg0)
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jser.save_graph(jpath, jg)
    tser.save_graph(tpath, tg)
    assert tpath.read_bytes() == jpath.read_bytes()
    nodes = np.arange(GN)
    want, cnt = tg.get_neighbors_batch(torch.from_numpy(nodes))
    # the JAX file in the port
    loaded = tser.load_graph(jpath, device="cpu")
    assert type(loaded) is type(tg) and (loaded.N, loaded.K) == (tg.N, tg.K)
    assert torch.equal(loaded.degrees, tg.degrees)
    for attr in ("compressed_ids_size_in_bytes", "overhead_in_bytes", "bits", "stride", "block"):
        assert getattr(loaded, attr, None) == getattr(tg, attr, None), attr
    nb, c = loaded.get_neighbors_batch(torch.from_numpy(nodes))
    assert torch.equal(nb, want) and torch.equal(c, cnt)
    if hasattr(tg, "decoder"):
        st, st0 = loaded.decoder.states, tg.decoder.states
        for f in ("head", "stack_len", "mt_ctr"):
            assert torch.equal(getattr(st, f), getattr(st0, f)), f
        assert st.stack.shape == st0.stack.shape
        assert torch.equal(loaded.decoder.lengths, tg.decoder.lengths)
        assert torch.equal(loaded.decoder.precision, tg.decoder.precision)
    D0, I0 = search_graph_device(tg, xb, xq, 5, entry=1)
    D1, I1 = search_graph_device(loaded, xb, xq, 5, entry=1)
    assert torch.equal(I1, I0) and torch.equal(D1, D0)
    # the port's file in JAX
    jl = jser.load_graph(tpath)
    assert type(jl).__name__ == type(tg).__name__ and (jl.N, jl.K) == (tg.N, tg.K)
    np.testing.assert_array_equal(jl.degrees, tg.degrees.numpy())
    assert getattr(jl, "compressed_ids_size_in_bytes", 0) == getattr(
        tg, "compressed_ids_size_in_bytes", 0)
    jnb, jcnt = jl.get_neighbors_batch(nodes)
    np.testing.assert_array_equal(jnb, want.numpy())
    np.testing.assert_array_equal(jcnt, cnt.numpy())


# ---------------------------------------------------------------- save_index


def flat_index():
    """The JAX flat index of ``test_torch_containers.py`` (same data)."""
    rng = np.random.default_rng(21)
    cent = rng.standard_normal((6, 8)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 6, 3000)] + rng.standard_normal((3000, 8))).astype(np.float32)
    xq = (cent[rng.integers(0, 6, 30)] + rng.standard_normal((30, 8))).astype(np.float32)
    jidx = JaxIndexIVF(8, NLIST, storage="flat")
    jidx.train(xb)
    jidx.add(xb)
    return jidx, xq, "roc", {}


def pq_index():
    """The JAX IVF-PQ index of ``test_torch_pq.py`` (same data)."""
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((8, 16)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 8, 4000)] + rng.standard_normal((4000, 16))).astype(np.float32)
    xq = (cent[rng.integers(0, 8, 40)] + rng.standard_normal((40, 16))).astype(np.float32)
    jidx = JaxIndexIVF(16, NLIST, storage="pq", pq_m=4)
    jidx.train(xb)
    jidx.add(xb)
    return jidx, xq, "roc-interleaved", dict(interleave=4, interleave_min=64)


@pytest.mark.parametrize("make", [flat_index, pq_index], ids=["flat", "pq"])
def test_save_index_matches_jax(tmp_path, make):
    jidx, xq, name, kw = make()
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_save_index(jpath, jidx)
    tidx = load_index(jpath, device="cpu")
    save_index(tpath, tidx)
    assert tpath.read_bytes() == jpath.read_bytes()
    jidx2 = jax_load_index(tpath)
    tidx2 = load_index(tpath, device="cpu")
    assert jidx2.ntotal == tidx2.ntotal == jidx.ntotal
    for ln in range(NLIST):
        np.testing.assert_array_equal(jidx2.invlists.ids[ln], tidx2.invlists.ids[ln])
        np.testing.assert_array_equal(jidx2.invlists.codes[ln], tidx2.invlists.codes[ln])
    # the port's loaded index with a container that JAX wrote searches
    # exactly as the built pair, and as JAX's loaded index under the
    # near-tie rule (JAX's search with a ROC container compiles its decode
    # per bucket for seconds; its file is the port's byte for byte)
    jc = jinv.AVAILABLE_COMPRESSED_IVFS[name](jidx.invlists, **kw)
    tc = tinv.AVAILABLE_COMPRESSED_IVFS[name](tidx.invlists, **kw, device="cpu")
    tidx.replace_invlists(tc)
    D0, I0 = tidx.search(xq, 10, nprobe=4)
    jpath_c, tpath_c = tmp_path / "jax_container.npz", tmp_path / "port_container.npz"
    jser.save_invlists(jpath_c, jc)
    tser.save_invlists(tpath_c, tc)
    assert tpath_c.read_bytes() == jpath_c.read_bytes()
    tidx2.replace_invlists(tser.load_invlists(jpath_c, device="cpu"))
    D1, I1 = tidx2.search(xq, 10, nprobe=4)
    assert torch.equal(I1, I0) and torch.equal(D1, D0)
    D_ref, I_ref = jidx2.search(xq, 10, nprobe=4)
    assert_same_results(D1, I1, D_ref, I_ref)


def test_save_index_trained_only_and_unported(tmp_path):
    """A trained index without lists saves as JAX's, with the flat or the
    HNSW quantizer, and with QINCo storage (its codec's weights in the JAX
    package's leaf order); each loads back in the other package."""
    rng = np.random.default_rng(4)
    xb = rng.standard_normal((200, 8)).astype(np.float32)
    for quantizer in ("hnsw", "flat"):
        jidx = JaxIndexIVF(8, 4, storage="flat", quantizer=quantizer, quantizer_efSearch=16)
        jidx.train(xb)
        jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
        jax_save_index(jpath, jidx)
        tidx = IndexIVF(8, 4, quantizer=quantizer, quantizer_efSearch=16, device="cpu")
        tidx.centroids = torch.from_numpy(np.array(jidx.centroids))
        save_index(tpath, tidx)
        assert tpath.read_bytes() == jpath.read_bytes()
        loaded = load_index(tpath, device="cpu")
        assert loaded.ntotal == 0 and loaded.invlists is None
        assert (loaded.quantizer, loaded.quantizer_efSearch) == (quantizer, 16)
    # QINCo storage, trained only: the codec with JAX's initial weights
    jc = JaxQincoCodec(8, 3, ksub=16, hidden=8)
    jc.params = jc.model.init(jax.random.PRNGKey(1), jnp.asarray(xb[:8]))
    jidx = JaxIndexIVF(8, 4, storage="qinco", qinco=jc)
    jidx.centroids = xb[:4].copy()
    jax_save_index(jpath, jidx)
    loaded = load_index(jpath, device="cpu")
    assert loaded.ntotal == 0 and loaded.invlists is None and loaded.code_size == 3 + 4
    codes = rng.integers(0, 16, (10, 3))
    np.testing.assert_allclose(loaded.qinco.decode(codes).numpy(), jc.decode(codes),
                               rtol=1e-5, atol=1e-5)
    save_index(tpath, loaded)
    assert tpath.read_bytes() == jpath.read_bytes()
    np.testing.assert_array_equal(jax_load_index(tpath).qinco.decode(codes), jc.decode(codes))


# ---------------------------------------------------------------- integrity


def test_integrity_matches_jax(tmp_path):
    """The checksum of an artifact equals JAX's; stamp then verify gives
    True in both packages; the stamped files are byte-equal; a flipped byte
    in an array gives False; a path without .npz raises."""
    jc, tc = make_containers("elias-fano", *source_lists("full"))
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jser.save_invlists(jpath, jc)
    tser.save_invlists(tpath, tc)
    assert tint.artifact_checksum(tpath) == jint.artifact_checksum(jpath)
    assert not tint.verify_artifact(tpath)  # not stamped yet
    assert tint.stamp_artifact(tpath) == jint.stamp_artifact(jpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tint.verify_artifact(tpath) and jint.verify_artifact(tpath)
    assert tint.artifact_checksum(tpath) == jint.artifact_checksum(tpath)
    # the stamped artifact still loads, in both packages
    assert_loaded_equal(tser.load_invlists(tpath, device="cpu"), tc)
    with np.load(tpath) as z:
        arrs = dict(z)
    arrs["codes_flat"].view(np.uint8)[123] ^= 0x10
    np.savez(tpath, **arrs)
    assert not tint.verify_artifact(tpath) and not jint.verify_artifact(tpath)
    with pytest.raises(ValueError, match=".npz"):
        tint.stamp_artifact(tmp_path / "port")
    with pytest.raises(ValueError, match="vdbidc-tpu-v1"):
        np.savez(tmp_path / "other.npz", x=np.arange(3))
        tser.load_invlists(tmp_path / "other.npz", device="cpu")

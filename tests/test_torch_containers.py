"""The port's packed-bits, Elias-Fano and wavelet-tree containers, IVF and
graph, against the JAX package's, on the CPU.

IVF: a small flat index is built in JAX (d = 8, nlist = 16, nb = 3000,
nq = 30), saved with the JAX ``save_index`` and loaded into the port, so
both hold identical lists (ids ascending per list, as ``add`` gives them).
Each container (packed bits, Elias-Fano, wavelet tree with plain and with
RRR planes) must hold the same words, sizes and code order, and give the
same ``decode_lists``, ``get_single_ids_batch``, ``decode_select`` and
``get_single_id`` as the JAX container, exactly. Small hand-made lists add
empty lists, lists of one id and nlist of 1, 2 and 4. The searches with
``decode_1by1`` true and false must equal the JAX search under the near-tie
rule of ``tests/test_torch_ivf.py`` (distances within rtol 1e-5, atol 1e-4;
torch and XLA sum the dot products in another order), and the two
translates must give identical ids.

Graph: a seeded adjacency (degrees 0..K, distinct neighbours, -1 padded) in
both packages: ``CompactBitGraph`` and ``EliasFanoGraph`` must hold the JAX
words per node and the JAX sizes, return the JAX ``get_neighbors_batch``,
and ``search_graph_device`` over each must give the dense graph's I and D
exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import save_index
from vector_db_id_compression_tpu.store import graph as jgraph
from vector_db_id_compression_tpu.store import invlists as jinv
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.search.ivf import load_index
from vector_db_id_compression_tpu_torch.store import graph as tgraph
from vector_db_id_compression_tpu_torch.store import invlists as tinv
from test_torch_ivf import assert_same_results

D, NLIST, NB, NQ, K, NPROBE = 8, 16, 3000, 30, 10, 4
NAMES = ["packed-bits", "elias-fano", "wavelet-tree", "wavelet-tree-1"]


def u64(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint64)


def u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """(JAX index, port index loaded from its .npz, queries)."""
    rng = np.random.default_rng(21)
    cent = rng.standard_normal((6, D)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 6, NB)] + rng.standard_normal((NB, D))).astype(np.float32)
    xq = (cent[rng.integers(0, 6, NQ)] + rng.standard_normal((NQ, D))).astype(np.float32)
    jidx = JaxIndexIVF(D, NLIST, storage="flat")
    jidx.train(xb)
    jidx.add(xb)
    path = tmp_path_factory.mktemp("containers") / "index.npz"
    save_index(path, jidx)
    return jidx, load_index(path, device="cpu"), xq


@pytest.fixture(scope="module")
def containers(indexes):
    """name → (JAX container, port container) over the index's lists."""
    jidx, tidx, _ = indexes
    return {name: (jinv.AVAILABLE_COMPRESSED_IVFS[name](jidx.invlists),
                   tinv.AVAILABLE_COMPRESSED_IVFS[name](tidx.invlists, device="cpu"))
            for name in NAMES}


def small_lists(nlist: int):
    """Port and JAX InvertedLists over 300 ids: list 0 empty when nlist > 2,
    list 1 a single id, the rest drawn; code_size 2."""
    rng = np.random.default_rng(nlist)
    assign = rng.integers(0, nlist, 300)
    if nlist > 2:
        assign[assign == 0] = 2
        assign[assign == 1] = 2
        assign[7] = 1
    pair = []
    for mod in (jinv, tinv):
        il = mod.InvertedLists(nlist, 2)
        for ln in range(nlist):
            ids = np.flatnonzero(assign == ln).astype(np.uint64)
            il.add_entries(ln, ids, rng.integers(0, 256, 2 * len(ids)).astype(np.uint8)
                           if mod is jinv else pair[0].codes[ln])
        pair.append(il)
    return pair


def jax_rows(jc, name):
    """Per list: the JAX container's stored words (host arrays)."""
    rows = {}
    for ln, (bi, lane) in jc._list_to_bucket.items():
        if name == "packed-bits":
            rows[ln] = (np.asarray(jc._packed[bi].words[lane]),)
        else:
            ef = jc._efs[bi]
            rows[ln] = (np.asarray(ef.high.words[lane]), np.asarray(ef.low_words[lane]),
                        np.asarray(ef.high.sb_prefix[lane]))
    return rows


def assert_same_container(jc, tc, name):
    """Sizes, codes, words and every decode of ``tc`` equal ``jc``'s."""
    nlist = jc.nlist
    assert tc.supports_random_access is jc.supports_random_access is True
    assert tc.compressed_ids_size_in_bytes == jc.compressed_ids_size_in_bytes
    assert tc.overhead_in_bytes == jc.overhead_in_bytes
    for ln in range(nlist):
        np.testing.assert_array_equal(tc.get_codes(ln), jc.get_codes(ln))
    if name in ("packed-bits", "elias-fano"):
        for ln, want in jax_rows(jc, name).items():
            got = ((u32(tc.packed.words[ln]),) if name == "packed-bits" else
                   (u32(tc.ef.high.words[ln]), u32(tc.ef.low_words[ln]),
                    tc.ef.high.sb_prefix[ln].numpy()))
            for g, w in zip(got, want):
                n = min(len(g), len(w))
                np.testing.assert_array_equal(g[:n], w[:n])
                # past the shorter row, only padding: zero words, or the
                # directory's running total
                tail = g[n:] if len(g) > n else w[n:]
                assert (tail == (w[-1] if g is got[-1] and name == "elias-fano" else 0)).all()
    elif tc.wt_type == 0:
        np.testing.assert_array_equal(u32(tc.wt.words), np.asarray(jc.wt.words))
        np.testing.assert_array_equal(tc.wt.sb_prefix.numpy(), np.asarray(jc.wt.sb_prefix))
        np.testing.assert_array_equal(tc.wt_tables.numpy(), np.asarray(jc.wt_tables))
    else:
        np.testing.assert_array_equal(tc.wt.classes.numpy(), np.asarray(jc.wt.classes))
        np.testing.assert_array_equal(u32(tc.wt.off_words), np.asarray(jc.wt.off_words))
        np.testing.assert_array_equal(tc.wt.sb_rank.numpy(), np.asarray(jc.wt.sb_rank))
        np.testing.assert_array_equal(tc.wt.sb_off_start.numpy(), np.asarray(jc.wt.sb_off_start))
    lists = np.arange(nlist)
    jids, jlens = jc.decode_lists(lists)
    tids, tlens = tc.decode_lists(torch.from_numpy(lists))
    np.testing.assert_array_equal(tlens.numpy(), jlens)
    np.testing.assert_array_equal(u64(tids), jids)
    # random labels over the nonempty lists
    rng = np.random.default_rng(nlist)
    lens = jc.lengths
    lns = rng.choice(np.flatnonzero(lens > 0), 200)
    offs = (rng.random(200) * lens[lns]).astype(np.int64)
    want = jc.get_single_ids_batch(lns, offs)
    np.testing.assert_array_equal(u64(tc.get_single_ids_batch(lns, offs)), want)
    np.testing.assert_array_equal(u64(tc.decode_select(torch.from_numpy(lns),
                                                       torch.from_numpy(offs))),
                                  jc.decode_select(lns, offs))
    assert tc.get_single_id(int(lns[0]), int(offs[0])) == jc.get_single_id(int(lns[0]),
                                                                           int(offs[0]))


@pytest.mark.parametrize("name", NAMES)
def test_container_matches_jax(containers, name):
    assert_same_container(*containers[name], name)


@pytest.mark.parametrize("nlist", [1, 2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_small_lists_match_jax(name, nlist):
    """Empty lists, a list of one id, and nlist of 1, 2 and 4."""
    jil, til = small_lists(nlist)
    assert_same_container(jinv.AVAILABLE_COMPRESSED_IVFS[name](jil),
                          tinv.AVAILABLE_COMPRESSED_IVFS[name](til, device="cpu"), name)


@pytest.mark.parametrize("name", NAMES)
def test_search_both_translates_match_jax(indexes, containers, name):
    """decode_1by1 true and false: equal to the JAX search under the
    near-tie rule, and the two translates give identical ids."""
    jidx, tidx, xq = indexes
    jc, tc = containers[name]
    jidx.replace_invlists(jc)
    tidx.replace_invlists(tc)
    try:
        results = {}
        for one_by_one in (True, False):
            D_ref, I_ref = jidx.search_defer_id_decoding(xq, K, nprobe=NPROBE,
                                                         decode_1by1=one_by_one)
            D_got, I_got = tidx.search_defer_id_decoding(xq, K, nprobe=NPROBE,
                                                         decode_1by1=one_by_one)
            assert_same_results(D_got, I_got, D_ref, I_ref)
            results[one_by_one] = (D_got, I_got)
        assert torch.equal(results[True][1], results[False][1])
        assert torch.equal(results[True][0], results[False][0])
        # none of these reorders an ascending list: the uncompressed search's
        # scan storage, so its results exactly
        D0, I0 = tidx.search_defer_id_decoding(xq, K, nprobe=NPROBE)
        tidx.replace_invlists(tidx.invlists)
        D1, I1 = tidx.search(xq, K, nprobe=NPROBE)
        assert torch.equal(I0, I1) and torch.equal(D0, D1)
    finally:
        jidx.replace_invlists(jidx.invlists)
        tidx.replace_invlists(tidx.invlists)


def test_random_access_translate_equals_grouped(indexes, containers):
    """The translate's two routes over one set of labels, per container,
    and the default (None) takes the random-access route."""
    _, tidx, xq = indexes
    for name in NAMES:
        tc = containers[name][1]
        tidx.replace_invlists(tc)
        _, L = tidx.search_positional(xq, K, NPROBE)
        assert torch.equal(tidx._translate(L, True), tidx._translate(L, False))
    tidx.replace_invlists(tidx.invlists)


def test_registry_and_input_checks():
    assert set(tinv.AVAILABLE_COMPRESSED_IVFS) == set(jinv.AVAILABLE_COMPRESSED_IVFS)
    il = tinv.InvertedLists(2, 0)
    il.add_entries(0, np.array([3, 1], np.uint64), np.zeros(0, np.uint8))
    il.add_entries(1, np.array([0, 9], np.uint64), np.zeros(0, np.uint8))
    with pytest.raises(ValueError, match="ntotal"):
        tinv.PackedBitsInvertedLists(il, device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        tinv.WaveletTreeInvertedLists(il, device="cpu")
    with pytest.raises(ValueError, match="wt_type"):
        tinv.WaveletTreeInvertedLists(il, wt_type=2, device="cpu")
    big = tinv.InvertedLists(1, 0)
    big.add_entries(0, np.array([1, 2**63], np.uint64), np.zeros(0, np.uint8))
    with pytest.raises(ValueError, match="2\\^63"):
        tinv.EliasFanoInvertedLists(big, device="cpu")
    roc = tinv.RocInvertedLists(il, device="cpu")
    with pytest.raises(NotImplementedError, match="random access"):
        roc.get_single_ids_batch([0], [0])


# ------------------------------------------------------------------- graph

GN, GK = 400, 12


@pytest.fixture(scope="module")
def graphs():
    """A seeded -1-padded adjacency (degrees 0..K, node 0 isolated but
    reachable from none, distinct neighbours) in both packages, vectors and
    queries."""
    rng = np.random.default_rng(31)
    adj = np.full((GN, GK), -1, np.int32)
    deg = rng.integers(1, GK + 1, GN)
    deg[:4] = [0, 1, GK, GK - 1]
    for i in range(GN):
        adj[i, : deg[i]] = rng.choice(np.arange(1, GN), deg[i], replace=False)
    xb = rng.standard_normal((GN, 6)).astype(np.float32)
    xq = rng.standard_normal((20, 6)).astype(np.float32)
    jg = jgraph.Graph(adj)
    tg = tgraph.Graph(adj, device="cpu")
    return SimpleNamespace(adj=adj, xb=xb, xq=xq, jg=jg, tg=tg)


@pytest.mark.parametrize("name", ["CompactBitGraph", "EliasFanoGraph"])
def test_graph_container_matches_jax(graphs, name):
    jc = getattr(jgraph, name)(graphs.jg)
    tc = getattr(tgraph, name)(graphs.tg)
    assert tc.compressed_ids_size_in_bytes == jc.compressed_ids_size_in_bytes
    assert tc.overhead_in_bytes == jc.overhead_in_bytes
    if name == "CompactBitGraph":
        assert (tc.bits, tc.stride) == (jc.bits, jc.stride)
        np.testing.assert_array_equal(u32(tc.words), np.asarray(jc._words))
    else:
        np.testing.assert_array_equal(u32(tc.ef.high.words), np.asarray(jc._ef.high.words))
        np.testing.assert_array_equal(tc.ef.high.sb_prefix.numpy(),
                                      np.asarray(jc._ef.high.sb_prefix))
        np.testing.assert_array_equal(u32(tc.ef.low_words), np.asarray(jc._ef.low_words))
        np.testing.assert_array_equal(tc.ef.l.numpy(), np.asarray(jc._ef.l))
    nodes = np.array([0, 1, 2, 3, 399, 17, 17, 250])
    jnb, jcnt = jc.get_neighbors_batch(nodes)
    tnb, tcnt = tc.get_neighbors_batch(torch.from_numpy(nodes))
    np.testing.assert_array_equal(tnb.numpy(), jnb)
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    # the dense graph's neighbour sets
    dense, _ = graphs.tg.get_neighbors_batch(torch.from_numpy(nodes))
    np.testing.assert_array_equal(np.sort(tnb.numpy(), 1), np.sort(dense.numpy(), 1))
    np.testing.assert_array_equal(tc.get_neighbors(3).numpy(), jc.get_neighbors(3))


@pytest.mark.parametrize("name", ["CompactBitGraph", "EliasFanoGraph"])
def test_graph_search_equals_dense(graphs, name):
    D0, I0 = search_graph_device(graphs.tg, graphs.xb, graphs.xq, 5, entry=1)
    D1, I1 = search_graph_device(getattr(tgraph, name)(graphs.tg), graphs.xb, graphs.xq, 5,
                                 entry=1)
    assert torch.equal(I1, I0) and torch.equal(D1, D0)
    assert int(I0.min()) >= 0

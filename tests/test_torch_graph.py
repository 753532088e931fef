"""The port's graph path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the graph
is the fixture of tests/test_graph_device.py (N = 500, d = 10, R = 10,
nq = 15, k = 5, seed 13), built once in JAX and carried into the port as its
adjacency array.

- Chained ROC codec (the plain version of both kernels' chained mode): the
  same head, stack words, stack length, MT19937 draw count and ids as the
  JAX codec, exactly.
- Containers: from one adjacency, RocGraph and RocBlockGraph give the same
  streams, sizes and neighbour lists in both packages.
- Search: the same labels as the JAX host search. Tolerance: distances agree
  to rtol 1e-5, as between the JAX host and device searches
  (tests/test_graph_device.py), since torch and XLA sum the squared
  differences in another order. Near-tie rule: a label may differ from the
  JAX label only where the JAX distances on either side of it lie within that
  tolerance — the packages then rank two almost equidistant nodes in the
  other order.
- build_nsg: the same medoid, and the same neighbour set per row except where
  the kNN distances tie at the candidate boundary within that tolerance.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.codecs import roc_device as rd
from vector_db_id_compression_tpu.codecs.roc import precision_for_max_id_safe
from vector_db_id_compression_tpu.search import nsg as jnsg
from vector_db_id_compression_tpu.store import graph as jgraph
from vector_db_id_compression_tpu_torch.codecs import roc_device as td
from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_ids_safe
from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
from vector_db_id_compression_tpu_torch.search import nsg
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.store.graph import Graph, RocBlockGraph, RocGraph

N, D, NQ, K, R = 500, 10, 15, 5, 10
RTOL = 1e-5

# (lanes, slots, n_max, id bits, seed, forced lengths of the first slots);
# the other lengths are drawn in [0, n_max], as tests/test_roc_pallas.py does
CHAINED_CASES = [
    (5, 4, 16, 18, 11, []),                               # test_roc_pallas.py:86-107
    (6, 1, 12, 20, 3, []),                                # S = 1: the per-list stream
    (3, 5, 8, 20, 4, [0] * 15),                           # every slot empty
    (4, 6, 20, "near32", 5, [20, 1]),                     # ids near 2^32
    (8, 16, 32, 20, 6, [0, 1, 2, 4, 8, 16, 32, 0, 31]),   # the graph's block shape
]
CHAINED_IDS = ["pallas-case", "S=1", "all-empty", "near-2^32", "16x32"]


def make_chained_batch(case_no: int):
    """ids u64[L, S, n_max] (slot ids ascending), lengths i32[L, S], safe
    precisions i32[L, S] (1 for empty slots, as RocBlockGraph gives them)."""
    L, S, n_max, bits, seed, forced = CHAINED_CASES[case_no]
    rng = np.random.default_rng(seed)
    ids = np.zeros((L, S, n_max), dtype=np.uint64)
    lengths = np.zeros((L, S), dtype=np.int32)
    prec = np.ones((L, S), dtype=np.int32)
    for b in range(L):
        for s in range(S):
            n = int(rng.integers(0, n_max + 1))
            if b * S + s < len(forced):
                n = forced[b * S + s]
            lengths[b, s] = n
            if n == 0:
                continue
            if bits == "near32":
                v = np.uint64(2**32 - 1) - rng.choice(5000, n, replace=False).astype(np.uint64)
            else:
                v = rng.choice(2**bits - 1, size=n, replace=False).astype(np.uint64) + 1
            ids[b, s, :n] = np.sort(v)
            prec[b, s] = precision_for_max_id_safe(int(v.max()))
    return ids, lengths, prec


def _shape(case_no):
    ids, lengths, prec = make_chained_batch(case_no)
    L, S, n_max = ids.shape
    maxp = int(prec.max())
    return ids, lengths, prec, rd.stack_capacity(S * n_max, maxp), rd.n_slices_for(maxp)


def jax_chained(case_no: int):
    """JAX chained encode + decode → (states, ids u64[L, S, n_max], final)."""
    ids, lengths, prec, cap, ns = _shape(case_no)
    L, S, n_max = ids.shape
    pool = rd.default_pool(S * n_max)
    st = rd.roc_encode_chained(jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec),
                               pool, rd.fresh_states(L, cap), ns)
    dec, final = rd.roc_decode_chained(st, jnp.asarray(lengths), jnp.asarray(prec),
                                       pool, n_max, ns)
    return st, np.asarray(dec), final


def port_chained_encode(case_no: int) -> td.RocStates:
    ids, lengths, prec, cap, ns = _shape(case_no)
    L, S, n_max = ids.shape
    return td.roc_encode_chained(
        torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths),
        torch.from_numpy(prec), td.default_pool(S * n_max), td.fresh_states(L, cap), ns)


def assert_same_stream(states: td.RocStates, ref) -> None:
    """Port states (torch) equal JAX states, exactly."""
    np.testing.assert_array_equal(states.head.numpy().view(np.uint64), np.asarray(ref.head))
    np.testing.assert_array_equal(states.stack_len.numpy(), np.asarray(ref.stack_len))
    np.testing.assert_array_equal(states.mt_ctr.numpy(), np.asarray(ref.mt_ctr))
    words, ref_words = states.stack.numpy().view(np.uint32), np.asarray(ref.stack)
    for b, n in enumerate(states.stack_len.numpy()):
        np.testing.assert_array_equal(words[b, :n], ref_words[b, :n])
    assert not bool(states.err.any()) and not bool(np.asarray(ref.err).any())


# ------------------------------------------------------------ chained codec


@pytest.mark.parametrize("case_no", range(len(CHAINED_CASES)), ids=CHAINED_IDS)
def test_chained_encode_matches_jax(case_no):
    st, _, _ = jax_chained(case_no)
    assert_same_stream(port_chained_encode(case_no), st)


@pytest.mark.parametrize("case_no", range(len(CHAINED_CASES)), ids=CHAINED_IDS)
def test_chained_decode_matches_jax(case_no):
    ids, lengths, prec, _, ns = _shape(case_no)
    _, ref, ref_final = jax_chained(case_no)
    n_max = ids.shape[2]
    dec, final = td.roc_decode_chained(
        port_chained_encode(case_no), torch.from_numpy(lengths), torch.from_numpy(prec),
        td.default_pool(ids.shape[1] * n_max), n_max, ns)
    np.testing.assert_array_equal(dec.numpy().view(np.uint64), ref)
    assert_same_stream(final, ref_final)
    # lossless: each slot decodes to its id set
    for b, s in np.ndindex(*lengths.shape):
        n = lengths[b, s]
        np.testing.assert_array_equal(np.sort(dec.numpy()[b, s, :n]).view(np.uint64),
                                      ids[b, s, :n])


def test_chained_one_slot_is_the_per_list_stream():
    """S = 1 reproduces the per-list (RocGraph) stream bit for bit."""
    case_no = CHAINED_IDS.index("S=1")
    ids, lengths, prec, cap, ns = _shape(case_no)
    L, _, n_max = ids.shape
    st, _ = rd.roc_encode_batch(jnp.asarray(ids[:, 0]), jnp.asarray(lengths[:, 0]),
                                jnp.asarray(prec[:, 0]), rd.default_pool(n_max),
                                rd.fresh_states(L, cap), ns)
    assert_same_stream(port_chained_encode(case_no), st)


def test_chained_wrappers_run_plain_version_on_cpu():
    """RocEncoder.encode_chained and a RocDecoder over [L, S] tables give the
    plain version's result on CPU tensors and launch no kernel."""
    case_no = 0
    ids, lengths, prec, _, _ = _shape(case_no)
    S, n_max = ids.shape[1:]
    before = (RocEncoder.chained_launches, RocDecoder.chained_launches)
    lengths_t, prec_t = torch.from_numpy(lengths), torch.from_numpy(prec)
    states = RocEncoder.encode_chained(torch.from_numpy(ids.view(np.int64)), lengths_t, prec_t)
    st, ref, _ = jax_chained(case_no)
    assert_same_stream(states, st)
    dec = RocDecoder(states, lengths_t, prec_t, td.default_pool(S * n_max), n_max)
    np.testing.assert_array_equal(dec.decode().numpy().view(np.uint64), ref)
    lanes = torch.tensor([4, 0, 4])
    np.testing.assert_array_equal(dec.decode_lanes(lanes).numpy().view(np.uint64),
                                  ref[lanes.numpy()])
    assert (RocEncoder.chained_launches, RocDecoder.chained_launches) == before


def test_chained_pallas_kernel_interpret_small():
    """The port's chained decode against the chained Pallas kernel
    (RocChainedPallasDecoder), run in interpret mode as
    tests/test_roc_pallas.py runs it."""
    from vector_db_id_compression_tpu.ops.roc_pallas import RocChainedPallasDecoder

    case_no = 0
    ids, lengths, prec, _, ns = _shape(case_no)
    S, n_max = ids.shape[1:]
    st, _, _ = jax_chained(case_no)
    got, ok = RocChainedPallasDecoder(st, lengths, prec, rd.default_pool(S * n_max),
                                      n_max).decode(interpret=True)
    assert ok
    dec, _ = td.roc_decode_chained(
        port_chained_encode(case_no), torch.from_numpy(lengths), torch.from_numpy(prec),
        td.default_pool(S * n_max), n_max, ns)
    np.testing.assert_array_equal(dec.numpy().view(np.uint64),
                                  np.asarray(got).astype(np.uint64))


@pytest.mark.parametrize("max_id", [1, 2, 3, 255, 256, 257, 2**20, 2**31 - 1, 2**32, 2**40 + 3])
def test_vectorized_precision_rule(max_id):
    got = precision_for_max_ids_safe(torch.tensor([max_id, max_id]))
    assert got.dtype == torch.int32
    assert got.tolist() == [precision_for_max_id_safe(max_id)] * 2


# ------------------------------------------------------------ containers


@pytest.fixture(scope="module")
def setup():
    """The JAX graph, its host-search result, and the port's Graph."""
    rng = np.random.default_rng(13)
    xb = rng.normal(size=(N, D)).astype(np.float32)
    xq = rng.normal(size=(NQ, D)).astype(np.float32)
    jg, medoid = jnsg.build_nsg(xb, R=R)
    D_h, I_h, _ = jnsg.search_graph(jg, xb, xq, K, entry=medoid)
    return xb, xq, jg, medoid, D_h, I_h, Graph(jg.adjacency)


def _roc_block4(graph):
    return (jgraph.RocBlockGraph(graph, block=4) if isinstance(graph, jgraph.Graph)
            else RocBlockGraph(graph, block=4))


def _roc(graph):
    return jgraph.RocGraph(graph) if isinstance(graph, jgraph.Graph) else RocGraph(graph)


CONTAINERS = [_roc, _roc_block4]
CONTAINER_IDS = ["RocGraph", "RocBlockGraph4"]


@pytest.fixture(scope="module")
def containers(setup):
    """{name: (JAX container, port container)} from one adjacency."""
    jg, tg = setup[2], setup[6]
    return {name: (make(jg), make(tg)) for name, make in zip(CONTAINER_IDS, CONTAINERS)}


@pytest.mark.parametrize("name", CONTAINER_IDS)
def test_container_matches_jax(containers, name):
    jc, tc = containers[name]
    assert_same_stream(tc.decoder.states, jc._states)
    assert tc.compressed_ids_size_in_bytes == jc.compressed_ids_size_in_bytes
    assert tc.overhead_in_bytes == jc.overhead_in_bytes
    np.testing.assert_array_equal(tc.degrees.numpy(), jc.degrees)
    nodes = np.array([0, 7, N - 1, 7, 123, 3, 250])
    nb, cnt = tc.get_neighbors_batch(torch.from_numpy(nodes))
    jnb, jcnt = jc.get_neighbors_batch(nodes)
    np.testing.assert_array_equal(nb.numpy(), jnb)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    np.testing.assert_array_equal(tc.get_neighbors(7).numpy(), jc.get_neighbors(7))


def test_block_of_one_is_the_per_node_stream(setup, containers):
    """RocBlockGraph(block=1) reproduces RocGraph's stream, apart from
    the empty nodes' precision (1 against 0), which encodes nothing."""
    one = RocBlockGraph(setup[6], block=1)
    per_node = containers["RocGraph"][1].decoder.states
    for field in ("head", "stack_len", "mt_ctr"):
        assert torch.equal(getattr(one.decoder.states, field), getattr(per_node, field))
    assert one.compressed_ids_size_in_bytes == containers["RocGraph"][1].compressed_ids_size_in_bytes


@pytest.mark.parametrize("name", CONTAINER_IDS)
def test_duplicate_neighbour_raises_in_both(setup, name):
    adj = setup[2].adjacency.copy()
    adj[3, 1] = adj[3, 0]
    make = CONTAINERS[CONTAINER_IDS.index(name)]
    with pytest.raises(ValueError, match="duplicate neighbor ids in adjacency row 3"):
        make(jgraph.Graph(adj))
    with pytest.raises(ValueError, match="duplicate neighbor ids in adjacency row 3"):
        make(Graph(adj))


# ------------------------------------------------------------ search


def assert_same_results(D_port, I_port, D_ref, I_ref, rtol=RTOL):
    """D within rtol; I equal under the near-tie rule (module doc)."""
    D_port, I_port = np.asarray(D_port), np.asarray(I_port)
    k = I_ref.shape[1]
    np.testing.assert_allclose(D_port, D_ref, rtol=rtol)
    for i, j in zip(*np.nonzero(I_port != I_ref)):
        near = [D_ref[i, jj] for jj in (j - 1, j + 1) if 0 <= jj < k] + [D_port[i, j]]
        assert any(abs(D_ref[i, j] - x) <= rtol * abs(x) for x in near), \
            f"query {i} slot {j}: label differs without a near tie"


GRAPHS = [lambda tg: tg, RocGraph, lambda tg: RocBlockGraph(tg, block=4)]
GRAPH_IDS = ["Graph", "RocGraph", "RocBlockGraph4"]


@pytest.mark.parametrize("make", GRAPHS, ids=GRAPH_IDS)
def test_device_search_matches_jax(setup, make):
    xb, xq, _, medoid, D_h, I_h, tg = setup
    D_d, I_d = search_graph_device(make(tg), xb, xq, K, entry=medoid)
    assert D_d.dtype == torch.float32 and I_d.dtype == torch.int64
    assert_same_results(D_d, I_d, D_h, I_h)


@pytest.mark.parametrize("make", GRAPHS, ids=GRAPH_IDS)
def test_host_search_matches_jax(setup, make):
    xb, xq, _, medoid, D_h, I_h, tg = setup
    D_p, I_p, _ = nsg.search_graph(make(tg), xb, xq, K, entry=medoid)
    assert_same_results(D_p, I_p, D_h, I_h)


def test_device_search_equals_host_search_per_query_entry(setup):
    """Per-query entries, and a pool larger than 2k: the device loop gives
    the host loop's result exactly."""
    xb, xq, _, _, _, _, tg = setup
    entries = torch.arange(NQ) * 31 % N
    roc = RocGraph(tg)
    D_d, I_d = search_graph_device(roc, xb, xq, K, L=16, entry=entries)
    for q in range(NQ):
        D_q, I_q, _ = nsg.search_graph(roc, xb, xq[q:q + 1], K, L=16, entry=int(entries[q]))
        assert torch.equal(I_d[q:q + 1], I_q)
        assert torch.equal(D_d[q:q + 1], D_q)


def test_search_and_trace_matches_jax(setup):
    xb, xq, jg, medoid, _, _, tg = setup
    jI, jD, jvisited = jnsg.search_and_trace(jg, xb, xq, K, entry=medoid)
    I, D_, visited = nsg.search_and_trace(tg, xb, xq, K, entry=medoid)
    assert_same_results(D_, I, jD, jI)
    np.testing.assert_array_equal(visited.numpy(), jvisited)


def test_max_iters_cap_warns_and_keeps_the_entry_pool(setup):
    """A tiny max_iters warns, and still returns the pool seeded at the
    entry."""
    xb, xq, _, medoid, _, I_h, tg = setup
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        D_d, I_d = search_graph_device(tg, xb, xq, K, entry=medoid, max_iters=2)
    assert any(issubclass(w.category, RuntimeWarning) and "max_iters=2" in str(w.message)
               for w in caught)
    assert I_d.shape == I_h.shape
    assert bool((I_d[:, 0] >= 0).all()) and bool(torch.isfinite(D_d[:, 0]).all())


# ------------------------------------------------------------ construction


def test_build_nsg_matches_jax(setup):
    xb, _, jg, medoid, _, _, _ = setup
    g, m = nsg.build_nsg(xb, R=R)
    assert m == medoid
    knn = min(max(2 * R, 32), N - 1)
    d2 = ((xb[:, None, :].astype(np.float64) - xb[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    boundary = np.sort(d2, axis=1)[:, knn - 1: knn + 1]
    A, B = g.adjacency.numpy(), jg.adjacency
    for i in range(N):
        if set(A[i][A[i] >= 0]) != set(B[i][B[i] >= 0]):
            lo, hi = boundary[i]
            assert hi - lo <= RTOL * hi, f"row {i} differs without a tie at the kNN boundary"


def test_build_nsg_does_not_depend_on_block(setup):
    xb = setup[0]
    g, m = nsg.build_nsg(xb, R=R)
    g_small, m_small = nsg.build_nsg(xb, R=R, block=37)
    assert m == m_small
    assert torch.equal(g.adjacency, g_small.adjacency)


def test_ensure_connected_matches_jax():
    """The vectorized repair writes what the JAX host loop writes, on a graph
    of four disconnected cliques with full and partly full rows."""
    rng = np.random.default_rng(2)
    n, r = 64, 6
    xb = rng.normal(size=(n, 4)).astype(np.float32)
    adj = np.full((n, r), -1, dtype=np.int32)
    for c in range(4):
        members = np.arange(c * 16, (c + 1) * 16)
        for u in members:
            deg = int(rng.integers(1, r + 1))
            adj[u, :deg] = rng.choice(members[members != u], deg, replace=False)
    want = jnsg._ensure_connected(adj.copy(), xb, 5)
    got = nsg._ensure_connected(torch.from_numpy(adj.copy()), torch.from_numpy(xb), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, adj)

"""The port's REC bits per edge (``codecs/rec.py``) against the JAX
package's, on the CPU.

On the cases of ``tests/test_rec.py`` (random edge lists of 12, 8 and 100
nodes, alpha 1 and 0.5, directed and undirected) and on a random -1-padded
adjacency of 500 nodes: the edge list, the degrees, the sequence bits and
the bits per edge equal JAX's, the floats within 1e-12 relative (both sum
float64 log-gammas over the same degrees, in other orders).
"""

import math

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.codecs import rec as jrec
from vector_db_id_compression_tpu_torch.codecs import rec as trec

RTOL = 1e-12


def close(a: float, b: float) -> bool:
    return abs(a - b) <= RTOL * max(1.0, abs(b))


@pytest.mark.parametrize("seed,n,m", [(3, 12, 30), (4, 8, 20), (5, 100, 400)])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("undirected", [False, True])
def test_bpe_matches_jax(seed, n, m, alpha, undirected):
    edges = np.random.default_rng(seed).integers(0, n, size=(m, 2))
    jm = jrec.PolyasUrnModel(n, m, undirected=undirected, alpha=alpha)
    tm = trec.PolyasUrnModel(n, m, undirected=undirected, alpha=alpha)
    jdeg = jrec.degrees_from_edges(edges, n)
    tdeg = trec.degrees_from_edges(torch.from_numpy(edges), n)
    np.testing.assert_array_equal(tdeg.numpy(), jdeg)
    assert close(tm.sequence_bits(tdeg), jm.sequence_bits(jdeg))
    assert close(tm.bits_back_savings(), jm.bits_back_savings())
    jt, jb = jm.compute_bpe(jrec.Graph(edges, n, m))
    tt, tb = tm.compute_bpe(trec.Graph(torch.from_numpy(edges), n, m))
    assert close(tt, jt) and close(tb, jb)


def test_padded_graph_matches_jax():
    """A random adjacency of 500 nodes, degree 0..24 of 24 slots, -1 padded:
    the edge list and the bits per edge of the directed graph equal JAX's."""
    rng = np.random.default_rng(9)
    n, width = 500, 24
    adj = np.full((n, width), -1, np.int32)
    for v in range(n):
        deg = rng.integers(0, width + 1)
        adj[v, :deg] = rng.choice(n, deg, replace=False)
    jedges = jrec.friend_to_edgelist_repr(adj)
    tedges = trec.friend_to_edgelist_repr(torch.from_numpy(adj))
    assert tedges.dtype == torch.int64
    np.testing.assert_array_equal(tedges.numpy(), jedges)
    m = len(jedges)
    _, jb = jrec.PolyasUrnModel(n, m).compute_bpe(jrec.Graph(jedges, n, m))
    _, tb = trec.PolyasUrnModel(n, m).compute_bpe(trec.Graph(tedges, n, m))
    assert close(tb, jb)
    assert 0 < tb < 2 * math.log2(n)


def test_friend_lists_and_checks():
    """A list of friend arrays gives JAX's edge list; an empty graph none;
    degrees that do not sum to 2m raise."""
    friends = [np.array([1, 2, -1]), np.array([0]), np.array([], np.int64), np.array([3, 0])]
    np.testing.assert_array_equal(trec.friend_to_edgelist_repr(friends).numpy(),
                                  jrec.friend_to_edgelist_repr(friends))
    assert trec.friend_to_edgelist_repr(torch.full((3, 2), -1)).shape == (0, 2)
    with pytest.raises(ValueError, match="2 \\* num_edges"):
        trec.PolyasUrnModel(4, 3).sequence_bits(torch.tensor([1, 1, 1, 1]))

"""The port's dense all-pairs scan against the JAX package's, on the CPU.

``search_positional`` scans a size bucket densely (every query against
every list of the bucket, the probed pairs gathered after) where the probed
pairs are at least a quarter of all its (query, list) pairs, as the JAX
package's ``_scan_flat_allpairs`` switch does. On ``test_torch_ivf.py``'s
flat index (d 16, nlist 32, 5000 vectors, 50 queries; four size buckets),
loaded from the JAX index's file:
  - nprobe = nlist: every bucket goes dense in both packages;
  - nprobe 8: two buckets go dense and two take the pair scan;
  - ``SCAN_BUDGET`` lowered (``VDBIDC_SCAN_BUDGET`` for JAX) so that a slab
    holds fewer lists than its bucket.
Each agrees with JAX under the near-tie rule of ``test_torch_ivf.py`` (rtol
1e-5, atol 1e-4: torch and XLA sum the products in other orders). A spy on
the two scans counts the buckets each took.
"""

import pytest

from test_torch_ivf import K, NLIST, assert_same_results, data, indexes  # noqa: F401
from vector_db_id_compression_tpu_torch.search import ivf


@pytest.fixture
def paths(monkeypatch):
    """The buckets (by identity) each scan was called on."""
    seen = {"dense": set(), "pairs": set()}
    dense, pairs = ivf._scan_flat_dense, ivf._scan_flat_pairs

    def dense_spy(xq, sb, k):
        seen["dense"].add(id(sb))
        return dense(xq, sb, k)

    def pairs_spy(xq, sb, *args):
        seen["pairs"].add(id(sb))
        return pairs(xq, sb, *args)

    monkeypatch.setattr(ivf, "_scan_flat_dense", dense_spy)
    monkeypatch.setattr(ivf, "_scan_flat_pairs", pairs_spy)
    return seen


@pytest.mark.parametrize("nprobe,n_dense,n_pairs", [(NLIST, 4, 0), (8, 2, 2)])
def test_dense_scan_matches_jax(data, indexes, paths, nprobe, n_dense, n_pairs):  # noqa: F811
    _, xq = data
    jidx, tidx = indexes
    assert len(tidx._scan) == 4
    D_ref, L_ref = jidx.search_positional(xq, K, nprobe=nprobe)
    D_got, L_got = tidx.search_positional(xq, K, nprobe=nprobe)
    assert (len(paths["dense"]), len(paths["pairs"])) == (n_dense, n_pairs)
    assert_same_results(D_got, L_got, D_ref, L_ref)


def test_dense_scan_in_slabs_matches_jax(data, indexes, paths, monkeypatch):  # noqa: F811
    """A budget of 3 lists of the narrowest bucket per slab (one list of
    the wider ones): the buckets of 17 and 12 lists go dense in several
    slabs."""
    _, xq = data
    jidx, tidx = indexes
    budget = len(xq) * min(sb.n_pad for sb in tidx._scan) * 3
    assert [len(sb.lengths) for sb in tidx._scan] == [17, 12, 2, 1]
    monkeypatch.setattr(ivf, "SCAN_BUDGET", budget)
    monkeypatch.setenv("VDBIDC_SCAN_BUDGET", str(budget))
    jidx.replace_invlists(jidx.invlists)  # JAX cuts its buckets by the budget
    try:
        D_ref, L_ref = jidx.search_positional(xq, K, nprobe=NLIST)
    finally:
        monkeypatch.delenv("VDBIDC_SCAN_BUDGET")
        jidx.replace_invlists(jidx.invlists)
    D_got, L_got = tidx.search_positional(xq, K, nprobe=NLIST)
    assert len(paths["dense"]) == 4 and not paths["pairs"]
    assert_same_results(D_got, L_got, D_ref, L_ref)

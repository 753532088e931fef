"""The port's k-means update: a segmented sum in a fixed order.

``search/kmeans.py`` ``cluster_sums`` adds each cluster's rows one by one in
row order, from zero. On the CPU that is ``index_add_``'s order, so the sums,
and every centroid built on them, equal what ``index_add_`` gave bit for bit;
on the card it is an order that does not change from run to run (the
two-runs check is ``test_torch_cuda.py`` ``test_train_kmeans_reproducible``).
About a second on the CPU.
"""

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu_torch.search import kmeans
from vector_db_id_compression_tpu_torch.search.kmeans import cluster_sums, train_kmeans


def skewed_assignment(n: int, k: int, seed: int, empty=()):
    """i64[n] cluster numbers whose cluster sizes differ by two orders of
    magnitude (a Zipf draw), with the clusters ``empty`` (not k // 2) left
    empty."""
    rng = np.random.default_rng(seed)
    a = np.minimum(rng.zipf(1.3, n) - 1, k - 1)
    a[np.isin(a, empty)] = k // 2
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("n,k,d,empty", [(3000, 37, 16, ()), (5000, 64, 128, (0, 5, 63))],
                         ids=["unequal-sizes", "empty-clusters"])
def test_cluster_sums_equal_index_add(n, k, d, empty):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    a = skewed_assignment(n, k, n + 1, empty)
    counts_want = torch.bincount(a, minlength=k)
    assert int(counts_want.max()) > 50 * max(int(counts_want[counts_want > 0].min()), 1)
    for c in empty:
        assert counts_want[c] == 0
    sums, counts = cluster_sums(x, a, k)
    want = torch.zeros((k, d)).index_add_(0, a, x)
    assert torch.equal(counts, counts_want)
    torch.testing.assert_close(sums, want, rtol=0, atol=0)  # the same order: bit-equal
    assert not bool(sums[list(empty)].any())


def test_train_kmeans_centroids_as_with_index_add(monkeypatch):
    """Centroids from the fixed-order sum equal those of the scatter-add
    update it replaced, on the CPU, through every iteration, and two calls
    give the same bits."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4000, 24)).astype(np.float32)
    x[:1500] += 4.0  # a dense region: clusters of unequal size
    got = train_kmeans(x, 50, niter=8, device="cpu")
    assert torch.equal(got, train_kmeans(x, 50, niter=8, device="cpu"))

    def index_add_sums(x, a, k):
        counts = torch.bincount(a, minlength=k)
        return torch.zeros((k, x.shape[1]), dtype=x.dtype).index_add_(0, a, x), counts

    monkeypatch.setattr(kmeans, "cluster_sums", index_add_sums)
    assert torch.equal(got, train_kmeans(x, 50, niter=8, device="cpu"))

"""The grouped float scan's slot grouping and plain version
(``ops/ivf_scan.py``), on the CPU.

On the card, ``search_positional`` groups a search's (query, probe) slots by
list on the device and scans each float size bucket with one launch of the
kernel K5 (``csrc/ivf_flat_scan.cu``); on the CPU it keeps the per-bucket
pair and dense scans. The kernel runs only on the card
(``tests/test_torch_cuda.py`` holds it against the plain version there);
here:
  - ``group_slots`` against a numpy stable sort, and against what a
    grouping must be: every slot once, in its list's range in slot order,
    -1 probes and lists in no bucket after every list;
  - the plain version against ``_scan_flat_pairs`` over every bucket of
    ``test_torch_ivf.py``'s index (d 16, nlist 32, four size buckets),
    k up to beyond the longest list;
  - the grouped route's candidates on the CPU (the plain version), merged
    and translated, against the JAX package's search on that index, under
    the near-tie rule of ``test_torch_ivf.py`` (rtol 1e-5, atol 1e-4).
"""

import numpy as np
import pytest
import torch

from test_torch_ivf import K, NLIST, NPROBE, assert_same_results, data, indexes  # noqa: F401
from vector_db_id_compression_tpu_torch.ops import ivf_scan
from vector_db_id_compression_tpu_torch.search import ivf


def numpy_grouping(probes, bucket_of):
    nlist = len(bucket_of)
    flat = probes.reshape(-1)
    key = np.where((flat >= 0) & (bucket_of[np.clip(flat, 0, None)] >= 0), flat, nlist)
    order = np.argsort(key, kind="stable")
    return order, np.searchsorted(key[order], np.arange(nlist + 1))


@pytest.mark.parametrize("nq,nprobe,empty", [(50, 4, 0), (7, 32, 5), (1, 16, 3), (200, 8, 31)])
def test_group_slots_matches_numpy(nq, nprobe, empty):
    rng = np.random.default_rng(nq + nprobe)
    nlist = 32
    bucket_of = rng.integers(0, 3, nlist)
    bucket_of[rng.choice(nlist, empty, replace=False)] = -1
    probes = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(nq)])
    probes[rng.random(probes.shape) < 0.2] = -1
    order, starts = ivf_scan.group_slots(torch.from_numpy(probes), torch.from_numpy(bucket_of))
    order, starts = order.numpy(), starts.numpy()
    want_order, want_starts = numpy_grouping(probes, bucket_of)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(starts, want_starts)
    flat = probes.reshape(-1)
    np.testing.assert_array_equal(np.sort(order), np.arange(flat.size))
    assert starts[0] == 0 and (np.diff(starts) >= 0).all()
    for ln in range(nlist):
        slots = order[starts[ln]:starts[ln + 1]]
        want = np.flatnonzero(flat == ln) if bucket_of[ln] >= 0 else []
        np.testing.assert_array_equal(slots, want)
    rest = order[starts[nlist]:]
    np.testing.assert_array_equal(rest, np.flatnonzero((flat < 0) | (bucket_of[flat] < 0)))


@pytest.mark.parametrize("k", [1, K, "beyond"])
def test_plain_grouped_scan_matches_pair_scan(data, indexes, k):  # noqa: F811
    """Each bucket's slots get the pair scan's candidates (distance + ||x||^2,
    labels), +inf and -1 past a list's end; other buckets' slots keep what
    they held."""
    _, xq = data
    _, tidx = indexes
    assert len(tidx._scan) == 4
    k = max(sb.n_pad for sb in tidx._scan) + 3 if k == "beyond" else k
    xq = torch.from_numpy(xq)
    x2 = (xq * xq).sum(dim=1)
    probes = tidx.coarse_assign(xq, NPROBE)
    flat = probes.reshape(-1)
    order, starts = ivf_scan.group_slots(probes, tidx._bucket_of)
    for sb in tidx._scan:
        out_d = torch.full((flat.numel(), k), -7.0)
        out_l = torch.full((flat.numel(), k), -7, dtype=torch.int64)
        ivf_scan.scan_flat_grouped(xq, x2, sb.payload, sb.norms, sb.lengths, sb.lists, order,
                                   starts, NPROBE, k, out_d, out_l)
        mine = torch.isin(flat, sb.lists)
        q = torch.nonzero(mine)[:, 0] // NPROBE
        dists, offs = ivf._scan_flat_pairs(xq, sb, q, tidx._lane_of[flat[mine]], k)
        valid = torch.isfinite(dists)
        want_d = torch.where(valid, dists + x2[q, None], float("inf"))
        want_l = torch.where(valid, ivf.lo_build(flat[mine][:, None], offs), -1)
        assert_same_results(out_d[mine], out_l[mine], want_d.numpy(), want_l.numpy())
        assert bool((out_d[~mine] == -7).all()) and bool((out_l[~mine] == -7).all())


@pytest.mark.parametrize("nprobe,k", [(NPROBE, K), (NLIST, K), (2, "beyond")])
def test_grouped_search_matches_jax(data, indexes, monkeypatch, nprobe, k):  # noqa: F811
    """The grouped route's candidates (``IndexIVF._scan_grouped``, the plain
    version on the CPU, for every k), merged and translated as
    ``search_positional`` and ``search`` do on the card, against the JAX
    package's searches."""
    _, xq = data
    jidx, tidx = indexes
    k = max(sb.n_pad for sb in tidx._scan) + 3 if k == "beyond" else k
    calls = []
    grouped = ivf_scan.scan_flat_grouped

    def spy(*args):
        calls.append(args[2])
        return grouped(*args)

    monkeypatch.setattr(ivf_scan, "scan_flat_grouped", spy)
    probes = tidx.coarse_assign(torch.from_numpy(xq), nprobe)
    D_got, L_got = ivf._merge_candidates(*tidx._scan_grouped(torch.from_numpy(xq), probes, k), k)
    assert len(calls) == len(tidx._scan)
    D_ref, L_ref = jidx.search_positional(xq, k, nprobe=nprobe)
    assert_same_results(D_got, L_got, D_ref, L_ref)
    D_ref, I_ref = jidx.search(xq, k, nprobe=nprobe)
    assert_same_results(D_got, tidx._translate(L_got), D_ref, I_ref)

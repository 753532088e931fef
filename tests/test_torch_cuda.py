"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports no jax, so it also
runs on the machine with the card, which has none; ``tests/conftest.py``
imports jax, so there it runs without the conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu_torch.codecs import roc_device as td
from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe
from vector_db_id_compression_tpu_torch.ops.probes import ProbeDecodeStep, ProbeGather
from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
from vector_db_id_compression_tpu_torch.search.nsg import build_nsg
from vector_db_id_compression_tpu_torch.store.graph import RocBlockGraph, RocGraph
from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_batch(sizes, bits, seed):
    rng = np.random.default_rng(seed)
    B, n_max = len(sizes), max(sizes)
    ids = np.zeros((B, n_max), dtype=np.uint64)
    prec = np.zeros(B, dtype=np.int32)
    for b, (n, nb) in enumerate(zip(sizes, bits)):
        v = np.sort(rng.choice(2**nb - 1, size=n, replace=False).astype(np.uint64) + 1)
        ids[b, :n] = v
        prec[b] = precision_for_max_id_safe(int(v.max()))
    return (torch.from_numpy(ids.view(np.int64)), torch.from_numpy(np.array(sizes, np.int32)),
            torch.from_numpy(prec))


@pytest.mark.parametrize("sizes,bits", [
    ([1, 5, 128, 37], [16] * 4),
    ([1, 2, 64, 512, 1000, 700, 200], [20, 20, 20, 32, 24, 12, 8]),
    ([300] * 40, [32] * 40),
])
def test_kernels_match_plain(cuda, sizes, bits):
    ids, lengths, prec = make_batch(sizes, bits, seed=len(sizes))
    before = (RocEncoder.launches, RocDecoder.launches)
    st_k, order_k = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    torch.cuda.synchronize()
    st_p, order_p = RocEncoder.encode(ids, lengths, prec)
    for got, want in zip(st_k, st_p):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(order_k.cpu(), order_p)
    n_max = ids.shape[1]
    dec_k = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda),
                       td.default_pool(n_max, cuda), n_max)
    dec_p = RocDecoder(st_p, lengths, prec, td.default_pool(n_max), n_max)
    assert torch.equal(dec_k.decode().cpu(), dec_p.decode())
    lanes = torch.tensor([len(sizes) - 1, 0, len(sizes) // 2])
    assert torch.equal(dec_k.decode_lanes(lanes.to(cuda)).cpu(), dec_p.decode_lanes(lanes))
    # decoding twice reads the same stored stream
    assert torch.equal(dec_k.decode().cpu(), dec_p.decode())
    torch.cuda.synchronize()
    assert RocEncoder.launches == before[0] + 1
    assert RocDecoder.launches == before[1] + 3


def test_roc_ivf_search_on_card(cuda):
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((20000, 32)).astype(np.float32)
    xq = rng.standard_normal((64, 32)).astype(np.float32)
    index = IndexIVF(32, 64, device=cuda)
    index.train(xb)
    index.add(xb)
    D0, I0 = index.search(xq, 10, nprobe=8)
    roc = RocInvertedLists(index.invlists, device=cuda)
    index.replace_invlists(roc)
    D1, I1 = index.search_defer_id_decoding(xq, 10, nprobe=8)
    assert torch.equal(I0.sort(1).values, I1.sort(1).values)
    torch.testing.assert_close(D1, D0, rtol=1e-4, atol=1e-3)
    for ln in (0, 17, 63):
        assert torch.equal(roc.get_ids(ln).sort().values.cpu(),
                           torch.from_numpy(np.sort(index.invlists.ids[ln]).view(np.int64)))


def make_chained_batch(L, S, n_max, bits, seed):
    """ids i64[L, S, n_max] (slot ids ascending), lengths i32[L, S] in
    [0, n_max] with 0, 1 and n_max among them, safe precisions i32[L, S]
    (1 for empty slots)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((L, S, n_max), dtype=np.uint64)
    lengths = rng.integers(0, n_max + 1, (L, S)).astype(np.int32)
    lengths.flat[:3] = [0, 1, n_max]
    prec = np.ones((L, S), dtype=np.int32)
    for b, s in np.ndindex(L, S):
        n = lengths[b, s]
        if n:
            v = np.sort(rng.choice(2**bits - 1, size=n, replace=False).astype(np.uint64) + 1)
            ids[b, s, :n] = v
            prec[b, s] = precision_for_max_id_safe(int(v.max()))
    return (torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths),
            torch.from_numpy(prec))


@pytest.mark.parametrize("L,S,n_max,bits", [(5, 4, 16, 18), (70, 16, 32, 20), (9, 3, 40, 32)])
def test_chained_kernels_match_plain(cuda, L, S, n_max, bits):
    ids, lengths, prec = make_chained_batch(L, S, n_max, bits, seed=L)
    before = (RocEncoder.chained_launches, RocDecoder.chained_launches)
    st_k = RocEncoder.encode_chained(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    torch.cuda.synchronize()
    st_p = RocEncoder.encode_chained(ids, lengths, prec)
    for got, want in zip(st_k, st_p):
        assert torch.equal(got.cpu(), want)
    pool = td.default_pool(S * n_max)
    dec_k = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda), pool.to(cuda), n_max)
    dec_p = RocDecoder(st_p, lengths, prec, pool, n_max)
    full = dec_p.decode()
    assert torch.equal(dec_k.decode().cpu(), full)
    lanes = torch.tensor([L - 1, 0, L - 1, L // 2])
    assert torch.equal(dec_k.decode_lanes(lanes.to(cuda)).cpu(), full[lanes])
    for b, s in np.ndindex(L, S):
        n = int(lengths[b, s])
        assert torch.equal(full[b, s, :n].sort().values, ids[b, s, :n])
    torch.cuda.synchronize()
    assert RocEncoder.chained_launches == before[0] + 1
    assert RocDecoder.chained_launches == before[1] + 2


@pytest.mark.parametrize("S", [1, 3])
def test_decode_lane_out_of_range_raises(cuda, S):
    """The kernel checks the lane bounds and reports through its error
    flag; the wrapper raises IndexError, and the next call decodes."""
    if S == 1:
        ids, lengths, prec = make_batch([4, 9, 2], [20] * 3, seed=3)
        st = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))[0]
        n_max = ids.shape[1]
    else:
        ids, lengths, prec = make_chained_batch(3, S, 8, 20, seed=3)
        st = RocEncoder.encode_chained(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
        n_max = ids.shape[2]
    dec = RocDecoder(st, lengths.to(cuda), prec.to(cuda),
                     td.default_pool(S * n_max, cuda), n_max)
    for lane in (-1, 3, 1 << 40):
        with pytest.raises(IndexError, match="lane indices"):
            dec.decode_lanes(torch.tensor([0, lane], device=cuda))
    assert torch.equal(dec.decode_lanes(torch.tensor([2, 0], device=cuda)),
                       dec.decode()[[2, 0]])


@pytest.mark.parametrize("capp,steps", [(896, 1100), (2, 300)])
def test_probes_match_plain(cuda, capp, steps):
    rng = np.random.default_rng(capp)
    win = torch.from_numpy(rng.integers(-2**31, 2**31, (256, 128)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, 128, (256, 1)).astype(np.int32))
    buf = torch.from_numpy(rng.integers(-2**31, 2**31, (capp, 256)).astype(np.int32))
    p = torch.arange(256, dtype=torch.int32)[None, :] % 17
    before = (ProbeGather.launches, ProbeDecodeStep.launches)
    assert torch.equal(ProbeGather.run(win.to(cuda), idx.to(cuda), steps).cpu(),
                       ProbeGather.run(win, idx, steps))
    buf_k = buf.to(cuda)
    assert torch.equal(ProbeDecodeStep.run(buf_k, p.to(cuda), steps).cpu(),
                       ProbeDecodeStep.run(buf, p, steps))
    assert torch.equal(buf_k.cpu(), buf)  # the kernel works on a copy
    assert (ProbeGather.launches, ProbeDecodeStep.launches) == (before[0] + 1, before[1] + 1)


def test_graph_search_on_card(cuda):
    """NSG on the card; the dense, per-node ROC and chained ROC graphs give
    identical results, through the decode kernels."""
    rng = np.random.default_rng(9)
    xb = torch.from_numpy(rng.standard_normal((3000, 24)).astype(np.float32)).to(cuda)
    xq = torch.from_numpy(rng.standard_normal((50, 24)).astype(np.float32)).to(cuda)
    g, medoid = build_nsg(xb, R=16)
    assert g.device.type == "cuda" and int(g.degrees.min()) >= 1
    D0, I0 = search_graph_device(g, xb, xq, 10, entry=medoid)
    before = (RocDecoder.launches, RocDecoder.chained_launches)
    for container in (RocGraph(g), RocBlockGraph(g, block=16)):
        D1, I1 = search_graph_device(container, xb, xq, 10, entry=medoid)
        assert torch.equal(I1, I0) and torch.equal(D1, D0)
    torch.cuda.synchronize()
    assert RocDecoder.launches > before[0] and RocDecoder.chained_launches > before[1]
    # the ROC neighbour lists are the dense graph's sets
    nodes = torch.tensor([0, 5, 2999], device=cuda)
    dense, cnt = g.get_neighbors_batch(nodes)
    for container in (RocGraph(g), RocBlockGraph(g, block=16)):
        nb, c = container.get_neighbors_batch(nodes)
        assert torch.equal(c, cnt)
        assert torch.equal(nb.sort(dim=1).values, dense.sort(dim=1).values)

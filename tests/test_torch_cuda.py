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
import torch.distributed as dist

from vector_db_id_compression_tpu_torch.codecs import roc_device as td
from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe
from vector_db_id_compression_tpu_torch.models.qinco import QincoCodec
from vector_db_id_compression_tpu_torch.ops._build import SHARED_BYTES_PER_BLOCK
from vector_db_id_compression_tpu_torch.ops.probes import (
    ProbeChain,
    ProbeDecodeStep,
    ProbeGather,
    decode_ranks,
    step_latency_cycles,
)
from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
from vector_db_id_compression_tpu_torch.parallel import multihost
from vector_db_id_compression_tpu_torch.parallel.mesh import sharded_roc_encode
from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
from vector_db_id_compression_tpu_torch.search import ivf
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
from vector_db_id_compression_tpu_torch.search.kmeans import assign, cluster_sums, train_kmeans
from vector_db_id_compression_tpu_torch.search.nsg import build_nsg
from vector_db_id_compression_tpu_torch.store.graph import (
    CompactBitGraph,
    EliasFanoGraph,
    Graph,
    RocBlockGraph,
    RocGraph,
)
from vector_db_id_compression_tpu_torch.store.invlists import (
    AVAILABLE_COMPRESSED_IVFS,
    InterleavedRocInvertedLists,
    InvertedLists,
    RocInvertedLists,
    roc_lane_table,
)
from vector_db_id_compression_tpu_torch.store.serialize import (
    load_graph,
    load_invlists,
    save_graph,
    save_invlists,
)

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


@pytest.mark.parametrize("layout", ["shared", "global"])
@pytest.mark.parametrize("sizes,bits", [
    ([1, 2, 64, 2100, 1000, 700, 200], [20, 20, 20, 20, 24, 12, 8]),
    ([3000, 40, 1], [40, 40, 40]),
])
def test_kernel_layouts_match_plain(cuda, monkeypatch, layout, sizes, bits):
    """Both kernels in both layouts, u32 and u64 symbols: the global one is
    forced by a limit of 1 KB of shared memory per block."""
    from vector_db_id_compression_tpu_torch.ops import _build

    if layout == "global":
        monkeypatch.setattr(_build, "SHARED_BYTES_PER_BLOCK", 1024)
    ids, lengths, prec = make_batch(sizes, bits, seed=7)
    st_k, order_k = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    st_p, order_p = RocEncoder.encode(ids, lengths, prec)
    for got, want in zip(st_k, st_p):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(order_k.cpu(), order_p)
    n_max = ids.shape[1]
    dec_k = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda),
                       td.default_pool(n_max, cuda), n_max)
    dec_p = RocDecoder(st_p, lengths, prec, td.default_pool(n_max), n_max)
    assert torch.equal(dec_k.decode().cpu(), dec_p.decode())


def test_decode_lanes_unsorted_with_repeats(cuda):
    """decode_lanes over lanes of mixed lengths in no order, some repeated:
    each lane's ids land in its own row of the output."""
    sizes = [5, 900, 1, 300, 2000, 64, 7]
    ids, lengths, prec = make_batch(sizes, [20] * len(sizes), seed=9)
    st, _ = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    n_max = ids.shape[1]
    dec_k = RocDecoder(st, lengths.to(cuda), prec.to(cuda), td.default_pool(n_max, cuda),
                       n_max)
    full = dec_k.decode().cpu()
    for b, n in enumerate(sizes):
        assert torch.equal(full[b, :n].sort().values, ids[b, :n])
    lanes = torch.tensor([2, 4, 0, 4, 6, 1, 2, 5, 3, 4])
    got = dec_k.decode_lanes(lanes.to(cuda)).cpu()
    assert torch.equal(got, full[lanes])
    chained_ids, c_len, c_prec = make_chained_batch(6, 3, 40, 20, seed=2)
    st_c = RocEncoder.encode_chained(chained_ids.to(cuda), c_len.to(cuda), c_prec.to(cuda))
    dec_c = RocDecoder(st_c, c_len.to(cuda), c_prec.to(cuda),
                       td.default_pool(3 * 40, cuda), 40)
    lanes = torch.tensor([5, 0, 5, 3, 1, 1])
    assert torch.equal(dec_c.decode_lanes(lanes.to(cuda)).cpu(), dec_c.decode().cpu()[lanes])


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


def test_sharded_search_one_nccl_rank_on_card(cuda, tmp_path):
    """A size-1 NCCL mesh on the card: ShardedIVF over ROC ids gives the
    unsharded search's rows (D within 1e-5), through the decode kernel, and
    the sharded encode gives the container's states."""
    rng = np.random.default_rng(6)
    xb = rng.standard_normal((20000, 32)).astype(np.float32)
    xq = rng.standard_normal((64, 32)).astype(np.float32)
    index = IndexIVF(32, 64, device=cuda)
    index.train(xb)
    index.add(xb)
    roc = RocInvertedLists(index.invlists, device=cuda)
    index.replace_invlists(roc)
    D0, I0 = index.search_defer_id_decoding(xq, 10, nprobe=8)
    multihost.initialize(init_method=f"file://{tmp_path / 'pg_init'}", world_size=1, rank=0,
                         device="cuda:0")
    try:
        mesh = multihost.global_lists_mesh(device="cuda:0")
        assert (mesh.size, mesh.backend) == (1, "nccl")
        before = (RocDecoder.launches, RocEncoder.launches)
        D1, I1 = ShardedIVF(mesh, index, roc, device=cuda).search(xq, 10, nprobe=8)
        ids, lengths, prec, _ = roc_lane_table(index.invlists)
        st, _ = sharded_roc_encode(mesh, torch.from_numpy(ids.view(np.int64)),
                                   torch.from_numpy(lengths), torch.from_numpy(prec),
                                   roc.decoder.states.stack.shape[1])
        torch.cuda.synchronize()
        assert RocDecoder.launches > before[0] and RocEncoder.launches > before[1]
    finally:
        dist.destroy_process_group()
    assert torch.equal(I1.sort(1).values, I0.sort(1).values)
    torch.testing.assert_close(D1, D0, rtol=1e-5, atol=1e-5)
    for a, b in zip(st, roc.decoder.states):
        assert torch.equal(a, b)


def test_qinco_on_card(cuda):
    """QINCo encode and decode on the card against the same weights on the
    CPU (reconstruction within 1e-4; codes equal except where the first step
    at which two rows differ is a near tie, the two chosen candidates'
    distances within 1e-5 relative), and the QINCo IVF search of the same
    lists on the card against the CPU's under the near-tie rule."""
    rng = np.random.default_rng(9)
    xb = (rng.standard_normal((4096, 32)) + 3 * rng.standard_normal((8, 32))[
        rng.integers(0, 8, 4096)]).astype(np.float32)
    cpu = QincoCodec(32, 8, ksub=64, hidden=64, device="cpu").train(xb, steps=30)
    card = QincoCodec(32, 8, ksub=64, hidden=64, device=cuda).load_state_dict(
        cpu.model.state_dict())
    codes_cpu, codes_card = cpu.encode(xb), card.encode(xb).cpu()
    torch.testing.assert_close(card.decode(codes_card).cpu(), cpu.decode(codes_card),
                               rtol=1e-4, atol=1e-4)
    rows = torch.nonzero((codes_cpu != codes_card).any(1))[:, 0]
    assert rows.numel() <= 4096 // 100
    with torch.no_grad():
        for r in rows.tolist():
            m = int(torch.nonzero(codes_cpu[r] != codes_card[r])[0, 0])
            x_hat = torch.zeros((1, 32))
            for j in range(m):
                x_hat = x_hat + cpu.model.steps[j].selected(x_hat, codes_cpu[r:r + 1, j].long())
            d2 = ((cpu.model.steps[m](x_hat)[0] - (torch.from_numpy(xb[r]) - x_hat)) ** 2).sum(-1)
            a, b = float(d2[int(codes_cpu[r, m])]), float(d2[int(codes_card[r, m])])
            assert abs(a - b) <= 1e-5 * max(a, b), f"row {r}: codes differ without a near tie"
    index_cpu = IndexIVF(32, 16, storage="qinco", qinco=cpu, device="cpu")
    index_cpu.train(xb, niter=5)
    index_cpu.add(xb)
    # the card's index scans the CPU index's lists (its own add could place
    # a vector otherwise at a near tie)
    index_card = IndexIVF(32, 16, storage="qinco", qinco=card, device=cuda)
    index_card.centroids = index_cpu.centroids.to(cuda)
    index_card.replace_invlists(index_cpu.invlists)
    xq = xb[:64] + 0.1
    for nprobe in (4, 16):  # the pair scan, then every bucket dense
        D0, I0 = index_cpu.search(xq, 10, nprobe=nprobe)
        D1, I1 = index_card.search(xq, 10, nprobe=nprobe)
        torch.testing.assert_close(D1.cpu(), D0, rtol=1e-4, atol=1e-3)
        assert bool(((I1.cpu() == I0) | torch.isclose(D1.cpu(), D0, rtol=1e-4, atol=1e-3)).all())


def test_dense_scan_on_card(cuda, monkeypatch):
    """Full probe on the card (every bucket dense, in slabs of a few lists
    under a lowered budget) equals the same index's search on the CPU under
    the near-tie rule."""
    rng = np.random.default_rng(10)
    xb = rng.standard_normal((20000, 32)).astype(np.float32)
    xq = rng.standard_normal((64, 32)).astype(np.float32)
    cpu = IndexIVF(32, 64, device="cpu")
    cpu.train(xb, niter=5)
    cpu.add(xb)
    card = IndexIVF(32, 64, device=cuda)
    card.centroids = cpu.centroids.to(cuda)
    card.add(xb)
    D0, I0 = cpu.search(xq, 10, nprobe=64)
    for budget in (ivf.SCAN_BUDGET, 64 * 1024 * 3):
        monkeypatch.setattr(ivf, "SCAN_BUDGET", budget)
        D1, I1 = card.search(xq, 10, nprobe=64)
        torch.testing.assert_close(D1.cpu(), D0, rtol=1e-4, atol=1e-3)
        assert bool(((I1.cpu() == I0) | torch.isclose(D1.cpu(), D0, rtol=1e-4, atol=1e-3)).all())


def test_pq_interleaved_search_on_card(cuda, monkeypatch):
    """IVF-PQ with the interleaved ROC container on the card, both scans,
    against the same index on the CPU (the card's index takes the CPU
    index's parameters and lists)."""
    rng = np.random.default_rng(6)
    xb = rng.standard_normal((20000, 32)).astype(np.float32)
    xq = rng.standard_normal((64, 32)).astype(np.float32)
    cpu = IndexIVF(32, 16, storage="pq", pq_m=8, device="cpu")
    cpu.train(xb)
    cpu.add(xb)
    card = IndexIVF(32, 16, storage="pq", pq_m=8, device=cuda)
    card.centroids, card.pq.centroids = cpu.centroids.to(cuda), cpu.pq.centroids.to(cuda)
    before = (RocEncoder.launches, RocDecoder.launches)
    il_cpu = InterleavedRocInvertedLists(cpu.invlists, device="cpu")
    il_card = InterleavedRocInvertedLists(cpu.invlists, device=cuda)
    assert il_card.compressed_ids_size_in_bytes == il_cpu.compressed_ids_size_in_bytes
    assert il_card.overhead_in_bytes == il_cpu.overhead_in_bytes > 0
    for budget in (ivf.PQ_DECODE_BUDGET, 0):
        monkeypatch.setattr(ivf, "PQ_DECODE_BUDGET", budget)
        cpu.replace_invlists(il_cpu)
        card.replace_invlists(il_card)
        assert card._scan_is_float == (budget > 0)
        D0, I0 = cpu.search(xq, 10, nprobe=4)
        D1, I1 = card.search(xq, 10, nprobe=4)
        torch.testing.assert_close(D1.cpu(), D0, rtol=1e-4, atol=1e-3)
        assert bool(((I1.cpu() == I0) | torch.isclose(D1.cpu(), D0, rtol=1e-4, atol=1e-3)).all())
    ids, lens = il_card.decode_lists(torch.arange(16, device=cuda))
    for ln in range(16):
        assert torch.equal(ids[ln, : lens[ln]].sort().values.cpu(),
                           torch.from_numpy(np.sort(cpu.invlists.ids[ln]).view(np.int64)))
    torch.cuda.synchronize()
    assert RocEncoder.launches == before[0] + 1 and RocDecoder.launches >= before[1] + 3


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


# words of one block's shared memory: the widest K3 window, and K4's largest
# buffer at 1100 steps and most steps on a two-row buffer
_SHARED_WORDS = SHARED_BYTES_PER_BLOCK // 4


@pytest.mark.parametrize("capp,steps,W,B", [
    (896, 1100, 128, 256), (2, 300, 128, 256), (896, 33, 128, 256), (896, 1, 128, 257),
    (_SHARED_WORDS - 2 * 1100, 1100, _SHARED_WORDS // 32, 256),
    (2, (_SHARED_WORDS - 2) // 2, 128, 3),
], ids=["probe-shape", "two-row-buf", "steps-33", "one-step-257-lanes", "largest-buf-window",
        "most-steps"])
def test_probes_match_plain(cuda, capp, steps, W, B):
    rng = np.random.default_rng(capp + steps)
    win = torch.from_numpy(rng.integers(-2**31, 2**31, (B, W)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, W, (B, 1)).astype(np.int32))
    idx[:8] = 0  # rows that start together, as the probe's do
    buf = torch.from_numpy(rng.integers(-2**31, 2**31, (capp, B)).astype(np.int32))
    p = torch.arange(B, dtype=torch.int32)[None, :] * 7 % 32
    before = (ProbeGather.launches, ProbeDecodeStep.launches)
    assert torch.equal(ProbeGather.run(win.to(cuda), idx.to(cuda), steps).cpu(),
                       ProbeGather.run(win, idx, steps))
    buf_k = buf.to(cuda)
    assert torch.equal(ProbeDecodeStep.run(buf_k, p.to(cuda), steps).cpu(),
                       ProbeDecodeStep.run(buf, p, steps))
    torch.cuda.synchronize()
    assert torch.equal(buf_k.cpu(), buf)  # the kernel works on a copy
    assert (ProbeGather.launches, ProbeDecodeStep.launches) == (before[0] + 1, before[1] + 1)


def test_step_latency_cycles(cuda):
    """The clock64() readings behind K4's latency bound: positive, a link of
    the rank (a compare, a warp reduction, an add) no faster than one integer
    add, and an SM clock a card can run at."""
    got = step_latency_cycles(cuda)
    assert set(got) == {"rank_reduce", "rank_ballot", "shared_load", "sm_mhz"}
    assert min(got["rank_reduce"], got["rank_ballot"], got["shared_load"]) >= 2, got
    assert 100 <= got["sm_mhz"] <= 5000, got


def test_train_kmeans_reproducible(cuda):
    """Two trainings on the card give the same centroids bit for bit, at a
    shape where about 200 rows share each centroid (the sum per cluster is
    in a fixed order, ``search/kmeans.py`` ``cluster_sums``); and that sum
    equals the CPU's, which adds in the same order."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((200_000, 128)).astype(np.float32)
    x[:50_000] *= 0.1  # a dense region: clusters of unequal size
    first = train_kmeans(x, 1024, device=cuda)
    second = train_kmeans(x, 1024, device=cuda)
    assert torch.equal(first, second)
    a = assign(torch.from_numpy(x).to(cuda), first)
    assert torch.equal(a, assign(torch.from_numpy(x).to(cuda), second))
    sums, counts = cluster_sums(torch.from_numpy(x[:20_000]).to(cuda), a[:20_000], 1024)
    sums_h, counts_h = cluster_sums(torch.from_numpy(x[:20_000]), a[:20_000].cpu(), 1024)
    assert torch.equal(counts.cpu(), counts_h) and torch.equal(sums.cpu(), sums_h)


def test_chain_probe_matches_plain(cuda):
    """The chain probe on the card, given the decode's ranks and the
    encode's sampling order, against its plain versions and the codec."""
    ids, lengths, prec = make_batch([1, 700, 2127, 40], [20, 20, 20, 32], seed=4)
    st, order = RocEncoder.encode(ids, lengths, prec)
    in_order = ids.gather(1, order.clamp(min=0).long())
    before = ProbeChain.launches
    st_k = ProbeChain.encode(in_order.to(cuda), lengths.to(cuda), prec.to(cuda))
    for got, want in zip(st_k, st):
        assert torch.equal(got.cpu(), want)
    n_max = ids.shape[1]
    ref = RocDecoder(st, lengths, prec, td.default_pool(n_max), n_max).decode()
    ranks = decode_ranks(ref, lengths)
    want = ProbeChain.decode(st, lengths, prec, ranks, td.default_pool(n_max))
    got = ProbeChain.decode(td.RocStates(*(t.to(cuda) for t in st)), lengths.to(cuda),
                            prec.to(cuda), ranks.to(cuda), td.default_pool(n_max, cuda))
    assert torch.equal(got.cpu(), want)
    for b, n in enumerate(lengths.tolist()):
        assert torch.equal(want[b, :n], ref[b, :n].flip(0))
    assert ProbeChain.launches == before + 2


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


def test_hnsw_on_card(cuda):
    """An HNSW built on the card: its device walk (the descent, then the
    level-0 pool search) equals the host oracle (the greedy descent, then the
    host search_graph from each query's entry) up to near ties, the card's
    build equals the CPU build's, and the five level-0 containers give
    identical I and D, through the decode kernels."""
    from vector_db_id_compression_tpu_torch.search.graph_device import hnsw_descend_device
    from vector_db_id_compression_tpu_torch.search.hnsw import HNSW
    from vector_db_id_compression_tpu_torch.search.nsg import search_graph

    rng = np.random.default_rng(12)
    xb = rng.standard_normal((2000, 32)).astype(np.float32)
    xq = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32)).to(cuda)
    h = HNSW(M=8, ef_construction=40).build(xb, batch=256)
    assert h._xb.device.type == "cuda" and h.max_level >= 1
    h_cpu = HNSW(M=8, ef_construction=40, device="cpu").build(xb, batch=256)
    assert h.entry == h_cpu.entry
    for a, b in zip(h.layers, h_cpu.layers):
        assert np.array_equal(a, b)
    entries = hnsw_descend_device(h, xq)
    cur = np.full(len(xq), h.entry, dtype=np.int64)
    everyone = torch.ones(len(xb), dtype=torch.bool, device=cuda)
    for lv in range(h.max_level, 0, -1):
        cur = h._greedy_descend(np.arange(len(xq)), cur, lv, everyone, xq=xq)
    assert np.array_equal(entries.cpu().numpy(), cur)
    D0, I0 = h.search(xq, 10, ef=32)
    g0 = h.level0_graph()
    for i in range(len(xq)):
        Dh, Ih, _ = search_graph(g0, h._xb, xq[i:i + 1], 10, L=32, entry=int(cur[i]))
        torch.testing.assert_close(Dh, D0[i:i + 1], rtol=1e-5, atol=1e-5)
        differ = torch.nonzero(Ih[0] != I0[i])[:, 0].tolist()
        for j in differ:  # a label may differ only at a near tie
            near = [abs(float(D0[i, j] - D0[i, jj])) <= 1e-5 * float(D0[i, j])
                    for jj in (j - 1, j + 1) if 0 <= jj < 10]
            assert any(near)
    before = (RocDecoder.launches, RocDecoder.chained_launches)
    for container in (RocGraph(g0), RocBlockGraph(g0, block=16), CompactBitGraph(g0),
                      EliasFanoGraph(g0)):
        D1, I1 = h.search(xq, 10, ef=32, graph0=container)
        assert torch.equal(I1, I0) and torch.equal(D1, D0)
    torch.cuda.synchronize()
    assert RocDecoder.launches > before[0] and RocDecoder.chained_launches > before[1]


def test_entry_points_default_to_the_card(cuda):
    """Called without ``device``, the entry points take the card."""
    rng = np.random.default_rng(8)
    xb = rng.standard_normal((2000, 16)).astype(np.float32)
    index = IndexIVF(16, 8)
    index.train(xb)
    index.add(xb)
    assert index.device.type == "cuda" and index.centroids.device.type == "cuda"
    assert RocInvertedLists(index.invlists).decoder.device.type == "cuda"
    hq = IndexIVF(16, 8, quantizer="hnsw", quantizer_M=4)
    hq.train(xb)
    hq.add(xb)
    assert hq._quantizer_hnsw.device.type == "cuda"
    assert sum(len(ids) for ids in hq.invlists.ids) == len(xb)
    g, _ = build_nsg(xb[:500], R=8)
    assert g.device.type == "cuda"


def _tensors(container):
    """The stored tables of a packed-bits, Elias-Fano or wavelet-tree
    container, by name."""
    if hasattr(container, "packed"):
        return {"words": container.packed.words, "lengths": container.packed.lengths}
    if hasattr(container, "ef"):
        ef = container.ef
        return {"high": ef.high.words, "dir": ef.high.sb_prefix, "nbits": ef.high.nbits,
                "low": ef.low_words, "l": ef.l, "m": ef.m}
    return dict(zip(container.wt._fields[:-2], tuple(container.wt)[:-2]))


@pytest.mark.parametrize("name", ["packed-bits", "elias-fano", "wavelet-tree", "wavelet-tree-1"])
def test_codec_containers_on_card_equal_cpu(cuda, name):
    """Each container built on the card from seeded lists (ids in id order,
    an empty list, a list of one id, one list past several superblocks)
    equals the port's CPU container: words, sizes, selects, decoded lists."""
    rng = np.random.default_rng(11)
    nlist = 64
    assign = rng.integers(2, nlist, 30000)
    assign[:4000] = 5  # a long list
    assign[7] = 1      # list 1 holds one id; list 0 none
    il = InvertedLists(nlist, 1)
    for ln in range(nlist):
        ids = np.flatnonzero(assign == ln).astype(np.uint64)
        il.add_entries(ln, ids, rng.integers(0, 256, len(ids)).astype(np.uint8))
    make = AVAILABLE_COMPRESSED_IVFS[name]
    cpu, card = make(il, device="cpu"), make(il, device=cuda)
    assert card.compressed_ids_size_in_bytes == cpu.compressed_ids_size_in_bytes
    assert card.overhead_in_bytes == cpu.overhead_in_bytes
    for field, want in _tensors(cpu).items():
        assert torch.equal(_tensors(card)[field].cpu(), want), field
    lists = torch.arange(nlist)
    ids_cpu, lens_cpu = cpu.decode_lists(lists)
    ids_card, lens_card = card.decode_lists(lists.to(cuda))
    assert torch.equal(ids_card.cpu(), ids_cpu) and torch.equal(lens_card.cpu(), lens_cpu)
    for ln in range(nlist):
        assert torch.equal(ids_cpu[ln, : lens_cpu[ln]],
                           torch.from_numpy(il.ids[ln].view(np.int64)))
    lns = torch.from_numpy(rng.choice(np.arange(1, nlist), 5000))
    offs = (torch.rand(5000, generator=torch.Generator().manual_seed(3))
            * lens_cpu[lns]).long()
    want = cpu.get_single_ids_batch(lns, offs)
    assert torch.equal(card.get_single_ids_batch(lns.to(cuda), offs.to(cuda)).cpu(), want)
    assert torch.equal(card.decode_select(lns.to(cuda), offs.to(cuda)).cpu(), want)


def test_graph_codec_containers_on_card_equal_cpu(cuda):
    """CompactBitGraph and EliasFanoGraph built on the card equal the CPU
    ones (words, sizes, fetched neighbours), and search like the dense
    graph."""
    rng = np.random.default_rng(12)
    N, K = 3000, 16
    adj = np.full((N, K), -1, np.int32)
    deg = rng.integers(1, K + 1, N)
    deg[:2] = [0, K]
    for i in range(N):
        adj[i, : deg[i]] = rng.choice(np.arange(1, N), deg[i], replace=False)
    g_cpu, g_card = Graph(adj, device="cpu"), Graph(adj, device=cuda)
    xb = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    xq = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    D0, I0 = search_graph_device(g_card, xb.to(cuda), xq.to(cuda), 10, entry=1)
    nodes = torch.from_numpy(rng.integers(0, N, 500))
    for make in (CompactBitGraph, EliasFanoGraph):
        cpu, card = make(g_cpu), make(g_card)
        assert card.compressed_ids_size_in_bytes == cpu.compressed_ids_size_in_bytes
        assert card.overhead_in_bytes == cpu.overhead_in_bytes
        words = (lambda c: (c.words,)) if make is CompactBitGraph else (
            lambda c: (c.ef.high.words, c.ef.high.sb_prefix, c.ef.low_words, c.ef.l))
        for got, want in zip(words(card), words(cpu)):
            assert torch.equal(got.cpu(), want)
        nb, cnt = card.get_neighbors_batch(nodes.to(cuda))
        nb_cpu, cnt_cpu = cpu.get_neighbors_batch(nodes)
        assert torch.equal(nb.cpu(), nb_cpu) and torch.equal(cnt.cpu(), cnt_cpu)
        D1, I1 = search_graph_device(card, xb.to(cuda), xq.to(cuda), 10, entry=1)
        assert torch.equal(I1, I0) and torch.equal(D1, D0)


def test_saved_and_loaded_on_card(cuda, tmp_path):
    """A ROC and an interleaved container and a RocBlockGraph built on the
    card, saved, and loaded onto the card decode through the kernels to the
    built ones' ids (the loaded states are the built ones)."""
    rng = np.random.default_rng(13)
    nlist = 32
    assign = rng.integers(1, nlist, 20000)
    assign[:3000] = 4  # a list chunked by the interleaved container
    il = InvertedLists(nlist, 2)
    for ln in range(nlist):
        ids = np.flatnonzero(assign == ln).astype(np.uint64)
        il.add_entries(ln, ids, rng.integers(0, 256, 2 * len(ids)).astype(np.uint8))
    lists = torch.arange(nlist, device=cuda)
    for make in (RocInvertedLists, InterleavedRocInvertedLists):
        built = make(il, device=cuda)
        save_invlists(tmp_path / "c.npz", built)
        before = RocDecoder.launches
        loaded = load_invlists(tmp_path / "c.npz", device=cuda)
        assert loaded.decoder.device.type == "cuda"
        for got, want in zip(loaded.decode_lists(lists), built.decode_lists(lists)):
            assert torch.equal(got, want)
        torch.cuda.synchronize()
        assert RocDecoder.launches > before
        assert loaded.compressed_ids_size_in_bytes == built.compressed_ids_size_in_bytes
        for ln in range(nlist):
            np.testing.assert_array_equal(loaded.get_codes(ln), built.get_codes(ln))
    xb = torch.from_numpy(rng.standard_normal((2000, 16)).astype(np.float32)).to(cuda)
    g, _ = build_nsg(xb, R=12)
    blk = RocBlockGraph(g, block=16)
    save_graph(tmp_path / "g.npz", blk)
    before = RocDecoder.chained_launches
    loaded = load_graph(tmp_path / "g.npz", device=cuda)
    nodes = torch.arange(g.N, device=cuda)
    for got, want in zip(loaded.get_neighbors_batch(nodes), blk.get_neighbors_batch(nodes)):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert RocDecoder.chained_launches > before


def test_bench_drivers_on_card(cuda, tmp_path):
    """Two experiment drivers at a tiny size on the card, each through its
    command line with its default device: P1 over every id method (the ROC
    rows launch both kernels) and the codec alone (every lane round-trips
    through the decode kernel, the encode kernel's streams equal the native
    host codec's)."""
    from vector_db_id_compression_tpu_torch.bench import bench_invlists, codec_scale

    enc, dec = RocEncoder.launches, RocDecoder.launches
    rows = bench_invlists.main(["--synth_scale", "0.02", "--index", "IVF16,Flat", "--runs", "1",
                                "--nprobe", "1", "4", "--out", str(tmp_path / "ivf.csv")])
    assert len(rows) == 12 and len({(r["nprobe"], r["recall_1"]) for r in rows}) == 2
    assert RocEncoder.launches > enc and RocDecoder.launches > dec
    enc, dec = RocEncoder.launches, RocDecoder.launches
    row = codec_scale.main(["--ntotal", "30000", "--nlist", "16", "--runs", "1",
                            "--chunk-target", "256"])
    assert row["lanes"] > 16 and row["decode_mids_s"] > 0 and row["encode_mids_s"] > 0
    assert RocEncoder.launches > enc and RocDecoder.launches > dec

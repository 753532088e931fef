"""Interleaved ROC in the port against the JAX package's.

The codec (``codecs/roc_interleaved.py``) and the container
(``InterleavedRocInvertedLists``) must produce exactly the JAX package's
streams: per lane (chunk entry) the same head, stack words, stack length and
MT19937 draw count; the same sizes, code order and decoded ids. The JAX
container decodes per size bucket and the port over one flat lane table, so
only the entries' own streams can be compared, and they must be equal.
"""

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.codecs import roc_interleaved as jri
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.store import invlists as jinv
from vector_db_id_compression_tpu_torch.codecs import roc_interleaved as tri
from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe, roc_encode
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
from vector_db_id_compression_tpu_torch.store import invlists as tinv


def _distinct(rng, n, bits):
    return rng.choice(1 << bits, size=n, replace=False).astype(np.uint64)


@pytest.mark.parametrize("n,S", [(10, 4), (500, 8), (7, 7), (1000, 3), (1, 1)])
def test_partition_and_chunk_plan_match_jax(n, S):
    np.testing.assert_array_equal(tri.partition_sizes(n, S), jri.partition_sizes(n, S))
    ids = np.sort(_distinct(np.random.default_rng(n), n, 20))
    ids[0] = 0 if n > 1 else ids[0]
    for got, want in zip(tri.chunk_plan(ids, S), jri.chunk_plan(ids, S)):
        if isinstance(got, list):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def _assert_lane_equal(states, lane, ref_states, ref_lane):
    """One lane's stream equal to the JAX lane's (u64 head and u32 words as
    the bit patterns the port stores in int64 and int32)."""
    n = int(np.asarray(ref_states.stack_len)[ref_lane])
    assert int(states.stack_len[lane]) == n
    assert int(states.head[lane]) == int(np.asarray(ref_states.head)[ref_lane].astype(np.int64))
    np.testing.assert_array_equal(states.stack[lane, :n].numpy().view(np.uint32),
                                  np.asarray(ref_states.stack)[ref_lane, :n].view(np.uint32))
    assert int(states.mt_ctr[lane]) == int(np.asarray(ref_states.mt_ctr)[ref_lane])


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_interleaved_encode_matches_jax(S):
    rng = np.random.default_rng(S)
    ids = _distinct(rng, 500, 16)
    env, order = tri.interleaved_encode(ids, S, device="cpu")
    ref, ref_order = jri.interleaved_encode(ids, S)
    for s in range(S):
        _assert_lane_equal(env.states, s, ref.states, s)
    np.testing.assert_array_equal(env.lane_lengths, ref.lane_lengths)
    np.testing.assert_array_equal(env.lane_lo, ref.lane_lo)
    np.testing.assert_array_equal(env.lane_prec, ref.lane_prec)
    np.testing.assert_array_equal(order, ref_order)
    assert env.size_bytes == ref.size_bytes and env.n == 500
    dec = tri.interleaved_decode(env)
    np.testing.assert_array_equal(dec, jri.interleaved_decode(ref))
    np.testing.assert_array_equal(dec, ids[order])  # the order contract


def test_s1_lane_is_the_single_stream():
    """At S = 1 with lo = 0 the lane stream is the host roc_encode stream
    (the port of the JAX package's tests/test_roc_interleaved.py:53)."""
    rng = np.random.default_rng(10)
    ids = _distinct(rng, 300, 14)
    ids[np.argmin(ids)] = 0  # lo == 0: rebasing is a no-op
    env, _ = tri.interleaved_encode(ids, 1, device="cpu")
    st, _ = roc_encode(ids, precision_for_max_id_safe(int(ids.max())))
    assert int(env.states.head[0]) == st.head
    n = int(env.states.stack_len[0])
    assert n == len(st.stack)
    np.testing.assert_array_equal(env.states.stack[0, :n].numpy().view(np.uint32),
                                  np.array(st.stack, dtype=np.uint32))


def test_interleaved_encode_rejects_bad_input():
    with pytest.raises(ValueError):
        tri.interleaved_encode(np.arange(3, dtype=np.uint64), 4, device="cpu")
    with pytest.raises(ValueError):
        tri.interleaved_encode(np.array([1 << 63], dtype=np.uint64), 1, device="cpu")


# ------------------------------------------------------------------ container


def make_il(module, nlist=6, ntotal=3000, code_size=4, seed=0):
    """The JAX package's tests/test_interleaved_container.py fixture, in
    either package's InvertedLists."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, nlist, ntotal)
    codes = rng.integers(0, 256, (ntotal, code_size), dtype=np.uint8)
    il = module.InvertedLists(nlist, code_size)
    for ln in range(nlist):
        members = np.flatnonzero(assign == ln).astype(np.uint64)
        il.add_entries(ln, members, codes[members].reshape(-1))
    return il


def make_ragged(module):
    """The ragged sizes of the JAX package's prepared-translate test, with
    20-bit ids, S = 4 past 16 ids."""
    rng = np.random.default_rng(23)
    sizes = [0, 3, 17, 40, 41, 43, 8, 97, 100, 5]
    il = module.InvertedLists(len(sizes), 2)
    ids = rng.choice(1 << 20, size=sum(sizes), replace=False)
    codes = rng.integers(0, 256, 2 * sum(sizes)).astype(np.uint8)
    pos = 0
    for ln, n in enumerate(sizes):
        il.add_entries(ln, ids[pos:pos + n].astype(np.uint64), codes[2 * pos:2 * (pos + n)])
        pos += n
    return il


CONTAINERS = {
    "auto": (lambda m: make_il(m, nlist=3, ntotal=3000), {}),
    "fixed4": (make_il, dict(interleave=4, interleave_min=64)),
    "ragged": (make_ragged, dict(interleave=4, interleave_min=16)),
}


@pytest.fixture(scope="module", params=sorted(CONTAINERS))
def pair(request):
    """(JAX container, port container, the source lists) on one input."""
    make, kw = CONTAINERS[request.param]
    jil, til = make(jinv), make(tinv)
    return (jinv.InterleavedRocInvertedLists(jil, **kw),
            tinv.InterleavedRocInvertedLists(til, **kw, device="cpu"), til)


def test_container_streams_match_jax(pair):
    jc, tc, il = pair
    for ln in range(il.nlist):
        keys = jc._entries_of[ln]
        assert int(tc.n_lanes[ln]) == len(keys)
        for s, e in enumerate(keys):
            bi, lane = jc._ent_to_bucket[e]
            _assert_lane_equal(tc.decoder.states, int(tc._lane_start[ln]) + s,
                               jc._states[bi], lane)
    assert tc.compressed_ids_size_in_bytes == jc.compressed_ids_size_in_bytes
    assert tc.overhead_in_bytes == jc.overhead_in_bytes
    np.testing.assert_array_equal(tc.id_symbol_precision, jc.id_symbol_precision)
    for ln in range(il.nlist):
        np.testing.assert_array_equal(tc.get_codes(ln), jc.get_codes(ln))


def test_container_decode_lists_matches_jax(pair):
    jc, tc, il = pair
    lists = np.arange(il.nlist)
    jids, jlens = jc.decode_lists(lists)
    tids, tlens = tc.decode_lists(torch.from_numpy(lists))
    np.testing.assert_array_equal(tlens.numpy(), jlens)
    np.testing.assert_array_equal(tids.numpy().view(np.uint64), jids)
    for ln in range(il.nlist):
        got = tids[ln, : tlens[ln]].numpy().view(np.uint64)
        np.testing.assert_array_equal(np.sort(got), np.sort(il.ids[ln]))
    # a subset, repeated and out of order
    sub = np.array([il.nlist - 1, 0, il.nlist - 1, 1])
    np.testing.assert_array_equal(tc.decode_lists(torch.from_numpy(sub))[0].numpy()
                                  .view(np.uint64), jc.decode_lists(sub)[0])


def test_container_decode_select_matches_jax(pair):
    """Offsets in every chunk, the larger (first n % S) and the smaller ones,
    and at both ends of each list."""
    jc, tc, il = pair
    lens = il.lengths
    lns, offs = [], []
    rng = np.random.default_rng(5)
    for ln in np.flatnonzero(lens > 0):
        n = int(lens[ln])
        take = np.unique(np.concatenate([[0, n - 1], rng.integers(0, n, 12)]))
        lns += [ln] * len(take)
        offs += take.tolist()
    lns, offs = np.array(lns, np.int64), np.array(offs, np.int64)
    perm = rng.permutation(len(lns))
    lns, offs = lns[perm], offs[perm]
    want = jc.decode_select(lns, offs)
    got = tc.decode_select(torch.from_numpy(lns), torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # the label's id is the decoded list's id at that offset
    dec, _ = tc.decode_lists(torch.from_numpy(lns))
    np.testing.assert_array_equal(got.numpy(), dec[torch.arange(len(lns)), offs].numpy())


def test_short_lists_stay_single_stream():
    til, jil = make_il(tinv, nlist=8, ntotal=400), make_il(jinv, nlist=8, ntotal=400)
    for kw in ({}, dict(interleave=4, interleave_min=4096)):
        c = tinv.InterleavedRocInvertedLists(til, **kw, device="cpu")
        assert (c.n_lanes == 1).all() and c.overhead_in_bytes == 0
        roc = tinv.RocInvertedLists(til, device="cpu")
        assert c.compressed_ids_size_in_bytes == roc.compressed_ids_size_in_bytes
        assert (c.compressed_ids_size_in_bytes
                == jinv.InterleavedRocInvertedLists(jil, **kw).compressed_ids_size_in_bytes)
        for ln in range(til.nlist):
            np.testing.assert_array_equal(c.get_codes(ln), roc.get_codes(ln))


def test_auto_policy_lane_counts():
    til = make_il(tinv, nlist=5, ntotal=4000)
    c = tinv.InterleavedRocInvertedLists(til, device="cpu")
    t = c.AUTO_CHUNK_TARGET
    assert c.interleave == "auto" and t == 512
    for ln, n in enumerate(til.lengths):
        assert c.n_lanes[ln] == (-(-n // t) if n > (3 * t) // 2 else 1)
    with pytest.raises(ValueError):
        tinv.InterleavedRocInvertedLists(til, interleave=0, device="cpu")


def test_empty_interleaved_container_searches_as_jax():
    """The interleaved container over lists without ids builds as JAX's
    (sizes 0 and 0, no lanes) and an index searches it: every slot empty."""
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((64, 8)).astype(np.float32)
    jidx = JaxIndexIVF(8, 16, storage="flat")
    jidx.train(xb)
    tidx = IndexIVF(8, 16, device="cpu")
    tidx.centroids = torch.from_numpy(np.array(jidx.centroids))
    jc = jinv.InterleavedRocInvertedLists(jinv.InvertedLists(16, 32))
    tc = tinv.InterleavedRocInvertedLists(tinv.InvertedLists(16, 32), device="cpu")
    assert (tc.compressed_ids_size_in_bytes, tc.overhead_in_bytes) == (
        jc.compressed_ids_size_in_bytes, jc.overhead_in_bytes) == (0, 0)
    assert tc.decoder.states.head.shape == (0,) and not tc.n_lanes.any()
    ids, lens = tc.decode_lists(torch.arange(16))
    jids, jlens = jc.decode_lists(np.arange(16))
    np.testing.assert_array_equal(ids.numpy().view(np.uint64), jids)
    np.testing.assert_array_equal(lens.numpy(), jlens)
    jidx.replace_invlists(jc)
    tidx.replace_invlists(tc)
    D_ref, I_ref = jidx.search_defer_id_decoding(xb[:5], 4, nprobe=3)
    D, I = tidx.search_defer_id_decoding(xb[:5], 4, nprobe=3)
    np.testing.assert_array_equal(I.numpy(), I_ref)
    np.testing.assert_array_equal(D.numpy(), D_ref)
    assert (I_ref == -1).all() and np.isinf(D_ref).all()

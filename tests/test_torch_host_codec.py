"""The port's host ROC codec against the JAX package's.

The order statistics (``core/order_stats.py``), the Python host codec
(``core/rans.py`` + ``codecs/roc.py``) and the native C++ codec
(``native/``) must produce exactly what the JAX package's produce on the same
inputs: the same ranks and traversals, the same head, stack words, sampling
order and MT19937 draw count. The native codec is also held against the
port's lane-batched plain codec (``RocEncoder.encode`` on CPU tensors).
"""

import subprocess

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu import native as jnative
from vector_db_id_compression_tpu.codecs import roc as jroc
from vector_db_id_compression_tpu.core import order_stats as jos
from vector_db_id_compression_tpu_torch import native
from vector_db_id_compression_tpu_torch.codecs import roc_device as rd
from vector_db_id_compression_tpu_torch.codecs.roc import (
    precision_for_max_id,
    precision_for_max_id_safe,
    roc_decode,
    roc_encode,
)
from vector_db_id_compression_tpu_torch.core import order_stats as tos
from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
from vector_db_id_compression_tpu_torch.store.ragged import pad_lists

# ---------------------------------------------------------------- order stats


def test_insert_sequence_matches_jax():
    """The reference's insert phase (test_fenwick_tree.cpp:16-78): b, a, b,
    d, c, e, c, c with duplicates; (symbol, start, freq) and the traversal
    after every insert."""
    port, ref = tos.InsertRank(), jos.InsertRank()
    for sym in "babdcecc":
        assert port.insert_then_forward_lookup(ord(sym)) == ref.insert_then_forward_lookup(ord(sym))
        assert port.as_sorted() == ref.as_sorted()
    assert len(port) == len(ref) == 8


def test_remove_sequence_matches_jax():
    """The reference's remove phase (test_fenwick_tree.cpp:80-135): removals
    by rank from a, b, b, c, c, c, d, e."""
    vals = np.array([ord(c) for c in "abbcccde"])
    port = tos.FenwickOrderStats.from_multiset(vals)
    ref = jos.FenwickOrderStats.from_multiset(vals)
    for k in (6, 1, 3, 4, 0, 1, 0, 0):
        assert port.reverse_lookup_then_remove(k) == ref.reverse_lookup_then_remove(k)
        assert port.inorder_traversal() == ref.inorder_traversal()
    assert len(port) == len(ref) == 0


def test_u64_sequence_matches_jax():
    """test_FenwickTree_2 (test_fenwick_tree.cpp:138-183) on u64 symbols."""
    port, ref = tos.InsertRank(), jos.InsertRank()
    for sym in (83, 77, 15, 86, 93):
        assert port.insert_then_forward_lookup(sym) == ref.insert_then_forward_lookup(sym)
    vals = np.array([15, 77, 83, 86, 93], dtype=np.uint64)
    f, g = tos.FenwickOrderStats.from_multiset(vals), jos.FenwickOrderStats.from_multiset(vals)
    assert f.reverse_lookup_then_remove(3) == g.reverse_lookup_then_remove(3) == (86, 3, 1)
    assert f.inorder_traversal() == g.inorder_traversal() == [15, 77, 83, 93]


def test_select_remove_out_of_range():
    f = tos.FenwickOrderStats.from_multiset(np.array([1, 2, 3]))
    with pytest.raises(IndexError):
        f.select_remove(3)
    with pytest.raises(IndexError):
        f.reverse_lookup_then_remove(-1)


@pytest.mark.parametrize("trial", range(3))
def test_randomized_duals_match_jax(trial):
    """Random select-removes over a multiset with heavy duplicates, then the
    decode-side inserts in the removal order: same symbols and ranks."""
    rng = np.random.default_rng(trial)
    vals = rng.integers(0, 20, size=60)
    port = tos.FenwickOrderStats.from_multiset(vals)
    ref = jos.FenwickOrderStats.from_multiset(vals)
    order = []
    while len(port):
        k = int(rng.integers(0, len(port)))
        got = port.select_remove(k)
        assert got == ref.select_remove(k)
        order.append(got[1])
    ins_p, ins_r = tos.InsertRank(), jos.InsertRank()
    assert [ins_p.insert(s) for s in order] == [ins_r.insert(s) for s in order]
    assert ins_p.as_sorted() == sorted(int(v) for v in vals)


def test_rank_matches_jax_under_removals():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 50, size=40)
    port = tos.FenwickOrderStats.from_multiset(vals)
    ref = jos.FenwickOrderStats.from_multiset(vals)
    for _ in range(30):
        k = int(rng.integers(0, len(port)))
        port.select_remove(k)
        ref.select_remove(k)
        assert [port.rank(i) for i in range(port._n + 1)] == [ref.rank(i) for i in range(ref._n + 1)]


# ---------------------------------------------------------------- host codec


def _distinct(rng, n, bits):
    return rng.choice(2**bits - 1, size=n, replace=False).astype(np.uint64) + 1


def host_cases():
    """(name, ids, precision): n = 0 and 1, a power-of-two max id under the
    reference's precision rule, ids near 2^32, 40-bit ids."""
    rng = np.random.default_rng(11)
    pow2 = _distinct(rng, 50, 15)
    pow2[0] = 1 << 16  # max id 2^16: the reference rule gives 16 bits
    near32 = (np.uint64(2**32 - 1) - _distinct(rng, 200, 12)).astype(np.uint64)
    cases = [
        ("n0", np.zeros(0, np.uint64), 8),
        ("n1", np.array([5], np.uint64), 3),
        ("n1_p0", np.array([1], np.uint64), 0),
        ("n7", _distinct(rng, 7, 8), None),
        ("n100_20bit", _distinct(rng, 100, 20), None),
        ("n1000_20bit", _distinct(rng, 1000, 20), None),
        ("pow2_max", pow2, precision_for_max_id(1 << 16)),
        ("near_2_32", near32, None),
        ("n300_40bit", _distinct(rng, 300, 40), None),
    ]
    return [(name, ids, precision_for_max_id_safe(int(ids.max())) if p is None else p)
            for name, ids, p in cases]


HOST_CASES = host_cases()


@pytest.mark.parametrize("name,ids,precision", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_roc_encode_matches_jax_exactly(name, ids, precision):
    st, order = roc_encode(ids, precision)
    ref, ref_order = jroc.roc_encode(ids, precision)
    assert st.head == ref.head
    assert st.stack == ref.stack
    assert st.mt_draws == ref.mt_draws
    np.testing.assert_array_equal(order, ref_order)
    assert st.size_bytes == ref.size_bytes


@pytest.mark.parametrize("name,ids,precision", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_roc_decode_round_trip(name, ids, precision):
    st, order = roc_encode(ids, precision)
    decoded = roc_decode(st.clone(), len(ids), precision)
    ref, _ = jroc.roc_encode(ids, precision)
    np.testing.assert_array_equal(decoded, jroc.roc_decode(ref, len(ids), precision))
    if len(ids) and int(ids.max()) < 1 << precision:  # else the codec drops top bits
        np.testing.assert_array_equal(decoded, ids[order])  # order contract


def test_roc_encode_continues_a_state():
    """A second list encoded on the first's state, as the chained graph
    container does: same stream as the JAX codec's."""
    rng = np.random.default_rng(4)
    a, b = _distinct(rng, 40, 16), _distinct(rng, 25, 16)
    st, _ = roc_encode(a, 16)
    st, _ = roc_encode(b, 16, state=st)
    ref, _ = jroc.roc_encode(a, 16)
    ref, _ = jroc.roc_encode(b, 16, state=ref)
    assert (st.head, st.stack, st.mt_draws) == (ref.head, ref.stack, ref.mt_draws)
    np.testing.assert_array_equal(roc_decode(st, 25, 16), jroc.roc_decode(ref, 25, 16))


def test_roc_vs_reference_harness(ref_codec_harness):
    """One case against the reference C++ codec (skips without its checkout)."""
    ids = _distinct(np.random.default_rng(0), 100, 20)
    precision = precision_for_max_id(int(ids.max()))
    res = subprocess.run([str(ref_codec_harness), str(precision)],
                         input=f"{len(ids)}\n" + "\n".join(str(int(v)) for v in ids) + "\n",
                         capture_output=True, text=True, check=True)
    out = res.stdout.split()
    stack_len = int(out[3])
    st, _ = roc_encode(ids, precision)
    assert st.head == int(out[1])
    assert st.stack == [int(x) for x in out[4:4 + stack_len]]
    np.testing.assert_array_equal(
        roc_decode(st, len(ids), precision),
        np.array(out[5 + stack_len:5 + stack_len + len(ids)], dtype=np.uint64))


# -------------------------------------------------------------- native codec


def _rand_lists(rng, n_lists, max_len, id_bits):
    return [rng.choice(1 << id_bits, size=int(rng.integers(1, max_len)),
                       replace=False).astype(np.uint64) for _ in range(n_lists)]


def _assert_native_equal(got, want):
    for a, b in zip(got[:3], want[:3]):  # heads, stacks, stack_lens
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[3], want[3]):    # orders
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[4], want[4])  # MT draws


@pytest.mark.parametrize("n_lists,max_len,bits", [(12, 200, 14), (20, 600, 32), (5, 40, 40)])
def test_native_encode_matches_jax_native(n_lists, max_len, bits):
    rng = np.random.default_rng(bits)
    lists = _rand_lists(rng, n_lists, max_len, bits)
    prec = [precision_for_max_id_safe(int(v.max())) for v in lists]
    got = native.roc_encode_lists(lists, prec)
    _assert_native_equal(got, jnative.roc_encode_lists(lists, prec))
    # and the host oracle, list by list
    for i, (ids, p) in enumerate(zip(lists, prec)):
        st, order = roc_encode(ids, p)
        assert int(got[0][i]) == st.head and int(got[4][i]) == st.mt_draws
        np.testing.assert_array_equal(got[1][i, : got[2][i]], np.array(st.stack, np.uint32))
        np.testing.assert_array_equal(got[3][i], order)


@pytest.mark.parametrize("bits", [16, 33])
def test_native_matches_plain_lane_codec(bits):
    """Native streams equal the lane-batched plain codec's (the CUDA
    kernels' plain version), and the native decode equals its decode."""
    rng = np.random.default_rng(bits + 1)
    lists = _rand_lists(rng, 16, 300, bits)
    prec = np.array([precision_for_max_id_safe(int(v.max())) for v in lists], np.int32)
    heads, stacks, lens, orders, mt = native.roc_encode_lists(lists, prec)
    perms = [np.argsort(v, kind="stable") for v in lists]
    n_max = max(len(v) for v in lists)
    table = pad_lists([v[p] for v, p in zip(lists, perms)], n_max, dtype=np.uint64)
    lengths = torch.tensor([len(v) for v in lists], dtype=torch.int32)
    states, order = RocEncoder.encode(torch.from_numpy(table.view(np.int64)), lengths,
                                      torch.from_numpy(prec))
    np.testing.assert_array_equal(states.head.numpy().view(np.uint64), heads)
    np.testing.assert_array_equal(states.stack_len.numpy(), lens)
    np.testing.assert_array_equal(states.mt_ctr.numpy(), mt.astype(np.int32))
    for i, v in enumerate(lists):
        np.testing.assert_array_equal(states.stack[i, : lens[i]].numpy().view(np.uint32),
                                      stacks[i, : lens[i]])
        np.testing.assert_array_equal(perms[i][order[i, : len(v)].numpy()], orders[i])
    decoded = native.roc_decode_lists(heads, stacks, lens, lengths.numpy(), prec)
    plain = RocDecoder(states, lengths, torch.from_numpy(prec), rd.default_pool(n_max),
                       n_max).decode().numpy().view(np.uint64)
    for i, v in enumerate(lists):
        np.testing.assert_array_equal(decoded[i], plain[i, : len(v)])
        np.testing.assert_array_equal(decoded[i], v[orders[i]])


def test_native_single_thread_matches_many():
    rng = np.random.default_rng(2)
    lists = _rand_lists(rng, 32, 100, 12)
    prec = [precision_for_max_id_safe(int(v.max())) for v in lists]
    one = native.roc_encode_lists(lists, prec, n_threads=1)
    _assert_native_equal(one, native.roc_encode_lists(lists, prec, n_threads=8))
    lengths = [len(v) for v in lists]
    for a, b in zip(native.roc_decode_lists(*one[:3], lengths, prec, n_threads=1),
                    native.roc_decode_lists(*one[:3], lengths, prec, n_threads=8)):
        np.testing.assert_array_equal(a, b)


def test_native_mt_underflow_path():
    """Short lists with high precision drain the stack and draw MT19937
    initial bits (the JAX package's tests/test_native.py case)."""
    ids = np.array([3, 9], dtype=np.uint64)
    got = native.roc_encode_lists([ids], [4])
    _assert_native_equal(got, jnative.roc_encode_lists([ids], [4]))
    st, order = roc_encode(ids, 4)
    assert st.mt_draws == got[4][0]
    assert got[0][0] == st.head
    decoded = native.roc_decode_lists(*got[:3], [2], [4])[0]
    np.testing.assert_array_equal(decoded, ids[order])


def test_native_raises_on_stack_overflow():
    ids = np.arange(1, 400, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="stack capacity 2 overflowed"):
        native.roc_encode_lists([ids], [9], cap=2)

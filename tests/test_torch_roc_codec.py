"""The port's lane-batched ROC codec (the plain version of both CUDA kernels)
against the JAX package's codec, bit for bit.

Inputs are made with numpy from a seed and handed to both packages. Encode
must give the same head, stack words, stack length, MT19937 draw count and
sampling order; decode the same ids. The cases include every power-of-two
list length the int64 carrying of the u64 head must survive (a threshold of
exactly 2^63), mixed precisions in one batch (p = 0 slices) and ids just
below 2^32.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.codecs import roc as jroc
from vector_db_id_compression_tpu.codecs import roc_device as rd
from vector_db_id_compression_tpu.core.mt19937 import mt19937_pool as jax_pool
from vector_db_id_compression_tpu_torch.codecs import roc as troc
from vector_db_id_compression_tpu_torch.codecs import roc_device as td
from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder

# (list lengths, id bits per list); "near32" draws ids from [2^32 - 5000, 2^32)
CASES = [
    ([64], 16),
    ([1, 5, 128, 37], 16),
    ([513, 2, 300], 20),
    ([1000] * 3, 24),
    ([1, 64, 512], 20),
    ([300, 300, 200, 5], [20, 32, 8, 3]),
    ([200, 17, 1], "near32"),
]
CASE_IDS = ["64x16b", "mixed-small", "513-2-300", "3x1000", "pow2-lengths",
            "mixed-precision", "near-2^32"]


def make_batch(case_no: int):
    """Sorted ids u64[B, n_max], lengths and safe precisions i32[B]."""
    sizes, bits = CASES[case_no]
    rng = np.random.default_rng(100 + case_no)
    B, n_max = len(sizes), max(sizes)
    ids = np.zeros((B, n_max), dtype=np.uint64)
    prec = np.zeros(B, dtype=np.int32)
    for b, n in enumerate(sizes):
        if bits == "near32":
            v = np.uint64(2**32 - 1) - rng.choice(5000, n, replace=False).astype(np.uint64)
        else:
            nb = bits[b] if isinstance(bits, list) else bits
            v = rng.choice(2**nb - 1, size=n, replace=False).astype(np.uint64) + 1
        v = np.sort(v)
        ids[b, :n] = v
        prec[b] = jroc.precision_for_max_id_safe(int(v.max()))
    return ids, np.array(sizes, dtype=np.int32), prec


@lru_cache(maxsize=None)
def jax_codec(case_no: int):
    """JAX encode + decode of a case → numpy (head, stack, stack_len, mt_ctr,
    order, ids)."""
    ids, lengths, prec = make_batch(case_no)
    B, n_max = ids.shape
    maxp = int(prec.max())
    ns = rd.n_slices_for(maxp)
    pool = rd.default_pool(n_max)
    st, order = rd.roc_encode_batch(
        jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(prec), pool,
        rd.fresh_states(B, rd.stack_capacity(n_max, maxp)), ns)
    dec, _ = rd.roc_decode_batch(st, jnp.asarray(lengths), jnp.asarray(prec),
                                 pool, n_max, ns)
    return (np.asarray(st.head), np.asarray(st.stack), np.asarray(st.stack_len),
            np.asarray(st.mt_ctr), np.asarray(order), np.asarray(dec))


def port_encode(case_no: int):
    ids, lengths, prec = make_batch(case_no)
    B, n_max = ids.shape
    maxp = int(prec.max())
    return td.roc_encode_batch(
        torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths),
        torch.from_numpy(prec), td.default_pool(n_max),
        td.fresh_states(B, td.stack_capacity(n_max, maxp)), td.n_slices_for(maxp))


def assert_states_equal(states, order, ref):
    """Port states/order (torch) equal the JAX codec's (numpy), exactly."""
    head, stack, stack_len, mt_ctr, ref_order, _ = ref
    np.testing.assert_array_equal(states.head.numpy().view(np.uint64), head)
    np.testing.assert_array_equal(states.stack_len.numpy(), stack_len)
    np.testing.assert_array_equal(states.mt_ctr.numpy(), mt_ctr)
    words = states.stack.numpy().view(np.uint32)
    for b, n in enumerate(stack_len):
        np.testing.assert_array_equal(words[b, :n], stack[b, :n])
    np.testing.assert_array_equal(order.numpy(), ref_order)
    assert not bool(states.err.any())


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_plain_encode_matches_jax(case_no):
    states, order = port_encode(case_no)
    assert_states_equal(states, order, jax_codec(case_no))


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_plain_decode_matches_jax(case_no):
    ids, lengths, prec = make_batch(case_no)
    n_max = ids.shape[1]
    states, _ = port_encode(case_no)
    dec, final = td.roc_decode_batch(
        states, torch.from_numpy(lengths), torch.from_numpy(prec),
        td.default_pool(n_max), n_max, td.n_slices_for(int(prec.max())))
    assert not bool(final.err.any())
    np.testing.assert_array_equal(dec.numpy().view(np.uint64), jax_codec(case_no)[5])
    # lossless: each lane decodes to its id set
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(np.sort(dec.numpy()[b, :n]).view(np.uint64),
                                      ids[b, :n])


@pytest.mark.parametrize("case_no", [1, 5], ids=["mixed-small", "mixed-precision"])
def test_wrappers_run_plain_version_on_cpu(case_no):
    """On CPU tensors the wrappers give the plain version's result and launch
    no kernel."""
    ids, lengths, prec = make_batch(case_no)
    launches = (RocEncoder.launches, RocDecoder.launches)
    lengths_t, prec_t = torch.from_numpy(lengths), torch.from_numpy(prec)
    states, order = RocEncoder.encode(torch.from_numpy(ids.view(np.int64)),
                                      lengths_t, prec_t)
    ref = jax_codec(case_no)
    assert_states_equal(states, order, ref)
    dec = RocDecoder(states, lengths_t, prec_t, td.default_pool(ids.shape[1]),
                     ids.shape[1])
    np.testing.assert_array_equal(dec.decode().numpy().view(np.uint64), ref[5])
    lanes = torch.tensor([len(lengths) - 1, 0])
    np.testing.assert_array_equal(dec.decode_lanes(lanes).numpy().view(np.uint64),
                                  ref[5][lanes.numpy()])
    assert (RocEncoder.launches, RocDecoder.launches) == launches


@pytest.mark.parametrize("past_end", [-1, 0, 1 << 40], ids=["negative", "at-end", "far"])
def test_decode_lanes_out_of_range_raises(past_end):
    """A lane outside the table raises IndexError (on CUDA the kernel's
    error flag reports it; tests/test_torch_cuda.py)."""
    ids, lengths, prec = make_batch(1)
    lengths_t, prec_t = torch.from_numpy(lengths), torch.from_numpy(prec)
    states, _ = RocEncoder.encode(torch.from_numpy(ids.view(np.int64)), lengths_t, prec_t)
    dec = RocDecoder(states, lengths_t, prec_t, td.default_pool(ids.shape[1]), ids.shape[1])
    lane = -1 if past_end < 0 else len(lengths) + past_end
    with pytest.raises(IndexError, match="lane indices"):
        dec.decode_lanes(torch.tensor([0, lane]))


def test_wrappers_refuse_other_devices():
    """No silent route: a tensor that is neither on the CPU nor on a CUDA
    device raises instead of running the plain version."""
    ids = torch.zeros((2, 4), dtype=torch.int64, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        RocEncoder.encode(ids, lens, lens)
    states = td.fresh_states(2, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        RocDecoder(states, lens, lens, td.default_pool(4, device="meta"), 4)


def test_pallas_kernels_interpret_small():
    """One small batch against the Pallas kernels in interpret mode."""
    from vector_db_id_compression_tpu.ops.roc_encode_pallas import roc_encode_pallas
    from vector_db_id_compression_tpu.ops.roc_pallas import roc_decode_pallas

    case_no = 1  # lengths [1, 5, 128, 37]
    ids, lengths, prec = make_batch(case_no)
    n_max = ids.shape[1]
    states, order = port_encode(case_no)
    pst, porder, ok = roc_encode_pallas(ids, lengths, prec, interpret=True)
    assert ok
    np.testing.assert_array_equal(states.head.numpy().view(np.uint64),
                                  np.asarray(pst.head))
    np.testing.assert_array_equal(states.stack_len.numpy(), np.asarray(pst.stack_len))
    np.testing.assert_array_equal(states.mt_ctr.numpy(), np.asarray(pst.mt_ctr))
    porder = np.asarray(porder)  # the Pallas kernel pads order with 0, not -1
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(order.numpy()[b, :n], porder[b, :n])
    words, pwords = states.stack.numpy().view(np.uint32), np.asarray(pst.stack)
    for b, n in enumerate(states.stack_len.numpy()):
        np.testing.assert_array_equal(words[b, :n], pwords[b, :n])
    pids, ok = roc_decode_pallas(
        rd.RocStates(*(jnp.asarray(a) for a in jax_codec(case_no)[:4]),
                     err=jnp.zeros(len(lengths), bool)),
        lengths, prec, rd.default_pool(n_max), n_max, interpret=True)
    assert ok
    dec, _ = td.roc_decode_batch(states, torch.from_numpy(lengths),
                                 torch.from_numpy(prec), td.default_pool(n_max),
                                 n_max, td.n_slices_for(int(prec.max())))
    np.testing.assert_array_equal(dec.numpy().astype(np.uint64), pids.astype(np.uint64))


@pytest.mark.parametrize("max_id", [1, 2, 3, 255, 256, 257, 2**20, 2**32 - 1, 2**32, 2**40 + 3])
def test_precision_rules_match_jax(max_id):
    assert troc.precision_for_max_id(max_id) == jroc.precision_for_max_id(max_id)
    assert (troc.precision_for_max_id_safe(max_id)
            == jroc.precision_for_max_id_safe(max_id))


@pytest.mark.parametrize("n_max,maxp", [(1, 1), (64, 16), (1500, 20), (70000, 32), (10, 63)])
def test_shape_rules_match_jax(n_max, maxp):
    assert td.stack_capacity(n_max, maxp) == rd.stack_capacity(n_max, maxp)
    assert td.n_slices_for(maxp) == rd.n_slices_for(maxp)
    assert td.digit_bits_for(n_max) == rd.digit_bits_for(n_max)


def test_default_pool_matches_jax():
    pool = td.default_pool(300)
    np.testing.assert_array_equal(pool.numpy().view(np.uint32),
                                  np.asarray(rd.default_pool(300)))
    np.testing.assert_array_equal(pool.numpy().view(np.uint32)[:50],
                                  jax_pool(count=50))

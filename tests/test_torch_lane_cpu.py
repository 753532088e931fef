"""The CUDA kernels' per-lane arithmetic, built for the CPU.

``csrc/roc_lane.cuh`` holds every step the two kernels run per lane, as
__host__ __device__ functions. Here a plain C++ compiler builds that header
behind a loop over lanes that does what each kernel thread does, and the
result is held bit-exact against the port's plain version (itself held
against the JAX codec in test_torch_roc_codec.py and, for the chained mode,
test_torch_graph.py) on the same codec cases.
The CUDA kernels themselves run only on the card (test_torch_cuda.py,
chip_smoke.py); this is the check of their arithmetic that runs without one.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_graph import CHAINED_CASES, CHAINED_IDS, make_chained_batch
from test_torch_roc_codec import CASE_IDS, CASES, make_batch
from vector_db_id_compression_tpu_torch.codecs import roc_device as td
from vector_db_id_compression_tpu_torch.ops._build import CSRC

# One loop iteration = one kernel thread (roc_encode.cu / roc_decode.cu).
HARNESS = r"""
#include "roc_lane.cuh"

extern "C" void encode_lanes(const uint64_t* ids, const int32_t* lengths,
    const int32_t* precision, int B, int S, int n_max, const uint32_t* pool,
    int pool_size, int n_slices, int32_t* tree, uint64_t* head,
    uint32_t* stack, int cap, int32_t* stack_len, int32_t* mt_ctr,
    int32_t* order, int32_t* err) {
  for (int lane = 0; lane < B; ++lane) {
    roc::LaneState s{roc::RANS_L,
                     roc::Strided<uint32_t>{stack + (int64_t)lane * cap, 1},
                     cap, 0, pool, pool_size, 0, 0};
    roc::encode_slots(s, ids + (int64_t)lane * S * n_max, lengths + (int64_t)lane * S,
                      precision + (int64_t)lane * S, S, n_slices,
                      roc::Strided<int32_t>{tree + lane, B},
                      order ? order + (int64_t)lane * n_max : nullptr, n_max);
    head[lane] = s.head;
    stack_len[lane] = s.len;
    mt_ctr[lane] = s.mt_ctr;
    err[lane] = s.err;
  }
}

extern "C" void decode_lanes(const uint64_t* head, const uint32_t* stack,
    int cap, const int32_t* stack_len, const int32_t* mt_ctr,
    const int32_t* lengths, const int32_t* precision, int S, int Q,
    const uint32_t* pool, int pool_size, int n_slices, int n_max,
    uint32_t* scratch, uint64_t* syms, int64_t* ids, int32_t* err) {
  for (int q = 0; q < Q; ++q) {
    roc::Strided<uint32_t> st{scratch + q, Q};
    for (int j = 0; j < stack_len[q] && j < cap; ++j) st[j] = stack[(int64_t)q * cap + j];
    roc::LaneState s{head[q], st, cap, stack_len[q], pool, pool_size, mt_ctr[q], 0};
    roc::decode_slots(s, lengths + (int64_t)q * S, precision + (int64_t)q * S, S,
                      n_slices, roc::Strided<uint64_t>{syms + q, Q},
                      ids + (int64_t)q * S * n_max, n_max);
    err[q] = s.err;
  }
}
"""

@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("roc_lane_cpu")
    (d / "harness.cpp").write_text(HARNESS)
    lib_path = d / "libroc_lane_cpu.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
                    str(d / "harness.cpp"), "-o", str(lib_path)], check=True)
    return ctypes.CDLL(str(lib_path))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def lane_encode(lib, ids, lengths, prec):
    """ids u64[B, n_max] with lengths i32[B] (one list per lane, with the
    sampling order), or u64[B, S, n_max] with lengths i32[B, S] (chained)."""
    chained = ids.ndim == 3
    B, S, n_max = ids.shape if chained else (ids.shape[0], 1, ids.shape[1])
    maxp = int(prec.max())
    cap = td.stack_capacity(S * n_max, maxp)
    pool = td.default_pool(S * n_max).numpy()
    out = dict(head=np.zeros(B, np.uint64), stack=np.zeros((B, cap), np.uint32),
               stack_len=np.zeros(B, np.int32), mt_ctr=np.zeros(B, np.int32),
               order=None if chained else np.zeros((B, n_max), np.int32),
               err=np.zeros(B, np.int32))
    tree = np.zeros((n_max + 1, B), np.int32)
    lib.encode_lanes(_ptr(ids), _ptr(lengths), _ptr(prec), B, S, n_max, _ptr(pool),
                     len(pool), td.n_slices_for(maxp), _ptr(tree), _ptr(out["head"]),
                     _ptr(out["stack"]), cap, _ptr(out["stack_len"]),
                     _ptr(out["mt_ctr"]), None if chained else _ptr(out["order"]),
                     _ptr(out["err"]))
    return out


def lane_decode(lib, enc, lengths, prec, n_max):
    """Decode the lanes of ``lane_encode``'s output → (ids i64[B, S, n_max],
    err i32[B])."""
    B, S = lengths.reshape(len(lengths), -1).shape
    cap = enc["stack"].shape[1]
    pool = td.default_pool(S * n_max).numpy()
    out = np.zeros((B, S, n_max), np.int64)
    err = np.zeros(B, np.int32)
    scratch = np.zeros((cap, B), np.uint32)
    syms = np.zeros((n_max, B), np.uint64)
    lib.decode_lanes(
        _ptr(enc["head"]), _ptr(enc["stack"]), cap, _ptr(enc["stack_len"]),
        _ptr(enc["mt_ctr"]), _ptr(lengths), _ptr(prec), S, B, _ptr(pool), len(pool),
        td.n_slices_for(int(prec.max())), n_max, _ptr(scratch), _ptr(syms), _ptr(out),
        _ptr(err))
    return out, err


def lane_states(enc) -> td.RocStates:
    return td.RocStates(
        head=torch.from_numpy(enc["head"].view(np.int64)),
        stack=torch.from_numpy(enc["stack"].view(np.int32)),
        stack_len=torch.from_numpy(enc["stack_len"]),
        mt_ctr=torch.from_numpy(enc["mt_ctr"]),
        err=torch.zeros(len(enc["head"]), dtype=torch.bool))


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_lane_encode_matches_plain(lane_lib, case_no):
    ids, lengths, prec = make_batch(case_no)
    n_max = ids.shape[1]
    maxp = int(prec.max())
    got = lane_encode(lane_lib, ids, lengths, prec)
    states, order = td.roc_encode_batch(
        torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths),
        torch.from_numpy(prec), td.default_pool(n_max),
        td.fresh_states(len(lengths), td.stack_capacity(n_max, maxp)),
        td.n_slices_for(maxp))
    assert not got["err"].any()
    np.testing.assert_array_equal(got["head"], states.head.numpy().view(np.uint64))
    np.testing.assert_array_equal(got["stack_len"], states.stack_len.numpy())
    np.testing.assert_array_equal(got["mt_ctr"], states.mt_ctr.numpy())
    np.testing.assert_array_equal(got["stack"], states.stack.numpy().view(np.uint32))
    np.testing.assert_array_equal(got["order"], order.numpy())


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_lane_decode_matches_plain(lane_lib, case_no):
    ids, lengths, prec = make_batch(case_no)
    n_max = ids.shape[1]
    maxp = int(prec.max())
    enc = lane_encode(lane_lib, ids, lengths, prec)
    out, err = lane_decode(lane_lib, enc, lengths, prec, n_max)
    ref, _ = td.roc_decode_batch(lane_states(enc), torch.from_numpy(lengths),
                                 torch.from_numpy(prec), td.default_pool(n_max),
                                 n_max, td.n_slices_for(maxp))
    assert not err.any()
    np.testing.assert_array_equal(out[:, 0], ref.numpy())
    # the decoder wrote scratch copies: the stored stacks are untouched
    np.testing.assert_array_equal(enc["stack"], lane_encode(lane_lib, ids, lengths, prec)["stack"])


@pytest.mark.parametrize("case_no", range(len(CHAINED_CASES)), ids=CHAINED_IDS)
def test_lane_chained_encode_matches_plain(lane_lib, case_no):
    """The kernels' chained slot loop (encode_slots) against the plain
    roc_encode_chained."""
    ids, lengths, prec = make_chained_batch(case_no)
    L, S, n_max = ids.shape
    maxp = int(prec.max())
    got = lane_encode(lane_lib, ids, lengths, prec)
    states = td.roc_encode_chained(
        torch.from_numpy(ids.view(np.int64)), torch.from_numpy(lengths),
        torch.from_numpy(prec), td.default_pool(S * n_max),
        td.fresh_states(L, td.stack_capacity(S * n_max, maxp)), td.n_slices_for(maxp))
    assert not got["err"].any()
    np.testing.assert_array_equal(got["head"], states.head.numpy().view(np.uint64))
    np.testing.assert_array_equal(got["stack_len"], states.stack_len.numpy())
    np.testing.assert_array_equal(got["mt_ctr"], states.mt_ctr.numpy())
    np.testing.assert_array_equal(got["stack"], states.stack.numpy().view(np.uint32))


@pytest.mark.parametrize("case_no", range(len(CHAINED_CASES)), ids=CHAINED_IDS)
def test_lane_chained_decode_matches_plain(lane_lib, case_no):
    """The kernels' chained slot loop (decode_slots) against the plain
    roc_decode_chained, and back to the input ids."""
    ids, lengths, prec = make_chained_batch(case_no)
    S, n_max = ids.shape[1:]
    enc = lane_encode(lane_lib, ids, lengths, prec)
    out, err = lane_decode(lane_lib, enc, lengths, prec, n_max)
    ref, _ = td.roc_decode_chained(lane_states(enc), torch.from_numpy(lengths),
                                   torch.from_numpy(prec), td.default_pool(S * n_max),
                                   n_max, td.n_slices_for(int(prec.max())))
    assert not err.any()
    np.testing.assert_array_equal(out, ref.numpy())
    for b, s in np.ndindex(*lengths.shape):
        n = lengths[b, s]
        np.testing.assert_array_equal(np.sort(out[b, s, :n]).view(np.uint64), ids[b, s, :n])

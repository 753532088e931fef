"""The CUDA kernels' per-lane arithmetic, built for the CPU.

``csrc/roc_lane.cuh`` holds every step the two kernels run per lane, as
__host__ __device__ functions. Here a plain C++ compiler builds that header
behind a loop over lanes that does what each kernel lane does, and the
result is held bit-exact against the port's plain version (itself held
against the JAX codec in test_torch_roc_codec.py and, for the chained mode,
test_torch_graph.py) on the same codec cases:

  - the encode's select (a bitmap of the remaining slots and a Fenwick tree
    over its words, in the [row, lane] layout of a block of 32 lanes, as the
    kernel keeps it in shared or global memory);
  - the decode's warp-level rank, built for the CPU as a loop over the 32
    threads of the warp (each thread's share, summed explicitly), with u32
    symbol buffers where every precision is <= 32 and u64 ones always;
  - the chain probe's chains (csrc/probe_chain.cu), which reproduce the
    codec given the decode's ranks and the encode's sampling order.

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
from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe
from vector_db_id_compression_tpu_torch.ops._build import CSRC
from vector_db_id_compression_tpu_torch.ops.probes import ProbeChain, decode_ranks

# One loop iteration = one kernel lane (roc_encode.cu: a thread; roc_decode.cu:
# a warp, whose 32 threads LaneWarp runs as a loop when built for the CPU).
HARNESS = r"""
#include <vector>
#include "roc_lane.cuh"

constexpr int kBlock = 32;  // roc_encode.cu's lanes per block

extern "C" void encode_lanes(const uint64_t* ids, const int32_t* lengths,
    const int32_t* precision, int B, int S, int n_max, const uint32_t* pool,
    int pool_size, int n_slices, uint32_t* scratch, uint64_t* head,
    uint32_t* stack, int cap, int32_t* stack_len, int32_t* mt_ctr,
    int32_t* order, int32_t* err) {
  const int words = roc::select_words(n_max);
  const int64_t block_words = (int64_t)(2 * words + 1) * kBlock;
  for (int lane = 0; lane < B; ++lane) {
    uint32_t* base = scratch + (lane / kBlock) * block_words + lane % kBlock;
    roc::Strided<uint32_t> bits{base, kBlock};
    roc::Strided<int32_t> tree{(int32_t*)base + (int64_t)words * kBlock, kBlock};
    roc::LaneState<roc::Stack<false>> s{roc::RANS_L, {stack + (int64_t)lane * cap},
                                        cap, 0, pool, pool_size, 0, 0};
    roc::encode_slots(s, ids + (int64_t)lane * S * n_max, lengths + (int64_t)lane * S,
                      precision + (int64_t)lane * S, S, n_slices, bits, tree,
                      order ? order + (int64_t)lane * n_max : nullptr, n_max);
    head[lane] = s.head;
    stack_len[lane] = s.len;
    mt_ctr[lane] = s.mt_ctr;
    err[lane] = s.err;
  }
}

template <typename Sym>
void decode_all(const uint64_t* head, const uint32_t* stack, int cap,
    const int32_t* stack_len, const int32_t* mt_ctr, const int32_t* lengths,
    const int32_t* precision, int S, int Q, const uint32_t* pool, int pool_size,
    int n_slices, int n_max, int64_t* ids, int32_t* err) {
  for (int q = 0; q < Q; ++q) {
    std::vector<uint32_t> copy(stack + (int64_t)q * cap, stack + (int64_t)(q + 1) * cap);
    std::vector<Sym> syms(n_max);
    roc::LaneState<roc::Stack<true>> s{head[q], {copy.data()}, cap, stack_len[q], pool,
                                       pool_size, mt_ctr[q], 0};
    roc::decode_slots(s, lengths + (int64_t)q * S, precision + (int64_t)q * S, S, n_slices,
                      syms.data(), ids + (int64_t)q * S * n_max, n_max, roc::LaneWarp{0});
    err[q] = s.err;
  }
}

extern "C" void decode_lanes(const uint64_t* head, const uint32_t* stack,
    int cap, const int32_t* stack_len, const int32_t* mt_ctr,
    const int32_t* lengths, const int32_t* precision, int S, int Q,
    const uint32_t* pool, int pool_size, int n_slices, int n_max, int sym_bytes,
    int64_t* ids, int32_t* err) {
  (sym_bytes == 4 ? decode_all<uint32_t> : decode_all<uint64_t>)(
      head, stack, cap, stack_len, mt_ctr, lengths, precision, S, Q, pool, pool_size,
      n_slices, n_max, ids, err);
}

// count selects on n fresh slots (one lane, stride 1): out[i] = the slot
// removed for ks[i]
extern "C" void select_sequence(int n, const int32_t* ks, int count, int32_t* out) {
  const int words = roc::select_words(n);
  std::vector<uint32_t> bits(words);
  std::vector<int32_t> tree(words + 1);
  roc::Strided<uint32_t> b{bits.data(), 1};
  roc::Strided<int32_t> t{tree.data(), 1};
  roc::select_fill(b, t, n);
  int top = 1;
  while (2 * top <= words) top *= 2;
  for (int i = 0; i < count; ++i) out[i] = roc::select_remove(b, t, n, top, ks[i]);
}

extern "C" uint32_t rank_share_u64(const uint64_t* syms, int i, uint64_t sym, int t) {
  return roc::rank_share(syms, i, sym, t);
}

// the chain probe's lanes (probe_chain.cu: one lane per block, on one thread)
extern "C" void decode_chain_lanes(const uint64_t* head, const uint32_t* stack, int cap,
    const int32_t* stack_len, const int32_t* mt_ctr, const int32_t* lengths,
    const int32_t* precision, const int32_t* ranks, int B, int n_max,
    const uint32_t* pool, int pool_size, int n_slices, uint64_t* syms, int32_t* err) {
  for (int b = 0; b < B; ++b) {
    std::vector<uint32_t> copy(stack + (int64_t)b * cap, stack + (int64_t)(b + 1) * cap);
    roc::LaneState<roc::Stack<false>> s{head[b], {copy.data()}, cap, stack_len[b], pool,
                                        pool_size, mt_ctr[b], 0};
    roc::decode_chain(s, lengths[b], precision[b], n_slices, ranks + (int64_t)b * n_max,
                      syms + (int64_t)b * n_max);
    err[b] = s.err;
  }
}

extern "C" void encode_chain_lanes(const uint64_t* ids, const int32_t* lengths,
    const int32_t* precision, int B, int n_max, const uint32_t* pool, int pool_size,
    int n_slices, uint64_t* head, uint32_t* stack, int cap, int32_t* stack_len,
    int32_t* mt_ctr, int32_t* err) {
  for (int b = 0; b < B; ++b) {
    roc::LaneState<roc::Stack<false>> s{roc::RANS_L, {stack + (int64_t)b * cap}, cap, 0, pool,
                                        pool_size, 0, 0};
    roc::encode_chain(s, ids + (int64_t)b * n_max, lengths[b], precision[b], n_slices);
    head[b] = s.head;
    stack_len[b] = s.len;
    mt_ctr[b] = s.mt_ctr;
    err[b] = s.err;
  }
}
"""

# lanes longer than 2048 (the decode's symbol buffers past 8 KB of u32):
# (list lengths, id bits per list)
LONG_CASES = [([2049, 3, 2300], 20), ([2600, 40], 32), ([4100, 1], 40)]
LONG_IDS = ["2049-3-2300x20b", "2600-40x32b", "4100-1x40b"]


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("roc_lane_cpu")
    (d / "harness.cpp").write_text(HARNESS)
    lib_path = d / "libroc_lane_cpu.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
                    str(d / "harness.cpp"), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.rank_share_u64.restype = ctypes.c_uint32
    lib.rank_share_u64.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                                   ctypes.c_int]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def make_long_batch(case_no: int):
    """Sorted ids u64[B, n_max], lengths and safe precisions i32[B]."""
    sizes, bits = LONG_CASES[case_no]
    rng = np.random.default_rng(300 + case_no)
    ids = np.zeros((len(sizes), max(sizes)), dtype=np.uint64)
    prec = np.zeros(len(sizes), dtype=np.int32)
    for b, n in enumerate(sizes):
        v = np.sort(rng.choice(2**bits - 1, size=n, replace=False).astype(np.uint64) + 1)
        ids[b, :n] = v
        prec[b] = precision_for_max_id_safe(int(v.max()))
    return ids, np.array(sizes, dtype=np.int32), prec


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
    blocks = -(-B // 32)
    scratch = np.zeros(blocks * 32 * (2 * -(-n_max // 32) + 1), np.uint32)
    lib.encode_lanes(_ptr(ids), _ptr(lengths), _ptr(prec), B, S, n_max, _ptr(pool),
                     len(pool), td.n_slices_for(maxp), _ptr(scratch), _ptr(out["head"]),
                     _ptr(out["stack"]), cap, _ptr(out["stack_len"]),
                     _ptr(out["mt_ctr"]), None if chained else _ptr(out["order"]),
                     _ptr(out["err"]))
    return out


def lane_decode(lib, enc, lengths, prec, n_max, sym_bytes=None):
    """Decode the lanes of ``lane_encode``'s output → (ids i64[B, S, n_max],
    err i32[B]). Symbols of ``sym_bytes`` (default: 4 where every precision
    is <= 32, else 8, as the wrapper picks)."""
    B, S = lengths.reshape(len(lengths), -1).shape
    cap = enc["stack"].shape[1]
    pool = td.default_pool(S * n_max).numpy()
    n_slices = td.n_slices_for(int(prec.max()))
    sym_bytes = sym_bytes or (4 if n_slices <= 2 else 8)
    out = np.zeros((B, S, n_max), np.int64)
    err = np.zeros(B, np.int32)
    lib.decode_lanes(
        _ptr(enc["head"]), _ptr(enc["stack"]), cap, _ptr(enc["stack_len"]),
        _ptr(enc["mt_ctr"]), _ptr(lengths), _ptr(prec), S, B, _ptr(pool), len(pool),
        n_slices, n_max, sym_bytes, _ptr(out), _ptr(err))
    return out, err


def lane_states(enc) -> td.RocStates:
    return td.RocStates(
        head=torch.from_numpy(enc["head"].view(np.int64)),
        stack=torch.from_numpy(enc["stack"].view(np.int32)),
        stack_len=torch.from_numpy(enc["stack_len"]),
        mt_ctr=torch.from_numpy(enc["mt_ctr"]),
        err=torch.zeros(len(enc["head"]), dtype=torch.bool))


def assert_encode_matches_plain(lib, ids, lengths, prec):
    n_max = ids.shape[1]
    maxp = int(prec.max())
    got = lane_encode(lib, ids, lengths, prec)
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
    return got


def assert_decode_matches_plain(lib, enc, ids, lengths, prec, sym_bytes=None):
    n_max = ids.shape[1]
    out, err = lane_decode(lib, enc, lengths, prec, n_max, sym_bytes)
    ref, _ = td.roc_decode_batch(lane_states(enc), torch.from_numpy(lengths),
                                 torch.from_numpy(prec), td.default_pool(n_max),
                                 n_max, td.n_slices_for(int(prec.max())))
    assert not err.any()
    np.testing.assert_array_equal(out[:, 0], ref.numpy())
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(np.sort(out[b, 0, :n]).view(np.uint64), ids[b, :n])


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_lane_encode_matches_plain(lane_lib, case_no):
    assert_encode_matches_plain(lane_lib, *make_batch(case_no))


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_lane_decode_matches_plain(lane_lib, case_no):
    ids, lengths, prec = make_batch(case_no)
    enc = lane_encode(lane_lib, ids, lengths, prec)
    assert_decode_matches_plain(lane_lib, enc, ids, lengths, prec)
    # the decoder wrote scratch copies: the stored stacks are untouched
    np.testing.assert_array_equal(enc["stack"], lane_encode(lane_lib, ids, lengths, prec)["stack"])


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_lane_decode_u64_symbols_matches_plain(lane_lib, case_no):
    """The decode's u64 symbol buffer, which the kernel takes past precision
    32, on every case (the u32 one where every precision is <= 32 is the
    default above)."""
    ids, lengths, prec = make_batch(case_no)
    enc = lane_encode(lane_lib, ids, lengths, prec)
    assert_decode_matches_plain(lane_lib, enc, ids, lengths, prec, sym_bytes=8)


@pytest.mark.parametrize("sym_bytes", [4, 8])
@pytest.mark.parametrize("case_no", range(len(LONG_CASES)), ids=LONG_IDS)
def test_lane_long_lanes_match_plain(lane_lib, case_no, sym_bytes):
    """Lanes longer than 2048: the encode's select over more than 64 words
    and the decode's rank over more than 64 symbols per thread, with u32 and
    u64 symbol buffers (u32 only where every precision is <= 32)."""
    ids, lengths, prec = make_long_batch(case_no)
    if sym_bytes == 4 and td.n_slices_for(int(prec.max())) > 2:
        sym_bytes = 8  # past 32 bits the kernel always takes u64 symbols
    enc = assert_encode_matches_plain(lane_lib, ids, lengths, prec)
    assert_decode_matches_plain(lane_lib, enc, ids, lengths, prec, sym_bytes)


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


def assert_chained_decode_matches_plain(lib, case_no, sym_bytes=None):
    ids, lengths, prec = make_chained_batch(case_no)
    S, n_max = ids.shape[1:]
    enc = lane_encode(lib, ids, lengths, prec)
    out, err = lane_decode(lib, enc, lengths, prec, n_max, sym_bytes)
    ref, _ = td.roc_decode_chained(lane_states(enc), torch.from_numpy(lengths),
                                   torch.from_numpy(prec), td.default_pool(S * n_max),
                                   n_max, td.n_slices_for(int(prec.max())))
    assert not err.any()
    np.testing.assert_array_equal(out, ref.numpy())
    for b, s in np.ndindex(*lengths.shape):
        n = lengths[b, s]
        np.testing.assert_array_equal(np.sort(out[b, s, :n]).view(np.uint64), ids[b, s, :n])


@pytest.mark.parametrize("case_no", range(len(CHAINED_CASES)), ids=CHAINED_IDS)
def test_lane_chained_decode_matches_plain(lane_lib, case_no):
    """The kernels' chained slot loop (decode_slots, the symbol buffer
    restarted per slot) against the plain roc_decode_chained, and back to the
    input ids."""
    assert_chained_decode_matches_plain(lane_lib, case_no)


@pytest.mark.parametrize("case_no", range(len(CHAINED_CASES)), ids=CHAINED_IDS)
def test_lane_chained_decode_u64_symbols_matches_plain(lane_lib, case_no):
    """The chained decode with u64 symbol buffers."""
    assert_chained_decode_matches_plain(lane_lib, case_no, sym_bytes=8)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 97, 1000, 2127])
def test_select_remove_matches_list(lane_lib, n):
    """The encode's select (bitmap + Fenwick tree over its words) removes the
    (k+1)-th remaining slot, as popping index k of the sorted remaining list
    does, down to the last slot."""
    rng = np.random.default_rng(n)
    ks = np.array([rng.integers(0, n - i) for i in range(n)], dtype=np.int32)
    out = np.zeros(n, np.int32)
    lane_lib.select_sequence(n, _ptr(ks), n, _ptr(out))
    remaining = list(range(n))
    np.testing.assert_array_equal(out, [remaining.pop(int(k)) for k in ks])


def test_rank_shares_split_the_rank(lane_lib):
    """Thread t's share counts the smaller symbols at j = t (mod 32) among the
    first i, and the 32 shares sum to the rank, at every i."""
    rng = np.random.default_rng(11)
    syms = rng.integers(0, 2**40, 200, dtype=np.uint64)
    for i in (0, 1, 31, 32, 33, 100, 200):
        sym = int(rng.integers(0, 2**40))
        shares = [lane_lib.rank_share_u64(_ptr(syms), i, sym, t) for t in range(32)]
        assert shares == [int((syms[t:i:32] < sym).sum()) for t in range(32)]
        assert sum(shares) == int((syms[:i] < sym).sum())


@pytest.mark.parametrize("case_no", range(len(CASES)), ids=CASE_IDS)
def test_chain_probe_reproduces_codec(lane_lib, case_no):
    """The chain probe's lanes (roc_lane.cuh decode_chain and encode_chain,
    built for the CPU), their torch plain versions and ProbeChain's CPU route,
    given the ranks the decode computes and the ids in the order the encode
    selects them, leave the codec's states and decode its symbols."""
    ids, lengths, prec = make_batch(case_no)
    B, n_max = ids.shape
    maxp = int(prec.max())
    n_slices = td.n_slices_for(maxp)
    pool = td.default_pool(n_max).numpy()
    enc = lane_encode(lane_lib, ids, lengths, prec)
    in_order = np.take_along_axis(ids, np.maximum(enc["order"], 0), axis=1)
    cap = enc["stack"].shape[1]
    got = dict(head=np.zeros(B, np.uint64), stack=np.zeros((B, cap), np.uint32),
               stack_len=np.zeros(B, np.int32), mt_ctr=np.zeros(B, np.int32),
               err=np.zeros(B, np.int32))
    lane_lib.encode_chain_lanes(_ptr(in_order), _ptr(lengths), _ptr(prec), B, n_max, _ptr(pool),
                                len(pool), n_slices, _ptr(got["head"]), _ptr(got["stack"]), cap,
                                _ptr(got["stack_len"]), _ptr(got["mt_ctr"]), _ptr(got["err"]))
    before = ProbeChain.launches
    states = ProbeChain.encode(torch.from_numpy(in_order.view(np.int64)),
                               torch.from_numpy(lengths), torch.from_numpy(prec))
    assert not got["err"].any() and not states.err.any()
    for field in ("head", "stack", "stack_len", "mt_ctr"):
        np.testing.assert_array_equal(got[field], enc[field])
    assert torch.equal(states.head, lane_states(enc).head)
    assert torch.equal(states.stack, lane_states(enc).stack)

    ref, _ = td.roc_decode_batch(lane_states(enc), torch.from_numpy(lengths),
                                 torch.from_numpy(prec), td.default_pool(n_max), n_max, n_slices)
    ranks = decode_ranks(ref, torch.from_numpy(lengths))
    want = np.zeros((B, n_max), np.uint64)
    for b, n in enumerate(lengths):
        want[b, :n] = ref[b, :n].numpy()[::-1].view(np.uint64)
    rank_np = ranks.numpy()
    syms, err = np.zeros((B, n_max), np.uint64), np.zeros(B, np.int32)
    lane_lib.decode_chain_lanes(_ptr(enc["head"]), _ptr(enc["stack"]), cap, _ptr(enc["stack_len"]),
                                _ptr(enc["mt_ctr"]), _ptr(lengths), _ptr(prec), _ptr(rank_np), B,
                                n_max, _ptr(pool), len(pool), n_slices, _ptr(syms), _ptr(err))
    assert not err.any()
    np.testing.assert_array_equal(syms, want)
    plain = ProbeChain.decode(lane_states(enc), torch.from_numpy(lengths), torch.from_numpy(prec),
                              ranks, td.default_pool(n_max))
    np.testing.assert_array_equal(plain.numpy().view(np.uint64), want)
    assert ProbeChain.launches == before  # the CPU route launches nothing


def test_decode_ranks_counts_earlier_smaller_steps():
    ids = torch.tensor([[30, 10, 20, 0], [5, 7, 0, 0]])  # sampling order
    lengths = torch.tensor([3, 2], dtype=torch.int32)
    # decode order: [20, 10, 30] and [7, 5]
    assert decode_ranks(ids, lengths).tolist() == [[0, 0, 2, 0], [0, 0, 0, 0]]

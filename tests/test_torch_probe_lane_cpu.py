"""The probes' per-row and per-lane steps (``csrc/probe_lane.cuh``), built
for the CPU.

A plain C++ compiler builds the header that the kernels ``csrc/probe_gather.cu``
(K3) and ``csrc/probe_decode_step.cu`` (K4) run, behind loops that do what the
kernels' blocks do: K3 tabulates each block's 32 windows column-major as byte
offsets of the successors and chases them; K4 runs each lane's steps on a copy
of its buffer column with the warp's 32 threads run as one (``LaneWarp`` built
for the CPU sums the 32 threads' rank shares in a loop; each thread's first
35 symbols in registers, the rest in shared memory), the emits written at
the stride of the [steps, B] output. Each is held bit-exact against its plain
version in ``ops/probes.py`` (itself held against the Pallas probes in
``test_torch_probes.py``), at the probes' shapes and at edges: steps not a
multiple of 32 and a single step, a two-row buffer (the pointer leaves it),
windows up to the shared-memory limit and a row count that leaves the last
block short. The kernels themselves run on the card (``test_torch_cuda.py``,
``chip_smoke.py``). About 6 s, most of it the plain K4 at 1100 steps.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu_torch.ops._build import CSRC, SHARED_BYTES_PER_BLOCK
from vector_db_id_compression_tpu_torch.ops.probes import (GATHER_ROWS, decode_step_fits,
                                                           gather_fits, probe_decode_step_plain,
                                                           probe_gather_plain)

HARNESS = r"""
#include <cstddef>
#include <vector>
#include "probe_lane.cuh"

using std::size_t;

using namespace probe;

// K3: each block of kGatherRows rows tabulated (rows past B point at
// themselves, as in the kernel), then each row's chain
extern "C" void gather_rows(const int32_t* win, const int32_t* idx0, int B, int W,
                            int steps, int32_t* out) {
  std::vector<int32_t> table((size_t)W * kGatherRows);
  for (int b0 = 0; b0 < B; b0 += kGatherRows) {
    for (int r = 0; r < kGatherRows; ++r)
      for (int j = 0; j < W; ++j)
        table[(size_t)j * kGatherRows + r] =
            b0 + r < B ? gather_successor(j, r, win[(int64_t)(b0 + r) * W + j], W)
                       : gather_offset(j, r);
    for (int r = 0; r < kGatherRows && b0 + r < B; ++r)
      out[b0 + r] =
          gather_index(gather_chain(table.data(), gather_offset(idx0[b0 + r], r), steps));
  }
}

// K4: each lane's steps on its copy of buf (the column of buf i32[capp, B]),
// symbols after it, as a lane's shared memory holds them
extern "C" void decode_step_lanes(const int32_t* buf, const int32_t* p, int capp, int B,
                                  int steps, int32_t* emit) {
  for (int b = 0; b < B; ++b) {
    std::vector<int32_t> lane((size_t)capp + steps + 1);
    for (int r = 0; r < capp; ++r) lane[r] = buf[(int64_t)r * B + b];
    decode_steps(lane.data(), capp, lane.data() + capp, steps, p[b], emit + b, B, 0);
    for (int i = 0; i < steps; ++i)  // the terms the kernel adds as it writes out
      emit[(int64_t)i * B + b] =
          (int32_t)((uint32_t)emit[(int64_t)i * B + b] + emit_terms(i, p[b]));
  }
}
"""


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    d = tmp_path_factory.mktemp("probe_lane_cpu")
    (d / "harness.cpp").write_text(HARNESS)
    lib_path = d / "libprobe_lane_cpu.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
                    str(d / "harness.cpp"), "-o", str(lib_path)], check=True)
    return ctypes.CDLL(str(lib_path))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("capp", [896, 2], ids=["probe-buf", "two-row-buf"])
@pytest.mark.parametrize("steps", [1100, 300, 33, 1])
def test_decode_steps_equal_plain(probe_lib, capp, steps):
    assert_decode_steps_equal_plain(probe_lib, capp, steps, 256)


def test_decode_steps_past_the_registers_equal_plain(probe_lib):
    """Past 1120 steps a thread's symbols go on from its 35 registers into
    shared memory."""
    assert_decode_steps_equal_plain(probe_lib, 40, 1500, 8)


def assert_decode_steps_equal_plain(lib, capp: int, steps: int, B: int):
    rng = np.random.default_rng(capp * 10_000 + steps)
    buf = rng.integers(-2**31, 2**31, size=(capp, B)).astype(np.int32)
    p = ((np.arange(B) * 7) % 32).astype(np.int32)  # every shift, 31 among them
    emit = np.zeros((steps, B), np.int32)
    lib.decode_step_lanes(_ptr(buf), _ptr(p), capp, B, steps, _ptr(emit))
    want = probe_decode_step_plain(torch.from_numpy(buf), torch.from_numpy(p[None]), steps)
    np.testing.assert_array_equal(emit, want.numpy())


@pytest.mark.parametrize("B,W,steps", [(256, 128, 1100), (257, 128, 33), (40, 1816, 1100),
                                       (33, 5, 1)],
                         ids=["probe-shape", "short-last-block", "widest-window", "narrow"])
def test_gather_chain_equals_plain(probe_lib, B, W, steps):
    rng = np.random.default_rng(B * W + steps)
    win = rng.integers(-2**31, 2**31, size=(B, W)).astype(np.int32)
    idx = rng.integers(0, W, size=B).astype(np.int32)
    idx[:8] = 0  # rows that start together, as the probe's do
    out = np.zeros(B, np.int32)
    probe_lib.gather_rows(_ptr(win), _ptr(idx), B, W, steps, _ptr(out))
    want = probe_gather_plain(torch.from_numpy(win), torch.from_numpy(idx[:, None]), steps)
    np.testing.assert_array_equal(out, want[:, 0].numpy())


def test_shared_memory_limits():
    """The limits the wrappers enforce are the kernels' layouts against one
    block's shared memory: W = 1816 is K3's widest window, and K4's lane is
    its buffer, symbols and emits, a word each."""
    assert gather_fits(1816) and not gather_fits(1817)
    assert 4 * GATHER_ROWS * 1817 > SHARED_BYTES_PER_BLOCK >= 4 * GATHER_ROWS * 1816
    most = SHARED_BYTES_PER_BLOCK // 4
    assert decode_step_fits(most - 2 * 1100, 1100) and not decode_step_fits(most - 2199, 1100)
    assert decode_step_fits(2, (most - 2) // 2) and not decode_step_fits(2, (most - 2) // 2 + 1)

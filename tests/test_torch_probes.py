"""The plain versions of the two decode-step probes (K3, K4) against the
Pallas kernels of tools/profiling/profile_pallas.py and profile_pallas2.py,
bit for bit, in interpret mode on the CPU, at the probes' own shapes (and K4
also with a two-row buffer).

The probe files run their kernels when imported and point the compile cache
into the repository, so they are not imported: only their definitions (the
source before the first input is made, without the compile-cache line) are
executed, and their ``kernel`` is called through ``pl.pallas_call`` here.
They run in JAX's default 32-bit mode, as the probe files do; the JAX
package turns on x64 mode when any test imports it, and the kernels' loop
carries would then widen to 64 bits.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import vector_db_id_compression_tpu  # noqa: F401  (x64 on, as in the whole suite)
from vector_db_id_compression_tpu_torch.ops._build import SHARED_BYTES_PER_BLOCK
from vector_db_id_compression_tpu_torch.ops.probes import (
    STEPS,
    ProbeDecodeStep,
    ProbeGather,
    probe_decode_step_plain,
    probe_gather_plain,
)

PROFILING = Path(__file__).resolve().parent.parent / "tools" / "profiling"


def probe_definitions(name: str, first_input: str) -> dict:
    """Execute a probe file's definitions only → its namespace."""
    src = (PROFILING / name).read_text()
    defs = src[: src.index(f"\n{first_input} = ")]
    defs = "\n".join(line for line in defs.splitlines()
                     if not line.startswith("jax.config.update"))
    ns: dict = {}
    exec(compile(defs, str(PROFILING / name), "exec"), ns)
    return ns


def k3_inputs(seed: int):
    """win u32[256, 128] and idx i32[256, 1], as the probe draws them (idx
    not all zero here, so that every row starts elsewhere)."""
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 2**31, size=(256, 128)).astype(np.uint32)
    win[::7] |= np.uint32(1 << 31)  # high bits set too
    idx = rng.integers(0, 128, size=(256, 1)).astype(np.int32)
    return win, idx


def k4_inputs(seed: int, capp: int = 896):
    """buf i32[capp, 256] and p = arange(256) % 17, as in the probe."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2**31, 2**31, size=(capp, 256)).astype(np.int32)
    p = (np.arange(256) % 17).reshape(1, 256).astype(np.int32)
    return buf, p


def test_probe_gather_matches_pallas_interpret():
    ns = probe_definitions("profile_pallas.py", "win")
    assert (ns["B"], ns["W"], ns["STEPS"]) == (256, 128, STEPS)
    win, idx = k3_inputs(3)
    with jax.enable_x64(False):
        want = pl.pallas_call(
            ns["kernel"], out_shape=jax.ShapeDtypeStruct((256, 1), jnp.int32),
            interpret=True)(jnp.asarray(win), jnp.asarray(idx))
    got = probe_gather_plain(torch.from_numpy(win.view(np.int32)), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and got.shape == (256, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capp", [896, 2], ids=["probe-shape", "ptr-leaves-buf"])
def test_probe_decode_step_matches_pallas_interpret(capp):
    """At the probe's shape, and with a buffer of two rows, where the
    pointer walks out of [1, capp] (a gather there reads 0, a scatter writes
    nothing)."""
    ns = probe_definitions("profile_pallas2.py", "buf")
    assert (ns["B"], ns["CAPP"], ns["NMAX"]) == (256, 896, STEPS)
    ns["CAPP"] = capp  # the kernel's global
    buf, p = k4_inputs(4, capp)
    with jax.enable_x64(False):
        (want,) = pl.pallas_call(
            ns["kernel"], out_shape=(jax.ShapeDtypeStruct((STEPS, 256), jnp.int32),),
            scratch_shapes=[pltpu.VMEM((STEPS, 256), jnp.int32)],
            interpret=True)(jnp.asarray(buf), jnp.asarray(p))
    buf_t = torch.from_numpy(buf.copy())
    got = probe_decode_step_plain(buf_t, torch.from_numpy(p))
    assert got.dtype == torch.int32 and got.shape == (STEPS, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(buf_t, torch.from_numpy(buf))  # works on a copy


def test_probe_wrappers_run_plain_version_on_cpu():
    win, idx = k3_inputs(5)
    buf, p = k4_inputs(6)
    before = (ProbeGather.launches, ProbeDecodeStep.launches)
    win_t, idx_t = torch.from_numpy(win.view(np.int32)), torch.from_numpy(idx)
    assert torch.equal(ProbeGather.run(win_t, idx_t, steps=50),
                       probe_gather_plain(win_t, idx_t, steps=50))
    buf_t, p_t = torch.from_numpy(buf), torch.from_numpy(p)
    assert torch.equal(ProbeDecodeStep.run(buf_t, p_t, steps=40),
                       probe_decode_step_plain(buf_t, p_t, steps=40))
    assert (ProbeGather.launches, ProbeDecodeStep.launches) == before


@pytest.mark.parametrize("bad", ["idx-range", "p-range", "dtype"])
def test_probe_wrappers_refuse_bad_input(bad):
    win, idx = k3_inputs(7)
    buf, p = k4_inputs(8)
    win_t, idx_t = torch.from_numpy(win.view(np.int32)), torch.from_numpy(idx)
    buf_t, p_t = torch.from_numpy(buf), torch.from_numpy(p)
    with pytest.raises(ValueError):
        if bad == "idx-range":
            ProbeGather.run(win_t, idx_t + 128)
        elif bad == "p-range":
            ProbeDecodeStep.run(buf_t, p_t + 32)
        else:
            ProbeDecodeStep.run(buf_t.to(torch.int64), p_t)


@pytest.mark.parametrize("probe", ["gather", "decode-step-buf", "decode-step-steps"])
def test_probe_wrappers_refuse_shapes_past_shared_memory(probe):
    """K3 keeps a block's 32 windows and K4 a lane's buffer, symbols and
    emits in shared memory: a shape past one block's limit raises, on the
    CPU as on the card, naming the limit; the largest that fits runs."""
    rng = np.random.default_rng(9)
    if probe == "gather":
        for W, fits in ((1817, False), (1816, True)):
            win = torch.from_numpy(rng.integers(-2**31, 2**31, (4, W)).astype(np.int32))
            idx = torch.zeros((4, 1), dtype=torch.int32)
            if fits:
                assert ProbeGather.run(win, idx, 3).shape == (4, 1)
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    ProbeGather.run(win, idx, 3)
        return
    most = SHARED_BYTES_PER_BLOCK // 4  # words of one block's shared memory
    p = torch.zeros((1, 2), dtype=torch.int32)
    if probe == "decode-step-buf":  # the largest buffer for 3 steps, and one row more
        capp, steps, fits = most - 2 * 3, 3, True
    else:  # the most steps on a two-row buffer, plus one (that fits: the CUDA test)
        capp, steps, fits = 2, (most - 2) // 2 + 1, False
    with pytest.raises(ValueError, match="shared memory"):
        ProbeDecodeStep.run(torch.zeros((capp + int(fits), 2), dtype=torch.int32), p, steps)
    if fits:
        assert ProbeDecodeStep.run(torch.zeros((capp, 2), dtype=torch.int32), p,
                                   steps).shape == (steps, 2)

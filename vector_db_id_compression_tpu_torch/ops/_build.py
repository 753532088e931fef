"""Build the package's CUDA kernels with nvcc at first use; load with ctypes.

``build()`` compiles every ``csrc/*.cu`` of this package, one nvcc process
per source, all started together, and links the objects into one shared
library with a plain C interface, ``_build/libroc_kernels.so`` (listed in
``.gitignore``). It rebuilds when a source or header is newer than the
library. The compiler's report (``-Xptxas=-v``: registers, spills, shared
memory per kernel) is kept beside it in ``_build/build.log``.

There is no fallback: without nvcc, or when the build fails, ``build()``
raises, and no caller falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
LIBRARY = BUILD_DIR / "libroc_kernels.so"
BUILD_LOG = BUILD_DIR / "build.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
# The most dynamic shared memory one block may use on the H100 (sm_90): 227 KB
# of the SM's 228 KB, past 48 KB only after cudaFuncSetAttribute. The ROC
# kernels keep a lane's buffers in shared memory while a block's lanes fit
# into it, else in global memory (``shared_lanes``).
SHARED_BYTES_PER_BLOCK = 227 * 1024


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of vector_db_id_compression_tpu_torch cannot be built")
    return found


def _run_all(cmds, log: list) -> None:
    """Run the commands concurrently; log each one's output; raise if any
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\nexited with code {proc.returncode}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels if the library is missing or older than a source;
    returns the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in [*sources, *CSRC.glob("*.cuh")])
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return LIBRARY
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    log: list = []
    # objects and the library go to temporary names first: a concurrent
    # loader never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        try:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                      for src, obj in zip(sources, objs)], log)
            lib = str(Path(tmp) / LIBRARY.name)
            _run_all([[nvcc, "-shared", "-o", lib, *objs]], log)
        finally:
            BUILD_LOG.write_text("\n".join(log))
        os.replace(lib, LIBRARY)
    return LIBRARY


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library, with every entry
    point's argument types declared (a pointer or stream passed without
    ``c_void_p`` would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.roc_encode_launch.argtypes = [P, P, P, I, I, I, P, I, I, I, I, P, P, P, I, P,
                                      P, P, P, P]
    lib.roc_encode_launch.restype = I
    lib.roc_encode_lane_bytes.argtypes = [I]
    lib.roc_encode_lane_bytes.restype = ctypes.c_longlong
    lib.roc_decode_launch.argtypes = [P, P, I, P, P, I, P, P, I, P, I, P, I, I, I, I,
                                      I, I, P, P, P, P]
    lib.roc_decode_launch.restype = I
    lib.roc_decode_lane_bytes.argtypes = [I, I, I]
    lib.roc_decode_lane_bytes.restype = ctypes.c_longlong
    lib.probe_gather_launch.argtypes = [P, P, I, I, I, P, P]
    lib.probe_gather_launch.restype = I
    lib.probe_decode_step_launch.argtypes = [P, P, I, I, I, I, P, P]
    lib.probe_decode_step_launch.restype = I
    lib.probe_step_latency_launch.argtypes = [I, P, P, P, P]
    lib.probe_step_latency_launch.restype = I
    lib.probe_chain_decode_launch.argtypes = [P, P, I, P, P, P, P, P, I, I, P, I, I, P, P, P]
    lib.probe_chain_decode_launch.restype = I
    lib.probe_chain_encode_launch.argtypes = [P, P, P, I, I, P, I, I, P, P, I, P, P, P, P]
    lib.probe_chain_encode_launch.restype = I
    lib.roc_error_string.argtypes = [I]
    lib.roc_error_string.restype = ctypes.c_char_p
    return lib


def shared_lanes(lane_bytes: int, lanes: int) -> int:
    """Lanes per block whose buffers of ``lane_bytes`` each fit together into
    ``SHARED_BYTES_PER_BLOCK``: ``lanes``, or fewer where fewer fit, or 0 where
    not one does (the kernel then keeps them in global memory)."""
    return min(lanes, SHARED_BYTES_PER_BLOCK // max(lane_bytes, 1))


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.roc_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({msg})")

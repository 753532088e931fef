"""Build the package's CUDA kernels with nvcc at first use; load with ctypes.

``build()`` compiles every ``csrc/*.cu`` of this package into one shared
library with a plain C interface, ``_build/libroc_kernels.so`` (listed in
``.gitignore``), and rebuilds it when a source or header is newer than the
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


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


def build() -> Path:
    """Compile the kernels if the library is missing or older than a source;
    returns the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in [*sources, *CSRC.glob("*.cuh")])
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return LIBRARY
    BUILD_DIR.mkdir(exist_ok=True)
    # compile to a temporary name and rename: a concurrent loader never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library, with every entry
    point's argument types declared (a pointer or stream passed without
    ``c_void_p`` would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.roc_encode_launch.argtypes = [P, P, P, I, I, I, P, I, I, P, P, P, I, P,
                                      P, P, P, P]
    lib.roc_encode_launch.restype = I
    lib.roc_decode_launch.argtypes = [P, P, I, P, P, P, P, P, I, I, P, I, I, I,
                                      P, P, P, P, P]
    lib.roc_decode_launch.restype = I
    lib.roc_error_string.argtypes = [I]
    lib.roc_error_string.restype = ctypes.c_char_p
    return lib


def lane_stride(lanes: int) -> int:
    """Row stride of the kernels' [rows, lanes] scratch: ``lanes`` rounded
    up to a whole warp, so that each warp's row segment is line-aligned."""
    return -(-lanes // 32) * 32


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = lib.roc_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} "
                           f"({msg})")

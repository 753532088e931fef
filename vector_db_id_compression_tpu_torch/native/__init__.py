"""Native host ROC codec: ctypes bindings over ``roc_native.cpp``.

The C++ source is a copy of the JAX package's ``native/roc_native.cpp``: a
list-parallel (std::thread) batch encode and decode, bit-exact with the
Python host codec (``codecs/roc.py``), the lane-batched torch codec and the
CUDA kernels. It never runs on the search path: it is the single-core host
baseline and a third witness of the stream format.

``g++`` builds it at first use into the package's ignored ``_build/``
directory (``libroc_native.so``), under a temporary name renamed into place,
so that processes building at once never load a half-written library. There
is no fallback: without ``g++``, or when the build fails, the first call
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "roc_native.cpp"
LIBRARY = SOURCE.parent.parent / "_build" / "libroc_native.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build() -> Path:
    """Compile the library if it is missing or older than the source;
    returns its path. Raises RuntimeError if ``g++`` is missing or fails."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    LIBRARY.parent.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIBRARY.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError("g++ not found: the native ROC codec cannot be built") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}\nexited with code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the library, every entry point's argument
    types declared."""
    lib = ctypes.CDLL(str(build()))
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    I = ctypes.c_int
    lib.roc_encode_lists.restype = I
    lib.roc_encode_lists.argtypes = [u64p, i64p, I, i32p, u64p, u32p, ctypes.c_int32,
                                     i32p, i32p, u32p, I]
    lib.roc_decode_lists.restype = I
    lib.roc_decode_lists.argtypes = [u64p, u32p, ctypes.c_int32, i32p, i64p, I, i32p,
                                     u64p, I]
    return lib


def default_threads() -> int:
    return max(os.cpu_count() or 1, 1)


def _offsets(lengths: np.ndarray) -> np.ndarray:
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return offsets


def _check_precisions(prec: np.ndarray, n_lists: int) -> None:
    if prec.shape != (n_lists,) or (n_lists and not (0 <= prec.min() and prec.max() <= 64)):
        raise ValueError(f"precisions must be {n_lists} values in [0, 64]")


def roc_encode_lists(
    id_lists: Sequence[np.ndarray],
    precisions: Sequence[int],
    cap: Optional[int] = None,
    n_threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray], np.ndarray]:
    """Batch ROC encode of lists of distinct ids. Returns (heads u64[n],
    stacks u32[n, cap], stack_lens i32[n], orders [per-list i32
    permutation into the list], mt_draws u32[n]). Raises RuntimeError if a
    list needs more than ``cap`` stack words."""
    lib = load_library()
    n_lists = len(id_lists)
    lengths = np.array([len(v) for v in id_lists], dtype=np.int64)
    offsets = _offsets(lengths)
    ids_flat = (np.concatenate([np.asarray(v, np.uint64) for v in id_lists])
                if offsets[-1] else np.zeros(0, np.uint64))
    prec = np.ascontiguousarray(precisions, dtype=np.int32)
    _check_precisions(prec, n_lists)
    if cap is None:
        # stack words are bounded by total pushed bits / 32 (+ slack)
        max_n = int(lengths.max()) if n_lists else 0
        max_p = int(prec.max()) if n_lists else 0
        cap = max_n * max_p // 32 + 8
    heads = np.zeros(n_lists, dtype=np.uint64)
    stacks = np.zeros((n_lists, cap), dtype=np.uint32)
    stack_lens = np.zeros(n_lists, dtype=np.int32)
    order_flat = np.zeros(int(offsets[-1]), dtype=np.int32)
    mt_draws = np.zeros(n_lists, dtype=np.uint32)
    rc = lib.roc_encode_lists(ids_flat, offsets, n_lists, prec, heads, stacks.reshape(-1),
                              cap, stack_lens, order_flat, mt_draws,
                              n_threads or default_threads())
    if rc != 0:
        raise RuntimeError(f"stack capacity {cap} overflowed: max needed "
                           f"{int(stack_lens.max())}")
    orders = [order_flat[offsets[i]:offsets[i + 1]] for i in range(n_lists)]
    return heads, stacks, stack_lens, orders, mt_draws


def roc_decode_lists(
    heads: np.ndarray,
    stacks: np.ndarray,
    stack_lens: np.ndarray,
    lengths: Sequence[int],
    precisions: Sequence[int],
    n_threads: Optional[int] = None,
) -> List[np.ndarray]:
    """Batch ROC decode; returns per-list ids in decode (= encode sampling)
    order."""
    lib = load_library()
    n_lists = len(lengths)
    offsets = _offsets(np.asarray(lengths, dtype=np.int64))
    heads = np.ascontiguousarray(heads, np.uint64)
    stacks = np.ascontiguousarray(stacks, dtype=np.uint32)
    stack_lens = np.ascontiguousarray(stack_lens, np.int32)
    prec = np.ascontiguousarray(precisions, np.int32)
    cap = stacks.shape[1] if stacks.ndim == 2 else 0
    if (heads.shape != (n_lists,) or stack_lens.shape != (n_lists,)
            or (cap and stacks.shape[0] != n_lists)):
        raise ValueError(f"heads, stacks and stack_lens must hold {n_lists} lists")
    if n_lists and (stack_lens.min() < 0 or stack_lens.max() > cap):
        raise ValueError(f"stack lengths must lie in [0, {cap}]")
    _check_precisions(prec, n_lists)
    out = np.zeros(int(offsets[-1]), dtype=np.uint64)
    lib.roc_decode_lists(heads, stacks.reshape(-1), cap, stack_lens, offsets, n_lists,
                         prec, out, n_threads or default_threads())
    return [out[offsets[i]:offsets[i + 1]] for i in range(n_lists)]

"""Native host code: ctypes bindings over ``roc_native.cpp`` and
``hnsw_native.cpp``.

``roc_native.cpp`` is a copy of the JAX package's ``native/roc_native.cpp``:
a list-parallel (std::thread) batch ROC encode and decode, bit-exact with the
Python host codec (``codecs/roc.py``), the lane-batched torch codec and the
CUDA kernels. It never runs on the search path: it is the single-core host
baseline and a third witness of the stream format.

``hnsw_native.cpp`` is the HNSW build's link assignment (``hnsw_link``), the
order-dependent host loop of ``search/hnsw.py``, with the JAX package's numpy
float32 distance arithmetic bit for bit.

``g++`` builds each source at first use into the package's ignored
``_build/`` directory (``lib<source>.so``), under a temporary name renamed
into place, so that processes building at once never load a half-written
library. There is no fallback: without ``g++``, or when the build fails, the
first call raises with the compiler's output.
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
HNSW_SOURCE = SOURCE.parent / "hnsw_native.cpp"
LIBRARY = SOURCE.parent.parent / "_build" / "libroc_native.so"
# no reassociation or fused multiply-add: hnsw_native.cpp reproduces numpy's
# float32 sums
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` into ``_build/lib<stem>.so`` if the library is
    missing or older than the source; returns its path. Raises RuntimeError
    if ``g++`` is missing or fails."""
    library = LIBRARY.parent / f"lib{source.stem}.so"
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return library
    library.parent.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=library.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(source), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ not found: {source.name} cannot be built") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}\nexited with code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, library)
    return library


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the ROC codec library, every entry point's
    argument types declared."""
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


@lru_cache(maxsize=None)
def load_hnsw_library() -> ctypes.CDLL:
    """Build if needed and load the HNSW link library."""
    lib = ctypes.CDLL(str(build(HNSW_SOURCE)))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    L = ctypes.c_int64
    lib.hnsw_link.restype = ctypes.c_int
    lib.hnsw_link.argtypes = [i32p, L, f32p, L, i64p, i64p, L, i64p, L, L, ctypes.c_int, i64p]
    lib.hnsw_pair_dists.restype = None
    lib.hnsw_pair_dists.argtypes = [f32p, L, L, i64p, L, f32p]
    return lib


def _c_array(a: np.ndarray, dtype, name: str) -> np.ndarray:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be a C-contiguous {np.dtype(dtype).name} array")
    return a


def hnsw_link(adj: np.ndarray, xb: np.ndarray, pts: np.ndarray, sub: np.ndarray,
              sel: np.ndarray, mcap: int, relink: bool, cur: np.ndarray) -> None:
    """The HNSW link assignment of one insert batch on one layer, in place:
    ``adj`` i32[N, cap] (cap = ``mcap``), ``xb`` f32[N, d], ``pts`` i64[B] the
    batch, ``sub`` i64[n] the batch positions at this level, ``sel``
    i64[n, out_deg] their pools closest first, ``cur`` i64[B] walk entries
    (updated)."""
    _c_array(adj, np.int32, "adj")
    _c_array(xb, np.float32, "xb")
    _c_array(cur, np.int64, "cur")
    pts, sub, sel = (np.ascontiguousarray(a, dtype=np.int64) for a in (pts, sub, sel))
    N, cap = adj.shape
    if cap != mcap or xb.shape[0] != N or sel.shape[0] != len(sub) or cur.shape != pts.shape:
        raise ValueError("hnsw_link: inconsistent shapes")
    if len(sub) and not (0 <= sub.min() and sub.max() < len(pts)):
        raise ValueError("hnsw_link: batch positions out of range")
    if len(pts) and not (0 <= pts.min() and pts.max() < N) or (sel.size and sel.max() >= N):
        raise ValueError("hnsw_link: node ids out of range")
    load_hnsw_library().hnsw_link(adj, cap, xb, xb.shape[1], pts, sub, len(sub), sel,
                                  sel.shape[1], mcap, int(relink), cur)


def hnsw_pair_dists(xb: np.ndarray, v: int, cand: np.ndarray) -> np.ndarray:
    """f32 distances from node ``v`` to the nodes ``cand`` (-1 → inf), as
    ``hnsw_link`` computes them."""
    _c_array(xb, np.float32, "xb")
    cand = np.ascontiguousarray(cand, dtype=np.int64)
    if cand.size and cand.max() >= len(xb) or not 0 <= v < len(xb):
        raise ValueError("hnsw_pair_dists: node ids out of range")
    out = np.empty(len(cand), dtype=np.float32)
    load_hnsw_library().hnsw_pair_dists(xb, xb.shape[1], v, cand, len(cand), out)
    return out


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

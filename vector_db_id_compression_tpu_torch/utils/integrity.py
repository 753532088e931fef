"""Artifact integrity: content checksums for the on-disk formats.

Port of the JAX package's ``utils/integrity.py`` (numpy only, copied so that
the port imports nothing of the JAX package): a CRC32 over every array of an
``.npz`` artifact, independent of the arrays' order in the file, written into
the artifact as one more array (``checksum``) and checked against its
content. Both packages compute the same checksum for the same file.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Union

import numpy as np


def _crc_of_arrays(arrays: dict) -> int:
    crc = 0
    for key in sorted(arrays):
        if key == "checksum":
            continue
        arr = np.ascontiguousarray(arrays[key])
        crc ^= zlib.crc32(key.encode() + b"\0" + arr.tobytes())
    return crc


def artifact_checksum(path: Union[str, Path]) -> int:
    """Order-independent CRC32 over all arrays of an npz artifact but its
    ``checksum``."""
    with np.load(path, allow_pickle=False) as z:
        return _crc_of_arrays({k: z[k] for k in z.files})


def stamp_artifact(path: Union[str, Path]) -> int:
    """Add a checksum entry to an existing artifact (rewrites the file) and
    return it."""
    path = Path(path)
    # np.savez appends '.npz' to a path without that suffix: it would write a
    # new file and leave the original unstamped
    if path.suffix != ".npz":
        raise ValueError(f"artifact path must end in .npz, got {path}")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "checksum"}
    crc = _crc_of_arrays(arrays)
    np.savez(path, **arrays, checksum=np.array([crc], dtype=np.uint32))
    return crc


def verify_artifact(path: Union[str, Path]) -> bool:
    """True iff the artifact carries a checksum and it matches its content."""
    with np.load(path, allow_pickle=False) as z:
        if "checksum" not in z.files:
            return False
        arrays = {k: z[k] for k in z.files}
    return int(arrays["checksum"][0]) == _crc_of_arrays(arrays)

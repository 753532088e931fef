"""Operations and bytes of the port's kernels, and the chip's peaks.

K1, the ROC decode (``csrc/roc_decode.cu`` through ``ops/roc_decode.py``),
counted as the port's ``chip_smoke.py`` ``decode_bound`` and PERF.md's
kernel table count it: each decoded lane's head (8 bytes), stack length,
MT counter, length and precision (4 each) and the lane index (8) read
once, its used stack words (4 bytes each) read once, and the ids
i64[lanes, n_max] written once; operations: the order statistics that ROC
decoding of lists of n needs, ceil(log2 n) per id.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks_of(kind: str) -> Optional[dict]:
    """The published peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def roc_decode_bytes(lengths, stack_len, n_max: int) -> int:
    """Bytes one decode of the lanes of ``lengths`` (ids per lane) and
    ``stack_len`` (stack words per lane) must move."""
    q = len(lengths)
    return q * (8 + 4 + 4 + 8 + 4) + q * 8 + 4 * int(sum(stack_len)) + q * n_max * 8


def roc_decode_ops(lengths) -> float:
    return float(sum(n * math.ceil(math.log2(max(n, 1))) for n in lengths))


def least_seconds(nbytes: float, ops: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the bytes over its
    memory bandwidth and the operations over its scalar rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["scalar_ops_per_s"])

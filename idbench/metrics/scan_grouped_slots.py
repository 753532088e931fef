"""The program's count ``scan_grouped_slots`` a search: the (query, probe)
slots that the port's grouped float scan kernel (K5, ``ops/ivf_scan.py``)
took, nq x nprobe where it took the float buckets and 0 where the search
took the per-bucket torch scan (the LUT scan), counted in ``ivf.scan`` over
the traced window's calls, from the port's ``utils/profiling.py``
``summary`` of the last ``traced_calls`` searches. None where the program
records no such count (a port without the kernel)."""

import importlib

COUNTER = "scan_grouped_slots"


def read(ctx):
    profiling = importlib.import_module("vector_db_id_compression_tpu_torch.utils.profiling")
    summary = getattr(profiling, "summary", None)
    s = summary(ctx.traced_calls) if summary is not None else None
    if s is None or not s.searches or COUNTER not in s.counts:
        return None
    return s.counts[COUNTER] / s.searches

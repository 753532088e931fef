"""The program's count ``host_syncs`` a search: how often the host waited
for the device (a ``nonzero`` per size bucket, the translate's masks and
scatter, ``unique``, the longest list, K1's error check), each counted at
its place in the port over the traced window's calls, from the port's
``utils/profiling.py`` ``summary`` of the last ``traced_calls`` searches.
None where the program records no spans."""

import importlib

COUNTER = "host_syncs"


def read(ctx):
    profiling = importlib.import_module("vector_db_id_compression_tpu_torch.utils.profiling")
    summary = getattr(profiling, "summary", None)
    s = summary(ctx.traced_calls) if summary is not None else None
    if s is None or not s.searches:
        return None
    return s.counts.get(COUNTER, 0) / s.searches

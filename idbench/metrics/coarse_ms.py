"""Mean time a search of the program's ``ivf.coarse`` span
(``IndexIVF.coarse_assign``: the coarse product and its top-nprobe) over the
traced window's calls: stream time between the span's CUDA events on the
card, the host clock on the CPU, from the port's ``utils/profiling.py``
``summary`` of the last ``traced_calls`` searches. None where the program
records no such span."""

import importlib

SPAN = "ivf.coarse"


def read(ctx):
    profiling = importlib.import_module("vector_db_id_compression_tpu_torch.utils.profiling")
    summary = getattr(profiling, "summary", None)
    s = summary(ctx.traced_calls) if summary is not None else None
    if s is None or not s.searches or SPAN not in s.spans:
        return None
    return s.spans[SPAN].ms / s.searches

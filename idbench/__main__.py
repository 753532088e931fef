"""The port's benchmark: one run of one cell.

    python3 -m idbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. A run makes its
inputs from the seed on the card, builds the port's index through its own
API, warms up the cell's own shapes, makes the kind's timed call (for IVF
``IndexIVF.search_defer_id_decoding``) in a closed loop for ``--seconds``,
judges a sample of the results against the kind's plain reference in
``reference/``, and prints one JSON line last on
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``card`` and ``check``),
each compared number and its limit last on standard error. Without a CUDA
device it exits 2 and prints no result. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones (the kind's spans, for
IVF CUDA events around ``search_positional`` and ``_translate``;
torch.profiler over part of the window).

Everything is found by name, so a later change adds files and entries and
edits none:

- a cell: an entry of ``workloads`` in ``BENCHMARK.json`` naming a
  configuration and a traffic mix;
- a configuration: ``idbench/configs/<config>.json`` (its ``kind``, sizes,
  payload, id codec, translate, nprobe, the scan path the port must take,
  the generator's scales, the check's ``limits``; ``reduced`` and
  ``assumed``) and its entry in ``configs``;
- a kind of index: ``idbench/kinds/<kind>.py`` (inputs, build, timed call,
  spans, check; the contract is in ``kinds/__init__.py``) and its plain
  reference under ``idbench/reference/``;
- a traffic mix: ``idbench/traffic/<mix>.json`` (queries a call, k, the
  pool, warm-up, sampled calls, traced calls), read by the one closed-loop
  generator in ``harness.py``;
- an end-to-end metric: ``idbench/end_to_end/<metric>.py``, a ``read(run)``
  over the window's host-clock record;
- a per-layer metric: ``idbench/metrics/<metric>.py``, a ``read(ctx)`` over
  the traced run's spans, trace and counters that returns None where it
  finds nothing to read.

A run pins itself to the last core it may use and keeps torch's CPU work
to one thread (``OMP_NUM_THREADS=1`` unless set).

Where the data comes from: the kind's ``make_inputs``; for IVF ``data.py``
(clustered corpus around the centroids, PQ codebooks, query pool;
``torch.Generator`` on the card).
The control of the check (the reference in TF32 in the program's place) and
the program's readings over many seeds: ``python3 -m idbench.control``.
CPU self-tests: ``python -m pytest idbench/tests -q``.
"""

import os
import sys

# one process with one thread of its own on one core: the single-query cells'
# tails are the host's, and a run pinned to a core (taskset) read a steady
# 95th percentile where unpinned runs of one seed read 2.44 to 2.79 ms
os.environ.setdefault("OMP_NUM_THREADS", "1")
if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

from .harness import main  # noqa: E402  (after the pinning: torch starts its threads)

if __name__ == "__main__":
    sys.exit(main())

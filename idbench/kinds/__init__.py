"""Kinds of index, each found by name: ``idbench/kinds/<kind>.py``.

A configuration file names its kind (``"kind": "ivf"``); ``harness.load_cell``
loads ``kinds/<kind>.py`` from the checkout and fails, naming what is
missing, where the key or the file is not there. Everything that belongs
to one kind of index lives in its file under five names, and everything
that every cell shares (the cell, the closed loop, the clocks, the
profiler, the readers, the result line) stays in ``harness.py``. So a new
kind, such as ``deep1m-nsg32-roc``'s NSG graph with ROC-coded adjacency,
comes as new files: ``kinds/<kind>.py``, its reference under
``idbench/reference/``, a configuration under ``configs/`` and entries in
``BENCHMARK.json``, with no edit to a file that is there.

The five names:

- ``make_inputs(cfg, seed, pool, device)``: the inputs, made from the seed
  on the device in a few large calls (the same seed gives the same
  tensors); its ``queries`` are the pool of ``pool`` rows that the closed
  loop cycles through. ``data.make_inputs`` makes a clustered corpus that
  any kind over float vectors may use.
- ``build(cfg, inputs, device)``: the program's index over the inputs,
  through the program's own API; raises ``SetupError`` where the program
  did not set itself up as the configuration states.
- ``call(index, cfg, traffic, xq)``: the timed call on the queries ``xq``
  (``traffic["queries_per_call"]`` rows). The harness synchronises after
  it and keeps its return value, as it is, for the check.
- ``Spans(index, device)``: the traced run's records around the program's
  layers. The harness sets its ``recording`` before each call of the window
  (True for the profiled calls); ``context()``, called once the window has
  closed, gives the fields that this kind adds to the per-layer readers'
  ``ctx``.
- ``Reference(cfg, seed, pool, device)``: the plain reference, built after
  the window once the program is freed: it makes the inputs again from the
  seed and builds the reference (under ``idbench/reference/``, importing
  nothing of the program) once for every cell of a seed. Its
  ``judge(traffic, sample)`` gives the verdict on ``sample``, a list of
  ``(start, out)``: the pool's start row of a sampled call and what
  ``call`` returned; ``control(traffic, sample)`` the verdict on the control
  (the reference in the next lower precision) put in the program's place
  on the same sampled queries (``python3 -m idbench.control``). A verdict
  is ``check.judge``'s ``{number: (reading, limit)}`` and ``"failed"``,
  with one reading for every limit of the configuration's ``limits``.
"""


# what a kind's file defines; ``harness.load_cell`` names any that is missing
NAMES = ("make_inputs", "build", "call", "Spans", "Reference")


class SetupError(RuntimeError):
    """The program did not set itself up as the configuration states."""

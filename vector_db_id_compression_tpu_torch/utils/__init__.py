"""Auxiliary subsystems: artifact integrity (content checksums of the
on-disk ``.npz`` artifacts that ``store/serialize.py`` and
``search/ivf.py`` write) and profiling (``profiling.py``: a Chrome trace
of a block, and the program's spans and counters, recorded while a profiler
records)."""

from .integrity import artifact_checksum, stamp_artifact, verify_artifact  # noqa: F401
from .profiling import device_trace  # noqa: F401

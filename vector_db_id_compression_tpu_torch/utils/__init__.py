"""Auxiliary subsystems: artifact integrity (content checksums of the
on-disk ``.npz`` artifacts that ``store/serialize.py`` and
``search/ivf.py`` write)."""

from .integrity import artifact_checksum, stamp_artifact, verify_artifact  # noqa: F401

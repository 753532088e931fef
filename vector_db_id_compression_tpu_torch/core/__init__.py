"""Core primitives: the MT19937 initial-bits pool."""

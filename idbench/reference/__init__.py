"""The plain reference the benchmark judges the port by (imports nothing of
the port)."""

"""Containers: size buckets, the inverted lists with compressed ids (ROC and
interleaved ROC) and the graph adjacency containers."""

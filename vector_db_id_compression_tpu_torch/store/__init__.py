"""Containers: size buckets, the inverted lists with compressed ids and the
graph adjacency containers."""

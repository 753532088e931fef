"""Containers: size buckets and the inverted lists with compressed ids."""

"""The benchmark of the PyTorch/CUDA port (``vector_db_id_compression_tpu_torch``):
IVF search with deferred id decoding. See ``__main__.py``."""

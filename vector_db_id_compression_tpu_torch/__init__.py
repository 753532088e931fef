"""vector_db_id_compression_tpu_torch — the PyTorch/CUDA port of
``vector_db_id_compression_tpu``.

Lossless compression of the vector ids stored in an IVF index, searched with
deferred id decoding, and of the neighbour lists of an NSG graph, searched
with the decode inside the traversal, on one NVIDIA H100. The sub-layout
mirrors the JAX package so that each module's counterpart has the same path:

  core/    MT19937 initial-bits pool (numpy)
  codecs/  ROC precision rules and the lane-batched torch ROC codec (per list
           and chained), the plain version of the ROC kernels
  ops/     the hand-written CUDA kernels (``csrc/``): build, binding, wrappers;
           the ROC encode and decode kernels and two decode-step probes
  store/   size buckets, the inverted-list containers and the graph
           containers (dense, per-node ROC, chained-block ROC)
  search/  k-means, ``IndexIVF`` (flat storage, flat quantizer), NSG
           construction and the host and device best-first graph searches

The package imports torch and numpy only; it never imports jax or the JAX
package. The CUDA kernels are compiled with ``nvcc`` at first use
(``ops/_build.py``); on CPU tensors every wrapper runs its plain version.
"""

__version__ = "0.1.0"

"""vector_db_id_compression_tpu_torch — the PyTorch/CUDA port of
``vector_db_id_compression_tpu``.

Lossless compression of the vector ids stored in an IVF index, searched with
deferred id decoding, and of the neighbour lists of an NSG or HNSW graph,
searched with the decode inside the traversal, on one NVIDIA H100. The sub-layout
mirrors the JAX package so that each module's counterpart has the same path:

  core/    MT19937 initial-bits pool, the host rANS state machine, the
           order statistics (numpy and Python ints) and the bit-vector
           plumbing (packers, popcount, rank/select directories; torch)
  codecs/  ROC precision rules, the host ROC codec (the exact oracle), the
           lane-batched torch ROC codec (per list and chained; the plain
           version of the ROC kernels), interleaved ROC, and the other id
           codecs in plain torch: packed bits, Elias-Fano, the wavelet tree
           and RRR-compressed bit planes; REC's Pólya-urn bits per edge
  models/  QINCo, the neural residual quantizer (codec, trainer)
  native/  the threaded C++ host ROC codec and the HNSW build's link loop
           (g++ at first use, ctypes)
  ops/     the hand-written CUDA kernels (``csrc/``): build, binding, wrappers;
           the ROC encode and decode kernels and two decode-step probes
  store/   size buckets, the inverted-list containers (uncompressed, packed
           bits, ROC, Elias-Fano, wavelet tree, interleaved ROC) and the graph
           containers (dense, compact bits, Elias-Fano, per-node ROC,
           chained-block ROC)
  search/  k-means, the product quantizer, ``IndexIVF`` (flat, PQ and
           QINCo storage, flat or HNSW quantizer; the pair or the dense
           all-pairs scan; grouped or random-access translate), NSG
           construction, HNSW (build, descent, search) and the host and
           device best-first graph searches
  parallel/ the 'lists' mesh on torch.distributed (NCCL on the cards, gloo
           for ranks on the CPU or sharing a card): process bring-up, the
           sharded ROC encode, decode and size psum, a data-parallel QINCo
           step, and ``ShardedIVF``, the IVF search sharded by lists
  utils/   artifact checksums and profiling helpers

The package imports torch and numpy only; it never imports jax or the JAX
package. The CUDA kernels are compiled with ``nvcc`` at first use
(``ops/_build.py``); on CPU tensors every wrapper runs its plain version.
The native host code is compiled with ``g++`` at first use
(``native/__init__.py``).
"""

__version__ = "0.1.0"

"""Experiment drivers — the reference's L4 layer (SURVEY.md §1); port of the
JAX package's ``bench/``, each driver with the same module name, CLI flags,
defaults and output columns, plus ``--device`` (default: the card):

  - :mod:`.datasets`                 — P6 + faiss.contrib adapters
  - :mod:`.bench_invlists`           — P1: IVF online bench
  - :mod:`.graph_dynamic_bench`      — P2: NSG online bench
  - :mod:`.graph_static_bench`       — P3: offline REC bits/edge
  - :mod:`.generate_graph_edgelists` — P4: zuckerli interchange export
  - :mod:`.search_ivf_qinco`         — P5: large-scale QINCo pipeline
  - :mod:`.hnsw_bench`, :mod:`.codec_scale`, :mod:`.wt_translate_bench`,
    :mod:`.quantizer_bench`, :mod:`.search_100m`, :mod:`.scaling` — the
    HNSW, codec-scale, wavelet-tree translate, coarse-quantizer, 100M-id
    and weak-scaling drivers

Run one as ``python -m vector_db_id_compression_tpu_torch.bench.<driver>``.
"""

from . import datasets  # noqa: F401

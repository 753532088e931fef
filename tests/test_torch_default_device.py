"""The port's entry points run on the card unless the caller says otherwise.

Called without ``device``, each entry point takes the card: on a machine
without one it raises instead of carrying on on the CPU. With
``device="cpu"`` it runs on the CPU, and ``build_nsg`` and ``Graph`` keep a
tensor's own device. The tests that need a machine without a card skip on
one with a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import save_index
from vector_db_id_compression_tpu_torch.codecs.roc_interleaved import interleaved_encode
from vector_db_id_compression_tpu_torch.models.qinco import QincoCodec
from vector_db_id_compression_tpu_torch.parallel.mesh import make_lists_mesh
from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
from vector_db_id_compression_tpu_torch.search.hnsw import HNSW
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index
from vector_db_id_compression_tpu_torch.search.kmeans import train_kmeans
from vector_db_id_compression_tpu_torch.search.nsg import build_knn_graph, build_nsg
from vector_db_id_compression_tpu_torch.search.pq import ProductQuantizer
from vector_db_id_compression_tpu_torch.store.graph import CompactBitGraph, EliasFanoGraph, Graph
from vector_db_id_compression_tpu_torch.store.serialize import (load_graph, load_hnsw,
                                                                load_invlists, save_graph,
                                                                save_hnsw, save_invlists)
from vector_db_id_compression_tpu_torch.store.invlists import (
    EliasFanoInvertedLists,
    InterleavedRocInvertedLists,
    PackedBitsInvertedLists,
    RocInvertedLists,
    WaveletTreeInvertedLists,
)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A few vectors, a JAX index saved as .npz, its lists loaded on the
    CPU, and a packed-bits container, a compact graph and an HNSW saved by
    the port."""
    rng = np.random.default_rng(4)
    xb = rng.standard_normal((200, 8)).astype(np.float32)
    jidx = JaxIndexIVF(8, 4, storage="flat")
    jidx.train(xb)
    jidx.add(xb)
    path = tmp_path_factory.mktemp("default_device") / "index.npz"
    save_index(path, jidx)
    adj = np.array([[1, 2, -1], [0, -1, -1], [-1, -1, -1], [0, 1, 2]], np.int32)
    il = load_index(path, device="cpu").invlists
    il_path, graph_path = path.with_name("packed.npz"), path.with_name("graph.npz")
    save_invlists(il_path, PackedBitsInvertedLists(il, device="cpu"))
    save_graph(graph_path, CompactBitGraph(Graph(adj, device="cpu")))
    hnsw_path = path.with_name("hnsw.npz")
    save_hnsw(hnsw_path, HNSW(M=4, device="cpu").build(xb[:50]))
    return SimpleNamespace(xb=xb, path=path, il=il, adj=adj, il_path=il_path,
                           graph_path=graph_path, hnsw_path=hnsw_path)


# each entry point → the device its result lives on, given the keyword
# arguments (none: the default)
ENTRY_POINTS = {
    "IndexIVF": lambda s, **kw: IndexIVF(8, 8, **kw).device,
    "IndexIVF-pq": lambda s, **kw: IndexIVF(8, 8, storage="pq", pq_m=2, **kw).pq.device,
    "IndexIVF-hnsw": lambda s, **kw: IndexIVF(8, 8, quantizer="hnsw", **kw).device,
    "IndexIVF-qinco": lambda s, **kw: IndexIVF(8, 8, storage="qinco",
                                               qinco=QincoCodec(8, 2, 8, 8, **kw), **kw).device,
    "QincoCodec": lambda s, **kw: QincoCodec(8, 2, 8, 8, **kw).device,
    "QincoCodec-train": lambda s, **kw: QincoCodec(8, 2, 8, 8, **kw).train(
        s.xb, steps=1).encode(s.xb[:5]).device,
    "HNSW": lambda s, **kw: HNSW(M=4, **kw).device,
    "load_hnsw": lambda s, **kw: load_hnsw(s.hnsw_path, s.xb[:50], **kw)._xb.device,
    "load_index": lambda s, **kw: load_index(s.path, **kw).centroids.device,
    "load_invlists": lambda s, **kw: load_invlists(s.il_path, **kw).packed.words.device,
    "load_graph": lambda s, **kw: load_graph(s.graph_path, **kw).words.device,
    "make_lists_mesh": lambda s, **kw: make_lists_mesh(1, **kw).device,
    # a mesh on the CPU, and the search's own device
    "ShardedIVF": lambda s, **kw: ShardedIVF(make_lists_mesh(1, device="cpu"),
                                             load_index(s.path, device="cpu"), **kw).device,
    "ProductQuantizer": lambda s, **kw: ProductQuantizer(8, 2, **kw).device,
    "train_kmeans": lambda s, **kw: train_kmeans(s.xb, 4, niter=1, **kw).device,
    "RocInvertedLists": lambda s, **kw: RocInvertedLists(s.il, **kw).decoder.device,
    "InterleavedRocInvertedLists":
        lambda s, **kw: InterleavedRocInvertedLists(s.il, **kw).decoder.device,
    "interleaved_encode": lambda s, **kw: interleaved_encode(
        np.arange(1, 60, dtype=np.uint64), 3, **kw)[0].states.head.device,
    "build_nsg": lambda s, **kw: build_nsg(s.xb, R=8, **kw)[0].device,
    "Graph": lambda s, **kw: Graph(np.full((4, 3), -1, np.int32), **kw).device,
    "PackedBitsInvertedLists": lambda s, **kw: PackedBitsInvertedLists(s.il, **kw).packed.words.device,
    "EliasFanoInvertedLists": lambda s, **kw: EliasFanoInvertedLists(s.il, **kw).ef.low_words.device,
    "WaveletTreeInvertedLists-0":
        lambda s, **kw: WaveletTreeInvertedLists(s.il, wt_type=0, **kw).wt.words.device,
    "WaveletTreeInvertedLists-1":
        lambda s, **kw: WaveletTreeInvertedLists(s.il, wt_type=1, **kw).wt.classes.device,
    # a graph container lives on its graph's device: the card for a numpy
    # adjacency
    "CompactBitGraph": lambda s, **kw: CompactBitGraph(Graph(s.adj, **kw)).words.device,
    "EliasFanoGraph": lambda s, **kw: EliasFanoGraph(Graph(s.adj, **kw)).ef.low_words.device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_card(small, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](small)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(small, name):
    assert ENTRY_POINTS[name](small, device="cpu") == torch.device("cpu")


def test_graph_entry_points_keep_a_tensors_device(small):
    xb = torch.from_numpy(small.xb)
    assert build_nsg(xb, R=8)[0].device == xb.device
    assert build_knn_graph(xb, 4).device == xb.device
    assert Graph(torch.full((4, 3), -1, dtype=torch.int32)).device == xb.device

"""The port imports, builds and searches with jax blocked.

The machine with the card has no jax, and the JAX package's ``__init__``
imports jax and turns on x64 mode, so no module of the port may import
either. A subprocess blocks ``jax`` in ``sys.modules``, imports every module
of the port, builds a tiny ROC-compressed IVF index on the CPU and searches
it, builds the packed-bits, Elias-Fano and wavelet-tree (plain and RRR)
containers over it and searches with each through both translates, builds a
tiny IVF-PQ index and searches it with the interleaved ROC container through
both PQ scans, runs the host and native ROC codecs, builds a tiny NSG graph
and searches it with its five containers, saves and reloads the PQ index, the
interleaved container (stamped and verified) and a chained ROC graph and
searches them again, builds and searches a tiny HNSW (dense and ROC level 0,
saved and reloaded) and an IVF index with the HNSW quantizer, trains a tiny
QINCo codec into an IVF index with QINCo storage, searches it at full probe
(the dense scan) with the shortlist's codes, decodes them, saves and reloads
it, takes REC bits per edge of the NSG graph, runs the two probes, and
searches the ROC-compressed IVF index sharded over a size-1 mesh
(``parallel/``) with the sharded ROC encode beside it, and runs the P1
experiment driver (``bench/bench_invlists.py``) at a tiny size. The
JAX package is imported
here only to compare with.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np

import vector_db_id_compression_tpu  # noqa: F401  (the reference, for the test process)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "vector_db_id_compression_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import numpy as np, torch
import vector_db_id_compression_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

rng = np.random.default_rng(3)
xb = rng.standard_normal((600, 8)).astype(np.float32)
xq = rng.standard_normal((12, 8)).astype(np.float32)
index = IndexIVF(8, 8, device="cpu")
index.train(xb, niter=5)
index.add(xb)
D0, I0 = index.search(xq, 5, nprobe=2)
index.replace_invlists(RocInvertedLists(index.invlists, device="cpu"))
D1, I1 = index.search_defer_id_decoding(xq, 5, nprobe=2)
assert torch.equal(I0.sort(1).values, I1.sort(1).values)
assert torch.allclose(D0, D1, rtol=1e-4, atol=1e-3)
assert int(I1.min()) >= 0 and int(I1.max()) < 600

from vector_db_id_compression_tpu_torch.store.invlists import AVAILABLE_COMPRESSED_IVFS
for name in ("packed-bits", "elias-fano", "wavelet-tree", "wavelet-tree-1"):
    index.replace_invlists(AVAILABLE_COMPRESSED_IVFS[name](index.invlists, device="cpu"))
    for one_by_one in (True, False):
        Dc, Ic = index.search_defer_id_decoding(xq, 5, nprobe=2, decode_1by1=one_by_one)
        assert torch.equal(Ic, I0) and torch.equal(Dc, D0), name

from vector_db_id_compression_tpu_torch import native
from vector_db_id_compression_tpu_torch.codecs.roc import roc_decode, roc_encode
from vector_db_id_compression_tpu_torch.search import ivf
from vector_db_id_compression_tpu_torch.store.invlists import InterleavedRocInvertedLists

pq = IndexIVF(8, 4, storage="pq", pq_m=2, device="cpu")
pq.train(xb, niter=5)
pq.add(xb)
Dp0, Ip0 = pq.search(xq, 5, nprobe=2)
il = InterleavedRocInvertedLists(pq.invlists, interleave=3, interleave_min=20,
                                 device="cpu")
assert il.overhead_in_bytes > 0
pq.replace_invlists(il)
Dp1, Ip1 = pq.search(xq, 5, nprobe=2)
ivf.PQ_DECODE_BUDGET = 0
pq.replace_invlists(il)
Dp2, Ip2 = pq.search(xq, 5, nprobe=2)
for Dx, Ix in ((Dp1, Ip1), (Dp2, Ip2)):
    assert torch.allclose(Dx, Dp0, rtol=1e-4, atol=1e-3)
    assert ((Ix == Ip0) | torch.isclose(Dx, Dp0, rtol=1e-4, atol=1e-3)).all()
ids = pq.invlists.ids[0]
st, order = roc_encode(ids, 10)
assert (roc_decode(st.clone(), len(ids), 10) == ids[order]).all()
heads, stacks, lens, orders, mt = native.roc_encode_lists([ids], [10])
assert int(heads[0]) == st.head and stacks[0, : lens[0]].tolist() == st.stack
assert (native.roc_decode_lists(heads, stacks, lens, [len(ids)], [10])[0] == ids[order]).all()

from vector_db_id_compression_tpu_torch.ops.probes import ProbeDecodeStep, ProbeGather
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.search.nsg import build_nsg, search_graph
from vector_db_id_compression_tpu_torch.store.graph import (CompactBitGraph, EliasFanoGraph,
                                                           RocBlockGraph, RocGraph)

g, medoid = build_nsg(xb, R=8, device="cpu")
Dg, Ig = search_graph_device(g, xb, xq, 5, entry=medoid)
for c in (RocGraph(g), RocBlockGraph(g, block=4), CompactBitGraph(g), EliasFanoGraph(g)):
    D2, I2 = search_graph_device(c, xb, xq, 5, entry=medoid)
    assert torch.equal(I2, Ig) and torch.equal(D2, Dg)
Dh, Ih, _ = search_graph(g, xb, xq, 5, entry=medoid)
assert torch.equal(Ih, Ig) and torch.equal(Dh, Dg)
import os, tempfile
from vector_db_id_compression_tpu_torch.search.ivf import load_index, save_index
from vector_db_id_compression_tpu_torch.store.serialize import (load_graph, load_invlists,
                                                                save_graph, save_invlists)
from vector_db_id_compression_tpu_torch.utils import stamp_artifact, verify_artifact

with tempfile.TemporaryDirectory() as tmp:
    save_index(os.path.join(tmp, "pq.npz"), pq)
    pq2 = load_index(os.path.join(tmp, "pq.npz"), device="cpu")
    path = os.path.join(tmp, "il.npz")
    save_invlists(path, il)
    stamp_artifact(path)
    assert verify_artifact(path)
    pq2.replace_invlists(load_invlists(path, device="cpu"))
    Dp3, Ip3 = pq2.search(xq, 5, nprobe=2)
    assert torch.equal(Ip3, Ip2) and torch.equal(Dp3, Dp2)
    save_graph(os.path.join(tmp, "g.npz"), RocBlockGraph(g, block=4))
    D3, I3 = search_graph_device(load_graph(os.path.join(tmp, "g.npz"), device="cpu"), xb, xq, 5,
                                 entry=medoid)
    assert torch.equal(I3, Ig) and torch.equal(D3, Dg)
from vector_db_id_compression_tpu_torch.search.hnsw import HNSW
from vector_db_id_compression_tpu_torch.store.serialize import load_hnsw, save_hnsw

h = HNSW(M=6, ef_construction=20, device="cpu").build(xb, batch=100)
Dh0, Ih0 = h.search(xq, 5, ef=20)
assert int(Ih0.min()) >= 0 and int(Ih0.max()) < 600
Dh1, Ih1 = h.search(xq, 5, ef=20, graph0=RocGraph(h.level0_graph()))
assert torch.equal(Ih1, Ih0) and torch.equal(Dh1, Dh0)
hq = IndexIVF(8, 16, quantizer="hnsw", quantizer_M=4, device="cpu")
hq.train(xb, niter=5)
hq.add(xb)
assert sum(len(ids) for ids in hq.invlists.ids) == 600
Dq0, Iq0 = hq.search(xq, 5, nprobe=20)
hq.replace_invlists(RocInvertedLists(hq.invlists, device="cpu"))
Dq1, Iq1 = hq.search(xq, 5, nprobe=20)
assert torch.equal(Iq0.sort(1).values, Iq1.sort(1).values)
with tempfile.TemporaryDirectory() as tmp:
    save_hnsw(os.path.join(tmp, "h.npz"), h)
    Dh2, Ih2 = load_hnsw(os.path.join(tmp, "h.npz"), xb, device="cpu").search(xq, 5, ef=20)
    assert torch.equal(Ih2, Ih0) and torch.equal(Dh2, Dh0)
from vector_db_id_compression_tpu_torch.codecs.rec import Graph as RecGraph
from vector_db_id_compression_tpu_torch.codecs.rec import PolyasUrnModel, friend_to_edgelist_repr
from vector_db_id_compression_tpu_torch.models.qinco import QincoCodec

qi = IndexIVF(8, 4, storage="qinco", qinco=QincoCodec(8, 2, ksub=8, hidden=8, device="cpu"),
              device="cpu")
qi.train(xb, niter=3, qinco_steps=5)
qi.add(xb)
Dq, Iq, Cq = qi.search_defer_id_decoding(xq, 5, nprobe=4, return_codes=2)
assert Cq.shape == (12, 5, 1 + 2 + 4) and int(Iq.min()) >= 0
assert qi.qinco.decode(Cq[:, :, 1:3].reshape(-1, 2)).shape == (60, 8)
with tempfile.TemporaryDirectory() as tmp:
    save_index(os.path.join(tmp, "q.npz"), qi)
    Dq2, Iq2 = load_index(os.path.join(tmp, "q.npz"), device="cpu").search(xq, 5, nprobe=4)
    assert torch.equal(Iq2, Iq) and torch.equal(Dq2, Dq)
edges = friend_to_edgelist_repr(g.adjacency)
assert edges.shape == (int(g.degrees.sum()), 2)
assert PolyasUrnModel(600, len(edges)).compute_bpe(RecGraph(edges, 600, len(edges)))[1] > 0
ones = torch.ones((4, 8), dtype=torch.int32)
assert ProbeGather.run(ones, torch.zeros((4, 1), dtype=torch.int32), steps=5).tolist() == [[5]] * 4
assert ProbeDecodeStep.run(ones, torch.zeros((1, 8), dtype=torch.int32), steps=6).shape == (6, 8)
from vector_db_id_compression_tpu_torch.parallel import multihost
from vector_db_id_compression_tpu_torch.parallel.mesh import sharded_roc_encode
from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
from vector_db_id_compression_tpu_torch.store.invlists import roc_lane_table

multihost.initialize(device="cpu")
mesh = multihost.global_lists_mesh(device="cpu")
roc = RocInvertedLists(index.invlists, device="cpu")
Ds, Is = ShardedIVF(mesh, index, roc, device="cpu").search(xq, 5, nprobe=2)
assert torch.equal(Is, I1) and torch.allclose(Ds, D1)
ids_t, lens_t, prec_t, _ = roc_lane_table(index.invlists)
st, _ = sharded_roc_encode(mesh, torch.from_numpy(ids_t.view(np.int64)), torch.from_numpy(lens_t),
                           torch.from_numpy(prec_t), roc.decoder.states.stack.shape[1])
assert torch.equal(st.head, roc.decoder.states.head)
import contextlib, io
from vector_db_id_compression_tpu_torch.bench import bench_invlists
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    rows = bench_invlists.main(["--synth_scale", "0.01", "--index", "IVF4,Flat", "--runs", "1",
                                "--nprobe", "2", "--methods", "ref", "roc", "--device", "cpu",
                                "--out", os.path.join(tmp, "ivf.csv")])
assert len(rows) == 2 and rows[0]["recall_1"] == rows[1]["recall_1"]
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("jax", "vector_db_id_compression_tpu"))
assert not loaded, loaded
np.save(sys.argv[1], I1.numpy())
print("ok")
"""


def test_port_runs_with_jax_blocked(tmp_path):
    out = tmp_path / "ids.npy"
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    ids = np.load(out)
    assert ids.shape == (12, 5)


def test_no_port_module_imports_jax():
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax",
                                    "vector_db_id_compression_tpu"), (path, name)

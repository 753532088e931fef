"""The port imports, builds and searches with jax blocked.

The machine with the card has no jax, and the JAX package's ``__init__``
imports jax and turns on x64 mode, so no module of the port may import
either. A subprocess blocks ``jax`` in ``sys.modules``, imports every module
of the port, builds a tiny ROC-compressed IVF index on the CPU and searches
it, builds a tiny NSG graph and searches it with its three containers, and
runs the two probes. The JAX package is imported here only to compare with.
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

from vector_db_id_compression_tpu_torch.ops.probes import ProbeDecodeStep, ProbeGather
from vector_db_id_compression_tpu_torch.search.graph_device import search_graph_device
from vector_db_id_compression_tpu_torch.search.nsg import build_nsg, search_graph
from vector_db_id_compression_tpu_torch.store.graph import RocBlockGraph, RocGraph

g, medoid = build_nsg(xb, R=8)
Dg, Ig = search_graph_device(g, xb, xq, 5, entry=medoid)
for c in (RocGraph(g), RocBlockGraph(g, block=4)):
    D2, I2 = search_graph_device(c, xb, xq, 5, entry=medoid)
    assert torch.equal(I2, Ig) and torch.equal(D2, Dg)
Dh, Ih, _ = search_graph(g, xb, xq, 5, entry=medoid)
assert torch.equal(Ih, Ig) and torch.equal(Dh, Dg)
ones = torch.ones((4, 8), dtype=torch.int32)
assert ProbeGather.run(ones, torch.zeros((4, 1), dtype=torch.int32), steps=5).tolist() == [[5]] * 4
assert ProbeDecodeStep.run(ones, torch.zeros((1, 8), dtype=torch.int32), steps=6).shape == (6, 8)
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

"""Worker for tests/test_torch_parallel.py: one gloo rank of the port's
'lists' mesh on the CPU. It imports torch and the port, never jax.

The parent test saves the indexes and containers (the JAX package's files)
and a ``spec.json`` of cases into a directory; each rank loads them, runs
every case on the mesh (``run_cases``) and writes its results to
``rank{r}.npz`` there. The parent runs ``run_cases`` itself on a size-1
mesh, so both sides run the same code. Usage:

    python tests/torch_parallel_worker.py <rank> <world size> <directory>
"""

import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from vector_db_id_compression_tpu_torch.parallel import mesh as pmesh
from vector_db_id_compression_tpu_torch.parallel import multihost
from vector_db_id_compression_tpu_torch.parallel.search import ShardedIVF
from vector_db_id_compression_tpu_torch.models.qinco import QincoCodec
from vector_db_id_compression_tpu_torch.search import ivf
from vector_db_id_compression_tpu_torch.store.serialize import load_invlists


def qinco_step(mesh, spec: dict, x: np.ndarray) -> dict:
    """One sharded Adam step of a fresh QINCo model (the same weights on
    every rank: ``seed`` 0) on ``x`` → the parameters and the loss."""
    codec = QincoCodec(spec["d"], spec["M"], spec["ksub"], spec["hidden"], device="cpu")
    codec.train(x, steps=0, rq_init=False)
    opt = torch.optim.Adam(codec.model.parameters(), lr=codec.lr, betas=(0.9, 0.999), eps=1e-8)
    loss = pmesh.shard_qinco_train_step(mesh, codec, opt, torch.from_numpy(x))
    out = {f"qinco/{k}": v.numpy() for k, v in codec.model.state_dict().items()}
    out["qinco/loss"] = loss.numpy()
    return out


def codec_results(mesh, z) -> dict:
    """The sharded ROC encode, decode and size accounting of a batch."""
    ids, lengths, prec = (torch.from_numpy(z[k]) for k in ("ids", "lengths", "prec"))
    states, order = pmesh.sharded_roc_encode(mesh, ids, lengths, prec, int(z["cap"]))
    decoded = pmesh.sharded_roc_decode(mesh, states, lengths, prec, ids.shape[1])
    nbytes, nids = pmesh.sharded_size_accounting(mesh, states, lengths)
    out = {f"codec/{k}": getattr(states, k).numpy()
           for k in ("head", "stack", "stack_len", "mt_ctr", "err")}
    out.update({"codec/order": order.numpy(), "codec/decoded": decoded.numpy(),
                "codec/bytes": nbytes.numpy(), "codec/ids": nids.numpy()})
    return out


def run_cases(mesh, directory: Path) -> dict:
    """Every case of ``directory/spec.json`` on ``mesh`` → results by key."""
    spec = json.loads((directory / "spec.json").read_text())
    out = codec_results(mesh, np.load(directory / "codec.npz"))
    out.update(qinco_step(mesh, spec["qinco_step"], np.load(directory / "qinco_batch.npy")))
    indexes = {}
    for case in spec["cases"]:
        if case["index"] not in indexes:
            indexes[case["index"]] = ivf.load_index(directory / case["index"], device="cpu")
        index = indexes[case["index"]]
        container = (None if case["container"] is None
                     else load_invlists(directory / case["container"], device="cpu"))
        xq = np.load(directory / case["queries"])
        budget = ivf.PQ_DECODE_BUDGET
        if case.get("lut"):
            ivf.PQ_DECODE_BUDGET = 0
        try:
            sh = ShardedIVF(mesh, index, container, process_local=case["process_local"],
                            device="cpu")
        finally:
            ivf.PQ_DECODE_BUDGET = budget
        if sh._scan_is_float == bool(case.get("lut")):
            raise AssertionError(f"{case['name']}: the scan is not the case's")
        D, I = sh.search(xq, case["k"], case["nprobe"])
        out[f"{case['name']}/D"], out[f"{case['name']}/I"] = D.numpy(), I.numpy()
    return out


def main() -> None:
    rank, world, directory = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    multihost.initialize(init_method=f"file://{directory / 'pg_init'}", world_size=world,
                         rank=rank, device="cpu", timeout=timedelta(seconds=120))
    try:
        mesh = multihost.global_lists_mesh(device="cpu")
        assert mesh.size == world and mesh.rank == rank and mesh.backend == "gloo"
        np.savez(directory / f"rank{rank}.npz", **run_cases(mesh, directory))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""The port's ``parallel/`` (torch.distributed) against the JAX package's, on
the CPU.

The reference for each comparison: the JAX package's ``ShardedIVF`` and
sharded codec on the 8-device CPU mesh of ``conftest.py``, and its
single-device ``search_defer_id_decoding``. The port runs on a size-1 mesh in
this process and on four gloo ranks, subprocesses that import torch and the
port and never jax (``torch_parallel_worker.py``, spawned once for the
module, all cases in one run). Both sides run the worker's ``run_cases``.

Inputs: indexes and containers built from a numpy seed by the JAX package
and carried into the port through its files (``save_index``,
``save_invlists`` → ``load_index``, ``load_invlists``): the flat fixture of
``test_parallel.py`` (d 16, nlist 48, 900 vectors, 40 queries, one list
forced empty; every container), the same vectors at nlist 50 (four ranks
pad to 52, the JAX mesh to 56), its PQ fixture (nlist 24, PQ4x8, ROC ids;
the decoded scan and the LUT scan) and a QINCo index over the flat
fixture's vectors (nlist 16, QINCo4x4, hidden 32; ROC ids).

Tolerances: I exactly, D within 1e-5 relative (1e-4 for PQ and QINCo, as
``test_parallel.py``); four ranks against one: I exactly, D within 1e-6;
the sharded ROC encode bit-equal; the QINCo step's parameters within 1e-6.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as worker
from test_torch_ivf import assert_same_results
from vector_db_id_compression_tpu.codecs import roc_device as jrd
from vector_db_id_compression_tpu.models.qinco import QincoCodec as JaxQincoCodec
from vector_db_id_compression_tpu.parallel import mesh as jmesh
from vector_db_id_compression_tpu.parallel.search import ShardedIVF as JaxShardedIVF
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import save_index as jax_save_index
from vector_db_id_compression_tpu.store import invlists as jinv
from vector_db_id_compression_tpu.store import serialize as jser
from vector_db_id_compression_tpu_torch.models.qinco import QincoCodec
from vector_db_id_compression_tpu_torch.parallel import mesh as pmesh
from vector_db_id_compression_tpu_torch.parallel import multihost
from vector_db_id_compression_tpu_torch.search.ivf import load_index
from vector_db_id_compression_tpu_torch.store.serialize import load_invlists

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
CONTAINERS = ["raw"] + sorted(jinv.AVAILABLE_COMPRESSED_IVFS)
QINCO = dict(d=16, M=4, ksub=16, hidden=32)


def flat_index(nlist: int):
    """``test_parallel.py``'s flat fixture at ``nlist`` lists: (JAX index,
    queries), the smallest list merged into the largest (one list empty)."""
    rng = np.random.default_rng(5)
    d, nb, nq = 16, 900, 40
    xb = rng.normal(size=(nb, d)).astype(np.float32)
    xq = rng.normal(size=(nq, d)).astype(np.float32)
    index = JaxIndexIVF(d, nlist, storage="flat", nprobe=4)
    index.train(xb[:400])
    index.add(xb)
    il = index.invlists
    src = int(np.argmin(np.where(il.lengths > 0, il.lengths, 1 << 30)))
    dst = int(np.argmax(il.lengths))
    cs = il.code_size
    ids = np.concatenate([il.ids[dst], il.ids[src]])
    codes = np.concatenate([il.codes[dst].reshape(-1, cs), il.codes[src].reshape(-1, cs)])
    order = np.argsort(ids, kind="stable")
    il.ids[dst], il.codes[dst] = ids[order], codes[order].reshape(-1)
    il.ids[src] = np.empty(0, np.uint64)
    il.codes[src] = np.empty(0, np.uint8)
    index.replace_invlists(il)
    assert (il.lengths == 0).any()
    return index, xb, xq


def pq_index():
    """``test_parallel.py``'s PQ fixture: (JAX index, queries)."""
    rng = np.random.default_rng(11)
    d, nlist, nb, nq = 16, 24, 600, 25
    xb = rng.normal(size=(nb, d)).astype(np.float32)
    xq = rng.normal(size=(nq, d)).astype(np.float32)
    index = JaxIndexIVF(d, nlist, storage="pq", pq_m=4, nprobe=4)
    index.train(xb[:400])
    index.add(xb)
    return index, xq


def codec_batch():
    """``test_parallel.py``'s codec batch: 16 lists of 50..200 ids < 2^18."""
    rng = np.random.default_rng(0)
    B, n_max, bits = 16, 200, 18
    ids = np.zeros((B, n_max), dtype=np.uint64)
    lengths = rng.integers(50, n_max + 1, size=B).astype(np.int32)
    prec = np.zeros(B, dtype=np.int32)
    for b in range(B):
        v = np.sort(rng.choice(2**bits - 1, size=lengths[b], replace=False) + 1)
        ids[b, : lengths[b]] = v
        prec[b] = int(v.max()).bit_length()
    return ids, lengths, prec, jrd.stack_capacity(n_max, int(prec.max()))


def jax_references(jidx, jc, xq, k: int, nprobe: int, lut: bool):
    """(JAX ShardedIVF on 8 devices, JAX single-device search) → (D, I) each."""
    env = {"VDBIDC_PQ_DECODE_SCAN": "0"} if lut else {}
    old = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        jidx.replace_invlists(jc)
        sharded = JaxShardedIVF(jmesh.make_lists_mesh(8), jidx, jc).search(xq, k, nprobe=nprobe)
        single = jidx.search_defer_id_decoding(
            xq, k, nprobe=nprobe, decode_1by1=getattr(jc, "supports_random_access", True))
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return sharded, tuple(np.asarray(a) for a in single)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Saves the artifacts and the cases, starts the four gloo ranks, runs
    the cases on a size-1 mesh here and the JAX references meanwhile, then
    collects the ranks' results."""
    work = tmp_path_factory.mktemp("parallel")
    cases, jax_side = [], {}

    def case(name, jidx, jc, index_file, xq_file, k=10, nprobe=4, lut=False, pl=True,
             container_file=None):
        cases.append(dict(name=name, index=index_file, container=container_file, k=k,
                          nprobe=nprobe, lut=lut, process_local=pl, queries=xq_file))
        jax_side[name] = (jidx, jc, k, nprobe, lut)

    def save_container(jidx, mode, stem):
        if mode == "raw":
            return jidx.invlists, None
        jc = jinv.AVAILABLE_COMPRESSED_IVFS[mode](jidx.invlists)
        jser.save_invlists(work / f"{stem}_{mode}.npz", jc)
        return jc, f"{stem}_{mode}.npz"

    for nlist in (48, 50):
        jidx, xb, xq = flat_index(nlist)
        stem = f"flat{nlist}"
        jax_save_index(work / f"{stem}.npz", jidx)
        np.save(work / f"{stem}_xq.npy", xq)
        for mode in CONTAINERS:
            jc, cf = save_container(jidx, mode, stem)
            case(f"{stem}/{mode}", jidx, jc, f"{stem}.npz", f"{stem}_xq.npy", container_file=cf)
            if nlist == 48 and mode in ("raw", "roc", "elias-fano"):
                case(f"{stem}/{mode}/full", jidx, jc, f"{stem}.npz", f"{stem}_xq.npy",
                     container_file=cf, pl=False)
        if nlist == 48:
            jc = jidx.invlists
            # k past what one probed list holds; the dense scan (4 nprobe >= nlist)
            case(f"{stem}/raw/k100", jidx, jc, f"{stem}.npz", f"{stem}_xq.npy", k=100, nprobe=1)
            case(f"{stem}/raw/dense", jidx, jc, f"{stem}.npz", f"{stem}_xq.npy", nprobe=16)
    pq, xq_pq = pq_index()
    jax_save_index(work / "pq.npz", pq)
    np.save(work / "pq_xq.npy", xq_pq)
    jc, cf = save_container(pq, "roc", "pq")
    for lut in (False, True):
        case(f"pq/roc/{'lut' if lut else 'decoded'}", pq, jc, "pq.npz", "pq_xq.npy", k=8,
             lut=lut, container_file=cf)
    qidx = JaxIndexIVF(16, 16, storage="qinco",
                       qinco=JaxQincoCodec(16, QINCO["M"], ksub=QINCO["ksub"],
                                           hidden=QINCO["hidden"]))
    qidx.train(xb, niter=10, qinco_steps=40)
    qidx.add(xb)
    jax_save_index(work / "qinco.npz", qidx)
    jc, cf = save_container(qidx, "roc", "qinco")
    case("qinco/roc", qidx, jc, "qinco.npz", "flat50_xq.npy", container_file=cf)

    ids, lengths, prec, cap = codec_batch()
    np.savez(work / "codec.npz", ids=ids.view(np.int64), lengths=lengths, prec=prec, cap=cap)
    x_step = np.random.default_rng(9).standard_normal((64, QINCO["d"])).astype(np.float32)
    np.save(work / "qinco_batch.npy", x_step)
    (work / "spec.json").write_text(json.dumps({"cases": cases, "qinco_step": QINCO}))

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_parallel_worker.py"), str(r), str(WORLD),
         str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO)) for r in range(WORLD)]
    try:
        one = worker.run_cases(pmesh.make_lists_mesh(1, device="cpu"), work)
        ref = {c["name"]: jax_references(*jax_side[c["name"]][:2],
                                         np.load(work / c["queries"]), *jax_side[c["name"]][2:])
               for c in cases if c["name"] in CASES}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return SimpleNamespace(work=work, cases={c["name"]: c for c in cases}, one=one,
                           ranks=ranks, ref=ref, xb=xb, x_step=x_step)


CASES = ([f"flat48/{m}" for m in CONTAINERS] + [f"flat50/{m}" for m in CONTAINERS]
         + ["flat48/raw/k100", "flat48/raw/dense", "pq/roc/decoded", "pq/roc/lut", "qinco/roc"])


def tolerance(name: str) -> float:
    return 1e-4 if name.startswith(("pq", "qinco")) else 1e-5


# ------------------------------------------------------------------ bring-up


def test_initialize_is_a_noop_without_configuration(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize(device="cpu")


def test_process_shard_bounds_cover_exactly():
    assert multihost.process_shard_bounds(100) == (0, 100)
    arr = np.arange(10)
    np.testing.assert_array_equal(multihost.host_local_slice(arr), arr)
    for n in (1, 4):
        meshes = [pmesh.ListsMesh(r, n, torch.device("cpu")) for r in range(n)]
        bounds = [multihost.process_shard_bounds(52, m) for m in meshes]
        assert bounds[0][0] == 0 and bounds[-1][1] == 52
        assert all(a[1] == b[0] and a[1] - a[0] == 52 // n for a, b in zip(bounds, bounds[1:]))
        assert np.concatenate([multihost.host_local_slice(np.arange(52), m)
                               for m in meshes]).tolist() == list(range(52))
    with pytest.raises(ValueError, match="evenly"):
        multihost.process_shard_bounds(50, meshes[0])


def test_global_lists_mesh_is_one_rank_without_a_group():
    mesh = multihost.global_lists_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device, mesh.group) == (0, 1, torch.device("cpu"), None)
    t = torch.arange(6).reshape(2, 3)
    assert torch.equal(mesh.all_gather(t), t[None]) and torch.equal(mesh.psum(t), t)
    with pytest.raises(ValueError, match="process group"):
        pmesh.make_lists_mesh(4, device="cpu")


# --------------------------------------------------------------------- codec


@pytest.fixture(scope="module")
def jax_codec():
    ids, lengths, prec, cap = codec_batch()
    mesh = jmesh.make_lists_mesh(8)
    states, order = jmesh.sharded_roc_encode(mesh, jnp.asarray(ids), jnp.asarray(lengths),
                                             jnp.asarray(prec), cap)
    nbytes, nids = jmesh.sharded_size_accounting(mesh, states, jnp.asarray(lengths))
    return states, np.asarray(order), int(nbytes), int(nids)


def port_side(world, n: int) -> dict:
    return world.one if n == 1 else world.ranks[0]


@pytest.mark.parametrize("n", [1, WORLD])
def test_sharded_roc_encode_matches_jax(world, jax_codec, n):
    states, order, _, _ = jax_codec
    got = port_side(world, n)
    np.testing.assert_array_equal(got["codec/head"].view(np.uint64), np.asarray(states.head))
    np.testing.assert_array_equal(got["codec/stack"].view(np.uint32), np.asarray(states.stack))
    np.testing.assert_array_equal(got["codec/stack_len"], np.asarray(states.stack_len))
    np.testing.assert_array_equal(got["codec/mt_ctr"], np.asarray(states.mt_ctr))
    np.testing.assert_array_equal(got["codec/order"], order)
    assert not got["codec/err"].any()


@pytest.mark.parametrize("n", [1, WORLD])
def test_sharded_roc_decode_round_trips(world, n):
    ids, lengths, _, _ = codec_batch()
    decoded = port_side(world, n)["codec/decoded"]
    for b in range(len(ids)):
        np.testing.assert_array_equal(np.sort(decoded[b, : lengths[b]].view(np.uint64)),
                                      ids[b, : lengths[b]])
    np.testing.assert_array_equal(decoded, world.one["codec/decoded"])


@pytest.mark.parametrize("n", [1, WORLD])
def test_sharded_size_accounting_matches_jax(world, jax_codec, n):
    _, _, nbytes, nids = jax_codec
    got = port_side(world, n)
    assert (int(got["codec/bytes"]), int(got["codec/ids"])) == (nbytes, nids)
    _, lengths, _, _ = codec_batch()
    assert nids == int(lengths.sum())


# -------------------------------------------------------------------- search


@pytest.mark.parametrize("name", CASES)
def test_sharded_search_matches_jax(world, name):
    """One rank: I equal to the JAX package's sharded and single-device
    searches, D within tolerance; -1 and +inf past what the probed lists
    hold, as there."""
    (D_sh, I_sh), (D_1, I_1) = world.ref[name]
    D, I = world.one[f"{name}/D"], world.one[f"{name}/I"]
    tol = tolerance(name)
    for D_ref, I_ref in ((D_sh, I_sh), (D_1, I_1)):
        np.testing.assert_array_equal(I, I_ref)
        np.testing.assert_array_equal(np.isfinite(D), np.isfinite(D_ref))
        np.testing.assert_allclose(D, D_ref, rtol=tol, atol=tol)
    if name.endswith("k100"):
        assert (I == -1).any() and np.isinf(D[I == -1]).all()


@pytest.mark.parametrize("name", CASES)
def test_four_ranks_equal_one(world, name):
    """Four gloo ranks: every rank returns the one-rank I, and D within 1e-6."""
    for r, got in enumerate(world.ranks):
        np.testing.assert_array_equal(got[f"{name}/I"], world.one[f"{name}/I"], err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{name}/D"], world.one[f"{name}/D"], rtol=1e-6,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("mode", ["raw", "roc", "elias-fano"])
def test_process_local_equals_full_construction(world, mode):
    name = f"flat48/{mode}"
    for got in [world.one] + world.ranks:
        np.testing.assert_array_equal(got[f"{name}/full/I"], got[f"{name}/I"])
        np.testing.assert_allclose(got[f"{name}/full/D"], got[f"{name}/D"], rtol=1e-6)


@pytest.mark.parametrize("name", ["flat48/roc", "flat50/packed-bits", "pq/roc/lut", "qinco/roc"])
def test_one_rank_equals_unsharded_search(world, name):
    """The one-rank sharded search against the port's own IndexIVF search
    on the same files, under the near-tie rule of ``test_torch_ivf.py``."""
    case = world.cases[name]
    index = load_index(world.work / case["index"], device="cpu")
    container = load_invlists(world.work / case["container"], device="cpu")
    budget = worker.ivf.PQ_DECODE_BUDGET
    if case["lut"]:
        worker.ivf.PQ_DECODE_BUDGET = 0
    try:
        index.replace_invlists(container)
    finally:
        worker.ivf.PQ_DECODE_BUDGET = budget
    D, I = index.search_defer_id_decoding(np.load(world.work / case["queries"]), case["k"],
                                          nprobe=case["nprobe"])
    assert_same_results(world.one[f"{name}/D"], world.one[f"{name}/I"], D.numpy(), I.numpy())


# --------------------------------------------------------------------- QINCo


def test_qinco_train_step_four_ranks_equal_one_step(world):
    """shard_qinco_train_step on four ranks (each a quarter of the batch,
    the gradients' mean) against one Adam step of the whole batch on one
    process: parameters within 1e-6, the same loss."""
    codec = QincoCodec(QINCO["d"], QINCO["M"], QINCO["ksub"], QINCO["hidden"], device="cpu")
    codec.train(world.x_step, steps=0, rq_init=False)
    opt = torch.optim.Adam(codec.model.parameters(), lr=codec.lr, betas=(0.9, 0.999), eps=1e-8)
    loss = codec.model(torch.from_numpy(world.x_step))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    for got in [world.one] + world.ranks:
        np.testing.assert_allclose(got["qinco/loss"], loss.item(), rtol=1e-6)
        for key, want in codec.model.state_dict().items():
            np.testing.assert_allclose(got[f"qinco/{key}"], want.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=key)

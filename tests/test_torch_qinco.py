"""The port's QINCo (``models/qinco.py``) and its IVF storage against the
JAX package's, on the CPU.

Fixtures are small and seeded with numpy: d 16, M 4 (and M 12 for the order
of the parameter leaves), ksub 16, hidden 32, nlist 16, 2000 vectors of an
8-centre Gaussian mixture, 40 queries. The JAX package's parameters are
carried across with ``params_from_leaves``; the JAX index is saved with its
``save_index`` and loaded into the port, so both hold the same lists and
weights.

Tolerances:
  - decode, x_hat: 1e-5 (absolute and relative): the port adds the selected
    row's MLP output where JAX builds the whole adapted codebook, and torch
    and XLA sum the matrix products in other orders;
  - codes: equal, except where the first step at which two code rows differ
    is a near tie: the two chosen candidates' distances lie within 1e-5
    relative (float32 rounding then decides the argmin);
  - the loss: 1e-5 relative; the parameters after Adam steps: 1e-5
    relative with an absolute floor of 1e-7 (parameters that pass near 0,
    where a float32 rounding of the update is larger than 1e-5 of them);
  - ``lin_decode`` and ``compute_luts``: 1e-6; ``lin_norms``: byte-equal (the
    same additions in the same order);
  - searches: the near-tie rule of ``test_torch_ivf.py`` (rtol 1e-5, atol
    1e-4), labels of equal QINCo codes tie exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ivf import assert_same_results
from vector_db_id_compression_tpu.models.qinco import Qinco as JaxQinco
from vector_db_id_compression_tpu.models.qinco import QincoCodec as JaxQincoCodec
from vector_db_id_compression_tpu.models.qinco import make_train_step
from vector_db_id_compression_tpu.search.ivf import IndexIVF as JaxIndexIVF
from vector_db_id_compression_tpu.search.ivf import load_index as jax_load_index
from vector_db_id_compression_tpu.search.ivf import save_index as jax_save_index
from vector_db_id_compression_tpu.store.invlists import RocInvertedLists as JaxRoc
from vector_db_id_compression_tpu_torch.models.qinco import (
    QincoCodec,
    params_from_leaves,
    params_to_leaves,
)
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF, load_index, save_index
from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

D, M, KSUB, HIDDEN, NLIST, NB, NQ = 16, 4, 16, 32, 16, 2000, 40
NPROBE, NSHORT, K = 4, 30, 10
TIE = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    cent = rng.standard_normal((8, D)).astype(np.float32) * 4.0
    xb = (cent[rng.integers(0, 8, NB)] + rng.standard_normal((NB, D))).astype(np.float32)
    xq = (cent[rng.integers(0, 8, NQ)] + rng.standard_normal((NQ, D))).astype(np.float32)
    return xb, xq


def jax_init(m: int, x: np.ndarray, seed: int = 0):
    """The JAX package's freshly initialised parameters for M = ``m``, as
    its ``QincoCodec.train`` makes them (before the RQ init)."""
    return JaxQinco(d=D, M=m, ksub=KSUB, hidden=HIDDEN).init(jax.random.PRNGKey(seed),
                                                            jnp.asarray(x[:8]))


def port_codec(params, m: int = M) -> QincoCodec:
    leaves = jax.tree_util.tree_leaves(params)
    return QincoCodec(D, m, KSUB, HIDDEN, device="cpu").load_state_dict(
        params_from_leaves(leaves, D, m, KSUB, HIDDEN))


def assert_codes_equal_but_ties(codec: QincoCodec, x, got, want, tie=TIE):
    """Code rows equal, except where the first step at which they differ is
    a near tie under ``codec``'s model: the distances of the two chosen
    candidates within ``tie`` relative. Returns the rows that differ."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    rows = np.flatnonzero((got != want).any(axis=1))
    if len(rows) == 0:
        return 0
    model = codec.model
    xr = torch.as_tensor(x[rows], dtype=torch.float32)
    first = (got[rows] != want[rows]).argmax(axis=1)
    with torch.no_grad():
        for i, r in enumerate(rows):
            xi, x_hat = xr[i:i + 1], torch.zeros((1, D))
            for m in range(first[i]):
                x_hat = x_hat + model.steps[m].selected(x_hat, torch.tensor([want[r, m]]))
            cb = model.steps[first[i]](x_hat)[0]
            d2 = ((cb - (xi - x_hat)) ** 2).sum(-1)
            a, b = float(d2[got[r, first[i]]]), float(d2[want[r, first[i]]])
            assert abs(a - b) <= tie * max(abs(a), abs(b)), f"row {r}: codes differ, no tie"
    return len(rows)


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("m", [M, 12])
def test_leaves_round_trip_in_jax_order(data, m):
    """params_from_leaves puts every JAX leaf where its path says (M 12: the
    leaves run step0, step1, step10, step11, step2, ...), and
    params_to_leaves gives the leaves back bit for bit."""
    params = jax_init(m, data[0])
    codec = port_codec(params, m)
    state = codec.model.state_dict()
    paths = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p[1].key for p, _ in paths[::5]] == sorted(f"step{i}" for i in range(m))
    for path, leaf in paths:
        step, layer, name = (p.key for p in path[1:]) if len(path) == 4 else (
            path[1].key, None, path[2].key)
        key = f"steps.{step[4:]}." + (f"{layer}.{'weight' if name == 'kernel' else name}"
                                      if layer else name)
        want = np.asarray(leaf)
        got = state[key].numpy()
        np.testing.assert_array_equal(got.T if name == "kernel" else got, want)
    back = params_to_leaves(codec)
    for got, (_, want) in zip(back, paths):
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, np.asarray(want))


def test_decode_matches_jax(data):
    params = jax_init(M, data[0])
    codes = np.random.default_rng(1).integers(0, KSUB, (500, M))
    want = np.asarray(JaxQinco(d=D, M=M, ksub=KSUB, hidden=HIDDEN).apply(
        params, jnp.asarray(codes, jnp.int32), method=JaxQinco.decode))
    got = port_codec(params).decode(codes).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_encode_matches_jax(data):
    xb, _ = data
    params = jax_init(M, xb)
    codec = port_codec(params)
    jc, jx = JaxQinco(d=D, M=M, ksub=KSUB, hidden=HIDDEN).apply(
        params, jnp.asarray(xb), method=JaxQinco.encode)
    got = codec.encode(xb)
    assert got.dtype == torch.uint8 and got.shape == (NB, M)
    differ = assert_codes_equal_but_ties(codec, xb, got.numpy(), np.asarray(jc))
    assert differ <= NB // 100
    with torch.no_grad():
        codes, x_hat = codec.model.encode(torch.from_numpy(xb))
    same = (codes.numpy() == np.asarray(jc)).all(axis=1)
    np.testing.assert_allclose(x_hat.numpy()[same], np.asarray(jx)[same], rtol=1e-5, atol=1e-5)


def test_loss_and_adam_step_match_jax(data):
    """The training loss on a batch, and the parameters after one Adam step
    on it (optax.adam(1e-3) against torch.optim.Adam with its defaults)."""
    xb, _ = data
    params = jax_init(M, xb)
    batch = xb[:256]
    model = JaxQinco(d=D, M=M, ksub=KSUB, hidden=HIDDEN)
    init_fn, train_step = make_train_step(model, 1e-3)
    state = init_fn(jax.random.PRNGKey(0), jnp.asarray(xb[:8]))
    state, jloss = jax.jit(train_step)(state._replace(params=params), jnp.asarray(batch))
    codec = port_codec(params)
    opt = torch.optim.Adam(codec.model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    loss = codec.model(torch.from_numpy(batch))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    loss.backward()
    opt.step()
    for got, want in zip(params_to_leaves(codec), jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)


def test_training_steps_match_jax(data):
    """Three steps of the training loop from the same weights (JAX's
    ``QincoCodec.train`` without the RQ init): the batches are the same
    numpy draws, so the parameters agree."""
    xb, _ = data
    jc = JaxQincoCodec(D, M, ksub=KSUB, hidden=HIDDEN, seed=0).train(xb, steps=3,
                                                                     rq_init=False)
    codec = port_codec(jax_init(M, xb))
    codec._fit(torch.from_numpy(xb), steps=3, batch_size=256)
    for got, want in zip(params_to_leaves(codec), jax.tree_util.tree_leaves(jc.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)


def test_lin_parts_match_jax(data):
    xb, xq = data
    jc = JaxQincoCodec(D, M, ksub=KSUB, hidden=HIDDEN)
    jc.params = jax_init(M, xb)
    codec = port_codec(jc.params)
    codes = np.random.default_rng(2).integers(0, KSUB, (700, M)).astype(np.uint8)
    np.testing.assert_array_equal(codec.lin_codebooks, jc.lin_codebooks)
    np.testing.assert_allclose(codec.lin_decode(codes), jc.lin_decode(codes), rtol=1e-6,
                               atol=1e-6)
    assert codec.lin_norms(codes).tobytes() == jc.lin_norms(codes).tobytes()
    np.testing.assert_allclose(codec.compute_luts(xq).numpy(), np.asarray(jc.compute_luts(xq)),
                               rtol=1e-6, atol=1e-6)


def test_train_lowers_the_loss(data):
    """The RQ init alone (0 Adam steps) against 100 steps from the same
    seed: the loss on the data falls; a second codec trained alike has the
    same weights (the init and the batches come from the seed)."""
    xb, _ = data
    x = torch.from_numpy(xb)
    before = QincoCodec(D, M, KSUB, HIDDEN, device="cpu").train(xb, steps=0)
    after = QincoCodec(D, M, KSUB, HIDDEN, device="cpu").train(xb, steps=100)
    again = QincoCodec(D, M, KSUB, HIDDEN, device="cpu").train(xb, steps=100)
    with torch.no_grad():
        assert float(after.model(x)) < float(before.model(x))
    assert after.loss is not None and before.loss is None
    for a, b in zip(params_to_leaves(after), params_to_leaves(again)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- IVF


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """(JAX index trained and filled, the port's index loaded from its file,
    the file's path)."""
    xb, _ = data
    jidx = JaxIndexIVF(D, NLIST, storage="qinco",
                       qinco=JaxQincoCodec(D, M, ksub=KSUB, hidden=HIDDEN))
    jidx.train(xb, niter=10, qinco_steps=60)
    jidx.add(xb)
    path = tmp_path_factory.mktemp("qinco") / "index.npz"
    jax_save_index(path, jidx)
    return jidx, load_index(path, device="cpu"), path


def rerank_numpy(index, xq, I, codes, k):
    """The re-rank of the JAX package's bench/search_ivf_qinco.py:150-168
    → (exact L2 of the kept entries, their ids)."""
    pfx, m = index.coarse_code_size, index.qinco.M
    flat = codes.reshape(-1, codes.shape[-1])
    listnos = np.zeros(len(flat), dtype=np.int64)
    for b in range(pfx):
        listnos |= flat[:, b].astype(np.int64) << (8 * b)
    listnos = np.clip(listnos, 0, index.nlist - 1)
    dec = index.qinco.decode(flat[:, pfx:pfx + m].astype(np.int32)) + index.centroids[listnos]
    diff = dec.reshape(len(xq), I.shape[1], -1) - xq[:, None, :]
    d2 = np.where(I >= 0, (diff * diff).sum(axis=2), np.inf)
    order = np.argsort(d2, axis=1)[:, :k]
    return np.take_along_axis(d2, order, 1), np.take_along_axis(I, order, 1)


def rerank_port(index, xq, I, codes, k):
    """The same re-rank in torch (as ``chip_smoke.py``'s): the listno from the
    coarse prefix, ``qinco.decode`` plus the centroid, the exact L2, inf
    where I < 0. Empty slots (codes 0xff) decode code 0 instead: their
    distance is inf either way, and a code past ksub does not index."""
    pfx, m = index.coarse_code_size, index.qinco.M
    flat = codes.reshape(-1, codes.shape[-1]).long()
    listnos = torch.zeros(flat.shape[0], dtype=torch.int64)
    for b in range(pfx):
        listnos |= flat[:, b] << (8 * b)
    listnos = listnos.clamp(0, index.nlist - 1)
    qc = torch.where(I.reshape(-1, 1) >= 0, flat[:, pfx:pfx + m], 0)
    dec = index.qinco.decode(qc) + index.centroids[listnos]
    diff = dec.reshape(xq.shape[0], I.shape[1], -1) - torch.as_tensor(xq)[:, None, :]
    d2 = torch.where(I >= 0, (diff * diff).sum(dim=2), float("inf"))
    order = torch.argsort(d2, dim=1)[:, :k]
    return torch.gather(d2, 1, order), torch.gather(I, 1, order)


def test_loaded_index_holds_jax_content(indexes):
    jidx, tidx, _ = indexes
    assert tidx.code_size == jidx.code_size == M + 4
    np.testing.assert_array_equal(tidx.centroids.numpy(), jidx.centroids)
    want = jax.tree_util.tree_leaves(jidx.qinco.params)
    for got, leaf in zip(params_to_leaves(tidx.qinco), want):
        np.testing.assert_array_equal(got, np.asarray(leaf))
    for ln in range(NLIST):
        np.testing.assert_array_equal(tidx.invlists.ids[ln], jidx.invlists.ids[ln])
        np.testing.assert_array_equal(tidx.invlists.codes[ln], jidx.invlists.codes[ln])


def test_add_codes_match_jax(data, indexes):
    """With the JAX-trained codec and centroids, the port's add stores each
    vector's bytes as JAX's add does: the M code bytes equal except at near
    ties, and the 4 norm bytes equal wherever the codes are."""
    xb, _ = data
    jidx, tidx, _ = indexes
    port = IndexIVF(D, NLIST, storage="qinco", qinco=tidx.qinco, device="cpu")
    port.centroids = tidx.centroids
    port.add(xb)

    def by_id(il):
        lists = np.empty(NB, np.int64)
        rows = np.empty((NB, M + 4), np.uint8)
        for ln in range(NLIST):
            ids = il.ids[ln].astype(np.int64)
            lists[ids] = ln
            rows[ids] = il.codes[ln].reshape(-1, M + 4)
        return lists, rows

    (lj, rj), (lt, rt) = by_id(jidx.invlists), by_id(port.invlists)
    same_list = lj == lt
    assert same_list.mean() > 0.99
    resid = xb - jidx.centroids[lj]
    rows = np.flatnonzero(same_list)
    differ = assert_codes_equal_but_ties(tidx.qinco, resid[rows], rt[rows, :M], rj[rows, :M])
    assert differ <= NB // 100
    same = rows[(rt[rows, :M] == rj[rows, :M]).all(axis=1)]
    assert rt[same].tobytes() == rj[same].tobytes()


def test_positional_search_matches_jax(data, indexes):
    _, xq = data
    jidx, tidx, _ = indexes
    D_ref, L_ref = jidx.search_positional(xq, NSHORT, nprobe=NPROBE)
    D_got, L_got = tidx.search_positional(xq, NSHORT, nprobe=NPROBE)
    assert_same_results(D_got, L_got, D_ref, L_ref)


def test_roc_search_codes_and_rerank_match_jax(data, indexes):
    """search_defer_id_decoding with RocInvertedLists and return_codes=2 in
    both packages: I and the harvested codes (listno prefix and entry) agree,
    and so does the re-rank of the shortlist through the neural decoder."""
    _, xq = data
    jidx, tidx, _ = indexes
    jidx.replace_invlists(JaxRoc(jidx.invlists))
    tidx.replace_invlists(RocInvertedLists(tidx.invlists, device="cpu"))
    try:
        D_ref, I_ref, c_ref = jidx.search_defer_id_decoding(xq, NSHORT, nprobe=NPROBE,
                                                            return_codes=2)
        D_got, I_got, c_got = tidx.search_defer_id_decoding(xq, NSHORT, nprobe=NPROBE,
                                                            return_codes=2)
    finally:
        jidx.replace_invlists(jidx.invlists)
        tidx.replace_invlists(tidx.invlists)
    assert c_got.shape == c_ref.shape == (NQ, NSHORT, tidx.coarse_code_size + M + 4)
    assert_same_results(D_got, I_got, D_ref, I_ref)
    same = I_got.numpy() == I_ref
    assert same.mean() > 0.95
    np.testing.assert_array_equal(c_got.numpy()[same], c_ref[same])
    Dr_ref, Ir_ref = rerank_numpy(jidx, xq, I_ref, c_ref, K)
    Dr_got, Ir_got = rerank_port(tidx, xq, I_got, c_got, K)
    assert_same_results(Dr_got, Ir_got, Dr_ref, Ir_ref)


def test_roc_search_and_rerank_equal_uncompressed(data, indexes):
    """Ids are lossless: with RocInvertedLists the port returns the
    uncompressed search's rows, and the re-rank keeps the same ids."""
    _, xq = data
    _, tidx, _ = indexes
    D0, I0, c0 = tidx.search_defer_id_decoding(xq, NSHORT, nprobe=NPROBE, return_codes=2)
    tidx.replace_invlists(RocInvertedLists(tidx.invlists, device="cpu"))
    try:
        D1, I1, c1 = tidx.search_defer_id_decoding(xq, NSHORT, nprobe=NPROBE, return_codes=2)
    finally:
        tidx.replace_invlists(tidx.invlists)
    assert torch.equal(D1, D0)
    assert torch.equal(I1.sort(1).values, I0.sort(1).values)
    Dr0, Ir0 = rerank_port(tidx, xq, I0, c0, K)
    Dr1, Ir1 = rerank_port(tidx, xq, I1, c1, K)
    assert_same_results(Dr1, Ir1, Dr0.numpy(), Ir0.numpy(), rtol=0, atol=0)


def test_save_index_byte_equal_and_loads_both_ways(data, indexes, tmp_path):
    _, xq = data
    jidx, tidx, jpath = indexes
    tpath = tmp_path / "port.npz"
    save_index(tpath, tidx)
    assert tpath.read_bytes() == jpath.read_bytes()
    jidx2 = jax_load_index(tpath)
    D_ref, I_ref = jidx.search(xq, K, nprobe=NPROBE)
    D2, I2 = jidx2.search(xq, K, nprobe=NPROBE)
    np.testing.assert_array_equal(I2, I_ref)
    np.testing.assert_array_equal(D2, D_ref)
    tidx2 = load_index(tpath, device="cpu")
    D0, I0 = tidx.search(xq, K, nprobe=NPROBE)
    D3, I3 = tidx2.search(xq, K, nprobe=NPROBE)
    assert torch.equal(I3, I0) and torch.equal(D3, D0)


def test_save_index_m12_leaf_order(data, tmp_path):
    """M 12 (leaves step0, step1, step10, step11, step2, ...): the port's
    file of a JAX index's content is the JAX file byte for byte, and JAX's
    loaded codec decodes as the original."""
    xb, _ = data
    jc = JaxQincoCodec(D, 12, ksub=KSUB, hidden=HIDDEN)
    jc.params = jax_init(12, xb)
    jidx = JaxIndexIVF(D, 4, storage="qinco", qinco=jc)
    jidx.centroids = xb[:4].copy()
    jidx.add(xb[:64])
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jax_save_index(jpath, jidx)
    tidx = load_index(jpath, device="cpu")
    save_index(tpath, tidx)
    assert tpath.read_bytes() == jpath.read_bytes()
    codes = np.random.default_rng(5).integers(0, KSUB, (20, 12)).astype(np.int32)
    np.testing.assert_array_equal(jax_load_index(tpath).qinco.decode(codes), jc.decode(codes))
    np.testing.assert_allclose(tidx.qinco.decode(codes).numpy(), jc.decode(codes), rtol=1e-5,
                               atol=1e-5)


def test_train_then_add_and_full_probe(data):
    """The port's own train (k-means, then the codec on the residuals) and
    add; at full probe every bucket takes the dense scan, and the scan's
    distances are the exact L2 to the linear reconstructions."""
    xb, xq = data
    index = IndexIVF(D, NLIST, storage="qinco",
                     qinco=QincoCodec(D, M, KSUB, HIDDEN, device="cpu"), device="cpu")
    index.train(xb, niter=5, qinco_steps=20)
    assert index.qinco.loss is not None
    index.add(xb)
    assert index.ntotal == NB and sum(len(i) for i in index.invlists.ids) == NB
    Dg, L = index.search_positional(xq, K, nprobe=NLIST)
    lns, offs = (L >> 32).numpy(), (L & 0xFFFFFFFF).numpy()
    rows = np.stack([index.invlists.codes[ln].reshape(-1, M + 4)[o]
                     for ln, o in zip(lns.ravel(), offs.ravel())])
    recon = index.qinco.lin_decode(rows[:, :M]) + index.centroids.numpy()[lns.ravel()]
    want = ((recon.reshape(NQ, K, D) - xq[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(Dg.numpy(), want, rtol=1e-5, atol=1e-4)
    norms = rows[:, M:].copy().view(np.float32)[:, 0]
    assert norms.tobytes() == index.qinco.lin_norms(rows[:, :M]).tobytes()


def test_qinco_storage_arguments():
    with pytest.raises(ValueError, match="qinco"):
        IndexIVF(D, NLIST, storage="qinco", device="cpu")
    with pytest.raises(ValueError, match="qinco"):
        IndexIVF(D, NLIST, qinco=QincoCodec(D, M, KSUB, HIDDEN, device="cpu"), device="cpu")
    codec = QincoCodec(D, M, KSUB, HIDDEN, device="cpu")
    with pytest.raises(RuntimeError, match="train"):
        codec.encode(np.zeros((2, D), np.float32))
    codec.train(np.random.default_rng(0).standard_normal((300, D)), steps=1)
    with pytest.raises(ValueError, match="codes"):
        codec.decode(np.full((2, M), KSUB))

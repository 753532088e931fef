"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports no jax, so it also
runs on the machine with the card, which has none; ``tests/conftest.py``
imports jax, so there it runs without the conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vector_db_id_compression_tpu_torch.codecs import roc_device as td
from vector_db_id_compression_tpu_torch.codecs.roc import precision_for_max_id_safe
from vector_db_id_compression_tpu_torch.ops.roc_decode import RocDecoder
from vector_db_id_compression_tpu_torch.ops.roc_encode import RocEncoder
from vector_db_id_compression_tpu_torch.search.ivf import IndexIVF
from vector_db_id_compression_tpu_torch.store.invlists import RocInvertedLists

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_batch(sizes, bits, seed):
    rng = np.random.default_rng(seed)
    B, n_max = len(sizes), max(sizes)
    ids = np.zeros((B, n_max), dtype=np.uint64)
    prec = np.zeros(B, dtype=np.int32)
    for b, (n, nb) in enumerate(zip(sizes, bits)):
        v = np.sort(rng.choice(2**nb - 1, size=n, replace=False).astype(np.uint64) + 1)
        ids[b, :n] = v
        prec[b] = precision_for_max_id_safe(int(v.max()))
    return (torch.from_numpy(ids.view(np.int64)), torch.from_numpy(np.array(sizes, np.int32)),
            torch.from_numpy(prec))


@pytest.mark.parametrize("sizes,bits", [
    ([1, 5, 128, 37], [16] * 4),
    ([1, 2, 64, 512, 1000, 700, 200], [20, 20, 20, 32, 24, 12, 8]),
    ([300] * 40, [32] * 40),
])
def test_kernels_match_plain(cuda, sizes, bits):
    ids, lengths, prec = make_batch(sizes, bits, seed=len(sizes))
    before = (RocEncoder.launches, RocDecoder.launches)
    st_k, order_k = RocEncoder.encode(ids.to(cuda), lengths.to(cuda), prec.to(cuda))
    torch.cuda.synchronize()
    st_p, order_p = RocEncoder.encode(ids, lengths, prec)
    for got, want in zip(st_k, st_p):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(order_k.cpu(), order_p)
    n_max = ids.shape[1]
    dec_k = RocDecoder(st_k, lengths.to(cuda), prec.to(cuda),
                       td.default_pool(n_max, cuda), n_max)
    dec_p = RocDecoder(st_p, lengths, prec, td.default_pool(n_max), n_max)
    assert torch.equal(dec_k.decode().cpu(), dec_p.decode())
    lanes = torch.tensor([len(sizes) - 1, 0, len(sizes) // 2])
    assert torch.equal(dec_k.decode_lanes(lanes.to(cuda)).cpu(), dec_p.decode_lanes(lanes))
    # decoding twice reads the same stored stream
    assert torch.equal(dec_k.decode().cpu(), dec_p.decode())
    torch.cuda.synchronize()
    assert RocEncoder.launches == before[0] + 1
    assert RocDecoder.launches == before[1] + 3


def test_roc_ivf_search_on_card(cuda):
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((20000, 32)).astype(np.float32)
    xq = rng.standard_normal((64, 32)).astype(np.float32)
    index = IndexIVF(32, 64, device=cuda)
    index.train(xb)
    index.add(xb)
    D0, I0 = index.search(xq, 10, nprobe=8)
    roc = RocInvertedLists(index.invlists, device=cuda)
    index.replace_invlists(roc)
    D1, I1 = index.search_defer_id_decoding(xq, 10, nprobe=8)
    assert torch.equal(I0.sort(1).values, I1.sort(1).values)
    torch.testing.assert_close(D1, D0, rtol=1e-4, atol=1e-3)
    for ln in (0, 17, 63):
        assert torch.equal(roc.get_ids(ln).sort().values.cpu(),
                           torch.from_numpy(np.sort(index.invlists.ids[ln]).view(np.int64)))

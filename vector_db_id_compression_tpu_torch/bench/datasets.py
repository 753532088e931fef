"""Dataset adapters for the experiment drivers.

Port of the JAX package's ``bench/datasets.py`` (reference parity: the
benches pull ``faiss.contrib.datasets`` SyntheticDataset / DatasetSIFT1M /
DatasetDeep1M, ``bench_invlists.py:50-55``, plus the repo's own FB-ssnpp
adapter, ``qinco_datasets.py:18-51``), without a Faiss dependency:

  - :class:`SyntheticDataset` — the same Gaussian mixture, drawn with numpy
    from the same seeds, so its arrays are bit-equal to the JAX package's;
    its exact ground truth comes from :func:`knn_l2` on ``device``.
  - :class:`DatasetSIFT1M` / :class:`DatasetDeep1M` — ``.fvecs`` /
    ``.ivecs`` readers, gated on the files existing locally (nothing is
    downloaded).
  - :class:`DatasetFBSsnpp` — ``.npy``-backed.

All adapters expose the faiss.contrib-style surface the drivers use:
``d``, ``nb``, ``nq``, ``nt``, ``get_train()``, ``get_database()``,
``get_queries()``, ``get_groundtruth()``, as host numpy arrays.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve


def knn_l2(xq, xb, k: int, block: int = 4096, budget: int = 2 ** 28,
           device=DEFAULT_DEVICE) -> np.ndarray:
    """Exact L2 ground truth i64[nq, k] (host numpy), blocked matrix
    products on ``device`` (the card unless the caller says
    ``device="cpu"``).

    Double-blocked so that the distance slab [block, slab] stays within
    ``budget`` float32 elements: the database streams to the device a slab
    at a time (a 100M database is never held there whole), ``torch.topk``
    keeps each slab's k best, and the slabs' results merge by distance."""
    dev = resolve(device)
    nb = len(xb)
    slab_b = min(nb, max(k, budget // block))
    out = []
    for i in range(0, len(xq), block):
        q = torch.as_tensor(np.asarray(xq[i:i + block]), dtype=torch.float32, device=dev)
        best_d, best_i = [], []
        for s in range(0, nb, slab_b):
            e = min(s + slab_b, nb)
            xs = torch.as_tensor(np.asarray(xb[s:e]), dtype=torch.float32, device=dev)
            d2 = (xs * xs).sum(dim=1)[None, :] - 2.0 * (q @ xs.T)
            d, idx = torch.topk(d2, min(k, e - s), dim=1, largest=False, sorted=True)
            best_d.append(d)
            best_i.append(idx + s)
        d_all = torch.cat(best_d, dim=1)
        i_all = torch.cat(best_i, dim=1)
        order = torch.argsort(d_all, dim=1, stable=True)[:, :k]
        out.append(torch.gather(i_all, 1, order).cpu().numpy())
    return np.concatenate(out, axis=0)


class Dataset:
    d: int
    nb: int
    nq: int
    nt: int
    metric = "L2"

    def get_train(self) -> np.ndarray:
        raise NotImplementedError

    def get_database(self) -> np.ndarray:
        raise NotImplementedError

    def get_queries(self) -> np.ndarray:
        raise NotImplementedError

    def get_groundtruth(self, k: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def __str__(self):
        return (f"{type(self).__name__}(d={self.d}, nb={self.nb}, "
                f"nq={self.nq}, nt={self.nt})")


class SyntheticDataset(Dataset):
    """Deterministic synthetic data in the style of
    faiss.contrib.datasets.SyntheticDataset(d, nt, nb, nq): points drawn from
    a d-dim Gaussian mixture so IVF clustering is non-degenerate. The arrays
    are the JAX package's bit for bit; ``device`` is where the ground truth
    is computed."""

    def __init__(self, d: int, nt: int, nb: int, nq: int, seed: int = 1234,
                 ncent: int = 32, device=DEFAULT_DEVICE):
        self.d, self.nt, self.nb, self.nq = d, nt, nb, nq
        self.device = resolve(device)
        rng = np.random.default_rng(seed)
        self._cent = rng.standard_normal((ncent, d)).astype(np.float32) * 4.0
        self._xt = self.draw(nt, seed + 1)
        self._xb = self.draw(nb, seed + 2)
        self._xq = self.draw(nq, seed + 3)
        self._gt: Optional[np.ndarray] = None

    def draw(self, n: int, draw_seed: int) -> np.ndarray:
        """``n`` vectors f32[n, d] of the mixture, drawn with
        ``np.random.default_rng(draw_seed)`` (the training, database and
        query sets are the draws of seed + 1, + 2 and + 3)."""
        r = np.random.default_rng(draw_seed)
        a = r.integers(0, len(self._cent), n)
        return (self._cent[a] + r.standard_normal((n, self.d))).astype(np.float32)

    def get_train(self):
        return self._xt

    def get_database(self):
        return self._xb

    def get_queries(self):
        return self._xq

    def get_groundtruth(self, k: Optional[int] = None):
        kk = k or 100
        if self._gt is None or self._gt.shape[1] < kk:
            self._gt = knn_l2(self._xq, self._xb, kk, device=self.device)
        return self._gt[:, :kk]


# ----------------------------------------------------------- file readers

def read_fvecs(path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    d = raw[0]
    return raw.reshape(-1, d + 1)[:, 1:].view(np.float32).copy()


def read_ivecs(path) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int32)
    d = raw[0]
    return raw.reshape(-1, d + 1)[:, 1:].copy()


def read_bvecs(path, limit: Optional[int] = None) -> np.ndarray:
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    d = int(np.frombuffer(raw[:4], dtype=np.int32)[0])
    rec = 4 + d
    n = len(raw) // rec
    if limit is not None:
        n = min(n, limit)
    return (np.asarray(raw[: n * rec]).reshape(n, rec)[:, 4:]
            .astype(np.float32))


class _FvecsDataset(Dataset):
    """SIFT1M/Deep1M layout: <root>/<name>_{learn,base,query}.fvecs +
    <name>_groundtruth.ivecs."""

    name = ""
    env = ""

    def __init__(self, root: Optional[str] = None):
        root = root or os.environ.get(self.env, "")
        self.root = Path(root)
        base = self.root / f"{self.name}_base.fvecs"
        if not base.exists():
            raise FileNotFoundError(
                f"{base} not found — set ${self.env} to the dataset dir")
        self._xb = read_fvecs(base)
        self._xt = read_fvecs(self.root / f"{self.name}_learn.fvecs")
        self._xq = read_fvecs(self.root / f"{self.name}_query.fvecs")
        self._gt = read_ivecs(self.root / f"{self.name}_groundtruth.ivecs")
        self.nb, self.d = self._xb.shape
        self.nq = len(self._xq)
        self.nt = len(self._xt)

    def get_train(self):
        return self._xt

    def get_database(self):
        return self._xb

    def get_queries(self):
        return self._xq

    def get_groundtruth(self, k: Optional[int] = None):
        return self._gt[:, : (k or self._gt.shape[1])]


class DatasetSIFT1M(_FvecsDataset):
    name = "sift"
    env = "SIFT1M_DIR"


class DatasetDeep1M(_FvecsDataset):
    name = "deep"
    env = "DEEP1M_DIR"


class DatasetFBSsnpp(Dataset):
    """FB-ssnpp 1M slice (reference ``qinco_datasets.py:18-51``): d=256,
    nb=1M, nq=10k, stored as .npy files in ``basedir``; the shapes are read
    from the files."""

    def __init__(self, basedir: Optional[str] = None):
        basedir = basedir or os.environ.get("FB_SSNPP_DIR", "")
        self.basedir = Path(basedir)
        for f in ("database1M.npy", "queries.npy", "ground_truth1M.npy"):
            if not (self.basedir / f).exists():
                raise FileNotFoundError(
                    f"{self.basedir / f} not found — set $FB_SSNPP_DIR")
        db = np.load(self.basedir / "database1M.npy", mmap_mode="r")
        q = np.load(self.basedir / "queries.npy", mmap_mode="r")
        self.nb, self.d = db.shape
        self.nq = len(q)
        self.nt = 0

    def get_train(self):
        return self.get_database()[:100_000]

    def get_database(self):
        return np.load(self.basedir / "database1M.npy").astype(np.float32)

    def get_queries(self):
        return np.load(self.basedir / "queries.npy").astype(np.float32)

    def get_groundtruth(self, k: Optional[int] = None):
        gt = np.load(self.basedir / "ground_truth1M.npy")
        return gt[:, : (k or gt.shape[1])]


def get_dataset(idx_or_name, fb_ssnpp_dir: Optional[str] = None,
                synth_scale: float = 1.0, device=DEFAULT_DEVICE) -> Dataset:
    """Reference CLI convention (``bench_invlists.py:50-55``): datasets are
    selected by index 0..3 = [Synthetic, SIFT1M, Deep1M, FB-ssnpp]; names also
    accepted. ``synth_scale`` scales the synthetic sizes and may be
    fractional (0.02 → nb=2000). ``device`` computes the synthetic ground
    truth."""
    table = {0: "synthetic", 1: "sift1m", 2: "deep1m", 3: "fb_ssnpp"}
    name = table.get(idx_or_name, idx_or_name)
    if isinstance(name, str):
        name = name.lower()
    if name == "synthetic":
        s = float(synth_scale)
        return SyntheticDataset(32, max(int(10_000 * s), 500),
                                max(int(100_000 * s), 1_000),
                                max(int(1_000 * min(s, 1.0)), 50), device=device)
    if name == "sift1m":
        return DatasetSIFT1M()
    if name == "deep1m":
        return DatasetDeep1M()
    if name == "fb_ssnpp":
        return DatasetFBSsnpp(fb_ssnpp_dir)
    raise ValueError(f"unknown dataset {idx_or_name!r}")

"""QINCo: a residual quantizer with implicit neural codebooks, in torch.

Port of the JAX package's ``models/qinco.py`` (flax and optax). Each of the
M steps adapts its base codebook f32[ksub, d] to the reconstruction so far
through a small MLP, and picks the nearest adapted codeword to the residual:

  - ``Qinco.encode``: greedy argmin per step over the whole adapted codebook
    [B, ksub, d] (every candidate is needed);
  - ``Qinco.decode``: codes → reconstruction. It adapts only the selected
    row of each step's codebook: rows of a matrix product are independent,
    so this is the function the JAX package computes by building the whole
    [B, ksub, d] codebook and taking one row, at 1/ksub of the work (the
    shortlist re-rank's decode);
  - ``Qinco.forward``: the training loss, the mean over steps of the mean
    squared error of each prefix, the argmin taken on detached distances and
    the gradient flowing into the selected row.

``QincoCodec`` is the surface the IVF index uses: ``train`` (residual-
quantizer init of the base codebooks by k-means, then Adam with optax's
defaults on batches drawn as the JAX package draws them), ``encode``,
``decode``, and the linear part of the model (the base codebooks) for the
scan: ``lin_codebooks``, ``lin_decode``, ``lin_norms`` and ``compute_luts``.

Weights are initialised as flax initialises them (codebooks normal(0, 0.02),
kernels lecun-normal, biases zero) from an explicit ``torch.Generator``, so
they are reproducible but are not the JAX package's numbers;
``params_from_leaves`` and ``params_to_leaves`` carry the JAX package's
parameters across (the order in which its index files store them). Matrix
products stay in full float32 (``search/__init__.py`` turns TF32 off), so the
card agrees closely with the CPU and with the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve
from ..search.kmeans import assign, train_kmeans

# flax's lecun_normal: a normal truncated at 2 standard deviations, scaled so
# that the truncated distribution has variance 1 / fan_in (the divisor is the
# standard deviation of the standard normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=gen)
    weight.mul_(math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD)


class QincoStep(nn.Module):
    """One residual step: the base codebook adapted by conditioning on the
    reconstruction so far."""

    def __init__(self, d: int, ksub: int, hidden: int):
        super().__init__()
        self.codebook = nn.Parameter(torch.empty(ksub, d))
        self.adapt_in = nn.Linear(2 * d, hidden)   # over [base, x_hat]
        self.adapt_out = nn.Linear(hidden, d)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.codebook, 0.0, 0.02, generator=gen)
        for lin in (self.adapt_in, self.adapt_out):
            _lecun_normal_(lin.weight, gen)
            lin.bias.zero_()

    def _adapt(self, base: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.adapt_in(torch.cat([base, x_hat], dim=-1)))
        return base + self.adapt_out(h)

    def forward(self, x_hat: torch.Tensor) -> torch.Tensor:
        """x_hat f32[B, d] → the adapted codebook f32[B, ksub, d]."""
        B, (ksub, d) = x_hat.shape[0], self.codebook.shape
        return self._adapt(self.codebook[None].expand(B, ksub, d),
                           x_hat[:, None, :].expand(B, ksub, d))

    def selected(self, x_hat: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """Row ``codes`` i64[B] of each vector's adapted codebook, f32[B, d]."""
        return self._adapt(self.codebook[codes], x_hat)


class Qinco(nn.Module):
    """M-step residual quantizer with implicit neural codebooks."""

    def __init__(self, d: int, M: int, ksub: int = 256, hidden: int = 256):
        super().__init__()
        self.d, self.M, self.ksub, self.hidden = d, M, ksub, hidden
        self.steps = nn.ModuleList(QincoStep(d, ksub, hidden) for _ in range(M))

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes i64[B, M] → x_hat f32[B, d]."""
        x_hat = torch.zeros((codes.shape[0], self.d), device=codes.device)
        for m, step in enumerate(self.steps):
            x_hat = x_hat + step.selected(x_hat, codes[:, m])
        return x_hat

    def _step_distances(self, m: int, x: torch.Tensor, x_hat: torch.Tensor):
        """(the adapted codebook of step m, squared L2 f32[B, ksub] from the
        residual to each of its rows)."""
        cb = self.steps[m](x_hat)
        return cb, ((cb - (x - x_hat)[:, None, :]) ** 2).sum(dim=-1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x f32[B, d] → (codes i64[B, M], x_hat f32[B, d]), greedy argmin."""
        x_hat = torch.zeros_like(x)
        codes = []
        for m in range(self.M):
            cb, d2 = self._step_distances(m, x, x_hat)
            c = torch.argmin(d2, dim=-1)
            x_hat = x_hat + cb[torch.arange(x.shape[0], device=x.device), c]
            codes.append(c)
        return torch.stack(codes, dim=1), x_hat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The training loss: the squared error of every prefix, averaged
        over the batch and the steps (straight-through selection)."""
        x_hat = torch.zeros_like(x)
        loss = 0.0
        rows = torch.arange(x.shape[0], device=x.device)
        for m in range(self.M):
            cb, d2 = self._step_distances(m, x, x_hat)
            x_hat = x_hat + cb[rows, torch.argmin(d2.detach(), dim=-1)]
            loss = loss + ((x - x_hat) ** 2).sum(dim=-1).mean()
        return loss / self.M


def _leaf_steps(M: int) -> List[int]:
    """Step numbers in the order of the JAX package's parameter leaves:
    ``jax.tree_util`` sorts the keys ``step0 .. step{M-1}`` as strings."""
    return sorted(range(M), key=lambda m: f"step{m}")


def params_from_leaves(leaves, d: int, M: int, ksub: int, hidden: int) -> dict:
    """The port's ``state_dict`` for ``Qinco(d, M, ksub, hidden)`` from the
    flat list of arrays that ``jax.tree_util.tree_leaves(params)`` gives for
    the JAX package's model: per step (in that list's order, see
    ``_leaf_steps``) adapt_in bias and kernel, adapt_out bias and kernel,
    codebook. A flax kernel is [in, out]: ``nn.Linear.weight`` is its
    transpose."""
    leaves = [np.asarray(leaf, dtype=np.float32) for leaf in leaves]
    if len(leaves) != 5 * M:
        raise ValueError(f"{len(leaves)} leaves for a model of {M} steps (want {5 * M})")
    want = {"adapt_in": (2 * d, hidden), "adapt_out": (hidden, d)}
    state = {}
    for i, m in enumerate(_leaf_steps(M)):
        b_in, k_in, b_out, k_out, cb = leaves[5 * i: 5 * i + 5]
        for name, b, k in (("adapt_in", b_in, k_in), ("adapt_out", b_out, k_out)):
            if k.shape != want[name] or b.shape != (want[name][1],):
                raise ValueError(f"step{m}/{name}: shapes {k.shape}, {b.shape}")
            state[f"steps.{m}.{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k.T))
            state[f"steps.{m}.{name}.bias"] = torch.from_numpy(b.copy())
        if cb.shape != (ksub, d):
            raise ValueError(f"step{m}/codebook: shape {cb.shape}")
        state[f"steps.{m}.codebook"] = torch.from_numpy(cb.copy())
    return state


def params_to_leaves(codec: "QincoCodec") -> List[np.ndarray]:
    """The codec's weights as the JAX package's leaves (``params_from_leaves``
    inverted): C-ordered float32 numpy arrays."""
    out = []
    for m in _leaf_steps(codec.M):
        step = codec.model.steps[m]
        for lin in (step.adapt_in, step.adapt_out):
            out.append(lin.bias.detach().cpu().numpy().copy())
            out.append(np.ascontiguousarray(lin.weight.detach().cpu().numpy().T))
        out.append(step.codebook.detach().cpu().numpy().copy())
    return out


class QincoCodec:
    """A trained QINCo quantizer with the surface the IVF index needs
    (the JAX package's ``QincoCodec``). The model lives on ``device``: the
    card unless the caller says ``device="cpu"``. ``model`` is None until
    ``train`` or ``load_state_dict``."""

    def __init__(self, d: int, M: int, ksub: int = 256, hidden: int = 256,
                 lr: float = 1e-3, seed: int = 0, device=DEFAULT_DEVICE):
        if not 1 <= ksub <= 256:
            raise ValueError("ksub must lie in [1, 256]: codes are stored as uint8")
        self.d, self.M, self.ksub, self.hidden = d, M, ksub, hidden
        self.lr, self.seed = lr, seed
        self.device = resolve(device)
        self.model: Optional[Qinco] = None
        self.loss: Optional[float] = None  # the last training batch's loss

    def _fresh_model(self) -> Qinco:
        """A model initialised from ``seed`` on the CPU (the same weights
        whatever the device), then moved to ``device``."""
        model = Qinco(self.d, self.M, self.ksub, self.hidden)
        gen = torch.Generator().manual_seed(self.seed)
        for step in model.steps:
            step.init_weights(gen)
        return model.to(self.device)

    def load_state_dict(self, state: dict) -> "QincoCodec":
        """Take the weights of ``state`` (``Qinco.state_dict()`` names, as
        ``params_from_leaves`` gives them)."""
        model = Qinco(self.d, self.M, self.ksub, self.hidden)
        model.load_state_dict(state)
        self.model = model.to(self.device)
        return self

    def _as_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def _rq_init(self, x: torch.Tensor) -> None:
        """Residual-quantizer init: each step's base codebook is the k-means
        centroids of the running residuals, so that Adam only has to learn
        the neural deltas."""
        resid = x.clone()
        for step in self.model.steps:
            cb = train_kmeans(resid, self.ksub, niter=10, device=self.device)
            resid -= cb[assign(resid, cb)]
            step.codebook.copy_(cb)

    def train(self, x, steps: int = 300, batch_size: int = 256, verbose: bool = False,
              rq_init: bool = True) -> "QincoCodec":
        """Fit a fresh model to the rows of ``x`` (numpy or tensor, f32[n, d]):
        the residual-quantizer init, then ``steps`` Adam steps."""
        x = self._as_device(x)
        self.model = self._fresh_model()
        if rq_init:
            self._rq_init(x)
        return self._fit(x, steps, batch_size, verbose)

    def _fit(self, x: torch.Tensor, steps: int, batch_size: int, verbose: bool = False):
        """``steps`` Adam steps from the current weights (optax.adam's
        defaults: betas 0.9, 0.999, eps 1e-8, the same bias correction), on
        batches drawn as the JAX package draws them:
        ``np.random.default_rng(seed).choice(n, batch_size, replace=False)``
        per step."""
        n = x.shape[0]
        batch_size = min(batch_size, n)
        opt = torch.optim.Adam(self.model.parameters(), lr=self.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        rng = np.random.default_rng(self.seed)
        loss = None
        for i in range(steps):
            idx = torch.from_numpy(rng.choice(n, batch_size, replace=False)).to(self.device)
            loss = self.model(x[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if verbose and i % 50 == 0:
                print(f"  qinco step {i}: loss {loss.item():.4f}", flush=True)
        self.loss = None if loss is None else loss.item()
        return self

    # --------------------------------------------------------------- inference

    def _trained(self) -> Qinco:
        if self.model is None:
            raise RuntimeError("train the codec (or load its weights) first")
        return self.model

    @torch.no_grad()
    def encode(self, x, batch: int = 16384) -> torch.Tensor:
        """Codes u8[n, M] on the codec's device, in batches of ``batch``
        vectors: a batch's working set is a few [batch, ksub, max(2d,
        hidden)] float32 tensors (4 GiB each at d 128, ksub and hidden 256)."""
        model = self._trained()
        x = self._as_device(x)
        out = torch.empty((x.shape[0], self.M), dtype=torch.uint8, device=self.device)
        for s in range(0, x.shape[0], batch):
            out[s:s + batch] = model.encode(x[s:s + batch])[0].to(torch.uint8)
        return out

    @torch.no_grad()
    def decode(self, codes, batch: int = 32768) -> torch.Tensor:
        """Reconstructions f32[n, d] of codes [n, M] (values below ksub), in
        batches of ``batch`` codes."""
        model = self._trained()
        codes = torch.as_tensor(codes, device=self.device).long()
        if codes.numel() and not (0 <= int(codes.min()) and int(codes.max()) < self.ksub):
            raise ValueError(f"codes must lie in [0, {self.ksub})")
        out = torch.empty((codes.shape[0], self.d), device=self.device)
        for s in range(0, codes.shape[0], batch):
            out[s:s + batch] = model.decode(codes[s:s + batch])
        return out

    @property
    def codebooks(self) -> torch.Tensor:
        """The base codebooks f32[M, ksub, d] on the codec's device."""
        return torch.stack([step.codebook.detach() for step in self._trained().steps])

    @property
    def lin_codebooks(self) -> np.ndarray:
        """The base codebooks f32[M, ksub, d] on the host."""
        return self.codebooks.cpu().numpy()

    def lin_decode(self, codes) -> np.ndarray:
        """The linear reconstruction f32[n, d] (the sum of each step's base
        codeword), on the host in the JAX package's order of additions, so
        that ``lin_norms`` stored in an index are its bytes."""
        cb = self.lin_codebooks
        codes = np.asarray(codes, np.int64)
        out = np.zeros((len(codes), self.d), np.float32)
        for m in range(self.M):
            out += cb[m][codes[:, m]]
        return out

    def lin_norms(self, codes) -> np.ndarray:
        """||lin_decode(codes)||^2, f32[n]."""
        xl = self.lin_decode(codes)
        return (xl * xl).sum(axis=1).astype(np.float32)

    def compute_luts(self, xq) -> torch.Tensor:
        """f32[nq, M, ksub]: -2 <x, C_m[j]> for the base codebooks C_m."""
        return -2.0 * torch.einsum("qd,mkd->qmk", self._as_device(xq), self.codebooks)

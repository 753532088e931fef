"""Plain reference of IVF search with deferred id decoding, in PyTorch.

It imports nothing of the port and takes nothing that the port made: from
the benchmark's inputs (``idbench/data.py``: centroids, database rows,
PQ codebooks, queries) it works out again which list each row lies in, each
row's PQ code, which lists each query probes, the distances, and the
top-k with their ids (an id is the database row's number).

``precision="float64"`` is the reference: every distance in float64, with
the near ties of each choice recorded, since the program decides them in
float32 (``TAU``). ``precision="tf32"`` is the control: the same search in
the precision one step below the configuration's float32, every dot
product taken over operands rounded to TF32's 10-bit mantissa (what a
tensor core does with TF32 enabled) and summed in float32; ``search``
then puts it in the program's place.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

# a choice whose two best candidates lie within TAU x (the scale of their
# distances) of each other is a near tie: float32 rounding may take either
# (its errors are about 2^-23 of that scale, TF32's 2^-11)
TAU = 2.0 ** -16
# a filtered choice whose two best lie within REFINE x (the scale of their
# distances) of each other is decided again in float64
REFINE = 2.0 ** -6
# rows of a blocked distance product: keeps each [rows, nlist] slab at
# 2^28 float32 elements (1 GiB)
SLAB_ELEMENTS = 1 << 28
# queries handled together when expanding candidates
QUERY_BLOCK = 64


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 products on the card inside the block (the filter of
    ``_nearest``), the previous setting after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → float32 rounded to nearest (ties to even) at TF32's 10
    mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class ReferenceIVF:
    """The reference's index over ``centroids`` f32[nlist, d], rows ``xb``
    f32[n, d] and, for PQ payload, ``codebooks`` f32[M, 256, d / M]."""

    def __init__(self, centroids, xb, codebooks: Optional[torch.Tensor] = None,
                 precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision is float64 or tf32, not {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = xb.device
        self.n, self.d = xb.shape
        self.xb = xb
        self.cent = centroids.to(self.dtype)
        self.codebooks = None if codebooks is None else codebooks.to(self.dtype)
        t0 = time.perf_counter()
        self.list_of, self.list_alt = self._nearest(xb, self.cent)
        self.seconds = {"assign": time.perf_counter() - t0}
        order = torch.sort(self.list_of, stable=True).indices
        self.order = order
        counts = torch.bincount(self.list_of, minlength=self.cent.shape[0])
        self.offsets = torch.zeros(self.cent.shape[0] + 1, dtype=torch.int64,
                                   device=self.device)
        torch.cumsum(counts, 0, out=self.offsets[1:])
        if self.codebooks is not None:
            t0 = time.perf_counter()
            self.codes, self.code_alt = self._encode(xb)
            self.seconds["encode"] = time.perf_counter() - t0

    # ---------------------------------------------------------------- pieces

    def _dots(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [r, d] x b [s, d]^T in the reference's precision."""
        if self.precision == "tf32":
            return round_tf32(a.float()) @ round_tf32(b.float()).T
        return a.to(torch.float64) @ b.to(torch.float64).T

    def _nearest(self, x: torch.Tensor, cents: torch.Tensor):
        """(nearest row of ``cents`` i64[r], the second where it is a near tie
        else -1) for every row of ``x``, blocked. The float64 reference
        filters with the card's TF32 products and decides again in float64
        every row whose two best lie within ``REFINE`` of each other: the
        filter's own error (at most 2^-11 of ||x|| ||c|| per product) is far
        below that, so each choice is float64's."""
        nc = cents.shape[0]
        c32 = cents.float()
        c2 = (c32 * c32).sum(dim=1)
        rows = max(1, SLAB_ELEMENTS // nc)
        best = torch.zeros(x.shape[0], dtype=torch.int64, device=self.device)
        alt = torch.full_like(best, -1)
        if nc == 1:
            return best, alt
        with _tf32(self.precision == "float64"):
            self._nearest_blocks(x, cents, c32, c2, rows, best, alt)
        return best, alt

    def _nearest_blocks(self, x, cents, c32, c2, rows, best, alt):
        for s in range(0, x.shape[0], rows):
            xs = x[s:s + rows].float()
            if self.precision == "tf32":
                dist = c2[None, :] - 2.0 * (round_tf32(xs) @ round_tf32(c32).T)
                best[s:s + rows] = torch.argmin(dist, dim=1)
                continue
            dist = torch.addmm(c2[None, :], xs, c32.T, alpha=-2.0)
            v0, i0 = torch.min(dist, dim=1)
            dist.scatter_(1, i0[:, None], float("inf"))
            v1 = torch.min(dist, dim=1).values
            best[s:s + rows] = i0
            near = (v1 - v0) <= REFINE * ((xs * xs).sum(dim=1) + c2[i0])
            r = torch.nonzero(near)[:, 0]
            if r.numel() == 0:
                continue
            x64, c64 = xs[r].double(), cents.double()
            c2_64 = (c64 * c64).sum(dim=1)
            v, i = torch.topk(c2_64[None, :] - 2.0 * (x64 @ c64.T), 2, dim=1, largest=False)
            best[s + r] = i[:, 0]
            tie = (v[:, 1] - v[:, 0]) <= TAU * ((x64 * x64).sum(dim=1) + c2_64[i[:, 0]])
            alt[s + r] = torch.where(tie, i[:, 1], -1)

    def _encode(self, x: torch.Tensor):
        """PQ codes i64[n, M] and their near-tie alternatives (-1: none)."""
        M, _, dsub = self.codebooks.shape
        codes = torch.empty((x.shape[0], M), dtype=torch.int64, device=self.device)
        alt = torch.empty_like(codes)
        for m in range(M):
            codes[:, m], alt[:, m] = self._nearest(x[:, m * dsub:(m + 1) * dsub],
                                                   self.codebooks[m])
        return codes, alt

    def coarse(self, xq: torch.Tensor) -> torch.Tensor:
        """Squared distances of the queries to every centroid, [b, nlist]."""
        xq = xq.to(self.dtype)
        c2 = (self.cent * self.cent).sum(dim=1)
        return (xq * xq).sum(dim=1)[:, None] + c2[None, :] - 2.0 * self._dots(xq, self.cent)

    def _expand(self, lists: torch.Tensor, keep: torch.Tensor):
        """The rows of lists ``lists`` i64[b, P] where ``keep``: (query of
        each candidate i64[c], its row i64[c]), grouped by query."""
        b, P = lists.shape
        starts = self.offsets[lists]
        cnt = ((self.offsets[lists + 1] - starts) * keep).reshape(-1)
        total = int(cnt.sum())
        q = torch.repeat_interleave(
            torch.arange(b, device=self.device).repeat_interleave(P), cnt)
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        pos = torch.arange(total, device=self.device) - first + torch.repeat_interleave(
            starts.reshape(-1), cnt)
        return q, self.order[pos]

    def distances(self, xq: torch.Tensor, q: torch.Tensor, rows: torch.Tensor):
        """(low, high) squared distances of query ``q`` to row ``rows``, for
        pairs; flat payload: the row itself (low == high); PQ payload: the
        row's reconstruction, its near-tie codes taken at their lowest and
        highest (the program may have chosen either)."""
        x = xq.to(self.dtype)[q]
        if self.codebooks is None:
            y = self.xb[rows].to(self.dtype)
            if self.precision == "tf32":
                dot = (round_tf32(x) * round_tf32(y)).sum(dim=1)
                d = (x * x).sum(dim=1) + (y * y).sum(dim=1) - 2.0 * dot
            else:
                d = ((x - y) ** 2).sum(dim=1)
            return d, d
        M, _, dsub = self.codebooks.shape
        lo = torch.zeros(q.shape[0], dtype=self.dtype, device=self.device)
        hi = torch.zeros_like(lo)
        for m in range(M):
            xm = x[:, m * dsub:(m + 1) * dsub]
            a = self._sub_dist(xm, self.codebooks[m][self.codes[rows, m]])
            alt = self.code_alt[rows, m] if self.precision == "float64" else None
            if alt is None or not bool((alt >= 0).any()):
                lo += a
                hi += a
                continue
            b = self._sub_dist(xm, self.codebooks[m][alt.clamp(min=0)])
            b = torch.where(alt >= 0, b, a)
            lo += torch.minimum(a, b)
            hi += torch.maximum(a, b)
        return lo, hi

    def _sub_dist(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            dot = (round_tf32(x) * round_tf32(c)).sum(dim=1)
            return (x * x).sum(dim=1) + (c * c).sum(dim=1) - 2.0 * dot
        return ((x - c) ** 2).sum(dim=1)

    @staticmethod
    def _topk_by_query(b: int, q: torch.Tensor, d: torch.Tensor, rows: torch.Tensor, k: int):
        """Per query of ``b``, the k smallest of (d, rows) grouped by ``q``
        (+inf, -1 past a query's candidates)."""
        dev = d.device
        counts = torch.bincount(q, minlength=b)
        width = max(int(counts.max()) if q.numel() else 0, k)
        first = torch.cumsum(counts, 0) - counts
        col = torch.arange(q.shape[0], device=dev) - first[q]
        dense = torch.full((b, width), float("inf"), dtype=d.dtype, device=dev)
        ids = torch.full((b, width), -1, dtype=torch.int64, device=dev)
        dense[q, col] = d
        ids[q, col] = rows
        v, j = torch.topk(dense, k, dim=1, largest=False, sorted=True)
        return v, torch.gather(ids, 1, j)

    # ---------------------------------------------------------------- search

    def search(self, xq: torch.Tensor, k: int, nprobe: int):
        """The whole search in this precision, in the program's place:
        (D f32[nq, k], I i64[nq, k])."""
        Ds, Is = [], []
        for s in range(0, xq.shape[0], QUERY_BLOCK):
            xb_ = xq[s:s + QUERY_BLOCK]
            lists = torch.topk(self.coarse(xb_), nprobe, dim=1, largest=False).indices
            q, rows = self._expand(lists, torch.ones_like(lists, dtype=torch.bool))
            d, _ = self.distances(xb_, q, rows)
            v, i = self._topk_by_query(xb_.shape[0], q, d, rows, k)
            Ds.append(v.float())
            Is.append(i)
        return torch.cat(Ds), torch.cat(Is)

    def judge(self, xq: torch.Tensor, D: torch.Tensor, I: torch.Tensor, nprobe: int):
        """Per query, the two numbers that ``check.py`` compares (float64
        reference only), each relative to the query's scale 2 ||x||^2:

        - ``dist_err``: how far each returned distance lies from the
          reference's distance of the returned id (outside its near-tie
          band): the scan's arithmetic and the translate (a wrong id has
          another distance);
        - ``rank_gap``: the largest amount by which the j-th returned
          result, by the reference's distance, lies beyond the reference's
          own j-th over the lists it surely probes: the coarse stage, the
          scan's completeness and the merge. A slot with no valid id, an id
          twice, or an id whose list the query cannot have probed counts
          as ``MISSING``.
        """
        if self.precision != "float64":
            raise ValueError("only the float64 reference judges")
        k = D.shape[1]
        nlist = self.cent.shape[0]
        dist_err, rank_gap = [], []
        for s in range(0, xq.shape[0], QUERY_BLOCK):
            x = xq[s:s + QUERY_BLOCK]
            Dp = D[s:s + QUERY_BLOCK].to(torch.float64)
            Ip = I[s:s + QUERY_BLOCK].to(torch.int64)
            b = x.shape[0]
            scale = 2.0 * (x.to(torch.float64) ** 2).sum(dim=1)
            cd = self.coarse(x)
            v, lists = torch.topk(cd, min(nprobe + 1, nlist), dim=1, largest=False,
                                  sorted=True)
            # lists the program surely probed, and those it may have
            bound = v[:, nprobe] if nprobe < nlist else torch.full_like(v[:, 0], float("inf"))
            surely_l = lists[:, :nprobe]
            surely_k = cd.gather(1, surely_l) < (bound - TAU * scale)[:, None]
            surely = torch.zeros((b, nlist), dtype=torch.bool, device=self.device)
            surely.scatter_(1, surely_l, surely_k)
            maybe = cd <= (v[:, nprobe - 1] + TAU * scale)[:, None]
            # the reference's own top-k over rows surely in surely-probed lists
            q, rows = self._expand(surely_l, surely_k)
            alt = self.list_alt[rows]
            certain = (alt < 0) | surely[q, alt.clamp(min=0)]
            q, rows = q[certain], rows[certain]
            _, hi = self.distances(x, q, rows)
            ref_top, _ = self._topk_by_query(b, q, hi, rows, k)
            # the program's results
            valid = (Ip >= 0) & (Ip < self.n)
            safe = Ip.clamp(0, self.n - 1)
            srt = torch.sort(torch.where(valid, Ip, -1 - torch.arange(k, device=self.device)),
                             dim=1).values
            dup_row = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
            dup = torch.zeros_like(valid)
            # an id returned twice: every slot holding it is rejected
            for j in range(k):
                dup[:, j] = ((srt[:, 1:] == Ip[:, j:j + 1]) & dup_row).any(dim=1)
            rows_q = torch.arange(b, device=self.device)[:, None].expand(b, k)
            alt_p = self.list_alt[safe]
            in_maybe = maybe[rows_q, self.list_of[safe]] | (
                (alt_p >= 0) & maybe[rows_q, alt_p.clamp(min=0)])
            ok = valid & ~dup & in_maybe
            lo, hi_p = self.distances(x, rows_q.reshape(-1), safe.reshape(-1))
            lo, hi_p = lo.view(b, k), hi_p.view(b, k)
            finite = torch.isfinite(Dp)
            excess = torch.clamp(torch.maximum(lo - Dp, Dp - hi_p), min=0.0) / scale[:, None]
            excess = torch.where(ok & finite, excess, 0.0)
            excess = torch.where(ok & ~finite, MISSING, excess)
            dist_err.append(excess.max(dim=1).values)
            got = torch.sort(torch.where(ok, lo, float("inf")), dim=1).values
            gap = (got - ref_top) / scale[:, None]
            gap = torch.where(torch.isinf(got) & torch.isfinite(ref_top), MISSING, gap)
            gap = torch.where(torch.isinf(got) & torch.isinf(ref_top), 0.0, gap)
            rank_gap.append(gap.max(dim=1).values)
        return torch.cat(dist_err), torch.cat(rank_gap)


# what a result slot that cannot be right reads (a relative gap of about 1
# is already as far as a random row lies)
MISSING = 1.0e6

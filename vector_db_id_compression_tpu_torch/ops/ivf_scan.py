"""Grouped float IVF scan: the CUDA kernel ``csrc/ivf_flat_scan.cu`` (K5)
and its plain version.

A search's (query, probe) slots, ``nq x nprobe`` of them, are grouped by
the list they probe (``group_slots``: a stable sort on the device, so the
host waits for nothing); then one call a size bucket whose payload is float
(``scan_flat_grouped``) computes, for every slot of every lane's list, the
k nearest rows, ||x - y||^2 = ||x||^2 + ||y||^2 - 2 <x, y> in float32, and
writes them into the search's candidates at the slot's row: k sorted
distances and labels (list << 32 | offset), +inf and -1 past the list's
length. On CUDA tensors it launches the kernel, which reads each probed
list once for all the queries that probe it (the source says what bounds
it); on CPU tensors it runs ``scan_flat_grouped_plain``, a loop over the
lanes. There is no other route: a tensor on any other device raises, and a
CUDA launch that fails raises. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

# the largest k the kernel keeps (csrc/ivf_flat_scan.cu kMaxK); a search
# with a larger k takes the per-bucket torch scan
MAX_K = 128

launches = 0


def group_slots(probes: torch.Tensor, bucket_of: torch.Tensor):
    """The slots of ``probes`` i64[nq, nprobe] grouped by list: (order
    i64[nq * nprobe], the slots q * nprobe + p sorted by their list, in slot
    order within a list; starts i64[nlist + 1], list l's slots at
    order[starts[l]:starts[l + 1]]). ``bucket_of`` i64[nlist] holds each
    list's size bucket, -1 for a list in none (an empty list): its slots,
    and -1 probes (an HNSW quantizer's unreached slots), key to the sentinel
    nlist, after every list. Plain torch on the probes' device, no sync."""
    nlist = bucket_of.numel()
    flat = probes.reshape(-1)
    lists = flat.clamp(min=0)
    # int32 keys: half the radix passes of int64 ones
    key = torch.where((flat >= 0) & (bucket_of[lists] >= 0), lists, nlist).int()
    keys, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(keys, torch.arange(nlist + 1, dtype=torch.int32,
                                                   device=keys.device))
    return order, starts


def scan_flat_grouped(xq, x2, payload, norms, lengths, lists, order, starts, nprobe: int,
                      k: int, out_d, out_l) -> None:
    """One size bucket's scan into the candidates: for each lane b, list
    ``lists[b]``, each of its slots s (``order``, ``starts`` of
    ``group_slots``) with query q = s // nprobe gets out_d[s] = the k
    smallest ||y||^2 - 2 <xq[q], y> + x2[q] over the lane's first
    ``lengths[b]`` rows y of ``payload`` (sorted, ties to the lower offset)
    and out_l[s] their labels (list << 32 | offset), +inf and -1 past the
    list's length. xq f32[nq, d], x2 f32[nq], payload f32[B, n_pad, d],
    norms f32[B, n_pad], lengths and lists i64[B], out_d f32[S, k] and
    out_l i64[S, k] (or any shape of S * k elements, contiguous); other
    rows of the outputs are left as they are."""
    global launches
    device = xq.device
    B = lists.numel()
    d = xq.shape[1]
    for name, t, dtype in (("xq", xq, torch.float32), ("x2", x2, torch.float32),
                           ("payload", payload, torch.float32), ("norms", norms, torch.float32),
                           ("lengths", lengths, torch.int64), ("lists", lists, torch.int64),
                           ("order", order, torch.int64), ("starts", starts, torch.int64),
                           ("out_d", out_d, torch.float32), ("out_l", out_l, torch.int64)):
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name} must be {dtype} on {device}, got {t.dtype} on {t.device}")
    if (payload.dim() != 3 or payload.shape[0] != B or payload.shape[2] != d
            or tuple(norms.shape) != tuple(payload.shape[:2]) or lengths.numel() != B):
        raise ValueError(f"payload [B, n_pad, d], norms [B, n_pad], lengths [B] for B = {B} "
                         f"lanes and d = {d}, got {list(payload.shape)}, {list(norms.shape)}, "
                         f"{list(lengths.shape)}")
    if out_d.numel() != order.numel() * k or out_l.numel() != out_d.numel():
        raise ValueError(f"out_d and out_l hold {order.numel()} slots x k = {k} entries")
    if not (out_d.is_contiguous() and out_l.is_contiguous()):
        raise ValueError("out_d and out_l must be contiguous")
    if device.type == "cpu":
        scan_flat_grouped_plain(xq, x2, payload, norms, lengths, lists, order, starts, nprobe,
                                k, out_d, out_l)
        return
    if device.type != "cuda":
        raise ValueError(f"the grouped scan runs on cpu or cuda tensors, not {device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the grouped scan kernel keeps 1 to {MAX_K} nearest, not {k}")
    if B == 0:
        return
    xq, x2, payload, norms = (t.contiguous() for t in (xq, x2, payload, norms))
    lengths, lists, order, starts = (t.contiguous() for t in (lengths, lists, order, starts))
    vec = d % 4 == 0 and payload.data_ptr() % 16 == 0 and xq.data_ptr() % 16 == 0
    lib = load_library()
    with torch.cuda.device(device):
        code = lib.ivf_flat_scan_launch(
            payload.data_ptr(), norms.data_ptr(), lengths.data_ptr(), lists.data_ptr(), B,
            payload.shape[1], d, order.data_ptr(), starts.data_ptr(), xq.data_ptr(),
            x2.data_ptr(), nprobe, k, int(vec), out_d.data_ptr(), out_l.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    check_launch(lib, code, "grouped IVF scan")
    launches += 1


def scan_flat_grouped_plain(xq, x2, payload, norms, lengths, lists, order, starts, nprobe: int,
                            k: int, out_d, out_l) -> None:
    """``scan_flat_grouped`` in plain torch, a lane at a time (reads the
    slot ranges on the host)."""
    out_d, out_l = out_d.view(-1, k), out_l.view(-1, k)
    bounds = starts.tolist()
    for b, ln in enumerate(lists.tolist()):
        slots = order[bounds[ln]:bounds[ln + 1]]
        if not slots.numel():
            continue
        n = int(lengths[b])
        q = slots // nprobe
        d2 = norms[b, :n][None, :] - 2.0 * (xq[q] @ payload[b, :n].T)
        kk = min(k, n)
        dists, offs = torch.sort(d2, dim=1, stable=True)
        out_d[slots] = float("inf")
        out_l[slots] = -1
        out_d[slots, :kk] = dists[:, :kk] + x2[q][:, None]
        out_l[slots, :kk] = (ln << 32) | offs[:, :kk]

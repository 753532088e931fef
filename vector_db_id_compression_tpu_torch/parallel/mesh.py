"""The 'lists' mesh on torch.distributed, and the sharded codec.

Port of the JAX package's ``parallel/mesh.py``. The unit of parallelism is
the inverted list: a mesh of N ranks, one device each, shards the lists
contiguously (rank r owns rows [r * B / N, (r + 1) * B / N)), and every lane
of the batched codecs is independent, so encode and decode need no
collective in their loops. Gathers run in rank order, so the N-rank artifact
is bit-identical to the 1-rank artifact by construction.

``ListsMesh`` carries the rank, the size, the rank's device and the process
group. A mesh of size 1 without a group is the JAX package's 1-device mesh:
its collectives are the identity. Two collectives: ``all_gather`` in rank
order and ``psum`` (all_reduce SUM). NCCL takes the device tensors; gloo has
no all_gather on CUDA tensors, so under gloo the mesh stages them through
the host. The choice follows the group's backend, never a caught error.

The codec functions take global arrays (every lane) and compute only the
rank's rows: ``sharded_roc_encode`` runs the encode kernel
(``ops/roc_encode.py``) and ``sharded_roc_decode`` the decode kernel
(``ops/roc_decode.py``) on the rank's lanes; on CPU tensors each runs its
plain version. ``shard_qinco_train_step`` is data parallel: each rank takes
its slice of the batch and the gradients are all-reduced to their mean.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..codecs import roc_device as rd
from ..device import DEFAULT_DEVICE, resolve
from ..ops.roc_decode import RocDecoder
from ..ops.roc_encode import RocEncoder


def rank_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` for this rank: a bare ``"cuda"`` means card ``LOCAL_RANK``
    (torchrun's, 0 without it) modulo the cards present, so that ranks
    beyond the cards share them; any other device as given. Raises where
    the device is not available (``device.resolve``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = max(torch.cuda.device_count(), 1)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % cards)
    return resolve(dev)


@dataclass(frozen=True)
class ListsMesh:
    """One rank of a 1-D 'lists' mesh: its rank and the mesh size, the
    rank's device, the process group and its backend (None for a size-1
    mesh without a group)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank), stacked in rank
        order → [size, *t.shape] on ``t``'s device."""
        if self.group is None:
            return t[None]
        src = t.cpu() if self._staged(t) else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(t.device)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, on ``t``'s device."""
        if self.group is None:
            return t
        out = t.cpu().clone() if self._staged(t) else t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out.to(t.device)

    def rows(self, n_rows: int) -> Tuple[int, int]:
        """[lo, hi) of the rank's rows of an [n_rows, ...] array sharded over
        the mesh (n_rows a multiple of the size)."""
        if n_rows % self.size:
            raise ValueError(f"{n_rows} rows do not shard evenly over {self.size} ranks")
        per = n_rows // self.size
        return self.rank * per, (self.rank + 1) * per


def make_lists_mesh(n_devices: Optional[int] = None, device=DEFAULT_DEVICE,
                    group: Optional[dist.ProcessGroup] = None) -> ListsMesh:
    """The mesh over every rank of ``group``, a sub-group of the launched
    world (``dist.new_group``) that this rank belongs to; without one, over
    every rank of the default process group (``multihost.initialize``), or
    the size-1 mesh where none is initialized. ``device``: the rank's device
    (``rank_device``); ``n_devices``, where given, must be the group's size
    (1 without a group)."""
    dev = rank_device(device)
    if group is not None:
        rank = dist.get_rank(group)
        if rank < 0:
            raise ValueError("this rank is not a member of the group")
        size, backend = dist.get_world_size(group), dist.get_backend(group)
    elif dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
        backend = dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} needs a process group of that size; "
                         f"this one has {size} rank(s)")
    return ListsMesh(rank, size, dev, group, backend)


def _padded(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """``t`` with rows of ``fill`` appended up to ``rows``."""
    if t.shape[0] == rows:
        return t
    pad = torch.full((rows - t.shape[0], *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def _local(mesh: ListsMesh, t: torch.Tensor, fill=0) -> torch.Tensor:
    """The rank's rows of a global lane array on the mesh's device, the
    lanes padded with ``fill`` up to a multiple of the mesh size."""
    b_pad = -(-t.shape[0] // mesh.size) * mesh.size
    lo, hi = mesh.rows(b_pad)
    return _padded(t[lo:min(hi, t.shape[0])].to(mesh.device), hi - lo, fill)


def _gathered(mesh: ListsMesh, t: torch.Tensor, rows: int) -> torch.Tensor:
    """Every rank's lanes ``t`` in list order, the first ``rows`` of them."""
    g = mesh.all_gather(t)
    return g.reshape(-1, *t.shape[1:])[:rows]


def sharded_roc_encode(mesh: ListsMesh, sorted_ids: torch.Tensor, lengths: torch.Tensor,
                       precision: torch.Tensor, cap: int) -> Tuple[rd.RocStates, torch.Tensor]:
    """ROC-encode B lists sharded over the mesh: each rank encodes its rows
    (the encode kernel on the card), and the states and the sampling order
    are gathered in list order → (RocStates with stacks [B, cap], order
    i32[B, n_max]) on the mesh's device, bit-identical to the 1-rank encode.

    sorted_ids i64[B, n_max] (u64 ids as int64, ascending in [0, len) per
    lane), lengths and precision i32[B]; ``cap`` the stack width of the
    result (``rd.stack_capacity(n_max, max precision)``, the JAX package's
    argument). Raises where a lane's stack outgrows ``cap``."""
    B = sorted_ids.shape[0]
    ids_l = _local(mesh, sorted_ids)
    len_l, prec_l = _local(mesh, lengths), _local(mesh, precision)
    states, order = RocEncoder.encode(ids_l, len_l, prec_l)
    if int(states.stack_len.max()) > cap:
        raise ValueError(f"a stack outgrows cap = {cap}")
    stack = states.stack[:, :cap]
    if stack.shape[1] < cap:
        stack = torch.nn.functional.pad(stack, (0, cap - stack.shape[1]))
    gathered = rd.RocStates(
        head=_gathered(mesh, states.head, B), stack=_gathered(mesh, stack, B),
        stack_len=_gathered(mesh, states.stack_len, B), mt_ctr=_gathered(mesh, states.mt_ctr, B),
        err=_gathered(mesh, states.err.to(torch.int32), B) != 0)
    return gathered, _gathered(mesh, order, B)


def sharded_roc_decode(mesh: ListsMesh, states: rd.RocStates, lengths: torch.Tensor,
                       precision: torch.Tensor, n_max: int) -> torch.Tensor:
    """Decode B lists sharded over the mesh: each rank decodes its rows (the
    decode kernel on the card) → ids i64[B, n_max] in sampling order,
    gathered in list order on the mesh's device."""
    B = lengths.shape[0]
    # pad lanes: a fresh state (head 2^31) of length 0
    local = rd.RocStates(head=_local(mesh, states.head, rd.RANS_L),
                         stack=_local(mesh, states.stack), stack_len=_local(mesh, states.stack_len),
                         mt_ctr=_local(mesh, states.mt_ctr), err=_local(mesh, states.err))
    dec = RocDecoder(local, _local(mesh, lengths), _local(mesh, precision),
                     rd.default_pool(n_max, mesh.device), n_max)
    return _gathered(mesh, dec.decode(), B)


def sharded_size_accounting(mesh: ListsMesh, states: rd.RocStates,
                            lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed size over the mesh: each rank sums 8 + 4 * stack_len over
    its non-empty lists, and its ids, and an int64 psum adds the ranks' →
    (total bytes, total ids), 0-d int64 tensors on the mesh's device (the
    JAX package's formula)."""
    stack_len = _local(mesh, states.stack_len).to(torch.int64)
    len_l = _local(mesh, lengths).to(torch.int64)
    local = torch.stack([torch.where(len_l > 0, 8 + 4 * stack_len, 0).sum(), len_l.sum()])
    total = mesh.psum(local)
    return total[0], total[1]


def shard_qinco_train_step(mesh: ListsMesh, codec, optimizer: torch.optim.Optimizer,
                           batch: torch.Tensor) -> torch.Tensor:
    """One data-parallel step of ``codec`` (a ``models.qinco.QincoCodec``
    whose model every rank holds with the same weights): each rank takes
    its slice of ``batch`` (f32[B, d], B a multiple of the mesh size, the
    same on every rank), the gradients are all-reduced to their mean, and
    ``optimizer`` steps. Returns the batch's loss (the mean of the ranks'),
    a 0-d tensor; the step equals one step on the whole batch up to float
    rounding."""
    lo, hi = mesh.rows(batch.shape[0])
    model = codec.model
    loss = model(batch[lo:hi].to(codec.device))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in model.parameters():
        if p.grad is not None:
            p.grad.copy_(mesh.psum(p.grad) / mesh.size)
    optimizer.step()
    return mesh.psum(loss.detach()) / mesh.size

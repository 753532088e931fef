"""Process bring-up and the global 'lists' mesh on torch.distributed.

Port of the JAX package's ``parallel/multihost.py``. One process per rank,
one device per process, the standard torch.distributed model:

    from vector_db_id_compression_tpu_torch.parallel import multihost
    multihost.initialize()                  # no-op for a single process
    mesh = multihost.global_lists_mesh()    # every rank of the group
    ...build ShardedIVF(mesh, index, ...) exactly as on one rank...

``initialize`` reads torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) where the JAX package reads
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.
Its default backend is NCCL for ranks on cards of their own and gloo for
``device="cpu"`` and for ranks that share a card (more ranks than cards,
``mesh.rank_device``), which NCCL refuses; an explicit ``backend=`` wins.

A rank owns the contiguous rows [rank * B_loc, (rank + 1) * B_loc) of a
lists-sharded array, B_loc = rows / N; ``ShardedIVF`` builds only those
(``process_shard_bounds``).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE
from .mesh import ListsMesh, make_lists_mesh, rank_device

# how long a collective (and the bring-up) waits for the other ranks
DEFAULT_TIMEOUT = timedelta(minutes=10)


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device=DEFAULT_DEVICE, timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Bring up the default process group when launched as several ranks.

    Arguments default from torchrun's variables: ``init_method`` from
    ``MASTER_ADDR``/``MASTER_PORT`` (``tcp://addr:port``), ``world_size`` from
    ``WORLD_SIZE`` (1), ``rank`` from ``RANK`` (0). With one process and no
    address configured this is a no-op, so the same script runs unchanged on
    one card and on many. ``device`` is the rank's (``mesh.rank_device``):
    NCCL for a card of its own, gloo for the CPU and for a world of more
    ranks than the host has cards, unless ``backend`` says otherwise."""
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world_size = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(env.get("RANK", "0"))
    if init_method is None:
        if world_size > 1:
            raise ValueError(f"a world of {world_size} ranks needs an init_method or "
                             "MASTER_ADDR and MASTER_PORT")
        return  # single process: nothing to initialize
    dev = rank_device(device)
    if backend is None:
        shared = dev.type == "cuda" and world_size > torch.cuda.device_count()
        backend = "gloo" if dev.type == "cpu" or shared else "nccl"
    kwargs = {}
    if backend == "nccl":
        # NCCL binds the group to the rank's card; collectives that allocate
        # their own tensors (broadcast_object_list) take the current device
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout, **kwargs)


def global_lists_mesh(n_devices: Optional[int] = None, device=DEFAULT_DEVICE) -> ListsMesh:
    """The 1-D 'lists' mesh over every rank of the group (``make_lists_mesh``)."""
    return make_lists_mesh(n_devices, device)


def addressable_row_bounds(mesh: ListsMesh, n_rows: int) -> tuple[int, int]:
    """[lo, hi) rows of a lists-sharded [n_rows, ...] array owned by this
    rank (n_rows a multiple of the mesh size). This is the canonical
    helper: ``ShardedIVF``'s constructor uses it."""
    return mesh.rows(n_rows)


def process_shard_bounds(n_rows: int, mesh: Optional[ListsMesh] = None) -> tuple[int, int]:
    """[lo, hi) slice of a lists-sharded global array that this rank must
    materialize. With a mesh, exact; without, the uniform contiguous layout
    over the default group (the last rank takes the remainder; everything
    without a group)."""
    if mesh is not None:
        return addressable_row_bounds(mesh, n_rows)
    if not (dist.is_available() and dist.is_initialized()):
        return 0, n_rows
    n, p = dist.get_world_size(), dist.get_rank()
    per = n_rows // n
    return p * per, (p + 1) * per if p + 1 < n else n_rows


def host_local_slice(arr: np.ndarray, mesh: Optional[ListsMesh] = None) -> np.ndarray:
    """The rows of a global lists-sharded host array this rank holds."""
    lo, hi = process_shard_bounds(arr.shape[0], mesh)
    return arr[lo:hi]

"""Joining processes (mirrors ``dmme_tpu/parallel/distributed.py``).

JAX drives every local device from one process and joins hosts with
``jax.distributed.initialize``; the port runs one process a device, joined
into a ``torch.distributed`` process group. :func:`initialize` makes that
group from its arguments or from the launcher's environment
(``python -m torch.distributed.run``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), as
JAX discovers a pod. The backend follows a fixed rule, printed on rank 0:
NCCL when each local rank has a card of its own, gloo when ranks share a
card or run on the CPU. A failing ``init_process_group`` raises; nothing
falls back.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dmme_tpu_torch.utils.device import resolve_device

#: how long a collective waits for a lost peer before the run fails
TIMEOUT = datetime.timedelta(minutes=30)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_world_size(default: int = 1) -> int:
    """The ranks on this host: the launcher's ``LOCAL_WORLD_SIZE``, else ``default``."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", default))


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """NCCL when each of the ``local_ranks`` ranks on this host has a card of
    its own, gloo when they share one or run on the CPU."""
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join this process to the group: ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id``, each taken from the launcher's
    environment where None. Without a launcher and without arguments the
    group is a world of 1 over an in-memory store. Returns the rank's device:
    ``device`` if given (``"cpu"``), else ``cuda:(LOCAL_RANK mod cards)``."""
    world = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None else num_processes
    rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    kwargs = dict(world_size=world, rank=rank)
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        kwargs = dict(init_method="env://")
    elif world == 1:
        kwargs["store"] = dist.HashStore()  # a world of 1 needs no rendezvous
    else:
        raise ValueError(f"a world of {world} processes needs a coordinator address "
                         "(or a launcher's MASTER_ADDR and MASTER_PORT)")
    device = resolve_device(device)
    backend = choose_backend(device, local_world_size(world))
    if backend == "nccl" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, timeout=timeout, **kwargs)
    if dist.get_rank() == 0:
        print(f"[initialize] backend {backend}, world {dist.get_world_size()}, device {device}",
              flush=True)
    return device


def shutdown() -> None:
    """Destroy the process group (and every group made from it), if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The process group's size; before one exists, the launcher's ``WORLD_SIZE``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def place(batch, device: torch.device):
    """A numpy batch (or tuple of them) as tensors on ``device``; through
    pinned memory on a CUDA device, so the copy does not wait for the
    kernels already queued."""
    if isinstance(batch, tuple):
        return tuple(place(b, device) for b in batch)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def global_batch(local_batch, mesh, chunked: bool = False, global_size: Optional[int] = None):
    """This rank's slice of a global batch as tensors on its device. Every
    rank passes its ``global_size / batch ranks`` rows (see
    ``DataModule.train_iter(process_index=..., process_count=...)``);
    ``chunked`` marks (steps, batch, …) inputs, whose second axis is the
    batch. With ``global_size`` the slice's size is checked against it."""
    axis = 1 if chunked else 0
    leaves = local_batch if isinstance(local_batch, tuple) else (local_batch,)
    sizes = {int(np.shape(x)[axis]) for x in leaves}
    if len(sizes) != 1:
        raise ValueError(f"the leaves of a batch disagree on its size: {sorted(sizes)}")
    if global_size is not None:
        ranks = mesh.batch_ranks
        if global_size % ranks or sizes != {global_size // ranks}:
            raise ValueError(f"a rank's slice of the global batch {global_size} over {ranks} "
                             f"batch ranks must hold {global_size / ranks:g} rows, "
                             f"got {sizes.pop()}")
    return place(local_batch, mesh.device)

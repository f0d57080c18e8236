"""Multi-process bootstrap: one process per GPU joined by torch.distributed.

The counterpart of the JAX package's ``core/jax_setup.py::
maybe_initialize_distributed``, read from the same three variables:

  OVERLAPNET_COORDINATOR   host:port of process 0 (its presence gates the
                           start), or ``auto`` to take the variables a
                           launcher such as torchrun sets (``env://``:
                           MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
  OVERLAPNET_NUM_PROCESSES total process count
  OVERLAPNET_PROCESS_ID    this process's rank

Collectives on CUDA tensors go through NCCL and those on CPU tensors through
gloo. Nothing falls back: a CUDA collective whose NCCL communicator cannot
start raises. Every collective has a deadline (``COLLECTIVE_TIMEOUT_S``), so a
rank whose peer died fails instead of waiting for ever.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from overlapnet_torch.core.device import resolve_device

COLLECTIVE_TIMEOUT_S = 600.0


def collective_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Join the process group the ``OVERLAPNET_*`` variables describe; a
    no-op without them. ``backend`` defaults to NCCL for CUDA tensors and
    gloo for CPU tensors (gloo alone on a machine without a card). Returns
    True when this process is part of a process group."""
    coord = os.environ.get("OVERLAPNET_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    if coord == "auto":
        dist.init_process_group(backend, init_method="env://", timeout=collective_timeout())
    else:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{coord}",
            world_size=int(os.environ["OVERLAPNET_NUM_PROCESSES"]),
            rank=int(os.environ["OVERLAPNET_PROCESS_ID"]),
            timeout=collective_timeout(),
        )
    return True


def world() -> tuple[int, int]:
    """(this process's rank, the world size); (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """The card index of this process on its host: ``LOCAL_RANK`` where a
    launcher sets it, else the rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return world()[0]


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``cuda`` (the default) becomes
    ``cuda:<local rank>``; an explicit index or ``cpu`` is kept. Raises when
    the local rank has no card of its own: ranks are never folded onto fewer
    cards unless the caller names the device."""
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        index, count = local_rank(), torch.cuda.device_count()
        if index >= count:
            raise RuntimeError(
                f"local rank {index} has no card of its own ({count} visible): "
                "NCCL needs one card per rank; name the device to share one"
            )
        device = torch.device("cuda", index)
    return device

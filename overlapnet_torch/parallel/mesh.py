"""Device mesh and sharding helpers over torch.distributed.

The counterpart of the JAX package's ``parallel/mesh.py``, with its public
names. PyTorch's idiom is one process per GPU, so a JAX ``Mesh`` of D
devices in one process becomes a :class:`Mesh` of D ranks: the process group,
this process's rank and the world size, the rank's device and the axis name
``"data"``. An array sharded on ``P("data")`` is the rank's contiguous block
of the leading dimension, as ``NamedSharding`` lays it out; a replicated
array is the same tensor on every rank; the psums XLA inserts are the
explicit collectives :func:`all_reduce_sum` and :func:`all_gather`.

A mesh of one rank is legal everywhere and computes what no mesh computes.
Without a process group (one process) its collectives are no calls at all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from overlapnet_torch.core.device import resolve_device
from overlapnet_torch.core.distributed import collective_timeout, rank_device, world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the process group along one axis.

    ``group`` is None in one process without torch.distributed. ``rank`` is
    this process's rank in the mesh, -1 for a process outside it."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_names: tuple[str, ...] = ("data",)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def check_member(self) -> None:
        if not self.member:
            raise ValueError(f"this process is outside the mesh of {self.size} ranks")


def make_mesh(
    n_devices: int | None = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all of them by
    default); further axis names have size 1. With a process group every
    rank calls it with the same ``n_devices``, and a rank past the first n
    gets a mesh it is not a member of. ``device`` is the rank's device
    (``cuda:<local rank>`` by default). A request for more ranks than the
    world holds raises."""
    rank, size = world()
    n = size if n_devices is None else int(n_devices)
    if not 1 <= n <= size:
        raise ValueError(f"a mesh of {n} ranks in a world of {size}")
    device = rank_device(device)
    group = None
    if dist.is_initialized():
        group = (dist.group.WORLD if n == size
                 else dist.new_group(list(range(n)), timeout=collective_timeout()))
    if rank >= n:
        return Mesh(None, -1, n, device, tuple(axis_names))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, rank, n, device, tuple(axis_names))


def device_of(device, mesh: Mesh | None) -> torch.device:
    """Where a constructor given ``device`` and ``mesh`` computes: ``device``
    ("cuda" when None) without a mesh, else the mesh's device (naming
    another raises, and so does a mesh this process is outside of)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    mesh.check_member()
    if device is not None and rank_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """SUM of ``x`` over the mesh's ranks, in place; returns ``x``. On the
    card it is enqueued on the stream: the host does not wait."""
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x`` in rank order, on every rank. A SUM
    all-reduce into a zero-filled buffer where each rank writes only its own
    slot: adding zeros is exact, every rank gets the same bits, and the same
    call runs on NCCL and on gloo."""
    buf = x.new_zeros((mesh.size, *x.shape))
    buf[mesh.rank] = x
    return all_reduce_sum(mesh, buf)


def barrier(mesh: Mesh | None) -> None:
    """Block until every rank of the mesh arrives (with a deadline)."""
    if mesh is not None and mesh.group is not None:
        all_reduce_sum(mesh, torch.zeros(1, device=mesh.device)).cpu()


def is_writer(mesh: Mesh | None) -> bool:
    """Whether this process writes the files of a run: rank 0, or the one
    process when there is no mesh."""
    return mesh is None or mesh.rank == 0


def save_npz(mesh: Mesh | None, path: str, **arrays) -> None:
    """``np.savez_compressed`` by the writer only; on a mesh every rank
    returns once the file is complete."""
    if is_writer(mesh):
        np.savez_compressed(path, **arrays)
    barrier(mesh)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: dimension ``dim`` split into contiguous
    rank blocks, or replicated (``dim`` None)."""

    mesh: Mesh
    dim: int | None

    def put(self, x) -> torch.Tensor:
        """This rank's part of the GLOBAL host array ``x`` (identical on
        every rank), on the rank's device."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if self.dim is not None:
            d, n = self.mesh.size, x.shape[self.dim]
            if n % d:
                raise ValueError(f"dimension {self.dim} of length {n} does not split over {d} ranks")
            x = x.narrow(self.dim, self.mesh.rank * (n // d), n // d)
        return x.to(self.mesh.device, non_blocking=True)


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dimension over ``axis``."""
    _check_axis(mesh, axis)
    return Sharding(mesh, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def put_replicated(mesh: Mesh, x) -> torch.Tensor:
    """One host array on every rank's device (every rank must pass the same
    value)."""
    return replicated(mesh).put(x)


def put_sharded(mesh: Mesh, x, axis: str = "data") -> torch.Tensor:
    """This rank's block of the leading dim of the GLOBAL array ``x``,
    identical on every rank (the multi-process input pattern)."""
    return batch_sharding(mesh, axis).put(x)


def put_sharded_dim(mesh: Mesh, x, dim: int = 0, axis: str = "data") -> torch.Tensor:
    """This rank's block of dimension ``dim`` of the global ``x``; dim=1
    shards the batch of K-stacked (K, B, ...) batches."""
    _check_axis(mesh, axis)
    return Sharding(mesh, dim).put(x)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any], axis: str = "data") -> dict:
    """This rank's block of every array of a global batch dict."""
    return {k: put_sharded(mesh, v, axis) for k, v in batch.items()}


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading dim up to a multiple (for even sharding); returns the
    padded array and the original length."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = multiple - rem
    pad_block = np.repeat(batch[-1:], pad, axis=0)
    return np.concatenate([batch, pad_block], axis=0), n


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis_names[0]:
        raise ValueError(f"axis {axis!r}: the mesh shards over {mesh.axis_names[0]!r}")

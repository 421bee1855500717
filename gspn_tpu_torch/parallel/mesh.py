"""The process-group counterparts of ``gspn_tpu/parallel/mesh.py``: the
data-parallel group (``make_mesh``, ``shard_batch``, ``replicate``) and the
point-sharded grid of rows (``make_mesh_2d``).

JAX's ``--dp`` is one process over every local device. Here each rank is a
process, started by ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) or by a caller that
initialized ``torch.distributed`` itself; without either, the world is
this one rank. On CUDA each rank takes a card of its own (``LOCAL_RANK``)
and the backend is NCCL when the host has a card for every local rank;
otherwise the ranks share the given card and the backend is gloo, which
takes CUDA tensors too. On the CPU the backend is gloo.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ranks a batch is split over: the process ``group``
    (``dist.group.WORLD``), this process's ``rank`` and the group's ``size``,
    the ``device`` this rank computes on, and whether :func:`make_mesh`
    initialized the default group (and :meth:`close` tears it down)."""

    group: object
    rank: int
    size: int
    device: torch.device
    owns_group: bool = False

    def close(self) -> None:
        """Tear the default group down if :func:`make_mesh` set it up."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _rank_device(device: torch.device, local_rank: int, local_size: int) -> torch.device:
    if device.type != "cuda":
        return device
    if torch.cuda.device_count() >= local_size:
        return torch.device("cuda", local_rank)
    return device if device.index is not None else torch.device("cuda", 0)


def make_mesh(device, n_ranks: int | None = None) -> DataMesh:
    """The data-parallel group over the default process group, initialized
    here from the environment when no caller did (a one-rank world without
    ``WORLD_SIZE``). ``n_ranks``: the size the caller expects (raises when
    the group has another). This rank's device: ``cuda:LOCAL_RANK`` when the
    host has a card for every local rank, else ``device``."""
    device = torch.device(device)
    owns = False
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
    else:
        size = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    if n_ranks is not None and n_ranks != size:
        raise ValueError(f"need {n_ranks} ranks, the process group has {size}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    rank_device = _rank_device(device, local_rank, local_size)
    if not dist.is_initialized():
        own_card = rank_device.type == "cuda" and torch.cuda.device_count() >= local_size
        backend = "nccl" if own_card else "gloo"
        if rank_device.type == "cuda":
            torch.cuda.set_device(rank_device)
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, rank=rank, world_size=size)
        elif size == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            raise RuntimeError(f"WORLD_SIZE={size} without MASTER_ADDR/MASTER_PORT: start "
                               "the ranks with torchrun or set the rendezvous address")
        owns = True
    return DataMesh(dist.group.WORLD, rank, size, rank_device, owns)


def shard_batch(mesh: DataMesh, batch: dict) -> dict:
    """This rank's rows of a full batch: the leading dim of every tensor
    split into ``mesh.size`` equal parts (a list, ``scene_ids``, too)."""
    out = {}
    for k, v in batch.items():
        b = len(v)
        if b % mesh.size:
            raise ValueError(f"batch of {b} ({k!r}) does not split over {mesh.size} ranks")
        per = b // mesh.size
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per]
    return out


def replicate(mesh: DataMesh, module: torch.nn.Module) -> torch.nn.Module:
    """Make every rank's parameters and buffers rank 0's (a broadcast)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


@dataclasses.dataclass(frozen=True)
class PointMesh:
    """The point-sharded ranks as a grid of ``n_data`` rows of ``n_space``
    consecutive ranks (JAX's ``reshape(n_data, n_space)``): scenes split
    over the rows, each scene's seeds, points and RoIs over the ranks of a
    row. ``space`` is this rank's row and ``data`` its column, as process
    groups (None where the group would be this rank alone); ``world`` holds
    every rank, the reduction set of the training statistics and
    gradients. ``data_index`` and ``space_index`` are this rank's
    coordinates. A 1-D space mesh is ``n_data = 1``."""

    world: object
    space: object | None
    data: object | None
    n_data: int
    n_space: int
    data_index: int
    space_index: int
    device: torch.device
    owns_group: bool = False

    @property
    def size(self) -> int:
        return self.n_data * self.n_space

    @property
    def rank(self) -> int:
        return self.data_index * self.n_space + self.space_index

    @property
    def group(self):
        """The world group (``replicate`` broadcasts over it)."""
        return self.world

    def close(self) -> None:
        """Tear the default group down if :func:`make_mesh_2d` set it up."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh_2d(n_data: int, n_space: int | None = None, device="cuda") -> PointMesh:
    """The hybrid mesh of ``gspn_tpu/parallel/mesh.py``'s ``make_mesh_2d``
    over the default process group (initialized as :func:`make_mesh` does
    when no caller did): ``n_data`` rows of ``n_space`` ranks, ``n_space``
    by default every rank of a row. Every rank creates every row's and
    every column's group, in the same order, as ``dist.new_group``
    requires."""
    base = make_mesh(device)
    size = base.size
    if n_space is None:
        if size % n_data:
            base.close()
            raise ValueError(f"{size} devices not divisible into {n_data} data rows")
        n_space = size // n_data
    need = n_data * n_space
    if size != need:
        base.close()
        raise ValueError(f"need {need} devices ({n_data}x{n_space}), have {size}")
    grid = np.arange(need).reshape(n_data, n_space)

    def groups(lines) -> list:
        if len(lines) == 1:
            return [base.group]
        if lines.shape[1] == 1:
            return [None] * len(lines)
        return [dist.new_group(line.tolist()) for line in lines]

    rows, cols = groups(grid), groups(grid.T)
    d, s = divmod(base.rank, n_space)
    return PointMesh(base.group, rows[d], cols[s], n_data, n_space, d, s, base.device,
                     base.owns_group)

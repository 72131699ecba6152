# forge3d_tpu_torch/parallel/mesh.py
# The rank mesh of the sharded renders (forge3d_tpu/parallel/mesh.py): a
# torch.distributed process group in place of JAX's 1-D device mesh. A rank
# owns a contiguous band of a frame's pixel rows (the "tiles" axis), keeps
# the read-only tables whole, and meets the other ranks only in the
# collectives: NCCL's on the card, gloo's on the CPU. With no process group
# initialised the mesh is one rank, on which the collectives are identities.

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"


@dataclass(frozen=True)
class FrameMesh:
    """The ranks a frame's rows shard over: the process group (None: one
    rank and no group), this rank, the rank count and this rank's device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place (JAX's psum)."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' `t` side by side along `dim`, in rank order (each rank
        holds a band of the same size)."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: "cuda" is the card torchrun's LOCAL_RANK names
    (else rank modulo the cards), "cpu" the host."""
    from ..pt.terrain_ref import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def frame_mesh(devices: Optional[Sequence[int]] = None, *, device=None) -> FrameMesh:
    """The mesh of the default process group's ranks, or of this process
    alone when no group is initialised. `devices` (JAX's device list), if
    given, must be those ranks in order. `device`: "cuda" (the default; the
    rank's card) or "cpu"."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    rank, size = (dist.get_rank(), dist.get_world_size()) if group is not None else (0, 1)
    if devices is not None and [int(r) for r in devices] != list(range(size)):
        raise ValueError(f"the mesh is the process group's ranks {list(range(size))}; "
                         f"initialise a group of the ranks {list(devices)} to render on them")
    return FrameMesh(group, rank, size, _rank_device(device, rank))


@dataclass(frozen=True)
class TileSharding:
    """Dim `axis` of an ndim-array sharded over the mesh's ranks, the rest
    whole: each rank owns an equal contiguous band of that dim."""

    mesh: FrameMesh
    ndim: int = 2
    axis: int = 0

    def band(self, n: int) -> slice:
        """The indices of an axis of n that this rank owns."""
        if n % self.mesh.size:
            raise ValueError(f"height {n} must divide across {self.mesh.size} devices")
        per = n // self.mesh.size
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def shard(self, a) -> torch.Tensor:
        """This rank's band of `a`, on its device."""
        t = torch.as_tensor(a)
        if t.dim() != self.ndim:
            raise ValueError(f"expected a {self.ndim}-d array, got {t.dim()}-d")
        b = self.band(t.shape[self.axis])
        return t.narrow(self.axis, b.start, b.stop - b.start).to(self.mesh.device)


@dataclass(frozen=True)
class ReplicatedSharding:
    """An array whole on every rank."""

    mesh: FrameMesh

    def shard(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.mesh.device)


def tile_sharding(mesh: FrameMesh, ndim: int = 2, axis: int = 0) -> TileSharding:
    """Shard dim `axis` (pixel rows) over the ranks; the rest whole."""
    return TileSharding(mesh, ndim, axis)


def replicated_sharding(mesh: FrameMesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)

"""The process mesh — the port of ``parallel/mesh.py``.

The geometry is the reference's Horovod one: one process per device, the
world of ``torch.distributed`` as the data-parallel communicator.  A
:class:`Mesh` is a logical description of the ranks: its ``shape`` names
the size of every axis of :data:`AXIS_ORDER`, ``size`` is the world, and
``rank`` and ``group`` say who this process is and which process group
its collectives run over.  :class:`MeshSpec` infers the axis sizes exactly
as the reference does (``MeshSpec()`` on N processes is pure data
parallelism over N).

Only the data axis is taken: ``fsdp``, ``tensor``, ``seq``, ``pipe`` and
``expert`` greater than 1 raise in :func:`create_mesh`, naming the ROADMAP
item that brings them (FSDP: A5's follow-up; tensor: A6; seq and pipe:
A7; expert: A5's MoE follow-up).  Multi-slice meshes (the reference's
``num_slices`` and ``_slice_groups``) wait with FSDP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# Outermost to innermost, as the reference orders its axes.
AXIS_ORDER: Tuple[str, ...] = ("pipe", "data", "fsdp", "expert", "seq", "tensor")

DATA_AXES: Tuple[str, ...] = ("data", "fsdp")  # batch is sharded over both

#: where each axis but ``data`` comes in the port
_NOT_YET = {
    "fsdp": "FSDP parameter sharding (ROADMAP A5 follow-up)",
    "tensor": "tensor parallelism (ROADMAP A6)",
    "seq": "sequence parallelism (ROADMAP A7)",
    "pipe": "pipeline parallelism (ROADMAP A7)",
    "expert": "expert parallelism (ROADMAP A5's MoE follow-up)",
}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh geometry.  Any axis left at None is inferred.

    At most one axis may be None; it absorbs ``device_count // product(rest)``.
    With every axis None-free the product must equal the device count.
    ``MeshSpec()`` is full data parallelism.
    """

    pipe: Optional[int] = 1
    data: Optional[int] = None
    fsdp: Optional[int] = 1
    expert: Optional[int] = 1
    seq: Optional[int] = 1
    tensor: Optional[int] = 1

    def sizes(self, device_count: int) -> Tuple[int, ...]:
        raw = [getattr(self, name) for name in AXIS_ORDER]
        free = [i for i, s in enumerate(raw) if s is None]
        if len(free) > 1:
            raise ValueError(f"At most one mesh axis may be None, got {free}")
        known = math.prod(s for s in raw if s is not None)
        if free:
            if device_count % known != 0:
                raise ValueError(
                    f"{device_count} devices not divisible by fixed axes product {known}"
                )
            raw[free[0]] = device_count // known
        elif known != device_count:
            raise ValueError(
                f"Mesh axes product {known} != device count {device_count}"
            )
        return tuple(raw)  # type: ignore[return-value]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks as a mesh: ``shape`` (axis -> size), ``size`` (the
    world), this process's ``rank`` and the ``group`` its collectives run
    over (None without a process group)."""

    shape: Dict[str, int]
    size: int
    rank: int = 0
    group: Any = None


def _world(group) -> Tuple[int, int]:
    """(world size, rank) of ``group``, (1, 0) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def create_mesh(spec: Optional[MeshSpec] = None, *, group=None) -> Mesh:
    """The mesh of ``spec`` over the processes of ``group`` (the default
    group; one process and no group when ``torch.distributed`` is not
    initialised) — the reference's ``hvd.init()`` world.  Axes other than
    ``data`` greater than 1 raise (module docstring)."""
    spec = spec or MeshSpec()
    world, rank = _world(group)
    if group is None and world > 1:
        group = dist.group.WORLD
    sizes = dict(zip(AXIS_ORDER, spec.sizes(world)))
    for axis, where in _NOT_YET.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"create_mesh: {axis}={sizes[axis]} is {where}; the port's "
                "mesh takes the data axis only"
            )
    return Mesh(shape=sizes, size=world, rank=rank, group=group)


def world_size(mesh: Optional[Mesh] = None) -> int:
    """Total device count — the reference's ``hvd.size()``."""
    if mesh is None:
        return _world(None)[0]
    return mesh.size


def data_parallel_size(mesh: Mesh) -> int:
    """Number of data-parallel replicas (batch shards): data x fsdp."""
    return int(math.prod(mesh.shape[a] for a in DATA_AXES))


def local_device_count() -> int:
    """Devices attached to this host — the reference's GPUs a node (one
    for a host without a card: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1

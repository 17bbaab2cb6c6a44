"""The process mesh — the port of ``parallel/mesh.py``.

The geometry is the reference's Horovod one: one process per device, the
world of ``torch.distributed`` as the data-parallel communicator.  A
:class:`Mesh` is a logical description of the ranks: its ``shape`` names
the size of every axis of :data:`AXIS_ORDER`, ``size`` is the world, and
``rank`` and ``group`` say who this process is and which process group
its data-parallel collectives run over.  :class:`MeshSpec` infers the axis
sizes exactly as the reference does (``MeshSpec()`` on N processes is pure
data parallelism over N).

Ranks lie on the mesh row-major in :data:`AXIS_ORDER`, as the reference
lays devices out, so ``tensor`` (the innermost axis) neighbours are
consecutive ranks.  ``groups`` holds one process group per axis of more
than one rank: the group of the ranks that differ from this one along
that axis alone (the reference's named-axis collectives, ``psum(x,
"tensor")``).  :meth:`Mesh.axis_index` is this rank's coordinate.

The data and tensor axes are taken.  ``fsdp``, ``seq``, ``pipe`` and
``expert`` greater than 1 raise in :func:`create_mesh`, naming the ROADMAP
item that brings them (FSDP: A5's follow-up; seq and pipe: A7; expert:
A5's MoE follow-up).  A tensor axis serves (``serve.engine.
tensor_parallel_engine``); the trainer refuses it (:func:`require_data_only`,
A5's FSDP / ``param_shardings`` item).  Multi-slice meshes (the reference's
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

#: where each axis but ``data`` and ``tensor`` comes in the port
_NOT_YET = {
    "fsdp": "FSDP parameter sharding (ROADMAP A5 follow-up)",
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
    world), this process's ``rank``, the ``group`` its data-parallel
    collectives run over (None without a process group) and ``groups``,
    one process group per axis of more than one rank (module docstring)."""

    shape: Dict[str, int]
    size: int
    rank: int = 0
    group: Any = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (row-major ranks)."""
        inner = math.prod(self.shape[a] for a in
                          AXIS_ORDER[AXIS_ORDER.index(axis) + 1:])
        return (self.rank // inner) % self.shape[axis]

    def axis_group(self, axis: str):
        """The process group of ``axis``: None for an axis of one rank
        (no collective runs over it)."""
        return self.groups.get(axis)


def _world(group) -> Tuple[int, int]:
    """(world size, rank) of ``group``, (1, 0) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _axis_groups(sizes: Dict[str, int], world: int, rank: int, group) -> Dict[str, Any]:
    """One process group per axis of more than one rank: the group of
    this rank's neighbours along it.  Every rank calls ``new_group`` for
    every group, in the same order, as ``torch.distributed`` requires; an
    axis that spans the whole world takes ``group`` itself."""
    groups: Dict[str, Any] = {}
    for axis in AXIS_ORDER:
        n = sizes[axis]
        if n == 1:
            continue
        if n == world:
            groups[axis] = group
            continue
        inner = math.prod(sizes[a] for a in AXIS_ORDER[AXIS_ORDER.index(axis) + 1:])
        for base in range(world):
            if (base // inner) % n:
                continue  # not the first rank of its group along the axis
            members = [base + i * inner for i in range(n)]
            made = dist.new_group(
                members if group is dist.group.WORLD
                else [dist.get_global_rank(group, m) for m in members])
            if rank in members:
                groups[axis] = made
    return groups


def create_mesh(spec: Optional[MeshSpec] = None, *, group=None) -> Mesh:
    """The mesh of ``spec`` over the processes of ``group`` (the default
    group; one process and no group when ``torch.distributed`` is not
    initialised) — the reference's ``hvd.init()`` world.  Axes other than
    ``data`` and ``tensor`` greater than 1 raise (module docstring)."""
    spec = spec or MeshSpec()
    world, rank = _world(group)
    if group is None and world > 1:
        group = dist.group.WORLD
    sizes = dict(zip(AXIS_ORDER, spec.sizes(world)))
    for axis, where in _NOT_YET.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"create_mesh: {axis}={sizes[axis]} is {where}; the port's "
                "mesh takes the data and tensor axes only"
            )
    return Mesh(shape=sizes, size=world, rank=rank, group=group,
                groups=_axis_groups(sizes, world, rank, group))


def require_data_only(mesh: Optional[Mesh], what: str) -> None:
    """Refuse a mesh with a model axis above 1 where only data
    parallelism is ported (``what`` names the caller): tensor-parallel
    training is ROADMAP A5's FSDP / ``param_shardings`` item."""
    if mesh is None:
        return
    model = {a: n for a, n in mesh.shape.items() if a not in DATA_AXES and n > 1}
    if model:
        raise NotImplementedError(
            f"{what}: a mesh with {model} shards the model; tensor-parallel "
            "training is ROADMAP A5's FSDP / param_shardings item, and the "
            "port trains data-parallel only"
        )


def world_size(mesh: Optional[Mesh] = None) -> int:
    """Total device count — the reference's ``hvd.size()``."""
    if mesh is None:
        return _world(None)[0]
    return mesh.size


def tensor_parallel_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``tensor`` axis (1 for no mesh — unsharded serving)."""
    return int(mesh.shape["tensor"]) if mesh is not None else 1


def data_parallel_size(mesh: Mesh) -> int:
    """Number of data-parallel replicas (batch shards): data x fsdp."""
    return int(math.prod(mesh.shape[a] for a in DATA_AXES))


def local_device_count() -> int:
    """Devices attached to this host — the reference's GPUs a node (one
    for a host without a card: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1

"""The process mesh — the port of ``parallel/mesh.py``.

The geometry is the reference's Horovod one: one process per device, the
world of ``torch.distributed`` as the data-parallel communicator.  A
:class:`Mesh` is a logical description of the ranks: its ``shape`` names
the size of every axis of :data:`AXIS_ORDER`, ``size`` is the world, and
``rank`` and ``group`` say who this process is and which process group
its world collectives run over (barriers, agreement, checkpoints).
:class:`MeshSpec` infers the axis sizes exactly as the reference does
(``MeshSpec()`` on N processes is pure data parallelism over N).

Ranks lie on the mesh row-major in :data:`AXIS_ORDER`, as the reference
lays devices out, so ``tensor`` (the innermost axis) neighbours are
consecutive ranks.  ``groups`` holds one process group per axis of more
than one rank: the group of the ranks that differ from this one along
that axis alone (the reference's named-axis collectives, ``psum(x,
"tensor")``).  :meth:`Mesh.axis_index` is this rank's coordinate.

``data_group`` is the group of the ranks that share every coordinate
but the data axes' (``data`` and ``fsdp`` jointly): the ranks that hold
different rows of the global batch and the same slice of the model.
The ranks along ``tensor`` and ``expert`` share a batch (the reference
shards the batch over ``data x fsdp`` only).
Every data-parallel reduction (the gradient mean, averaged metrics, the
eval reduction, global-batch BatchNorm) runs over it, never over the
world: on a ``data=2 x tensor=2`` mesh a mean over the world would
average different tensor shards together.  :meth:`Mesh.data_index` is
this rank's coordinate over the data axes (its batch shard).

The data, fsdp, expert and tensor axes are taken: a tensor axis serves
(``serve.engine.tensor_parallel_engine``) and trains (Megatron), fsdp
trains (ZeRO-3), expert splits a mixture of experts' expert weights
(``models.moe``).  ``seq`` and ``pipe`` greater than 1 raise in
:func:`create_mesh`, naming the ROADMAP item that brings them (A7d), and
so does a model that meets them in :func:`require_ported`.  Multi-slice meshes (the reference's
``num_slices`` and ``_slice_groups``) are A5.3.
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

#: where each axis the port does not take yet comes in
_NOT_YET = {
    "seq": "sequence parallelism (ROADMAP A7d)",
    "pipe": "pipeline parallelism (ROADMAP A7d)",
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
    """The ranks as a mesh: ``shape`` (axis -> size; an axis left out is
    1), ``size`` (the world), this process's ``rank``, the world ``group``
    (None without a process group), ``groups``, one process group per
    axis of more than one rank, and ``data_group``, the data axes' group
    (None where it is one rank; module docstring)."""

    shape: Dict[str, int]
    size: int
    rank: int = 0
    group: Any = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_group: Any = None

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (row-major ranks)."""
        return (self.rank // _inner_size(self.shape, axis)) % self.shape.get(axis, 1)

    def data_index(self) -> int:
        """This rank's batch shard: its row-major coordinate over the data
        axes jointly (``data`` outer, ``fsdp`` inner).  The ranks outside the data
        axes (``tensor``) that share it hold the same rows."""
        return (self.rank // _inner_size(self.shape, "fsdp")) % data_parallel_size(self)

    def axis_group(self, axis: str):
        """The process group of ``axis``: None for an axis of one rank
        (no collective runs over it)."""
        return self.groups.get(axis)


def _world(group) -> Tuple[int, int]:
    """(world size, rank) of ``group``, (1, 0) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _inner_size(sizes: Dict[str, int], axis: str) -> int:
    """The ranks between two neighbours along ``axis`` (row-major)."""
    return math.prod(sizes.get(a, 1) for a in AXIS_ORDER[AXIS_ORDER.index(axis) + 1:])


def _rank_group(n: int, inner: int, world: int, rank: int, group):
    """The group of ``n`` ranks ``inner`` apart that holds ``rank``.  Every
    rank calls ``new_group`` for every such group, in the same order, as
    ``torch.distributed`` requires; a group of the whole world is
    ``group`` itself."""
    if n == world:
        return group
    mine = None
    for base in range(world):
        if (base // inner) % n:
            continue  # not the first rank of its group
        members = [base + i * inner for i in range(n)]
        made = dist.new_group(
            members if group is dist.group.WORLD
            else [dist.get_global_rank(group, m) for m in members])
        if rank in members:
            mine = made
    return mine


def _axis_groups(sizes: Dict[str, int], world: int, rank: int, group) -> Dict[str, Any]:
    """One process group per axis of more than one rank: the group of
    this rank's neighbours along it."""
    return {axis: _rank_group(sizes[axis], _inner_size(sizes, axis), world, rank, group)
            for axis in AXIS_ORDER if sizes[axis] > 1}


def _data_group(sizes: Dict[str, int], world: int, rank: int, group):
    """The group of the ranks that share this rank's coordinates off the
    data axes (module docstring); None where that is one rank.  ``data``
    and ``fsdp`` neighbour each other in ``AXIS_ORDER``, so these ranks
    lie as one axis's do."""
    n = math.prod(sizes[a] for a in DATA_AXES)
    if n == 1:
        return None
    return _rank_group(n, _inner_size(sizes, "fsdp"), world, rank, group)


def create_mesh(spec: Optional[MeshSpec] = None, *, group=None) -> Mesh:
    """The mesh of ``spec`` over the processes of ``group`` (the default
    group; one process and no group when ``torch.distributed`` is not
    initialised) — the reference's ``hvd.init()`` world.  ``seq`` and
    ``pipe`` greater than 1 raise (module docstring)."""
    spec = spec or MeshSpec()
    world, rank = _world(group)
    if group is None and world > 1:
        group = dist.group.WORLD
    sizes = dict(zip(AXIS_ORDER, spec.sizes(world)))
    for axis, where in _NOT_YET.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"create_mesh: {axis}={sizes[axis]} is {where}; the port's "
                "mesh takes the data, fsdp, expert and tensor axes only"
            )
    groups = _axis_groups(sizes, world, rank, group)
    return Mesh(shape=sizes, size=world, rank=rank, group=group, groups=groups,
                data_group=_data_group(sizes, world, rank, group))


def require_ported(mesh: Optional[Mesh], what: str) -> None:
    """Refuse a mesh with an axis the port does not take yet (``seq``,
    ``pipe`` above 1; ``what`` names the caller).  A mesh
    built by :func:`create_mesh` never has one; a hand-made one may."""
    if mesh is None:
        return
    for axis, where in _NOT_YET.items():
        if mesh.shape.get(axis, 1) > 1:
            raise NotImplementedError(
                f"{what}: {axis}={mesh.shape[axis]} is {where}; the port "
                "trains over the data, fsdp, expert and tensor axes only")


def world_size(mesh: Optional[Mesh] = None) -> int:
    """Total device count — the reference's ``hvd.size()``."""
    if mesh is None:
        return _world(None)[0]
    return mesh.size


def tensor_parallel_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``tensor`` axis (1 for no mesh — unsharded serving)."""
    return int(mesh.shape.get("tensor", 1)) if mesh is not None else 1


def data_parallel_size(mesh: Mesh) -> int:
    """Number of data-parallel replicas (batch shards): data x fsdp, the
    world over the other axes (an axis a hand-made mesh leaves out is
    1)."""
    return mesh.size // math.prod(n for a, n in mesh.shape.items()
                                  if a not in DATA_AXES)


def local_device_count() -> int:
    """Devices attached to this host — the reference's GPUs a node (one
    for a host without a card: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1

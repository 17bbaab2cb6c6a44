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
so does a model that meets them in :func:`require_ported`.

Multi-slice meshes (``create_mesh(..., num_slices=)``, the reference's
DCN meshes): the ``data`` axis spans the slices, its size a multiple of
``num_slices``, and ``fsdp``, ``expert`` and ``tensor`` stay inside one
slice, so the slice boundary is outermost on ``data``.  A slice is a
node: each rank reports the node it runs on as the launcher gives it
(torchrun's ``GROUP_RANK``), the ranks agree on the report in one
all-gather and are grouped by node (:func:`_slice_groups`, the
reference's ``Device.slice_index`` grouping); where no rank reports a
node the ranks split into contiguous equal slices, as the reference does
on CPU fakes, and a report that contradicts ``num_slices`` raises.  The
slices lie on the mesh one after the other, each in rank order, so
ranks whose nodes interleave sit at other mesh positions than their
rank: ``Mesh.order`` maps positions to ranks, every coordinate is a
position's and every group is built from positions.  A group along an
axis inside a slice lists its ranks in position order, as
``torch.distributed`` orders a group's ranks; a group along ``data``
may not, so a collective over it whose result depends on the order of
the ranks reads their positions (``models.moe``'s routing takes
``data_index``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    axis of more than one rank, ``data_group``, the data axes' group
    (None where it is one rank; module docstring), and ``order``, the
    rank at each mesh position (None: position == rank)."""

    shape: Dict[str, int]
    size: int
    rank: int = 0
    group: Any = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_group: Any = None
    order: Optional[Tuple[int, ...]] = None

    @property
    def position(self) -> int:
        """This rank's place on the mesh, row-major in ``AXIS_ORDER``."""
        return self.rank if self.order is None else self.order.index(self.rank)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (row-major positions)."""
        return (self.position // _inner_size(self.shape, axis)) % self.shape.get(axis, 1)

    def data_index(self) -> int:
        """This rank's batch shard: its row-major coordinate over the data
        axes jointly (``data`` outer, ``fsdp`` inner).  The ranks outside the data
        axes (``tensor``) that share it hold the same rows."""
        return (self.position // _inner_size(self.shape, "fsdp")) % data_parallel_size(self)

    def axis_group(self, axis: str):
        """The process group of ``axis``: None for an axis of one rank
        (no collective runs over it)."""
        return self.groups.get(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """The ranks of this rank's group along ``axis``, in the order of
        their coordinates; ``axis`` "data_group" gives the data axes'
        group's, in the order of their batch shards."""
        if axis == "data_group":
            n, inner = data_parallel_size(self), _inner_size(self.shape, "fsdp")
        else:
            n, inner = self.shape.get(axis, 1), _inner_size(self.shape, axis)
        first = self.position - (self.position // inner % n) * inner
        return [_rank_at(self.order, first + i * inner) for i in range(n)]


def _rank_at(order: Optional[Sequence[int]], position: int) -> int:
    return position if order is None else order[position]


def _world(group) -> Tuple[int, int]:
    """(world size, rank) of ``group``, (1, 0) without a process group."""
    if not dist.is_available() or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _inner_size(sizes: Dict[str, int], axis: str) -> int:
    """The ranks between two neighbours along ``axis`` (row-major)."""
    return math.prod(sizes.get(a, 1) for a in AXIS_ORDER[AXIS_ORDER.index(axis) + 1:])


def _rank_group(n: int, inner: int, world: int, rank: int, group, order=None):
    """The group of the ``n`` ranks ``inner`` mesh positions apart that
    holds ``rank`` (``order``: the rank at each position).  Every rank
    calls ``new_group`` for every such group, in the same order, as
    ``torch.distributed`` requires; a group of the whole world is
    ``group`` itself."""
    if n == world:
        return group
    mine = None
    for base in range(world):
        if (base // inner) % n:
            continue  # not the first position of its group
        members = [_rank_at(order, base + i * inner) for i in range(n)]
        made = dist.new_group(
            members if group is dist.group.WORLD
            else [dist.get_global_rank(group, m) for m in members])
        if rank in members:
            mine = made
    return mine


def _axis_groups(sizes: Dict[str, int], world: int, rank: int, group,
                 order=None) -> Dict[str, Any]:
    """One process group per axis of more than one rank: the group of
    this rank's neighbours along it."""
    return {axis: _rank_group(sizes[axis], _inner_size(sizes, axis), world, rank,
                              group, order)
            for axis in AXIS_ORDER if sizes[axis] > 1}


def _data_group(sizes: Dict[str, int], world: int, rank: int, group, order=None):
    """The group of the ranks that share this rank's coordinates off the
    data axes (module docstring); None where that is one rank.  ``data``
    and ``fsdp`` neighbour each other in ``AXIS_ORDER``, so these ranks
    lie as one axis's do."""
    n = math.prod(sizes[a] for a in DATA_AXES)
    if n == 1:
        return None
    return _rank_group(n, _inner_size(sizes, "fsdp"), world, rank, group, order)


def _node() -> Optional[int]:
    """The node this process runs on as its launcher reports it
    (torchrun's ``GROUP_RANK``), None where none does."""
    node = os.environ.get("GROUP_RANK", "").strip()
    return int(node) if node else None


def _slice_groups(nodes: Sequence[Optional[int]], num_slices: int) -> List[List[int]]:
    """The ranks grouped by slice (ref ``_slice_groups``, ranks for
    devices and a rank's node for ``Device.slice_index``): by node, the
    nodes in ascending order and each node's ranks in rank order, where
    every rank reports one; else contiguous equal splits.  A node count
    that contradicts ``num_slices``, or a report from some ranks only,
    raises: a contiguous fall-back would put the inner axes' collectives
    across nodes."""
    reported = [n for n in nodes if n is not None]
    if reported:
        if len(reported) != len(nodes):
            raise ValueError(
                f"{len(reported)} of {len(nodes)} ranks report a node (GROUP_RANK) "
                f"and the others do not; num_slices={num_slices} needs every "
                "rank's node or none")
        distinct = len(set(reported))
        if distinct != num_slices:
            raise ValueError(
                f"ranks report {distinct} node(s) (GROUP_RANK) but "
                f"num_slices={num_slices} was requested")
        groups: Dict[int, List[int]] = {}
        for rank, node in enumerate(nodes):
            groups.setdefault(node, []).append(rank)
        return [groups[n] for n in sorted(groups)]
    if len(nodes) % num_slices:
        raise ValueError(f"{len(nodes)} devices not divisible into {num_slices} slices")
    per = len(nodes) // num_slices
    return [list(range(i * per, (i + 1) * per)) for i in range(num_slices)]


def slice_order(spec: MeshSpec, nodes: Sequence[Optional[int]],
                num_slices: int) -> Optional[Tuple[int, ...]]:
    """The rank at each position of a ``num_slices`` mesh of ``spec`` over
    ranks whose nodes are ``nodes`` (module docstring; None where that is
    rank order): each slice's sub-mesh in rank order, the slices stacked
    along ``data``, as ref ``create_mesh`` stacks them.  The data axis
    must be a multiple of ``num_slices`` (the reference's error)."""
    world = len(nodes)
    data = dict(zip(AXIS_ORDER, spec.sizes(world)))["data"]
    if data % num_slices:
        raise ValueError(
            f"data axis {data} not divisible by num_slices {num_slices} — "
            "multi-slice runs scale data parallelism across DCN")
    sub = dataclasses.replace(spec, data=data // num_slices)
    order: List[int] = []
    for ranks in _slice_groups(nodes, num_slices):
        sub.sizes(len(ranks))  # a slice must hold the sub-mesh: the reference's error
        order.extend(ranks)
    return None if order == list(range(world)) else tuple(order)


def _nodes(world: int, group) -> List[Optional[int]]:
    """Every rank's :func:`_node`, agreed in one all-gather."""
    nodes: List[Optional[int]] = [_node()] * world
    if world > 1:
        dist.all_gather_object(nodes, _node(), group=group)
    return nodes


def create_mesh(spec: Optional[MeshSpec] = None, *, group=None,
                num_slices: int = 1) -> Mesh:
    """The mesh of ``spec`` over the processes of ``group`` (the default
    group; one process and no group when ``torch.distributed`` is not
    initialised) — the reference's ``hvd.init()`` world.  ``num_slices``
    > 1 builds a multi-slice mesh: the slice boundary outermost on
    ``data`` (module docstring).  ``seq`` and ``pipe`` greater than 1
    raise (module docstring)."""
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
    order = slice_order(spec, _nodes(world, group), num_slices) if num_slices > 1 else None
    groups = _axis_groups(sizes, world, rank, group, order)
    return Mesh(shape=sizes, size=world, rank=rank, group=group, groups=groups,
                data_group=_data_group(sizes, world, rank, group, order), order=order)


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

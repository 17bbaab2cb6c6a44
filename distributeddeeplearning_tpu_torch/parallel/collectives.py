"""Collectives over a process group — the port of ``parallel/collectives.py``.

The reference's three Horovod collectives (the gradient all-reduce, the
averaged metrics, the parameter broadcast) and the JAX package's
``psum`` / ``pmean`` / ``all_gather`` / ``global_norm`` helpers, as
``torch.distributed`` calls on the group a :class:`..mesh.Mesh` carries.
``psum`` and ``pmean`` take a tree (nested dicts, tuples and lists of
tensors) and make ONE collective per dtype over the concatenated leaves.

The backend is the group's, never chosen by a failure.  NCCL runs every
operation on CUDA tensors; gloo runs only ``all_reduce`` and
``broadcast`` on them.  Where gloo lacks an operation for a CUDA tensor,
it is staged through host memory: the tensor is copied to the CPU, the
collective runs there and the result is copied back.  Each staging is
counted by operation (:func:`staged_ops`), so a run can say what it
staged.  Every collective that runs on a process group is counted by
operation too (:func:`counts`): a run that resets the count before a
tensor-parallel forward and reads it after sees exactly the collectives
it issued.  With no process group (one process) every collective is the
identity of a world of 1, and nothing is counted.

``ring_permute`` waits for sequence parallelism (ROADMAP A7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.train.state import tree_leaves, tree_map

Tree = Any

#: operations gloo runs on CUDA tensors itself
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})

_staged: Dict[str, int] = {}
_counts: Dict[str, int] = {}


def staged_ops() -> Dict[str, int]:
    """``{operation: times staged through host memory}`` since the last
    :func:`reset_staged`."""
    return dict(_staged)


def reset_staged() -> None:
    _staged.clear()


def counts() -> Dict[str, int]:
    """``{operation: collectives run}`` since the last :func:`reset_counts`
    (``all_reduce``, ``all_reduce_max``, ``all_gather``, ...)."""
    return dict(_counts)


def reset_counts() -> None:
    _counts.clear()


def _count(op: str) -> None:
    _counts[op] = _counts.get(op, 0) + 1


def active(group=None) -> bool:
    """Whether collectives run on the backend: whenever a process group
    exists, at a world of 1 too (a one-rank NCCL group still launches its
    kernels); without one they are the identity."""
    return dist.is_available() and dist.is_initialized()


def group_size(group=None) -> int:
    return (dist.get_world_size(group)
            if dist.is_available() and dist.is_initialized() else 1)


def _host_staged(op: str, t: torch.Tensor, group) -> bool:
    if t.device.type == "cpu" or op in GLOO_CUDA_OPS:
        return False
    if dist.get_backend(group) != "gloo":
        return False
    _staged[op] = _staged.get(op, 0) + 1
    return True


class Pending:
    """A collective in flight: :meth:`wait` blocks until it is done and
    returns its result (copied back to the caller's device when it was
    staged through host memory)."""

    def __init__(self, work, out: torch.Tensor, device: torch.device):
        self._work, self._out, self._device = work, out, device

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._out.device != self._device:
            self._out = self._out.to(self._device)
        return self._out


def all_reduce(t: torch.Tensor, group=None, *, async_op: bool = False):
    """Sum ``t`` over the group IN PLACE; returns ``t`` (or a
    :class:`Pending` with ``async_op``)."""
    work = None
    if active(group):
        _count("all_reduce")
        work = dist.all_reduce(t, group=group, async_op=async_op)
    pending = Pending(work if async_op else None, t, t.device)
    return pending if async_op else t


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over the group, IN PLACE; returns
    ``t``."""
    if active(group):
        _count("all_reduce_max")
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` with ``src``'s, in place (group rank ``src``)."""
    if active(group):
        _count("broadcast")
        dist.broadcast(t, dist.get_global_rank(group, src) if group is not None
                       else src, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group=None, *, async_op: bool = False):
    """Tiled reduce-scatter of a 1-D tensor whose length divides by the
    world: rank r gets the sum of every rank's block r (``psum_scatter
    (tiled=True)``)."""
    n = group_size(group)
    if not active(group):
        out = t.clone()
        return Pending(None, out, t.device) if async_op else out
    _count("reduce_scatter")
    src = t.cpu() if _host_staged("reduce_scatter", t, group) else t
    out = src.new_empty(src.shape[0] // n)
    work = dist.reduce_scatter_tensor(out, src.contiguous(), group=group,
                                      async_op=async_op)
    pending = Pending(work, out, t.device)
    return pending if async_op else pending.wait()


def all_to_all(t: torch.Tensor, group=None, *, async_op: bool = False):
    """Block i of ``t`` (split along dim 0 into world blocks) goes to rank
    i; the result holds block r of every rank, in rank order."""
    if not active(group):
        out = t.clone()
        return Pending(None, out, t.device) if async_op else out
    _count("all_to_all")
    src = t.cpu() if _host_staged("all_to_all", t, group) else t
    src = src.contiguous()
    out = torch.empty_like(src)
    work = dist.all_to_all_single(out, src, group=group, async_op=async_op)
    pending = Pending(work, out, t.device)
    return pending if async_op else pending.wait()


def all_gather(x: torch.Tensor, group=None, *, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along dim 0
    (``tiled``) or stacked on a new leading dim."""
    n = group_size(group)
    if not active(group):
        return x.clone() if tiled else x[None].clone()
    _count("all_gather")
    src = x.cpu() if _host_staged("all_gather", x, group) else x
    src = src.contiguous().reshape((-1,) + tuple(x.shape[1:]))
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    out = out.to(x.device)
    return out if tiled and x.dim() else out.view(n, *x.shape)


def all_gather_object(obj, group=None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if not active(group):
        return [obj]
    out: List[Any] = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not active(group):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src)
                               if group is not None else src, group=group)
    return box[0]


def barrier(group=None) -> None:
    if active(group):
        dist.barrier(group=group)


def _rebuild(tree, it):
    leaves = iter(it)
    return tree_map(lambda _: next(leaves), tree)


def psum(tree: Tree, group=None) -> Tree:
    """The tree of every leaf summed over the group (new tensors): one
    all-reduce per dtype over the concatenated leaves."""
    leaves = tree_leaves(tree)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[tuple, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault((leaf.dtype, leaf.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        all_reduce(flat, group)
        offset = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[offset:offset + n].view(leaves[i].shape)
            offset += n
    return _rebuild(tree, iter(out))


def pmean(tree: Tree, group=None) -> Tree:
    """The tree of every leaf averaged over the group."""
    n = group_size(group)
    summed = psum(tree, group)
    if n == 1:
        return summed
    return _rebuild(tree, iter([x / n for x in tree_leaves(summed)]))


def global_norm(tree: Tree, group=None) -> torch.Tensor:
    """L2 norm over a tree, in f32 (``optax.global_norm``); with ``group``
    the leaves are this rank's shards and their squares are summed over
    the group first."""
    sq = sum(torch.sum(x.float() ** 2) for x in tree_leaves(tree))
    if group is not None and active(group):
        sq = all_reduce(sq.clone(), group)
    return torch.sqrt(sq)

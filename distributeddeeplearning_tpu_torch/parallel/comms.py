"""Explicit gradient communication for the training hot loop — the port
of ``parallel/comms.py``, on ``torch.distributed``.

The reference's schedule, consumed by ``build_train_step(comm_overlap=
True)``:

- :class:`BucketLayout` — a static flat-vector layout over the parameter
  tree: the leaves in the reference's ``tree_leaves`` order (dict keys
  sorted, taken BY KEY from any tree of the same structure, never by
  position), cut into ``bucket_bytes`` buckets, each padded to a multiple
  of the data-parallel shard count so it reduce-scatters cleanly;
- :func:`reduce_scatter_buckets` — per-bucket tiled reduce-scatter over
  the group, issued asynchronously so it overlaps the next microbatch's
  backward.  The f32 wire is ``reduce_scatter_tensor``; the bf16 wire is
  the reference's all-to-all of the bf16 payload plus a local f32 sum,
  with per-bucket error feedback (``adj = bucket + residual``; the new
  residual is ``adj - wire.float()``).  A native bf16 reduce-scatter
  would sum in bf16 and lose what the residual cannot see;
- :func:`gather_flat` — the all-gather that closes the loop;
- :func:`prepare_comm_state` / :func:`comm_opt_tree` /
  :func:`map_params_subtrees` — a fresh ``TrainState`` into the comm
  layout.  Under weight-update sharding (ZeRO) each rank holds its 1/N
  shard of every params-shaped optimizer buffer; with the bf16 wire each
  rank holds its own residual block of ``bucket`` elements per bucket.
  Both are :class:`RankShards`: concatenated over the ranks in rank order
  they are the reference's global arrays;
- :func:`ring_wire_bytes` — the bytes-on-wire model, the reference's
  numbers.

The reference's ``collective_stats`` parses XLA's HLO and has no eager
counterpart; a profiler-based count is ROADMAP A7's (``obs/``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.train.state import TreeTuple, is_sequence_node

Tree = Any
Path = Tuple[str, ...]


class RankShards(TreeTuple):
    """This rank's blocks of vectors that span the ranks (weight-update
    shards, error-feedback residuals): a tuple of 1-D tensors, one per
    bucket, with the ``group``, ``rank`` and ``world`` they belong to.
    Rank r's block of a global vector of length ``world * n`` is its
    elements ``[r * n, (r + 1) * n)``."""

    def __new__(cls, items, *, group=None, rank: int = 0, world: int = 1):
        obj = super().__new__(cls, items)
        obj.group, obj.rank, obj.world = group, rank, world
        return obj


def sorted_leaves(tree: Tree, path: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """``(key path, leaf)`` of a nested dict in the reference's
    ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in sorted_leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _get(tree: Tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static layout of a tree as a padded flat f32 vector cut into buckets.

    Leaves are concatenated in the reference's ``tree_leaves`` order; the
    vector is cut into buckets of ``bucket_elems`` elements (the last
    holds the remainder) and every bucket length is a multiple of
    ``shards``.  Padding is zeros and stays zero through any elementwise
    optimizer."""

    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    total: int
    bucket_bounds: Tuple[Tuple[int, int], ...]
    shards: int

    @classmethod
    def for_tree(cls, tree: Tree, *, bucket_bytes: int, shards: int) -> "BucketLayout":
        leaves = sorted_leaves(tree)
        shapes = tuple(tuple(leaf.shape) for _, leaf in leaves)
        sizes = tuple(math.prod(s) if s else 1 for s in shapes)
        total = int(sum(sizes))
        if total == 0:
            raise ValueError("cannot bucket an empty pytree")
        elems = max(int(bucket_bytes) // 4, 1)
        bucket_elems = max(-(-elems // shards) * shards, shards)
        bounds = []
        start = 0
        while start < total:
            end = min(start + bucket_elems, total)
            padded_end = start + -(-(end - start) // shards) * shards
            bounds.append((start, padded_end))
            start = padded_end
        return cls(paths=tuple(p for p, _ in leaves), shapes=shapes,
                   dtypes=tuple(leaf.dtype for _, leaf in leaves), sizes=sizes,
                   total=total, bucket_bounds=tuple(bounds), shards=shards)

    @property
    def padded_total(self) -> int:
        return self.bucket_bounds[-1][1]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_bounds)

    @property
    def bucket_sizes(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in self.bucket_bounds)

    def shard_sizes(self) -> Tuple[int, ...]:
        return tuple(n // self.shards for n in self.bucket_sizes)

    def to_flat(self, tree: Tree) -> torch.Tensor:
        """Ravel + concat + zero-pad the tree (leaves taken by key) into a
        new padded f32 vector."""
        parts = [_get(tree, p).detach().reshape(-1).float() for p in self.paths]
        pad = self.padded_total - self.total
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def to_buckets(self, tree: Tree) -> Tuple[torch.Tensor, ...]:
        flat = self.to_flat(tree)
        return tuple(flat[s:e] for s, e in self.bucket_bounds)

    def _pieces(self, flat: torch.Tensor):
        offset = 0
        for path, shape, dtype, size in zip(self.paths, self.shapes, self.dtypes,
                                            self.sizes):
            yield path, flat[offset:offset + size].reshape(shape).to(dtype)
            offset += size

    def from_flat(self, flat: torch.Tensor) -> Tree:
        """The padded flat vector back to a nested dict (original shapes
        and dtypes)."""
        out: Dict[str, Any] = {}
        for path, leaf in self._pieces(flat):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out

    def from_buckets(self, buckets: Sequence[torch.Tensor]) -> Tree:
        return self.from_flat(torch.cat(list(buckets)))

    @torch.no_grad()
    def write_flat(self, tree: Tree, flat: torch.Tensor) -> None:
        """Copy the padded flat vector into ``tree``'s tensors, in place."""
        for path, leaf in self._pieces(flat):
            _get(tree, path).copy_(leaf)

    def shard_slice(self, bucket: torch.Tensor, index: int) -> torch.Tensor:
        """``index``-th shard of a full local bucket (no collective)."""
        size = bucket.shape[0] // self.shards
        return bucket[index * size:(index + 1) * size]


# -- collectives ---------------------------------------------------------------

class _Summed:
    """The f32 sum over the received bf16 blocks of an all-to-all in
    flight (the compressed reduce-scatter's receiver side)."""

    def __init__(self, pending):
        self._pending = pending

    def wait(self) -> torch.Tensor:
        return self._pending.wait().float().sum(dim=0)


def reduce_scatter_buckets(
    buckets: Sequence[torch.Tensor],
    group=None,
    *,
    comm_dtype: Optional[torch.dtype] = None,
    residuals: Optional[Sequence[torch.Tensor]] = None,
    shards: Optional[int] = None,
    async_op: bool = False,
):
    """Per-bucket tiled reduce-scatter over ``group``; f32 results, as
    ``(scattered, new_residuals)``.  With ``async_op`` each scattered
    entry is a handle whose ``wait()`` gives the shard.

    With ``comm_dtype`` (bf16) the payload ``adj = bucket + residual`` is
    cast down, ``adj - wire.float()`` is the new residual, and the
    reduction is an all-to-all of the bf16 blocks summed locally in f32:
    the only lossy step is the explicit cast, which error feedback
    re-injects next step.  ``residuals`` are then this rank's f32 blocks
    (one per bucket, of the bucket's size) and ``shards`` the world."""
    scattered = []
    new_residuals: Optional[List[torch.Tensor]] = [] if comm_dtype is not None else None
    for i, bucket in enumerate(buckets):
        if comm_dtype is None:
            pending = collectives.reduce_scatter(bucket, group, async_op=True)
        else:
            if shards is None:
                raise ValueError("compressed reduce-scatter needs shards=N")
            adj = bucket + residuals[i]
            wire = adj.to(comm_dtype)
            new_residuals.append(adj - wire.float())
            pending = _Summed(collectives.all_to_all(wire.view(shards, -1), group,
                                                     async_op=True))
        scattered.append(pending if async_op else pending.wait())
    return tuple(scattered), (tuple(new_residuals) if new_residuals is not None
                              else None)


def gather_flat(shards: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """All-gather per-bucket shards (tiled) and concat to the flat vector."""
    return torch.cat([collectives.all_gather(s, group) for s in shards])


# -- optimizer-state conversion (weight-update sharding) ---------------------

def tree_structure(tree: Tree):
    """The key structure of a nested dict (leaves are None)."""
    if isinstance(tree, dict):
        return tuple((k, tree_structure(tree[k])) for k in sorted(tree))
    return None


def map_params_subtrees(opt_state: Tree, params_structure, replace_fn: Callable,
                        leaf_fn: Callable) -> Tree:
    """Rebuild ``opt_state`` with every params-shaped subtree (a dict with
    the parameters' key structure: Adam's moments, the momentum trace)
    replaced by ``replace_fn(subtree)`` and every other leaf by
    ``leaf_fn(leaf)``."""

    def go(sub):
        if isinstance(sub, dict):
            if tree_structure(sub) == params_structure:
                return replace_fn(sub)
            return {k: go(v) for k, v in sub.items()}
        if is_sequence_node(sub) and not isinstance(sub, RankShards):
            return tuple(go(v) for v in sub)
        return leaf_fn(sub)

    return go(opt_state)


def comm_opt_tree(opt_state: Tree, params_structure, layout: BucketLayout) -> Tree:
    """Params-shaped optimizer buffers -> tuples of per-bucket flat
    vectors (global length)."""
    return map_params_subtrees(opt_state, params_structure, layout.to_buckets,
                               lambda leaf: leaf)


def is_prepared(opt_state) -> bool:
    return isinstance(opt_state, dict) and set(opt_state) == {"base", "residual"}


def prepare_comm_state(mesh, state, layout: BucketLayout, *,
                       weight_update_sharding: bool,
                       comm_dtype: Optional[torch.dtype]):
    """A fresh ``TrainState`` in the comm layout the ``comm_overlap`` step
    trains and checkpoints: ``opt_state`` becomes ``{"base", "residual"}``.

    - ``base`` is the optimizer state, except (under weight-update
      sharding) every params-shaped buffer becomes this rank's
      :class:`RankShards` of its per-bucket flat vectors;
    - ``residual`` is this rank's :class:`RankShards` of zero f32
      error-feedback blocks (one of each bucket's size) with the bf16 wire,
      else ``()``.

    Idempotent on a prepared state (restore templates pass through)."""
    opt = state.opt_state
    if is_prepared(opt):
        return state
    group, rank, world = mesh.group, mesh.rank, layout.shards
    p_struct = tree_structure(state.params)

    def own(tensors):
        return RankShards(tensors, group=group, rank=rank, world=world)

    if weight_update_sharding:
        base = map_params_subtrees(
            opt, p_struct,
            lambda sub: own([layout.shard_slice(b, rank).clone()
                             for b in layout.to_buckets(sub)]),
            lambda leaf: leaf)
    else:
        base = opt
    residual: Any = ()
    if comm_dtype is not None:
        device = sorted_leaves(state.params)[0][1].device
        residual = own([torch.zeros(n, dtype=torch.float32, device=device)
                        for n in layout.bucket_sizes])
    return dataclasses.replace(state, opt_state={"base": base, "residual": residual})


# -- bytes-on-wire accounting ------------------------------------------------

def ring_wire_bytes(layout: BucketLayout, *, comm_dtype: Optional[Any] = None,
                    weight_update_sharding: bool = False, accum_steps: int = 1,
                    param_itemsize: int = 4) -> Dict[str, int]:
    """Per-device bytes on the wire per STEP under the ring-collective
    cost model (the reference's numbers): a reduce-scatter or all-gather
    of S bytes moves (N-1)/N * S per device, an all-reduce both halves.
    The overlap schedule reduce-scatters once per microbatch and, under
    weight-update sharding, all-gathers the updated params once a step."""
    n = layout.shards
    comm_itemsize = 2 if comm_dtype is not None else 4
    rs = (n - 1) * layout.padded_total * comm_itemsize // n * accum_steps
    ag = ((n - 1) * layout.padded_total * param_itemsize // n
          if weight_update_sharding else 0)
    baseline = 2 * (n - 1) * layout.total * 4 // n
    return {
        "reduce_scatter_bytes": rs,
        "all_gather_bytes": ag,
        "total_bytes": rs + ag,
        "implicit_allreduce_bytes": baseline,
    }

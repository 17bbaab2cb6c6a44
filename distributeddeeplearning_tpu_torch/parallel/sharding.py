"""How arrays are laid out over the ranks — the port of
``parallel/sharding.py``, its data-parallel part.

The reference's contract is Horovod's: the batch is split over the data
axes, parameters are replicated.  With one process per device a "sharded"
batch is simply the rows this rank holds: :func:`shard_batch` gives rank
r the contiguous rows ``[r * B / N, (r + 1) * B / N)`` of a global batch
(the row order of the reference's ``batch_sharding``, which its strided
microbatch split depends on), and :func:`replicate_params` broadcasts
rank 0's parameters, statistics and optimizer state at start (the
reference's ``hvd.broadcast_parameters``).  :func:`batch_spec`,
:func:`data_spec` and :func:`replicated_spec` describe those layouts as
plain tuples of axis names.

``LAYOUT_RULES``, ``logical_to_spec`` and ``param_shardings`` wait for FSDP
(ROADMAP A5) and tensor parallelism (ROADMAP A6).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import DATA_AXES, Mesh
from distributeddeeplearning_tpu_torch.train.state import tree_leaves, tree_map


def replicated_spec() -> Tuple:
    return ()


def data_spec(*rest: Any) -> Tuple:
    """Leading dim over the data axes, trailing entries as given."""
    return (DATA_AXES, *rest)


def batch_spec(ndim: int) -> Tuple:
    """Batch tensors: leading dim over the data axes, rest replicated."""
    return (DATA_AXES, *([None] * (ndim - 1)))


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``."""
    if n % mesh.size:
        raise ValueError(f"global batch {n} not divisible by the {mesh.size} "
                         "data-parallel ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous rows of every array of a global batch (numpy
    arrays or tensors; views, no copy)."""

    def take(x):
        x = x if isinstance(x, (np.ndarray, torch.Tensor)) else np.asarray(x)
        return x[local_rows(mesh, x.shape[0])]

    return tree_map(take, batch)


@torch.no_grad()
def replicate_params(mesh: Mesh, state):
    """Overwrite this rank's parameters, BatchNorm statistics and optimizer
    state with rank 0's, in place; returns ``state``."""
    if mesh.group is None:
        return state
    for leaf in tree_leaves([state.params, state.batch_stats, state.opt_state]):
        if isinstance(leaf, torch.Tensor):
            collectives.broadcast_(leaf.data if leaf.requires_grad else leaf, 0,
                                   mesh.group)
    return state

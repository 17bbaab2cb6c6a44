"""How arrays are laid out over the ranks — the port of
``parallel/sharding.py``: the data-parallel batch layout and the
partition-rule layout table of tensor-parallel serving.

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

The partition-rule layout table.  :data:`LAYOUT_RULES` is the
reference's table, copied verbatim (``layout_rules_provenance`` gives the
reference's tag), and :func:`spec_for` / :func:`match_partition_rules`
resolve a leaf name through it exactly as the reference does: first match
wins, scalars replicate, an axis is used once per leaf, and a mapping is
dropped where the dim does not divide by the axis size (the leaf is then
replicated along it).  A spec is a plain tuple of entries (an axis name, a
tuple of them, or None), the reference's ``PartitionSpec`` without jax.

Under GSPMD a spec is a placement and XLA inserts the collectives; the port
runs one process per device, so :func:`shard_params` and
:func:`local_slice` give each rank its LOCAL slice of a tree, and the model
issues the collectives itself (``models.pipelined_transformer``'s ``mesh=``
path).  Every dim a spec maps to axes is cut into contiguous blocks, block
``i`` to the rank whose coordinate over those axes (row-major, in the order
the entry names them) is ``i``.

One place differs from a literal reading of the table.  ``qkv`` is ``[L, d,
3d]`` and its rule splits the last dim; a rank that computed with a
contiguous third of it would hold the q of some heads and the k of others.
So the port's slice of ``qkv`` (values and QTensor scales) takes, from EACH
of the q, k and v thirds, the columns of heads ``[r h / tp, (r + 1) h /
tp)``: the layout a rank of the reference's ``shard_map`` attention sees.
``w_in``, ``proj`` and ``w_out`` split contiguously; the rows of ``proj``
are head-major (the attention output's ``reshape(b, d)`` puts heads
first), so a rank's ``proj`` rows are exactly its heads' outputs.

``logical_to_spec`` and ``param_shardings`` wait for FSDP (ROADMAP A5).
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    DATA_AXES,
    Mesh,
    tensor_parallel_size,  # noqa: F401 — the reference's home of it
)
from distributeddeeplearning_tpu_torch.quant.qtensor import QTensor
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


# ---------------------------------------------------------------------------
# The partition-rule layout table (regex leaf-name -> partition entries),
# the reference's, verbatim: ``layout_rules_provenance`` hashes its repr.
# ---------------------------------------------------------------------------

LayoutRules = Tuple[Tuple[str, Tuple[Any, ...]], ...]

LAYOUT_RULES: LayoutRules = (
    # -- KV caches ---------------------------------------------------------
    # dense [slots, L, S, h, hd]: slots over the data axes, heads over
    # tensor; scale leaves ([slots, L, S, h] f32) drop the hd dim.
    (r"^kv_dense/(k|v)$", (DATA_AXES, None, None, "tensor", None)),
    (r"^kv_dense/(k|v)_scale$", (DATA_AXES, None, None, "tensor")),
    # paged [pages+1, L, page_size, h, hd]: the page axis NEVER shards
    # (the block-table gather must stay chip-local), heads over tensor.
    (r"^kv_paged/(k|v)$", (None, None, None, "tensor", None)),
    (r"^kv_paged/(k|v)_scale$", (None, None, None, "tensor")),
    # -- engine operands (``io/`` namespace; before the param rules so
    # ``io/pos`` can never fall through to the [max_len, d] ``pos`` rule).
    # Per-slot vectors ride the data axes (a pure-TP mesh has data size 1,
    # which replicates them); host-derived page plumbing replicates.
    (r"^io/(tokens?|pos|slots?|lengths?|step)$", (DATA_AXES,)),
    (r"^io/(block_tables?|page_ids|k|v|from_(pos|offs)|offsets?|draft_len)$", ()),
    # -- flash-decode kernel operands (``attn/`` namespace): the Pallas
    # path shard_maps over ``tensor`` so each chip's kernel instance runs
    # its LOCAL heads — q/pages/out head dim over tensor, scale leaves
    # likewise, block tables and position matrices replicated (page
    # addressing is chip-local by construction).
    (r"^attn/(q|out|(k|v)_pages)$", (None, None, "tensor", None)),
    (r"^attn/(k|v)_scale$", (None, None, "tensor")),
    (r"^attn/(k|v)_own$", (None, "tensor", None)),
    (r"^attn/(tables|posmat)$", ()),
    # -- serve-path transformer weights (stacked [L, ...]; Megatron TP) ----
    # column-parallel (output width over tensor): qkv, w_in.  QTensor
    # scale leaves (axis=-2 keepdims) keep the same rank, so one rule
    # covers values and scales.
    (r"(^|/)(qkv|w_in)(/(values|scales))?$", (None, None, "tensor")),
    # row-parallel (contraction dim over tensor): proj, w_out.  Their
    # QTensor scales reduce that dim to size 1 — the divisibility drop
    # de-shards it, which is exactly right (scales replicate).
    (r"(^|/)(proj|w_out)(/(values|scales))?$", (None, "tensor", None)),
    (r"(^|/)ln[0-9]+$", ()),
    # vocab-parallel embedding/head: per-chip [V/t, d] and [d, V/t]; the
    # embed gather and the sharded-vocab argmax each cost one collective.
    (r"(^|/)embed(/(values|scales))?$", ("tensor", None)),
    (r"(^|/)head(/(values|scales))?$", (None, "tensor")),
    (r"(^|/)pos$", ()),
    # -- comm-overlap state: flat bucket vectors over the data axes --------
    (r"^comm/", (DATA_AXES,)),
)

#: leaves whose tensor split is head-aligned per q/k/v third (docstring)
_HEAD_ALIGNED = re.compile(r"(^|/)qkv(/(values|scales))?$")

Spec = Tuple[Any, ...]


def layout_rules_provenance(rules: LayoutRules = LAYOUT_RULES) -> str:
    """Short provenance tag for reports: which rule table produced the
    layout (count + content digest, the reference's tag for the same
    table)."""
    h = hashlib.sha1(repr(rules).encode()).hexdigest()[:8]
    return f"LAYOUT_RULES#{len(rules)}@{h}"


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _spec_from_entries(entries: Spec, *, shape: Optional[Tuple[int, ...]] = None,
                       mesh: Optional[Mesh] = None) -> Spec:
    """Partition entries -> the spec of one leaf: an axis used twice
    replicates after its first use, an axis whose size does not divide the
    dim is dropped, entries past the leaf's rank and trailing Nones go."""
    if shape is not None:
        entries = entries[: len(shape)]
    taken: set = set()
    out: List[Any] = []
    for i, entry in enumerate(entries):
        kept = []
        for ax in _entry_axes(entry):
            if ax in taken:
                continue
            if mesh is not None and shape is not None and shape[i] % int(mesh.shape[ax]):
                continue
            kept.append(ax)
        taken.update(kept)
        out.append(None if not kept else kept[0] if len(kept) == 1 else tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_for(name: str, *, shape: Optional[Tuple[int, ...]] = None,
             rules: LayoutRules = LAYOUT_RULES, mesh: Optional[Mesh] = None
             ) -> Optional[Spec]:
    """Resolve one leaf name through the rule table (first match wins);
    None when no rule matches.  Scalars replicate."""
    if shape is not None and len(shape) == 0:
        return ()
    for pattern, entries in rules:
        if re.search(pattern, name):
            return _spec_from_entries(entries, shape=shape, mesh=mesh)
    return None


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` of every leaf: dict keys and a QTensor's
    ``values`` / ``scales`` joined by ``/`` (the reference's leaf path
    names), under ``prefix``."""
    def walk(node, name):
        if isinstance(node, dict):
            for key, child in node.items():
                yield from walk(child, f"{name}/{key}" if name else str(key))
        elif isinstance(node, QTensor):
            yield from walk(node.values, f"{name}/values")
            yield from walk(node.scales, f"{name}/scales")
        else:
            yield name, node
    return list(walk(tree, prefix))


def match_partition_rules(tree, *, prefix: str = "", rules: LayoutRules = LAYOUT_RULES,
                          mesh: Optional[Mesh] = None, strict: bool = True
                          ) -> Dict[str, Spec]:
    """``{leaf name: spec}`` for every leaf of ``tree`` (leaves supply the
    shapes of the divisibility drop; a None leaf resolves by name alone).
    ``strict`` raises on a non-scalar leaf no rule matches."""
    specs, missed = {}, []
    for name, leaf in named_leaves(tree, prefix):
        shape = None if leaf is None else tuple(leaf.shape)
        spec = spec_for(name, shape=shape, rules=rules, mesh=mesh)
        if spec is None:
            missed.append(name)
            spec = ()
        specs[name] = spec
    if missed and strict:
        raise ValueError(
            f"no partition rule matches leaf(s) {missed} (prefix={prefix!r}) — "
            "add a rule to parallel.sharding.LAYOUT_RULES instead of "
            "hand-wiring a layout at the call site")
    return specs


def _block(mesh: Mesh, entry: Any) -> Tuple[int, int]:
    """(this rank's block index, block count) over an entry's axes."""
    idx, n = 0, 1
    for ax in _entry_axes(entry):
        idx = idx * mesh.shape[ax] + mesh.axis_index(ax)
        n *= mesh.shape[ax]
    return idx, n


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of this rank's slice of a ``shape`` leaf laid out by
    ``spec``; raises where a split dim does not divide."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _block(mesh, entry)[1]
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over "
                             f"{entry} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def local_slice(t: torch.Tensor, spec: Spec, mesh: Mesh, *,
                head_aligned: bool = False) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view; contiguous
    blocks).  ``head_aligned`` cuts the last dim per third (the ``qkv``
    rule, module docstring)."""
    for i, entry in enumerate(spec):
        idx, n = _block(mesh, entry)
        if n == 1:
            continue
        if head_aligned and i == t.dim() - 1 and t.shape[i] % (3 * n) == 0:
            third = t.shape[i] // 3
            per = third // n
            t = torch.cat([t.narrow(i, j * third + idx * per, per) for j in range(3)], i)
            continue
        per = t.shape[i] // n
        t = t.narrow(i, idx * per, per)
    return t


def shard_params(params, mesh: Mesh):
    """This rank's slice of a serve-path parameter tree (f32, bf16 or
    int8-weight leaves) through the rule table, under the reference's
    ``params`` prefix: column-parallel ``qkv`` (head-aligned) and
    ``w_in``, row-parallel ``proj`` and ``w_out`` (their int8 scales
    replicate), vocab-parallel ``embed`` and ``head``, replicated ``pos``
    and layer norms.  Contiguous copies, so the full tree can be freed;
    without a tensor axis above 1 the tree comes back as it is."""
    if tensor_parallel_size(mesh) <= 1:
        return params
    specs = match_partition_rules(params, prefix="params", mesh=mesh)

    def take(node, name):
        if isinstance(node, dict):
            return {k: take(v, f"{name}/{k}") for k, v in node.items()}
        if isinstance(node, QTensor):
            return QTensor(take(node.values, f"{name}/values"),
                           take(node.scales, f"{name}/scales"), node.axis, node.block)
        return local_slice(node, specs[name], mesh,
                           head_aligned=bool(_HEAD_ALIGNED.search(name))).contiguous()

    return take(params, "params")

"""Train state and optimizers — the port of ``train/state.py``.

Where the reference threads an immutable pytree through a jitted step and
donates it, :class:`TrainState` is updated IN PLACE: the optimizers write
the new parameters and moments into the existing tensors under
``torch.no_grad``, so the device holds one copy of params and optimizer
state, as the donated JAX state did.

:func:`adamw` and :func:`sgd_momentum` reproduce the optax chains the
reference builds, update for update (not ``torch.optim``'s conventions):
the schedule is read at the optimizer's count *before* it is incremented,
Adam's bias correction uses count + 1, its update is m^/(sqrt(v^) + eps)
with no eps inside the root, weight decay is decoupled, scaled by the
learning rate and applies to every leaf, and global-norm clipping is
``where(norm < max, g, g / norm * max)``.  The count is a 0-d tensor on
the parameters' device.

Params are a nested dict of tensors (the model's layout).  BatchNorm
running statistics live apart in ``TrainState.batch_stats`` (``{}`` for a
model without them): they take no gradient and no weight decay, and a
train step replaces them with the model's new ones together with the
update (kept where the update is skipped).  :func:`create_train_state`
builds the state of an image model from its ``init``.

Sharded training (``TrainState.layout``, a ``parallel.sharding.
ParamLayout``): the params are this rank's slices, and the optimizers
work on them unchanged, so AdamW's ``mu`` and ``nu`` and SGD's ``trace``
take each shard's shape (ZeRO's contract).  Clipping then needs the norm
of the whole tree, not of this rank's slice: the train step computes it
(``collectives.sharded_global_norm``) and passes it as ``grad_norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from distributeddeeplearning_tpu_torch.train.schedule import Schedule

Params = Dict[str, Any]


class TreeTuple(tuple):
    """A tuple the tree helpers descend into although it is a subclass
    (plain tuples and lists are nodes; other tuple subclasses, such as
    ``torch.Size``, are leaves)."""


def is_sequence_node(tree) -> bool:
    return type(tree) in (tuple, list) or isinstance(tree, TreeTuple)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict (insertion order) of tuples and lists (in
    order; see :class:`TreeTuple`): a tuple of flat buckets is a tree too."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if is_sequence_node(tree):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if is_sequence_node(tree):
        kind = tuple if isinstance(tree, tuple) else list
        return kind(tree_map(fn, v, *(r[i] for r in rest))
                    for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_zip(tree, *rest):
    """Tuples of corresponding leaves, matched by key along ``tree``'s
    order (the others may have their keys in another order); tuples and
    lists pair by position."""
    if isinstance(tree, dict):
        return [z for k, v in tree.items()
                for z in tree_zip(v, *(r[k] for r in rest))]
    if is_sequence_node(tree):
        return [z for i, v in enumerate(tree)
                for z in tree_zip(v, *(r[i] for r in rest))]
    return [(tree, *rest)]


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))


def _commit(dst: torch.Tensor, new: torch.Tensor, ok: Optional[torch.Tensor]):
    dst.copy_(new if ok is None else torch.where(ok, new, dst))


class _Optimizer:
    """Shared state handling: ``init(params)`` makes the state,
    ``apply(params, grads, opt_state, ok=None)`` updates params and state in
    place; where the 0-d bool ``ok`` is False both are left as they were."""

    def __init__(self, schedule: Schedule):
        self.schedule = schedule

    def _count(self, params):
        return torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)

    def _lr(self, count):
        lr = self.schedule(count)
        return lr if isinstance(lr, torch.Tensor) else torch.tensor(
            lr, dtype=torch.float32, device=count.device)


class AdamW(_Optimizer):
    """``optax.chain(clip_by_global_norm(grad_clip_norm), optax.adamw(...))``
    (the clip is dropped when ``grad_clip_norm`` is 0)."""

    def __init__(self, schedule: Schedule, *, weight_decay: float, b1: float,
                 b2: float, eps: float, grad_clip_norm: float):
        super().__init__(schedule)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": self._count(params), "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, opt_state, ok=None, *,
              grad_norm: Optional[torch.Tensor] = None) -> None:
        """``grad_norm``: the global norm the clip divides by, when
        ``grads`` are slices of a sharded tree (module docstring); None
        computes it from ``grads``."""
        b1, b2 = self.b1, self.b2
        norm = None
        if self.grad_clip_norm:
            norm = global_norm(tree_leaves(grads)) if grad_norm is None else grad_norm
        count = opt_state["count"]
        count_inc = count + 1
        lr = self._lr(count)  # read before the increment, as optax does
        bc1 = 1 - b1 ** count_inc
        bc2 = 1 - b2 ** count_inc
        for p, g, mu, nu in tree_zip(params, grads, opt_state["mu"],
                                     opt_state["nu"]):
            if norm is not None:
                g = torch.where(norm < self.grad_clip_norm, g,
                                g / norm * self.grad_clip_norm)
            mu_new = (1 - b1) * g + b1 * mu
            nu_new = (1 - b2) * g ** 2 + b2 * nu
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            u = u + self.weight_decay * p
            _commit(p, p + (-lr) * u, ok)
            _commit(mu, mu_new, ok)
            _commit(nu, nu_new, ok)
        _commit(count, count_inc, ok)


class SGDMomentum(_Optimizer):
    """``optax.chain(add_decayed_weights(wd), optax.sgd(schedule,
    momentum, nesterov))``: coupled weight decay, as torch.optim.SGD."""

    def __init__(self, schedule: Schedule, *, momentum: float,
                 weight_decay: float, nesterov: bool):
        super().__init__(schedule)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": self._count(params),
                "trace": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, opt_state, ok=None, *,
              grad_norm: Optional[torch.Tensor] = None) -> None:
        del grad_norm  # no clip
        count = opt_state["count"]
        lr = self._lr(count)
        for p, g, t in tree_zip(params, grads, opt_state["trace"]):
            if self.weight_decay:
                g = g + self.weight_decay * p
            t_new = g + self.momentum * t
            u = g + self.momentum * t_new if self.nesterov else t_new
            _commit(p, p + (-lr) * u, ok)
            _commit(t, t_new, ok)
        _commit(count, count + 1, ok)


def sgd_momentum(schedule: Schedule, *, momentum: float = 0.9,
                 weight_decay: float = 5e-5, nesterov: bool = False) -> SGDMomentum:
    """The reference optimizer: SGD momentum 0.9, weight decay 5e-5."""
    return SGDMomentum(schedule, momentum=momentum, weight_decay=weight_decay,
                       nesterov=nesterov)


def adamw(schedule: Schedule, *, weight_decay: float = 0.01, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-6,
          grad_clip_norm: float = 1.0) -> AdamW:
    """AdamW with global-norm clipping (the reference's LM/BERT optimizer)."""
    return AdamW(schedule, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                 grad_clip_norm=grad_clip_norm)


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state, step, the model function and the BatchNorm
    running statistics.

    ``step`` is a host int (the count of train-step calls, skipped updates
    included); the optimizer keeps its own count on the device.  Floating
    param leaves are set to require grad on construction.  ``layout``: the
    ``parallel.sharding.ParamLayout`` of sharded params (module
    docstring), None for replicated ones."""

    step: int
    params: Params
    opt_state: Any
    apply_fn: Callable
    tx: Any
    batch_stats: Params = dataclasses.field(default_factory=dict)
    layout: Any = None

    def __post_init__(self):
        for leaf in tree_leaves(self.params):
            if leaf.is_floating_point():
                leaf.requires_grad_(True)

    @classmethod
    def create(cls, *, params: Params, apply_fn: Callable, tx,
               batch_stats: Optional[Params] = None) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params),
                   apply_fn=apply_fn, tx=tx, batch_stats=batch_stats or {})

    def apply_gradients(self, grads: Params, ok=None,
                        batch_stats: Optional[Params] = None,
                        grad_norm: Optional[torch.Tensor] = None) -> "TrainState":
        """Update in place (skipped where ``ok`` is False), and take
        ``batch_stats`` as the new running statistics under the same
        condition; step advances either way.  ``grad_norm``: the clip's
        global norm of sharded gradients (module docstring)."""
        self.tx.apply(self.params, grads, self.opt_state, ok, grad_norm=grad_norm)
        if batch_stats is not None:
            with torch.no_grad():
                for old, new in tree_zip(self.batch_stats, batch_stats):
                    _commit(old, new, ok)
        self.step += 1
        return self


def create_train_state(generator: Optional[torch.Generator], model, input_shape,
                       tx, *, device=None) -> TrainState:
    """The state of an image model (``models.resnet``, ``inception``,
    ``vgg``): ``model.init(generator, input_shape, device=device)`` gives
    f32 params and BatchNorm statistics (``{}`` without BatchNorm), ``tx``
    its optimizer state, and ``model`` itself is the model function."""
    variables = model.init(generator, input_shape, device=device)
    return TrainState.create(params=variables["params"], apply_fn=model, tx=tx,
                             batch_stats=variables.get("batch_stats", {}))


def shard_state(state: TrainState, layout) -> TrainState:
    """Lay ``state`` out by ``layout`` (a ``parallel.sharding.ParamLayout``)
    IN PLACE: its global params become this rank's slices and the
    optimizer state is made anew on them (its moments take the shards'
    shapes); returns ``state``.  A fresh state only (step 0): a trained
    one restores from a checkpoint instead.  Laying a state out again by
    the same specs does nothing; by others raises."""
    if state.layout is not None:
        if state.layout.specs != layout.specs or state.layout.mesh.shape != layout.mesh.shape:
            raise ValueError("the state is already laid out otherwise")
        return state
    if state.step != 0:
        raise ValueError("shard_state lays out a fresh state (step 0); a "
                         "trained one restores from a checkpoint")
    with torch.no_grad():
        params = layout.shard(tree_map(lambda t: t.detach(), state.params))
    state.params = params
    for leaf in tree_leaves(params):
        if leaf.is_floating_point():
            leaf.requires_grad_(True)
    state.opt_state = state.tx.init(params)
    state.layout = layout
    return state

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

Params are a nested dict of tensors (the model's layout); there are no BN
batch statistics in the port yet (the ResNet is slice 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from distributeddeeplearning_tpu_torch.train.schedule import Schedule

Params = Dict[str, Any]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_zip(tree, *rest):
    """Tuples of corresponding leaves, matched by key along ``tree``'s
    order (the others may have their keys in another order)."""
    if isinstance(tree, dict):
        return [z for k, v in tree.items()
                for z in tree_zip(v, *(r[k] for r in rest))]
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
    def apply(self, params: Params, grads: Params, opt_state, ok=None) -> None:
        b1, b2 = self.b1, self.b2
        g_all = tree_leaves(grads)
        norm = global_norm(g_all) if self.grad_clip_norm else None
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
    def apply(self, params: Params, grads: Params, opt_state, ok=None) -> None:
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
    """Params, optimizer state, step and the model function.

    ``step`` is a host int (the count of train-step calls, skipped updates
    included); the optimizer keeps its own count on the device.  Floating
    param leaves are set to require grad on construction."""

    step: int
    params: Params
    opt_state: Any
    apply_fn: Callable
    tx: Any

    def __post_init__(self):
        for leaf in tree_leaves(self.params):
            if leaf.is_floating_point():
                leaf.requires_grad_(True)

    @classmethod
    def create(cls, *, params: Params, apply_fn: Callable, tx) -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params),
                   apply_fn=apply_fn, tx=tx)

    def apply_gradients(self, grads: Params, ok=None) -> "TrainState":
        """Update in place (skipped where ``ok`` is False); step advances
        either way."""
        self.tx.apply(self.params, grads, self.opt_state, ok)
        self.step += 1
        return self

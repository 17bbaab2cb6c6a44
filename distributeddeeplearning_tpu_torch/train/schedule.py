"""Learning-rate recipes — the port of ``train/schedule.py``.

Pure ``step -> lr`` functions that return the same values as the optax
schedules the reference builds.  Each takes a Python int (and returns a
Python float) or a 0-d integer tensor (and returns a float32 tensor on its
device): the optimizer reads its schedule at a step count that lives on
the device, so a skipped non-finite update needs no host sync.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

Step = Union[int, torch.Tensor]
Schedule = Callable[[Step], Union[float, torch.Tensor]]


def _clip(x, lo, hi):
    if isinstance(x, torch.Tensor):
        return x.clamp(lo, hi).float()
    return min(max(x, lo), hi)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init`` to ``end`` over the steps, held
    at ``end`` after (held at ``init`` if ``transition_steps <= 0``)."""
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step):
        frac = 1 - _clip(step, 0, transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: schedule i+1 takes over at boundary i and
    sees the steps since that boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = _where(step < boundary, out, sched(step - boundary))
        return out

    return schedule


def scale_base_lr(base_lr: float, world_size: int) -> float:
    """Linear LR scaling (Goyal §2.1): lr = base_lr x number of replicas."""
    return base_lr * world_size


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


def goyal_lr_schedule(
    base_lr: float,
    world_size: int,
    steps_per_epoch: int,
    *,
    warmup_epochs: int = 5,
    decay_epochs: Sequence[int] = (30, 60, 80),
    decay_factor: float = 0.1,
) -> Schedule:
    """Linear warmup from ``base_lr`` to ``base_lr x world_size`` over
    ``warmup_epochs``, then /10 at each milestone epoch."""
    peak = scale_base_lr(base_lr, world_size)
    warmup_steps = warmup_epochs * steps_per_epoch
    warmup = linear_schedule(base_lr, peak, max(warmup_steps, 1))
    plateaus = [constant_schedule(peak * decay_factor ** i)
                for i in range(len(decay_epochs) + 1)]
    boundaries = [warmup_steps] + [e * steps_per_epoch for e in decay_epochs]
    return join_schedules([warmup] + plateaus, boundaries)


def warmup_linear_decay_schedule(
    peak_lr: float,
    total_steps: int,
    *,
    warmup_fraction: float = 0.1,
) -> Schedule:
    """Linear warmup from 0 to ``peak_lr`` over the first
    ``warmup_fraction`` of training, then linear decay to 0."""
    warmup_steps = max(int(total_steps * warmup_fraction), 1)
    return join_schedules(
        [
            linear_schedule(0.0, peak_lr, warmup_steps),
            linear_schedule(peak_lr, 0.0, max(total_steps - warmup_steps, 1)),
        ],
        [warmup_steps],
    )

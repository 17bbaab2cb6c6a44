"""Train and eval steps — the port of ``train/step.py`` on one device.

Step contract, as in the reference:

    train_step(state, batch) -> (state, metrics)
    eval_step(state, batch)  -> metrics

with ``batch = {"input" | "image": ..., "label": ...}`` (numpy arrays or
tensors; moved to the parameters' device) and ``metrics`` a dict of 0-d
float32 tensors left on the device: nothing in a step waits for the card,
so the loop decides when to sync.  Where the reference donated the state
to a jitted step, the port updates it IN PLACE and returns the same
object.

One process, one device: there is no mesh.  The implicit data-parallel
gradient all-reduce and the explicit comm-overlap schedule
(``parallel/comms.py``) are ROADMAP item 11; their arguments raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from distributeddeeplearning_tpu_torch.train.schedule import Schedule
from distributeddeeplearning_tpu_torch.train.state import (
    TrainState,
    global_norm,
    tree_leaves,
)

Metrics = Dict[str, torch.Tensor]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in f32, over every
    leading dim.  With ``label_smoothing`` a the target is ``(1 - a) *
    one_hot + a / num_classes`` (``optax.smooth_labels``), written as
    ``lse - (1 - a) * logit[label] - a * mean(logits)`` so no one-hot array
    is built."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None])[..., 0]
    if label_smoothing > 0.0:
        per = (lse - (1.0 - label_smoothing) * tgt
               - label_smoothing * logits.mean(dim=-1))
    else:
        per = lse - tgt
    return per.mean()


def topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of rows whose label is among the top-k logits."""
    k = min(k, logits.shape[-1])
    top = torch.topk(logits.float(), k, dim=-1).indices
    labels = torch.as_tensor(labels, device=logits.device).long()
    return (top == labels[:, None]).any(dim=-1).float().mean()


def classification_metrics(logits, labels, loss) -> Metrics:
    return {
        "loss": loss.float(),
        "top1": topk_correct(logits, labels, 1),
        "top5": topk_correct(logits, labels, 5),
    }


def _device_of(state: TrainState) -> torch.device:
    return tree_leaves(state.params)[0].device


def _to_device(x, device, compute_dtype):
    """Batch array onto ``device``; floating inputs cast to the compute
    dtype, integer inputs (token ids) pass through."""
    t = torch.as_tensor(x, device=device)
    return t.to(compute_dtype) if t.is_floating_point() else t


def _unsupported(**given) -> None:
    for name, value in given.items():
        if value:
            raise NotImplementedError(
                f"build_train_step: {name} is the explicit gradient-comms "
                "schedule (parallel/comms.py), ROADMAP item 11; the port's "
                "step is one process on one device"
            )


def build_train_step(
    state_example: Optional[TrainState] = None,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    label_smoothing: float = 0.0,
    schedule: Optional[Schedule] = None,
    loss_fn: Callable = cross_entropy_loss,
    metrics_fn: Callable = classification_metrics,
    accum_steps: int = 1,
    input_transform: Optional[Callable] = None,
    skip_nonfinite: bool = False,
    comm_overlap: bool = False,
    bucket_mb: float = 4.0,
    comm_dtype: Optional[Any] = None,
    weight_update_sharding: bool = False,
    comm_skip: bool = False,
) -> Callable:
    """The training step: forward, loss, backward, optimizer update.

    ``state_example`` is accepted for signature parity and not needed (the
    port compiles nothing); ``bucket_mb``, as in the reference, only
    matters with ``comm_overlap``, which raises.  ``accum_steps`` > 1 splits the batch into
    microbatches the reference's way, INTERLEAVED (row r goes to microbatch
    r % accum_steps), sums their gradients in f32, scales by
    1/accum_steps and makes one update; metrics are the microbatch means.
    ``skip_nonfinite`` computes the global gradient norm and discards the
    update on the device when it or the loss is not finite (``state.step``
    still advances); the metrics gain ``grad_norm`` and ``anomalous``
    (0/1).  With ``schedule`` the metrics gain ``lr = schedule(step)``.
    """
    del state_example
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _unsupported(comm_overlap=comm_overlap,
                 comm_dtype=comm_dtype not in (None, "f32", "float32"),
                 weight_update_sharding=weight_update_sharding,
                 comm_skip=comm_skip)

    def loss_and_grads(state, inputs, labels):
        logits = state.apply_fn(state.params, inputs)
        loss = loss_fn(logits, labels, label_smoothing=label_smoothing)
        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            metrics = metrics_fn(logits.detach(), labels, loss.detach())
        return list(grads), metrics

    def step(state: TrainState, batch) -> tuple:
        device = _device_of(state)
        inputs = batch.get("image", batch.get("input"))
        if input_transform is not None:
            inputs = input_transform(inputs)
        inputs = _to_device(inputs, device, compute_dtype)
        labels = _to_device(batch["label"], device, compute_dtype)
        if accum_steps == 1:
            grads, metrics = loss_and_grads(state, inputs, labels)
        else:
            n = inputs.shape[0]
            if n % accum_steps:
                raise ValueError(f"global batch {n} not divisible by "
                                 f"accum_steps={accum_steps}")
            grads, stack = None, []
            for i in range(accum_steps):
                g, m = loss_and_grads(state, inputs[i::accum_steps],
                                      labels[i::accum_steps])
                grads = [x.float() for x in g] if grads is None else [
                    a.add_(x.float()) for a, x in zip(grads, g)]
                stack.append(m)
            inv = 1.0 / accum_steps
            grads = [(g * inv).to(p.dtype)
                     for g, p in zip(grads, tree_leaves(state.params))]
            metrics = {k: torch.stack([m[k] for m in stack]).mean()
                       for k in stack[0]}
        lr_step = state.step
        ok = None
        if skip_nonfinite:
            norm = global_norm(grads)
            ok = torch.isfinite(metrics["loss"]) & torch.isfinite(norm)
            metrics["grad_norm"] = norm.float()
            metrics["anomalous"] = 1.0 - ok.float()
        state.apply_gradients(_as_tree(state.params, grads), ok)
        if schedule is not None:
            metrics["lr"] = torch.as_tensor(schedule(lr_step),
                                            dtype=torch.float32, device=device)
        return state, metrics

    return step


def _as_tree(params, leaves):
    """``leaves`` (in :func:`tree_leaves` order) shaped like ``params``."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return next(it)

    return build(params)


def build_eval_step(
    state_example: Optional[TrainState] = None,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    loss_fn: Callable = cross_entropy_loss,
    metrics_fn: Callable = classification_metrics,
    input_transform: Optional[Callable] = None,
) -> Callable:
    """Forward + loss + metrics, no gradient, no state change."""
    del state_example

    @torch.no_grad()
    def step(state: TrainState, batch) -> Metrics:
        device = _device_of(state)
        inputs = batch.get("image", batch.get("input"))
        if input_transform is not None:
            inputs = input_transform(inputs)
        inputs = _to_device(inputs, device, compute_dtype)
        labels = _to_device(batch["label"], device, compute_dtype)
        logits = state.apply_fn(state.params, inputs)
        return metrics_fn(logits, labels, loss_fn(logits, labels))

    return step

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

The model is called as ``state.apply_fn(params, inputs, train=...,
generator=..., **extras)``: ``extras`` are the batch's
:data:`EXTRA_INPUT_KEYS` (BERT's padding mask and token types), split with
the rows under ``accum_steps``; ``train`` is True in the train step and
False in the eval step; ``generator`` is a ``torch.Generator`` on the
parameters' device for dropout, seeded from ``(rng, state.step)`` (the
reference's ``fold_in(rng, step)``), so a resumed run at step k draws
step k's masks again.  The eval step passes ``generator=None``.

A model with BatchNorm statistics (``state.batch_stats`` not empty) is
also given ``batch_stats=``: in the train step it returns ``(outputs,
new_batch_stats)``, which the state takes with the update (under
``accum_steps`` > 1 threaded through the microbatches in order; a skipped
non-finite update keeps the old ones too), and the eval step reads the
running statistics.  ``outputs`` may be a ``(main, aux)`` tuple (an
aux-head model in training): ``loss_fn`` takes it whole and the metrics
read the main head.  Nothing in a step reads a device value on the host.

Mixture-of-experts layers (:mod:`..models.moe`) hand their load-balance
terms to ``moe.sow`` in training; the train step collects them around
each forward (the reference's ``moe_losses`` collection) and adds
``moe_aux_weight`` (default 0.01, Switch Transformer's alpha) times their
sum to the loss it differentiates and reports.  The eval step adds
nothing.

One process, one device: there is no mesh.  The implicit data-parallel
gradient all-reduce and the explicit comm-overlap schedule
(``parallel/comms.py``) are ROADMAP item 11; their arguments raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models import moe
from distributeddeeplearning_tpu_torch.train.schedule import Schedule
from distributeddeeplearning_tpu_torch.train.state import (
    TrainState,
    global_norm,
    tree_leaves,
)

Metrics = Dict[str, torch.Tensor]

# Batch keys forwarded to the model as keyword inputs (transformer models
# take the padding mask alongside the token ids).
EXTRA_INPUT_KEYS = ("attention_mask", "token_type_ids")


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


def _forward(state: TrainState, params, inputs, *, train: bool, generator,
             extras, batch_stats=None):
    """(outputs, new batch_stats, aux) of the model; ``batch_stats``
    overrides the state's (microbatches thread the ones earlier
    microbatches made).  A model without statistics is called as before
    and its (empty) statistics come back unchanged.  ``aux`` is the sum of
    the load-balance terms the model's mixture-of-experts layers sowed in
    training, an f32 tensor, or 0.0 when none did (ref ``train/step.py::
    _forward``)."""
    stats = state.batch_stats if batch_stats is None else batch_stats
    with moe.collect_losses() as terms:
        if not tree_leaves(stats):
            out = state.apply_fn(params, inputs, train=train, generator=generator,
                                 **extras), stats
        else:
            out = state.apply_fn(params, inputs, train=train, generator=generator,
                                 batch_stats=stats, **extras)
            out = out if train else (out, stats)
    aux = 0.0
    for term in terms:
        aux = aux + term.float()
    return (*out, aux)


def _main_head(outputs):
    """The main head of an aux-head model's ``(main, aux)`` outputs."""
    return outputs[0] if isinstance(outputs, tuple) else outputs


def _extras(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=device)
            for k in EXTRA_INPUT_KEYS if k in batch}


def step_generator(rng: int, step: int, device,
                   generator: Optional[torch.Generator] = None) -> torch.Generator:
    """The dropout generator of train step ``step``: seeded from ``(rng,
    step)`` through numpy's SeedSequence, on ``device``.  ``generator`` (on
    ``device``), when given, is reseeded and returned instead of a new one."""
    seed = int(np.random.SeedSequence([rng, step]).generate_state(1, np.uint64)[0])
    if generator is None:
        generator = torch.Generator(device=device)
    return generator.manual_seed(seed)


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
    rng: int = 0,
    moe_aux_weight: float = 0.01,
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
    ``rng`` seeds the per-step dropout generators (:func:`step_generator`).
    ``moe_aux_weight`` weights the mixture-of-experts load-balance terms
    added to the loss.
    """
    del state_example
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _unsupported(comm_overlap=comm_overlap,
                 comm_dtype=comm_dtype not in (None, "f32", "float32"),
                 weight_update_sharding=weight_update_sharding,
                 comm_skip=comm_skip)

    generators: Dict[torch.device, torch.Generator] = {}  # one per device, reseeded

    def loss_and_grads(state, stats, inputs, labels, extras, generator):
        outputs, new_stats, aux = _forward(state, state.params, inputs, train=True,
                                           generator=generator, extras=extras,
                                           batch_stats=stats)
        loss = loss_fn(outputs, labels, label_smoothing=label_smoothing)
        if isinstance(aux, torch.Tensor):
            loss = loss + moe_aux_weight * aux
        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            metrics = metrics_fn(_main_head(outputs).detach(), labels, loss.detach())
        return list(grads), metrics, new_stats

    def step(state: TrainState, batch) -> tuple:
        device = _device_of(state)
        inputs = batch.get("image", batch.get("input"))
        if input_transform is not None:
            inputs = input_transform(inputs)
        inputs = _to_device(inputs, device, compute_dtype)
        labels = _to_device(batch["label"], device, compute_dtype)
        extras = _extras(batch, device)
        generator = generators[device] = step_generator(
            rng, state.step, device, generators.get(device))
        if accum_steps == 1:
            grads, metrics, stats = loss_and_grads(state, state.batch_stats,
                                                   inputs, labels, extras,
                                                   generator)
        else:
            n = inputs.shape[0]
            if n % accum_steps:
                raise ValueError(f"global batch {n} not divisible by "
                                 f"accum_steps={accum_steps}")
            grads, stack, stats = None, [], state.batch_stats
            for i in range(accum_steps):
                g, m, stats = loss_and_grads(
                    state, stats, inputs[i::accum_steps], labels[i::accum_steps],
                    {k: v[i::accum_steps] for k, v in extras.items()},
                    generator)
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
        state.apply_gradients(_as_tree(state.params, grads), ok,
                              batch_stats=stats if tree_leaves(stats) else None)
        if schedule is not None:
            # a fill, not a host-to-device copy: no sync
            metrics["lr"] = torch.full((), schedule(lr_step),
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
    """Forward + loss + metrics, no gradient, no state change (BatchNorm
    reads the running statistics)."""
    del state_example

    @torch.no_grad()
    def step(state: TrainState, batch) -> Metrics:
        device = _device_of(state)
        inputs = batch.get("image", batch.get("input"))
        if input_transform is not None:
            inputs = input_transform(inputs)
        inputs = _to_device(inputs, device, compute_dtype)
        labels = _to_device(batch["label"], device, compute_dtype)
        logits, _, _ = _forward(state, state.params, inputs, train=False,
                                generator=None, extras=_extras(batch, device))
        return metrics_fn(logits, labels, loss_fn(logits, labels))

    return step

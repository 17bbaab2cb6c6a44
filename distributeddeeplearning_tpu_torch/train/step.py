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

Data parallelism (``mesh=`` a :class:`..parallel.mesh.Mesh` of the
process group, one process per device, each step given this rank's rows):

- the implicit path (``comm_overlap=False``) gives the reference's GSPMD
  result: train-mode BatchNorm normalises with the GLOBAL batch's moments
  (``models._convnet.global_batch_moments``: an all-reduce of ``[sum x,
  sum x^2, count]`` autograd flows through), the gradient is the
  global-batch mean through one explicit all-reduce of the gradient tree,
  and the metrics are averaged over the ranks;
- the ``comm_overlap`` path (:class:`CommOverlapStep`) is the reference's
  explicit schedule of ``parallel/comms.py``: each microbatch's bucketed
  reduce-scatter is issued as soon as its gradients exist and waited on
  before it is accumulated, so it overlaps the next microbatch's
  backward; ZeRO weight-update sharding updates this rank's flat shards
  and all-gathers the parameters; the bf16 wire carries error feedback;
  one ``pmean`` carries the metrics and (per-rank BatchNorm, the
  reference's semantics on this path) the statistics.  Its dropout
  generators are seeded from ``(rng, step, microbatch, rank)``, held to
  within-port determinism only.

Without a mesh the step is one process on one device, as before.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models import _convnet, moe
from distributeddeeplearning_tpu_torch.parallel import collectives, comms
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    create_mesh,
    data_parallel_size,
    require_data_only,
)
from distributeddeeplearning_tpu_torch.train.schedule import Schedule
from distributeddeeplearning_tpu_torch.train.state import (
    TrainState,
    _commit,
    global_norm,
    tree_leaves,
    tree_zip,
)

Metrics = Dict[str, torch.Tensor]

COMM_DTYPES = {None: None, "f32": None, "float32": None,
               "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}

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
                   generator: Optional[torch.Generator] = None,
                   salt: tuple = ()) -> torch.Generator:
    """The dropout generator of train step ``step``: seeded from ``(rng,
    step, *salt)`` through numpy's SeedSequence, on ``device``.
    ``generator`` (on ``device``), when given, is reseeded and returned
    instead of a new one.  A data-parallel step salts with the rank (and
    the comm-overlap step with the microbatch)."""
    seed = int(np.random.SeedSequence([rng, step, *salt])
               .generate_state(1, np.uint64)[0])
    if generator is None:
        generator = torch.Generator(device=device)
    return generator.manual_seed(seed)


@torch.no_grad()
def _all_reduce_mean(grads, group, world: int):
    """The gradient leaves summed over ``group`` through ONE all-reduce of
    their f32 concatenation, divided by ``world``, in their dtypes."""
    flat = collectives.all_reduce(torch.cat([g.float().reshape(-1) for g in grads]),
                                  group)
    flat.mul_(1.0 / world)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view(g.shape).to(g.dtype))
        offset += g.numel()
    return out


def build_train_step(
    state_example: Optional[TrainState] = None,
    *,
    mesh=None,
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

    ``state_example`` is needed by the ``comm_overlap`` step (its params
    make the bucket layout) and otherwise only accepted for signature
    parity; ``bucket_mb``, as in the reference, only matters with
    ``comm_overlap``.  ``mesh`` makes the step data-parallel (module
    docstring); the batch it is given is this rank's rows.
    ``comm_overlap``, ``bucket_mb``, ``comm_dtype`` (``COMM_DTYPES``),
    ``weight_update_sharding`` and ``comm_skip`` (timing only: the
    collectives are left out and the numbers are garbage) are the
    reference's; the three last raise without ``comm_overlap``.
    ``accum_steps`` > 1 splits the batch into
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
    require_data_only(mesh, "build_train_step")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if comm_overlap:
        if comm_dtype not in COMM_DTYPES and comm_dtype is not torch.bfloat16:
            raise ValueError(
                f"comm_dtype must be one of "
                f"{sorted(k for k in COMM_DTYPES if k)} or None, "
                f"got {comm_dtype!r}"
            )
        return _build_comm_overlap_step(
            mesh, state_example, compute_dtype=compute_dtype,
            label_smoothing=label_smoothing, schedule=schedule, loss_fn=loss_fn,
            metrics_fn=metrics_fn, rng=rng, moe_aux_weight=moe_aux_weight,
            accum_steps=accum_steps, input_transform=input_transform,
            skip_nonfinite=skip_nonfinite, bucket_mb=bucket_mb,
            comm_dtype=(torch.bfloat16 if comm_dtype is torch.bfloat16
                        else COMM_DTYPES[comm_dtype]),
            weight_update_sharding=weight_update_sharding, comm_skip=comm_skip)
    if weight_update_sharding or comm_skip or comm_dtype not in (
            None, "f32", "float32"):
        # silently dropping these would let an A/B run believe it measured
        # the explicit schedule while running the implicit one
        raise ValueError(
            "weight_update_sharding/comm_skip/comm_dtype require "
            "comm_overlap=True"
        )
    group = None if mesh is None else mesh.group  # None: no collectives
    world = mesh.size if mesh is not None else 1
    salt = () if group is None else (mesh.rank,)

    generators: Dict[torch.device, torch.Generator] = {}  # one per device, reseeded

    def loss_and_grads(state, stats, inputs, labels, extras, generator):
        with _convnet.global_batch_moments(group):
            outputs, new_stats, aux = _forward(state, state.params, inputs,
                                               train=True, generator=generator,
                                               extras=extras, batch_stats=stats)
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
            rng, state.step, device, generators.get(device), salt)
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
        if group is not None:
            # the global-batch mean gradient and metrics (equal rows a rank)
            grads = _all_reduce_mean(grads, group, world)
            metrics = collectives.pmean(metrics, group)
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


class CommOverlapStep:
    """The ``comm_overlap`` train step: callable as ``step(state, batch)``
    like the implicit one, plus the comm-layout plumbing callers need:
    :meth:`prepare_state` turns a fresh ``TrainState`` into the layout this
    step trains and checkpoints (call it once before the first step; the
    prepared state is the restore template), and :meth:`wire_bytes` is the
    analytic bytes-on-wire model."""

    def __init__(self, fn, mesh, layout, *, comm_dtype, weight_update_sharding,
                 accum_steps):
        self._fn = fn
        self.mesh = mesh
        self.layout = layout
        self.comm_dtype = comm_dtype
        self.weight_update_sharding = weight_update_sharding
        self.accum_steps = accum_steps
        self.comm_overlap = True

    def __call__(self, state, batch):
        return self._fn(state, batch)

    def prepare_state(self, state):
        return comms.prepare_comm_state(
            self.mesh, state, self.layout,
            weight_update_sharding=self.weight_update_sharding,
            comm_dtype=self.comm_dtype)

    def wire_bytes(self) -> Dict[str, int]:
        return comms.ring_wire_bytes(
            self.layout, comm_dtype=self.comm_dtype,
            weight_update_sharding=self.weight_update_sharding,
            accum_steps=self.accum_steps)


def _build_comm_overlap_step(mesh, state_example, *, compute_dtype,
                             label_smoothing, schedule, loss_fn, metrics_fn, rng,
                             moe_aux_weight, accum_steps, input_transform,
                             skip_nonfinite, bucket_mb, comm_dtype,
                             weight_update_sharding, comm_skip) -> CommOverlapStep:
    """The explicit-comms train step (ref ``_build_comm_overlap_step``);
    ``build_train_step``'s docstring and the module docstring say what it
    does."""
    if state_example is None:
        raise ValueError("comm_overlap needs state_example: its params make "
                         "the bucket layout")
    mesh = mesh if mesh is not None else create_mesh()
    n_shards = data_parallel_size(mesh)
    group, rank = mesh.group, mesh.rank
    layout = comms.BucketLayout.for_tree(
        state_example.params, bucket_bytes=max(int(bucket_mb * 2**20), 4),
        shards=n_shards)
    generators: Dict[torch.device, torch.Generator] = {}

    def scatter(grad_tree, res):
        """Handles of this microbatch's reduce-scattered shards (in
        flight), and the new residuals."""
        buckets = layout.to_buckets(grad_tree)
        if comm_skip:  # timing only: no collective, garbage numbers
            return [collectives.Pending(None, layout.shard_slice(b, rank), b.device)
                    for b in buckets], res
        if comm_dtype is None:
            return comms.reduce_scatter_buckets(buckets, group, async_op=True)[0], res
        return comms.reduce_scatter_buckets(
            buckets, group, comm_dtype=comm_dtype, residuals=res,
            shards=n_shards, async_op=True)

    def gather(shards):
        if comm_skip:
            return torch.cat([s.repeat(n_shards) for s in shards])
        return comms.gather_flat(shards, group)

    def step(state: TrainState, batch) -> tuple:
        opt = state.opt_state
        if not comms.is_prepared(opt):
            raise ValueError("the comm_overlap step trains the comm layout: "
                             "state = step.prepare_state(state) first")
        device = _device_of(state)
        inputs = batch.get("image", batch.get("input"))
        if input_transform is not None:
            inputs = input_transform(inputs)
        inputs = _to_device(inputs, device, compute_dtype)
        labels = _to_device(batch["label"], device, compute_dtype)
        extras = _extras(batch, device)
        local = inputs.shape[0]
        if local % accum_steps:
            raise ValueError(
                f"global batch {local * n_shards} not divisible by "
                f"data shards x accum_steps = {n_shards} x {accum_steps}")
        params = state.params
        leaves = tree_leaves(params)
        has_stats = bool(tree_leaves(state.batch_stats))
        opt_base, residuals = opt["base"], opt["residual"]

        def loss_and_grads(stats, mb_inputs, mb_labels, mb_extras, generator):
            outputs, new_stats, aux = _forward(state, params, mb_inputs, train=True,
                                               generator=generator,
                                               extras=mb_extras, batch_stats=stats)
            loss = loss_fn(outputs, mb_labels, label_smoothing=label_smoothing)
            if isinstance(aux, torch.Tensor):
                # sown aux terms are global sums in the implicit path: the
                # local partial scales by the shard count
                loss = loss + moe_aux_weight * aux * n_shards
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                metrics = metrics_fn(_main_head(outputs).detach(), mb_labels,
                                     loss.detach())
            return _as_tree(params, grads), metrics, new_stats

        acc, pending, stack = None, None, []
        stats, res = state.batch_stats, residuals
        for i in range(accum_steps):
            # the strided split of the LOCAL rows (row l -> microbatch
            # l % accum): the global strided microbatches, rank by rank
            rows = slice(i, None, accum_steps) if accum_steps > 1 else slice(None)
            generator = generators[device] = step_generator(
                rng, state.step, device, generators.get(device), (i, rank))
            g, m, stats = loss_and_grads(stats, inputs[rows], labels[rows],
                                         {k: v[rows] for k, v in extras.items()},
                                         generator)
            stack.append(m)
            # the previous microbatch's reduce-scatter ran under this one's
            # backward; it lands before it is accumulated
            if pending is not None:
                acc = _accumulate(acc, pending)
            with torch.no_grad():
                pending, res = scatter(g, res)
        acc = _accumulate(acc, pending)
        scale = 1.0 / (n_shards * accum_steps)
        g_shards = tuple(s * scale for s in acc)
        local_metrics = (stack[0] if accum_steps == 1 else
                         {k: torch.stack([m[k] for m in stack]).mean()
                          for k in stack[0]})

        # ONE collective for the metrics and the per-rank BatchNorm
        # statistics (the reference's per-GPU BN on this path)
        payload = {"metrics": local_metrics}
        if has_stats:
            payload["stats"] = stats
        reduced = payload if comm_skip else collectives.pmean(payload, group)
        metrics = dict(reduced["metrics"])
        out_stats = reduced["stats"] if has_stats else None

        ok = None
        if skip_nonfinite:
            sq = sum(torch.sum(torch.square(x)).float() for x in g_shards)
            if not comm_skip:
                sq = collectives.all_reduce(sq.clone(), group)
            grad_norm = torch.sqrt(sq)
            ok = torch.isfinite(metrics["loss"]) & torch.isfinite(grad_norm)
            metrics["grad_norm"] = grad_norm.float()
            metrics["anomalous"] = 1.0 - ok.float()

        tx = state.tx
        with torch.no_grad():
            if weight_update_sharding:
                # ZeRO: this rank updates its 1/N flat parameter shard (the
                # optimizer's buffers are flat shards too), then gathers
                p_shards = tuple(layout.shard_slice(b, rank)
                                 for b in layout.to_buckets(params))
                tx.apply(p_shards, g_shards, opt_base, ok)
                layout.write_flat(params, gather(p_shards))
            else:
                tx.apply(params, layout.from_flat(gather(g_shards)), opt_base, ok)
            if comm_dtype is not None:
                for old, new in zip(residuals, res):
                    _commit(old, new, ok)
            if has_stats:
                for old, new in tree_zip(state.batch_stats, out_stats):
                    _commit(old, new, ok)
        lr_step = state.step
        state.step += 1
        if schedule is not None:
            metrics["lr"] = torch.full((), schedule(lr_step), dtype=torch.float32,
                                       device=device)
        return state, metrics

    return CommOverlapStep(step, mesh, layout, comm_dtype=comm_dtype,
                           weight_update_sharding=weight_update_sharding,
                           accum_steps=accum_steps)


def _accumulate(acc, pending):
    """``acc + shards`` (the shards of ``pending`` waited on here)."""
    shards = [p.wait() for p in pending]
    return shards if acc is None else [a + s for a, s in zip(acc, shards)]


def build_eval_step(
    state_example: Optional[TrainState] = None,
    *,
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    loss_fn: Callable = cross_entropy_loss,
    metrics_fn: Callable = classification_metrics,
    input_transform: Optional[Callable] = None,
) -> Callable:
    """Forward + loss + metrics, no gradient, no state change (BatchNorm
    reads the running statistics).  With a ``mesh`` each rank evaluates
    its rows and the metrics are the global batch's means (each rank's
    weighted by its rows)."""
    require_data_only(mesh, "build_eval_step")
    del state_example
    group = None if mesh is None else mesh.group

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
        metrics = metrics_fn(logits, labels, loss_fn(logits, labels))
        if group is None:
            return metrics
        rows = float(inputs.shape[0])
        summed = collectives.psum(
            {"m": {k: v.float() * rows for k, v in metrics.items()},
             "rows": torch.full((), rows, dtype=torch.float32, device=device)},
            group)
        return {k: v / summed["rows"] for k, v in summed["m"].items()}

    return step

"""Causal-LM training workload — the port of ``workloads/transformer.py``.

``main()`` trains :mod:`..models.pipelined_transformer` on synthetic
next-token batches (fixed-seed random tokens; the loss is the shifted
cross-entropy) with AdamW, global-norm clipping and a warmup + linear
decay schedule, through the port's train step and :class:`Trainer`: the
reference's ``pipe = seq = 1`` geometries, on one device or over the
processes of a ``torch.distributed`` group (``distributed=True``, one
process per device; see :mod:`._runner` for the ``torchrun`` launch):
data-parallel, ZeRO-3 over ``fsdp`` and Megatron over ``tensor``, the
two composed as the reference composes them (its rules and logical axes:
``models.pipelined_transformer.LOGICAL_AXES`` under ``train_rules``;
the vocabulary over fsdp, the block widths over tensor when ``tensor`` >
1, else over fsdp).  With ``attention="flash"`` every layer runs the
hand-written flash forward kernel and, in backward, the dQ and dK/dV
kernels, each rank on its own rows and, under ``tensor``, its own heads
(``make_flash_attention(mesh=..., causal=True)``).

As in the reference, ``batch_size`` is per data shard: the global batch
is ``batch_size x data shards`` (``data x fsdp``), each rank takes
``batch_size`` rows a step from its data shard's stream, and the
implicit path or the explicit gradient comms (``comm_overlap``,
``bucket_mb``, ``comm_dtype``, ``weight_update_sharding``; pure data
parallelism only, and weight-update sharding with a global-norm clip is
refused, as in the reference) carry the gradients.  One departure: the
reference seeds each process's stream ``seed + process_index``; here the
stream is seeded ``seed + data shard`` (``Mesh.data_index``), so the
tensor ranks of one shard see the same rows.  Under pure data
parallelism that is ``seed + rank``, as before.  Every rank draws the
same global weights and keeps its slice.

Arguments keep the reference's names and defaults, plus ``device``
(``"cuda"`` unless asked for the CPU).  What the slice does not take
raises, naming where it comes: pipeline and sequence parallelism and
ring attention (A7), multi-slice meshes (A5.3).
``save_filepath`` and ``checkpoint_every_steps`` checkpoint and resume
through the trainer's :class:`..train.checkpoint.Checkpointer` (with a
``save_filepath`` the preemption guard is on: SIGTERM or an injected
``preempt`` writes an emergency checkpoint and the run exits 75);
``tensorboard_dir``, ``profile_dir``, ``skip_nonfinite``,
``anomaly_max_consecutive``, ``anomaly_rollback`` and ``step_deadline_s``
reach the :class:`..train.loop.Trainer` as in the reference.  Weights are
drawn from ``torch.Generator().manual_seed(seed)`` and so differ from the
reference's ``jax.random`` draws.

    python -m distributeddeeplearning_tpu_torch.workloads.transformer --epochs 1
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger("ddlt.workloads.transformer")


def _token_batches(
    per_host_batch: int,
    seq_len: int,
    vocab_size: int,
    seed: int,
    length: int,
    repeat: bool,
) -> Iterator:
    """Deterministic synthetic LM batches: {"input": toks, "label": toks}
    (the causal shift happens inside the loss) — the same numpy stream as
    the reference's, batch for batch."""
    rng = np.random.default_rng(seed)
    n_batches = max(length // per_host_batch, 1)
    epoch = [
        rng.integers(0, vocab_size, (per_host_batch, seq_len)).astype(np.int32)
        for _ in range(n_batches)
    ]
    while True:
        for toks in epoch:
            yield {"input": toks, "label": toks}
        if not repeat:
            return


def _refuse(**given) -> None:
    """Raise for each argument the single-device slice does not take."""
    where = {
        "pipe": "pipeline parallelism (ROADMAP A7)",
        "seq": "sequence parallelism (ROADMAP A7)",
        "num_slices": "multi-slice data parallelism (ROADMAP A5.3)",
        "sp_block_k": "ring attention (ROADMAP A7)",
        "scan_unroll": "nothing: it is an XLA scan-unroll compile hint with "
                       "no eager counterpart",
    }
    for name, bad in given.items():
        if bad:
            raise NotImplementedError(
                f"transformer workload: {name} is not taken by the port "
                f"yet; it belongs to {where[name]}"
            )


def main(
    *,
    epochs: int = 3,
    batch_size: int = 8,
    seq_len: int = 128,
    vocab_size: int = 1031,
    num_layers: int = 8,
    d_model: int = 256,
    num_heads: int = 8,
    d_ff: int = 1024,
    base_lr: float = 3e-4,
    warmup_fraction: float = 0.1,
    weight_decay: float = 0.01,
    grad_clip_norm: float = 1.0,
    accum_steps: int = 1,
    train_examples: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
    save_filepath: Optional[str] = None,
    tensorboard_dir: Optional[str] = None,
    resume: bool = True,
    profile_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    checkpoint_every_steps: Optional[int] = None,
    seed: int = 42,
    compute_dtype: str = "bfloat16",
    distributed: Optional[bool] = None,
    data_format: str = "synthetic",
    pipe: int = 1,
    seq: int = 1,
    fsdp: int = 1,
    tensor: int = 1,
    num_slices: int = 1,
    num_microbatches: int = 8,  # only read by pipe > 1, as in the reference
    remat: bool = False,
    loss_chunk: Optional[int] = None,
    scan_unroll: int = 1,
    attention: str = "dense",
    sp_block_k: Optional[int] = None,
    comm_overlap: bool = False,
    bucket_mb: float = 4.0,  # only read by comm_overlap, as in the reference
    comm_dtype: Optional[str] = None,
    weight_update_sharding: bool = False,
    skip_nonfinite: bool = False,
    anomaly_max_consecutive: Optional[int] = None,
    anomaly_rollback: bool = False,
    step_deadline_s: Optional[float] = None,
    device: str = "cuda",
):
    """Train; returns ``(state, FitResult)``."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        ATTENTIONS,
        LOGICAL_AXES,
        forward,
        init_params,
        next_token_loss,
        per_token_loss,
        train_rules,
    )
    from distributeddeeplearning_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from distributeddeeplearning_tpu_torch.parallel import (
        MeshSpec,
        ParamLayout,
        create_mesh,
        data_parallel_size,
        initialize,
    )
    from distributeddeeplearning_tpu_torch.train.loop import (
        Trainer,
        TrainerConfig,
    )
    from distributeddeeplearning_tpu_torch.train.schedule import (
        warmup_linear_decay_schedule,
    )
    from distributeddeeplearning_tpu_torch.train.state import (
        TrainState,
        adamw,
        shard_state,
        tree_map,
    )
    from distributeddeeplearning_tpu_torch.train.step import (
        build_eval_step,
        build_train_step,
        topk_correct,
    )

    if data_format != "synthetic":
        raise ValueError("the transformer LM workload is synthetic-data only "
                         f"(got data_format={data_format!r})")
    if fsdp > 1 and (vocab_size % fsdp or d_model % fsdp or d_ff % fsdp):
        raise ValueError(
            f"fsdp={fsdp} must divide vocab_size ({vocab_size}), "
            f"d_model ({d_model}) and d_ff ({d_ff})"
        )
    if tensor > 1 and (d_model % tensor or d_ff % tensor or num_heads % tensor):
        raise ValueError(
            f"tensor={tensor} must divide d_model ({d_model}), "
            f"d_ff ({d_ff}) and num_heads ({num_heads})"
        )
    if comm_overlap:
        if pipe > 1 or seq > 1 or fsdp > 1 or tensor > 1:
            raise ValueError(
                "comm_overlap is the explicit replicated-params DP "
                "schedule; it does not compose with pipe/seq/fsdp/tensor"
            )
        if weight_update_sharding and grad_clip_norm:
            raise ValueError(
                "weight_update_sharding applies the optimizer per gradient "
                "shard, so optax.clip_by_global_norm would clip by the "
                "SHARD norm — pass --grad_clip_norm 0 with "
                "--weight_update_sharding"
            )
    _refuse(pipe=pipe != 1, seq=seq != 1, num_slices=num_slices != 1, sp_block_k=sp_block_k is not None,
            scan_unroll=scan_unroll != 1)
    if attention not in ATTENTIONS:
        raise NotImplementedError(
            f"attention={attention!r}: the port takes {ATTENTIONS}; ring and "
            "ulysses sequence-parallel attention are ROADMAP A7"
        )
    ctx = initialize(force=distributed, device=device)
    dev = ctx.device
    mesh = create_mesh(MeshSpec(fsdp=fsdp, tensor=tensor))
    dp_mesh = mesh if mesh.group is not None else None
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    data_shards = data_parallel_size(mesh)
    global_batch = batch_size * data_shards
    shard = mesh.data_index()  # this rank's data shard: its stream's seed
    n_train = train_examples or 25_000
    spe = steps_per_epoch or max(n_train // global_batch, 1)
    total_steps = spe * epochs
    if ctx.is_primary:
        logger.info("training %d-layer LM on %s: %d ranks (data=%d fsdp=%d "
                    "tensor=%d), global batch %d, %d steps/epoch, %d epochs",
                    num_layers, dev, mesh.size, mesh.shape["data"], fsdp,
                    tensor, global_batch, spe, epochs)
    attention_fn = (make_flash_attention(mesh=mesh, causal=True)
                    if attention == "flash" and dp_mesh is not None else None)

    params = init_params(
        torch.Generator().manual_seed(seed), num_layers=num_layers,
        d_model=d_model, num_heads=num_heads, d_ff=d_ff,
        vocab_size=vocab_size, max_len=seq_len, device=dev,
    )

    # every rank drew the same global weights and keeps its slice of the
    # LM's training layout, which the model reads its splits from
    # (comm_overlap is replicated-params only: the rules exist for the
    # fsdp/tensor geometries it excludes)
    layout = (None if comm_overlap or dp_mesh is None else ParamLayout.from_rules(
        dp_mesh, params, train_rules(tensor), LOGICAL_AXES))

    def apply_fn(p, tokens, **_):
        # the step's train/generator keywords: the LM has no dropout
        p = tree_map(lambda a: a.to(dtype), p)  # no copy when already f32
        if loss_chunk:
            # "logits" are the per-position losses [b, s-1]; the full
            # [b, s, vocab] logits never exist
            return per_token_loss(p, tokens, num_heads=num_heads,
                                  attention=attention, remat=remat,
                                  loss_chunk=loss_chunk,
                                  attention_fn=attention_fn, layout=layout)
        return forward(p, tokens, num_heads=num_heads, attention=attention,
                       remat=remat, attention_fn=attention_fn,
                       layout=layout).float()

    schedule = warmup_linear_decay_schedule(
        base_lr, total_steps, warmup_fraction=warmup_fraction)
    state = TrainState.create(
        params=params, apply_fn=apply_fn,
        tx=adamw(schedule, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm),
    )
    if layout is not None:
        shard_state(state, layout)

    if loss_chunk:
        def lm_loss(losses, labels, *, label_smoothing: float = 0.0):
            del label_smoothing
            return losses.mean()

        def lm_metrics(losses, tokens, loss):
            return {"loss": loss.float(), "perplexity": torch.exp(loss).float()}
    else:
        def lm_loss(logits, labels, *, label_smoothing: float = 0.0):
            del label_smoothing  # the LM loss has no smoothing knob
            return next_token_loss(logits, labels)

        def lm_metrics(logits, tokens, loss):
            b, s = tokens.shape
            flat = logits[:, :-1].reshape(b * (s - 1), -1)
            targets = tokens[:, 1:].reshape(b * (s - 1))
            return {"loss": loss.float(), "top1": topk_correct(flat, targets, 1),
                    "perplexity": torch.exp(loss).float()}

    train_step = build_train_step(
        state, mesh=dp_mesh, schedule=schedule, compute_dtype=dtype,
        loss_fn=lm_loss, metrics_fn=lm_metrics, accum_steps=accum_steps,
        skip_nonfinite=skip_nonfinite, comm_overlap=comm_overlap,
        bucket_mb=bucket_mb, comm_dtype=comm_dtype,
        weight_update_sharding=weight_update_sharding,
    )
    if comm_overlap:
        # the prepared state doubles as the checkpoint restore template
        state = train_step.prepare_state(state)
    eval_step = build_eval_step(state, mesh=dp_mesh, compute_dtype=dtype,
                                loss_fn=lm_loss, metrics_fn=lm_metrics)
    train_iter = _token_batches(batch_size, seq_len, vocab_size, seed + shard,
                                n_train, repeat=True)

    def eval_factory():
        return _token_batches(batch_size, seq_len, vocab_size,
                              seed + 7000 + shard,
                              min(n_train, 4 * global_batch), repeat=False)

    trainer = Trainer(
        train_step,
        eval_step=eval_step,
        config=TrainerConfig(
            epochs=epochs,
            steps_per_epoch=spe,
            global_batch_size=global_batch,
            checkpoint_dir=save_filepath,
            tensorboard_dir=tensorboard_dir,
            resume=resume,
            profile_dir=profile_dir,
            metrics_path=metrics_path,
            checkpoint_every_steps=checkpoint_every_steps,
            anomaly_max_consecutive=anomaly_max_consecutive,
            anomaly_rollback=anomaly_rollback,
            step_deadline_s=step_deadline_s,
        ),
        mesh=dp_mesh,
    )
    return trainer.fit(state, train_iter, eval_factory)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    from distributeddeeplearning_tpu_torch.workloads._runner import run_from_argv

    run_from_argv(main)

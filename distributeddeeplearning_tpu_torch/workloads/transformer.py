"""Causal-LM training workload — the port of ``workloads/transformer.py``.

``main()`` trains :mod:`..models.pipelined_transformer` on synthetic
next-token batches (fixed-seed random tokens; the loss is the shifted
cross-entropy) with AdamW, global-norm clipping and a warmup + linear
decay schedule, through the port's train step and :class:`Trainer`, on
one device: the reference's ``pipe = seq = fsdp = tensor = 1`` geometry,
its single-chip LM trainer.  With ``attention="flash"`` every layer runs
the hand-written flash forward kernel and, in backward, the dQ and dK/dV
kernels.

Arguments keep the reference's names and defaults, plus ``device``
(``"cuda"`` unless asked for the CPU).  What the slice does not take
raises, naming where it comes: the parallel geometries and the gradient
comms (ROADMAP item 11), sequence-parallel attention (slice 8),
checkpoints, TensorBoard, profiling and the resilience knobs (item 12's
remainder).  Weights are drawn from ``torch.Generator().manual_seed(seed)``
and so differ from the reference's ``jax.random`` draws.
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
        "pipe": "pipeline parallelism (slice 8)",
        "seq": "sequence parallelism (slice 8)",
        "fsdp": "FSDP parameter sharding (ROADMAP item 11)",
        "tensor": "tensor parallelism (slice 7)",
        "num_slices": "multi-slice data parallelism (ROADMAP item 11)",
        "distributed": "multi-process training (ROADMAP item 11)",
        "comm_overlap": "the gradient-comms schedule (ROADMAP item 11)",
        "weight_update_sharding": "the gradient-comms schedule (ROADMAP item 11)",
        "comm_dtype": "the gradient-comms schedule (ROADMAP item 11)",
        "sp_block_k": "ring attention (slice 8)",
        "scan_unroll": "nothing: it is an XLA scan-unroll compile hint with "
                       "no eager counterpart",
    }
    for name, bad in given.items():
        if bad:
            raise NotImplementedError(
                f"transformer workload: {name} is not taken by the port's "
                f"single-device slice; it belongs to {where[name]}"
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
    from distributeddeeplearning_tpu_torch._device import resolve_device
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        ATTENTIONS,
        forward,
        init_params,
        next_token_loss,
        per_token_loss,
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
    _refuse(pipe=pipe != 1, seq=seq != 1, fsdp=fsdp != 1, tensor=tensor != 1,
            num_slices=num_slices != 1, distributed=bool(distributed),
            comm_overlap=comm_overlap,
            weight_update_sharding=weight_update_sharding,
            comm_dtype=comm_dtype not in (None, "f32", "float32"),
            sp_block_k=sp_block_k is not None, scan_unroll=scan_unroll != 1)
    if attention not in ATTENTIONS:
        raise NotImplementedError(
            f"attention={attention!r}: the port takes {ATTENTIONS}; ring and "
            "ulysses sequence-parallel attention are slice 8"
        )
    dev = resolve_device(device)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    global_batch = batch_size
    n_train = train_examples or 25_000
    spe = steps_per_epoch or max(n_train // global_batch, 1)
    total_steps = spe * epochs
    logger.info("training %d-layer LM on %s: batch %d, %d steps/epoch, "
                "%d epochs", num_layers, dev, global_batch, spe, epochs)

    params = init_params(
        torch.Generator().manual_seed(seed), num_layers=num_layers,
        d_model=d_model, num_heads=num_heads, d_ff=d_ff,
        vocab_size=vocab_size, max_len=seq_len, device=dev,
    )

    def apply_fn(p, tokens):
        p = tree_map(lambda a: a.to(dtype), p)  # no copy when already f32
        if loss_chunk:
            # "logits" are the per-position losses [b, s-1]; the full
            # [b, s, vocab] logits never exist
            return per_token_loss(p, tokens, num_heads=num_heads,
                                  attention=attention, remat=remat,
                                  loss_chunk=loss_chunk)
        return forward(p, tokens, num_heads=num_heads, attention=attention,
                       remat=remat).float()

    schedule = warmup_linear_decay_schedule(
        base_lr, total_steps, warmup_fraction=warmup_fraction)
    state = TrainState.create(
        params=params, apply_fn=apply_fn,
        tx=adamw(schedule, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm),
    )

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
        state, schedule=schedule, compute_dtype=dtype, loss_fn=lm_loss,
        metrics_fn=lm_metrics, accum_steps=accum_steps,
        skip_nonfinite=skip_nonfinite, bucket_mb=bucket_mb,
    )
    eval_step = build_eval_step(state, compute_dtype=dtype, loss_fn=lm_loss,
                                metrics_fn=lm_metrics)
    train_iter = _token_batches(global_batch, seq_len, vocab_size, seed,
                                n_train, repeat=True)

    def eval_factory():
        return _token_batches(global_batch, seq_len, vocab_size, seed + 7000,
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
    )
    return trainer.fit(state, train_iter, eval_factory)

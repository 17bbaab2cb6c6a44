"""BERT fine-tune workload — the port of ``workloads/bert.py``.

``main()`` fine-tunes :mod:`..models.bert` for sequence classification on
synthetic tokenized text (:class:`..data.synthetic.SyntheticTextDataset`:
random ids, a random length per example, the rest padding, so every batch
carries a real key-padding mask) with AdamW, global-norm clipping and a
linear warmup then linear decay, through the port's train step and
:class:`Trainer`, on one device or over the processes of a
``torch.distributed`` group (``distributed=True``, one process per
device, the implicit step): data-parallel, and over the reference's model
axes ``fsdp``, ``tensor`` and ``expert`` with its mesh, its rule choice
(``RULES_TP`` when ``tensor`` > 1, else ``RULES_FSDP`` when ``fsdp`` > 1,
else ``RULES_DP``; ``RULES_EP`` appended with experts) and its batch of
``batch_size`` rows a data shard (``data x fsdp`` shards).  Every rank
draws the same global weights and keeps its slice of that layout, which
the model reads its splits from (``models.bert``'s ``layout=``).  The
ranks of data shard d read the reference's synthetic stream of seed
``seed + 1000 d`` (under pure data parallelism d is the process index,
the reference's host r's stream).  ``attention="flash"`` runs every layer's attention through the
hand-written flash kernels with the padding mask as their key-padding
bias, forward and backward; ``"default"`` (and ``"auto"``, as at ``seq=1``
in the reference) the reference's plain attention.  ``num_experts`` > 0
makes every second layer's FFN a mixture of experts (:mod:`..models.moe`),
whose load-balance term the train step adds to the loss at weight 0.01;
``save_filepath`` checkpoints (each epoch end) and resumes through the
trainer's :class:`..train.checkpoint.Checkpointer`, with the preemption
guard on (exit 75 under ``python -m``); ``tensorboard_dir`` and
``profile_dir`` reach the :class:`..train.loop.Trainer`.

Arguments keep the reference's names and defaults, plus ``device``
(``"cuda"`` unless asked for the CPU).  What the slice does not take
raises, naming its ROADMAP item.  Weights are drawn from
``torch.Generator().manual_seed(seed)`` and so differ from the reference's
``jax.random`` draws; dropout draws from the train step's per-step
generators, seeded from ``seed + 1`` as the reference's step rng is.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

logger = logging.getLogger("ddlt.workloads.bert")


def _refuse(**given) -> None:
    """Raise for each argument the port does not take yet."""
    where = {
        "tfrecords": "the TFRecord text reader and data/text.py (ROADMAP A7e)",
        "attention": "sequence-parallel attention, ring and ulysses (ROADMAP A7d)",
        "seq": "sequence parallelism (ROADMAP A7d)",
        "num_slices": "multi-slice data parallelism (ROADMAP A5.3)",
        "sp_block_k": "ring attention's blocked loop (ROADMAP A7d)",
    }
    for name, bad in given.items():
        if bad:
            raise NotImplementedError(
                f"bert workload: {name} is not taken by the port yet; it "
                f"belongs to {where[name]}"
            )


def _batches(per_host_batch: int, seq_len: int, vocab_size: int,
             num_classes: int, seed: int, length: int,
             is_training: bool) -> Iterator:
    """The reference's synthetic batches: one epoch of the dataset, repeated
    forever for training."""
    from distributeddeeplearning_tpu_torch.data.synthetic import (
        SyntheticTextDataset,
    )

    ds = SyntheticTextDataset(length=length, seq_len=seq_len,
                              vocab_size=vocab_size, num_classes=num_classes,
                              seed=seed)
    if len(ds) < per_host_batch:
        raise ValueError(
            f"synthetic dataset length {len(ds)} yields zero batches at "
            f"per-host batch size {per_host_batch}"
        )
    if not is_training:
        return ds.batches(per_host_batch)

    def epochs() -> Iterator:
        while True:
            yield from ds.batches(per_host_batch)

    return epochs()


def main(
    *,
    model: str = "bert-base",
    data_format: str = "synthetic",
    training_data_path: Optional[str] = None,
    validation_data_path: Optional[str] = None,
    epochs: int = 3,
    batch_size: int = 8,
    seq_len: int = 128,
    num_classes: int = 2,
    vocab_size: int = 30522,
    base_lr: float = 3e-5,
    warmup_fraction: float = 0.1,
    weight_decay: float = 0.01,
    grad_clip_norm: float = 1.0,
    accum_steps: int = 1,
    dropout_rate: float = 0.1,
    train_examples: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
    save_filepath: Optional[str] = None,
    tensorboard_dir: Optional[str] = None,
    resume: bool = True,
    profile_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    seed: int = 42,
    compute_dtype: str = "bfloat16",
    distributed: Optional[bool] = None,
    num_slices: int = 1,
    fsdp: int = 1,
    tensor: int = 1,
    seq: int = 1,
    expert: int = 1,
    attention: str = "auto",
    sp_block_k: Optional[int] = None,
    remat: str = "none",
    num_experts: int = 0,
    num_layers: Optional[int] = None,
    hidden_size: Optional[int] = None,
    num_heads: Optional[int] = None,
    intermediate_size: Optional[int] = None,
    max_position_embeddings: Optional[int] = None,
    device: str = "cuda",
):
    """Fine-tune; returns ``(state, FitResult)``."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.models.bert import (
        dot_product_attention,
        logical_axes,
    )
    from distributeddeeplearning_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from distributeddeeplearning_tpu_torch.parallel import (
        RULES_DP,
        RULES_EP,
        RULES_FSDP,
        RULES_TP,
        MeshSpec,
        ParamLayout,
        create_mesh,
        data_parallel_size,
        initialize,
        replicate_params,
    )
    from distributeddeeplearning_tpu_torch.train.loop import Trainer, TrainerConfig
    from distributeddeeplearning_tpu_torch.train.schedule import (
        warmup_linear_decay_schedule,
    )
    from distributeddeeplearning_tpu_torch.train.state import (
        TrainState,
        adamw,
        shard_state,
    )
    from distributeddeeplearning_tpu_torch.train.step import (
        build_eval_step,
        build_train_step,
    )

    if data_format not in ("synthetic", "tfrecords"):
        raise ValueError(f"unknown data_format {data_format!r}")
    _refuse(tfrecords=data_format == "tfrecords",
            attention=attention in ("ring", "ulysses", "ulysses-flash"),
            seq=seq != 1, num_slices=num_slices != 1,
            sp_block_k=sp_block_k is not None)
    # the reference's checks and words (ref workloads/bert.py:150-155)
    if expert > 1 and num_experts == 0:
        raise ValueError("expert-axis sharding needs --num_experts > 0")
    if num_experts and expert > 1 and num_experts % expert != 0:
        raise ValueError(
            f"num_experts {num_experts} not divisible by expert axis {expert}")
    ctx = initialize(force=distributed, device=device)
    dev = ctx.device
    mesh = create_mesh(MeshSpec(fsdp=fsdp, tensor=tensor, expert=expert))
    dp_mesh = mesh if mesh.group is not None else None
    model_axes = fsdp > 1 or tensor > 1 or expert > 1
    if attention == "auto":
        attention = "default"  # the reference's choice at seq = 1
    if attention == "flash":
        attention_fn = make_flash_attention(mesh=dp_mesh)
    elif attention == "default":
        attention_fn = dot_product_attention
    else:
        raise ValueError(f"unknown attention mode {attention!r}")
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    global_batch = batch_size * data_parallel_size(mesh)  # data x fsdp shards
    shard = mesh.data_index()  # this rank's data shard: its stream's seed
    n_train = train_examples or 25_000
    spe = steps_per_epoch or max(n_train // global_batch, 1)
    total_steps = spe * epochs
    if ctx.is_primary:
        logger.info("fine-tuning %s on %s: %d ranks (data=%d fsdp=%d tensor=%d "
                    "expert=%d), global batch %d, %d steps/epoch, %d epochs, "
                    "attention %s", model, dev, mesh.size, mesh.shape["data"],
                    fsdp, tensor, expert, global_batch, spe, epochs, attention)

    model_kwargs = dict(num_classes=num_classes, vocab_size=vocab_size,
                        dropout_rate=dropout_rate, dtype=dtype, remat=remat,
                        attention_fn=attention_fn, num_experts=num_experts)
    for key, value in (
        ("num_layers", num_layers),
        ("hidden_size", hidden_size),
        ("num_heads", num_heads),
        ("intermediate_size", intermediate_size),
        ("max_position_embeddings", max_position_embeddings),
    ):
        if value is not None:
            model_kwargs[key] = value
    net = get_model(model, **model_kwargs)
    params = net.init_params(torch.Generator().manual_seed(seed), device=dev)
    layout = None
    if model_axes:
        rules = RULES_TP if tensor > 1 else RULES_FSDP if fsdp > 1 else RULES_DP
        if num_experts:
            # expert weights [E, ...] over the expert axis (none at size 1)
            rules = list(rules) + list(RULES_EP)
        layout = ParamLayout.from_rules(mesh, params, rules, logical_axes(net.config))

    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return net(p, ids, train=train, attention_mask=attention_mask,
                   token_type_ids=token_type_ids, generator=generator,
                   layout=layout)

    schedule = warmup_linear_decay_schedule(
        base_lr, total_steps, warmup_fraction=warmup_fraction)
    state = TrainState.create(
        params=params, apply_fn=apply_fn,
        tx=adamw(schedule, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm),
    )
    if layout is not None:
        shard_state(state, layout)  # every rank drew the same global weights
    else:
        replicate_params(mesh, state)
    train_step = build_train_step(state, mesh=dp_mesh, schedule=schedule,
                                  compute_dtype=dtype, accum_steps=accum_steps,
                                  rng=seed + 1)
    eval_step = build_eval_step(state, mesh=dp_mesh, compute_dtype=dtype)
    data_seed = seed + 1000 * shard
    train_iter = _batches(batch_size, seq_len, vocab_size, num_classes,
                          data_seed, n_train, is_training=True)

    def eval_factory():
        return _batches(batch_size, seq_len, vocab_size, num_classes,
                        data_seed, min(n_train, 4 * global_batch),
                        is_training=False)

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
        ),
        mesh=dp_mesh,
    )
    return trainer.fit(state, train_iter, eval_factory)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    from distributeddeeplearning_tpu_torch.workloads._runner import run_from_argv

    run_from_argv(main)

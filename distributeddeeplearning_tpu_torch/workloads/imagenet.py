"""ImageNet classification training — the port of ``workloads/imagenet.py``.

The flagship workload: ResNet-50 (or any registered image model) trained
with the reference's recipe (both reference trainers are the same recipe:
``TensorFlow_imagenet/src/resnet_main.py:37-312`` and
``PyTorch_imagenet/src/imagenet_pytorch_horovod.py:50-446``): 64 images a
device (``defaults.py:7``), 224 px, 1001 classes, bf16 compute, base LR
0.0125 under the Goyal warmup/decay schedule, SGD momentum 0.9, weight
decay 5e-5, from synthetic data, TFRecords or a class-directory tree of
images, with checkpoints, exact resume and an eval pass each epoch.

    python -m distributeddeeplearning_tpu_torch.workloads.imagenet \\
        --data_format=tfrecords --training_data_path=DIR \\
        --validation_data_path=DIR

Arguments keep the reference's names and defaults, plus ``device`` (the
card unless asked for the CPU).  Input pipelines (``input_pipeline``), none
of which needs TensorFlow: ``"tf"`` (the default) is the reference's
tf.data recipe rebuilt on the port's reader (``data/tfrecords.py``,
``data/images.py``); ``"native"`` the C reader and decoder
(``data/native_pipeline.py``); ``"raw"`` the decode-once uint8 cache
(``data/raw_cache.py``), built beside the shards on first use, whose
batches cross to the card as uint8 and are normalized there
(``uint8_normalizer`` as the steps' ``input_transform``), and which hands
the Trainer a step-indexed factory, so a resumed fit continues the stream
from its step without replaying it.  ``distributed=True`` trains
data-parallel over a ``torch.distributed`` group, one process a device
(each process reads its own host shard of the files), over
``num_slices`` nodes with ``num_slices`` > 1 (``parallel.mesh``).
Weights are drawn from ``torch.Generator().manual_seed(seed)``, so they
differ from the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

logger = logging.getLogger("ddlt.workloads.imagenet")

NUM_IMAGES = {"train": 1281167, "validation": 50000}  # defaults.py:13-15
NUM_CLASSES = 1001  # defaults.py:11
DEFAULT_BATCH_PER_CHIP = 64  # defaults.py:7
BASE_LR = 0.0125  # imagenet_pytorch_horovod.py:296-302


def _batches(
    data_format: str,
    data_path: Optional[str],
    is_training: bool,
    per_host_batch: int,
    image_size: int,
    num_classes: int,
    seed: Optional[int],
    synthetic_length: Optional[int] = None,
    augment: str = "reference",
    input_pipeline: str = "tf",
    start_batch: int = 0,
) -> Iterator:
    """The reference's input switch (ref ``workloads/imagenet.py:36-157``):
    numpy batches ``{"image", "label"}`` of this host's rows."""
    from distributeddeeplearning_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    if input_pipeline in ("native", "raw") and data_format != "tfrecords":
        raise ValueError(
            f"input_pipeline={input_pipeline!r} supports "
            f"data_format='tfrecords' only (got {data_format!r})"
        )
    if input_pipeline not in ("tf", "native", "raw"):
        raise ValueError(f"unknown input_pipeline {input_pipeline!r}")
    if data_format == "synthetic":
        from distributeddeeplearning_tpu_torch.data.synthetic import (
            SyntheticDataset,
        )

        ds = SyntheticDataset(
            length=synthetic_length,
            image_shape=(image_size, image_size, 3),
            num_classes=num_classes,
            # hosts contribute distinct slices of the global batch
            seed=(seed or 42) + 1000 * process_index(),
        )
        if len(ds) < per_host_batch:
            raise ValueError(
                f"synthetic dataset length {len(ds)} yields zero batches at "
                f"per-host batch size {per_host_batch}"
            )
        if is_training:
            # regenerated each epoch: cycling would keep every batch
            def epochs() -> Iterator:
                while True:
                    yield from ds.batches(per_host_batch)

            return epochs()
        return ds.batches(per_host_batch)
    if data_format == "tfrecords":
        if input_pipeline == "raw":
            if augment != "reference":
                raise ValueError(
                    "input_pipeline='raw' caches deterministically-"
                    "preprocessed pixels; augment='reference' only"
                )
            from distributeddeeplearning_tpu_torch.data.raw_cache import (
                build_raw_cache,
                cache_path_for,
                raw_cache_input_fn,
            )

            # per-host cache dirs: hosts on shared storage must not write
            # one images.u8
            count, index = process_count(), process_index()
            cache_dir = cache_path_for(data_path, is_training, image_size,
                                       shard_count=count, shard_index=index)
            if count > 1:
                build_raw_cache(data_path, cache_dir, is_training,
                                image_size=image_size, shard_count=count,
                                shard_index=index)
            else:
                build_raw_cache(data_path, cache_dir, is_training,
                                image_size=image_size)
            return raw_cache_input_fn(
                cache_dir, is_training, per_host_batch, seed=seed or 0,
                repeat=is_training, start_batch=start_batch,
            )
        if input_pipeline == "native":
            if augment != "reference":
                raise ValueError(
                    "input_pipeline='native' supports augment='reference' only"
                )
            from distributeddeeplearning_tpu_torch.data.native_pipeline import (
                native_input_fn,
            )

            return native_input_fn(
                data_path, is_training, per_host_batch,
                image_size=image_size, seed=seed or 0, repeat=is_training,
            )
        from distributeddeeplearning_tpu_torch.data import tfrecords

        return tfrecords.input_fn(
            data_path, is_training, per_host_batch,
            image_size=image_size, seed=seed, repeat=is_training,
            augment=augment,
        )
    if data_format == "images":
        from distributeddeeplearning_tpu_torch.data import images

        return images.input_fn(
            data_path, is_training, per_host_batch,
            image_size=image_size, seed=seed, repeat=is_training,
            augment=augment,
        )
    raise ValueError(f"unknown data_format {data_format!r}")


def main(
    *,
    model: str = "resnet50",
    data_format: str = "synthetic",
    training_data_path: Optional[str] = None,
    validation_data_path: Optional[str] = None,
    epochs: int = 90,
    batch_size: int = DEFAULT_BATCH_PER_CHIP,  # per device
    base_lr: float = BASE_LR,
    momentum: float = 0.9,  # imagenet_pytorch_horovod.py:42
    weight_decay: float = 5e-5,  # imagenet_pytorch_horovod.py:43
    warmup_epochs: int = 5,
    label_smoothing: float = 0.0,
    accum_steps: int = 1,
    image_size: int = 224,
    num_classes: int = NUM_CLASSES,
    save_filepath: Optional[str] = None,
    tensorboard_dir: Optional[str] = None,
    resume: bool = True,
    steps_per_epoch: Optional[int] = None,
    train_images: Optional[int] = None,
    seed: int = 42,
    compute_dtype: str = "bfloat16",
    distributed: Optional[bool] = None,
    augment: str = "reference",  # "inception" = stronger train-time aug
    input_pipeline: str = "tf",  # "native" = C reader+decoder; "raw" = u8 cache
    checkpoint_every_steps: Optional[int] = None,
    profile_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    goodput_path: Optional[str] = None,
    aux_logits: bool = False,  # InceptionV3 aux head, loss weighted 0.4
    num_slices: int = 1,
    comm_overlap: bool = False,
    bucket_mb: float = 4.0,
    comm_dtype: Optional[str] = None,
    weight_update_sharding: bool = False,
    skip_nonfinite: bool = False,
    anomaly_max_consecutive: Optional[int] = None,
    anomaly_rollback: bool = False,
    step_deadline_s: Optional[float] = None,
    device: str = "cuda",
):
    """Train; returns ``(state, FitResult)``."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        initialize,
        replicate_params,
    )
    from distributeddeeplearning_tpu_torch.train.loop import Trainer, TrainerConfig
    from distributeddeeplearning_tpu_torch.train.schedule import goyal_lr_schedule
    from distributeddeeplearning_tpu_torch.train.state import (
        create_train_state,
        sgd_momentum,
    )
    from distributeddeeplearning_tpu_torch.train.step import (
        build_eval_step,
        build_train_step,
    )

    ctx = initialize(force=distributed, device=device)
    dev = ctx.device
    mesh = create_mesh(MeshSpec(), num_slices=num_slices)
    dp_mesh = mesh if mesh.group is not None else None
    world = mesh.size
    global_batch = batch_size * world
    per_host_batch = global_batch // ctx.process_count

    n_train = train_images or (
        NUM_IMAGES["train"] if data_format != "synthetic" else 50_000
    )
    spe = steps_per_epoch or max(n_train // global_batch, 1)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32

    if ctx.is_primary:
        logger.info(
            "training %s on %s: %d devices, global batch %d, %d steps/epoch, "
            "%d epochs, input %s/%s", model, dev, world, global_batch, spe,
            epochs, data_format, input_pipeline,
        )

    model_kwargs = {}
    step_kwargs = {}
    if aux_logits:
        if "inception" not in model:
            raise ValueError("--aux_logits is an InceptionV3 option")
        from distributeddeeplearning_tpu_torch.models.inception import (
            inception_aux_loss,
        )

        model_kwargs["aux_logits"] = True
        step_kwargs["loss_fn"] = inception_aux_loss
    net = get_model(model, num_classes=num_classes, dtype=dtype, **model_kwargs)
    schedule = goyal_lr_schedule(base_lr, world, spe, warmup_epochs=warmup_epochs)
    tx = sgd_momentum(schedule, momentum=momentum, weight_decay=weight_decay)
    state = create_train_state(torch.Generator().manual_seed(seed), net,
                               (1, image_size, image_size, 3), tx, device=dev)
    replicate_params(mesh, state)
    if input_pipeline == "raw":
        # uint8 batches: cast + mean subtraction on the card
        from distributeddeeplearning_tpu_torch.data.raw_cache import (
            uint8_normalizer,
        )

        step_kwargs["input_transform"] = uint8_normalizer(device=dev)
    train_step = build_train_step(
        state, mesh=dp_mesh, schedule=schedule, label_smoothing=label_smoothing,
        compute_dtype=dtype, rng=seed + 1, accum_steps=accum_steps,
        skip_nonfinite=skip_nonfinite, comm_overlap=comm_overlap,
        bucket_mb=bucket_mb, comm_dtype=comm_dtype,
        weight_update_sharding=weight_update_sharding, **step_kwargs,
    )
    if comm_overlap:
        # the prepared state is also the checkpoint restore template
        state = train_step.prepare_state(state)
    eval_step = build_eval_step(
        state, mesh=dp_mesh, compute_dtype=dtype,
        input_transform=step_kwargs.get("input_transform"),
    )

    def train_stream(start_batch: int = 0):
        return _batches(
            data_format, training_data_path, True, per_host_batch,
            image_size, num_classes, seed, synthetic_length=n_train,
            augment=augment, input_pipeline=input_pipeline,
            start_batch=start_batch,
        )

    # raw: a step-indexed factory, which the cache fast-forwards at
    # index-math cost, so a resumed fit sees the batches of an unstopped one
    train_iter = train_stream if input_pipeline == "raw" else train_stream()
    eval_factory = None
    if validation_data_path or data_format == "synthetic":
        def eval_factory():
            return _batches(
                data_format, validation_data_path, False, per_host_batch,
                image_size, num_classes, seed,
                synthetic_length=min(n_train, 4 * global_batch),
                input_pipeline=input_pipeline,
            )

    trainer = Trainer(
        train_step,
        eval_step=eval_step,
        config=TrainerConfig(
            epochs=epochs,
            steps_per_epoch=spe,
            global_batch_size=global_batch,
            checkpoint_dir=save_filepath,
            checkpoint_every_steps=checkpoint_every_steps,
            tensorboard_dir=tensorboard_dir,
            resume=resume,
            profile_dir=profile_dir,
            metrics_path=metrics_path,
            goodput_path=goodput_path,
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

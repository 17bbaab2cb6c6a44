"""Synthetic throughput benchmark workload — the port of
``workloads/benchmark.py``.

A model by name trains on one fixed batch resident on the device: N
warmup batches, then timed windows of train steps, img/s per device as
the mean ±1.96σ (:mod:`..train.benchmark`).  The defaults are the
reference's: resnet50, batch 64 a device, 224 x 224 images, 1001 classes,
10 warmup batches then 10 windows of 10, bf16 compute, SGD momentum 0.9
with weight decay 5e-5 under the Goyal schedule from base lr 0.0125
(5004 steps an epoch).

    python -m distributeddeeplearning_tpu_torch.workloads.benchmark --model resnet50

Arguments keep the reference's names and defaults, plus ``device``
(``cuda`` unless asked for the CPU; without a card it raises).
``distributed=True`` runs data-parallel over the processes of a
``torch.distributed`` group, one per device (``torchrun``; see
:mod:`._runner`): the global batch is ``batch_size x world``, the Goyal
schedule scales with the world, each rank trains its rows of the
reference's global batch through the implicit data-parallel step
(global-batch BatchNorm moments, one gradient all-reduce), the result
carries the world's total img/s and only rank 0 logs and writes the
metrics row.  Data formats other than synthetic raise (the ImageNet
readers are ROADMAP A5's second half).  Weights are drawn from
``torch.Generator().manual_seed(0)`` and the batch from the reference's
``synthetic_batch`` (numpy seed 0), so the batch is the reference's bit
for bit and the weights are not.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger("ddlt.workloads.benchmark")


def main(
    *,
    model: str = "resnet50",
    data_format: str = "synthetic",
    batch_size: int = 64,  # per device
    image_size: int = 224,
    num_classes: int = 1001,
    num_iters: int = 10,
    num_batches_per_iter: int = 10,
    num_warmup_batches: int = 10,
    compute_dtype: str = "bfloat16",
    base_lr: float = 0.0125,
    tensorboard_dir: Optional[str] = None,  # accepted for submit parity
    save_filepath: Optional[str] = None,  # accepted for submit parity
    metrics_path: Optional[str] = None,  # one summary row is appended
    distributed: Optional[bool] = None,
    device: Optional[str] = None,
):
    """Run the synthetic benchmark; returns a ``BenchmarkResult``."""
    if data_format != "synthetic":
        raise ValueError(
            f"the benchmark workload is synthetic-only (data_format "
            f"{data_format!r}); fed data is ROADMAP A5"
        )
    import torch

    from distributeddeeplearning_tpu_torch.data.synthetic import synthetic_batch
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.parallel import (
        MeshSpec,
        create_mesh,
        initialize,
        replicate_params,
        shard_batch,
    )
    from distributeddeeplearning_tpu_torch.train.benchmark import run_benchmark
    from distributeddeeplearning_tpu_torch.train.loop import MetricsLog
    from distributeddeeplearning_tpu_torch.train.schedule import goyal_lr_schedule
    from distributeddeeplearning_tpu_torch.train.state import (
        create_train_state,
        sgd_momentum,
    )
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    ctx = initialize(force=distributed, device=device)
    dev = ctx.device
    mesh = create_mesh(MeshSpec())
    n_dev = mesh.size
    global_batch = batch_size * n_dev
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    img_shape = (image_size, image_size, 3)

    net = get_model(model, num_classes=num_classes, dtype=dtype)
    sched = goyal_lr_schedule(base_lr, n_dev, steps_per_epoch=5004)
    state = create_train_state(torch.Generator().manual_seed(0), net,
                               (batch_size, *img_shape), sgd_momentum(sched),
                               device=dev)
    replicate_params(mesh, state)
    step = build_train_step(state, mesh=mesh if mesh.group is not None else None,
                            schedule=sched, compute_dtype=dtype)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in shard_batch(
        mesh, synthetic_batch(global_batch, img_shape, num_classes)).items()}
    result = run_benchmark(
        step,
        state,
        batch,
        model_name=model,
        batch_size_per_chip=batch_size,
        num_devices=n_dev,
        num_warmup_batches=num_warmup_batches,
        num_iters=num_iters,
        num_batches_per_iter=num_batches_per_iter,
        log=logger.info if ctx.is_primary else (lambda *_: None),
    )
    MetricsLog(metrics_path).append({
        "model": model,
        "img_sec_per_chip": result.img_sec_per_chip_mean,
        "img_sec_total": result.img_sec_total,
        "num_devices": n_dev,
    })
    return result


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    from distributeddeeplearning_tpu_torch.workloads._runner import run_from_argv

    run_from_argv(main)

"""The port's image training path on the card.

These tests need an NVIDIA GPU and skip elsewhere.  They import neither
jax nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda_image.py

- One train step of the benchmark model (resnet50 at the workload's
  defaults, batch cut to 16: a resident batch on the card, the Goyal
  schedule, SGD momentum, bf16) runs under
  ``torch.cuda.set_sync_debug_mode("error")``: nothing in it waits for the
  card, which the benchmark's overlapped windows rely on.
- The card's f32 forward and first train step of resnet18 (32 px, batch
  8, TF32 off) against the CPU's from the same weights: eval logits within
  1e-4 of the largest |logit| (cuDNN and the CPU sum in other orders), the
  loss within 1e-4 relative.
- Raw-cache uint8 batches staged through ``prefetch_to_device`` and
  normalized by ``uint8_normalizer`` on the card equal the CPU's bit for
  bit (a cast and a subtraction), and the staged batch is still uint8.
- ``workloads.imagenet.main`` trains resnet18 for 2 steps at 64 px over
  the native pipeline on the card and evaluates.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch.data.synthetic import synthetic_batch
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.models._convnet import (
    variables_from_numpy,
    variables_to_numpy,
)
from distributeddeeplearning_tpu_torch.train.schedule import goyal_lr_schedule
from distributeddeeplearning_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    sgd_momentum,
)
from distributeddeeplearning_tpu_torch.train.step import build_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def test_benchmark_train_step_makes_no_host_sync(cuda):
    model = get_model("resnet50")
    sched = goyal_lr_schedule(0.0125, 1, steps_per_epoch=5004)
    state = create_train_state(torch.Generator().manual_seed(0), model,
                               (16, 224, 224, 3), sgd_momentum(sched), device=cuda)
    step = build_train_step(state, schedule=sched)
    batch = {k: torch.as_tensor(v, device=cuda)
             for k, v in synthetic_batch(16, (224, 224, 3)).items()}
    state, _ = step(state, batch)  # first call: cuDNN plans, allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 2
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_card_matches_the_cpu_in_f32(cuda):
    model = get_model("resnet18", num_classes=10, dtype=torch.float32)
    host = variables_to_numpy(model.init(torch.Generator().manual_seed(1),
                                         (1, 32, 32, 3), device="cpu"))
    batch = synthetic_batch(8, (32, 32, 3), 10, seed=3)
    out = {}
    for dev in ("cpu", "cuda"):
        v = variables_from_numpy(host, device=dev)
        logits = model(v["params"], torch.as_tensor(batch["image"], device=dev),
                       train=False, batch_stats=v["batch_stats"])
        state = TrainState.create(params=v["params"], batch_stats=v["batch_stats"],
                                  apply_fn=model,
                                  tx=sgd_momentum(goyal_lr_schedule(0.0125, 1, 5004)))
        _, metrics = build_train_step(state, compute_dtype=torch.float32)(state, batch)
        out[dev] = (logits.detach().cpu(), float(metrics["loss"]))
    (cpu_logits, cpu_loss), (card_logits, card_loss) = out["cpu"], out["cuda"]
    scale = cpu_logits.abs().max().item()
    assert (card_logits - cpu_logits).abs().max().item() <= 1e-4 * scale
    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)


@pytest.fixture
def shards(tmp_path):
    from distributeddeeplearning_tpu_torch.data.bench_data import (
        generate_bench_shards,
    )

    generate_bench_shards(str(tmp_path), num_images=16, num_shards=2, seed=7)
    generate_bench_shards(str(tmp_path), num_images=8, num_shards=2, seed=8,
                          split="validation")
    return str(tmp_path)


def test_raw_batches_normalize_on_the_card_as_on_the_cpu(cuda, shards):
    import itertools

    from distributeddeeplearning_tpu_torch.data import raw_cache
    from distributeddeeplearning_tpu_torch.utils.prefetch import prefetch_to_device

    cache = raw_cache.cache_path_for(shards, True, 64)
    raw_cache.build_raw_cache(shards, cache, True, image_size=64)

    def stream():
        return itertools.islice(raw_cache.raw_cache_input_fn(
            cache, True, 8, shard_count=1, shard_index=0, seed=1), 4)

    host = list(stream())
    staged = prefetch_to_device(stream(), cuda)
    try:
        for want, got in zip(host, staged):
            assert got["image"].device.type == "cuda"
            assert got["image"].dtype == torch.uint8
            card = raw_cache.uint8_normalizer()(got["image"])
            cpu = raw_cache.uint8_normalizer()(want["image"])
            assert card.device.type == "cuda"
            assert torch.equal(card.cpu(), cpu)
            moved = raw_cache.uint8_normalizer(device=cuda)(want["image"])
            assert torch.equal(moved, card)
            np.testing.assert_array_equal(got["label"].cpu().numpy(), want["label"])
    finally:
        staged.close()


def test_imagenet_trains_on_the_card_over_the_native_pipeline(cuda, shards):
    from distributeddeeplearning_tpu_torch.workloads import imagenet

    state, result = imagenet.main(
        model="resnet18", data_format="tfrecords", input_pipeline="native",
        training_data_path=shards, validation_data_path=shards, epochs=1,
        steps_per_epoch=2, batch_size=4, image_size=64, num_classes=1001,
        train_images=16, device="cuda")
    assert state.step == 2
    from distributeddeeplearning_tpu_torch.train.state import tree_leaves

    assert tree_leaves(state.params)[0].device.type == "cuda"
    assert np.isfinite(result.final_train_metrics["loss"])
    assert result.final_eval_metrics

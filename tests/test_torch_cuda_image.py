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

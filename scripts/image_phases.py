#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s image, ViT, MoE, parallelism, robust-serving, fleet and
ImageNet-data phases on one NVIDIA GPU.

    python3 scripts/image_phases.py                      # all of them
    python3 scripts/image_phases.py phase_resnet         # or any of them

``phase_resnet`` (the reference's ResNet-50 synthetic benchmark through
``workloads.benchmark.main`` and one profiled step), ``phase_resnet_parity``
(the card against the CPU in float64 and f32, bf16 against f32),
``phase_image_short`` (inceptionv3, vgg16 and resnet50 shortened runs),
``phase_vit`` (ViT-B/16's benchmark, a shortened ViT-L/16 run),
``phase_vit_flash`` (the bf16 flash kernels at ViT's shape, launches a
step, flash against default, the card against the CPU), ``phase_resume``
(checkpoints and bit-exact resume of a ViT-B/16 fit), ``phase_resilience``
(the trainer's resilience layer on that fit, and the LM workload's exit
codes), ``phase_moe_bert`` (bert-base with experts) and
``phase_data_parallel`` (data-parallel training: NCCL at a world of 1,
two gloo ranks sharing the card, the distributed flagship benchmark) and
``phase_tensor_parallel`` (tensor-parallel serving over two gloo ranks
sharing the card, K4(d) and K1-K3 over a rank's heads) and
``phase_serve_robust`` (overload with priority classes, the host page
tier, live reload, the serve faults, int8-KV fidelity and the ledger's
frames at the serving geometry) and ``phase_fleet`` (the supervised serving
fleet: replica workers, failover, reload, drain, a dense replica) and
``phase_imagenet`` (the ImageNet readers' host rates, fed against
resident img/s, the workload through ``python -m`` and a replay-free
raw-cache resume) and ``phase_model_parallel_train`` (tensor-parallel and
FSDP training of the LM over four gloo ranks sharing the card) and
``phase_bert_model_parallel`` (BERT and MoE BERT over the fsdp, tensor
and expert axes on four gloo ranks sharing the card) and
``phase_model_axes`` (the last two with their ranks in one spawn) and
``phase_train`` (the LM at the reference configuration in f32, its
profiled step's roofline through ``utils.roofline``), each as
``chip_smoke.py`` runs it, after the card's ``nvidia-smi`` name and power
limit.  Exits
nonzero if a phase fails.  Run from the repository's root; needs a CUDA
card and imports no jax.
"""

from __future__ import annotations

import inspect
import os
import sys
import traceback

PHASES = ("phase_resnet", "phase_resnet_parity", "phase_image_short", "phase_vit",
          "phase_vit_flash", "phase_resume", "phase_resilience", "phase_moe_bert",
          "phase_data_parallel", "phase_tensor_parallel", "phase_serve_robust",
          "phase_fleet", "phase_imagenet", "phase_model_parallel_train",
          "phase_bert_model_parallel", "phase_model_axes", "phase_train")


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from distributeddeeplearning_tpu_torch import resolve_device
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import flash_decode as fd

    resolve_device("cuda")
    chip_smoke.set_peaks(torch)  # bounds and mfu over the card's peaks
    card = chip_smoke.card_line()
    chip_smoke.log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    chip_smoke.log(f"[build] {_build.build_all()}")
    args = {"torch": torch, "np": np, "F": F, "fa": fa, "fd": fd, "card": card}
    rc = 0
    for name in argv or PHASES:
        if name not in PHASES:
            raise SystemExit(f"unknown phase {name!r}; one of {PHASES}")
        phase = getattr(chip_smoke, name)
        try:
            chip_smoke.timed(phase, *(args[p] for p, v in
                                      inspect.signature(phase).parameters.items()
                                      if v.default is inspect.Parameter.empty))
        except Exception:  # noqa: BLE001 — report every phase, fail at the end
            traceback.print_exc()
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

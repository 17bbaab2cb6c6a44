#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s image phases on one NVIDIA GPU.

    python3 scripts/image_phases.py                      # all three
    python3 scripts/image_phases.py phase_resnet         # or any of them

``phase_resnet`` (the reference's ResNet-50 synthetic benchmark through
``workloads.benchmark.main`` and one profiled step), ``phase_resnet_parity``
(the card against the CPU in float64 and f32, bf16 against f32) and
``phase_image_short`` (inceptionv3, vgg16 and resnet50 shortened runs),
each as ``chip_smoke.py`` runs it, after the card's
``nvidia-smi`` name and power limit.  Exits nonzero if a phase fails.
Run from the repository's root; needs a CUDA card and imports no jax.
"""

from __future__ import annotations

import os
import sys
import traceback

PHASES = ("phase_resnet", "phase_resnet_parity", "phase_image_short")


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from distributeddeeplearning_tpu_torch import resolve_device

    resolve_device("cuda")
    card = chip_smoke.card_line()
    chip_smoke.log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    rc = 0
    for name in argv or PHASES:
        if name not in PHASES:
            raise SystemExit(f"unknown phase {name!r}; one of {PHASES}")
        try:
            chip_smoke.timed(getattr(chip_smoke, name), torch, np, card)
        except Exception:  # noqa: BLE001 — report every phase, fail at the end
            traceback.print_exc()
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

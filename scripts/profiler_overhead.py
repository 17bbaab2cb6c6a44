#!/usr/bin/env python3
"""Does running torch.profiler once slow a host-bound train step later in
the same process?  On one NVIDIA GPU:

    python3 scripts/profiler_overhead.py [--model resnet50] [--runs 2]

Runs the synthetic benchmark (``workloads.benchmark.main`` at the given
model's reference defaults, shortened to 3 warmup batches and 5 windows
of 10) ``--runs`` times, then profiles one train step as
``chip_smoke.py``'s image phase does, then runs the benchmark ``--runs``
times more; prints each run's img/s and step p50 (CUDA events), with the
card's name and power limit.  Run from the repository's root.
"""

from __future__ import annotations

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch import resolve_device

    resolve_device("cuda")
    cs.set_peaks(torch)  # bounds and mfu over the card's peaks
    card = cs.card_line()
    kw = dict(model=args.model, num_warmup_batches=3, num_iters=5,
              num_batches_per_iter=10)

    def bench(tag):
        result, step_ms, kept, peak_gb = cs._image_bench(torch, np, **kw)
        p50 = cs._image_line(np, tag, result, step_ms, 3, peak_gb, card,
                             "bfloat16", 224)
        return kept, p50

    kept = None
    for i in range(args.runs):
        kept, p50 = bench(f"{args.model} before the profiler, run {i + 1}")
    step, state, batch = kept
    cs._profile_image_step(torch, step, state, batch, args.model, card, p50)
    del kept, step, state, batch
    for i in range(args.runs):
        bench(f"{args.model} after the profiler, run {i + 1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

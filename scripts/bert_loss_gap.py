"""Per-step loss gap between bert-base fine-tuning with flash attention and
with the default attention (same seed, dropout 0), over several seeds,
beside a control run of flash with the key-padding bias dropped (every key
visible), which a sound limit on the gap must reject.

    python3 scripts/bert_loss_gap.py [--seeds 42 0 1 2 3] [--seq-len 128]
        [--dtype bfloat16] [--train-examples 64]

Each run is ``chip_smoke.py``'s ``phase_bert`` run (``workloads.bert.main``
at bert-base, batch 8, one epoch of 8 steps, launch counts and per-step
losses recorded the same way) with ``seed`` set; ``--train-examples 8``
feeds one batch repeatedly instead of a fresh batch each step.  Needs one
CUDA card.  Prints a line per seed and one JSON line: the largest gap of
flash vs default and of the control vs default, per seed."""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 0, 1, 2, 3])
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--train-examples", type=int, default=64)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bert_loss_gap: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch import resolve_device
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    resolve_device("cuda")
    cs.set_peaks(torch)  # bounds and mfu over the card's peaks
    make = fa.make_flash_attention

    def make_unmasked(*a, **k):
        attend = make(*a, **k)
        return lambda q, k, v, mask, *, dtype: attend(q, k, v, None, dtype=dtype)

    dtype_kw = {"compute_dtype": args.dtype}
    result = {}
    for seed in args.seeds:
        losses = {}
        for name, attention in (("flash", "flash"), ("default", "default"),
                                ("control", "flash")):
            if name == "control":
                fa.make_flash_attention = make_unmasked
            try:
                _, loss, _, _, _, _ = cs._bert_run(
                    torch, np, fa, seq_len=args.seq_len, attention=attention,
                    dropout_rate=0.0, dtype_kw=dtype_kw, seed=seed,
                    train_examples=args.train_examples)
            finally:
                fa.make_flash_attention = make
            losses[name] = loss
        gaps = {name: [abs(a - c) / abs(c) for a, c in zip(losses[name],
                                                           losses["default"])]
                for name in ("flash", "control")}
        result[seed] = {name: max(g) for name, g in gaps.items()}
        print(f"seed {seed}: default loss {[round(x, 5) for x in losses['default']]}; "
              f"|flash - default| / default {[f'{x:.2e}' for x in gaps['flash']]}; "
              f"control (bias dropped) {[f'{x:.2e}' for x in gaps['control']]}",
              flush=True)
    print(cs.card_line())
    print(json.dumps({"seq_len": args.seq_len, "dtype": args.dtype,
                      "train_examples": args.train_examples, "max_gap": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the unmasked flash kernels K1, K2, K3 of one checkout of the
PyTorch port, f32 and bf16, at the LM training shape (B=8, H=12, S=2048,
D=64, causal; q, k, v as strided views of one qkv tensor).

    python3 scripts/time_flash.py [--root DIR] [--tag NAME]

``--root`` is the directory that holds ``distributeddeeplearning_tpu_torch``
(default: the checkout this script lies in), so that two checkouts can be
timed on one card in one sitting, each building its own kernels; run them
interleaved (A, B, B, A) and compare only times taken together.  Each time is the
mean of 20 launches after 3 warm-up launches, between two CUDA events.
Prints the card as ``nvidia-smi`` names it, then one JSON line."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, H, S, D = 8, 12, 2048, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    def ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn((B, S, 3 * H * D), generator=g, device="cuda").to(dtype)
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
        o, lse = fa.flash_attention_core(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        out[f"K1_{tag}"] = ms(lambda: fa.flash_attention_core(q, k, v, causal=True))
        out[f"K2_{tag}"] = ms(lambda: fa._launch_bwd_dq(q, k, v, do, lse, delta,
                                                        causal=True))
        out[f"K3_{tag}"] = ms(lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta,
                                                         causal=True))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "shape": f"B={B} H={H} S={S} D={D} causal", "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

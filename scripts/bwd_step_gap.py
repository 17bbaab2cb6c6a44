"""Time the bf16 flash-attention backward kernels (K2, the dQ pass, and K3,
the dK/dV pass) inside the LM training step and alone, on one card, to
find out why a launch inside the step can take longer than one alone.

    python3 scripts/bwd_step_gap.py [--root DIR] [--tag NAME]

``--root`` is the directory that holds ``distributeddeeplearning_tpu_torch``
(default: this script's checkout), as in ``scripts/time_flash.py``; the
timers and the training configuration are ``chip_smoke.py``'s (its
``TRAIN``: 12 layers, d 768, 12 heads, seq 2048, batch 8, at the
workload's default bf16).  It reports, per launch:

- ``in_step``: K2's and K3's device time in one profiled training step
  (``chip_smoke.profile_share`` over 2 steps), divided by the 12 launches
  of a step;
- ``captured``: each kernel alone (``chip_smoke.device_ms``) on the very
  q, k, v, dO, lse and delta that each of the step's 12 layers gave it
  (copied with their strides), averaged over the layers;
- ``random``: alone on random strided q, k, v and dO of the same shape,
  with the lse and delta of the causal forward on those inputs;
- ``random_noncausal_lse``: the same, but the lse and delta of a
  NON-causal forward on those inputs (the inputs ``chip_smoke.py``'s bf16
  backward timing once took: it timed after its non-causal check);
- ``windows``: for each of 10 torch.profiler windows of 10 calls of K2
  alone on the random inputs, the launches the profiler recorded and the
  recorded device time over the 10 calls (what ``chip_smoke.device_ms``
  read before it timed kernels by the launches recorded).

It prints the card as ``nvidia-smi`` names it, then one JSON line."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

KERNELS = {"dq": "flash_bwd_dq_bf16_kernel", "dkv": "flash_bwd_dkv_bf16_kernel"}


def _copy(t):
    """A copy of ``t`` with its strides (a strided view stays strided)."""
    out = t.new_empty_strided(t.shape, t.stride())
    out.copy_(t)
    return out


def _alone(torch, fa, inputs, causal=True):
    """Device ms of K2 and K3 alone on ``(q, k, v, do, lse, delta)``."""
    q, k, v, do, lse, delta = inputs
    return {"dq": cs.device_ms(torch, lambda i: fa._launch_bwd_dq(
                q, k, v, do, lse, delta, causal=causal)),
            "dkv": cs.device_ms(torch, lambda i: fa._launch_bwd_dkv(
                q, k, v, do, lse, delta, causal=causal))}


def _windows(torch, fn, n=10, iters=10):
    """(launches recorded, device ms a call) of ``n`` profiler windows of
    ``iters`` calls of ``fn``, each launching one kernel a call."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        out.append((sum(e.count for e in cuda),
                    sum(e.self_device_time_total for e in cuda) / 1e3 / iters))
    return out


def _random_inputs(torch, fa, causal_lse: bool):
    """Random strided bf16 q, k, v and dO at the training shape, with the
    lse and delta of a causal (or non-causal) forward on them."""
    t = cs.TRAIN
    b, s, h = t["batch_size"], t["seq_len"], t["num_heads"]
    q, k, v = cs.bf16_qkv(torch, b, s, h=h, d=t["d_model"] // h, seed=s)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal_lse)
    g = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bwd_step_gap: no CUDA device", file=sys.stderr)
        return 1
    cs.set_peaks(torch)  # bounds over the card's peaks (utils/hardware.PEAKS)
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        next_token_loss,
    )
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.train.step import build_train_step
    from distributeddeeplearning_tpu_torch.workloads import transformer

    t = cs.TRAIN
    with tempfile.TemporaryDirectory() as tmp:
        state, _ = transformer.main(
            epochs=1, steps_per_epoch=1, train_examples=t["batch_size"],
            attention="flash", device="cuda",
            metrics_path=os.path.join(tmp, "metrics.jsonl"), **t)
    step = build_train_step(
        state, compute_dtype=torch.bfloat16,
        loss_fn=lambda lg, lb, label_smoothing=0.0: next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss})
    batch = next(transformer._token_batches(
        t["batch_size"], t["seq_len"], t["vocab_size"], 42, t["batch_size"],
        repeat=False))

    # the step's own inputs to K2, one set per layer
    captured = []
    launch = fa._launch_bwd_dq

    def capture(q, k, v, do, lse, delta, *, causal, bias=None):
        captured.append(tuple(_copy(x) for x in (q, k, v, do, lse, delta)))
        return launch(q, k, v, do, lse, delta, causal=causal, bias=bias)

    fa._launch_bwd_dq = capture
    try:
        step(state, batch)
    finally:
        fa._launch_bwd_dq = launch
    torch.cuda.synchronize()

    layers = t["num_layers"]
    _, busy, top, _ = cs.profile_share(torch, lambda: step(state, batch), 2)
    in_step = {kern: sum(ms for key, ms in top if name in key) / layers
               for kern, name in KERNELS.items()}
    per_layer = [_alone(torch, fa, inputs) for inputs in captured]
    alone = {kern: sum(x[kern] for x in per_layer) / len(per_layer)
             for kern in KERNELS}
    del captured, state, step
    torch.cuda.empty_cache()
    inputs = _random_inputs(torch, fa, causal_lse=True)
    random = _alone(torch, fa, inputs)
    windows = _windows(torch, lambda i: fa._launch_bwd_dq(*inputs, causal=True))
    del inputs
    mismatched = _alone(torch, fa, _random_inputs(torch, fa, causal_lse=False))
    card = cs.card_line()
    print(card)
    print(json.dumps({
        "tag": args.tag, "root": args.root, "card": card,
        "shape": f"B={t['batch_size']} H={t['num_heads']} S={t['seq_len']} "
                 f"D={t['d_model'] // t['num_heads']} causal bf16",
        "step_kernel_ms": busy, "in_step": in_step, "captured": alone,
        "captured_by_layer": per_layer, "random": random,
        "random_noncausal_lse": mismatched, "windows": windows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

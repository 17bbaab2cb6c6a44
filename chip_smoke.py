#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (the port's package sits beside this
script); it needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch
built for CUDA, and imports nothing of jax or of the JAX package.  Phases:

1. build: compile every CUDA kernel of the serving path from ``csrc/``
   (one ``nvcc`` per source, all at once) and print the build time;
2. K1, the causal flash-attention forward, against its plain PyTorch
   version at the prefill shapes B=1, H=12, D=64, S in {128, 512, 576}
   (576 is a ragged tile), inputs as the model's strided qkv split;
3. K4(a), decode attention, against its plain version at b=8, h=12,
   hd=64, S=576 on the strided layer views of a real [8, 12, 576, 12, 64]
   cache, with unequal positions including 0 and S-1;
4. serving end to end: the 12-layer causal LM at full width (d_model
   768, 12 heads, d_ff 3072, vocab 32768; random weights from seed 0 with
   the tied 4x embedding head) served by ``InferenceEngine`` (8 slots,
   max_seq 576) under ``ContinuousBatchingScheduler(max_new_tokens=32)``
   over 16 synthetic requests of 64..512 tokens.  The kernels' launch
   counters are zeroed just before the run and must have risen after it;
   the greedy tokens of the two shortest requests must equal a naive
   oracle that recomputes the full dense forward each step;
5. K2 and K3, the flash-attention backward (dQ pass, dK/dV pass), against
   their plain version at the training shape B=8, H=12, D=64, S=2048,
   causal, and at S in {37, 576} (ragged tiles), inputs as strided qkv
   views with a random dO;
6. gradient parity at full width: one loss and gradient of the 12-layer
   LM at batch 1, seq 2048, flash (K1 + K2/K3) against dense attention;
7. training end to end: the port's ``workloads.transformer.main`` at the
   reference configuration (12 layers, d 768, 12 heads, ff 3072, vocab
   32768, seq 2048, batch 8, flash attention, f32), 8 epochs of one step
   on one repeated batch.  The counters are zeroed just before it; K1 must
   count 12 per forward (train and eval), K2 and K3 12 per train step; the
   loss must fall and every metric be finite.  It prints the step time
   p50, tokens/s, model-FLOPs utilisation of the f32 peak (``mfu``, with
   ``bench.py``'s convention 6NT + causal attention) and peak memory, and
   a profiler breakdown of one train step.

Kernel, plain and library times are device times: torch.profiler's sum
of the CUDA work each call runs, averaged over many calls after warm-up
(for K1 and K4 the log also gives a CUDA-event span around a launch loop,
which at these small shapes counts the host's launch gaps too); the
decode kernel cycles through the cache's 12 layers so its history is not
served from L2.  ``bound_ms`` is the least time the card could take: the
larger of the bytes moved (inputs read once, outputs written once) over
3.35 TB/s and the flops over 67 TFLOP/s (the H100's f32 peak on CUDA
cores, which is what the f32 kernels use).  ``library_ms`` times
one ``scaled_dot_product_attention`` call on the same inputs (for K2/K3,
``torch.autograd.grad`` through it, graph built once), a yardstick the
port never calls.  ``launches`` is the count in this slice's own path
(training for K1, K2, K3; serving for K4); K1's row also gives both.

Output: progress lines, then one JSON line with a row per kernel, the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives,
and last ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero before that last line.  Without a card, or without the package
beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 on CUDA cores

K1_TOL = 1e-4  # f32 rounding: sums over <= 576 terms in another order
K4_TOL = 1e-4
LOGIT_RTOL = 1e-4  # of the largest |logit|: f32 through 12 layers, 2 paths
# K2/K3: of the largest |gradient|; f32 sums of up to 2048 terms, twice
# (dP = dO V^T, then dS K or dS^T Q), in another order than cuBLAS
BWD_RTOL = 1e-4
# full-width gradient parity, of each leaf's largest |gradient|: f32
# rounding of two attention paths carried back through 12 layers
GRAD_RTOL = 1e-3

TRAIN = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
             vocab_size=32768, seq_len=2048, batch_size=8)
TRAIN_EPOCHS = 8  # one step each: every epoch end is a timed sync point

SERVE = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
             vocab_size=32768)
SLOTS, MAX_SEQ, REQUESTS, NEW_TOKENS = 8, 576, 16, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call of ``fn``: every kernel, copy and set it
    ran, summed by torch.profiler over ``iters`` calls after warm-up.
    Unlike a CUDA-event span around a launch loop (:func:`cuda_ms`), it
    leaves out the gaps in which the card waits for the host to prepare
    the next launch, which dominate at the serving shapes."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3 / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k1(torch, F, fa, card):
    """K1 vs its plain version; returns the JSON row (timed at S=512, the
    largest prompt bucket of the serving run)."""
    b, h, d = 1, 12, 64
    worst_o = worst_lse = 0.0
    row = None
    for s in (128, 512, 576):
        g = torch.Generator(device="cuda").manual_seed(s)
        qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda")
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        o, lse = fa.flash_attention_core(q, k, v, causal=True)
        o_ref, lse_ref = fa._dense_attention(q, k, v, None, causal=True)
        torch.cuda.synchronize()
        err_o = (o - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
        worst_o, worst_lse = max(worst_o, err_o), max(worst_lse, err_lse)
        log(f"[k1] S={s}: max|dO|={err_o:.3e} max|dlse|={err_lse:.3e} "
            f"(tolerance {K1_TOL:g}) finite={finite}")
        if not finite or err_o > K1_TOL or err_lse > K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at S={s}")
        if s != 512:
            continue
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        run = lambda i: fa.flash_attention_core(q, k, v, causal=True)  # noqa: E731
        ms, loop_ms = device_ms(torch, run, iters=50), cuda_ms(torch, run)
        plain_ms = device_ms(torch, lambda i: fa._dense_attention(q, k, v, None, causal=True))
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), iters=50)
        pairs = s * (s + 1) // 2  # visible (query, key) pairs, causal
        flops = 4.0 * b * h * d * pairs
        nbytes = 4.0 * (4 * b * s * h * d + b * h * s)  # q, k, v in; o, lse out
        bms, by = bound_ms(nbytes, flops)
        log(f"[k1] S=512 kernel {ms:.4f} ms ({loop_ms:.4f} ms a launch in an "
            f"event-timed loop), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}); device times, on {card}")
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms, shape=f"B=1 H=12 S=512 D=64 causal f32")
    row["max_abs_err"] = max(worst_o, worst_lse)
    return row


def phase_k4(torch, F, fd, card):
    """K4(a) vs its plain version on the strided layer views of a real
    dense cache; returns the JSON row."""
    slots, layers, s, h, hd = 8, 12, 576, 12, 64
    g = torch.Generator(device="cuda").manual_seed(4)
    cache_k = torch.randn((slots, layers, s, h, hd), generator=g, device="cuda")
    cache_v = torch.randn((slots, layers, s, h, hd), generator=g, device="cuda")
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    q3 = torch.randn((slots, h, hd), generator=g, device="cuda")
    worst = 0.0
    for layer in (0, layers - 1):
        k_l, v_l = cache_k[:, layer], cache_v[:, layer]
        assert not k_l.is_contiguous()
        out = fd.decode_attention_dense(q3, k_l, v_l, None, None, None, None, pos)
        ref = fd._gather_decode_dense(q3, k_l, v_l, None, None, None, None, pos)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        worst = max(worst, err)
        log(f"[k4] layer {layer}: max|dout|={err:.3e} (tolerance {K4_TOL:g}) "
            f"finite={finite}")
        if not finite or err > K4_TOL:
            raise AssertionError("K4(a) disagrees with its plain version")
    views = [(cache_k[:, i], cache_v[:, i]) for i in range(layers)]
    visible = torch.arange(s, device="cuda")[None, :] <= pos[:, None]
    mask = visible[:, None, None, :]
    lib_views = [(k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)) for k, v in views]
    q4 = q3[:, :, None, :]
    run = lambda i: fd.decode_attention_dense(  # noqa: E731
        q3, *views[i % layers], None, None, None, None, pos)
    ms, loop_ms = device_ms(torch, run, iters=120), cuda_ms(torch, run, iters=120)
    plain_ms = device_ms(torch, lambda i: fd._gather_decode_dense(
        q3, *views[i % layers], None, None, None, None, pos), iters=60)
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, *lib_views[i % layers], attn_mask=mask), iters=60)
    hist = float((pos.long() + 1).sum().item())  # visible positions, all slots
    nbytes = 4.0 * (2 * hist * h * hd + 2 * slots * h * hd) + 4.0 * 2 * slots
    flops = 4.0 * hist * h * hd
    bms, by = bound_ms(nbytes, flops)
    log(f"[k4] b=8 S=576 kernel {ms:.4f} ms ({loop_ms:.4f} ms a launch in an "
        f"event-timed loop), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}); device times, on {card}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, max_abs_err=worst,
                shape="b=8 h=12 hd=64 S=576 nq=1 f32, pos 0..575")


def naive_greedy(torch, forward, params, prompt, n):
    """Oracle: greedy generation by a full dense forward every step."""
    toks = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"),
                             num_heads=SERVE["num_heads"], attention="dense")
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def teacher_forced_error(torch, params, tokens, prompt_len):
    """Max |logit difference| between the serving path (flash prefill of
    the prompt, then one kernel decode step per token) and one full dense
    forward over the same tokens, and the largest |logit| for scale.  The
    margin profile makes greedy streams insensitive to attention; these
    logits are not."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, forward_decode, forward_prefill,
    )
    from distributeddeeplearning_tpu_torch.serve import init_cache, insert_sequence

    heads = SERVE["num_heads"]
    toks = torch.tensor([tokens], device="cuda")
    with torch.inference_mode():
        full = forward(params, toks, num_heads=heads, attention="dense")[0]
        logits, k, v = forward_prefill(params, toks[:, :prompt_len],
                                       num_heads=heads, attention="flash")
        cache = init_cache(batch_slots=1, num_layers=SERVE["num_layers"],
                           max_seq=MAX_SEQ, num_heads=heads,
                           head_dim=SERVE["d_model"] // heads, device="cuda")
        insert_sequence(cache, k, v, 0)
        got = [logits[0, prompt_len - 1]]
        for pos in range(prompt_len, len(tokens) - 1):
            step, _ = forward_decode(
                params, toks[:, pos], cache,
                torch.tensor([pos], dtype=torch.int32, device="cuda"),
                num_heads=heads,
            )
            got.append(step[0])
        want = full[prompt_len - 1:len(tokens) - 1]
        err = (torch.stack(got) - want).abs().max().item()
    return err, want.abs().max().item()


def profile_share(torch, fn, steps):
    """(host wall ms per step, CUDA kernel ms per step, top kernels) from
    torch.profiler over ``steps`` calls of ``fn``; kernel ms is None when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / steps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    total = sum(ms for _, ms in kernels)
    top = sorted(kernels, key=lambda kv: -kv[1])
    return wall, (total if kernels else None), top


def phase_serve(torch, np, fa, fd, card):
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, init_params,
    )
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, Request,
        synthetic_requests,
    )

    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), max_len=MAX_SEQ,
                         device="cuda", **SERVE)
    # tied 4x-gain embedding head: top-2 logit gaps dwarf f32 reassociation
    # noise, so token equality measures the kernels, not tie-breaking
    params["embed"] *= 4.0
    params["head"] = params["embed"].T.contiguous()
    n_params = sum(t.numel() for t in (params["embed"], params["pos"],
                                       params["head"],
                                       *params["blocks"].values()))
    engine = InferenceEngine(params, num_heads=SERVE["num_heads"],
                             batch_slots=SLOTS, max_seq=MAX_SEQ)
    log(f"[serve] {n_params / 1e6:.1f} M f32 params, KV cache "
        f"{engine.kv_bytes() / 1e6:.1f} MB, set-up {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    warm = [Request(uid=f"warm{n}", prompt=rng.integers(1, SERVE["vocab_size"], n).tolist())
            for n in (64, 128, 256, 512)]  # one request per prompt bucket
    ContinuousBatchingScheduler(engine, max_new_tokens=2).run(warm)
    requests = synthetic_requests(REQUESTS, vocab_size=SERVE["vocab_size"],
                                  max_prompt=512, min_prompt=64,
                                  rng=np.random.default_rng(0))

    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fd.launches = 0
    torch.cuda.synchronize()
    results, report = ContinuousBatchingScheduler(
        engine, max_new_tokens=NEW_TOKENS).run(requests)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.launches, "flash_decode": fd.launches}
    log(f"[serve] launches during the run: {launches} (expected "
        f"{REQUESTS * SERVE['num_layers']} prefill, "
        f"{report.decode_steps * SERVE['num_layers']} decode)")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if fa.launches_dq or fa.launches_dkv:
        raise AssertionError("serving launched a backward kernel")
    if launches["flash_attention_fwd"] != REQUESTS * SERVE["num_layers"] or (
        launches["flash_decode"] != report.decode_steps * SERVE["num_layers"]
    ):
        raise AssertionError(f"unexpected launch counts {launches}")
    log(f"[serve] {report.requests} requests, {report.generated_tokens} tokens, "
        f"{report.decode_steps} decode steps, finish {report.finish_reasons}")
    log(f"[serve] tokens/s {report.tokens_per_sec} | TTFT p50 "
        f"{report.ttft_s['p50'] * 1e3:.2f} ms p99 {report.ttft_s['p99'] * 1e3:.2f} ms"
        f" | decode step p50 {report.decode_step_s['p50'] * 1e3:.3f} ms"
        f" | decode tokens/s {report.decode_tokens_per_sec}"
        f" | peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
    log("[serve] report " + json.dumps(report.to_dict()))
    if report.finish_reasons != {"length": REQUESTS}:
        raise AssertionError(f"finish reasons {report.finish_reasons}")
    for r in results:
        if len(r.tokens) != NEW_TOKENS or not all(
            0 <= t < SERVE["vocab_size"] for t in r.tokens
        ):
            raise AssertionError(f"{r.uid}: bad token stream {r.tokens}")
    by_uid = {r.uid: r for r in results}
    for req in sorted(requests, key=lambda r: len(r.prompt))[:2]:
        want = naive_greedy(torch, forward, engine.params, req.prompt, NEW_TOKENS)
        got = by_uid[req.uid].tokens
        same = got == want
        log(f"[serve] {req.uid} (prompt {len(req.prompt)}): greedy tokens equal "
            f"the dense full-forward oracle: {same}")
        if not same:
            raise AssertionError(f"{req.uid}: engine {got} != oracle {want}")
        err, scale = teacher_forced_error(
            torch, engine.params, list(req.prompt) + got, len(req.prompt))
        log(f"[serve] {req.uid}: teacher-forced logits, kernel path vs dense "
            f"forward: max|d|={err:.3e} (largest |logit| {scale:.3f}, "
            f"tolerance {LOGIT_RTOL:g} of it)")
        if not err <= LOGIT_RTOL * scale:
            raise AssertionError(f"{req.uid}: serving logits drift {err}")

    # where a step's time goes: host wall vs CUDA kernel time (profiler)
    pos = np.full(SLOTS, 300, np.int32)
    toks = np.arange(1, SLOTS + 1, dtype=np.int32)
    prompt = rng.integers(1, SERVE["vocab_size"], 512).tolist()
    for name, fn, steps in (
        ("decode step (8 slots, pos 300)", lambda: engine.decode(toks, pos), 10),
        ("prefill (512 tokens)", lambda: engine.prefill(0, prompt), 3),
    ):
        wall, busy, top = profile_share(torch, fn, steps)
        share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
        log(f"[profile] {name}: host wall {wall:.3f} ms, kernel time {share} on {card}")
        for key, ms in top[:6]:
            log(f"[profile]   {ms:8.4f} ms  {key[:90]}")
    return launches


def _causal_pairs(s: int) -> int:
    return s * (s + 1) // 2  # visible (query, key) pairs of one head


def phase_bwd(torch, F, fa, card):
    """K2 and K3 against the plain backward; returns their JSON rows
    (timed at the training shape S=2048)."""
    b, h, d = 8, 12, 64
    worst = {"dq": 0.0, "dkv": 0.0}
    rows = {}
    for s in (37, 576, 2048):
        g = torch.Generator(device="cuda").manual_seed(s)
        qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda")
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        o, lse = fa.flash_attention_core(q, k, v, causal=True)
        do = torch.randn(o.shape, generator=g, device="cuda")
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, causal=True)
        dk, dv = fa._launch_bwd_dkv(q, k, v, do, lse, delta, causal=True)
        want = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=True)
        torch.cuda.synchronize()
        parts = []
        for name, got, ref, kern in (("dQ", dq, want[0], "dq"),
                                     ("dK", dk, want[1], "dkv"),
                                     ("dV", dv, want[2], "dkv")):
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            finite = bool(torch.isfinite(got).all())
            worst[kern] = max(worst[kern], err)
            parts.append(f"max|d{name}|={err:.3e} (of max {scale:.3f})")
            if not finite or err > BWD_RTOL * scale:
                raise AssertionError(f"K2/K3 {name} disagrees at S={s}")
        log(f"[bwd] S={s}: " + ", ".join(parts)
            + f"; tolerance {BWD_RTOL:g} of the max")
        del want
        if s != 2048:
            continue
        ms_dq = device_ms(torch, lambda i: fa._launch_bwd_dq(
            q, k, v, do, lse, delta, causal=True), iters=10)
        ms_dkv = device_ms(torch, lambda i: fa._launch_bwd_dkv(
            q, k, v, do, lse, delta, causal=True), iters=10)
        plain_ms = device_ms(torch, lambda i: fa._dense_attention_bwd(
            q, k, v, do, lse, delta, causal=True), iters=3, warmup=1)
        # yardstick: autograd through SDPA, graph built once
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        lib_ms = device_ms(torch, lambda i: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=5, warmup=2)
        pairs = b * h * _causal_pairs(s)
        head = 4.0 * b * s * h * d  # one [B, S, H, D] f32 tensor
        rows_in = 4 * head + 2 * 4.0 * b * h * s  # q, k, v, dO; lse, delta
        # the function each kernel computes: dQ needs S, dP and dS K
        # (6 D flops a pair); dK, dV need S, dP, P^T dO and dS^T Q (8 D)
        b_dq = bound_ms(rows_in + head, 6.0 * d * pairs)
        b_dkv = bound_ms(rows_in + 2 * head, 8.0 * d * pairs)
        whole = bound_ms(rows_in + 3 * head, 10.0 * d * pairs)
        log(f"[bwd] S=2048 B=8 H=12 D=64 causal: K2 {ms_dq:.4f} ms (bound "
            f"{b_dq[0]:.4f} ms, {b_dq[1]}), K3 {ms_dkv:.4f} ms (bound "
            f"{b_dkv[0]:.4f} ms, {b_dkv[1]}), plain backward {plain_ms:.4f} ms, "
            f"sdpa backward {lib_ms:.4f} ms on {card}")
        log(f"[bwd] whole backward: K2+K3 {ms_dq + ms_dkv:.4f} ms against "
            f"{whole[0]:.4f} ms for the 5 products (10 D flops a pair, "
            f"{whole[1]}); the two-pass design recomputes S and dP "
            f"(4 D more a pair, {4.0 * d * pairs / 1e9:.1f} GFLOP)")
        shape = "B=8 H=12 S=2048 D=64 causal f32 (strided qkv views)"
        rows["dq"] = dict(ms=ms_dq, plain_ms=plain_ms, bound_ms=b_dq[0],
                          bound_by=b_dq[1], library_ms=lib_ms, shape=shape)
        rows["dkv"] = dict(ms=ms_dkv, plain_ms=plain_ms, bound_ms=b_dkv[0],
                           bound_by=b_dkv[1], library_ms=lib_ms, shape=shape)
        del out, qt, kt, vt
    for kern in rows:
        rows[kern]["max_abs_err"] = worst[kern]
    torch.cuda.empty_cache()
    return rows


def phase_grad_parity(torch, np):
    """Loss and every parameter gradient of the full-width LM at batch 1,
    seq 2048: flash attention (K1, K2, K3) against dense."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, init_params, next_token_loss,
    )
    from distributeddeeplearning_tpu_torch.train.state import tree_leaves

    cfg = {k: v for k, v in TRAIN.items() if k not in ("seq_len", "batch_size")}
    s = TRAIN["seq_len"]
    params = init_params(torch.Generator().manual_seed(1), max_len=s,
                         device="cuda", **cfg)
    names = ["embed", "pos", *(f"blocks.{k}" for k in params["blocks"]), "head"]
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg["vocab_size"], (1, s))).cuda()
    out = {}
    for attention in ("flash", "dense"):
        loss = next_token_loss(forward(params, toks, num_heads=cfg["num_heads"],
                                       attention=attention), toks)
        out[attention] = (loss.item(), torch.autograd.grad(loss, leaves))
    (lf, gf), (ld, gd) = out["flash"], out["dense"]
    log(f"[grad] full width, batch 1, seq 2048: loss flash {lf:.7f} dense "
        f"{ld:.7f} (|d| {abs(lf - ld):.2e})")
    if abs(lf - ld) > 1e-5 * abs(ld):
        raise AssertionError("flash and dense losses disagree")
    worst = 0.0
    for name, a, r in zip(names, gf, gd):
        share = (a - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        worst = max(worst, share)
        if not share <= GRAD_RTOL:
            raise AssertionError(f"gradient of {name} disagrees: {share:.2e}")
    log(f"[grad] every leaf's max|dg| within {worst:.2e} of its max|g| "
        f"(tolerance {GRAD_RTOL:g}) over {len(names)} leaves")
    del out, gf, gd, params, leaves
    torch.cuda.empty_cache()


def phase_train(torch, np, fa, card):
    """The port's LM workload at the reference configuration; returns the
    launch counts of the run."""
    import tempfile

    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        next_token_loss,
    )
    from distributeddeeplearning_tpu_torch.train.step import build_train_step
    from distributeddeeplearning_tpu_torch.workloads import transformer

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        torch.cuda.synchronize()
        state, result = transformer.main(
            epochs=TRAIN_EPOCHS, steps_per_epoch=1,
            train_examples=TRAIN["batch_size"], attention="flash",
            compute_dtype="float32", device="cuda", metrics_path=path, **TRAIN)
        torch.cuda.synchronize()
        launches = {"flash_attention_fwd": fa.launches,
                    "flash_attention_bwd_dq": fa.launches_dq,
                    "flash_attention_bwd_dkv": fa.launches_dkv}
        with open(path) as f:
            rows = [json.loads(line) for line in f]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers, steps = TRAIN["num_layers"], TRAIN_EPOCHS
    want = {"flash_attention_fwd": layers * (steps + TRAIN_EPOCHS),
            "flash_attention_bwd_dq": layers * steps,
            "flash_attention_bwd_dkv": layers * steps}
    log(f"[train] launches during the run: {launches} (expected {want}: 12 "
        f"per forward, {steps} train steps and {TRAIN_EPOCHS} eval passes)")
    if launches != want:
        raise AssertionError(f"unexpected launch counts {launches}")
    losses = [r["train_loss"] for r in rows]
    log(f"[train] loss by step: {[round(x, 5) for x in losses]}; final "
        f"train {result.final_train_metrics}, eval {result.final_eval_metrics}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on the repeated batch")
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad} in epoch {r['epoch']}")
    tokens = TRAIN["batch_size"] * TRAIN["seq_len"]
    step_s = sorted(TRAIN["batch_size"] / r["images_per_second"] for r in rows[1:])
    p50 = float(np.median(step_s))
    n_params = sum(t.numel() for t in (state.params["embed"], state.params["pos"],
                                       state.params["head"],
                                       *state.params["blocks"].values()))
    b, s, d = TRAIN["batch_size"], TRAIN["seq_len"], TRAIN["d_model"]
    flops = 6 * n_params * tokens + 3 * (2 * b * s * s * d) * layers
    mfu = flops / p50 / F32_FLOPS_PER_S
    log(f"[train] {n_params / 1e6:.1f} M params; step p50 {p50 * 1e3:.1f} ms "
        f"(steps 2..{steps}: {[round(x * 1e3, 1) for x in step_s]} ms), "
        f"tokens/s {tokens / p50:.1f}, mfu {mfu:.4f} of 67 TFLOP/s f32 "
        f"({flops / 1e12:.2f} TFLOP a step), first step "
        f"{TRAIN['batch_size'] / rows[0]['images_per_second']:.2f} s, peak "
        f"memory {peak_gb:.2f} GB on {card}")

    step = build_train_step(
        state, compute_dtype=torch.float32,
        loss_fn=lambda lg, lb, label_smoothing=0.0: next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss})
    batch = next(transformer._token_batches(b, s, TRAIN["vocab_size"], 42,
                                            b, repeat=False))
    wall, busy, top = profile_share(torch, lambda: step(state, batch), 2)
    share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
    log(f"[profile] train step (B=8, S=2048, f32, flash): host wall "
        f"{wall:.3f} ms, kernel time {share} on {card}")
    groups = {"f32 GEMMs (cuBLAS/CUTLASS)": 0.0, "K1 flash_fwd_kernel": 0.0,
              "K2 flash_bwd_dq_kernel": 0.0, "K3 flash_bwd_dkv_kernel": 0.0,
              "everything else": 0.0}
    for key, ms in top:
        group = ("f32 GEMMs (cuBLAS/CUTLASS)" if "gemm" in key.lower() else
                 "K1 flash_fwd_kernel" if "flash_fwd_kernel" in key else
                 "K2 flash_bwd_dq_kernel" if "flash_bwd_dq_kernel" in key else
                 "K3 flash_bwd_dkv_kernel" if "flash_bwd_dkv_kernel" in key else
                 "everything else")
        groups[group] += ms
    for group, ms in groups.items():
        log(f"[profile]   {ms:9.3f} ms  {ms / max(busy or 1e-9, 1e-9):6.1%}  {group}")
    for key, ms in top[:10]:
        log(f"[profile]   {ms:8.4f} ms  {key[:90]}")
    del state, step
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from distributeddeeplearning_tpu_torch import resolve_device
        from distributeddeeplearning_tpu_torch.ops import _build
        from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
        from distributeddeeplearning_tpu_torch.ops import flash_decode as fd
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    try:
        resolve_device("cuda")  # TF32 off: the parity contract is f32
        card = card_line()
        log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        times = _build.build_all()
        log(f"[build] {len(times)} kernels in {time.perf_counter() - t0:.2f} s "
            f"(parallel nvcc): {times}")
        for name, text in _build.build_log.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
        k1 = phase_k1(torch, F, fa, card)
        k4 = phase_k4(torch, F, fd, card)
        served = phase_serve(torch, np, fa, fd, card)
        torch.cuda.empty_cache()
        bwd = phase_bwd(torch, F, fa, card)
        phase_grad_parity(torch, np)
        trained = phase_train(torch, np, fa, card)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    rows = [
        dict(name="flash_attention_fwd", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:160",
             launches=trained["flash_attention_fwd"],
             launches_by_path={"serve": served["flash_attention_fwd"],
                               "train": trained["flash_attention_fwd"]}, **k1),
        dict(name="flash_decode", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=served["flash_decode"], **k4),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:335",
             launches=trained["flash_attention_bwd_dq"], **bwd["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:355",
             launches=trained["flash_attention_bwd_dkv"], **bwd["dkv"]),
    ]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

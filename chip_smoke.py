#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (the port's package sits beside this
script); it needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch
built for CUDA, and imports nothing of jax or of the JAX package.  Phases:

1. build: compile every CUDA kernel from ``csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time and each kernel's
   registers and spills;
2. K1, the causal flash-attention forward (f32: split TF32 on the
   tensor cores, three TF32 products a product), against its plain
   PyTorch version at the prefill shapes B=1, H=12, D=64, S in {128, 512,
   576} (576 is a ragged tile) and at the training shape B=8, S=2048,
   inputs as the model's strided qkv split; timed at B=1 S=512 and at the
   training shape, each with its TFLOP/s, both bounds (split TF32 and the
   f32 FMA rate), SDPA beside it and the query rows a block its launcher
   took; the build lines give each f32 K1 instance's registers, spills
   and dynamic shared memory;
2a. bf16 K1 (tensor cores: wgmma on TMA tiles, a warp-specialised ring)
   at S in {1, 37, 576, 2048} (B=8 at 2048, else
   2), causal and not, on strided bf16 qkv views: held against its bf16
   plain version and, with it, against the f32 result of the same bf16
   inputs (the kernel's error there at most twice the plain version's
   plus one bf16 ulp of max |o|; lse within 1e-4 of the plain one); timed
   at B=1 S=512 (serving) and B=8 S=2048 (training), each with its
   TFLOP/s, its share of the bound and the query rows a block its launcher
   took; the build lines give each bf16 K1 instance's registers, spills and
   dynamic shared memory;
3. K4(a), decode attention, against its plain version at b=8, h=12,
   hd=64, S=576 on the strided layer views of a real [8, 12, 576, 12, 64]
   cache, with unequal positions including 0 and S-1; NaN written into K
   and V past every slot's position must leave the output finite and
   bitwise the unpoisoned one;
4. K4(b), the same kernel with 64 queries: one chunk of chunked prefill
   (b=1, nq=64) through a scrambled 9-page table on the strided layer
   views of a [73, 12, 64, 12, 64] f32 pool, at offsets 0, 200 and 512;
5. K4(c), its int8 variant on a quantize_kv pool: decode with the own-token
   overlay (b=8, nq=1, K4(a)'s positions) and a chunk without it (nq=64);
   a NaN scale at a visible position must make its slot NaN and no other;
5a. K4 at nq = K+1 = 5 through the speculative-verify wrapper (b=8 slots,
   ``posmat = pos + arange(5)``, pos over 0..571) on the scrambled f32
   pool; every column must equal an nq=1 launch at pos+j bitwise;
5b. the int8 weight product (``torch._int_mm``, rows padded to its
   minimum) at the model's weight shapes and the head, 8 and 40 rows: the
   int32 accumulator equals a float64 product exactly, qdot's rescale is
   within 1e-6 relative;
6. dense serving end to end: the 12-layer causal LM at full width (d_model
   768, 12 heads, d_ff 3072, vocab 32768; random weights from seed 0 with
   the tied 4x embedding head) served by ``InferenceEngine`` (8 slots,
   max_seq 576) under ``ContinuousBatchingScheduler(max_new_tokens=32)``
   over 16 synthetic requests of 64..512 tokens.  The kernels' launch
   counters are zeroed just before the run and read just after; the
   greedy tokens of the two shortest requests must equal a naive oracle
   that recomputes the full dense forward each step;
7. paged serving end to end: 16 requests with a shared 128-token prefix
   (64..384 more tokens each) on ``PagedInferenceEngine`` (page 64, chunk
   64, the default 72-page pool) four times — f32, int8, f32 without the
   prefix cache, and int8 through the plain read (``decode_kernel=
   "gather"``) — each with the counters zeroed just before and read just
   after: K4 must launch 12 times per chunk and per decode step (int8
   runs: every launch int8; the gather run: none), K1 never.  Paged f32
   tokens must equal the dense engine's on the same requests, the prefix
   hit run the cold run's, int8 kernel tokens the int8 plain-read
   tokens, and a teacher-forced check holds chunked prefill + paged
   decode to the dense forward;
7a. speculative serving (K = 4): the paged f32 engine with the truncated
   drafter (the first 2 layers), the int8-weight drafter and a
   forced-rejection drafter (first 4 requests), and the dense engine with
   the truncated drafter, on the paged and dense runs' requests; each run
   with the counters zeroed just before and read just after: verify
   launches = 12 a spec step, draft launches = K x M a step, chunks 12
   each; tokens must equal the non-speculative run's, the rejection run's
   acceptance be 0 and its pool equal a never-drafted twin's, and one
   verify pass hold to five sequential decode steps (logits within 1e-5
   of the largest); a spec step is profiled beside a decode step;
8. K2 and K3, the f32 flash-attention backward (dQ pass, dK/dV pass; split
   TF32 on the tensor cores: three TF32 products a product), against their
   plain version at the training shape B=8, H=12, D=64, S=2048, causal,
   and at S in {37, 130, 576} (ragged tiles), inputs as strided qkv views
   with a random dO; timed at the training shape with the rows a block
   each pass took, TFLOP/s, both bounds (split TF32 and the f32 FMA rate)
   and K2+K3 against autograd through SDPA; the build lines give each f32
   K2 and K3 instance's registers, spills and dynamic shared memory;
8a. bf16 K2 and K3 (tensor cores: wgmma on TMA tiles, a warp-specialised
   ring, like bf16 K1) the same way at S in {37, 576, 2048}, causal and
   not, with a random bf16 dO, against the bf16 plain backward and the
   f32 backward of the same inputs; timed at the training shape on the
   causal case's inputs, with TFLOP/s, the rows a block each launcher took
   and autograd through bf16 SDPA as the yardstick; the build lines give
   each bf16 K2 and K3 instance's registers, spills and dynamic shared
   memory;
9. gradient parity at full width: one loss and gradient of the 12-layer
   LM at batch 1, seq 2048, flash (K1 + K2/K3) against dense attention;
9a. the same in bf16 (f32 params cast inside the loss): flash through the
   bf16 kernels against dense bf16 — loss within 1e-2 relative, every
   leaf's gradient within 5e-2 of its largest |gradient| — with the f32
   dense gradients logged beside them;
10. training end to end: the port's ``workloads.transformer.main`` at the
   reference configuration (12 layers, d 768, 12 heads, ff 3072, vocab
   32768, seq 2048, batch 8, flash attention, f32), 8 epochs of one step
   on one repeated batch.  The counters are zeroed just before it; K1 must
   count 12 per forward (train and eval), K2 and K3 12 per train step; the
   loss must fall and every metric be finite.  It prints the step time
   p50, tokens/s, model-FLOPs utilisation of the f32 peak (``mfu``, with
   ``bench.py``'s convention 6NT + causal attention) and peak memory, and
   a profiler breakdown of one train step;
11. the same training run at the reference's default, ``compute_dtype``
   left to bf16: the bf16 counters must count as K1-K3 did in f32 and
   the f32 counters 0; each step's loss must lie within 1e-2 relative of
   the f32 run's (same seed, same batch); mfu is over 989.4 TFLOP/s, the
   spec-sheet dense bf16 peak;
12. ``phase_k4_bf16`` (after 5a): K4 on bf16 pages under bf16 queries at
   the decode shape (b=8, nq=1, hd=64, S=576) and the chunk shape (nq=64),
   and on int8 pages under bf16 queries with the bf16 overlay, each held
   to its plain version (1e-4), to the f32 result of the same bf16 inputs
   (the bf16 kernels' rule, ``hold_bf16``) and, bitwise, to the f32 launch
   on widened copies; timed
   beside SDPA on the pre-gathered bf16 history with a boolean mask;
13. ``phase_serve_bf16`` (after 7a): the full-width serve model with bf16
   weights (the f32 cells' weights cast) on a dense bf16 cache (the dense
   cell's requests, and the paged cell's), bf16 pages with the 128-token
   shared prefix and a cold twin, and int8 pages under bf16 weights; exact
   launch counts (bf16 K1 and bf16 K4 counters take every launch, every
   f32 counter 0), hit == cold tokens, paged == dense (one bf16 prompt
   pass in both layouts, then 32 decode steps on each, logits bitwise
   equal; the two engines' streams, whose prompt passes round apart, are
   compared and their agreement logged), bf16 kv_bytes_peak exactly half
   the f32 paged run's, greedy tokens equal a bf16 dense full-forward
   oracle and teacher-forced logits within 5e-2 of the largest; decode
   steps profiled;
14. ``phase_headdim``: every kernel (K1, K2, K3 in f32 and bf16; K4 a, b,
   c, verify and bf16 pages) at head dims 8, 16 and 32 against its plain
   version under the head-dim-64 tolerances, timed at one shape each (f32
   K1 and K4 have instances at 8; K2, K3 and bf16 K1 at 8 run at 16 on
   zero-padded copies);
15. ``phase_default_geometries``: the dense and paged engines at `ddlt
   serve`'s geometry (2 layers, d 64, 4 heads: head dim 16, vocab 257)
   with their default flash prefill and decode kernel, f32 and int8
   weights (N = 257 through the padded int8 product), greedy streams
   equal to a dense oracle; then ``workloads.transformer.main(attention=
   "flash")`` at its own defaults (head dim 32, vocab 1031) in f32 and
   bf16, the loss falling; exact launch counts in every run;
15a. ``phase_serve_d8``: head dim 8 at ``bench.py --small``'s serving
   geometry (2 layers, d 32 over 4 heads, ff 64, vocab 509; 4 slots of 64,
   pages and chunks of 16; 8 requests behind an 8-token shared prefix, 6
   new tokens): the dense engine (K1 prefill, K4 decode), the paged engine
   on f32 and int8 pages and the int8 engine through the plain read, exact
   launch counts, f32 greedy tokens equal to a dense oracle, int8 kernel
   tokens equal to the plain read's, teacher-forced dense and paged logits
   within 1e-4 of the largest;
16. ``phase_bias``: K1, K2, K3 built with the key-padding bias
   (``HAS_BIAS``) against their plain versions, f32 and bf16, head dims 16,
   32, 64, causal and not, S in {1, 37, 128, 512}, the masks synthetic-text
   lengths plus a length-1 row, a full row and an all-masked row (its lse,
   -1e30 * ln 2, bitwise equal to the plain version's); masked keys of
   every other row get dK = dV = 0 exactly; the same at bert-base's own
   B=8, H=12, D=64, S 128 and 512, non-causal; then held and timed at
   bert-base's shape (B=8, H=12, S=512, D=64, non-causal, a synthetic-text
   mask) beside the plain versions and SDPA with the same boolean
   ``attn_mask``;
17. ``phase_bert``: ``workloads.bert.main`` at bert-base's full width
   (109.5 M params), one epoch of 8 steps and one eval pass, at its
   defaults (bf16, batch 8, seq 128), at seq 512 and in f32 at seq 128:
   flash and the default attention at dropout 0 with the same seed
   (per-step losses within 1e-2 relative in bf16, 1e-5 in f32), and at
   the defaults flash at dropout 0.1 (finite); the flash runs launch
   exactly the bias kernels of their dtype (12 K1 a forward, 12 K2 and 12
   K3 a train step), every other counter 0, and call no plain version.
   Step time p50 (CUDA-event spans from one step's launch to the next),
   tokens/s (padded positions counted), mfu (6NT + 3 x the
   non-causal 4 B H S^2 D attention term) and peak memory; a profiled
   step's breakdown beside a CUDA-event span of the same steps (more than
   10% apart marks it untrusted; ``phase_train``'s breakdown says the
   same).

K4 (``csrc/flash_decode.cu``) runs in two passes from one C call: a
split pass with one block per (span of 64 absolute positions, head, slot)
that stages the span's K/V rows in shared memory once (16-byte copies,
every row in flight, bf16 and int8 widened to f32 there) and serves every
query of the slot from that tile, a warp a query, writing each query's
online-softmax state (m, l, acc) to a scratch; and a merge pass that
combines a query's spans in ascending order.  The serving profiles give
K4's time a step with both passes under one name.  ``scripts/
time_decode.py --root DIR`` times K4 of another checkout beside this one
on one card.

Kernel, plain and library times are device times: torch.profiler's sum
of the CUDA work each call runs, averaged over many calls after warm-up
(for K1 and K4 the log also gives a CUDA-event span around a launch loop,
which at these small shapes counts the host's launch gaps too); the
decode kernel cycles through the cache's 12 layers so its history is not
served from L2.  ``bound_ms`` is the least time the card could take: the
larger of the bytes moved (inputs read once, outputs written once) over
3.35 TB/s and the flops over 67 TFLOP/s (the H100's f32 peak on CUDA
cores, which is what the f32 decode kernel uses), for the f32 forward and
backward over 164.9 TFLOP/s (split TF32: a third of the 494.7 TFLOP/s
dense TF32 peak; their rows give the 67 TFLOP/s bound beside, as
``fma_bound_ms``) or, for the bf16 kernels, over 989.4 TFLOP/s (dense bf16
on the tensor cores).  ``library_ms`` times
one ``scaled_dot_product_attention`` call on the same inputs (for K2/K3,
``torch.autograd.grad`` through it, graph built once; for K4(b), on the
history gathered beforehand, since it cannot follow block tables), a
yardstick the port never calls; K4(c) has none (no single PyTorch call
takes int8 K/V).  The int8 bound counts 2*(hd + 4) bytes per visible
position and head.  ``launches`` is the count in the path that runs the
kernel: training for K1, K2, K3; dense serving for K4(a); the f32 paged
run's chunks for K4(b), the int8 paged run for K4(c) and the four
speculative runs for the verify row.  The verify row's bound counts each
(slot, head)'s visible history once for all K+1 queries.

The six bias rows (``flash_attention_fwd_bias``, ``..._bwd_dq_bias``,
``..._bwd_dkv_bias``, each in f32 and ``_bf16``) take their launches from
``phase_bert``'s flash runs at dropout 0 (``bert_flash``: seq 128 in the
row's dtype; ``bert_flash_seq512`` beside it for bf16), and their bound
counts the (query, key) pairs the run's mask leaves visible.

Each row of the kernels line carries ``head_dims``: the phase-14 entry
of the kernel at head dims 8, 16 and 32, with the launches of the phase-15
(15a at 8) main path that runs it there (0 where none does).

Output: progress lines, then one JSON line with a row per kernel, the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives,
and last ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero before that last line.  Without a card, or without the package
beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 on CUDA cores
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM spec sheet, dense bf16 tensor cores
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM spec sheet, dense TF32 tensor cores
# the f32 K2/K3's route: split TF32, three TF32 products for each product
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3

K1_TOL = 1e-4  # f32 rounding: sums over <= 576 terms in another order
K4_TOL = 1e-4
LOGIT_RTOL = 1e-4  # of the largest |logit|: f32 through 12 layers, 2 paths
# K2/K3: of the largest |gradient|; f32 sums of up to 2048 terms, twice
# (dP = dO V^T, then dS K or dS^T Q), in another order than cuBLAS
BWD_RTOL = 1e-4
# full-width gradient parity, of each leaf's largest |gradient|: f32
# rounding of two attention paths carried back through 12 layers
GRAD_RTOL = 1e-3

LSE_TOL = 1e-4  # lse is f32 in every dtype: f32 sums in another order
# full-width bf16 gradient parity, flash vs dense, of each leaf's largest
# |gradient|: the two paths round attention differently (dense rounds the
# Q K^T product and P V's output to bf16, flash keeps S in f32 and rounds P
# against a running max), a bf16 ulp here and there carried through 12
# layers; and the relative loss difference
GRAD_RTOL_BF16 = 5e-2
LOSS_RTOL_BF16 = 1e-2
# bf16 training vs the f32 run, same seed and batch, relative, every step
TRAIN_LOSS_RTOL_BF16 = 1e-2

TRAIN = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
             vocab_size=32768, seq_len=2048, batch_size=8)
TRAIN_EPOCHS = 8  # one step each: every epoch end is a timed sync point

SERVE = dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
             vocab_size=32768)
SLOTS, MAX_SEQ, REQUESTS, NEW_TOKENS = 8, 576, 16, 32
PAGE, CHUNK = 64, 64  # the CLI's defaults (cli/main.py:379, :386)
POOL_PAGES = SLOTS * MAX_SEQ // PAGE  # the paged engine's default pool, 72
# speculative decoding: K drafts a step; the truncated drafter's depth is
# L // 6, as bench.py's spec run sets it (bench.py:1676-1680)
SPEC_K = 4
DRAFT_LAYERS = SERVE["num_layers"] // 6
SPEC_POS = (0, 571, 17, 300, 64, 507, 128, 450)  # pos + K stays <= 575
INT_MM_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 32768))
QDOT_RTOL = 1e-6  # three f32 roundings (acc, x a_scale, x w_scale) of a f64 value
# verify vs sequential decode, of the largest |logit| (or |K/V|): the same
# f32 math with the GEMMs at 8 x 5 rows instead of 8, where cuBLAS may
# pick another kernel and sum in another order
VERIFY_RTOL = 1e-5


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


#: profiler windows that recorded no device time, timed by CUDA events
#: instead (the run's last lines say how many)
EVENT_TIMED = []
#: profiler windows that lost some launch records (the run's last lines say
#: how many): their kernels were timed by the launches recorded
PARTIAL_WINDOWS = []
#: the port's kernel instances the run's profiles saw, by the name a
#: profile group matches them on (``flash_fwd_f32_kernel``, ``flash_decode``)
PROFILED = {}


def device_ms(torch, fn, iters: int = 20, warmup: int = 3, by_kernel=None) -> float:
    """Mean device time per call of ``fn``: every kernel, copy and set it
    ran, from torch.profiler over ``iters`` calls after warm-up (and, into
    a dict ``by_kernel``, split by kernel function, template arguments
    dropped).
    Unlike a CUDA-event span around a launch loop (:func:`cuda_ms`), it
    leaves out the gaps in which the card waits for the host to prepare
    the next launch, which dominate at the serving shapes.  torch.profiler
    does not record every launch of a window: late in a long process most
    windows lose a few (17 of 20 calls of a kernel recorded, 7 of 10;
    ``scripts/bwd_step_gap.py`` counts them), so the recorded sum over
    ``iters`` reads low.  Each kernel is therefore timed by its mean over
    the launches the window recorded, times the launches one call makes:
    its recorded count over ``iters``, rounded up, which is exact while
    fewer than ``iters`` of its launches are lost (1 to 4 seen); for a
    window that recorded every launch this is the sum over ``iters``.
    Windows that lost records are listed in :data:`PARTIAL_WINDOWS`.  Now
    and then a window records no device time at all (seen once in ~200
    windows); it is profiled once more and, failing that, timed by a
    CUDA-event span (which counts the launch gaps too) and recorded in
    :data:`EVENT_TIMED`."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
        if sum(e.self_device_time_total for e in cuda) > 0:
            per_call = [(e.key, e.self_device_time_total / 1e3 / e.count
                         * math.ceil(e.count / iters)) for e in cuda]
            if any(e.count % iters for e in cuda):
                PARTIAL_WINDOWS.append([(e.key[:60], e.count) for e in cuda])
            if by_kernel is not None:
                for key, ms in per_call:
                    key = key.replace("(anonymous namespace)::", "")
                    name = re.match(r"(?:void )?(?:[\w:]+::)?(\w+)", key).group(1)
                    by_kernel[name] = by_kernel.get(name, 0.0) + ms
            return sum(ms for _, ms in per_call)
    ms = cuda_ms(torch, fn, iters=iters, warmup=0)
    EVENT_TIMED.append(ms)
    log(f"[timer] torch.profiler recorded no device time twice; a CUDA-event "
        f"span gives {ms:.4f} ms a call (launch gaps included)")
    return ms


def timed(phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, logging its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def bound_ms(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x) -> float:
    """One bf16 ulp (8 significant bits) at the largest |x|."""
    top = x.abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def hold_bf16(got, plain, ref, what: str):
    """A bf16 kernel output against the f32 reference ``ref`` from the same
    bf16 inputs: its error may be at most twice the bf16 plain version's
    plus one bf16 ulp of max |ref|.  Returns (error, plain error, limit)."""
    err = (got.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    limit = 2 * plain_err + bf16_ulp(ref)
    if got.dtype != plain.dtype or not bool(got.float().isfinite().all()) or err > limit:
        raise AssertionError(f"{what}: error {err:.3e} against the f32 "
                             f"reference over the limit {limit:.3e} (plain "
                             f"{plain_err:.3e}, dtype {got.dtype})")
    return err, plain_err, limit


def bf16_qkv(torch, b, s, h=12, d=64, seed=0):
    """bf16 q, k, v as strided [b, s, h, d] views of one [b, s, 3*h*d]
    bf16 tensor (row stride 3*768 elements), as the model's qkv split
    makes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").bfloat16()
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def _k1_timed(torch, F, fa, q, k, v, card):
    """f32 K1 on causal (q, k, v) beside its plain version and SDPA: device
    times, a CUDA-event span, TFLOP/s, the bound at the split-TF32 rate of
    the kernel's route and the one at the CUDA cores' f32 FMA rate, and the
    query rows a block its launcher took; logged and returned as a row."""
    b, s, h, d = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    run = lambda i: fa.flash_attention_core(q, k, v, causal=True)  # noqa: E731
    big = s > 1024  # the training shape: fewer calls of the slow ones
    ms = device_ms(torch, run, iters=20 if big else 50)
    loop_ms = cuda_ms(torch, run, iters=20 if big else 50)
    plain_ms = device_ms(torch, lambda i: fa._dense_attention(q, k, v, None, causal=True),
                         iters=3 if big else 20, warmup=1 if big else 3)
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=20 if big else 50)
    flops = 4.0 * d * b * h * _causal_pairs(s)
    nbytes = 4.0 * (4 * b * s * h * d + b * h * s)  # q, k, v in; o, lse out
    bms, by = bound_ms(nbytes, flops, TF32X3_FLOPS_PER_S)
    fma, _ = bound_ms(nbytes, flops)
    rows = fa.f32_block_rows(b, h, s)
    shape = f"B={b} H={h} S={s} D={d} causal f32"
    log(f"[k1] {shape}: kernel {ms:.4f} ms ({loop_ms:.4f} ms a launch in an "
        f"event-timed loop; {rows}-row blocks, {flops / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
        f"bound {bms:.4f} ms at split TF32 ({by}, {bms / ms:.1%}), {fma:.4f} ms "
        f"at the f32 FMA rate; device times, on {card}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, fma_bound_ms=fma, event_ms=loop_ms,
                tflops=flops / ms / 1e9, block_rows=rows, shape=shape)


def phase_k1(torch, F, fa, card):
    """f32 K1 (split TF32 on the tensor cores) vs its plain version at the
    prefill shapes B=1, H=12, D=64, S in {128, 512, 576} and at the
    training shape B=8, S=2048; returns the JSON row (timed at S=512, the
    largest prompt bucket of the serving run, with the training shape's
    entry under ``train``)."""
    h, d = 12, 64
    worst_o = worst_lse = 0.0
    row = None
    for b, s in ((1, 128), (1, 512), (1, 576), (8, 2048)):
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
        log(f"[k1] B={b} S={s}: max|dO|={err_o:.3e} max|dlse|={err_lse:.3e} "
            f"(tolerance {K1_TOL:g}) finite={finite}")
        if not finite or err_o > K1_TOL or err_lse > K1_TOL:
            raise AssertionError(f"K1 disagrees with its plain version at S={s}")
        del o_ref, lse_ref
        if s == 512:
            row = _k1_timed(torch, F, fa, q, k, v, card)
        elif s == 2048:
            row["train"] = _k1_timed(torch, F, fa, q, k, v, card)
        del q, k, v, qkv
        torch.cuda.empty_cache()
    row["max_abs_err"] = max(worst_o, worst_lse)
    return row


def phase_k1_bf16(torch, F, fa, card):
    """bf16 K1 against its bf16 plain version and both against the f32
    reference from the same bf16 inputs, causal and not, on strided qkv
    views; returns the JSON row (timed at the training shape, with the
    serving shape B=1 S=512 logged beside it)."""
    h, d = 12, 64
    worst = 0.0
    for s in (1, 37, 576, 2048):
        b = 8 if s == 2048 else 2
        for causal in (True, False):
            q, k, v = bf16_qkv(torch, b, s, seed=s + causal)
            before = (fa.launches, fa.launches_bf16)
            o, lse = fa.flash_attention_core(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if (fa.launches, fa.launches_bf16) != (before[0], before[1] + 1):
                raise AssertionError("a bf16 K1 call did not launch the bf16 kernel once")
            o_plain, lse_plain = fa._dense_attention(q, k, v, None, causal=causal)
            o_ref, _ = fa._dense_attention(q.float(), k.float(), v.float(), None,
                                           causal=causal)
            err, plain_err, limit = hold_bf16(o, o_plain, o_ref, f"bf16 K1 S={s}")
            err_lse = (lse - lse_plain).abs().max().item()
            worst = max(worst, (o.float() - o_plain.float()).abs().max().item(),
                        err_lse)
            log(f"[k1-bf16] B={b} S={s} causal={causal} "
                f"({fa.bf16_block_rows(b, h, s)}-row blocks): vs f32 reference "
                f"kernel {err:.3e}, plain {plain_err:.3e} (limit 2x plain + 1 "
                f"ulp = {limit:.3e}, max|o| {o_ref.abs().max().item():.3f}); "
                f"max|dlse| vs plain {err_lse:.3e} (tolerance {LSE_TOL:g})")
            if err_lse > LSE_TOL:
                raise AssertionError(f"bf16 K1 lse disagrees at S={s}")
            del o_plain, lse_plain, o_ref

    def timed(b, s):
        q, k, v = bf16_qkv(torch, b, s, seed=99)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = device_ms(torch, lambda i: fa.flash_attention_core(q, k, v, causal=True),
                       iters=20)
        plain_ms = device_ms(torch, lambda i: fa._dense_attention(
            q, k, v, None, causal=True), iters=3, warmup=1)
        lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters=20)
        flops = 4.0 * b * h * d * _causal_pairs(s)
        nbytes = 2.0 * 4 * b * s * h * d + 4.0 * b * h * s  # q, k, v, o; lse
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"[k1-bf16] B={b} H=12 S={s} D=64 causal "
            f"({fa.bf16_block_rows(b, h, s)}-row blocks): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa bf16 {lib_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}, bf16 tensor-core peak); kernel at "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.1%} of the bound "
            f"(sdpa {flops / lib_ms / 1e9:.1f} TFLOP/s); device times, on {card}")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, tflops=flops / ms / 1e9,
                    shape=f"B={b} H=12 S={s} D=64 causal bf16 (strided qkv views)")

    prefill = timed(1, 512)
    row = timed(8, 2048)
    row["serve_prefill"] = prefill
    row["max_abs_err"] = worst
    torch.cuda.empty_cache()
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
    # stale history past each slot's position, NaN in K and V, is neither
    # read nor weighted: the output is the unpoisoned one, bit for bit
    clean = fd.decode_attention_dense(q3, cache_k[:, 0], cache_v[:, 0], None, None,
                                      None, None, pos)
    poisoned = [t[:, 0].clone() for t in (cache_k, cache_v)]
    for b, p in enumerate(pos.tolist()):
        for t in poisoned:
            t[b, p + 1:] = float("nan")
    dirty = fd.decode_attention_dense(q3, *poisoned, None, None, None, None, pos)
    torch.cuda.synchronize()
    same = torch.equal(clean, dirty)
    log(f"[k4] NaN K/V past every slot's position: output finite and bitwise the "
        f"unpoisoned one: {same and bool(torch.isfinite(dirty).all())}")
    if not same or not bool(torch.isfinite(dirty).all()):
        raise AssertionError("K4(a) read or weighted history past a position")
    del poisoned
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


def _paged_pool(torch, dtype, seed):
    """A [POOL_PAGES + 1, 12, 64, 12, 64] pool of random K/V in ``dtype``
    ("float32", "bfloat16", or "int8": through the port's quantize_kv, with
    its scale pools) and scrambled block tables over pages 1..POOL_PAGES
    for 8 slots of 9 pages."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    layers, h, hd = SERVE["num_layers"], SERVE["num_heads"], 64
    pool = {}
    for name in ("k", "v"):
        x = torch.randn((POOL_PAGES + 1, layers, PAGE, h, hd), generator=g,
                        device="cuda")
        if dtype == "int8":
            pool[name], pool[f"{name}_scale"] = quantize_kv(x)
        else:
            pool[name] = x.to(getattr(torch, dtype))
        del x
    perm = torch.randperm(POOL_PAGES, generator=torch.Generator().manual_seed(seed))
    tables = (perm + 1).reshape(SLOTS, MAX_SEQ // PAGE).to(torch.int32).cuda()
    return pool, tables


def _layer_views(pool, layer):
    """Layer ``layer``'s strided views (k, v, k_scale, v_scale) of a pool;
    the scales are None on an f32 pool."""
    return tuple(pool[n][:, layer] if n in pool else None
                 for n in ("k", "v", "k_scale", "v_scale"))


def phase_k4b(torch, F, fd, card):
    """K4(b): one 64-token chunk of a sequence (b=1, nq=64) against its
    plain version, through a scrambled 9-page table, on the strided layer
    views of a 73-page f32 pool; timed with the history 576 (offset 512)."""
    pool, tables = _paged_pool(torch, "float32", seed=6)
    layers, h, hd, C = SERVE["num_layers"], SERVE["num_heads"], 64, CHUNK
    table = tables[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((C, 3, h, hd), generator=g, device="cuda")[:, 0]  # strided
    worst = 0.0
    for offset in (0, 200, 512):
        posns = offset + torch.arange(C, device="cuda")
        for layer in (0, layers - 1):
            k_l, v_l, _, _ = _layer_views(pool, layer)
            assert not k_l.is_contiguous()
            out = fd.chunk_attention(q, k_l, v_l, None, None, table, posns)
            ref = fd._gather_chunk(q, k_l, v_l, None, None, table, posns)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            if not bool(torch.isfinite(out).all()) or err > K4_TOL:
                raise AssertionError(f"K4(b) disagrees at offset {offset}: {err}")
    log(f"[k4b] b=1 nq=64 chunk, scrambled table, offsets 0/200/512: max|dout|="
        f"{worst:.3e} (tolerance {K4_TOL:g})")
    posns = 512 + torch.arange(C, device="cuda")
    views = [_layer_views(pool, i)[:2] for i in range(layers)]
    run = lambda i: fd.chunk_attention(q, *views[i % layers], None, None,  # noqa: E731
                                       table, posns)
    ms = device_ms(torch, run, iters=120)
    plain_ms = device_ms(torch, lambda i: fd._gather_chunk(
        q, *views[i % layers], None, None, table, posns), iters=60)
    # the library call gets the history already gathered (it cannot follow
    # block tables) and a boolean mask of the visible positions
    s = MAX_SEQ
    hist = [tuple(t[table.long()].reshape(1, s, h, hd).transpose(1, 2)
                  for t in v) for v in views]
    qt = q[None].transpose(1, 2)
    mask = torch.arange(s, device="cuda")[None, :] <= posns[:, None]
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, *hist[i % layers], attn_mask=mask), iters=60)
    pairs = float((posns.long() + 1).sum().item())  # visible (query, key)
    nbytes = 4.0 * (2 * C * h * hd + 2 * s * h * hd) + 4.0 * (C + table.numel())
    flops = 4.0 * pairs * h * hd
    bms, by = bound_ms(nbytes, flops)
    log(f"[k4b] history 576, nq=64: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa (pre-gathered history, bool mask) {lib_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); device times, on {card}")
    del pool, views, hist
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, max_abs_err=worst,
                shape="b=1 nq=64 h=12 hd=64 page 64, history 576 (offset 512), "
                      "f32, scrambled table, strided pool view")


def phase_k4c(torch, fd, card):
    """K4(c): int8 decode with the own-token overlay (b=8, nq=1) and an
    int8 chunk without it (b=1, nq=64), against their plain versions on a
    real quantize_kv pool; a NaN scale must poison its slot only."""
    pool, tables = _paged_pool(torch, "int8", seed=8)
    layers, h, hd = SERVE["num_layers"], SERVE["num_heads"], 64
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn((SLOTS, 3, h, hd), generator=g, device="cuda")
    q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # strided, as the model's
    q_c = torch.randn((CHUNK, 3, h, hd), generator=g, device="cuda")[:, 0]
    posns = 512 + torch.arange(CHUNK, device="cuda")
    worst = 0.0
    for layer in (0, layers - 1):
        views = _layer_views(pool, layer)
        out = fd.decode_attention_paged(q3, *views, k_t, v_t, pos, tables)
        ref = fd._gather_decode_paged(q3, *views, k_t, v_t, pos, tables)
        out_c = fd.chunk_attention(q_c, *views, tables[1], posns)
        ref_c = fd._gather_chunk(q_c, *views, tables[1], posns)
        torch.cuda.synchronize()
        for what, o, r in (("decode+overlay", out, ref), ("chunk", out_c, ref_c)):
            err = (o - r).abs().max().item()
            worst = max(worst, err)
            log(f"[k4c] layer {layer} int8 {what}: max|dout|={err:.3e} "
                f"(tolerance {K4_TOL:g})")
            if not bool(torch.isfinite(o).all()) or err > K4_TOL:
                raise AssertionError(f"K4(c) {what} disagrees with its plain version")
    # the int8 quarantine signal: a NaN K scale at a visible position of
    # slot 3 (pos 300) makes slot 3's output NaN and leaves the rest finite
    views = _layer_views(pool, 0)
    page, row = tables[3, 2].item(), 10  # position 138
    saved = pool["k_scale"][page, 0, row].clone()
    pool["k_scale"][page, 0, row] = float("nan")
    out = fd.decode_attention_paged(q3, *views, k_t, v_t, pos, tables)
    others = torch.cat([out[:3], out[4:]])
    confined = bool(torch.isnan(out[3]).all()) and bool(torch.isfinite(others).all())
    pool["k_scale"][page, 0, row] = saved
    log(f"[k4c] NaN scale at slot 3, position 138: slot 3 all NaN and the other "
        f"7 slots finite: {confined}")
    if not confined:
        raise AssertionError("a NaN scale escaped its slot (or was not read)")
    allv = [_layer_views(pool, i) for i in range(layers)]
    run = lambda i: fd.decode_attention_paged(  # noqa: E731
        q3, *allv[i % layers], k_t, v_t, pos, tables)
    ms = device_ms(torch, run, iters=120)
    plain_ms = device_ms(torch, lambda i: fd._gather_decode_paged(
        q3, *allv[i % layers], k_t, v_t, pos, tables), iters=60)
    chunk_ms = device_ms(torch, lambda i: fd.chunk_attention(
        q_c, *allv[i % layers], tables[1], posns), iters=120)
    hist = float((pos.long() + 1).sum().item())
    nbytes = (2 * hist * h * (hd + 4) + 4.0 * 4 * SLOTS * h * hd
              + 4.0 * (2 * SLOTS + tables.numel()))  # q, own K/V, out; pos, tables
    bms, by = bound_ms(nbytes, 4.0 * hist * h * hd)
    log(f"[k4c] int8 decode b=8 S=576 with overlay: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); int8 chunk nq=64 "
        f"history 576: kernel {chunk_ms:.4f} ms; no single PyTorch call takes "
        f"int8 K/V; device times, on {card}")
    del pool, allv
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, max_abs_err=worst, chunk_ms=chunk_ms,
                shape="b=8 nq=1 h=12 hd=64 page 64, pos 0..575, int8 + f32 "
                      "scales, own-token overlay, scrambled tables")


def phase_k4v(torch, F, fd, card):
    """K4 at nq = K+1 through the verify wrapper (b=8 slots, 5 queries
    each at ``pos + arange(5)``) on the scrambled 73-page f32 pool, against
    its plain version; each column must equal an nq = 1 launch bitwise."""
    pool, tables = _paged_pool(torch, "float32", seed=12)
    layers, h, hd, k1 = SERVE["num_layers"], SERVE["num_heads"], 64, SPEC_K + 1
    pos = torch.tensor(SPEC_POS, dtype=torch.int32, device="cuda")
    posmat = (pos[:, None] + torch.arange(k1, device="cuda")).to(torch.int32)
    g = torch.Generator(device="cuda").manual_seed(13)
    # the model's strided q: the first third of a [b, K1, 3*h*hd] projection
    qkv = torch.randn((SLOTS, k1, 3 * h * hd), generator=g, device="cuda")
    q4 = qkv[..., : h * hd].reshape(SLOTS, k1, h, hd)
    worst, bitwise = 0.0, True
    for layer in (0, layers - 1):
        k_l, v_l, _, _ = _layer_views(pool, layer)
        out = fd.verify_attention_paged(q4, k_l, v_l, tables, posmat)
        ref = fd.verify_attention_paged(q4, k_l, v_l, tables, posmat, kernel="gather")
        for j in range(k1):
            one = fd.paged_attention(q4[:, j:j + 1], k_l, v_l, tables,
                                     posmat[:, j:j + 1].contiguous())
            bitwise = bitwise and torch.equal(out[:, j:j + 1], one)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        if not bool(torch.isfinite(out).all()) or err > K4_TOL:
            raise AssertionError(f"K4 verify disagrees with its plain version: {err}")
    log(f"[k4v] b=8 nq=5 verify, scrambled table, pos {list(SPEC_POS)}: "
        f"max|dout|={worst:.3e} (tolerance {K4_TOL:g}); every column equals "
        f"an nq=1 launch at pos+j bitwise: {bitwise}")
    if not bitwise:
        raise AssertionError("a verify column differs from its nq=1 launch")
    views = [_layer_views(pool, i)[:2] for i in range(layers)]
    run = lambda i: fd.verify_attention_paged(  # noqa: E731
        q4, *views[i % layers], tables, posmat)
    ms = device_ms(torch, run, iters=120)
    plain_ms = device_ms(torch, lambda i: fd.verify_attention_paged(
        q4, *views[i % layers], tables, posmat, kernel="gather"), iters=60)
    hist = [tuple(t[tables.long()].reshape(SLOTS, MAX_SEQ, h, hd).transpose(1, 2)
                  for t in v) for v in views]
    qt = q4.transpose(1, 2)
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, None, :]
            <= posmat[:, :, None])[:, None]
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, *hist[i % layers], attn_mask=mask), iters=60)
    # each (slot, head)'s visible history read once for all K+1 queries
    visible = float((pos.long() + k1).sum().item())
    pairs = float((posmat.long() + 1).sum().item())
    nbytes = (4.0 * (2 * visible * h * hd + 2 * SLOTS * k1 * h * hd)
              + 4.0 * (posmat.numel() + tables.numel()))
    bms, by = bound_ms(nbytes, 4.0 * pairs * h * hd)
    log(f"[k4v] verify b=8 nq=5: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa (pre-gathered history, bool mask) {lib_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}); device times, on {card}")
    del pool, views, hist
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, max_abs_err=worst,
                shape="b=8 nq=5 h=12 hd=64 page 64, pos 0..571 (+0..4), f32, "
                      "scrambled table, strided pool view")


def phase_int_mm(torch, card):
    """qdot's int8 x int8 product at the model's weight shapes and the
    head, for 8 rows (a decode step) and 40 (a verify pass of 8 slots x
    5): the int32 accumulator equals a float64 product exactly, and the
    rescaled output is within QDOT_RTOL of a float64 rescale."""
    from distributeddeeplearning_tpu_torch.quant import qtensor as qt

    worst = 0.0
    times = []
    for rows in (SLOTS, SLOTS * (SPEC_K + 1)):
        for k, n in INT_MM_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(rows * 7 + k + n)
            x = torch.randn((rows, k), generator=g, device="cuda")
            w = qt.quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02)
            a_scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=qt.EPS) / qt.QMAX
            xq = torch.clamp(torch.round(x / a_scale), -qt.QMAX, qt.QMAX).to(torch.int8)
            acc = qt.int8_matmul(xq, w.values)
            exact = torch.equal(acc.double(), xq.double() @ w.values.double())
            f64 = acc.double() * a_scale.double() * w.scales.double()
            rel = ((qt.qdot(x, w).double() - f64).abs()
                   / f64.abs().clamp(min=1e-300)).max().item()
            worst = max(worst, rel)
            if not exact or not rel <= QDOT_RTOL:
                raise AssertionError(
                    f"int8 product at {rows}x{k}->{n}: exact {exact}, rel {rel:.2e}")
            if n == 32768:
                wf = qt.dequantize(w)
                times.append((rows, device_ms(torch, lambda i: qt.qdot(x, w)),
                              device_ms(torch, lambda i: x @ wf)))
    log(f"[int8] torch._int_mm at {[f'{k}->{n}' for k, n in INT_MM_SHAPES]} x "
        f"rows 8/40 (padded to {qt.INT_MM_MIN_ROWS} where fewer): int32 "
        f"accumulators equal float64 exactly; qdot within {worst:.2e} relative "
        f"of a float64 rescale (tolerance {QDOT_RTOL:g})")
    for rows, q_ms, f_ms in times:
        log(f"[int8] head 768->32768, {rows} rows: qdot {q_ms:.4f} ms (quantize "
            f"+ int8 GEMM + rescale), f32 matmul {f_ms:.4f} ms; device times, on {card}")
    return worst


def naive_greedy(torch, forward, params, prompt, n, heads=None):
    """Oracle: greedy generation by a full dense forward every step."""
    heads = heads or SERVE["num_heads"]
    toks = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            logits = forward(params, torch.tensor([toks], device="cuda"),
                             num_heads=heads, attention="dense")
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def teacher_forced_error(torch, params, tokens, prompt_len, geo=None,
                         max_seq=MAX_SEQ):
    """Max |logit difference| between the serving path (flash prefill of
    the prompt, then one kernel decode step per token, on a cache of the
    weights' dtype) and one full dense forward over the same tokens, and
    the largest |logit| for scale.  The margin profile makes greedy
    streams insensitive to attention; these logits are not.  ``geo``: the
    model's geometry (default :data:`SERVE`)."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, forward_decode, forward_prefill,
    )
    from distributeddeeplearning_tpu_torch.serve import init_cache, insert_sequence

    geo = geo or SERVE
    heads = geo["num_heads"]
    toks = torch.tensor([tokens], device="cuda")
    with torch.inference_mode():
        full = forward(params, toks, num_heads=heads, attention="dense")[0]
        logits, k, v = forward_prefill(params, toks[:, :prompt_len],
                                       num_heads=heads, attention="flash")
        cache = init_cache(batch_slots=1, num_layers=geo["num_layers"],
                           max_seq=max_seq, num_heads=heads,
                           head_dim=geo["d_model"] // heads,
                           dtype=params["embed"].dtype, device="cuda")
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
        err = (torch.stack(got) - want).float().abs().max().item()
    return err, want.float().abs().max().item()


def profile_share(torch, fn, steps):
    """(host wall ms per step, CUDA kernel ms per step, top kernels, CUDA-event
    span ms per step) from torch.profiler over ``steps`` calls of ``fn``;
    kernel ms is None when the profiler records no device time.  The span
    covers the same calls on the device (first launch to last, idle gaps
    included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for _ in range(steps):
            fn()
        end.record()
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
    return wall, (total if kernels else None), top, start.elapsed_time(end) / steps


def serve_params(torch):
    """The serving cells' f32 weights: the full-width LM of ``SERVE`` from
    seed 0 with a tied 4x-gain embedding head: top-2 logit gaps dwarf f32
    reassociation noise, so token equality measures the kernels, not
    tie-breaking."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        init_params,
    )

    params = init_params(torch.Generator().manual_seed(0), max_len=MAX_SEQ,
                         device="cuda", **SERVE)
    params["embed"] *= 4.0
    params["head"] = params["embed"].T.contiguous()
    return params


def serve_requests(np, layout):
    """The serving cells' traffic: ``REQUESTS`` requests of 64..512 prompt
    tokens on the dense layout, of 64..384 with a 128-token shared prefix
    on the paged one."""
    from distributeddeeplearning_tpu_torch.serve import synthetic_requests

    extra = (dict(max_prompt=512) if layout == "dense"
             else dict(max_prompt=384, shared_prefix_len=128))
    return synthetic_requests(REQUESTS, vocab_size=SERVE["vocab_size"], min_prompt=64,
                              rng=np.random.default_rng(0), **extra)


def serve_engine(torch, np, params, layout, warm, seed, **kw):
    """A serving cell's engine (``SLOTS`` slots of ``MAX_SEQ``; paged: pages
    of ``PAGE``, chunks of ``CHUNK``) after a warm-up run of one request a
    prompt length of ``warm``, random tokens from ``seed``; the paged
    engine's stats and prefix cache are cleared after it."""
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, PagedInferenceEngine, Request,
    )

    if layout == "dense":
        engine = InferenceEngine(params, num_heads=SERVE["num_heads"],
                                 batch_slots=SLOTS, max_seq=MAX_SEQ, **kw)
    else:
        engine = PagedInferenceEngine(params, num_heads=SERVE["num_heads"],
                                      batch_slots=SLOTS, max_seq=MAX_SEQ,
                                      page_size=PAGE, prefill_chunk=CHUNK, **kw)
    rng = np.random.default_rng(seed)
    ContinuousBatchingScheduler(engine, max_new_tokens=2).run(
        [Request(uid=f"warm{n}", prompt=rng.integers(1, SERVE["vocab_size"], n).tolist())
         for n in warm])
    if layout == "paged":
        engine.reset_stats()
        engine.clear_prefix_cache()
    return engine


def fill_slots(np, engine, rng, n=300):
    """Every slot prefilled with ``n`` random tokens; returns the (tokens,
    positions) of a decode step at position ``n`` for a profile."""
    for slot in range(SLOTS):
        prompt = rng.integers(1, SERVE["vocab_size"], n).tolist()
        if hasattr(engine, "block_tables"):  # paged: reserve the new tokens' pages
            engine.prefill(slot, prompt, NEW_TOKENS)
        else:
            engine.prefill(slot, prompt)
    return np.arange(1, SLOTS + 1, dtype=np.int32), np.full(SLOTS, n, np.int32)


def phase_serve(torch, np, fa, fd, card):
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import forward
    from distributeddeeplearning_tpu_torch.serve import ContinuousBatchingScheduler

    t0 = time.perf_counter()
    params = serve_params(torch)
    n_params = sum(t.numel() for t in (params["embed"], params["pos"],
                                       params["head"],
                                       *params["blocks"].values()))
    # warm-up: one request per prompt bucket
    engine = serve_engine(torch, np, params, "dense", (64, 128, 256, 512), 1)
    log(f"[serve] {n_params / 1e6:.1f} M f32 params, KV cache "
        f"{engine.kv_bytes() / 1e6:.1f} MB, set-up and warm-up "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    requests = serve_requests(np, "dense")

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
    served = {"requests": requests, "tokens": {r.uid: r.tokens for r in results},
              "report": report}

    # where a step's time goes: host wall vs CUDA kernel time (profiler)
    pos = np.full(SLOTS, 300, np.int32)
    toks = np.arange(1, SLOTS + 1, dtype=np.int32)
    prompt = rng.integers(1, SERVE["vocab_size"], 512).tolist()
    for name, fn, steps in (
        ("decode step (8 slots, pos 300)", lambda: engine.decode(toks, pos), 10),
        ("prefill (512 tokens)", lambda: engine.prefill(0, prompt), 3),
    ):
        wall, busy, top, _ = profile_share(torch, fn, steps)
        share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
        log(f"[profile] {name}: host wall {wall:.3f} ms, kernel time {share} on {card}")
        log_k4(top, busy)
        for key, ms in top[:6]:
            log(f"[profile]   {ms:8.4f} ms  {key[:90]}")
    return launches, engine, served


def teacher_forced_paged_error(torch, params, tokens, prompt_len, geo=None,
                               max_seq=MAX_SEQ, page=PAGE, chunk=CHUNK):
    """Max |logit difference| between the paged serving path (the prompt in
    ``chunk``-token chunks through forward_prefill_chunk, then one paged
    decode step per token, f32 pool of ``page``-position pages, reversed
    block table) and one full dense forward over the same tokens, and the
    largest |logit|.  ``geo``: the model's geometry (default
    :data:`SERVE`)."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, forward_decode_paged, forward_prefill_chunk,
    )
    from distributeddeeplearning_tpu_torch.serve import init_paged_cache

    geo = geo or SERVE
    heads, nb = geo["num_heads"], max_seq // page
    cache = init_paged_cache(num_pages=nb, num_layers=geo["num_layers"],
                             page_size=page, num_heads=heads,
                             head_dim=geo["d_model"] // heads, device="cuda")
    table = torch.arange(nb, 0, -1, dtype=torch.int32, device="cuda")
    toks = torch.tensor([tokens], device="cuda")
    got = []
    with torch.inference_mode():
        full = forward(params, toks, num_heads=heads, attention="dense")[0]
        for off in range(0, prompt_len, chunk):
            real = min(chunk, prompt_len - off)
            logits, _ = forward_prefill_chunk(
                params, toks[:, off:off + real], cache, table, off, num_heads=heads)
            got.append(logits[0, :real])
        for pos in range(prompt_len, len(tokens) - 1):
            step, _ = forward_decode_paged(
                params, toks[:, pos], cache,
                torch.tensor([pos], dtype=torch.int32, device="cuda"),
                table[None], num_heads=heads)
            got.append(step)
        want = full[:len(tokens) - 1]
        err = (torch.cat(got) - want).abs().max().item()
    return err, want.abs().max().item()


PAGED_RUNS = (  # name, engine options
    ("f32", {}),
    ("int8", {"cache_dtype": "int8"}),
    ("f32_cold", {"prefix_cache": False}),
    ("int8_gather", {"cache_dtype": "int8", "decode_kernel": "gather"}),
)


def phase_serve_paged(torch, np, fa, fd, card, dense_engine):
    """The paged engine at the serving geometry (page 64, chunk 64, the
    default 72-page pool) on shared-prefix traffic: four engines, each run
    with the launch counters zeroed just before it and read just after."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward_prefill_chunk,
    )
    from distributeddeeplearning_tpu_torch.serve import ContinuousBatchingScheduler

    params = dense_engine.params
    layers, vocab = SERVE["num_layers"], SERVE["vocab_size"]
    requests = serve_requests(np, "paged")
    dense_res, _ = ContinuousBatchingScheduler(
        dense_engine, max_new_tokens=NEW_TOKENS).run(requests)
    dense_tokens = {r.uid: r.tokens for r in dense_res}
    rng = np.random.default_rng(3)
    runs = {}
    for name, kw in PAGED_RUNS:
        engine = serve_engine(torch, np, params, "paged", (72, 200), 3, **kw)
        final = {}  # prompt -> the final chunk's logits row (first token)

        def capture(task, step=engine.prefill_step, engine=engine, final=final):
            tok = step(task)
            if tok is not None:
                final[tuple(task.prompt)] = engine.last_prefill_logits.clone()
            return tok

        engine.prefill_step = capture
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        fd.launches = fd.launches_int8 = fd.launches_multi_query = 0
        torch.cuda.synchronize()
        results, report = ContinuousBatchingScheduler(
            engine, max_new_tokens=NEW_TOKENS).run(requests)
        torch.cuda.synchronize()
        counts = {"flash_attention_fwd": fa.launches, "flash_decode": fd.launches,
                  "int8": fd.launches_int8, "multi_query": fd.launches_multi_query}
        chunks, steps = engine.chunks_run, report.decode_steps
        kernel = 0 if name.endswith("gather") else layers
        want = {"flash_attention_fwd": 0,
                "flash_decode": kernel * (chunks + steps),
                "int8": kernel * (chunks + steps) if "int8" in name else 0,
                "multi_query": kernel * chunks}
        log(f"[paged] {name}: launches {counts} (expected {want}: {kernel} per "
            f"chunk and per decode step; {chunks} chunks, {steps} decode steps)")
        if counts != want:
            raise AssertionError(f"{name}: unexpected launch counts {counts}")
        if report.finish_reasons != {"length": REQUESTS}:
            raise AssertionError(f"{name}: finish reasons {report.finish_reasons}")
        for r in results:
            if len(r.tokens) != NEW_TOKENS or not all(0 <= t < vocab for t in r.tokens):
                raise AssertionError(f"{name} {r.uid}: bad token stream {r.tokens}")
        engine.allocator.check()
        if engine.allocator.pages_in_use:
            raise AssertionError(f"{name}: pages leaked")
        log(f"[paged] {name}: tokens/s {report.tokens_per_sec} | TTFT p50 "
            f"{report.ttft_s['p50'] * 1e3:.2f} ms p99 {report.ttft_s['p99'] * 1e3:.2f} ms"
            f" | decode step p50 {report.decode_step_s['p50'] * 1e3:.3f} ms | "
            f"kv_bytes_peak {report.kv_bytes_peak} of kv_bytes {report.kv_bytes} | "
            f"prefix hit rate {report.prefix_hit_rate} on {card}")
        log(f"[paged] {name} report " + json.dumps(report.to_dict()))
        runs[name] = dict(tokens={r.uid: r.tokens for r in results},
                          report=report, counts=counts, final=final,
                          engine=engine)

    f32, int8, cold, gather = (runs[n] for n, _ in PAGED_RUNS)
    for name in ("f32", "int8"):
        if not runs[name]["report"].prefix_hit_rate > 0:
            raise AssertionError(f"{name}: no prefix hit")
    if cold["report"].prefix_hit_rate != 0:
        raise AssertionError("prefix_cache=False hit the prefix cache")
    checks = (("f32 paged tokens == dense engine tokens", f32["tokens"], dense_tokens),
              ("f32 prefix hit == cold run tokens", f32["tokens"], cold["tokens"]),
              ("int8 flash tokens == int8 gather tokens", int8["tokens"],
               gather["tokens"]))
    for what, got, want in checks:
        log(f"[paged] {what}: {got == want}")
        if got != want:
            raise AssertionError(what)
    hit_diff = max((f32["final"][p] - cold["final"][p]).abs().max().item()
                   for p in cold["final"])
    log(f"[paged] prefix hit vs cold run: largest final-chunk logit difference "
        f"{hit_diff:.3e} over {len(cold['final'])} prompts, "
        f"{f32['engine'].prefix_hit_tokens} prompt tokens served from shared "
        f"pages (page 64 and chunk 64 put every hit on a chunk boundary)")
    same = sum(a == b for uid in f32["tokens"]
               for a, b in zip(f32["tokens"][uid], int8["tokens"][uid]))
    log(f"[paged] int8 vs f32 greedy token agreement: "
        f"{same / (REQUESTS * NEW_TOKENS):.4f}")
    shortest = min(requests, key=lambda r: len(r.prompt))
    err, scale = teacher_forced_paged_error(
        torch, params, list(shortest.prompt) + f32["tokens"][shortest.uid],
        len(shortest.prompt))
    log(f"[paged] {shortest.uid} (prompt {len(shortest.prompt)}): teacher-forced "
        f"logits, chunked prefill + paged decode vs dense forward: max|d|="
        f"{err:.3e} (largest |logit| {scale:.3f}, tolerance {LOGIT_RTOL:g} of it)")
    if not err <= LOGIT_RTOL * scale:
        raise AssertionError(f"paged serving logits drift {err}")

    # where a paged step's time goes (f32 engine): 8 slots at pos 300, and
    # one 64-token chunk at offset 256
    engine = f32["engine"]
    toks, pos = fill_slots(np, engine, rng)
    table = torch.from_numpy(engine.block_tables[0].copy()).cuda()
    chunk = torch.from_numpy(rng.integers(1, vocab, (1, CHUNK))).cuda()

    def one_chunk():
        with torch.inference_mode():
            forward_prefill_chunk(engine.params, chunk, engine.cache, table, 256,
                                  num_heads=SERVE["num_heads"])

    decode_wall = None
    for what, fn, n in (("paged decode step (8 slots, pos 300)",
                         lambda: engine.decode(toks, pos), 10),
                        ("prefill chunk (64 tokens at offset 256)", one_chunk, 10)):
        wall, busy, top, _ = profile_share(torch, fn, n)
        decode_wall = wall if decode_wall is None else decode_wall
        share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
        log(f"[profile] {what}: host wall {wall:.3f} ms, kernel time {share} on {card}")
        log_k4(top, busy)
        for key, ms in top[:6]:
            log(f"[profile]   {ms:8.4f} ms  {key[:90]}")
    for slot in range(SLOTS):
        engine.release(slot)
    out = {"decode_f32": f32["counts"]["flash_decode"] - f32["counts"]["multi_query"],
           "chunk_f32": f32["counts"]["multi_query"],
           "int8": int8["counts"]["int8"],
           "requests": requests, "f32_tokens": f32["tokens"],
           "f32_report": f32["report"], "f32_chunks": f32["counts"]["multi_query"] // layers,
           "decode_profile_ms": decode_wall}
    del runs, f32, int8, cold, gather, engine
    torch.cuda.empty_cache()
    return out


def _garbage_drafter(torch, Drafter, TruncatedDrafter, token):
    """The forced-rejection adversary: writes real truncated K/V at every
    draft position and proposes ``token`` (one the baseline never emits),
    so every draft is rejected and the rollback must erase every write."""

    class Garbage(Drafter):
        name = "garbage"

        def bind(self, engine):
            self.inner = TruncatedDrafter(DRAFT_LAYERS)
            self.inner.bind(engine)

        def propose(self, cache, tokens, pos):
            _, cache = self.inner.propose(cache, tokens, pos)
            return torch.full_like(tokens, token), cache

    return Garbage()


def verify_vs_decode(torch, np, engine):
    """One verify pass (8 slots x K+1 columns) against K+1 sequential decode
    steps on the same prefilled cache: ``(logits bitwise, max |d| of the
    logits, largest |logit|, argmax equal, cache writes bitwise, max |d|
    of the cache)``.  The verify GEMMs run at 8 x 5 rows, decode's at 8."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward_decode, forward_decode_paged, forward_verify, forward_verify_paged,
    )

    paged = engine.kv_layout == "paged"
    heads, k1 = SERVE["num_heads"], SPEC_K + 1
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, SERVE["vocab_size"], 150 + 37 * s).tolist()
               for s in range(SLOTS)]
    first = [engine.prefill(s, p, NEW_TOKENS) if paged else engine.prefill(s, p)
             for s, p in enumerate(prompts)]
    pos0 = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    tok0 = torch.tensor(first, dtype=torch.int32, device="cuda")
    cache = engine.cache
    saved = {k: v.clone() for k, v in cache.items()}
    tables = engine.device_tables() if paged else None
    with torch.inference_mode():
        walk, toks, pos = [], tok0, pos0
        for _ in range(k1):
            if paged:
                lg, _ = forward_decode_paged(engine.params, toks, cache, pos, tables,
                                             num_heads=heads)
            else:
                lg, _ = forward_decode(engine.params, toks, cache, pos, num_heads=heads)
            walk.append(lg)
            toks, pos = torch.argmax(lg, -1).to(torch.int32), pos + 1
        walk = torch.stack(walk, dim=1)
        walked = {k: v.clone() for k, v in cache.items()}
        for k, v in cache.items():
            v.copy_(saved[k])
        mat = torch.cat([tok0[:, None], torch.argmax(walk[:, :-1], -1).to(torch.int32)], 1)
        dlen = torch.full((SLOTS,), SPEC_K, dtype=torch.int32, device="cuda")
        if paged:
            got, _ = forward_verify_paged(engine.params, mat, cache, pos0, dlen, tables,
                                          num_heads=heads)
        else:
            got, _ = forward_verify(engine.params, mat, cache, pos0, dlen, num_heads=heads)
    out = (torch.equal(got, walk), (got - walk).abs().max().item(),
           walk.abs().max().item(),
           torch.equal(torch.argmax(got, -1), torch.argmax(walk, -1)),
           all(torch.equal(cache[k], walked[k]) for k in cache),
           max((cache[k] - walked[k]).abs().max().item() for k in cache))
    for s in range(SLOTS):
        engine.release(s)
    del saved, walked
    return out


def phase_serve_spec(torch, np, fa, fd, card, params, dense_engine, dense, paged):
    """Speculative greedy serving at full width: the paged f32 engine (page
    64, chunk 64, 8 slots) with the truncated (M = 2), int8-weight and
    forced-rejection drafters on the paged cell's traffic, and the dense
    engine with the truncated drafter on the dense cell's; K = 4.  Each run
    with the counters zeroed just before it and read just after; tokens
    equal the non-speculative run's exactly."""
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, PagedInferenceEngine, Request,
    )
    from distributeddeeplearning_tpu_torch.spec import (
        Drafter, SpeculativeDecoder, TruncatedDrafter,
    )

    layers, vocab = SERVE["num_layers"], SERVE["vocab_size"]
    first4 = paged["requests"][:4]
    seen = {t for r in first4 for t in paged["f32_tokens"][r.uid]}
    garbage = min(set(range(vocab)) - seen)
    runs = (  # name, layout, drafter, draft depth, requests, baseline tokens
        ("spec_truncated", "paged", lambda: TruncatedDrafter(DRAFT_LAYERS),
         DRAFT_LAYERS, paged["requests"], paged["f32_tokens"]),
        ("spec_int8", "paged", lambda: "int8", layers, paged["requests"],
         paged["f32_tokens"]),
        ("spec_reject", "paged",
         lambda: _garbage_drafter(torch, Drafter, TruncatedDrafter, garbage),
         DRAFT_LAYERS, first4, {r.uid: paged["f32_tokens"][r.uid] for r in first4}),
        ("spec_dense", "dense", lambda: TruncatedDrafter(DRAFT_LAYERS),
         DRAFT_LAYERS, dense["requests"], dense["tokens"]),
    )
    rng = np.random.default_rng(5)
    warm = [Request(uid=f"warm{n}", prompt=rng.integers(1, vocab, n).tolist())
            for n in (72, 200)]
    out = {}
    for name, layout, make, depth, requests, base_tokens in runs:
        if layout == "paged":
            engine = PagedInferenceEngine(
                params, num_heads=SERVE["num_heads"], batch_slots=SLOTS,
                max_seq=MAX_SEQ, page_size=PAGE, prefill_chunk=CHUNK)
        else:
            engine = dense_engine
        sd = SpeculativeDecoder(engine, drafter=make(), draft_tokens=SPEC_K)
        ContinuousBatchingScheduler(engine, max_new_tokens=2 * SPEC_K + 2,
                                    spec_decoder=sd).run(warm)
        if layout == "paged":
            engine.reset_stats()
            engine.clear_prefix_cache()
        fa.launches = fa.launches_dq = fa.launches_dkv = 0
        fd.launches = fd.launches_int8 = fd.launches_multi_query = 0
        fd.launches_verify = 0
        torch.cuda.synchronize()
        results, report = ContinuousBatchingScheduler(
            engine, max_new_tokens=NEW_TOKENS, spec_decoder=sd).run(
            [Request(uid=r.uid, prompt=list(r.prompt)) for r in requests])
        torch.cuda.synchronize()
        counts = {"flash_attention_fwd": fa.launches, "flash_decode": fd.launches,
                  "int8": fd.launches_int8, "multi_query": fd.launches_multi_query,
                  "verify": fd.launches_verify}
        steps = report.decode_steps
        chunks = engine.chunks_run if layout == "paged" else 0
        prefills = len(requests) * layers if layout == "dense" else 0
        draft = steps * SPEC_K * depth
        want = {"flash_attention_fwd": prefills,
                "flash_decode": layers * (chunks + steps) + draft, "int8": 0,
                "multi_query": layers * (chunks + steps), "verify": layers * steps}
        log(f"[spec] {name}: launches {counts} (expected {want}: {layers} a "
            f"chunk and a verify pass, {SPEC_K} x {depth} draft launches a "
            f"step; {chunks} chunks, {steps} spec steps)")
        if counts != want:
            raise AssertionError(f"{name}: unexpected launch counts {counts}")
        if layout == "paged" and name != "spec_reject" and chunks != paged["f32_chunks"]:
            raise AssertionError(f"{name}: {chunks} chunks, the f32 run had "
                                 f"{paged['f32_chunks']}")
        tokens = {r.uid: r.tokens for r in results}
        same = tokens == base_tokens
        log(f"[spec] {name}: tokens == the non-speculative {layout} run's: {same}")
        if not same:
            raise AssertionError(f"{name}: speculative tokens differ")
        if report.finish_reasons != {"length": len(requests)}:
            raise AssertionError(f"{name}: finish reasons {report.finish_reasons}")
        if name == "spec_reject" and (report.acceptance_rate != 0.0
                                      or report.tokens_per_verify != 1.0):
            raise AssertionError(f"{name}: acceptance {report.acceptance_rate}, "
                                 f"tokens/verify {report.tokens_per_verify}")
        if layout == "paged":
            engine.allocator.check()
            if engine.allocator.pages_in_use:
                raise AssertionError(f"{name}: pages leaked")
        base = paged["f32_report"] if layout == "paged" else dense["report"]
        log(f"[spec] {name} ({sd.drafter_name}"
            f"{f', token {garbage}' if name == 'spec_reject' else ''}): tokens/s "
            f"{report.tokens_per_sec} | decode tokens/s {report.decode_tokens_per_sec}"
            f" (non-spec {layout} run {base.decode_tokens_per_sec}) | TTFT p50 "
            f"{report.ttft_s['p50'] * 1e3:.2f} ms p99 {report.ttft_s['p99'] * 1e3:.2f} ms"
            f" | acceptance {report.acceptance_rate} | tokens/verify "
            f"{report.tokens_per_verify} | draft p50 "
            f"{report.draft_step_s['p50'] * 1e3:.3f} ms | verify p50 "
            f"{report.verify_step_s['p50'] * 1e3:.3f} ms | {steps} spec steps on {card}")
        log(f"[spec] {name} report " + json.dumps(report.to_dict()))
        out[name] = dict(counts=counts, draft=draft)
        if name == "spec_reject":
            # the never-drafted twin: the same engine, warm-up and requests
            # without speculation (a rejection step commits one token a
            # slot, as a decode step does, so pages go out in the same
            # order); every position past a kept prefix is zero in both,
            # kept positions hold verify's writes there, decode's here
            ref = PagedInferenceEngine(
                params, num_heads=SERVE["num_heads"], batch_slots=SLOTS,
                max_seq=MAX_SEQ, page_size=PAGE, prefill_chunk=CHUNK)
            ContinuousBatchingScheduler(ref, max_new_tokens=2 * SPEC_K + 2).run(warm)
            ref.reset_stats()
            ref.clear_prefix_cache()
            ContinuousBatchingScheduler(ref, max_new_tokens=NEW_TOKENS).run(
                [Request(uid=r.uid, prompt=list(r.prompt)) for r in requests])
            zeros_same = all(torch.equal(engine.cache[k][1:] == 0, ref.cache[k][1:] == 0)
                             for k in ("k", "v"))
            bitwise = all(torch.equal(engine.cache[k][1:], ref.cache[k][1:])
                          for k in ("k", "v"))
            diff = max((engine.cache[k][1:] - ref.cache[k][1:]).abs().max().item()
                       for k in ("k", "v"))
            scale = max(ref.cache[k][1:].abs().max().item() for k in ("k", "v"))
            log(f"[spec] {name}: pool after the run vs the never-drafted run's "
                f"(scratch page excluded): zero positions identical {zeros_same}, "
                f"bitwise {bitwise}, max|d| {diff:.3e} (largest |K/V| {scale:.3f}, "
                f"tolerance {VERIFY_RTOL:g} of it)")
            if not zeros_same or not diff <= VERIFY_RTOL * scale:
                raise AssertionError(f"{name}: rollback left rejected-draft residue")
            del ref
        if name in ("spec_truncated", "spec_dense"):
            same, err, scale, argmax_same, cache_same, cache_err = verify_vs_decode(
                torch, np, engine)
            log(f"[spec] {layout} verify (8 slots x 5 columns) vs 5 sequential "
                f"decode steps: logits bitwise {same}, max|d| {err:.3e} (largest "
                f"|logit| {scale:.3f}, tolerance {VERIFY_RTOL:g} of it), argmax "
                f"equal {argmax_same}; cache writes bitwise {cache_same}, max|d| "
                f"{cache_err:.3e}")
            if not (argmax_same and err <= VERIFY_RTOL * scale):
                raise AssertionError(f"{layout} verify drifts from decode: {err}")
        if name == "spec_truncated":
            # one spec step (8 slots at pos 300, K = 4, every draft real)
            # under the profiler, beside the paged decode step's wall
            toks, pos = fill_slots(np, engine, rng)
            dlen = np.full(SLOTS, SPEC_K, np.int32)
            wall, busy, top, _ = profile_share(torch, lambda: sd.step(toks, pos, dlen), 10)
            share = ("not measured" if busy is None
                     else f"{busy:.3f} ms ({busy / wall:.1%} busy)")
            log(f"[profile] spec step (8 slots, pos 300, K=4, M=2): host wall "
                f"{wall:.3f} ms, kernel time {share} on {card}; the paged decode "
                f"step's host wall was {paged['decode_profile_ms']:.3f} ms")
            log_k4(top, busy)
            for key, ms in top[:8]:
                log(f"[profile]   {ms:8.4f} ms  {key[:90]}")
            for slot in range(SLOTS):
                engine.release(slot)
        del sd
        if layout == "paged":
            del engine
        torch.cuda.empty_cache()
    return out


def _causal_pairs(s: int) -> int:
    return s * (s + 1) // 2  # visible (query, key) pairs of one head


def phase_bwd(torch, F, fa, card):
    """K2 and K3 (f32: split TF32 on the tensor cores) against the plain
    backward at S 37, 130 (ragged tiles), 576 and 2048; returns their JSON
    rows (timed at the training shape S=2048, with the rows a block each
    pass took, TFLOP/s, the bound at the split-TF32 rate and the one at the
    CUDA cores' f32 FMA rate, and K2+K3 against SDPA's backward)."""
    b, h, d = 8, 12, 64
    worst = {"dq": 0.0, "dkv": 0.0}
    rows = {}
    for s in (37, 130, 576, 2048):
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
        # (6 D flops a pair); dK, dV need S, dP, P^T dO and dS^T Q (8 D);
        # bound at the rate of the kernels' route (split TF32: a third of
        # the dense TF32 peak) and, beside it, at the f32 FMA rate
        b_dq = bound_ms(rows_in + head, 6.0 * d * pairs, TF32X3_FLOPS_PER_S)
        b_dkv = bound_ms(rows_in + 2 * head, 8.0 * d * pairs, TF32X3_FLOPS_PER_S)
        fma_dq = bound_ms(rows_in + head, 6.0 * d * pairs)
        fma_dkv = bound_ms(rows_in + 2 * head, 8.0 * d * pairs)
        whole = bound_ms(rows_in + 3 * head, 10.0 * d * pairs, TF32X3_FLOPS_PER_S)
        block_rows = {kind: fa.f32_bwd_block_rows(kind, b, h, s) for kind in ("dq", "dkv")}
        tflops = {"dq": 6.0 * d * pairs / ms_dq / 1e9, "dkv": 8.0 * d * pairs / ms_dkv / 1e9}
        log(f"[bwd] S=2048 B=8 H=12 D=64 causal: K2 {ms_dq:.4f} ms "
            f"({block_rows['dq']}-row blocks, {tflops['dq']:.1f} TFLOP/s; bound "
            f"{b_dq[0]:.4f} ms at split TF32, {b_dq[1]}, {b_dq[0] / ms_dq:.1%}; "
            f"{fma_dq[0]:.4f} ms at the f32 FMA rate), K3 {ms_dkv:.4f} ms "
            f"({block_rows['dkv']}-row blocks, {tflops['dkv']:.1f} TFLOP/s; bound "
            f"{b_dkv[0]:.4f} ms, {b_dkv[1]}, {b_dkv[0] / ms_dkv:.1%}; {fma_dkv[0]:.4f} "
            f"ms at the FMA rate), plain backward {plain_ms:.4f} ms, sdpa "
            f"backward {lib_ms:.4f} ms on {card}")
        log(f"[bwd] whole backward: K2+K3 {ms_dq + ms_dkv:.4f} ms, "
            f"{(ms_dq + ms_dkv) / lib_ms:.2f}x SDPA's backward ({lib_ms:.4f} ms), "
            f"against {whole[0]:.4f} ms for the 5 products at split TF32 (10 D "
            f"flops a pair, {whole[1]}); the two-pass design recomputes S and "
            f"dP (4 D more a pair, {4.0 * d * pairs / 1e9:.1f} GFLOP)")
        shape = "B=8 H=12 S=2048 D=64 causal f32 (strided qkv views)"
        for kind, ms, (bms, by), fma in (("dq", ms_dq, b_dq, fma_dq),
                                         ("dkv", ms_dkv, b_dkv, fma_dkv)):
            rows[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              library_ms=lib_ms, fma_bound_ms=fma[0],
                              tflops=tflops[kind], block_rows=block_rows[kind],
                              shape=shape)
        del out, qt, kt, vt
    for kern in rows:
        rows[kern]["max_abs_err"] = worst[kern]
    torch.cuda.empty_cache()
    return rows


def phase_bwd_bf16(torch, F, fa, card):
    """bf16 K2 and K3 against the bf16 plain backward and both against the
    f32 backward from the same bf16 inputs, lse and delta, causal and not,
    on strided qkv views with a random bf16 dO; returns their JSON rows
    (timed at the training shape)."""
    h, d = 12, 64
    worst = {"dq": 0.0, "dkv": 0.0}
    rows = {}
    for s in (37, 576, 2048):
        b = 8 if s == 2048 else 2
        # causal last: the timing below runs on the causal case's inputs
        for causal in (False, True):
            q, k, v = bf16_qkv(torch, b, s, seed=s + 10 * causal)
            o, lse = fa.flash_attention_core(q, k, v, causal=causal)
            g = torch.Generator(device="cuda").manual_seed(s)
            do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            before = (fa.launches_dq, fa.launches_dkv, fa.launches_dq_bf16,
                      fa.launches_dkv_bf16)
            got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal)
            torch.cuda.synchronize()
            if (fa.launches_dq, fa.launches_dkv, fa.launches_dq_bf16,
                    fa.launches_dkv_bf16) != (before[0], before[1],
                                              before[2] + 1, before[3] + 1):
                raise AssertionError("a bf16 backward did not launch K2 and K3 bf16 once")
            plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal)
            ref = fa._dense_attention_bwd(q.float(), k.float(), v.float(),
                                          do.float(), lse, delta, causal=causal)
            parts = []
            for name, kern, gt, pl, rf in zip(("dQ", "dK", "dV"), ("dq", "dkv", "dkv"),
                                              got, plain, ref):
                err, plain_err, limit = hold_bf16(gt, pl, rf, f"bf16 {name} S={s}")
                worst[kern] = max(worst[kern],
                                  (gt.float() - pl.float()).abs().max().item())
                parts.append(f"{name} {err:.3e} (plain {plain_err:.3e}, limit "
                             f"{limit:.3e}, max {rf.abs().max().item():.3f})")
            log(f"[bwd-bf16] B={b} S={s} causal={causal} ("
                f"{fa.bf16_bwd_block_rows('dq', b, h, s)}/"
                f"{fa.bf16_bwd_block_rows('dkv', b, h, s)}-row blocks): vs "
                f"f32 reference " + "; ".join(parts))
            del plain, ref, got
        if s != 2048:
            continue
        ms_dq = device_ms(torch, lambda i: fa._launch_bwd_dq(
            q, k, v, do, lse, delta, causal=True), iters=10)
        ms_dkv = device_ms(torch, lambda i: fa._launch_bwd_dkv(
            q, k, v, do, lse, delta, causal=True), iters=10)
        plain_ms = device_ms(torch, lambda i: fa._dense_attention_bwd(
            q, k, v, do, lse, delta, causal=True), iters=3, warmup=1)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        lib_ms = device_ms(torch, lambda i: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=5, warmup=2)
        pairs = b * h * _causal_pairs(s)
        head = 2.0 * b * s * h * d  # one [B, S, H, D] bf16 tensor
        rows_in = 4 * head + 2 * 4.0 * b * h * s  # q, k, v, dO; lse, delta
        b_dq = bound_ms(rows_in + head, 6.0 * d * pairs, BF16_FLOPS_PER_S)
        b_dkv = bound_ms(rows_in + 2 * head, 8.0 * d * pairs, BF16_FLOPS_PER_S)
        log(f"[bwd-bf16] S=2048 B=8 H=12 D=64 causal: K2 {ms_dq:.4f} ms (bound "
            f"{b_dq[0]:.4f} ms, {b_dq[1]}, {6.0 * d * pairs / ms_dq / 1e9:.1f} "
            f"TFLOP/s), K3 {ms_dkv:.4f} ms (bound {b_dkv[0]:.4f} ms, {b_dkv[1]}, "
            f"{8.0 * d * pairs / ms_dkv / 1e9:.1f} TFLOP/s), plain backward "
            f"{plain_ms:.4f} ms, sdpa bf16 backward {lib_ms:.4f} ms on {card}")
        shape = "B=8 H=12 S=2048 D=64 causal bf16 (strided qkv views)"
        for kern, ms, (bms, by), per_pair in (("dq", ms_dq, b_dq, 6.0),
                                             ("dkv", ms_dkv, b_dkv, 8.0)):
            rows[kern] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              library_ms=lib_ms, shape=shape,
                              tflops=per_pair * d * pairs / ms / 1e9,
                              block_rows=fa.bf16_bwd_block_rows(kern, b, h, s))
        log(f"[bwd-bf16] K2+K3 {ms_dq + ms_dkv:.4f} ms against sdpa's whole "
            f"backward {lib_ms:.4f} ms ({(ms_dq + ms_dkv) / lib_ms:.2f}x), "
            f"{rows['dq']['block_rows']}/{rows['dkv']['block_rows']}-row blocks")
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


def phase_grad_parity_bf16(torch, np, fa):
    """Loss and every parameter gradient of the full-width LM at batch 1,
    seq 2048 in bf16 (f32 params cast inside the loss, as the workload's
    apply_fn does): flash attention (bf16 K1, K2, K3) against dense.  The
    f32 dense run on the same weights is logged beside them as a yardstick
    of what bf16 costs either path."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, init_params, next_token_loss,
    )
    from distributeddeeplearning_tpu_torch.train.state import tree_leaves, tree_map

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
    for attention, dtype in (("flash", torch.bfloat16), ("dense", torch.bfloat16),
                             ("dense", torch.float32)):
        before = _fa_counts(fa)
        p = tree_map(lambda a: a.to(dtype), params)
        logits = forward(p, toks, num_heads=cfg["num_heads"], attention=attention)
        loss = next_token_loss(logits.float(), toks)
        out[(attention, dtype)] = (loss.item(), torch.autograd.grad(loss, leaves))
        n = cfg["num_layers"]
        if attention == "flash" and _fa_counts(fa) != {
                **before, "launches_bf16": before["launches_bf16"] + n,
                "launches_dq_bf16": before["launches_dq_bf16"] + n,
                "launches_dkv_bf16": before["launches_dkv_bf16"] + n}:
            raise AssertionError(f"bf16 flash gradient launches {_fa_counts(fa)} "
                                 f"(before {before})")
        del p, logits, loss
    (lf, gf) = out[("flash", torch.bfloat16)]
    (ld, gd) = out[("dense", torch.bfloat16)]
    (l32, g32) = out[("dense", torch.float32)]
    log(f"[grad-bf16] full width, batch 1, seq 2048: loss flash bf16 {lf:.7f} "
        f"dense bf16 {ld:.7f} (rel |d| {abs(lf - ld) / abs(ld):.2e}, tolerance "
        f"{LOSS_RTOL_BF16:g}); dense f32 {l32:.7f}")
    if abs(lf - ld) > LOSS_RTOL_BF16 * abs(ld):
        raise AssertionError("bf16 flash and dense losses disagree")
    worst = worst_f = worst_d = 0.0
    for name, a, r, x in zip(names, gf, gd, g32):
        top = max(r.abs().max().item(), 1e-30)
        share = (a - r).abs().max().item() / top
        worst = max(worst, share)
        top32 = max(x.abs().max().item(), 1e-30)
        worst_f = max(worst_f, (a - x).abs().max().item() / top32)
        worst_d = max(worst_d, (r - x).abs().max().item() / top32)
        if not share <= GRAD_RTOL_BF16:
            raise AssertionError(f"bf16 gradient of {name} disagrees: {share:.2e}")
    log(f"[grad-bf16] flash vs dense, every leaf's max|dg| within {worst:.2e} "
        f"of its max|g| (tolerance {GRAD_RTOL_BF16:g}) over {len(names)} "
        f"leaves; against the f32 dense gradients: flash bf16 {worst_f:.2e}, "
        f"dense bf16 {worst_d:.2e}")
    del out, gf, gd, g32, params, leaves
    torch.cuda.empty_cache()


def _fa_counts(fa):
    return {c: getattr(fa, c) for c in FA_COUNTERS}


# every flash counter: the unbiased kernels', then the key-padding-bias
# variants' (which every path but BERT's must leave at 0)
FA_COUNTERS = ("launches", "launches_dq", "launches_dkv", "launches_bf16",
               "launches_dq_bf16", "launches_dkv_bf16", "launches_bias",
               "launches_dq_bias", "launches_dkv_bias", "launches_bias_bf16",
               "launches_dq_bias_bf16", "launches_dkv_bias_bf16")


def phase_train(torch, np, fa, card, dtype="float32", f32_losses=None):
    """The port's LM workload at the reference configuration, in f32 or
    (``dtype="bfloat16"``) at ``compute_dtype`` left to its default, bf16;
    returns ``(launch counts of the run, per-step losses)``.  A bf16 run's
    losses are held to ``f32_losses`` step by step."""
    import tempfile

    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        next_token_loss,
    )
    from distributeddeeplearning_tpu_torch.train.step import build_train_step
    from distributeddeeplearning_tpu_torch.workloads import transformer

    bf16 = dtype == "bfloat16"
    tag = "train-bf16" if bf16 else "train"
    sfx = "_bf16" if bf16 else ""
    # the reference's default; the f32 run asks for f32 explicitly
    dtype_kw = {} if bf16 else {"compute_dtype": "float32"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        for counter in FA_COUNTERS:
            setattr(fa, counter, 0)
        torch.cuda.synchronize()
        state, result = transformer.main(
            epochs=TRAIN_EPOCHS, steps_per_epoch=1,
            train_examples=TRAIN["batch_size"], attention="flash",
            device="cuda", metrics_path=path, **dtype_kw, **TRAIN)
        torch.cuda.synchronize()
        counts = _fa_counts(fa)
        with open(path) as f:
            rows = [json.loads(line) for line in f]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    layers, steps = TRAIN["num_layers"], TRAIN_EPOCHS
    want = {c: 0 for c in FA_COUNTERS}
    want.update({f"launches{sfx}": layers * (steps + TRAIN_EPOCHS),
                 f"launches_dq{sfx}": layers * steps,
                 f"launches_dkv{sfx}": layers * steps})
    log(f"[{tag}] launches during the run: {counts} (expected {want}: 12 "
        f"per forward, {steps} train steps and {TRAIN_EPOCHS} eval passes)")
    if counts != want:
        raise AssertionError(f"unexpected launch counts {counts}")
    launches = {"flash_attention_fwd": counts[f"launches{sfx}"],
                "flash_attention_bwd_dq": counts[f"launches_dq{sfx}"],
                "flash_attention_bwd_dkv": counts[f"launches_dkv{sfx}"]}
    losses = [r["train_loss"] for r in rows]
    log(f"[{tag}] loss by step: {[round(x, 5) for x in losses]}; final "
        f"train {result.final_train_metrics}, eval {result.final_eval_metrics}")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on the repeated batch")
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad} in epoch {r['epoch']}")
    if f32_losses is not None:
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)]
        log(f"[{tag}] |loss - f32 loss| / f32 loss by step: "
            f"{[f'{x:.2e}' for x in rel]} (tolerance {TRAIN_LOSS_RTOL_BF16:g})")
        if len(rel) != len(losses) or max(rel) > TRAIN_LOSS_RTOL_BF16:
            raise AssertionError("the bf16 losses left the f32 run's")
    tokens = TRAIN["batch_size"] * TRAIN["seq_len"]
    step_s = sorted(TRAIN["batch_size"] / r["images_per_second"] for r in rows[1:])
    p50 = float(np.median(step_s))
    n_params = sum(t.numel() for t in (state.params["embed"], state.params["pos"],
                                       state.params["head"],
                                       *state.params["blocks"].values()))
    b, s, d = TRAIN["batch_size"], TRAIN["seq_len"], TRAIN["d_model"]
    flops = 6 * n_params * tokens + 3 * (2 * b * s * s * d) * layers
    peak, peak_name = ((BF16_FLOPS_PER_S, "989.4 TFLOP/s, the spec-sheet dense bf16 peak")
                       if bf16 else (F32_FLOPS_PER_S, "67 TFLOP/s f32"))
    mfu = flops / p50 / peak
    log(f"[{tag}] {n_params / 1e6:.1f} M params; step p50 {p50 * 1e3:.1f} ms "
        f"(steps 2..{steps}: {[round(x * 1e3, 1) for x in step_s]} ms), "
        f"tokens/s {tokens / p50:.1f}, mfu {mfu:.4f} of {peak_name} "
        f"({flops / 1e12:.2f} TFLOP a step), first step "
        f"{TRAIN['batch_size'] / rows[0]['images_per_second']:.2f} s, peak "
        f"memory {peak_gb:.2f} GB on {card}")

    step = build_train_step(
        state, compute_dtype=getattr(torch, dtype),
        loss_fn=lambda lg, lb, label_smoothing=0.0: next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss})
    batch = next(transformer._token_batches(b, s, TRAIN["vocab_size"], 42,
                                            b, repeat=False))
    wall, busy, top, event_ms = profile_share(torch, lambda: step(state, batch), 2)
    share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
    log(f"[profile] train step (B=8, S=2048, {dtype}, flash): host wall "
        f"{wall:.3f} ms, kernel time {share}; {trust_note(busy, event_ms)} on {card}")
    gemms = f"{'bf16' if bf16 else 'f32'} GEMMs (cuBLAS/CUTLASS)"
    bsfx = sfx or "_f32"  # the f32 kernels are named so
    kernels = {f"K1 flash_fwd{bsfx}_kernel": f"flash_fwd{bsfx}_kernel",
               f"K2 flash_bwd_dq{bsfx}_kernel": f"flash_bwd_dq{bsfx}_kernel",
               f"K3 flash_bwd_dkv{bsfx}_kernel": f"flash_bwd_dkv{bsfx}_kernel"}
    log_groups(top, busy, gemms, kernels)
    del state, step
    torch.cuda.empty_cache()
    return launches, losses


# ---- head dims 8, 16 and 32 (the reference's small serve and trainer
# geometries) ----

#: head dim -> (heads, batch, sequence) at which every flash kernel is held
#: and timed: `bench.py --small`'s d 32 over 4 heads with its 4 slots of 64
#: positions (bench.py:2574-2578), `ddlt serve`'s d 64 over 4 heads with 4
#: slots of a 512-token prompt bucket, and the LM trainer's d 256 over 8
#: heads at its batch 8, seq 128 (workloads/transformer.py defaults)
HEADDIM_GEOMETRY = {8: (4, 4, 64), 16: (4, 4, 512), 32: (8, 8, 128)}


def qkv_views(torch, b, s, h, d, dtype, seed):
    """q, k, v as strided [b, s, h, d] views of one [b, s, 3*h*d] tensor in
    ``dtype``, as the model's qkv split makes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").to(dtype)
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


def _hold_flash(torch, fa, q, k, v, causal, seed, what, bias=None):
    """K1, K2, K3 on (q, k, v) -- with the key-padding ``bias`` when given --
    against their plain versions on the same inputs: f32 within K1_TOL
    (K1) and BWD_RTOL of the largest |plain| (K2, K3); bf16 by hold_bf16
    against the f32 result of the same inputs; lse within LSE_TOL (bf16)
    or K1_TOL.  dO is drawn from ``seed``.  Returns (worst |kernel - plain|
    per kernel, (lse, lse_plain, do, delta, kernel grads))."""
    bf = q.dtype == torch.bfloat16
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias)
    o_p, lse_p = fa._dense_attention(q, k, v, bias, causal=causal)
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(o.shape, generator=g, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias)
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias)
    torch.cuda.synchronize()
    err_lse = (lse - lse_p).abs().max().item()
    if err_lse > (LSE_TOL if bf else K1_TOL):
        raise AssertionError(f"K1 lse at {what}: {err_lse}")
    if bf:
        qf, kf, vf = q.float(), k.float(), v.float()
        hold_bf16(o, o_p, fa._dense_attention(qf, kf, vf, bias, causal=causal)[0],
                  f"bf16 K1 {what}")
        ref = fa._dense_attention_bwd(qf, kf, vf, do.float(), lse, delta,
                                      causal=causal, bias=bias)
        for name, gt, pl, rf in zip(("dQ", "dK", "dV"), got, plain, ref):
            if q.shape[1] == 1 and name != "dV":
                # one key: P = 1, dS = dP - delta is 0 but for the f32
                # rounding of two D-term sums; hold both sides near 0
                if max(gt.abs().max().item(), pl.abs().max().item()) > 1e-5:
                    raise AssertionError(f"bf16 {name} {what} not ~0")
                continue
            hold_bf16(gt, pl, rf, f"bf16 {name} {what}")
    else:
        err = (o - o_p).abs().max().item()
        if not bool(torch.isfinite(o).all()) or err > K1_TOL:
            raise AssertionError(f"K1 at {what}: {err}")
        for name, gt, pl in zip(("dQ", "dK", "dV"), got, plain):
            e = (gt - pl).abs().max().item()
            if not bool(torch.isfinite(gt).all()) or (
                    e > BWD_RTOL * max(pl.abs().max().item(), 1.0)):
                raise AssertionError(f"{name} at {what}: {e}")
    worst = {"fwd": max((o.float() - o_p.float()).abs().max().item(), err_lse),
             "dq": (got[0].float() - plain[0].float()).abs().max().item(),
             "dkv": max((gt.float() - pl.float()).abs().max().item()
                        for gt, pl in zip(got[1:], plain[1:]))}
    return worst, (lse, lse_p, do, delta, got)


def _time_flash(torch, F, fa, q, k, v, do, lse, delta, causal, bias=None,
                keep=None):
    """Device ms of K1, K2, K3, their plain versions and SDPA (its forward,
    and autograd through it), all on the same inputs; SDPA gets ``keep``
    ([B, S] bool) as its boolean attn_mask.  Returns (fwd, fwd plain, fwd
    SDPA, K2, K3, plain backward, SDPA backward)."""
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    mask = None if keep is None else keep[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=causal)

    fwd_ms = device_ms(torch, lambda i: fa.flash_attention_core(
        q, k, v, causal=causal, bias=bias))
    fwd_plain = device_ms(torch, lambda i: fa._dense_attention(q, k, v, bias,
                                                               causal=causal),
                          iters=5, warmup=1)
    fwd_lib = device_ms(torch, lambda i: sdpa())
    dq_ms = device_ms(torch, lambda i: fa._launch_bwd_dq(q, k, v, do, lse, delta,
                                                         causal=causal, bias=bias))
    dkv_ms = device_ms(torch, lambda i: fa._launch_bwd_dkv(q, k, v, do, lse, delta,
                                                           causal=causal, bias=bias))
    bwd_plain = device_ms(torch, lambda i: fa._dense_attention_bwd(
        q, k, v, do, lse, delta, causal=causal, bias=bias), iters=5, warmup=1)
    out = sdpa()
    bwd_lib = device_ms(torch, lambda i: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=5, warmup=2)
    return fwd_ms, fwd_plain, fwd_lib, dq_ms, dkv_ms, bwd_plain, bwd_lib


def _flash_at(torch, F, fa, d, h, b, s, dtype, card):
    """K1, K2, K3 in ``dtype`` at head dim ``d``: held against the plain
    versions (f32: K1_TOL, BWD_RTOL; bf16: against the f32 result of the
    same inputs, hold_bf16) at S in {37, s}, causal and not; timed at
    (b, s) causal.  Returns {kernel: entry}."""
    bf = dtype == torch.bfloat16
    peak = BF16_FLOPS_PER_S if bf else TF32X3_FLOPS_PER_S  # f32: split TF32
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for ss in (37, s):
        # causal last: the timing below runs on the causal case's inputs
        for causal in (False, True):
            q, k, v = qkv_views(torch, b, ss, h, d, dtype, seed=ss + d + causal)
            errs, (lse, _, do, delta, _) = _hold_flash(
                torch, fa, q, k, v, causal, seed=ss, what=f"D={d} S={ss}")
            worst = {kern: max(worst[kern], e) for kern, e in errs.items()}
    fwd_ms, fwd_plain, fwd_lib, dq_ms, dkv_ms, bwd_plain, bwd_lib = _time_flash(
        torch, F, fa, q, k, v, do, lse, delta, causal=True)
    es = 2.0 if bf else 4.0
    pairs = b * h * _causal_pairs(s)
    head = es * b * s * h * d
    rows_in = 4 * head + 2 * 4.0 * b * h * s
    shape = f"B={b} H={h} S={s} D={d} causal {'bf16' if bf else 'f32'} (strided qkv views)"
    entries = {
        "fwd": (fwd_ms, fwd_plain, fwd_lib,
                bound_ms(4 * head + 4.0 * b * h * s, 4.0 * d * pairs, peak)),
        "dq": (dq_ms, bwd_plain, bwd_lib,
               bound_ms(rows_in + head, 6.0 * d * pairs, peak)),
        "dkv": (dkv_ms, bwd_plain, bwd_lib,
                bound_ms(rows_in + 2 * head, 8.0 * d * pairs, peak)),
    }
    result = {}
    for kern, (ms, plain_ms, lib_ms, (bms, by)) in entries.items():
        result[kern] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=lib_ms, max_abs_err=worst[kern], shape=shape)
    log(f"[headdim] D={d} {'bf16' if bf else 'f32'} B={b} H={h} S={s} causal: K1 "
        f"{fwd_ms:.4f} ms (plain {fwd_plain:.4f}, sdpa {fwd_lib:.4f}, bound "
        f"{entries['fwd'][3][0]:.4f} {entries['fwd'][3][1]}), K2 {dq_ms:.4f} ms "
        f"(bound {entries['dq'][3][0]:.4f}), K3 {dkv_ms:.4f} ms (bound "
        f"{entries['dkv'][3][0]:.4f}), plain backward {bwd_plain:.4f} ms, sdpa "
        f"backward {bwd_lib:.4f} ms; held at S=37 and {s}, causal and not "
        f"(max |kernel - plain| K1 {worst['fwd']:.3e}, K2 {worst['dq']:.3e}, K3 "
        f"{worst['dkv']:.3e}); device times, on {card}")
    return result


def _decode_at(torch, F, fd, d, h, card):
    """K4 at head dim ``d`` with ``h`` heads over a [73, 2, 64, h, d] pool
    and an [8, 2, 576, h, d] dense cache: (a) dense decode, (b) a 64-query
    chunk, (c) int8 decode with the overlay, verify at nq = 5 (each column
    bitwise an nq = 1 launch) and bf16 pages under bf16 queries (bitwise
    the f32 launch on the widened values), each against its plain version
    (K4_TOL) and timed.  Returns {variant: entry}."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(d)
    pages, layers, ps = POOL_PAGES, 2, PAGE
    pool = {n: torch.randn((pages + 1, layers, ps, h, d), generator=g, device="cuda")
            for n in ("k", "v")}
    ipool = {}
    for n in ("k", "v"):
        ipool[n], ipool[f"{n}_scale"] = quantize_kv(pool[n])
    bpool = {n: t.bfloat16() for n, t in pool.items()}
    dense = {n: torch.randn((SLOTS, layers, MAX_SEQ, h, d), generator=g, device="cuda")
             for n in ("k", "v")}
    perm = torch.randperm(pages, generator=torch.Generator().manual_seed(d))
    tables = (perm + 1).reshape(SLOTS, MAX_SEQ // ps).to(torch.int32).cuda()
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    qkv = torch.randn((SLOTS, 3, h, d), generator=g, device="cuda")
    q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    q_c = torch.randn((CHUNK, 3, h, d), generator=g, device="cuda")[:, 0]
    posns = 512 + torch.arange(CHUNK, device="cuda")
    k1 = SPEC_K + 1
    vpos = torch.tensor(SPEC_POS, dtype=torch.int32, device="cuda")
    posmat = (vpos[:, None] + torch.arange(k1, device="cuda")).to(torch.int32)
    q4 = torch.randn((SLOTS, k1, 3 * h * d), generator=g, device="cuda")[..., : h * d]
    q4 = q4.reshape(SLOTS, k1, h, d)
    lv = lambda c: tuple(c[n][:, 1] if n in c else None  # noqa: E731
                         for n in ("k", "v", "k_scale", "v_scale"))
    kf, vf, _, _ = lv(pool)
    ki, vi, ksi, vsi = lv(ipool)
    kb, vb, _, _ = lv(bpool)
    kd, vd = dense["k"][:, 1], dense["v"][:, 1]
    qb = q3.bfloat16()
    variants = {
        "decode": (lambda: fd.decode_attention_dense(q3, kd, vd, None, None, None, None, pos),
                   lambda: fd._gather_decode_dense(q3, kd, vd, None, None, None, None, pos)),
        "chunk": (lambda: fd.chunk_attention(q_c, kf, vf, None, None, tables[1], posns),
                  lambda: fd._gather_chunk(q_c, kf, vf, None, None, tables[1], posns)),
        "int8": (lambda: fd.decode_attention_paged(q3, ki, vi, ksi, vsi, k_t, v_t, pos,
                                                   tables),
                 lambda: fd._gather_decode_paged(q3, ki, vi, ksi, vsi, k_t, v_t, pos,
                                                 tables)),
        "verify": (lambda: fd.verify_attention_paged(q4, kf, vf, tables, posmat),
                   lambda: fd.verify_attention_paged(q4, kf, vf, tables, posmat,
                                                     kernel="gather")),
        "bf16": (lambda: fd.decode_attention_paged(qb, kb, vb, None, None, None, None,
                                                   pos, tables),
                 lambda: fd._paged_attention_plain(qb[:, None], kb, vb, tables,
                                                   pos[:, None])[:, 0]),
    }
    hist = float((pos.long() + 1).sum().item())
    chunk_pairs = float((posns + 1).sum().item())
    vis = float((vpos.long() + k1).sum().item())
    vpairs = float((posmat.long() + 1).sum().item())
    qo = 4.0 * 2 * SLOTS * h * d  # f32 q in, out
    bounds = {
        "decode": bound_ms(4.0 * 2 * hist * h * d + qo, 4.0 * hist * h * d),
        "chunk": bound_ms(4.0 * (2 * CHUNK * h * d + 2 * MAX_SEQ * h * d),
                          4.0 * chunk_pairs * h * d),
        "int8": bound_ms(2 * hist * h * (d + 4) + qo + 4.0 * 2 * SLOTS * h * d,
                         4.0 * hist * h * d),
        "verify": bound_ms(4.0 * (2 * vis * h * d + 2 * SLOTS * k1 * h * d),
                           4.0 * vpairs * h * d),
        "bf16": bound_ms(2.0 * 2 * hist * h * d + 2.0 * SLOTS * h * d
                         + 4.0 * SLOTS * h * d, 4.0 * hist * h * d),
    }
    # the library call: SDPA on the history gathered beforehand, bool mask
    s = MAX_SEQ
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None]
    gath = lambda t: t[tables.long()].reshape(SLOTS, s, h, d).transpose(1, 2)  # noqa: E731
    hk, hv = gath(kf), gath(vf)
    hkb, hvb = gath(kb), gath(vb)
    cmask = torch.arange(s, device="cuda")[None, :] <= posns[:, None]
    ck, cv = (t[tables[1].long()].reshape(1, s, h, d).transpose(1, 2) for t in (kf, vf))
    vmask = (torch.arange(s, device="cuda")[None, None, :] <= posmat[:, :, None])[:, None]
    libs = {
        "decode": lambda i: F.scaled_dot_product_attention(
            q3[:, :, None], kd.permute(0, 2, 1, 3), vd.permute(0, 2, 1, 3),
            attn_mask=mask),
        "chunk": lambda i: F.scaled_dot_product_attention(
            q_c[None].transpose(1, 2), ck, cv, attn_mask=cmask),
        "int8": None,
        "verify": lambda i: F.scaled_dot_product_attention(
            q4.transpose(1, 2), hk, hv, attn_mask=vmask),
        "bf16": lambda i: F.scaled_dot_product_attention(
            qb[:, :, None], hkb, hvb, attn_mask=mask),
    }
    result = {}
    for name, (kern, plain) in variants.items():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out - ref.float()).abs().max().item()
        if not bool(torch.isfinite(out).all()) or err > K4_TOL:
            raise AssertionError(f"K4 {name} at D={d} disagrees: {err}")
        ms = device_ms(torch, lambda i: kern(), iters=30)
        plain_ms = device_ms(torch, lambda i: plain(), iters=10)
        lib_ms = device_ms(torch, libs[name], iters=30) if libs[name] else None
        bms, by = bounds[name]
        result[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=lib_ms, max_abs_err=err)
    for j in range(k1):
        one = fd.paged_attention(q4[:, j:j + 1], kf, vf, tables,
                                 posmat[:, j:j + 1].contiguous())
        if not torch.equal(variants["verify"][0]()[:, j:j + 1], one):
            raise AssertionError(f"a verify column at D={d} differs from nq=1")
    widened = fd.decode_attention_paged(qb.float(), kb.float(), vb.float(), None, None,
                                        None, None, pos, tables)
    if not torch.equal(variants["bf16"][0](), widened):
        raise AssertionError(f"bf16 pages at D={d} differ from the f32 launch")
    log(f"[headdim] D={d} K4 (h={h}, b=8, S=576): " + "; ".join(
        f"{n} {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, "
        f"{'sdpa %.4f' % e['library_ms'] if e['library_ms'] else 'no library call'}, "
        f"bound {e['bound_ms']:.4f} {e['bound_by']}, max|d| {e['max_abs_err']:.2e})"
        for n, e in result.items())
        + f"; verify columns == nq=1 launches and bf16 pages == the f32 launch "
          f"on widened values, bitwise; device times, on {card}")
    return result


def phase_headdim(torch, F, fa, fd, card):
    """Every kernel at head dims 8, 16 and 32 against its plain version
    under the head-dim-64 tolerances, timed at one shape each (f32 K1 and
    K4 have instances at 8; K2, K3 and bf16 K1 at 8 run at 16 on
    zero-padded copies).  Returns
    {row name: {d: entry}}."""
    out = {}
    for d, (h, b, s) in HEADDIM_GEOMETRY.items():
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            res = _flash_at(torch, F, fa, d, h, b, s, dtype, card)
            for kern, name in (("fwd", "flash_attention_fwd"),
                               ("dq", "flash_attention_bwd_dq"),
                               ("dkv", "flash_attention_bwd_dkv")):
                out.setdefault(name + sfx, {})[d] = res[kern]
        res = _decode_at(torch, F, fd, d, h, card)
        for var, name in (("decode", "flash_decode"), ("chunk", "flash_decode_chunk"),
                          ("int8", "flash_decode_int8"), ("verify", "flash_decode_verify"),
                          ("bf16", "flash_decode_bf16")):
            res[var]["shape"] = f"b=8 h={h} hd={d} S=576 ({var})"
            out.setdefault(name, {})[d] = res[var]
        torch.cuda.empty_cache()
    return out


# ---- K4 on bf16 pages at the serving geometry ----------------------------

def phase_k4_bf16(torch, F, fd, card):
    """K4 on bf16 pages under bf16 queries at the decode shape (b=8, nq=1,
    hd=64, S=576) and the chunk shape (nq=64), and on int8 pages under bf16
    queries with the bf16 own-token overlay, on the strided layer views of
    73-page pools through scrambled tables.  Each is held against its plain
    version (K4_TOL) and against the f32 result of the same bf16 inputs
    (hold_bf16, the bf16 kernels' rule; the kernel widens in registers,
    so it must also equal the f32 launch on widened copies bitwise).
    Returns the two JSON rows."""
    pool, tables = _paged_pool(torch, "bfloat16", seed=21)
    ipool, _ = _paged_pool(torch, "int8", seed=22)
    layers, h, hd = SERVE["num_layers"], SERVE["num_heads"], 64
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    g = torch.Generator(device="cuda").manual_seed(23)
    qkv = torch.randn((SLOTS, 3, h, hd), generator=g, device="cuda").bfloat16()
    q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # strided, as the model's
    q_c = torch.randn((CHUNK, 3, h, hd), generator=g, device="cuda").bfloat16()[:, 0]
    posns = 512 + torch.arange(CHUNK, device="cuda")
    w = lambda t: t.float() if t is not None and t.dtype == torch.bfloat16 else t  # noqa: E731
    worst = {"bf16": 0.0, "int8": 0.0}
    for layer in (0, layers - 1):
        kb, vb, _, _ = _layer_views(pool, layer)
        ki, vi, ksi, vsi = _layer_views(ipool, layer)
        cases = (
            ("bf16", "decode",
             lambda q, k, v: fd.decode_attention_paged(q, k, v, None, None, None, None,
                                                       pos, tables), q3, kb, vb,
             lambda: fd._paged_attention_plain(q3[:, None], kb, vb, tables,
                                               pos[:, None])[:, 0]),
            ("bf16", "chunk",
             lambda q, k, v: fd.chunk_attention(q, k, v, None, None, tables[1], posns),
             q_c, kb, vb,
             lambda: fd._paged_attention_plain(q_c[None], kb, vb, tables[1][None],
                                               posns.to(torch.int32)[None])[0]),
            ("int8", "decode+overlay",
             lambda q, k, v: fd.decode_attention_paged(
                 q, k, v, ksi, vsi, k_t if q.dtype == torch.bfloat16 else w(k_t),
                 v_t if q.dtype == torch.bfloat16 else w(v_t), pos, tables), q3, ki, vi,
             lambda: fd._paged_attention_plain(q3[:, None], ki, vi, tables, pos[:, None],
                                               ksi, vsi, k_t, v_t)[:, 0]),
        )
        for row, what, kern, q, k, v, plain in cases:
            before = (fd.launches, fd.launches_bf16, fd.launches_int8)
            out = kern(q, k, v)
            torch.cuda.synchronize()
            if (fd.launches, fd.launches_bf16, fd.launches_int8) != (
                    before[0] + 1, before[1] + 1, before[2] + (row == "int8")):
                raise AssertionError(f"bf16 K4 {what}: not one bf16 launch")
            ref_plain = plain()
            f32 = kern(w(q), w(k), w(v))  # the f32 launch on the widened values
            err = (out - ref_plain).abs().max().item()
            worst[row] = max(worst[row], err)
            e, pe, limit = hold_bf16(out, ref_plain, ref_plain.float(),
                                     f"bf16 K4 {what}")
            log(f"[k4-bf16] layer {layer} {row} {what}: max|kernel - plain| {err:.3e} "
                f"(tolerance {K4_TOL:g}); vs the f32 result of the same bf16 inputs "
                f"{e:.3e} (limit {limit:.3e}); == the f32 launch on widened copies: "
                f"{torch.equal(out, f32)}")
            if not bool(torch.isfinite(out).all()) or err > K4_TOL or not torch.equal(
                    out, f32):
                raise AssertionError(f"bf16 K4 {what} disagrees")
    views = [_layer_views(pool, i)[:2] for i in range(layers)]
    iviews = [_layer_views(ipool, i) for i in range(layers)]
    dec = lambda i: fd.decode_attention_paged(  # noqa: E731
        q3, *views[i % layers], None, None, None, None, pos, tables)
    ms = device_ms(torch, dec, iters=120)
    plain_ms = device_ms(torch, lambda i: fd._paged_attention_plain(
        q3[:, None], *views[i % layers], tables, pos[:, None]), iters=30)
    s = MAX_SEQ
    hist = [tuple(t[tables.long()].reshape(SLOTS, s, h, hd).transpose(1, 2) for t in v)
            for v in views]
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None]
    lib_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q3[:, :, None], *hist[i % layers], attn_mask=mask), iters=60)
    chunk_ms = device_ms(torch, lambda i: fd.chunk_attention(
        q_c, *views[i % layers], None, None, tables[1], posns), iters=120)
    chist = [tuple(t[tables[1].long()].reshape(1, s, h, hd).transpose(1, 2) for t in v)
             for v in views]
    cmask = torch.arange(s, device="cuda")[None, :] <= posns[:, None]
    chunk_lib = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q_c[None].transpose(1, 2), *chist[i % layers], attn_mask=cmask), iters=60)
    int8_ms = device_ms(torch, lambda i: fd.decode_attention_paged(
        q3, *iviews[i % layers], k_t, v_t, pos, tables), iters=120)
    int8_plain = device_ms(torch, lambda i: fd._paged_attention_plain(
        q3[:, None], *iviews[i % layers][:2], tables, pos[:, None],
        *iviews[i % layers][2:], k_t, v_t), iters=30)
    vis = float((pos.long() + 1).sum().item())
    qo = 2.0 * SLOTS * h * hd + 4.0 * SLOTS * h * hd + 4.0 * (SLOTS + tables.numel())
    bms, by = bound_ms(2.0 * 2 * vis * h * hd + qo, 4.0 * vis * h * hd)
    ibms, iby = bound_ms(2 * vis * h * (hd + 4) + qo + 2.0 * 2 * SLOTS * h * hd,
                         4.0 * vis * h * hd)
    cbms, cby = bound_ms(2.0 * (2 * CHUNK * h * hd + 2 * s * h * hd)
                         + 2.0 * CHUNK * h * hd, 4.0 * float((posns + 1).sum()) * h * hd)
    log(f"[k4-bf16] bf16 pages, bf16 q, b=8 S=576: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa bf16 (pre-gathered history, bool mask) {lib_ms:.4f} "
        f"ms, bound {bms:.4f} ms ({by}, 2*hd*2 bytes a visible position and head); "
        f"chunk nq=64 history 576: kernel {chunk_ms:.4f} ms, sdpa {chunk_lib:.4f} ms, "
        f"bound {cbms:.4f} ms ({cby}); int8 pages, bf16 q and overlay: kernel "
        f"{int8_ms:.4f} ms, plain {int8_plain:.4f} ms, bound {ibms:.4f} ms ({iby}); "
        f"device times, on {card}")
    del pool, ipool, views, iviews, hist, chist
    torch.cuda.empty_cache()
    return (dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                 max_abs_err=worst["bf16"], chunk_ms=chunk_ms, chunk_library_ms=chunk_lib,
                 chunk_bound_ms=cbms,
                 shape="b=8 nq=1 h=12 hd=64 page 64, pos 0..575, bf16 pages and q, "
                       "scrambled tables, strided pool view"),
            dict(ms=int8_ms, plain_ms=int8_plain, bound_ms=ibms, bound_by=iby,
                 library_ms=None, max_abs_err=worst["int8"],
                 shape="b=8 nq=1 h=12 hd=64 page 64, pos 0..575, int8 pages + f32 "
                       "scales, bf16 q and own-token overlay, scrambled tables"))


# ---- the reference's own default geometries ------------------------------

#: `ddlt serve`'s defaults (ref cli/main.py:346-356, 505-511): 2 layers,
#: d 64, 4 heads (head dim 16), ff 128, vocab 257; 12 synthetic requests of
#: up to 16 prompt tokens, 4 slots, 32 new tokens, max_seq 16 + 32
CLI_SERVE = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=257)
CLI_REQUESTS, CLI_PROMPT, CLI_SLOTS, CLI_NEW = 12, 16, 4, 32
#: `workloads.transformer.main`'s defaults (ref workloads/transformer.py:
#: 63-66): 8 layers, d 256, 8 heads (head dim 32), ff 1024, vocab 1031,
#: batch 8, seq 128; one batch repeated, one step an epoch
LM_LAYERS, LM_EPOCHS = 8, 6


def phase_default_geometries(torch, np, fa, fd, card):
    """An InferenceEngine and a PagedInferenceEngine at `ddlt serve`'s
    geometry (head dim 16) with their default flash prefill and decode
    kernel, f32 and int8 weights (the head's N = 257 through the padded
    int8 product), greedy streams held to a dense oracle; then the LM
    workload at its own defaults (head dim 32) with flash attention, f32
    and bf16, the loss falling.  Each run with the counters zeroed just
    before it and read just after.  Returns the launches by head dim."""
    import tempfile

    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, init_params,
    )
    from distributeddeeplearning_tpu_torch.quant.calibrate import quantize_params
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, PagedInferenceEngine,
        synthetic_requests,
    )
    from distributeddeeplearning_tpu_torch.workloads import transformer

    layers, heads = CLI_SERVE["num_layers"], CLI_SERVE["num_heads"]
    max_seq = CLI_PROMPT + CLI_NEW
    params = init_params(torch.Generator().manual_seed(0), max_len=max_seq,
                         device="cuda", **CLI_SERVE)
    params["embed"] *= 4.0  # the tied 4x head: greedy measures the kernels
    params["head"] = params["embed"].T.contiguous()
    trees = {"f32": params, "int8w": quantize_params(params)}
    requests = synthetic_requests(CLI_REQUESTS, vocab_size=CLI_SERVE["vocab_size"],
                                  max_prompt=CLI_PROMPT, rng=np.random.default_rng(0))
    launches = {16: {}, 32: {}}
    for weights, tree in trees.items():
        oracle = {r.uid: naive_greedy(torch, forward, tree, r.prompt, CLI_NEW,
                                      heads=heads) for r in requests}
        for layout in ("dense", "paged"):
            if layout == "dense":
                engine = InferenceEngine(tree, num_heads=heads, batch_slots=CLI_SLOTS,
                                         max_seq=max_seq)
            else:
                engine = PagedInferenceEngine(tree, num_heads=heads,
                                              batch_slots=CLI_SLOTS, max_seq=max_seq)
            _zero_counters(fa, fd)
            torch.cuda.synchronize()
            results, report = ContinuousBatchingScheduler(
                engine, max_new_tokens=CLI_NEW).run(requests)
            torch.cuda.synchronize()
            counts = {**_fa_counts(fa), **_fd_counts(fd)}
            steps = report.decode_steps
            chunks = engine.chunks_run if layout == "paged" else 0
            want = {c: 0 for c in counts}
            want.update({"launches": layers * CLI_REQUESTS if layout == "dense" else 0,
                         "fd_launches": layers * (chunks + steps),
                         "launches_multi_query": layers * chunks})
            tokens = {r.uid: r.tokens for r in results}
            log(f"[default] ddlt serve geometry (D=16), {weights} weights, {layout}: "
                f"launches {counts} (expected {want}); {steps} decode steps, "
                f"{chunks} chunks; tokens == the dense oracle: {tokens == oracle}; "
                f"tokens/s {report.tokens_per_sec}, kv_dtype {report.kv_dtype}, "
                f"weights_dtype {report.weights_dtype} on {card}")
            if counts != want or tokens != oracle:
                raise AssertionError(f"ddlt serve geometry {weights} {layout} failed")
            if report.weights_dtype != ("int8" if weights == "int8w" else "float32"):
                raise AssertionError(f"weights_dtype {report.weights_dtype}")
            for key, n in (("flash_attention_fwd", counts["launches"]),
                           ("flash_decode", counts["fd_launches"]
                            - counts["launches_multi_query"]),
                           ("flash_decode_chunk", counts["launches_multi_query"])):
                launches[16][key] = launches[16].get(key, 0) + n
            del engine
    for dtype in ("float32", "bfloat16"):
        sfx = "_bf16" if dtype == "bfloat16" else ""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "metrics.jsonl")
            for c in FA_COUNTERS:
                setattr(fa, c, 0)
            torch.cuda.synchronize()
            _, result = transformer.main(
                epochs=LM_EPOCHS, steps_per_epoch=1, train_examples=8,
                attention="flash", device="cuda", metrics_path=path,
                compute_dtype=dtype)
            torch.cuda.synchronize()
            counts = _fa_counts(fa)
            with open(path) as f:
                losses = [json.loads(line)["train_loss"] for line in f]
        want = {c: 0 for c in FA_COUNTERS}
        # one train step and one eval batch an epoch
        want.update({f"launches{sfx}": LM_LAYERS * 2 * LM_EPOCHS,
                     f"launches_dq{sfx}": LM_LAYERS * LM_EPOCHS,
                     f"launches_dkv{sfx}": LM_LAYERS * LM_EPOCHS})
        log(f"[default] LM workload defaults (8 layers, d 256, 8 heads: D=32, vocab "
            f"1031, batch 8, seq 128), {dtype}, flash: launches {counts} (expected "
            f"{want}); loss by step {[round(x, 5) for x in losses]} on {card}")
        if counts != want or not losses[-1] < losses[0] or not all(
                np.isfinite(losses)):
            raise AssertionError(f"LM workload defaults {dtype} failed")
        for key, c in (("flash_attention_fwd", "launches"),
                       ("flash_attention_bwd_dq", "launches_dq"),
                       ("flash_attention_bwd_dkv", "launches_dkv")):
            launches[32][key + sfx] = counts[c + sfx]
    torch.cuda.empty_cache()
    return launches


#: `bench.py --small`'s serving run (bench.py:2574-2597): 2 layers, d 32
#: over 4 heads (head dim 8), ff 64, vocab 509; 4 slots of 64 positions,
#: pages and prefill chunks of 16 positions; 8 requests of up to 24 tokens
#: behind an 8-token shared prefix, 6 new tokens each
SMALL_SERVE = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=509)
SMALL_SLOTS, SMALL_MAX_SEQ, SMALL_PAGE = 4, 64, 16
SMALL_REQUESTS, SMALL_PROMPT, SMALL_PREFIX, SMALL_NEW = 8, 24, 8, 6
SMALL_RUNS = (  # name, paged, engine options
    ("dense", False, {}),
    ("paged", True, {}),
    ("paged_int8", True, {"cache_dtype": "int8"}),
    ("paged_int8_gather", True, {"cache_dtype": "int8", "decode_kernel": "gather"}),
)


def phase_serve_d8(torch, np, fa, fd, card):
    """Head dim 8 end to end at `bench.py --small`'s serving geometry: the
    dense engine (prefill through the f32 K1's instance at 8, decode through
    K4's instance at 8), the paged engine on f32 pages and on int8 pages
    (8-byte rows; chunked prefill and decode through K4), and the int8
    engine through the plain read, each with the counters zeroed just
    before it and read just after.  Greedy tokens of the f32 engines equal
    a dense full-forward oracle's, int8 kernel tokens the int8 plain read's;
    teacher-forced logits of the dense and paged paths hold to one dense
    forward within LOGIT_RTOL of the largest |logit|.  Returns the
    launches by kernel row name."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward, init_params,
    )
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, PagedInferenceEngine,
        synthetic_requests,
    )

    geo, heads = SMALL_SERVE, SMALL_SERVE["num_heads"]
    layers = geo["num_layers"]
    params = init_params(torch.Generator().manual_seed(0), max_len=SMALL_MAX_SEQ,
                         device="cuda", **geo)
    params["embed"] *= 4.0  # the tied 4x head: greedy measures the kernels
    params["head"] = params["embed"].T.contiguous()
    requests = synthetic_requests(SMALL_REQUESTS, vocab_size=geo["vocab_size"],
                                  max_prompt=SMALL_PROMPT,
                                  shared_prefix_len=SMALL_PREFIX,
                                  rng=np.random.default_rng(0))
    oracle = {r.uid: naive_greedy(torch, forward, params, r.prompt, SMALL_NEW,
                                  heads=heads) for r in requests}
    tokens, launches = {}, {}
    for name, paged, opts in SMALL_RUNS:
        kw = dict(num_heads=heads, batch_slots=SMALL_SLOTS, max_seq=SMALL_MAX_SEQ)
        if paged:
            engine = PagedInferenceEngine(params, page_size=SMALL_PAGE,
                                          prefill_chunk=SMALL_PAGE, **kw, **opts)
        else:
            engine = InferenceEngine(params, **kw)
        _zero_counters(fa, fd)
        torch.cuda.synchronize()
        results, report = ContinuousBatchingScheduler(
            engine, max_new_tokens=SMALL_NEW).run(requests)
        torch.cuda.synchronize()
        counts = {**_fa_counts(fa), **_fd_counts(fd)}
        steps = report.decode_steps
        chunks = engine.chunks_run if paged else 0
        kernel = opts.get("decode_kernel") != "gather"
        int8 = opts.get("cache_dtype") == "int8"
        want = {c: 0 for c in counts}
        want.update({"launches": 0 if paged else layers * SMALL_REQUESTS,
                     "fd_launches": layers * (chunks + steps) * kernel,
                     "launches_multi_query": layers * chunks * kernel,
                     "launches_int8": layers * (chunks + steps) * kernel * int8})
        tokens[name] = {r.uid: r.tokens for r in results}
        ref = tokens["paged_int8"] if name == "paged_int8_gather" else (
            None if int8 else oracle)
        log(f"[d8] bench.py --small geometry (D=8), {name}: launches {counts} "
            f"(expected {want}); {steps} decode steps, {chunks} chunks; tokens "
            + ("== the int8 kernel run's" if name == "paged_int8_gather" else
               "== the dense oracle" if ref is oracle else "(held by the plain read)")
            + f": {ref is None or tokens[name] == ref}; kv_dtype {report.kv_dtype} "
            f"on {card}")
        if counts != want or (ref is not None and tokens[name] != ref):
            raise AssertionError(f"head dim 8 serving {name} failed")
        if kernel:
            launches["flash_attention_fwd"] = (launches.get("flash_attention_fwd", 0)
                                               + counts["launches"])
            key = "flash_decode_int8" if int8 else "flash_decode"
            launches[key] = launches.get(key, 0) + counts["fd_launches"] - (
                0 if int8 else counts["launches_multi_query"])
            if not int8:
                launches["flash_decode_chunk"] = (launches.get("flash_decode_chunk", 0)
                                                  + counts["launches_multi_query"])
        del engine
    r = max(requests, key=lambda x: len(x.prompt))
    seq = list(r.prompt) + oracle[r.uid]
    for path, fn in (("dense", teacher_forced_error),
                     ("paged", teacher_forced_paged_error)):
        extra = {"page": SMALL_PAGE, "chunk": SMALL_PAGE} if path == "paged" else {}
        err, top = fn(torch, params, seq, len(r.prompt), geo=geo,
                      max_seq=SMALL_MAX_SEQ, **extra)
        log(f"[d8] teacher-forced {path} path over {len(seq)} tokens: max |logit "
            f"- dense forward| {err:.3e} of max |logit| {top:.3f} (tolerance "
            f"{LOGIT_RTOL:g} of the max) on {card}")
        if not err <= LOGIT_RTOL * top:
            raise AssertionError(f"head dim 8 teacher-forced {path} logits: {err}")
    torch.cuda.empty_cache()
    return launches


# ---- bf16 serving at full width ------------------------------------------

#: teacher-forced logits of the bf16 serving path (bf16 K1 prefill, K4 on
#: bf16 pages) against one dense bf16 forward, of the largest |logit|: the
#: two paths round attention differently (the dense forward rounds Q K^T
#: and P V's output to bf16, the kernels keep S in f32 and round P against
#: a running max), a few bf16 ulps (2^-8 relative) carried through 12 layers
LOGIT_RTOL_BF16 = 5e-2

BF16_RUNS = (  # name, layout, engine options, requests ("dense" or "paged" cell's)
    ("dense", "dense", {}, "dense"),
    ("dense_on_paged", "dense", {}, "paged"),
    ("paged", "paged", {}, "paged"),
    ("paged_cold", "paged", {"prefix_cache": False}, "paged"),
    ("paged_int8", "paged", {"cache_dtype": "int8"}, "paged"),
)


def phase_serve_bf16(torch, np, fa, fd, card, params, dense, paged):
    """The full-width serve model with bf16 weights (the f32 cells' weights
    cast) on the dense and paged cells' requests: a dense bf16 cache, bf16
    pages with the shared prefix (and a cold twin), and int8 pages under
    bf16 weights.  Each run with the counters zeroed just before it and
    read just after."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import forward
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request,
    )
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    layers = SERVE["num_layers"]
    bparams = tree_map(lambda t: t.bfloat16(), params)
    cells = {"dense": dense["requests"], "paged": paged["requests"]}
    runs = {}
    for name, layout, kw, cell in BF16_RUNS:
        engine = serve_engine(torch, np, bparams, layout, (64, 72, 200, 512), 4, **kw)
        _zero_counters(fa, fd)
        torch.cuda.synchronize()
        results, report = ContinuousBatchingScheduler(
            engine, max_new_tokens=NEW_TOKENS).run(
            [Request(uid=r.uid, prompt=list(r.prompt)) for r in cells[cell]])
        torch.cuda.synchronize()
        counts = {**_fa_counts(fa), **_fd_counts(fd)}
        steps = report.decode_steps
        chunks = engine.chunks_run if layout == "paged" else 0
        k4 = layers * (chunks + steps)
        want = {c: 0 for c in counts}
        want.update({"launches_bf16": layers * len(cells[cell]) if layout == "dense" else 0,
                     "fd_launches": k4, "launches_bf16_fd": k4,
                     "launches_multi_query": layers * chunks,
                     "launches_int8": k4 if "int8" in name else 0})
        kv = "int8" if "int8" in name else "bfloat16"
        log(f"[serve-bf16] {name}: launches {counts} (expected {want}: bf16 K1 "
            f"{layers} a prompt on the dense layout, bf16 K4 {layers} a chunk and a "
            f"decode step, every f32 counter 0; {chunks} chunks, {steps} decode steps)")
        if counts != want:
            raise AssertionError(f"bf16 {name}: unexpected launch counts {counts}")
        if (report.kv_dtype, report.weights_dtype) != (kv, "bfloat16"):
            raise AssertionError(f"bf16 {name}: {report.kv_dtype}/{report.weights_dtype}")
        if report.finish_reasons != {"length": len(cells[cell])}:
            raise AssertionError(f"bf16 {name}: finish {report.finish_reasons}")
        if layout == "paged":
            engine.allocator.check()
            if engine.allocator.pages_in_use:
                raise AssertionError(f"bf16 {name}: pages leaked")
        log(f"[serve-bf16] {name}: tokens/s {report.tokens_per_sec} | TTFT p50 "
            f"{report.ttft_s['p50'] * 1e3:.2f} ms p99 {report.ttft_s['p99'] * 1e3:.2f} ms"
            f" | decode step p50 {report.decode_step_s['p50'] * 1e3:.3f} ms | decode "
            f"tokens/s {report.decode_tokens_per_sec} | kv_bytes_peak "
            f"{report.kv_bytes_peak} of kv_bytes {report.kv_bytes} | prefix hit rate "
            f"{report.prefix_hit_rate} on {card}")
        log(f"[serve-bf16] {name} report " + json.dumps(report.to_dict()))
        runs[name] = dict(tokens={r.uid: r.tokens for r in results}, report=report,
                          counts=counts, engine=engine)
    f32_peak = paged["f32_report"].kv_bytes_peak
    bf16_peak = runs["paged"]["report"].kv_bytes_peak
    same = runs["paged"]["tokens"] == runs["paged_cold"]["tokens"]
    log(f"[serve-bf16] bf16 prefix hit == cold run tokens: {same}")
    if not same:
        raise AssertionError("bf16 prefix hit != cold run tokens")
    if not runs["paged"]["report"].prefix_hit_rate > 0:
        raise AssertionError("bf16 paged: no prefix hit")
    # paged == dense: the same bf16 K/V in both layouts decode to the same
    # bits.  The two ENGINES prefill through different kernels (bf16 K1
    # rounds P to bf16 before P V; the paged chunk path keeps it f32), so
    # their caches differ by bf16 rounding and their streams may part at a
    # near-tie: that agreement is measured, not pinned
    for req in sorted(cells["paged"], key=lambda r: len(r.prompt))[:2]:
        same, steps = layouts_decode_bitwise(torch, bparams, req.prompt, NEW_TOKENS)
        log(f"[serve-bf16] {req.uid} (prompt {len(req.prompt)}): one bf16 prompt "
            f"pass in a dense bf16 cache and in scrambled bf16 pages, then {steps} "
            f"greedy decode steps on each: logits bitwise equal at every step: {same}")
        if not same:
            raise AssertionError("bf16 paged decode != dense decode on the same K/V")
    agree = sum(a == b for uid, toks in runs["paged"]["tokens"].items()
                for a, b in zip(toks, runs["dense_on_paged"]["tokens"][uid]))
    log(f"[serve-bf16] bf16 paged engine vs bf16 dense engine on the paged "
        f"cell's requests, free-running greedy agreement: "
        f"{agree / (REQUESTS * NEW_TOKENS):.4f} (the prompt passes round apart)")
    log(f"[serve-bf16] kv_bytes_peak: bf16 pages {bf16_peak}, f32 pages {f32_peak} "
        f"(ratio {bf16_peak / f32_peak}); int8 pages under bf16 weights "
        f"{runs['paged_int8']['report'].kv_bytes_peak}")
    if 2 * bf16_peak != f32_peak:
        raise AssertionError("bf16 kv_bytes_peak is not half the f32 run's")
    same = sum(a == b for uid, toks in runs["paged"]["tokens"].items()
               for a, b in zip(toks, paged["f32_tokens"][uid]))
    log(f"[serve-bf16] bf16 vs f32 paged greedy token agreement (free-running): "
        f"{same / (REQUESTS * NEW_TOKENS):.4f}")
    reqs = sorted(dense["requests"], key=lambda r: len(r.prompt))[:2]
    for req in reqs:
        want = naive_greedy(torch, forward, bparams, req.prompt, NEW_TOKENS)
        got = runs["dense"]["tokens"][req.uid]
        log(f"[serve-bf16] {req.uid} (prompt {len(req.prompt)}): greedy tokens equal "
            f"the bf16 dense full-forward oracle: {got == want}")
        if got != want:
            raise AssertionError(f"{req.uid}: bf16 engine {got} != oracle {want}")
        err, scale = teacher_forced_error(torch, bparams, list(req.prompt) + got,
                                          len(req.prompt))
        log(f"[serve-bf16] {req.uid}: teacher-forced logits, bf16 kernel path vs "
            f"bf16 dense forward: max|d|={err:.3e} (largest |logit| {scale:.3f}, "
            f"tolerance {LOGIT_RTOL_BF16:g} of it)")
        if not err <= LOGIT_RTOL_BF16 * scale:
            raise AssertionError(f"{req.uid}: bf16 serving logits drift {err}")
    rng = np.random.default_rng(4)
    for name in ("dense", "paged"):
        engine = runs[name]["engine"]
        toks, pos = fill_slots(np, engine, rng)
        wall, busy, top, _ = profile_share(torch, lambda: engine.decode(toks, pos), 10)
        share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
        log(f"[profile] bf16 {name} decode step (8 slots, pos 300): host wall "
            f"{wall:.3f} ms, kernel time {share} on {card}")
        log_k4(top, busy)
        for key, ms in top[:6]:
            log(f"[profile]   {ms:8.4f} ms  {key[:90]}")
        for slot in range(SLOTS):
            engine.release(slot)
    out = {"decode_bf16": {n: runs[n]["counts"]["launches_bf16_fd"]
                           for n in ("dense", "paged")},
           "k1_bf16": runs["dense"]["counts"]["launches_bf16"],
           "int8_bf16q": runs["paged_int8"]["counts"]["launches_bf16_fd"]}
    del runs
    torch.cuda.empty_cache()
    return out


def layouts_decode_bitwise(torch, params, prompt, n):
    """One flash prompt pass of ``prompt`` whose K/V go into a dense cache
    and into scrambled pages of the weights' dtype, then ``n`` greedy
    decode steps on each layout: (logits bitwise equal at every step,
    steps)."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward_decode, forward_decode_paged, forward_prefill,
    )
    from distributeddeeplearning_tpu_torch.serve import (
        init_cache, init_paged_cache, insert_pages, insert_sequence, pages_for,
    )

    heads, layers = SERVE["num_heads"], SERVE["num_layers"]
    hd, nb, dtype = SERVE["d_model"] // heads, MAX_SEQ // PAGE, params["embed"].dtype
    p = len(prompt)
    with torch.inference_mode():
        logits, k, v = forward_prefill(params, torch.tensor([prompt], device="cuda"),
                                       num_heads=heads, attention="flash")
        dense = init_cache(batch_slots=1, num_layers=layers, max_seq=MAX_SEQ,
                           num_heads=heads, head_dim=hd, dtype=dtype, device="cuda")
        insert_sequence(dense, k, v, 0)
        pool = init_paged_cache(num_pages=nb, num_layers=layers, page_size=PAGE,
                                num_heads=heads, head_dim=hd, dtype=dtype, device="cuda")
        table = (torch.randperm(nb, generator=torch.Generator().manual_seed(p)) + 1
                 ).to(torch.int32).cuda()
        used = pages_for(p, PAGE)
        pad = lambda t: torch.nn.functional.pad(  # noqa: E731
            t[0], (0, 0, 0, 0, 0, used * PAGE - p))
        insert_pages(pool, pad(k), pad(v), table[:used], page_size=PAGE)
        tok = torch.argmax(logits[0, -1:].float(), -1).to(torch.int32)
        same = True
        for i in range(n):
            pos = torch.tensor([p + i], dtype=torch.int32, device="cuda")
            a, _ = forward_decode(params, tok, dense, pos, num_heads=heads)
            b, _ = forward_decode_paged(params, tok, pool, pos, table[None],
                                        num_heads=heads)
            same = same and torch.equal(a, b)
            tok = torch.argmax(a.float(), -1).to(torch.int32)
    return same, n


# ---- the key-padding bias (K1-K3 built with HAS_BIAS) and BERT fine-tuning --

#: the bias kernels are timed at bert-base's longest sequence
BIAS_TIMED = dict(b=8, h=12, s=512, d=64)


def padding_keep(torch, b, s, seed):
    """[b, s] bool key mask on the card: SyntheticTextDataset lengths, then
    rows of length 1, s and 0 (every key masked) in the last three rows."""
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    mask = next(SyntheticTextDataset(length=b, seq_len=s, vocab_size=50,
                                     seed=seed).batches(b))["attention_mask"]
    keep = torch.from_numpy(mask).bool()
    keep[b - 3] = torch.arange(s) < 1
    keep[b - 2] = True
    keep[b - 1] = False
    return keep.cuda()


def _bias_check(torch, fa, dtype, d, s, causal, b=6, h=4, keep=None):
    """K1, K2, K3 with the key-padding bias of ``keep`` ([b, s] bool;
    default :func:`padding_keep`) at one (dtype, D, S, causal, B, H)
    against their plain versions (:func:`_hold_flash`); a fully masked
    row's lse equals the plain version's bit for bit, and masked keys of
    every other row get dK = dV = 0 exactly.  Returns (worst |kernel -
    plain| per kernel, the inputs (q, k, v, do, lse, delta, bias, keep))."""
    what = (f"{'bf16' if dtype == torch.bfloat16 else 'f32'} bias B={b} H={h} "
            f"D={d} S={s} causal={causal}")
    q, k, v = qkv_views(torch, b, s, h, d, dtype, seed=s + d + causal)
    if keep is None:
        keep = padding_keep(torch, b, s, seed=s + d)
    bias = fa._mask_bias(keep[:, None, None, :], b, s)
    worst, (lse, lse_p, do, delta, got) = _hold_flash(
        torch, fa, q, k, v, causal, seed=s + d, what=what, bias=bias)
    dead = ~keep.any(-1)
    if not torch.equal(lse[dead], lse_p[dead]):
        raise AssertionError(f"fully masked rows' lse differ at {what}")
    masked = ~keep
    masked[dead] = False
    if not (bool((got[1][masked] == 0).all()) and bool((got[2][masked] == 0).all())):
        raise AssertionError(f"masked keys got nonzero dK/dV at {what}")
    return worst, (q, k, v, do, lse, delta, bias, keep)


def _bias_timed(torch, F, fa, dtype, card):
    """The bias kernels in ``dtype`` at bert-base's shape (B=8, H=12,
    S=512, D=64, non-causal, synthetic-text lengths): held against their
    plain versions on these inputs, then kernel, plain and SDPA (same
    boolean attn_mask) device times and bounds.  Returns ({kernel: entry},
    worst |kernel - plain| per kernel)."""
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    b, h, s, d = (BIAS_TIMED[x] for x in ("b", "h", "s", "d"))
    bf = dtype == torch.bfloat16
    mask = next(SyntheticTextDataset(length=b, seq_len=s, seed=42).batches(b))[
        "attention_mask"]
    worst, (q, k, v, do, lse, delta, bias, keep) = _bias_check(
        torch, fa, dtype, d, s, False, b=b, h=h,
        keep=torch.from_numpy(mask).bool().cuda())
    fwd_ms, fwd_plain, fwd_lib, dq_ms, dkv_ms, bwd_plain, bwd_lib = _time_flash(
        torch, F, fa, q, k, v, do, lse, delta, causal=False, bias=bias, keep=keep)
    # work this run's data needs: every query row against its row's
    # visible keys (the kernels visit every key; masked ones add 0)
    pairs = h * s * int(keep.sum().item())
    es = 2.0 if bf else 4.0
    head = es * b * s * h * d
    small = 4.0 * b * h * s  # one f32 [B, H, S] (lse or delta)
    bias_bytes = 4.0 * b * s
    peak = BF16_FLOPS_PER_S if bf else TF32X3_FLOPS_PER_S  # f32: split TF32
    entries = {
        "fwd": (fwd_ms, fwd_plain, fwd_lib,
                bound_ms(4 * head + small + bias_bytes, 4.0 * d * pairs, peak)),
        "dq": (dq_ms, bwd_plain, bwd_lib,
               bound_ms(5 * head + 2 * small + bias_bytes, 6.0 * d * pairs, peak)),
        "dkv": (dkv_ms, bwd_plain, bwd_lib,
                bound_ms(6 * head + 2 * small + bias_bytes, 8.0 * d * pairs, peak)),
    }
    tag = "bf16" if bf else "f32"
    k1_flops = 4.0 * d * pairs
    log(f"[bias] {tag} K1 at B={b} H={h} S={s} D={d}"
        + (f" ({fa.bf16_block_rows(b, h, s)}-row blocks)" if bf else "")
        + f": {k1_flops / fwd_ms / 1e9:.1f} TFLOP/s, "
        f"{entries['fwd'][3][0] / fwd_ms:.1%} of its bound (sdpa "
        f"{k1_flops / fwd_lib / 1e9:.1f} TFLOP/s); device times, on {card}")
    shape = (f"B={b} H={h} S={s} D={d} non-causal {tag}, synthetic-text mask "
             f"({int(keep.sum().item())} of {b * s} keys visible; strided qkv views)")
    if not bf:
        rows = {kind: fa.f32_bwd_block_rows(kind, b, h, s) for kind in ("dq", "dkv")}
        log(f"[bias] f32 K2/K3 at B={b} H={h} S={s} D={d}: {rows['dq']}/"
            f"{rows['dkv']}-row blocks, {6.0 * d * pairs / dq_ms / 1e9:.1f} / "
            f"{8.0 * d * pairs / dkv_ms / 1e9:.1f} TFLOP/s; K2+K3 {dq_ms + dkv_ms:.4f} "
            f"ms, {(dq_ms + dkv_ms) / bwd_lib:.2f}x SDPA's backward; device "
            f"times, on {card}")
    log(f"[bias] {tag} at B={b} H={h} S={s} D={d}, {int(keep.sum().item())} of "
        f"{b * s} keys visible: K1 {fwd_ms:.4f} ms (bound {entries['fwd'][3][0]:.4f}, "
        f"{entries['fwd'][3][1]}), K2 {dq_ms:.4f} ms (bound {entries['dq'][3][0]:.4f}, "
        f"{entries['dq'][3][1]}), K3 {dkv_ms:.4f} ms (bound "
        f"{entries['dkv'][3][0]:.4f}, {entries['dkv'][3][1]}); plain forward "
        f"{fwd_plain:.4f} ms, plain backward {bwd_plain:.4f} ms; sdpa with the "
        f"boolean mask {fwd_lib:.4f} ms, its backward {bwd_lib:.4f} ms; held "
        f"against the plain versions on these inputs (max |kernel - plain| K1 "
        f"{worst['fwd']:.3e}, K2 {worst['dq']:.3e}, K3 {worst['dkv']:.3e}); "
        f"device times, on {card}")
    return ({kern: dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms, shape=shape)
             for kern, (ms, plain_ms, lib_ms, (bms, by)) in entries.items()}, worst)


#: (B, H, S, D, causal) of the bias checks: small batches at every head dim
#: and S, causal and not; then bert-base's own shapes (B=8, H=12, D=64,
#: non-causal) at seq 128 and 512, with H=12 exercising the kernels'
#: batch row = (batch x head) // H
BIAS_CHECKS = tuple((6, 4, s, d, causal) for d in (16, 32, 64)
                    for s in (1, 37, 128, 512) for causal in (False, True)) + (
    (8, 12, 128, 64, False), (8, 12, 512, 64, False))


def phase_bias(torch, F, fa, card):
    """K1, K2, K3 with the key-padding bias against their plain versions in
    f32 and bf16 at every shape of :data:`BIAS_CHECKS`, with a length-1
    row, a full row and an all-masked row beside synthetic-text lengths;
    then held and timed at bert-base's shape on a synthetic-text batch.
    Returns {(kernel, dtype): JSON row fields}."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        for b, h, s, d, causal in BIAS_CHECKS:
            errs, _ = _bias_check(torch, fa, dtype, d, s, causal, b=b, h=h)
            worst = {kern: max(worst[kern], e) for kern, e in errs.items()}
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        log(f"[bias] {tag} K1-K3 held at B=6 H=4 D 16/32/64, S 1/37/128/512, "
            f"causal and not, and at B=8 H=12 D=64 S 128/512 non-causal (f32: "
            f"K1 {K1_TOL:g}, K2/K3 {BWD_RTOL:g} of the max; bf16: hold_bf16), "
            f"all-masked rows' lse bitwise, masked keys' dK = dV = 0 exactly; "
            f"max |kernel - plain| K1 {worst['fwd']:.3e}, K2 {worst['dq']:.3e}, "
            f"K3 {worst['dkv']:.3e}")
        timed, timed_worst = _bias_timed(torch, F, fa, dtype, card)
        for kern, entry in timed.items():
            rows[(kern, tag)] = {**entry,
                                 "max_abs_err": max(worst[kern], timed_worst[kern])}
    torch.cuda.empty_cache()
    return rows


#: bert-base fine-tuning at the workload's defaults (bf16, batch 8, dropout
#: 0.1, AdamW, clip 1.0, warmup then decay): one epoch of 8 steps on a fresh
#: batch each (64 examples), then one eval pass over min(64, 4 x 8) = 32
#: examples, 4 batches
BERT_RUN = dict(model="bert-base", batch_size=8, epochs=1, steps_per_epoch=8,
                train_examples=64)
BERT_STEPS = BERT_RUN["epochs"] * BERT_RUN["steps_per_epoch"]
BERT_EVAL_BATCHES = 4
#: flash vs the default attention, same seed, dropout 0: |flash - default| /
#: default per-step loss.  f32: the two differ in summation order only;
#: bf16: the default attention rounds its scores and weights to bf16 where
#: flash keeps f32 scores.  PERF.md gives the readings behind each limit
#: (scripts/bert_loss_gap.py over five seeds, with a bias-dropped control).
BERT_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def trust_note(busy, event_ms) -> str:
    """The profiled kernel sum beside a CUDA-event span of the same steps;
    more than 10% apart marks the breakdown untrusted."""
    if busy is None:
        return "kernel sum not measured (no device time in the profile)"
    gap = abs(event_ms - busy) / max(event_ms, 1e-9)
    verdict = ("UNTRUSTED: the two differ by more than 10%" if gap > 0.10
               else "trusted: within 10%")
    return (f"kernel sum {busy:.3f} ms vs CUDA-event span {event_ms:.3f} ms of "
            f"the same steps ({gap:.1%} apart; breakdown {verdict})")


def _bert_run(torch, np, fa, *, seq_len, attention, dropout_rate, dtype_kw,
              **overrides):
    """One ``workloads.bert.main`` run with the counters zeroed just before
    and read just after, the plain versions counted, and each train step's
    loss and CUDA-event span (from its launch to the next step's, the last
    to its own end) recorded
    by wrapping the train step the workload builds; ``overrides`` replace
    :data:`BERT_RUN`'s arguments.  Returns (state, per-step losses, per-step
    ms, counts, plain calls, peak GB)."""
    import tempfile

    from distributeddeeplearning_tpu_torch.train import step as tstep
    from distributeddeeplearning_tpu_torch.workloads import bert

    plain_calls = [0]
    originals = (fa._dense_attention, fa._dense_attention_bwd, tstep.build_train_step)
    losses, marks, ends = [], [], []

    def counted(fn):
        def wrapper(*args, **kwargs):
            plain_calls[0] += 1
            return fn(*args, **kwargs)
        return wrapper

    def recording_build(*args, **kwargs):
        train_step = originals[2](*args, **kwargs)

        def step(state, batch):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            state, metrics = train_step(state, batch)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            losses.append(metrics["loss"].detach())
            return state, metrics
        return step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        fa._dense_attention, fa._dense_attention_bwd = map(counted, originals[:2])
        tstep.build_train_step = recording_build
        try:
            for c in FA_COUNTERS:
                setattr(fa, c, 0)
            torch.cuda.synchronize()
            state, _ = bert.main(seq_len=seq_len, attention=attention,
                                 dropout_rate=dropout_rate, device="cuda",
                                 metrics_path=path,
                                 **{**BERT_RUN, **dtype_kw, **overrides})
            torch.cuda.synchronize()
            counts = {c: getattr(fa, c) for c in FA_COUNTERS}
        finally:
            fa._dense_attention, fa._dense_attention_bwd, tstep.build_train_step = (
                originals)
        with open(path) as f:
            rows = [json.loads(line) for line in f]
    for r in rows:
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics {bad} in epoch {r['epoch']}")
    losses = [x.item() for x in losses]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"per-step losses {losses}")
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:] + ends[-1:])]
    return (state, losses, step_ms, counts, plain_calls[0],
            torch.cuda.max_memory_allocated() / 1e9)


def phase_bert(torch, np, fa, card):
    """bert-base fine-tuning at full width through ``workloads.bert.main``:
    at the defaults (bf16, batch 8, seq 128), then seq 512, and in f32 at
    seq 128; each with flash and with the default attention at dropout 0
    (same seed: per-step losses within :data:`BERT_LOSS_RTOL` of the
    dtype), and at the defaults flash at dropout 0.1 (finite losses).  Flash
    runs must launch exactly the bias kernels of their dtype (12 K1 a
    forward, 12 K2 and 12 K3 a train step), nothing else, and never call a
    plain version.  Returns {(seq_len, dtype): {kernel: launches}} of the
    flash runs at dropout 0."""
    from distributeddeeplearning_tpu_torch.train.state import tree_leaves

    layers, steps = 12, BERT_STEPS
    launches = {}
    for seq_len, dtype in ((128, "bfloat16"), (512, "bfloat16"), (128, "float32")):
        sfx = "_bf16" if dtype == "bfloat16" else ""
        dtype_kw = {} if dtype == "bfloat16" else {"compute_dtype": "float32"}
        tag = f"[bert] seq {seq_len} {dtype}"
        losses = {}
        runs = [("flash", 0.0), ("default", 0.0)]
        if (seq_len, dtype) == (128, "bfloat16"):
            runs.append(("flash", 0.1))  # the workload's own defaults
        for attention, rate in runs:
            state, loss, step_ms, counts, plain, peak_gb = _bert_run(
                torch, np, fa, seq_len=seq_len, attention=attention,
                dropout_rate=rate, dtype_kw=dtype_kw)
            want = {c: 0 for c in FA_COUNTERS}
            if attention == "flash":
                want.update({f"launches_bias{sfx}":
                             layers * (steps + BERT_EVAL_BATCHES),
                             f"launches_dq_bias{sfx}": layers * steps,
                             f"launches_dkv_bias{sfx}": layers * steps})
            if counts != want or plain:
                raise AssertionError(f"{tag} {attention}: launches {counts}, plain "
                                     f"calls {plain} (expected {want}, 0)")
            losses[(attention, rate)] = loss
            p50 = float(np.median(step_ms[1:])) / 1e3
            b = BERT_RUN["batch_size"]
            tokens = b * seq_len
            n_params = sum(t.numel() for t in tree_leaves(state.params))
            flops = 6 * n_params * tokens + 3 * 4 * b * seq_len * seq_len * 768 * layers
            peak = BF16_FLOPS_PER_S if sfx else F32_FLOPS_PER_S
            log(f"{tag} {attention} dropout {rate}: {n_params / 1e6:.1f} M params; "
                f"loss by step {[round(x, 5) for x in loss]}; step p50 "
                f"{p50 * 1e3:.2f} ms (CUDA-event span from one step's launch to "
                f"the next; steps 1..{steps} in order: "
                f"{[round(x, 2) for x in step_ms]}), tokens/s {tokens / p50:.1f} "
                f"(padded positions counted), mfu {flops / p50 / peak:.4f} of "
                f"{peak / 1e12:.1f} TFLOP/s ({flops / 1e12:.3f} TFLOP a step), peak "
                f"memory {peak_gb:.2f} GB; launches {counts} on {card}")
            if attention == "flash" and rate == 0.0:
                launches[(seq_len, dtype)] = {
                    kern: counts[f"launches{pre}_bias{sfx}"]
                    for kern, pre in (("fwd", ""), ("dq", "_dq"), ("dkv", "_dkv"))}
                if seq_len == 128:
                    _profile_bert(torch, state, seq_len, dtype, card)
            del state
        flash, default = losses[("flash", 0.0)], losses[("default", 0.0)]
        rel = [abs(a - c) / abs(c) for a, c in zip(flash, default)]
        log(f"{tag}: |flash - default| / default loss by step "
            f"{[f'{x:.2e}' for x in rel]} (tolerance {BERT_LOSS_RTOL[dtype]:g})")
        if len(rel) != steps or max(rel) > BERT_LOSS_RTOL[dtype]:
            raise AssertionError(f"{tag}: flash losses left the default attention's")
    torch.cuda.empty_cache()
    return launches


def _profile_bert(torch, state, seq_len, dtype, card):
    """One profiled train step of the returned state: kernel groups and the
    kernel sum beside a CUDA-event span of the same steps."""
    from distributeddeeplearning_tpu_torch.train.step import build_train_step
    from distributeddeeplearning_tpu_torch.workloads import bert

    sfx = "_bf16" if dtype == "bfloat16" else ""
    step = build_train_step(state, compute_dtype=getattr(torch, dtype), rng=43)
    batch = next(bert._batches(BERT_RUN["batch_size"], seq_len, 30522, 2, 42, 8,
                               is_training=False))
    wall, busy, top, event_ms = profile_share(torch, lambda: step(state, batch), 2)
    log(f"[profile] bert step (B=8, S={seq_len}, {dtype}, flash with the bias): "
        f"host wall {wall:.3f} ms; {trust_note(busy, event_ms)} on {card}")
    gemms = f"{'bf16' if sfx else 'f32'} GEMMs (cuBLAS/CUTLASS)"
    bsfx = sfx or "_f32"  # the f32 kernels are named so
    kernels = {f"K1 flash_fwd{bsfx}_kernel (bias)": f"flash_fwd{bsfx}_kernel",
               f"K2 flash_bwd_dq{bsfx}_kernel (bias)": f"flash_bwd_dq{bsfx}_kernel",
               f"K3 flash_bwd_dkv{bsfx}_kernel (bias)": f"flash_bwd_dkv{bsfx}_kernel"}
    log_groups(top, busy, gemms, kernels)


def log_k4(top, busy):
    """The decode kernel's share of a profiled serving step: its split and
    merge passes (every kernel named ``flash_decode_*``) under one name."""
    ms = sum(t for key, t in top if "flash_decode" in key)
    note_profiled(top, ["flash_decode"])
    share = "" if not busy else f", {ms / busy:.1%} of kernel time"
    log(f"[profile]   K4 (split + merge passes): {ms:.4f} ms a step{share}")
    return ms


def log_groups(top, busy, gemms, kernels):
    """Kernel time by group (GEMMs, the named kernels, the rest), then the
    ten largest kernels."""
    groups = {gemms: 0.0, **{g: 0.0 for g in kernels}, "everything else": 0.0}
    for key, ms in top:
        low = key.lower()
        group = next((g for g, name in kernels.items() if name in key), None)
        if group is None:
            group = gemms if ("gemm" in low or "nvjet" in low or "cutlass" in low
                              or "xmma" in low) else "everything else"
        groups[group] += ms
    note_profiled(top, kernels.values())
    for group, ms in groups.items():
        log(f"[profile]   {ms:9.3f} ms  {ms / max(busy or 1e-9, 1e-9):6.1%}  {group}")
    for key, ms in top[:10]:
        log(f"[profile]   {ms:8.4f} ms  {key[:90]}")


def note_profiled(top, names):
    """Adds to PROFILED each kernel instance of a profile (``top``) whose
    name holds one of ``names``, under that name."""
    for key, _ in top:
        for name in names:
            if name in key:
                m = re.search(r"\w+_kernel<[^>]*>", key)
                PROFILED.setdefault(name, set()).add(m.group(0) if m else key)


def profiled_kernels(row_name):
    """The instances of the CUDA kernel a kernels-line row's wrapper
    launches, as the run's profiles named them: flash_attention_<pass>
    [_bias][_bf16] launches flash_<pass>_<f32 or bf16>_kernel (a row lists
    its instances with and without the bias); the flash_decode* wrappers
    share the flash_decode split and merge kernels (each row lists all
    their instances)."""
    if row_name.startswith("flash_decode"):
        name = "flash_decode"
    else:
        dtype = "_bf16" if row_name.endswith("_bf16") else "_f32"
        stem = row_name.replace("_bias", "").replace("_bf16", "")
        name = stem.replace("flash_attention_", "flash_") + dtype + "_kernel"
    return sorted(PROFILED.get(name, ()))


def log_instances(_build):
    """One build line per instance of the bf16 forward (K1) and backward
    (K2, K3) and of the f32 forward and backward (K1, K2, K3 on split
    TF32) -- head dim, bias, rows a block: its registers and spill bytes
    from ``ptxas -v`` and its dynamic shared memory from the library."""
    fwd = _build.load("flash_attention_fwd")
    bwd = _build.load("flash_attention_bwd")
    # bf16: <D, bias, 64-row consumer warpgroups>; f32: <D, bias, 16-row
    # warps, streamed rows>
    pattern = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)_(bf16|f32)_kernelILi(\d+)ELb([01])"
                         r"ELi(\d)E")
    info = {}
    for lib in ("flash_attention_fwd", "flash_attention_bwd"):
        fn = None
        for line in _build.build_log.get(lib, "").splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                m = pattern.search(line)
                fn = ((m.group(1), m.group(2), int(m.group(3)), int(m.group(4)),
                       (64 if m.group(2) == "bf16" else 16) * int(m.group(5)))
                      if m else None)
            elif fn is not None and "spill" in line:
                info.setdefault(fn, {})["spill"] = line.strip()
            elif fn is not None and "registers" in line:
                info.setdefault(fn, {})["regs"] = re.search(r"Used (\d+) registers",
                                                            line).group(1)
    names = {"fwd": "K1", "bwd_dq": "K2", "bwd_dkv": "K3"}
    for (kind, dtype, d, bias, rows), got in sorted(info.items()):
        if dtype == "f32" and kind == "fwd":
            smem = fwd.flash_attention_fwd_f32_smem_bytes(d, rows)
        elif dtype == "f32":
            smem = bwd.flash_attention_bwd_f32_smem_bytes(int(kind == "bwd_dkv"), d, rows)
        elif kind == "fwd":
            smem = fwd.flash_attention_fwd_bf16_smem_bytes(d, bias, rows)
        else:
            smem = bwd.flash_attention_bwd_bf16_smem_bytes(int(kind == "bwd_dkv"),
                                                           d, bias, rows)
        log(f"[build] {dtype} {names[kind]} D={d} bias={bool(bias)} rows={rows}: "
            f"{got.get('regs')} registers, {got.get('spill')}, {smem} bytes of "
            f"dynamic shared memory")


def _fd_counts(fd):
    """The decode kernel's counters, named apart from the flash ones."""
    return {"fd_launches": fd.launches, "launches_bf16_fd": fd.launches_bf16,
            "launches_int8": fd.launches_int8,
            "launches_multi_query": fd.launches_multi_query,
            "launches_verify": fd.launches_verify}


def _zero_counters(fa, fd):
    for c in FA_COUNTERS:
        setattr(fa, c, 0)
    fd.launches = fd.launches_bf16 = fd.launches_int8 = 0
    fd.launches_multi_query = fd.launches_verify = 0


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
        t_start = time.perf_counter()
        card = card_line()
        log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        times = _build.build_all()
        log(f"[build] {len(times)} kernels in {time.perf_counter() - t0:.2f} s "
            f"(parallel nvcc): {times}")
        for name, text in _build.build_log.items():
            fn = ""  # the (mangled) kernel the next ptxas lines describe
            for line in text.splitlines():
                m = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
                if m:
                    fn = m.group(1)
                elif "registers" in line or "spill" in line:
                    log(f"[build] {name}: {fn}: {line.strip()}")
        log_instances(_build)
        k1 = timed(phase_k1, torch, F, fa, card)
        k1_bf16 = timed(phase_k1_bf16, torch, F, fa, card)
        k4 = timed(phase_k4, torch, F, fd, card)
        k4b = timed(phase_k4b, torch, F, fd, card)
        k4c = timed(phase_k4c, torch, fd, card)
        k4v = timed(phase_k4v, torch, F, fd, card)
        k4_bf16, k4_int8_bf16q = timed(phase_k4_bf16, torch, F, fd, card)
        timed(phase_int_mm, torch, card)
        served, dense_engine, dense = timed(phase_serve, torch, np, fa, fd, card)
        paged = timed(phase_serve_paged, torch, np, fa, fd, card, dense_engine)
        spec = timed(phase_serve_spec, torch, np, fa, fd, card, dense_engine.params,
                     dense_engine, dense, paged)
        served_bf16 = timed(phase_serve_bf16, torch, np, fa, fd, card,
                            dense_engine.params, dense, paged)
        del dense_engine
        torch.cuda.empty_cache()
        headdim = timed(phase_headdim, torch, F, fa, fd, card)
        defaults = timed(phase_default_geometries, torch, np, fa, fd, card)
        defaults[8] = timed(phase_serve_d8, torch, np, fa, fd, card)
        bwd = timed(phase_bwd, torch, F, fa, card)
        bwd_bf16 = timed(phase_bwd_bf16, torch, F, fa, card)
        timed(phase_grad_parity, torch, np)
        timed(phase_grad_parity_bf16, torch, np, fa)
        trained, f32_losses = timed(phase_train, torch, np, fa, card)
        trained_bf16, _ = timed(phase_train, torch, np, fa, card, dtype="bfloat16",
                                f32_losses=f32_losses)
        bias = timed(phase_bias, torch, F, fa, card)
        bert_runs = timed(phase_bert, torch, np, fa, card)
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
             launches=served["flash_decode"],
             launches_by_path={"serve_dense": served["flash_decode"],
                               "serve_paged_f32": paged["decode_f32"],
                               **{f"{name}_draft": run["draft"]
                                  for name, run in spec.items()}}, **k4),
        dict(name="flash_decode_chunk", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=paged["chunk_f32"], **k4b),
        dict(name="flash_decode_int8", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=paged["int8"], **k4c),
        dict(name="flash_decode_verify", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=sum(run["counts"]["verify"] for run in spec.values()),
             launches_by_path={name: run["counts"]["verify"]
                               for name, run in spec.items()}, **k4v),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:335",
             launches=trained["flash_attention_bwd_dq"], **bwd["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:355",
             launches=trained["flash_attention_bwd_dkv"], **bwd["dkv"]),
        dict(name="flash_attention_fwd_bf16", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:160",
             launches=trained_bf16["flash_attention_fwd"],
             launches_by_path={"train": trained_bf16["flash_attention_fwd"],
                               "serve_bf16": served_bf16["k1_bf16"]}, **k1_bf16),
        dict(name="flash_attention_bwd_dq_bf16", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:335",
             launches=trained_bf16["flash_attention_bwd_dq"], **bwd_bf16["dq"]),
        dict(name="flash_attention_bwd_dkv_bf16", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_attention.py:355",
             launches=trained_bf16["flash_attention_bwd_dkv"], **bwd_bf16["dkv"]),
        dict(name="flash_decode_bf16", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=sum(served_bf16["decode_bf16"].values()),
             launches_by_path={f"serve_bf16_{n}": c
                               for n, c in served_bf16["decode_bf16"].items()},
             **k4_bf16),
        dict(name="flash_decode_int8_bf16q", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=served_bf16["int8_bf16q"], **k4_int8_bf16q),
    ]
    # the key-padding-bias variants of K1-K3: held and timed in phase_bias,
    # launched by BERT fine-tuning (bf16: the defaults at seq 128, and seq
    # 512; f32: seq 128 in f32)
    for kern, stem, src, line in (
            ("fwd", "flash_attention_fwd", "flash_attention_fwd.cu", 160),
            ("dq", "flash_attention_bwd_dq", "flash_attention_bwd.cu", 335),
            ("dkv", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", 355)):
        for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            by_path = {"bert_flash": bert_runs[(128, dtype)][kern]}
            if tag == "bf16":
                by_path["bert_flash_seq512"] = bert_runs[(512, dtype)][kern]
            rows.append(dict(
                name=f"{stem}_bias{'_bf16' if tag == 'bf16' else ''}", route="cuda",
                source=f"distributeddeeplearning_tpu_torch/csrc/{src}",
                replaces=f"distributeddeeplearning_tpu/ops/flash_attention.py:{line}",
                launches=by_path["bert_flash"], launches_by_path=by_path,
                **bias[(kern, tag)]))
    # each kernel at head dims 16 and 32: held and timed in phase_headdim,
    # launched on the main paths of the reference's default geometries
    # (`ddlt serve` at 16, the LM workload at 32) where one runs it
    for row in rows:
        row["head_dims"] = {
            str(d): {**entry, "launches": defaults[d].get(row["name"], 0)}
            for d, entry in headdim.get(row["name"], {}).items()}
    for row in rows:
        row["kernel"] = profiled_kernels(row["name"])
    log(f"[timer] windows timed by CUDA events for want of profiler device "
        f"time: {len(EVENT_TIMED)}; windows that lost launch records, timed by "
        f"the launches recorded: {len(PARTIAL_WINDOWS)}")
    log(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

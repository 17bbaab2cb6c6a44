#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (the port's package sits beside this
script); it needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch
built for CUDA, and imports nothing of jax or of the JAX package.  Phases:

1. build: compile every CUDA kernel from ``csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time and each kernel's
   registers and spills; beside it, phase 30's shards are written and its
   ``python -m`` run starts on them (``_ImagenetEarly``; waited for before
   phase 2);
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
   drafter (the first 2 layers), the int8-weight drafter (first 8
   requests) and a forced-rejection drafter (first 4), and the dense engine with
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
   the f32 run's (same seed, same batch); mfu is over the card's dense
   bf16 peak (``utils/hardware.PEAKS``);
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
   (109.5 M params), one epoch of 4 steps and one eval pass, at its
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
   same);
18. ``phase_resnet``: the reference's synthetic benchmark,
   ``workloads.benchmark.main()`` at its defaults (resnet50, bf16, batch
   64, 224 px, 1001 classes, SGD momentum under the Goyal schedule; 10
   warmup batches, then 10 measured windows of 10 between an unmeasured
   priming window and a trailing one), as ``python -m`` in a fresh
   process (its img/s: earlier profiler windows slow a host-bound step in
   this one), then here shortened (3 warmup batches, 3 windows of 5): img/s
   a chip mean +-ci95 and the windows, step p50 (CUDA events), peak memory
   and mfu over the card's dense bf16 peak
   from the FLOP reckoning (``ImageModel.forward_macs``: 3 x the forward's
   multiply-adds x 2 a trained image), on one ``[resnet]`` line; then one
   step profiled under ``torch.cuda.set_sync_debug_mode("error")`` (a host
   sync inside it fails the run): kernel time by group (cuDNN conv fprop,
   dgrad, wgrad, GEMM-named kernels, BatchNorm, elementwise, the
   optimizer's kernels and their device span, layout copies), the busy
   share and the kernel sum beside a CUDA-event span.  No hand-written
   kernel runs on this path: the convolutions are cuDNN's;
19. ``phase_resnet_parity``: resnet50 at 64 px, batch 4, from the same
   numpy weights (BatchNorm drawn at random) on the card and the CPU, two
   train steps, in float64 (logits, new statistics and losses within
   1e-6, params, momentum and statistics after the first step within 5e-4
   of each leaf) and in f32 (each no further from the CPU's float64 run
   than 4x the CPU's f32 run is, the second loss within 5e-2); then the
   first bf16 step at 224 px, batch 64, within 1e-2 of the f32 one; every
   reading finite;
20. ``phase_image_short``: inceptionv3 (bf16, 299 px) and vgg16 and
   resnet50 (f32, 224 px) at batch 64 through the same ``main``, 2 warmup
   batches and 2 windows of 3: img/s, step p50, peak memory and mfu;
21. ``phase_vit``: ViT-B/16 through ``workloads.benchmark.main(model=
   "vit-b16")`` (bf16, batch 64, 224 px) shortened (3 warmup batches, 3
   windows of 5):
   img/s, step p50, peak memory, mfu (``forward_macs`` counts the two
   attention products, 17.56 G multiply-adds an image) and a profiled
   step's split (GEMMs, attention, LayerNorm/GELU, elementwise, SGD); then
   a shortened vit-l16 run (2 warmup batches, 2 windows of 3);
22. ``phase_vit_flash``: the bf16 K1, K2, K3 at ViT-B/16's attention shape
   (B 64, H 12, S 197, D 64, non-causal, no bias) and at S 1 and 37 against
   their plain versions, timed beside SDPA; exact launches a ViT-B/16
   flash train step (12 K1, 12 K2, 12 K3; 24 K1 under remat ``dots`` and
   ``full``); flash losses within 1e-2 of the default attention's; the
   card's ViT forward against the CPU's in float64 and f32;
23. ``phase_resume``: ViT-B/16 with flash through the ``Trainer``, 6 steps
   with a generation every 3, twice (bitwise equal, else again under
   ``cudnn.deterministic``), then stopped before step 4 and resumed by a
   fresh ``Trainer`` and ``Checkpointer``: params, momentum and per-step
   losses bit-identical to the uninterrupted fit; the newest generation
   corrupted, ``restore`` falls back to step 3; the save, snapshot and
   verify walls;
24. ``phase_moe_bert``: bert-base with 8 experts in every second layer
   through ``workloads.bert.main(num_experts=8, attention="flash")`` at its
   defaults, 4 batches: finite losses, the load-balance term, the share of
   token-slots dropped over capacity, step p50, peak memory, exact bias
   kernel launches; the f32 forward on the card against the CPU's with the
   expert choices compared first;
25. ``phase_resilience`` (after 23): the trainer's resilience layer on
   phase 23's ViT-B/16 flash fit (``skip_nonfinite=True``, prefetch on):
   a clean fit with exact launches (12 K1, K2, K3 a step); an anomaly
   rollback (``nan_loss@4,nan_loss@5``, detector 2 in a row, a generation
   every 3) and a preempted fit restarted by ``supervise`` both bitwise
   the clean fit (params, momentum, per-step losses), an isolated NaN step
   leaving the state of the step before; the emergency checkpoint's wall;
   the preempted run's goodput ledger (categories, recovery seconds,
   goodput share; residual within 2%, no redone step; the rollback's 2
   redone steps); ``io_error@p=0.3:seed=7`` bitwise with its retries
   counted; ``restore`` falling back past a torn and a truncated
   generation; prefetch off bitwise on, with each one's step p50 and a
   detector-on fit's; a profiler window naming K1-K3 and the
   ``train/step`` ranges, the tracer's export with the ``train/*`` spans and the rollback event; the
   LM workload as ``python -m`` at TRAIN's width cut to 2 layers (flash,
   bf16; started with the phase, beside its fits) exiting 75 on
   ``preempt@3`` with a generation at 3, then resuming from it to exit 0,
   and at its defaults (also beside) exiting 70
   with the stacks when an injected data stall outlasts
   ``--step_deadline_s``;
26. ``phase_data_parallel`` (after 25): data-parallel training, one process a
   device, in three parts.  (a) NCCL at a world of 1: the LM workload at
   TRAIN's full width (bf16, flash) with ``distributed=True`` for 3 steps,
   once through the ``comm_overlap`` step (bf16 wire with error feedback,
   weight-update sharding, ``accum_steps=2``, no clip) and once through
   the implicit step, exact K1-K3 launch counts each, per-step losses
   within ``DP_LOSS_RTOL`` of each other, no operation staged through the
   host (NCCL runs reduce-scatter, all-to-all and all-gather itself);
   (b) a world of 2 over gloo, both processes on the one card (spawned,
   each with its own time limit): the same LM cut to 4 layers
   (``DP_LAYERS``) on the same 3 global batches of 8 rows, 4 a rank,
   through the ``comm_overlap`` step with the
   f32 wire and then the bf16 wire with weight-update sharding, each held
   against a one-process implicit fit of those batches on the card
   (per-step losses within ``DP_LOSS_RTOL``, params after the last step
   within ``DP_PARAM_TOL`` of the summed learning rates); every rank's
   K1, K2 and K3 counters count 4 launches a step each at B = 4, and the
   plain versions 0; the operations gloo staged through host memory are
   printed; the three kernels are then held and timed at that per-rank
   shape (B=4, H=12, S=2048, D=64, causal, bf16); (c) ``workloads.benchmark.main(distributed=True)``, the
   reference's flagship (ResNet-50, batch 64 a rank, 224 px, bf16), over
   the same 2 gloo ranks after (b) (one spawn for both) with a short
   geometry, img/s per rank and in total ("two ranks share one card: not
   a scaling figure").  It prints the wall time of (a) and of (b) with
   (c), the wire bytes of ``wire_bytes()`` and the peak memory of each
   rank.
27. ``phase_tensor_parallel`` (after 26): tensor-parallel serving.  The
   serve model (SERVE's full width, seed 0, the tied 4x head) through
   ``tensor_parallel_engine(tp=2)`` over 2 gloo ranks sharing the card
   (spawned, ``cuda:0`` passed explicitly, their own time limit), each
   rank holding its slice of the weights and its 6 of the 12 heads of the
   cache, in five runs of 8 new tokens a request (``TP_NEW_TOKENS``, a
   quarter of the serving cells') at the first 3 of the 12 layers of the same
   weights (``tp_layers``; the script's depth cut) held against the same
   run on the one-process
   engine (tp=1, first, in this process): (a) dense f32, the dense
   serving cell's requests; (b) paged f32 on the paged cell's
   shared-prefix requests (page 64, chunk 64, 72 pages); (c) paged with
   an int8 cache; (d) dense with bf16 weights and cache; (e) dense with
   int8 weights.  Every run, with every counter zeroed just before and
   read just after: both ranks' streams are equal, and equal tp=1's in
   (a), (b), (c) and (e); in (d) bf16 greedy meets exact ties (tp=1's own
   top-2 logits 0 or one bf16 ulp apart, where another order of the
   row-parallel sums may take the other token), so there the tp=2
   engine's teacher-forced logits over tp=1's streams are held to tp=1's
   by ``hold_bf16`` against the f32 logits of the same weights, and a
   stream may leave tp=1's only at a token whose tp=1 logit is within
   that limit of the row's top; the paged runs'
   prefix hit rate equals tp=1's and is above 0; each rank launches K4
   L times (the run's layers) a decode step and a chunk, each over 6
   heads, K1 L times a dense prefill over 6 heads, no plain version; each
   rank runs exactly 2 L + 1 all-reduces and one all-gather a forward
   pass (2 L all-reduces with MAX more under int8 weights), and gloo
   stages the
   all-gather through the host.  It prints the per-rank param and KV
   bytes against tp=1, the per-rank decode step p50, TTFT p50, tokens/s,
   peak memory, and where a dense f32 decode step's time goes on a rank
   (host wall, the host time inside the collectives' calls, and the
   kernels' device time in a profiled window).  Then, alone on the
   card: K4(d), K4 over a rank's 6 heads of the dense [8, 12, 576, 12,
   64] cache (f32, bf16 and int8 pages), held against its plain version
   and bitwise against the all-heads launch's rows, timed beside SDPA over
   the local heads and its bound; and K1-K3 through
   ``make_flash_attention(mesh)`` over a rank's 6 heads at the prefill
   shape (B=1, S=512, f32 and bf16), held against the plain versions and
   the all-heads kernels' rows (output and gradients), and timed.

28. ``phase_serve_robust`` (after 27): robust serving at SERVE's full width
   (seed 0, the tied 4x head; page 64, chunk 64), each run with every
   counter zeroed just before and read just after and held to exact
   launches (K4 12 a chunk and a decode step, K1 12 a dense prefill, the
   plain versions 0).  (a) Overload: the reference's three tenants
   (premium 1.5 rps, standard 1.0, best_effort 1.0, Poisson, prompts of
   2..16 tokens, 16 new) for 8 s with the burst fault
   ``burst@1:tenant=best_effort:rps=40:secs=4:at=0.5``, replayed in real
   time through ``poll_source`` into one paged engine of 8 slots and 7
   pages (2.5 of every 3 slots' worst case) with ``shed_policy="shed"``,
   ``preempt_budget=2`` and an explicit ledger capacity of the engine's
   committed bytes plus 3 requests' pages, so the forecast gates
   admission; it prints per-class TTFT and TPOT p50/p99, sheds,
   preemptions and the retry hints, and holds that only best_effort is
   shed, every request ends once, every page returns, and each preempted
   stream equals the same request served alone (or leaves it at a tie
   within ``LOGIT_RTOL``, counted).  (b) The host tier: the reference's
   TIER recipe at page 64 (24 sessions over 4-page prefixes, pages for two
   sequences, 100 host pages, 3 rounds after a seed round), f32 and int8,
   tiered and untiered: tiered tokens equal untiered (and, in f32, the
   dense engine's) bitwise, spill-then-restore runs equal never-spilled
   runs, the tier raises the hit rate; the per-page D2H and H2D times and
   GB/s by CUDA events beside the PCIe link nvidia-smi reports.  (c) Live
   reload: ``request_reload`` at the first decode step, dense and paged;
   the requests admitted after the barrier equal a fresh engine of the new
   weights, those before it the old weights'.  (d) Faults on a paged
   engine: ``decode_nan`` fails only its victim and leaves no NaN in the
   pool, ``decode_stall`` fires the watchdog (``watchdog_on_timeout``)
   that stays quiet without it, ``reject_admit@1`` sheds one request, a
   raised decode exception requeues the batch once, ``should_drain``
   returns the queue ``preempted``.  (e) int8-KV fidelity: the
   reference's teacher-forced per-position greedy agreement against f32
   through ``capture_logits`` over the paged cell's 16 prompts, beside its
   0.99 gate.  (f) The process ledger's reconciled frame after (a) and (b)
   (owners, committed bytes, the host owner outside the forecast, the
   residual against ``torch.cuda.memory_allocated()`` beside 5%).  The
   kernels line's K4 and K1 rows add each run's launches as
   ``serve_robust <run>``.

29. ``phase_fleet``: the supervised serving fleet (``serve/fleet.py``)
   at SERVE's full width: the seed-0 weights (the tied 4x head) saved once
   with the port's ``Checkpointer`` and served through ``checkpoint_dir``
   by replica workers the router spawns, two sharing the card (paged f32,
   page 64, chunk 64, 8 slots each), the dense cell's 16 requests of
   64..512 tokens, greedy, 16 new tokens each; the router builds the
   kernels before it spawns and the workers only load them.  (a) A clean
   fleet: tokens equal the one-process paged engine's request for request;
   ``reload`` to a second checkpoint (seed 1) acked by both replicas, then
   8 requests on the same processes equal a fresh engine of the new
   weights; a drain ends both workers cleanly.  (b) The reference's fault
   matrix ``replica_death@3,decode_nan@5,decode_stall@8:secs=0.2`` with
   ``max_restarts=1``, ``max_redeliveries=2`` and tracing on, both
   replicas ready before the requests: one death, one restart (waited for
   until ready), no lost request, exactly one ``"error"`` finish and it
   non-finite, every survivor's tokens equal (a)'s; the merged fleet
   trace has a requeued request whose failover chain passes
   ``check_failover_chain``.  (c) One dense replica built through
   ``data_parallel_engine`` (flash prefill: K1) equals the one-process
   dense engine on 8 requests.  (b)'s and (c)'s workers spawn while (a)
   reloads and drains, and (c) serves while (b)'s restart comes up; once
   every worker has exited, the card's free memory
   (``torch.cuda.mem_get_info``) is within 1 GB of where it was before
   the fleets.  In every run each worker that exited
   cleanly never loaded jax and its shipped launch counters are exact: K4
   12 a decode step and 12 a prefill chunk (its exit report's counts), K1
   12 a request on the dense replica and 0 on the paged ones.  (d) It prints each worker's
   spawn-to-ready seconds (the restart's too), the time to the first
   streamed token, the merged TTFT and TPOT p50/p99 from the bucket-merged
   worker histograms, the per-replica HBM peak from the shipped ledger
   gauges, and the launches per worker; the kernels line's K4 and K1 rows
   add each worker's launches as ``fleet <run> replicaK`` (a restart:
   ``fleet <run> replicaK restartN``).

30. ``phase_imagenet``: the ImageNet data plane and the
   ``imagenet`` workload at the reference's flagship settings (ResNet-50,
   224 px, batch 64, bf16, 1001 classes), with no TensorFlow.  (a) Seeded
   ILSVRC-size JPEG shards (``data.bench_data``: train 1024 in 8 shards,
   validation 256 in 2; written beside the build); the C record reader (``data/csrc/ddlt_records.c``)
   must build with the host compiler; the C JPEG decoder needs libjpeg and
   may not build, and then PIL decodes; both are printed.  (b) Each
   pipeline alone on the host (the tf recipe, native, raw; 8 batches of
   64): img/s beside the host's cores.  (c) ``train.benchmark``'s
   ``run_data_benchmark`` over the native and raw pipelines (prefetched
   to the card; raw crosses as uint8 and ``uint8_normalizer`` runs on the
   card) against ``run_benchmark`` on one resident batch of the same step,
   3 windows of 5: fed img/s, resident img/s, their ratio; the raw batch
   normalized on the card is within 0.5 + 1e-4 of the native float batch
   of the same records.  (d) ``python -m
   distributeddeeplearning_tpu_torch.workloads.imagenet
   --data_format=tfrecords`` (the tf recipe), 4 steps and eval over the 256
   validation images, in a fresh process started beside the build:
   finite loss, eval metrics, no import of jax or tensorflow in its ``-X
   importtime`` log.  (e) A raw
   fit stopped at step 2 (checkpoint) and resumed to step 4 draws the
   unstopped stream's batches 2 and 3.  No kernel of the port runs here
   (cuDNN's convolutions), so the kernels line gains no row.

31. ``phase_model_parallel_train``: tensor-parallel and FSDP
   training of the LM over four gloo ranks sharing the card (spawned,
   ``cuda:0`` each, one time limit).  (a) ``workloads.transformer.main(
   tensor=2, fsdp=2, attention="flash", compute_dtype="bfloat16")`` at
   TRAIN's full width (d 768, 12 heads, ff 3072, vocab 32768, seq 2048)
   cut to 4 layers (``MP_WIDTH``), 2 rows a data shard, 3 steps and one
   eval pass of 2 batches, checkpointed, then resumed from that
   generation for one more step.  Checks on every rank: the losses finite
   and bitwise rank 0's; the replicated leaves (``pos``, ``ln1``, ``ln2``)
   bitwise rank 0's after every step; bf16 K1, K2 and K3 launched exactly
   4 times a step each (a layer's; K1 also 4 an eval batch), every launch
   at B=2 H=6 (a rank's rows and
   heads), no plain version and no f32 launch; each step's collectives
   exactly ``MP_STEP_COLLECTIVES``, written down before the first run (4 L
   + 4 all-reduces, 2 all-gathers, 2 reduce-scatters); the parameter and
   optimizer bytes the sum of the rank's shards of MP_WIDTH's global shapes;
   the restored parameters and moments bitwise the saved ones.  It prints
   the step p50 a rank (CUDA events), the host seconds inside collectives,
   what gloo staged and the peak memory a rank, beside a one-process run
   of the same global batch (B=4) in this process.  (b) Parity: the LM at
   full width cut to 2 layers, seq 512, f32, flash, through
   ``build_train_step`` with the LM's rules on ``tensor=2 x fsdp=2``,
   ``fsdp=4`` and ``data=2 x tensor=2``, 2 steps over the same 4-row
   global batches, AdamW's clip at half the first step's unclipped norm,
   each held to one process on the card (the tolerances and their reasons
   in the phase's docstring).  Then the bf16 K1-K3 held and timed at a
   rank's shape (B=2, H=6, S=2048, D=64, causal).

32. ``phase_bert_model_parallel`` (last): BERT and MoE BERT over the
   fsdp, tensor and expert axes on four gloo ranks sharing the card (one
   spawn).  (a) ``workloads.bert.main(tensor=2, fsdp=2)`` at bert-base's
   defaults (12 layers, d 768, 12 heads, ff 3072, vocab 30522, bf16, 8
   rows a data shard, seq 128, dropout 0.1, flash), 3 steps, one eval
   pass of 2 batches, checkpointed, then resumed for one more step.  On
   every rank: the bf16 bias K1, K2, K3 launched exactly 12 times a step
   (K1 also 12 an eval batch), every launch at B=8 H=6, no plain version;
   each step's collectives exactly ``BMP_STEP_COLLECTIVES`` (derived
   beside it); the losses bitwise rank 0's; the leaves a data shard's
   ranks hold alike (``BMP_REPLICATED``) bitwise equal across them after
   every step, dropout on; parameter and optimizer bytes the sum of the
   rank's shards; the restore bitwise.  It prints the step p50 a rank, the
   share of the host wall inside collectives, the bytes and the peak
   memory a rank beside one process at the same global batch (B=16).  (b)
   MoE bert-base (8 experts, top-2, capacity 1.25, every second layer) at
   ``expert=2 x fsdp=2``, 3 steps and eval: each rank holds 4 experts'
   ``w_in`` and ``w_out``, each step's collectives exactly
   ``BMP_MOE_COLLECTIVES`` (the combine's all-reduces over expert among
   them), the dropped share of token-slots and the load-balance term
   printed.  (c) f32 parity at bert-base's width cut to 2 layers, seq 128,
   4 rows, 2 steps: BERT on ``tensor=2 x fsdp=2``, ``fsdp=4`` and
   ``data=2 x tensor=2``, MoE BERT on ``data=2 x expert=2`` (the global
   batch's routing) and ``expert=2 x tensor=2``, each against one process
   on the card, expert choices compared first (tolerances in the phase's
   docstring).  (d) The bf16 bias K1-K3 at a tensor rank's shape (B=8,
   H=6 of 12, S=128, D=64, BERT's mask): held against their plain
   versions, bitwise the all-heads launch's rows, timed beside SDPA with
   the bool mask and its backward.
33. ``phase_obs_attrib`` (after 13, while phase 6's dense engine lives):
   per-program cost attribution (``obs/attrib.py``) and the profiling
   harness (``obs/profile.py``) at SERVE's full width.  A paged f32 and an
   int8 engine over phase 6's weights and a truncated drafter (K 4, 2
   layers) serve the paged cell's first 4 requests.  (i) ``build_report``
   over the process registry: a row with FLOPs for every program of the
   reference's ``self_check`` set and the int8 engine's, no kernel
   launched and the live pool's bits unchanged by the collection, the
   owners' card bytes within 1% of ``memory_allocated()`` (cuBLAS's
   workspaces freed first) and the residual under its limit; the dense
   decode row's FLOPs equal to the analytic count for 8 slots exactly.
   (ii) the tracked wrapper's cost a decode call, against 1% of the step
   or 20 us: a no-op tracked program's host time a call (gated), and
   ``engine.decode`` with the tracked program and with its bare callable,
   A B B A call by call in 200 quads, the mean difference with its 95%
   interval (fails if the interval lies above the limit; on the card's
   shared host it is wider than the limit, and the log says
   "unresolved").  (iii) ``decode_phase_breakdown`` over the full-width pools (8
   slots of 536 tokens, position 574), f32, int8 and with the drafter:
   K4 launched 12 times a call of the attention phase and of the decode
   step (int8: every launch int8; the drafter's runs add its drafts and
   verify passes; each part's counts read when it starts and ends),
   ``attention_kernel + mlp_other == decode_step_ms``,
   and ``attribute_regression`` names the phase int8 decode's extra time
   lands in.  (iv) 2 requests (4 new tokens) on the f32 engine inside
   ``profile_and_merge``: aligned on a shared span name, every kernel
   inside the host's ``profile/window`` span (10 ms slack), device events
   in the digest, ``flash_decode`` and ``gemm`` in ``device_analysis``,
   whose device total is within 1% of ``key_averages()``.  (v), inside
   phase 10 (f32): the ``train.step.implicit`` row of the step phase 10
   profiles equals ``utils.hardware.step_flops`` plus half the attention
   forward (the row counts the whole step; the plain backward recomputes
   the scores) exactly.

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
the card's HBM rate and the flops over its f32 peak on the CUDA cores
(what the f32 decode kernel uses), for the f32 forward and backward over
a third of its dense TF32 peak (split TF32; their rows give the f32
bound beside, as ``fma_bound_ms``) or, for the bf16 kernels, over its
dense bf16 peak; every rate is the card's row of the port's table,
``utils/hardware.PEAKS``.  ``library_ms`` times
one ``scaled_dot_product_attention`` call on the same inputs (for K2/K3,
``torch.autograd.grad`` through it, graph built once; for K4(b), on the
history gathered beforehand, since it cannot follow block tables), a
yardstick the port never calls; K4(c) has none (no single PyTorch call
takes int8 K/V).  The int8 bound counts 2*(hd + 4) bytes per visible
position and head.  ``launches`` is the count in the path that runs the
kernel: training for K1, K2, K3; dense serving for K4(a); the f32 paged
run's chunks for K4(b), the int8 paged run for K4(c) and the four
speculative runs for the verify row.  Phase 33 adds to ``launches_by_path``
its decode phase breakdowns' K4 launches, each part's read from the
counters when it starts and ends (``obs_breakdown_attention_*``,
``obs_breakdown_decode_steps_*``: f32 and with the drafter on the K4(a)
row, int8 on K4(c)'s; the drafter run's spec steps add
``obs_breakdown_spec_drafts_f32_spec`` to K4(a) and
``obs_breakdown_spec_verify_f32_spec`` to the verify row) and its
profiled window's (``obs_profiled_window``, K4(a) and K4(b)).  The verify row's bound counts each
(slot, head)'s visible history once for all K+1 queries.

The six bias rows (``flash_attention_fwd_bias``, ``..._bwd_dq_bias``,
``..._bwd_dkv_bias``, each in f32 and ``_bf16``) take their launches from
``phase_bert``'s flash runs at dropout 0 (``bert_flash``: seq 128 in the
row's dtype; ``bert_flash_seq512`` beside it for bf16), and their bound
counts the (query, key) pairs the run's mask leaves visible.  The bf16
ones carry ``model_parallel``: phase 32's entry at a tensor rank's shape
(B=8, H=6 of 12, S 128), with each rank's launches in (a), its resume and
(b) (``bert_mp_train_rank{r}``, ``bert_mp_resume_rank{r}``,
``moe_mp_train_rank{r}``); the f32 ones' ``launches_by_path`` add (c)'s
parity runs (``bert_mp_parity_<mesh>_rank{r}``).  The same entry also
stands as three rows of its own, ``flash_attention_{fwd,bwd_dq,bwd_dkv}_
local_heads_bias_bf16``, whose ``launches`` are rank 0's in (a).

The bf16 K1, K2 and K3 rows carry ``vit``: their entry at ViT-B/16's
attention shape (phase 22), with the launches of one ViT train step; their
``launches_by_path`` adds ``vit_train_step``, ``vit_fit`` (phase 23's
uninterrupted fit of 6 steps) and ``vit_resilience_fit`` (phase 25's
clean fit, through the prefetching ``Trainer``).

The bf16 K1, K2 and K3 rows also carry ``data_parallel``: their entry at
the per-rank shape of phase 26(b) (B=4, S 2048, causal) with the launches
a rank a step; their ``launches_by_path`` adds each phase-26 run's counts
(``dp_nccl_*`` at a world of 1, ``dp_gloo_rank{r}_*`` each rank's).

The ``flash_decode_tp`` row is K4(d): its entry is phase 27's, at a
rank's shape (6 heads, f32 pages; the bf16 and int8 times beside), and
its launches each rank's on the five tensor-parallel runs.  The f32 and
bf16 K1, K2 and K3 rows carry ``tensor_parallel``: phase 27's entry over a
rank's heads, with each rank's launches on the tensor-parallel runs that
run the kernel (K1 on the dense runs' prefills; K2 and K3 on none: serving
runs no backward).  The bf16 K1, K2 and K3 rows also carry
``model_parallel``: phase 31's entry at a rank's training shape (B=2, H=6
of 12, S 2048), with each rank's launches in (a) and its resume
(``mp_train_rank{r}``, ``mp_resume_rank{r}``); the f32 rows'
``launches_by_path`` add (b)'s parity runs (``mp_parity_<mesh>_rank{r}``).

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

import hashlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from typing import Optional

# the card's peak rates, set from the port's table (utils/hardware.PEAKS)
# by set_peaks() before any phase: HBM bytes/s, f32 on the CUDA cores,
# dense bf16 and TF32 on the tensor cores, and the f32 K1-K3's route,
# split TF32 (three TF32 products for each product)
HBM_BYTES_PER_S = F32_FLOPS_PER_S = BF16_FLOPS_PER_S = None
TF32_FLOPS_PER_S = TF32X3_FLOPS_PER_S = None


def set_peaks(torch, name=None) -> None:
    """The peak rates of card ``name`` (default: this process's card) from
    ``utils/hardware.PEAKS``; raises for a card the table does not know
    (no bound or mfu without its peaks)."""
    global HBM_BYTES_PER_S, F32_FLOPS_PER_S, BF16_FLOPS_PER_S
    global TF32_FLOPS_PER_S, TF32X3_FLOPS_PER_S
    from distributeddeeplearning_tpu_torch.utils import hardware

    name = name or torch.cuda.get_device_name(0)
    peaks = hardware.PEAKS.get(name)
    if peaks is None:
        raise RuntimeError(f"no peak rates for {name!r} in utils/hardware.PEAKS")
    HBM_BYTES_PER_S = peaks["hbm_gbps"] * 1e9
    F32_FLOPS_PER_S = peaks["f32_flops"]
    BF16_FLOPS_PER_S = peaks["bf16_flops"]
    TF32_FLOPS_PER_S = peaks["tf32_flops"]
    TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3


def tflops(rate: float) -> str:
    return f"{rate / 1e12:.1f} TFLOP/s"

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


def bound_ms(nbytes: float, flops: float, flops_per_s: Optional[float] = None):
    """(the least ms, what bounds it): bytes over the HBM rate, or flops
    over ``flops_per_s`` (default the f32 CUDA-core peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (flops_per_s or F32_FLOPS_PER_S) * 1e3
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


def profile_share(torch, fn, steps, trace_path=None):
    """(host wall ms per step, CUDA kernel ms per step, top kernels, CUDA-event
    span ms per step) from torch.profiler over ``steps`` calls of ``fn``;
    kernel ms is None when the profiler records no device time.  The span
    covers the same calls on the device (first launch to last, idle gaps
    included).  ``trace_path``: the same profile exported there as a
    chrome trace."""
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
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    return wall, (total if kernels else None), top, start.elapsed_time(end) / steps


#: serve_params' host draws by seed: a process draws each weight set once
#: (about 2 s of CPU normals) and every call copies it to the card anew
_SERVE_HOST = {}


def serve_params(torch, seed=0):
    """The serving cells' f32 weights: the full-width LM of ``SERVE`` from
    ``seed`` (0 unless another weight set is wanted) with a tied 4x-gain
    embedding head: top-2 logit gaps dwarf f32 reassociation noise, so
    token equality measures the kernels, not tie-breaking.  Each call
    returns a fresh copy on the card."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        init_params,
    )
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    if seed not in _SERVE_HOST:
        _SERVE_HOST[seed] = init_params(torch.Generator().manual_seed(seed),
                                        max_len=MAX_SEQ, device="cpu", **SERVE)
    params = tree_map(lambda t: t.to("cuda"), _SERVE_HOST[seed])
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


SPEC_INT8_REQUESTS = 8  # the int8 drafter's run: the paged cell's first 8


def phase_serve_spec(torch, np, fa, fd, card, params, dense_engine, dense, paged):
    """Speculative greedy serving at full width: the paged f32 engine (page
    64, chunk 64, 8 slots) with the truncated (M = 2), int8-weight (its
    first SPEC_INT8_REQUESTS requests) and forced-rejection (its first 4)
    drafters on the paged cell's traffic, and the dense
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
    first4, first8 = paged["requests"][:4], paged["requests"][:SPEC_INT8_REQUESTS]
    seen = {t for r in first4 for t in paged["f32_tokens"][r.uid]}
    garbage = min(set(range(vocab)) - seen)
    runs = (  # name, layout, drafter, draft depth, requests, baseline tokens
        ("spec_truncated", "paged", lambda: TruncatedDrafter(DRAFT_LAYERS),
         DRAFT_LAYERS, paged["requests"], paged["f32_tokens"]),
        ("spec_int8", "paged", lambda: "int8", layers, first8,
         {r.uid: paged["f32_tokens"][r.uid] for r in first8}),
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
        if name == "spec_truncated" and chunks != paged["f32_chunks"]:
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
    peak, peak_name = ((BF16_FLOPS_PER_S, f"{tflops(BF16_FLOPS_PER_S)}, the dense bf16 peak")
                       if bf16 else (F32_FLOPS_PER_S, f"{tflops(F32_FLOPS_PER_S)} f32"))
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
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "train.trace.json")
        wall, busy, top, event_ms = profile_share(torch, lambda: step(state, batch), 2,
                                                  trace_path)
        share = "not measured" if busy is None else f"{busy:.3f} ms ({busy / wall:.1%} busy)"
        log(f"[profile] train step (B=8, S=2048, {dtype}, flash): host wall "
            f"{wall:.3f} ms, kernel time {share}; {trust_note(busy, event_ms)} on {card}")
        _roofline_check(trace_path, busy, f"{tag} step", b, card)
    gemms = f"{'bf16' if bf16 else 'f32'} GEMMs (cuBLAS/CUTLASS)"
    bsfx = sfx or "_f32"  # the f32 kernels are named so
    kernels = {f"K1 flash_fwd{bsfx}_kernel": f"flash_fwd{bsfx}_kernel",
               f"K2 flash_bwd_dq{bsfx}_kernel": f"flash_bwd_dq{bsfx}_kernel",
               f"K3 flash_bwd_dkv{bsfx}_kernel": f"flash_bwd_dkv{bsfx}_kernel"}
    log_groups(top, busy, gemms, kernels)
    if not bf16:
        _obs_train_step(torch, card, state, batch)  # `step` alive: its row
    del state, step
    torch.cuda.empty_cache()
    return launches, losses


#: the port's roofline reader against the profiler's own sums: its
#: device time a step within this share of key_averages()'s kernel time
#: (both read the same profile; the reader rounds ms to 2 decimals)
ROOFLINE_RTOL = 0.01


def _roofline_check(trace_path, kernel_ms, what, batch, card):
    """The port's ``utils.roofline.analyze_trace`` on a torch.profiler
    chrome trace of 2 steps: its device time a step against the
    ``key_averages()`` kernel time of the same profile (``kernel_ms``),
    within ROOFLINE_RTOL; its categories logged."""
    from distributeddeeplearning_tpu_torch.utils.roofline import analyze_trace

    r = analyze_trace(trace_path, steps=2, global_batch=batch)
    got = r["device_ms_per_step"]
    if kernel_ms is None or abs(got - kernel_ms) > ROOFLINE_RTOL * kernel_ms:
        raise AssertionError(f"[roofline] {what}: analyze_trace {got} ms a step, "
                             f"key_averages {kernel_ms} ms")
    cats = {k: (v["time_ms_per_step"], v["time_fraction"])
            for k, v in r["categories"].items()}
    log(f"[roofline] {what}: utils.roofline.analyze_trace over the exported trace: "
        f"device {got} ms a step against key_averages' {kernel_ms:.3f} "
        f"({abs(got - kernel_ms) / kernel_ms:.2e} apart, tolerance {ROOFLINE_RTOL:g}); "
        f"{r['device_lanes_in_trace']} device lane(s), busiest share "
        f"{r['busiest_lane_share']}; categories (ms a step, share) {cats}; HBM GB a "
        f"step {r['hbm_gb_per_step']} (kernels carry no byte counts), peaks "
        f"{r['peak_tflops']} TFLOP/s, {r['peak_hbm_gbps']} GB/s on {card}")


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


# ---- phase 33: per-program cost attribution, the decode phase breakdown
# and the merged serving timeline (obs/attrib.py, obs/profile.py) ----

OBS_REQUESTS, OBS_NEW_TOKENS = 4, 8  # the paged cell's first 4 requests
#: the profiled window's: its trace (host ops and kernels) is written,
#: merged and read back, so it is kept to a few steps
OBS_WINDOW_REQUESTS, OBS_WINDOW_TOKENS = 2, 4
OBS_DECODE_QUADS = 200  # (ii)'s A B B A quads of engine.decode calls
#: the tracked wrapper's cost a decode call: at most this share of the
#: step, or this many microseconds, whichever is larger
OBS_WRAPPER_SHARE, OBS_WRAPPER_US = 0.01, 20.0
OBS_ITERS, OBS_WARMUP = 10, 2  # decode_phase_breakdown's (the reference's)
#: the reference's owner-totals match tolerance, % of the live bytes
OBS_MATCH_PCT = 1.0
#: device events may fall this far outside the host's profile/window span:
#: the profiler maps the card's clock onto the host's, and that mapping
#: was off by more than 1 ms in a whole-script run
OBS_WINDOW_SLACK_US = 10000.0
#: phase 33's expected programs: the reference's self_check set, plus the
#: int8 paged engine's
OBS_PROGRAMS = ("serve.dense.float32.prefill", "serve.dense.float32.decode",
                "serve.paged.float32.prefill_chunk", "serve.paged.float32.decode",
                "spec.paged.verify", "serve.paged.int8.prefill_chunk",
                "serve.paged.int8.decode")


def _obs_decode_flops(slots):
    """The dense decode program's matrix-product FLOPs at SERVE's width: 2 x
    the products' weights (qkv, proj, the two FF matrices a layer, the
    head) a slot, plus QK and PV over the whole MAX_SEQ window a layer."""
    d, ff, v, h, layers = (SERVE[k] for k in ("d_model", "d_ff", "vocab_size",
                                              "num_heads", "num_layers"))
    weights = layers * (4 * d * d + 2 * d * ff) + d * v
    return slots * (2 * weights + layers * 2 * 2 * h * MAX_SEQ * (d // h))


def _obs_decode_quads(np, engine, arms, quads):
    """``quads`` A B B A quads of ``engine.decode`` calls (each ends in its
    own token readback) at mid-window in every slot, the engine's decode
    program taken from ``arms`` call by call, after 5 untimed quads.
    Returns each quad's wall difference A minus B (the mean of each arm's
    two calls: drift in the host's pace falls on both arms of a quad
    alike) and B's walls."""
    tokens, pos = np.ones(SLOTS, np.int32), np.full(SLOTS, MAX_SEQ // 2, np.int32)
    a, b = arms.values()
    walls = np.empty((5 + quads, 4))
    for q in range(5 + quads):
        for i, prog in enumerate((a, b, b, a)):
            engine._decode_prog = prog
            t0 = time.perf_counter()
            engine.decode(tokens, pos)
            walls[q, i] = time.perf_counter() - t0
    walls = walls[5:]
    return (walls[:, 0] + walls[:, 3] - walls[:, 1] - walls[:, 2]) / 2, walls[:, 1:3].ravel()


def _obs_bits(torch, cache):
    """A digest of a cache's bits (int64 sums of each leaf's words)."""
    return {k: int(v.view(torch.int32).sum(dtype=torch.int64)) for k, v in cache.items()}


def _obs_report(torch, np, fa, fd, card, dense_engine, engines):
    """(i): the process registry's report at full width."""
    import gc

    from distributeddeeplearning_tpu_torch.obs import attrib

    f32, int8 = engines
    measured = {"serve.dense.float32.decode": attrib._time_decode(dense_engine),
                "serve.paged.float32.decode": attrib._time_decode(f32),
                "serve.paged.int8.decode": attrib._time_decode(int8)}
    peak_tflops, peak_gbps, source = attrib.reference_peaks()
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:  # cuBLAS's workspaces: the allocator's, no owner's
        clear()
    bits = _obs_bits(torch, f32.cache)
    _zero_counters(fa, fd)
    t0 = time.perf_counter()
    report = attrib.build_report(memory=True, measured_step_s=measured,
                                 peak_tflops=peak_tflops, peak_hbm_gbps=peak_gbps,
                                 match_tolerance_pct=OBS_MATCH_PCT)
    collect_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = {**_fa_counts(fa), **_fd_counts(fd)}
    if any(counts.values()) or _obs_bits(torch, f32.cache) != bits:
        raise AssertionError(f"[attrib] collect launched kernels {counts} or wrote "
                             "the live cache")
    programs = report["programs"]
    for name, row in programs.items():
        roof = row.get("roofline", {})
        log(f"[attrib] {name}: {row['signatures']} signature(s), {row['flops']:.6g} "
            f"FLOP, {row['bytes_accessed']:.6g} B accessed (unfused), arguments "
            f"{row['argument_bytes']} B, outputs {row['output_bytes']} B, in place "
            f"{row['alias_bytes']} B, temp {row['temp_bytes']} B"
            + (f"; measured {roof['measured_s'] * 1e3:.3f} ms: "
               f"{roof['achieved_tflops']} TFLOP/s, {roof['achieved_gbps']} GB/s, "
               f"{roof.get('pct_of_compute_roofline')} of the compute and "
               f"{roof.get('pct_of_bandwidth_roofline')} of the bandwidth roofline, "
               f"{roof.get('bound')}" if roof else "") + f" on {card}")
    ledger = report["ledger"]
    log(f"[attrib] collect + report {collect_s:.2f} s (no launch, live cache "
        f"unchanged); peaks: {source}; ledger owners "
        f"{ {k: v['bytes'] for k, v in ledger['owners'].items()} }, live "
        f"{ledger['live_bytes']} B, owners' match {report['owner_match_pct']}% "
        f"(tolerance {OBS_MATCH_PCT}%), unaccounted {report['unaccounted_hbm_pct']}% "
        f"(limit {ledger['residual_limit_pct']}%); gates {report['gates']} on {card}")
    missing = sorted(set(OBS_PROGRAMS) - set(programs))
    if missing or not all(report["gates"].values()):
        raise AssertionError(f"[attrib] missing {missing}, gates {report['gates']}")
    got, want = programs["serve.dense.float32.decode"]["flops"], _obs_decode_flops(SLOTS)
    log(f"[attrib] serve.dense.float32.decode: {got:.0f} FLOP against the analytic "
        f"{want} for {SLOTS} slots (exact: both count the matrix products over "
        f"the {MAX_SEQ}-position window)")
    if got != want:
        raise AssertionError(f"[attrib] dense decode FLOPs {got} != {want}")
    return report


def _obs_wrapper_cost(torch, np, card, engine):
    """(ii): engine.decode with the tracked program and with its bare
    callable, A B B A call by call, on the same engine, and the wrapper
    alone on the host."""
    from distributeddeeplearning_tpu_torch.obs import attrib

    tracked = engine._decode_prog
    try:
        diffs, bare = _obs_decode_quads(np, engine, {"tracked": tracked,
                                                     "bare": tracked._fn},
                                        OBS_DECODE_QUADS)
    finally:
        engine._decode_prog = tracked
    step = float(np.median(bare))
    limit = max(OBS_WRAPPER_SHARE * step, OBS_WRAPPER_US * 1e-6)
    diff = float(diffs.mean())
    half = 1.96 * float(diffs.std(ddof=1)) / np.sqrt(diffs.size)
    verdict = ("under the limit at 95%" if diff + half <= limit else
               "above the limit at 95%" if diff - half > limit else
               "unresolved: the interval is wider than the limit")
    # the wrapper alone on the host: its key and one set lookup a call
    params, cache = engine.params, engine.cache
    tok = torch.ones(SLOTS, dtype=torch.int32, device=engine.device)
    kw = dict(num_heads=engine.num_heads, kernel=engine.decode_kernel, mesh=None)
    noop = attrib.TrackedProgram("noop", lambda *a, **k: None)
    noop(params, tok, cache, tok, **kw)  # records its one signature
    t0 = time.perf_counter()
    for _ in range(10000):
        noop(params, tok, cache, tok, **kw)
    alone_us = (time.perf_counter() - t0) / 10000 * 1e6
    log(f"[attrib] wrapper cost: alone on the host {alone_us:.3f} us a call (a no-op "
        f"program, the decode arguments); end to end, {OBS_DECODE_QUADS} A B B A quads "
        f"of decode calls, tracked minus bare {diff * 1e6:.1f} +- {half * 1e6:.1f} us "
        f"(95%), {verdict}; bare p50 {step * 1e3:.4f} ms; limit {limit * 1e6:.2f} us "
        f"({OBS_WRAPPER_SHARE:.0%} of the step or {OBS_WRAPPER_US:g} us) on {card}")
    if alone_us > limit * 1e6 or diff - half > limit:
        raise AssertionError(f"[attrib] the tracked wrapper costs {alone_us:.2f} us "
                             f"alone, {diff * 1e6:.1f} +- {half * 1e6:.1f} us end to end; "
                             f"limit {limit * 1e6:.2f} us")
    return {"diff_us": diff * 1e6, "ci_us": half * 1e6, "step_ms": step * 1e3,
            "alone_us": alone_us}


def _obs_breakdowns(torch, np, fa, fd, card, f32, int8, spec):
    """(iii): the decode phase breakdown over the live full-width pools, f32,
    int8 and with the speculative decoder; returns (the breakdowns, K4
    launches by path)."""
    from distributeddeeplearning_tpu_torch.obs import profile

    layers, n = SERVE["num_layers"], OBS_ITERS + OBS_WARMUP
    history = MAX_SEQ - NEW_TOKENS - 8  # every slot's history all but full
    rng = np.random.default_rng(33)
    for engine in (f32, int8):
        fill_slots(np, engine, rng, history)
    runs, parts = {}, {}
    for name, engine, sd in (("f32", f32, None), ("int8", int8, None),
                             ("f32_spec", f32, spec)):
        _zero_counters(fa, fd)
        torch.cuda.synchronize()
        # the counters (host-side, bumped at each launch) when the decode
        # steps and the spec steps start: the first engine.decode and the
        # first spec step end the part before them
        marks = {}

        def marked(part, fn):
            def first(*args, **kwargs):
                marks.setdefault(part, _fd_counts(fd))
                return fn(*args, **kwargs)
            return first

        engine.decode = marked("decode_steps", engine.decode)
        if sd is not None:
            sd.step = marked("spec_steps", sd.step)
        try:
            out = profile.decode_phase_breakdown(engine, iters=OBS_ITERS,
                                                 warmup=OBS_WARMUP, spec_decoder=sd)
        finally:
            del engine.decode
            if sd is not None:
                del sd.step
        torch.cuda.synchronize()
        flash, end = _fa_counts(fa), _fd_counts(fd)
        bounds = [("attention", {c: 0 for c in end}), ("decode_steps", marks["decode_steps"]),
                  ("spec_steps", marks.get("spec_steps", end)), (None, end)]
        got = {part: {c: hi[c] - lo[c] for c in end}
               for (part, lo), (_, hi) in zip(bounds, bounds[1:])}
        # the attention phase and the decode steps: `layers` launches a
        # call; the spec steps K drafts of DRAFT_LAYERS and one verify of
        # all layers
        one = dict({c: 0 for c in end}, fd_launches=layers * n,
                   launches_int8=layers * n if name == "int8" else 0)
        want = {"attention": one, "decode_steps": one,
                "spec_steps": {c: 0 for c in end}}
        if sd is not None:
            want["spec_steps"].update(
                fd_launches=(SPEC_K * DRAFT_LAYERS + layers) * n,
                launches_multi_query=layers * n, launches_verify=layers * n)
        ph = out["phases_ms"]
        log(f"[breakdown] {name}: {json.dumps(out)} on {card}")
        log(f"[breakdown] {name}: K4 launches by part {got} (expected {want}: "
            f"{layers} x {n} calls in each of the attention phase and the decode "
            f"steps" + (", the spec steps' drafts and verify passes" if sd else "")
            + f"); K1-K3 {flash}")
        if got != want or any(flash.values()):
            raise AssertionError(f"[breakdown] {name}: launches {got}, K1-K3 {flash}; "
                                 f"expected {want}")
        if abs(ph["attention_kernel"] + ph["mlp_other"] - out["decode_step_ms"]) > 2e-3:
            raise AssertionError(f"[breakdown] {name}: attention {ph['attention_kernel']}"
                                 f" + rest {ph['mlp_other']} != {out['decode_step_ms']}")
        if name != "int8" and ph["scale_dequant"] != 0.0:
            raise AssertionError(f"[breakdown] {name}: scale_dequant {ph['scale_dequant']}")
        runs[name] = out
        parts[name] = got
    regression = profile.attribute_regression(runs["f32"], runs["int8"])
    log(f"[breakdown] int8 against f32 pages (attribute_regression): "
        f"{json.dumps(regression)}; hottest phase {regression['hottest_phase']} "
        f"(+{regression['hottest_phase_delta_ms']} ms, "
        f"{regression['hottest_phase_share_of_step_time']:.1%} of the int8 step) "
        f"on {card}; these times are read against each other, not against "
        "phase 6's or 7's p50 (other engines, positions and cache history)")
    for engine in (f32, int8):
        for slot in range(SLOTS):
            engine.release(slot)
    spec_steps = parts["f32_spec"]["spec_steps"]
    launches = {
        "flash_decode": {
            **{f"obs_breakdown_{part}_{run}": parts[run][part]["fd_launches"]
               for run in ("f32", "f32_spec") for part in ("attention", "decode_steps")},
            "obs_breakdown_spec_drafts_f32_spec":
                spec_steps["fd_launches"] - spec_steps["launches_multi_query"]},
        "flash_decode_int8": {f"obs_breakdown_{part}_int8": parts["int8"][part]["launches_int8"]
                              for part in ("attention", "decode_steps")},
        "flash_decode_verify": {"obs_breakdown_spec_verify_f32_spec":
                                spec_steps["launches_verify"]}}
    return runs, regression, launches


def _obs_window(torch, np, fa, fd, card, engine, requests):
    """(iv): a few scheduler steps of the full-width paged engine in
    ``profile_and_merge``: the merged timeline and the roofline table."""
    import tempfile

    from distributeddeeplearning_tpu_torch.obs import profile
    from distributeddeeplearning_tpu_torch.obs.trace import get_tracer
    from distributeddeeplearning_tpu_torch.serve import ContinuousBatchingScheduler

    tracer = get_tracer()
    tracer.clear()
    kept = []
    _zero_counters(fa, fd)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        (_, report), _, merged, path = profile.profile_and_merge(
            lambda: ContinuousBatchingScheduler(
                engine, max_new_tokens=OBS_WINDOW_TOKENS).run(requests),
            trace_dir=tmp, tracer=tracer, keep=kept)
        counts = _fd_counts(fd)
        size = os.path.getsize(path)
        analysis = profile.device_analysis(tmp, steps=1)
    tracer.clear()
    meta = merged["metadata"]
    # the tracer's spans ride the device timeline too (record_function's
    # GPU annotations): they are not kernels
    spans = {e["name"] for e in merged["traceEvents"] if e.get("pid") in meta["host_pids"]}
    kernel_ms = sum(e.self_device_time_total for e in kept[0].key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.key not in spans) / 1e3
    (window,) = [e for e in merged["traceEvents"] if e.get("name") == "profile/window"
                 and e.get("pid") in meta["host_pids"]]
    kernels = [e for e in merged["traceEvents"] if e.get("cat") == "kernel"]
    lo, hi = window["ts"] - OBS_WINDOW_SLACK_US, window["ts"] + window["dur"] + OBS_WINDOW_SLACK_US
    outside = [e for e in kernels if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi)]
    # how far the kernels reach before and after the host span, us
    end = window["ts"] + window["dur"]
    early = window["ts"] - min((e["ts"] for e in kernels), default=window["ts"])
    late = max((e["ts"] + e["dur"] for e in kernels), default=end) - end
    digest = profile.summarize_timeline(merged)
    cats = analysis.get("categories", {})
    device_ms = analysis.get("device_ms_per_step")
    log(f"[timeline] {report.decode_steps} decode steps, "
        f"{counts['launches_multi_query'] // SERVE['num_layers']} chunks profiled: merged {meta['device_trace']}, clock offset "
        f"{meta['clock_offset_us']:.1f} us from a shared span name"
        f"{' (' + meta['clock_alignment'] + ')' if 'clock_alignment' in meta else ''}; "
        f"{len(kernels)} kernels, {len(outside)} outside the host window "
        f"{window['dur'] / 1e3:.3f} ms (slack {OBS_WINDOW_SLACK_US:g} us; the first "
        f"starts {early:.1f} us before it opens, the last ends {late:.1f} us after it "
        f"closes); digest "
        f"{digest['event_counts']}; merged file {size} B; K4 launches {counts} on {card}")
    log(f"[timeline] device_analysis: {device_ms} ms of kernels against "
        f"key_averages' {kernel_ms:.3f} ms (tolerance {ROOFLINE_RTOL:g}); categories "
        f"(ms, share) { {k: (v['time_ms_per_step'], v['time_fraction']) for k, v in cats.items()} }"
        f" on {card}")
    if (meta["device_trace"] != "merged" or "clock_alignment" in meta or outside
            or not digest["event_counts"]["device_events"]
            or not {"flash_decode", "gemm"} <= set(cats) or not kernel_ms
            or abs(device_ms - kernel_ms) > ROOFLINE_RTOL * kernel_ms):
        raise AssertionError("[timeline] the merged serving window failed its checks")
    return {"k4": counts["fd_launches"] - counts["launches_multi_query"],
            "chunks": counts["launches_multi_query"]}


def phase_obs_attrib(torch, np, fa, fd, card, dense_engine, paged):
    """Phase 33 (module docstring): (i) the attribution report at full
    width, (ii) the tracked wrapper's cost a decode call, (iii) the decode
    phase breakdown over f32 and int8 pools and with a drafter, (iv) a
    profiled serving window merged with the host spans.  Returns the K4
    launches of (iii) and (iv) by path."""
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request,
    )
    from distributeddeeplearning_tpu_torch.spec import SpeculativeDecoder

    params = dense_engine.params

    def requests():
        return [Request(uid=r.uid, prompt=list(r.prompt))
                for r in paged["requests"][:OBS_REQUESTS]]

    f32 = serve_engine(torch, np, params, "paged", (64,), 33)
    int8 = serve_engine(torch, np, params, "paged", (64,), 33, cache_dtype="int8")
    spec = SpeculativeDecoder(f32, drafter="truncated", draft_tokens=SPEC_K,
                              draft_layers=DRAFT_LAYERS)
    for engine, sd in ((f32, None), (int8, None), (f32, spec)):
        ContinuousBatchingScheduler(engine, max_new_tokens=OBS_NEW_TOKENS,
                                    spec_decoder=sd).run(requests())
    _obs_report(torch, np, fa, fd, card, dense_engine, (f32, int8))
    _obs_wrapper_cost(torch, np, card, dense_engine)
    _, _, launches = _obs_breakdowns(torch, np, fa, fd, card, f32, int8, spec)
    window = _obs_window(torch, np, fa, fd, card, f32,
                         requests()[:OBS_WINDOW_REQUESTS])
    del f32, int8, spec
    torch.cuda.empty_cache()
    return {"breakdown": launches, "window": window}


def _obs_train_step(torch, card, state, batch):
    """Phase 33 (v), inside phase 10: the process registry's
    ``train.step.implicit`` row for the full-width LM step (the tracked
    step phase 10 profiles, alive in the caller) against ``utils.hardware.step_flops``
    on the same state and batch.  The row counts the whole step on meta
    (forward and backward products); ``step_flops`` is 3 x the forward, so
    the two differ by the plain backward's recomputed score product: half
    the attention forward's QK and PV."""
    from distributeddeeplearning_tpu_torch.obs.attrib import get_programs
    from distributeddeeplearning_tpu_torch.utils.hardware import step_flops

    t0 = time.perf_counter()
    rows = get_programs().collect(memory=True)["train.step.implicit"]
    collect_s = time.perf_counter() - t0
    b, s, d, h = (TRAIN[k] for k in ("batch_size", "seq_len", "d_model", "num_heads"))
    attention = TRAIN["num_layers"] * 2 * 2 * b * h * s * s * (d // h)
    want = step_flops(state, batch, compute_dtype=torch.float32) + 0.5 * attention
    row = max(rows, key=lambda r: r.flops or 0.0)
    log(f"[attrib] train.step.implicit (phase 33 (v)): {row.flops:.6g} FLOP a step "
        f"(the whole step: forward + backward products), step_flops {want - 0.5 * attention:.6g}"
        f" (3 x the forward) + half the attention forward {0.5 * attention:.6g} = "
        f"{want:.6g}; {row.bytes_accessed:.6g} B accessed (unfused), in place "
        f"{row.alias_bytes} B, temp {row.temp_bytes} B; collect {collect_s:.2f} s on {card}")
    if row.flops != want:
        raise AssertionError(f"[attrib] train step FLOPs {row.flops} != {want}")


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
#: 0.1, AdamW, clip 1.0, warmup then decay): one epoch of 4 steps on a fresh
#: batch each (32 examples), then one eval pass over min(32, 4 x 8) = 32
#: examples, 4 batches
BERT_RUN = dict(model="bert-base", batch_size=8, epochs=1, steps_per_epoch=4,
                train_examples=32)
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


# ---- image phases: the reference's synthetic benchmark (ResNet-50,
# InceptionV3, VGG) through workloads.benchmark.main; no hand-written
# kernel runs on this path (convolutions are cuDNN's)

#: shortened runs at full width: 3 warmup batches, then 3 windows of 5
SHORT = dict(num_warmup_batches=3, num_iters=3, num_batches_per_iter=5)
#: the shortest image runs (phase_image_short, ViT-L/16 in phase_vit): 2
#: warm-up batches, 2 windows of 3
L16_WINDOWS = dict(num_warmup_batches=2, num_iters=2, num_batches_per_iter=3)
SHORT_RUNS = (("inceptionv3", "bfloat16", 299), ("vgg16", "float32", 224),
              ("resnet50", "float32", 224))
#: the card against the CPU: resnet50 at 64 px, batch 4, two train steps
PARITY = dict(model="resnet50", size=64, batch=4, steps=2)
#: float64, card against CPU: of the largest |value| (logits, statistics),
#: relative (each step's loss), and of each leaf's largest |value| for the
#: params, momentum and statistics after the first step.  Both sides
#: compute in float64 but round the logits to f32 (the head's output); the
#: first step starts from equal logits, and after it the state is compared
#: only through the second loss: one f32 ulp of a logit that rounds apart
#: there moved a momentum leaf of the card 8e-2 off the CPU's (measured
#: on one H100), as train-mode BatchNorm over 4-16 values a channel makes
#: single gradient leaves ill-conditioned (tests/test_torch_benchmark.py)
F64_TOL = dict(forward=1e-6, loss=1e-6, state=5e-4)
#: f32: the card's worst leaf (or the first loss) no further from the
#: CPU's float64 run than this many times the CPU's own f32 run's, plus a
#: floor of the value's scale.  f32 gradients of this model are
#: ill-conditioned (on the CPU, single gradient leaves up to 0.2 of a
#: momentum leaf off the float64 ones after one step), so f32 readings are
#: held to the spread f32 itself shows, not to a fixed number; the
#: float64 comparison above is the tight one.  Losses after the first
#: update are held to F32_APART_RTOL: the f32 runs have parted by then
#: (the second loss 3.4e-3 off float64 on the CPU, 8.6e-3 and 1.05e-2 on
#: the card, measured on one H100 in two runs)
F32_FACTOR, F32_FLOOR, F32_APART_RTOL = 4.0, 1e-5, 5e-2
#: bf16 against f32, first step at 224 px, batch 64: BERT's rule
IMAGE_LOSS_RTOL_BF16 = 1e-2


def _image_bench(torch, np, **kw):
    """``workloads.benchmark.main(**kw)`` with each train step bracketed by
    CUDA events (through the train step the workload builds) and the last
    (step, state, batch) kept.  Returns (result, per-step ms from one
    step's start to the next's, the kept triple, peak GB)."""
    from distributeddeeplearning_tpu_torch.train import step as tstep
    from distributeddeeplearning_tpu_torch.workloads import benchmark

    original = tstep.build_train_step
    marks, kept = [], []

    def recording_build(*args, **kwargs):
        train_step = original(*args, **kwargs)

        def step(state, batch):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            out = train_step(state, batch)
            kept[:] = [train_step, out[0], batch]
            return out
        return step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tstep.build_train_step = recording_build
    try:
        result = benchmark.main(**kw)
    finally:
        tstep.build_train_step = original
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:] + [end])]
    return result, step_ms, kept, torch.cuda.max_memory_allocated() / 1e9


def _image_line(np, tag, result, step_ms, warmup, peak_gb, card, dtype, image_size):
    """The run's one report line: img/s mean +-ci95 and the windows, step
    p50, peak memory and mfu (3 x the forward's multiply-adds x 2 FLOPs an
    image, over the dtype's peak).  Returns the p50 in ms."""
    from distributeddeeplearning_tpu_torch.models import get_model

    p50 = float(np.median(step_ms[warmup:]))
    macs = get_model(result.model).forward_macs(image_size)
    flops = 3 * 2 * macs * result.batch_size_per_chip
    peak, peak_name = ((BF16_FLOPS_PER_S, f"{tflops(BF16_FLOPS_PER_S)} dense bf16")
                       if dtype == "bfloat16" else
                       (F32_FLOPS_PER_S, f"{tflops(F32_FLOPS_PER_S)} f32, TF32 off"))
    log(f"[{tag}] img/s a chip {result.img_sec_per_chip_mean:.1f} "
        f"+-{result.img_sec_per_chip_ci95:.1f} (mean +-1.96 sigma over "
        f"{len(result.iter_times_s)} windows; window s "
        f"{[round(t, 4) for t in result.iter_times_s]}); step p50 {p50:.2f} ms "
        f"(CUDA events, start to start, {len(step_ms) - warmup} steps after "
        f"warmup); peak memory {peak_gb:.2f} GB; mfu "
        f"{flops / (p50 / 1e3) / peak:.4f} of {peak_name} ({flops / 1e12:.4f} "
        f"TFLOP a step from {macs / 1e9:.4f} G multiply-adds a forward) on {card}")
    bad = [x for x in (result.img_sec_per_chip_mean, *result.iter_times_s)
           if not math.isfinite(x) or x <= 0]
    if bad:
        raise AssertionError(f"[{tag}] readings not finite and positive: {bad}")
    return p50


def _conv_group(key: str) -> str:
    """The group of a kernel in an image model's train step, by name."""
    low = key.lower()
    if "wgrad" in low:
        return "conv wgrad (cuDNN)"
    if "dgrad" in low:
        return "conv dgrad (cuDNN)"
    if "fprop" in low or "convolve" in low or "conv2d" in low:
        return "conv fprop (cuDNN)"
    if "batch_norm" in low or "bn_" in low or "welford" in low:
        return "BatchNorm (statistics, normalise, backward)"
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout copies (NCHW <-> NHWC)"
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "GEMM-named kernels (the head Dense; cuDNN's GEMM convs)"
    if "elementwise" in low or "functor" in low:
        return "elementwise"
    return "everything else"


def _profile_image_step(torch, step, state, batch, tag, card, step_p50,
                        group=_conv_group):
    """One train step under torch.profiler and
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync inside it
    raises): kernel time by ``group`` (a kernel name to its group; the
    optimizer's elementwise kernels taken out of the "elementwise" group),
    the optimizer's own share (under a ``record_function`` range), the busy
    share and the kernel sum beside a CUDA-event span of the same step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tx_apply = state.tx.apply

    def apply(*args, **kwargs):
        with record_function("optimizer"):
            return tx_apply(*args, **kwargs)

    state.tx.apply = apply
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        del state.tx.apply
    rows = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the "optimizer" range shows twice: as a CPU row whose device time is
    # its kernels', and as a device-side span (not a kernel)
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in rows
                  if e.device_type == cuda and e.self_device_time_total > 0
                  and e.key != "optimizer"), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in top) or None
    event_ms = start.elapsed_time(end)
    opt = next((e.device_time_total / 1e3 for e in rows if e.key == "optimizer"
                and e.device_type != cuda), 0.0)
    opt_span = next((e.device_time_total / 1e3 for e in rows if e.key == "optimizer"
                     and e.device_type == cuda), None)
    log(f"[profile] {tag} train step under sync debug mode 'error' (no host "
        f"sync raised): host wall {wall:.3f} ms (profiled); "
        f"{trust_note(busy, event_ms)}; busy share {(busy or 0) / event_ms:.1%} "
        f"of the profiled span, {(busy or 0) / step_p50:.1%} of the unprofiled "
        f"step p50 {step_p50:.2f} ms; the optimizer's kernels {opt:.3f} ms over "
        f"a device span of {opt_span} ms on {card}")
    groups = {}
    for key, ms in top:
        g = group(key)
        groups[g] = groups.get(g, 0.0) + ms
    groups["elementwise"] = groups.get("elementwise", 0.0) - opt
    groups["optimizer (SGD momentum, elementwise)"] = opt
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {ms:9.3f} ms  {ms / max(busy or 1e-9, 1e-9):6.1%}  {g}")
    for key, ms in top[:25]:
        log(f"[profile]   {ms:8.4f} ms  {group(key)[:12]:12}  {key[:110]}")
    return groups, busy, event_ms


def _fresh_process_benchmark(card):
    """The reference benchmark as a user launches it, ``python -m
    distributeddeeplearning_tpu_torch.workloads.benchmark`` with no flags,
    in a process of its own: a host-bound step runs slower after a
    torch.profiler window in the same process (``scripts/
    profiler_overhead.py``: +23%, measured on one H100), and this script
    has opened many.  Logs its img/s line; returns the mean."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.jsonl")
        proc = subprocess.run(
            [sys.executable, "-m", "distributeddeeplearning_tpu_torch.workloads.benchmark",
             "--metrics_path", path],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            raise AssertionError(f"[resnet] python -m ...workloads.benchmark failed: "
                                 f"{proc.stderr[-2000:]}")
        with open(path) as f:
            row = json.loads(f.read().splitlines()[-1])
    line = next((ln for ln in proc.stderr.splitlines() if "Img/sec per chip" in ln), "")
    log(f"[resnet] fresh process (python -m distributeddeeplearning_tpu_torch."
        f"workloads.benchmark, reference defaults): "
        f"{line.split('Img/sec per chip:')[-1].strip()} "
        f"img/s a chip (mean +-1.96 sigma); metrics row {row} on {card}")
    if not (math.isfinite(row["img_sec_per_chip"]) and row["img_sec_per_chip"] > 0):
        raise AssertionError(f"[resnet] fresh-process img/s {row}")
    return row["img_sec_per_chip"]


def phase_resnet(torch, np, card):
    """``workloads.benchmark.main()`` at the reference defaults (resnet50,
    bf16, batch 64, 224 px, 1001 classes, 10 warmup batches then 10 windows
    of 10) through ``python -m`` in a fresh process (img/s), then in this
    process shortened (SHORT: 3 warmup batches, 3 windows of 5) with each
    step bracketed by CUDA events: img/s, step p50,
    peak memory and mfu from the FLOP reckoning, then one profiled step
    under sync debug mode 'error'."""
    from distributeddeeplearning_tpu_torch.models import get_model

    fresh = _fresh_process_benchmark(card)
    result, step_ms, (step, state, batch), peak_gb = _image_bench(torch, np, **SHORT)
    n = SHORT["num_warmup_batches"] + (SHORT["num_iters"] + 2) * SHORT[
        "num_batches_per_iter"]
    if not (result.model == "resnet50" and result.batch_size_per_chip == 64
            and len(step_ms) == n):
        raise AssertionError(f"[resnet] not the reference model and batch, or not "
                             f"SHORT: {result}, {len(step_ms)} steps")
    p50 = _image_line(np, "resnet", result, step_ms, SHORT["num_warmup_batches"],
                      peak_gb, card, "bfloat16", 224)
    macs = get_model("resnet50").forward_macs(224)
    flops = 3 * 2 * macs * 64
    log(f"[resnet] FLOP reckoning (ImageModel.forward_macs): {macs / 1e9:.4f} G "
        f"multiply-adds a forward, {3 * 2 * macs / 1e9:.3f} GFLOP a trained "
        f"image, {flops / 1e12:.4f} TFLOP a batch-64 step; compute bound "
        f"{flops / BF16_FLOPS_PER_S * 1e3:.3f} ms at {tflops(BF16_FLOPS_PER_S)}; the mean "
        f"img/s is mfu {result.img_sec_per_chip_mean * 6 * macs / BF16_FLOPS_PER_S:.4f}")
    if not all(math.isfinite(float(v)) for v in step(state, batch)[1].values()):
        raise AssertionError("[resnet] non-finite metrics after the run")
    _profile_image_step(torch, step, state, batch, "resnet50 bf16 B=64 224px", card,
                        p50)
    return {"img_s": result.img_sec_per_chip_mean, "p50_ms": p50, "fresh_img_s": fresh}


def _parity_run(torch, np, host, batches, device, dtype):
    """resnet50 from the numpy variables ``host`` on ``device``, computing
    in ``dtype`` (params and statistics float64 with float64, else f32):
    the train-mode logits and new statistics of the first batch, then one
    train step per batch.  Returns numpy readings: those, every step's
    loss, and the params, momentum and statistics after the first step."""
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.models._convnet import (
        variables_from_numpy,
        variables_to_numpy,
    )
    from distributeddeeplearning_tpu_torch.train.schedule import goyal_lr_schedule
    from distributeddeeplearning_tpu_torch.train.state import TrainState, sgd_momentum
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    v = variables_from_numpy(host, device=device)
    if dtype == torch.float64:
        def to64(tree):
            return {k: to64(t) if isinstance(t, dict) else t.double()
                    for k, t in tree.items()}
        v = to64(v)
    model = get_model(PARITY["model"], dtype=dtype)
    with torch.no_grad():
        logits, stats = model(v["params"], torch.as_tensor(batches[0]["image"],
                                                           device=device),
                              train=True, batch_stats=v["batch_stats"])
    state = TrainState.create(params=v["params"], batch_stats=v["batch_stats"],
                              apply_fn=model,
                              tx=sgd_momentum(goyal_lr_schedule(0.0125, 1, 5004)))
    step = build_train_step(state, compute_dtype=dtype)
    losses, out = [], None
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        if out is None:  # the state after the first step
            out = variables_to_numpy({"params": state.params,
                                      "trace": state.opt_state["trace"],
                                      "batch_stats": state.batch_stats,
                                      "new_stats": stats})
    out["logits"] = logits.double().cpu().numpy()
    out["losses"] = np.array(losses)
    return out


def _leaves(np, tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(np, v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree, np.float64)}


def phase_resnet_parity(torch, np, card):
    """resnet50 at 64 px, batch 4, from the same numpy variables (the
    port's init, every BatchNorm's scale, bias, mean and var drawn from
    numpy seed 0) on the card and on the CPU, two train steps, in float64
    (every reading within F64_TOL) and in f32 (each reading no further from
    the CPU's float64 run than F32_FACTOR times the CPU's f32 run is, plus
    F32_FLOOR; the second loss within F32_APART_RTOL of it); the logits and
    new statistics of the first forward, each step's loss, and the params,
    momentum and statistics after the first step.  Then resnet50's first
    bf16 step at 224 px, batch 64, within 1e-2 of the f32 step's loss from
    the same weights.  Every reading must be finite."""
    from distributeddeeplearning_tpu_torch.data.synthetic import (
        synthetic_batch,
        synthetic_batches,
    )
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.models._convnet import variables_to_numpy

    rng = np.random.default_rng(0)

    def drawn(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = drawn(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    size, b = PARITY["size"], PARITY["batch"]
    host = drawn(variables_to_numpy(get_model("resnet50").init(
        torch.Generator().manual_seed(0), (1, size, size, 3), device="cpu")))
    batches = list(synthetic_batches(b, PARITY["steps"], (size, size, 3), 1001, seed=1))
    runs = {}
    for dev in ("cpu", "cuda"):
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            t0 = time.perf_counter()
            runs[dev, name] = {k: _leaves(np, v) if isinstance(v, dict) else v
                               for k, v in _parity_run(torch, np, host, batches, dev,
                                                       dtype).items()}
            log(f"[parity] {PARITY['model']} {size} px batch {b} {name} on {dev}: losses "
                f"{runs[dev, name]['losses'].tolist()} "
                f"({time.perf_counter() - t0:.1f} s)")

    def err(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def worst_leaf(x, y):
        """(largest error over the leaves, its leaf) of readings x against y."""
        pairs = x.items() if isinstance(x, dict) else [("", x)]
        return max((err(v, y[k] if k else y), k) for k, v in pairs)

    ref = runs["cpu", "f64"]
    failed = []
    for key in ("logits", "new_stats", "losses", "params", "trace", "batch_stats"):
        for name in ("f64", "f32"):
            card_r, cpu_r = runs["cuda", name][key], runs["cpu", name][key]
            for r in (card_r.values() if isinstance(card_r, dict) else [card_r]):
                if not np.isfinite(r).all():
                    raise AssertionError(f"[parity] {name} {key}: not finite")
            if key == "losses":  # step by step, relative
                got = [abs(c - h) / abs(h) for c, h in zip(card_r, cpu_r if name == "f64"
                                                           else ref[key])]
                spread = [abs(h - r) / abs(r) for h, r in zip(cpu_r, ref[key])]
                where = "by step"
            else:  # the worst leaf of the tree
                got, where = worst_leaf(card_r, cpu_r if name == "f64" else ref[key])
                spread = [worst_leaf(cpu_r, ref[key])[0]]
                got = [got]
            if name == "f64":
                limits = [F64_TOL["forward" if key in ("logits", "new_stats") else
                                  "loss" if key == "losses" else "state"]] * len(got)
                against = "the CPU's float64"
            else:
                limits = [F32_FACTOR * x + F32_FLOOR for x in spread]
                if key == "losses":
                    limits[1:] = [F32_APART_RTOL] * (len(limits) - 1)
                against = (f"the CPU's float64 run (the CPU's f32 run is "
                           f"{[f'{x:.3e}' for x in spread]} off it)")
            log(f"[parity] {name} {key}: card against {against}: "
                f"{[f'{x:.3e}' for x in got]} at {where or key} (limit "
                f"{[f'{x:.3e}' for x in limits]})")
            if any(x > lim for x, lim in zip(got, limits)):
                failed.append((name, key))
    if failed:
        raise AssertionError(f"[parity] the card left the CPU: {failed}")

    # bf16 against f32 at the reference geometry, same weights (a ResNet's
    # params do not depend on the image size) and batch
    batch = synthetic_batch(64, (224, 224, 3), 1001)
    loss = {name: float(_parity_run(torch, np, host, [batch], "cuda", dtype)
                        ["losses"][0])
            for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    rel = abs(loss["bf16"] - loss["f32"]) / abs(loss["f32"])
    log(f"[parity] resnet50 224 px batch 64 first-step loss: f32 {loss['f32']:.6f}, "
        f"bf16 {loss['bf16']:.6f}, relative {rel:.3e} (limit "
        f"{IMAGE_LOSS_RTOL_BF16:g}) on {card}")
    if not math.isfinite(rel) or rel > IMAGE_LOSS_RTOL_BF16:
        raise AssertionError("[parity] bf16 first-step loss left the f32 one")


def phase_image_short(torch, np, card):
    """Shortened runs at full width through ``workloads.benchmark.main``
    (L16_WINDOWS: 2 warmup batches, 2 windows of 3): inceptionv3 bf16 at
    299 px and vgg16 and resnet50 in f32 at 224 px, batch 64 each."""
    out = {}
    w = L16_WINDOWS
    for model, dtype, size in SHORT_RUNS:
        result, step_ms, _, peak_gb = _image_bench(
            torch, np, model=model, compute_dtype=dtype, image_size=size, **w)
        n = w["num_warmup_batches"] + (w["num_iters"] + 2) * w["num_batches_per_iter"]
        if len(step_ms) != n:
            raise AssertionError(f"[{model}] {len(step_ms)} steps, not {n}")
        out[model, dtype] = _image_line(np, f"{model} {dtype} {size}px", result, step_ms,
                                        w["num_warmup_batches"], peak_gb, card,
                                        dtype, size)
    torch.cuda.empty_cache()
    return out


# ---- ViT-B/16 and MoE BERT on the card; checkpoints and bit-exact resume

#: the ViT-B/16 attention at the benchmark's batch: 196 patches + CLS
VIT_ATTN = dict(b=64, h=12, s=197, d=64)
#: flash vs the default attention, bf16, same weights and batch: per-step
#: loss, relative (BERT's bf16 rule)
VIT_LOSS_RTOL = 1e-2
#: card against CPU: ViT-B/16 at 64 px (16 patches), batch 4
VIT_PARITY = dict(size=64, batch=4)
#: the resumed fit: ViT-B/16, flash, bf16, batch 64 at 224 px, one epoch of
#: 6 steps, a generation every 3; the interrupted run stops before step 4
RESUME = dict(batch=64, steps=6, every=3, stop_before=4)
#: MoE BERT: bert-base with a mixture of experts in every second layer
MOE_EXPERTS = 8
#: MoE BERT f32 forward, card against CPU on the rows no routing flip
#: reaches: of the largest |logit| (f32 through 12 layers, two paths)
MOE_LOGIT_RTOL = 1e-4


def _zero_fa(fa):
    for c in FA_COUNTERS:
        setattr(fa, c, 0)


def _vit_group(key: str) -> str:
    """The group of a kernel in a ViT train step, by name."""
    low = key.lower()
    if "flash_" in low or "softmax" in low:
        return "attention (flash kernels; the default attention's softmax)"
    if "layer_norm" in low or "gelu" in low:
        return "LayerNorm / GELU"
    if "gemm" in low or "nvjet" in low or "cutlass" in low or "xmma" in low:
        return "GEMMs (cuBLAS/CUTLASS; with the default attention its products too)"
    if "conv" in low or "wgrad" in low or "dgrad" in low or "fprop" in low:
        return "patch embedding (cuDNN conv)"
    if "elementwise" in low or "functor" in low or "reduce" in low:
        return "elementwise"
    return "everything else"


def phase_vit(torch, np, card):
    """ViT-B/16 through ``workloads.benchmark.main(model="vit-b16")`` (bf16,
    batch 64, 224 px, 1001 classes), shortened (SHORT: 3 warmup batches,
    3 windows of 5) with each step bracketed by CUDA events: img/s, step p50,
    peak memory and mfu from ``forward_macs`` (the attention products
    counted), one profiled step's split (GEMMs, attention, LayerNorm/GELU,
    elementwise, SGD); then a shortened vit-l16 run (L16_WINDOWS: 2 warmup
    batches, 2 windows of 3)."""
    from distributeddeeplearning_tpu_torch.models import get_model

    result, step_ms, (step, state, batch), peak_gb = _image_bench(
        torch, np, model="vit-b16", **SHORT)
    n = SHORT["num_warmup_batches"] + (SHORT["num_iters"] + 2) * SHORT[
        "num_batches_per_iter"]
    if not (result.model == "vit-b16" and result.batch_size_per_chip == 64
            and len(step_ms) == n):
        raise AssertionError(f"[vit] not the reference model and batch, or not "
                             f"SHORT: {result}, {len(step_ms)} steps")
    p50 = _image_line(np, "vit", result, step_ms, SHORT["num_warmup_batches"],
                      peak_gb, card, "bfloat16", 224)
    macs = get_model("vit-b16").forward_macs(224)
    flops = 3 * 2 * macs * 64
    log(f"[vit] FLOP reckoning (forward_macs, attention products counted): "
        f"{macs / 1e9:.4f} G multiply-adds a forward, {flops / 1e12:.4f} TFLOP a "
        f"batch-64 step; compute bound {flops / BF16_FLOPS_PER_S * 1e3:.3f} ms at "
        f"{tflops(BF16_FLOPS_PER_S)}, {flops / BF16_FLOPS_PER_S * 1e3 / p50:.1%} of the step p50")
    if not all(math.isfinite(float(v)) for v in step(state, batch)[1].values()):
        raise AssertionError("[vit] non-finite metrics after the run")
    _profile_image_step(torch, step, state, batch, "vit-b16 bf16 B=64 224px", card,
                        p50, group=_vit_group)
    del step, state, batch
    torch.cuda.empty_cache()
    large, step_ms, _, peak_gb = _image_bench(torch, np, model="vit-l16", **L16_WINDOWS)
    n = L16_WINDOWS["num_warmup_batches"] + (L16_WINDOWS["num_iters"] + 2) * L16_WINDOWS[
        "num_batches_per_iter"]
    if len(step_ms) != n:
        raise AssertionError(f"[vit-l16] {len(step_ms)} steps, not {n}")
    p50_l = _image_line(np, "vit-l16 bfloat16 224px", large, step_ms,
                        L16_WINDOWS["num_warmup_batches"], peak_gb, card, "bfloat16",
                        224)
    torch.cuda.empty_cache()
    return {"img_s": result.img_sec_per_chip_mean, "p50_ms": p50,
            "l16_p50_ms": p50_l}


def _vit_state(torch, host, attention_fn=None, remat="none"):
    """A bf16 ViT-B/16 train state on the card from the host params
    ``host`` (copied), SGD momentum under the Goyal schedule."""
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.schedule import goyal_lr_schedule
    from distributeddeeplearning_tpu_torch.train.state import (
        TrainState,
        sgd_momentum,
        tree_map,
    )

    kw = {"remat": remat}
    if attention_fn is not None:
        kw["attention_fn"] = attention_fn
    model = get_model("vit-b16", **kw)
    sched = goyal_lr_schedule(0.0125, 1, 5004)
    return TrainState.create(params=tree_map(lambda t: t.to("cuda", copy=True), host),
                             apply_fn=model, tx=sgd_momentum(sched)), sched


def phase_vit_flash(torch, np, F, fa, card):
    """The bf16 K1, K2 and K3 at ViT-B/16's attention shape (B 64, H 12,
    S 197, D 64, non-causal, no bias) and at S 1 and 37 (B 2) against their
    plain versions (the bf16 rule); timed at the ViT shape beside SDPA with
    the block rows and how full S = 197 leaves them; exact launches a train
    step (12 K1, 12 K2, 12 K3; under remat ``dots`` and ``full`` K1 again
    where each block is recomputed); the flash ViT's losses within
    VIT_LOSS_RTOL of the default attention's over three steps; then the f32
    forward on the card against the port on the CPU (float64 and f32, as
    ``phase_resnet_parity``).  Returns the kernels-line entries."""
    from distributeddeeplearning_tpu_torch.data.synthetic import synthetic_batch
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    b, h, s, d = (VIT_ATTN[k] for k in ("b", "h", "s", "d"))
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for bb, ss in ((2, 1), (2, 37), (b, s)):
        q, k, v = qkv_views(torch, bb, ss, h, d, torch.bfloat16, seed=ss + 5)
        errs, (lse, _, do, delta, _) = _hold_flash(
            torch, fa, q, k, v, False, seed=ss, what=f"ViT B={bb} S={ss}")
        worst = {kern: max(worst[kern], e) for kern, e in errs.items()}
        log(f"[vit-flash] bf16 B={bb} H={h} S={ss} D={d} non-causal, no bias: held "
            f"against the plain versions (bf16 rule); max |kernel - plain| K1 "
            f"{errs['fwd']:.3e}, K2 {errs['dq']:.3e}, K3 {errs['dkv']:.3e}")
    fwd_ms, fwd_plain, fwd_lib, dq_ms, dkv_ms, bwd_plain, bwd_lib = _time_flash(
        torch, F, fa, q, k, v, do, lse, delta, causal=False)
    pairs = b * h * s * s
    head = 2.0 * b * s * h * d
    rows_in = 4 * head + 2 * 4.0 * b * h * s
    rows = {"fwd": fa.bf16_block_rows(b, h, s),
            "dq": fa.bf16_bwd_block_rows("dq", b, h, s),
            "dkv": fa.bf16_bwd_block_rows("dkv", b, h, s)}
    shape = f"B={b} H={h} S={s} D={d} non-causal bf16 (strided qkv views)"
    entries = {}
    for kern, ms, plain_ms, lib_ms, nbytes, per_pair in (
            ("fwd", fwd_ms, fwd_plain, fwd_lib, 4 * head + 4.0 * b * h * s, 4.0),
            ("dq", dq_ms, bwd_plain, bwd_lib, rows_in + head, 6.0),
            ("dkv", dkv_ms, bwd_plain, bwd_lib, rows_in + 2 * head, 8.0)):
        bms, by = bound_ms(nbytes, per_pair * d * pairs, BF16_FLOPS_PER_S)
        entries[kern] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             library_ms=lib_ms, max_abs_err=worst[kern], shape=shape,
                             block_rows=rows[kern],
                             tflops=per_pair * d * pairs / ms / 1e9)
    qfill = s / (-(-s // rows["fwd"]) * rows["fwd"])
    kfill = s / (-(-s // 128) * 128)
    log(f"[vit-flash] {shape}: K1 {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, sdpa "
        f"{fwd_lib:.4f}, {fwd_ms / fwd_lib:.2f}x; bound {entries['fwd']['bound_ms']:.4f} "
        f"ms, {entries['fwd']['bound_by']}), K2 {dq_ms:.4f} ms (bound "
        f"{entries['dq']['bound_ms']:.4f}), K3 {dkv_ms:.4f} ms (bound "
        f"{entries['dkv']['bound_ms']:.4f}); K2+K3 {dq_ms + dkv_ms:.4f} ms against "
        f"sdpa's whole backward {bwd_lib:.4f} ms ({(dq_ms + dkv_ms) / bwd_lib:.2f}x), "
        f"plain backward {bwd_plain:.4f} ms; block rows K1/K2/K3 "
        f"{rows['fwd']}/{rows['dq']}/{rows['dkv']}: S = 197 fills the query blocks "
        f"{qfill:.0%} and the 128-key tiles {kfill:.0%}; device times, on {card}")
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()

    # exact launches a train step, and the loss against the default attention
    host = get_model("vit-b16").init(torch.Generator().manual_seed(0),
                                     (1, 224, 224, 3), device="cpu")["params"]
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_batch(b, (224, 224, 3), 1001, seed=3).items()}
    losses = {}
    for name, remat in (("flash", "none"), ("flash", "dots"), ("flash", "full"),
                        ("default", "none")):
        attention_fn = fa.make_flash_attention() if name == "flash" else None
        state, sched = _vit_state(torch, host, attention_fn, remat)
        step = build_train_step(state, schedule=sched, compute_dtype=torch.bfloat16)
        run = []
        for i in range(3 if remat == "none" else 1):
            _zero_fa(fa)
            torch.cuda.synchronize()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            counts = _fa_counts(fa)
            run.append(metrics["loss"].item())
            want = {c: 0 for c in FA_COUNTERS}
            if name == "flash":
                want.update({"launches_bf16": 12 * (1 if remat == "none" else 2),
                             "launches_dq_bf16": 12, "launches_dkv_bf16": 12})
            if counts != want:
                raise AssertionError(f"[vit-flash] {name} remat={remat} step {i + 1}: "
                                     f"launches {counts}, expected {want}")
        log(f"[vit-flash] ViT-B/16 bf16 B=64 train step, {name} attention, remat "
            f"{remat}: launches a step K1 {counts['launches_bf16']}, K2 "
            f"{counts['launches_dq_bf16']}, K3 {counts['launches_dkv_bf16']} "
            f"(every other counter 0); losses {[round(x, 6) for x in run]}")
        losses[name, remat] = run
        del state, step
        torch.cuda.empty_cache()
    rel = [abs(a - c) / abs(c) for a, c in zip(losses["flash", "none"],
                                                losses["default", "none"])]
    log(f"[vit-flash] |flash - default| / default loss by step "
        f"{[f'{x:.2e}' for x in rel]} (tolerance {VIT_LOSS_RTOL:g}); remat dots / "
        f"full first loss {losses['flash', 'dots'][0]:.6f} / "
        f"{losses['flash', 'full'][0]:.6f} against {losses['flash', 'none'][0]:.6f}")
    if not all(math.isfinite(x) for x in rel) or max(rel) > VIT_LOSS_RTOL:
        raise AssertionError("[vit-flash] flash losses left the default attention's")
    if not (losses["flash", "dots"][0] == losses["flash", "full"][0]
            == losses["flash", "none"][0]):
        raise AssertionError("[vit-flash] remat changed the first step's loss")
    for kern in entries:
        entries[kern]["launches"] = 12
    _vit_parity(torch, np, fa, card)
    return entries


def _vit_parity(torch, np, fa, card):
    """ViT-B/16's forward (eval) on the card against the port on the CPU from
    the same weights (the port's init at 64 px: the position embeddings
    follow the patch count) and a 64 px batch of 4: float64 within F64_TOL's
    forward limit, and f32 (default attention, and flash: the f32 kernel on
    split TF32) no further from the CPU's float64 logits than F32_FACTOR
    times the CPU's f32 logits are, plus F32_FLOOR."""
    from distributeddeeplearning_tpu_torch.data.synthetic import synthetic_batch
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    size, bsz = VIT_PARITY["size"], VIT_PARITY["batch"]
    host = get_model("vit-b16").init(torch.Generator().manual_seed(2),
                                     (1, size, size, 3), device="cpu")["params"]
    images = synthetic_batch(bsz, (size, size, 3), 1001, seed=4)["image"]
    out = {}
    for dev in ("cpu", "cuda"):
        for name, dtype, attn in (("f64", torch.float64, None),
                                  ("f32", torch.float32, None),
                                  ("f32 flash", torch.float32, "flash")):
            if attn and dev == "cpu":
                continue
            kw = {"dtype": dtype}
            if attn:
                kw["attention_fn"] = fa.make_flash_attention()
            params = tree_map(lambda t: t.to(dev, dtype, copy=True), host)
            with torch.no_grad():
                logits = get_model("vit-b16", **kw)(
                    params, torch.as_tensor(images, device=dev), train=False)
            out[dev, name] = logits.double().cpu().numpy()
    ref = out["cpu", "f64"]

    def err(a):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    spread = err(out["cpu", "f32"])
    limit32 = F32_FACTOR * spread + F32_FLOOR
    got = {name: err(out["cuda", name]) for name in ("f64", "f32", "f32 flash")}
    log(f"[vit-parity] ViT-B/16 {size} px batch {bsz} eval logits, card against the "
        f"CPU's float64: f64 {got['f64']:.3e} (limit {F64_TOL['forward']:g}), f32 "
        f"{got['f32']:.3e}, f32 flash {got['f32 flash']:.3e} (limit {limit32:.3e}: "
        f"the CPU's f32 is {spread:.3e} off) on {card}")
    bad = [n for n, e in got.items()
           if not math.isfinite(e) or e > (F64_TOL["forward"] if n == "f64" else limit32)]
    if bad:
        raise AssertionError(f"[vit-parity] the card left the CPU: {bad}")


def phase_resume(torch, np, fa, card):
    """ViT-B/16 with flash attention (bf16, batch 64, 224 px, SGD momentum)
    through the ``Trainer``: one epoch of RESUME["steps"] steps with a
    generation every RESUME["every"] steps through a step-indexed batch
    factory, twice (the two runs must agree bitwise; if they do not, the
    phase names the differing leaves and runs both again with
    ``torch.backends.cudnn.deterministic``, in this phase only); then a run
    whose stream stops before step RESUME["stop_before"], and a fresh
    ``Trainer`` and ``Checkpointer`` that resume it from its last
    generation and finish: the resumed run's params, momentum and per-step
    losses must equal the uninterrupted run's bit for bit.  Last, the
    newest generation of the resumed run's store is corrupted (``flip``)
    and ``restore`` must fall back to step RESUME["every"].  Logs the
    checkpointer's save, snapshot and verify walls and the launches of the
    uninterrupted fit (the counters zeroed just before it)."""
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch.data.synthetic import synthetic_batch
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.checkpoint import (
        Checkpointer,
        corrupt_generation,
        flatten,
    )
    from distributeddeeplearning_tpu_torch.train.loop import Trainer, TrainerConfig
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    b, steps, every = RESUME["batch"], RESUME["steps"], RESUME["every"]
    host = get_model("vit-b16").init(torch.Generator().manual_seed(1),
                                     (1, 224, 224, 3), device="cpu")["params"]
    data = [synthetic_batch(b, (224, 224, 3), 1001, seed=100 + i) for i in range(steps)]

    class Stopped(Exception):
        pass

    def fit(directory, stop_before=None):
        state, sched = _vit_state(torch, host, fa.make_flash_attention())
        step = build_train_step(state, schedule=sched, compute_dtype=torch.bfloat16)
        losses = {}

        def recording(state, batch):
            state, metrics = step(state, batch)
            losses[state.step] = metrics["loss"].detach()
            return state, metrics

        def factory(start):
            for i in range(start, steps):
                if stop_before is not None and i + 1 == stop_before:
                    raise Stopped(i + 1)
                yield data[i]

        trainer = Trainer(recording, config=TrainerConfig(
            epochs=1, steps_per_epoch=steps, global_batch_size=b,
            checkpoint_dir=directory, checkpoint_every_steps=every))
        try:
            state, _ = trainer.fit(state, factory)
        except Stopped:
            state = None
        return state, {k: v.item() for k, v in losses.items()}, trainer.checkpointer

    def leaves(state):
        return flatten({"params": state.params, "trace": state.opt_state["trace"]})

    def differing(a, b):
        return [k for (k, x), (_, y) in zip(leaves(a), leaves(b)) if not torch.equal(x, y)]

    root = tempfile.mkdtemp(prefix="vit-resume-")
    deterministic = torch.backends.cudnn.deterministic
    try:
        for attempt in range(2):
            _zero_fa(fa)
            torch.cuda.synchronize()
            a, losses_a, ckpt_a = fit(os.path.join(root, f"a{attempt}"))
            torch.cuda.synchronize()
            counts = _fa_counts(fa)
            b_state, losses_b, _ = fit(os.path.join(root, f"b{attempt}"))
            diff = differing(a, b_state)
            log(f"[resume] two uninterrupted fits of {steps} steps (cudnn.deterministic "
                f"{torch.backends.cudnn.deterministic}): losses {losses_a} and "
                f"{losses_b}; {len(diff)} of {len(leaves(a))} params/momentum leaves "
                f"differ {diff[:6]}")
            del b_state
            if not diff and losses_a == losses_b:
                break
            if attempt == 1:
                raise AssertionError("[resume] two uninterrupted fits differ with "
                                     "cudnn.deterministic too")
            torch.backends.cudnn.deterministic = True
        want = {c: 0 for c in FA_COUNTERS}
        want.update({"launches_bf16": 12 * steps, "launches_dq_bf16": 12 * steps,
                     "launches_dkv_bf16": 12 * steps})
        if counts != want:
            raise AssertionError(f"[resume] launches {counts}, expected {want}")
        log(f"[resume] checkpointer of the uninterrupted fit ({len(ckpt_a.all_steps())} "
            f"generations {ckpt_a.all_steps()}, ViT-B/16 params + momentum "
            f"{sum(t.numel() for _, t in leaves(a)) * 4 / 1e9:.3f} GB): save wall "
            f"{ckpt_a.save_wall_s:.3f} s (snapshot to host {ckpt_a.snapshot_wall_s:.3f} "
            f"s), verify wall {ckpt_a.verify_wall_s:.3f} s, waits for the data to "
            f"land {ckpt_a.write_wait_s:.3f} s, background checksums "
            f"{ckpt_a.verify_cpu_s:.3f} s; launches {counts} on {card}")
        resumed_dir = os.path.join(root, "resumed")
        _, losses_c, ckpt_c = fit(resumed_dir, stop_before=RESUME["stop_before"])
        if ckpt_c.all_steps() != [every]:
            raise AssertionError(f"[resume] the stopped run left {ckpt_c.all_steps()}")
        t0 = time.perf_counter()
        d, losses_d, ckpt_d = fit(resumed_dir)
        diff = differing(a, d)
        same_losses = all(losses_d[k] == losses_a[k] for k in losses_d)
        log(f"[resume] stopped before step {RESUME['stop_before']} (losses "
            f"{losses_c}), resumed by a fresh Trainer and Checkpointer from step "
            f"{every}: steps {sorted(losses_d)} losses {losses_d} (uninterrupted "
            f"{[losses_a[k] for k in sorted(losses_d)]}); {len(diff)} params/momentum "
            f"leaves differ; {time.perf_counter() - t0:.1f} s")
        if sorted(losses_d) != list(range(every + 1, steps + 1)) or diff or not same_losses:
            raise AssertionError(f"[resume] the resumed fit is not bit-identical: "
                                 f"{diff[:6]}, losses {losses_d} vs {losses_a}")
        newest = max(ckpt_d.all_steps())
        what = corrupt_generation(os.path.join(resumed_dir, str(newest)), "flip")
        template, _ = _vit_state(torch, host, fa.make_flash_attention())
        checker = Checkpointer(resumed_dir)
        restored, step_no = checker.restore(template)
        log(f"[resume] corrupted generation {newest} ({what}); restore fell back to "
            f"step {step_no} (state step {restored.step}), verify wall "
            f"{checker.verify_wall_s:.3f} s; generations left {checker.all_steps()}")
        if step_no != every or restored.step != every or newest in checker.all_steps():
            raise AssertionError(f"[resume] restore did not fall back to {every}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"deterministic_switch": attempt == 1, "launches": counts}


#: the resilience phase: the RESUME fit's model, batch and steps; an LM
#: subprocess at TRAIN's width and batch (LM_LAYERS_PREEMPT layers)
#: preempted at LM_PREEMPT of LM_STEPS; the
#: watchdog subprocess at the LM workload's defaults, its deadline and the
#: injected stall
LM_STEPS, LM_PREEMPT = 6, 3
LM_LAYERS_PREEMPT = 2  # (7)'s LM runs: TRAIN's width and batch, cut to 2 layers
WATCHDOG = dict(deadline_s=2, stall_at=3, stall_s=6)


def _lm_workload_start(env_faults, argv):
    """Start ``python -m ...workloads.transformer argv`` in a fresh process
    with ``DDLT_FAULTS=env_faults``; :func:`_lm_workload_wait` collects it."""
    env = dict(os.environ, DDLT_FAULTS=env_faults)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.workloads.transformer",
         *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=env)
    return proc, time.perf_counter()


def _lm_workload_wait(started, timeout=600):
    """(exit code, stdout, stderr, seconds) of a started LM process; killed
    at ``timeout``."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0


def _lm_workload(env_faults, argv, timeout=600):
    """``python -m ...workloads.transformer argv`` in a fresh process with
    ``DDLT_FAULTS=env_faults``: (exit code, stdout, stderr, seconds)."""
    return _lm_workload_wait(_lm_workload_start(env_faults, argv), timeout)


#: the resilience fit's step FLOPs, the Trainer's probe against the
#: script's reckoning: both count ViT-B/16's convolution, matrix products
#: and attention products by their shapes (the CPU tests find them equal)
MFU_FLOPS_RTOL = 1e-9


def phase_resilience(torch, np, fa, card):
    """The trainer's resilience layer on ViT-B/16 with flash (bf16, the
    RESUME batch and steps, SGD momentum, ``skip_nonfinite=True``) through
    the ``Trainer`` and a step-indexed factory, each sub-run with a fresh
    state, trainer and checkpointer and its own faults armed by
    ``install_plan`` (disarmed after): a clean fit (the launch counters
    zeroed just before it), then (1) ``nan_loss@4,nan_loss@5`` with the
    detector (2 in a row) and rollback, a generation every 3 steps: one
    rollback to 3, 2 anomalous steps, params, momentum and per-step losses
    bitwise the clean fit's, 2 redone steps in its goodput ledger; an
    isolated ``nan_loss@4`` without the detector leaves the state after
    step 4 bitwise the state after step 3; (2) ``preempt@4`` under
    ``supervise(max_restarts=1)``: an emergency generation at 4,
    ``PreemptionError`` in attempt 0, resume from 4, bitwise the clean fit;
    (3) its goodput ledger through ``stitch`` / ``summarize_ledger``: the
    categories within RESIDUAL_LIMIT_PCT of the wall, no redone step, and
    its mfu non-null and the script's recomputation from the ledger's
    FLOPs, steps and wall over ``utils/hardware``'s bf16 peak, the FLOPs
    the script's own reckoning within MFU_FLOPS_RTOL; (4)
    ``io_error@p=0.3:seed=7`` bitwise the clean fit with the retries
    counted, ``ckpt_torn@2`` (a generation every 3) and
    ``ckpt_corrupt@3:mode=truncate`` (every 2): ``restore`` falls back to
    the newest generation that verifies; (5) ``prefetch=0`` bitwise the
    clean fit (``prefetch=2``), each one's step p50 (CUDA events from one
    step's launch to the next), and a fit with the detector on (one host
    sync a step); (6) a profiler window over steps 3-4 with
    the tracer on: the chrome trace names K1, K2, K3 and ``train/step``
    (recorded launches logged, not gated), the tracer's export the
    ``train/*`` spans and the rollback event; (7) the LM workload in
    subprocesses at TRAIN's width and batch cut to LM_LAYERS_PREEMPT
    layers (flash, bf16, LM_STEPS steps) preempted at LM_PREEMPT, started
    with the phase and run beside (1)-(6): exit 75 and a generation at
    LM_PREEMPT, then rerun without faults: resumes from it and exits 0; at
    its defaults with ``--step_deadline_s`` and an injected data stall (a
    process also started with the phase): exit 70 with the stacks on
    stderr.  Returns the clean fit's launches."""
    import json as _json
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch.data.synthetic import synthetic_batch
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.obs import goodput, trace
    from distributeddeeplearning_tpu_torch.obs.recorder import get_recorder
    from distributeddeeplearning_tpu_torch.obs.registry import get_registry
    from distributeddeeplearning_tpu_torch.train.checkpoint import (
        Checkpointer,
        flatten,
        load_manifest,
    )
    from distributeddeeplearning_tpu_torch.train.loop import Trainer, TrainerConfig
    from distributeddeeplearning_tpu_torch.train.resilience import supervise
    from distributeddeeplearning_tpu_torch.train.step import build_train_step
    from distributeddeeplearning_tpu_torch.utils import faults, hardware

    b, steps, every = RESUME["batch"], RESUME["steps"], RESUME["every"]
    host = get_model("vit-b16").init(torch.Generator().manual_seed(1),
                                     (1, 224, 224, 3), device="cpu")["params"]
    data = [synthetic_batch(b, (224, 224, 3), 1001, seed=100 + i) for i in range(steps)]

    def factory(start):
        for i in range(start, steps):
            yield data[i]

    def leaves(state):
        return flatten({"params": state.params, "trace": state.opt_state["trace"]})

    def differing(a, b):
        return [k for (k, x), (_, y) in zip(leaves(a), leaves(b)) if not torch.equal(x, y)]

    def fit(spec="", directory=None, every=every, attempts=None, snap=(), **cfg):
        """One fit (a fresh state, Trainer and Checkpointer an attempt,
        ``spec`` armed for the whole fit); returns (state, result, [(step,
        loss)], [trainer of each attempt], restarts, {step: leaves},
        [step-start events])."""
        losses, trainers, snaps, starts = [], [], {}, []

        def attempt(_):
            state, sched = _vit_state(torch, host, fa.make_flash_attention())
            step = build_train_step(state, schedule=sched, compute_dtype=torch.bfloat16,
                                    skip_nonfinite=True)

            def recording(state, batch):
                starts.append(torch.cuda.Event(enable_timing=True))
                starts[-1].record()
                state, metrics = step(state, batch)
                losses.append((state.step, metrics["loss"].detach()))
                if state.step in snap:
                    snaps[state.step] = [t.clone() for _, t in leaves(state)]
                return state, metrics

            trainer = Trainer(recording, config=TrainerConfig(
                epochs=1, steps_per_epoch=steps, global_batch_size=b,
                checkpoint_dir=directory,
                checkpoint_every_steps=every if directory else None, **cfg))
            trainers.append(trainer)
            return trainer.fit(state, factory)

        faults.install_plan(spec)
        try:
            (state, result), restarts = supervise(
                attempt, max_restarts=attempts or 0,
                ledger_path=cfg.get("goodput_path"))
        finally:
            faults.install_plan("")
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        spans = [a.elapsed_time(z) for a, z in zip(starts, starts[1:] + [end])]
        return (state, result, [(s, v.item()) for s, v in losses], trainers, restarts,
                snaps, spans)

    def same_losses(got, want):
        return all(a == b for a, b in zip(got, want)) and len(got) == len(want)

    root = tempfile.mkdtemp(prefix="vit-resilience-")
    out = {}
    # (7)'s preempted LM run and the watchdog's run start now, in processes
    # of their own, and run beside (1)-(6) (their exit codes are checked;
    # the steps they time are not theirs)
    watchdog = _lm_workload_start(
        f"data_stall@{WATCHDOG['stall_at']}:secs={WATCHDOG['stall_s']}",
        [f"--step_deadline_s={WATCHDOG['deadline_s']}", "--epochs=1",
         "--steps_per_epoch=8"])
    lm_dir = tempfile.mkdtemp(prefix="lm-preempt-")
    lm_geo = {**TRAIN, "num_layers": LM_LAYERS_PREEMPT}
    argv = [f"--{k}={v}" for k, v in lm_geo.items()] + [
        "--attention=flash", "--compute_dtype=bfloat16", "--epochs=1",
        f"--steps_per_epoch={LM_STEPS}", f"--train_examples={LM_STEPS * TRAIN['batch_size']}",
        f"--save_filepath={lm_dir}"]
    preempted = _lm_workload_start(f"preempt@{LM_PREEMPT}", argv)
    try:
        # the clean fit: prefetch on (the default), no checkpoint
        _zero_fa(fa)
        torch.cuda.synchronize()
        clean, res_c, losses_c, _, _, _, spans_c = fit()
        torch.cuda.synchronize()
        counts = _fa_counts(fa)
        want = {c: 0 for c in FA_COUNTERS}
        want.update({"launches_bf16": 12 * steps, "launches_dq_bf16": 12 * steps,
                     "launches_dkv_bf16": 12 * steps})
        if counts != want:
            raise AssertionError(f"[resilience] launches {counts}, expected {want}")
        clean_losses = dict(losses_c)
        log(f"[resilience] clean ViT-B/16 flash fit of {steps} steps (bf16, batch {b}, "
            f"prefetch 2): losses {clean_losses}; launches {counts} on {card}")

        # (1) anomaly rollback (the tracer on), and an isolated NaN without
        # the detector
        tracer_rb = trace.configure(enabled=True)
        gp1 = os.path.join(root, "rollback.goodput.jsonl")
        st1, res1, losses1, _, _, _, _ = fit(
            "nan_loss@4,nan_loss@5", os.path.join(root, "rollback"),
            anomaly_max_consecutive=2, anomaly_rollback=True, goodput_path=gp1)
        tracer_rb.disable()
        diff = differing(st1, clean)
        replay = dict(losses1)
        led1 = goodput.summarize_ledger(goodput.stitch(gp1))
        log(f"[resilience] rollback: nan_loss@4,nan_loss@5, detector 2 in a row: steps "
            f"{[s for s, _ in losses1]}, {res1.anomalous_steps} anomalous, "
            f"{res1.rollbacks} rollback(s); {len(diff)} params/momentum leaves differ "
            f"from the clean fit; replayed losses {[replay[k] for k in (4, 5, 6)]}; "
            f"ledger redone steps {led1['counts']['steps_redone']}, segments "
            f"{led1['counts']['segments']} on {card}")
        if ([s for s, _ in losses1] != [1, 2, 3, 4, 5, 4, 5, 6] or res1.rollbacks != 1
                or res1.anomalous_steps != 2 or diff or replay != clean_losses
                or not all(math.isnan(v) for _, v in losses1[3:5])
                or led1["counts"]["steps_redone"] != 2):
            raise AssertionError(f"[resilience] the rolled-back fit is not the clean "
                                 f"fit: {diff[:6]}, {losses1}, {led1['counts']}")
        _, res_n, losses_n, _, _, snaps, _ = fit("nan_loss@4", snap=(3, 4))
        same = all(torch.equal(x, y) for x, y in zip(snaps[3], snaps[4]))
        log(f"[resilience] isolated nan_loss@4 without the detector: loss at 4 "
            f"{dict(losses_n)[4]}, params and momentum after step 4 bitwise those "
            f"after step 3: {same} on {card}")
        if not same or not math.isnan(dict(losses_n)[4]):
            raise AssertionError("[resilience] the NaN step's update was not skipped")
        del snaps

        # (2) preemption, supervised restart, (3) its goodput ledger
        gp2 = os.path.join(root, "preempt.goodput.jsonl")
        pre_dir = os.path.join(root, "preempt")
        t0 = time.perf_counter()
        st2, _, losses2, _, restarts, _, _ = fit(
            "preempt@4", pre_dir, attempts=1, goodput_path=gp2)
        wall2 = time.perf_counter() - t0
        diff = differing(st2, clean)
        # the emergency checkpoint's span, from the flight recorder (on
        # while the tracer is off)
        emergency = [e["dur_us"] / 1e6 for e in get_recorder().entries()
                     if e["name"] == "train/emergency_checkpoint"][-1]
        gens = Checkpointer(pre_dir).all_steps()
        rows = goodput.read_rows(gp2)
        reasons = [r.get("reason") for r in rows if r["kind"] == "segment"]
        gb = sum(t.numel() * t.element_size() for _, t in leaves(st2)) / 1e9
        log(f"[resilience] preempt@4 under supervise(max_restarts=1): {restarts} "
            f"restart, segments {reasons}, steps {[s for s, _ in losses2]}, "
            f"generations {gens}; {len(diff)} params/momentum leaves differ from the "
            f"clean fit; emergency checkpoint (save + wait, {gb:.3f} GB of params and "
            f"momentum) {emergency:.3f} s; {wall2:.2f} s in all on {card}")
        if (restarts != 1 or reasons != ["PreemptionError", "completed"] or diff
                or [s for s, _ in losses2] != list(range(1, steps + 1))
                or dict(losses2) != clean_losses or 4 not in gens):
            raise AssertionError(f"[resilience] the preempted fit is not the clean "
                                 f"fit: {diff[:6]}, {losses2}, {gens}, {reasons}")
        led2 = goodput.summarize_ledger(goodput.stitch(gp2))
        secs = {k: round(v, 4) for k, v in led2["seconds"].items()}
        log(f"[resilience] goodput of the preempted run: total {led2['total_wall_s']} s, "
            f"categories {secs}, recovery {secs['recovery']} s, goodput share "
            f"{led2['goodput_fraction']}, unaccounted {led2['unaccounted_pct']}% (limit "
            f"{goodput.RESIDUAL_LIMIT_PCT}%), counts {led2['counts']}, notes "
            f"{led2['notes']} on {card}")
        if (not led2["residual_under_limit"] or led2["counts"]["steps_redone"] != 0
                or led2["counts"]["restarts"] != 1):
            raise AssertionError(f"[resilience] goodput ledger: {led2}")
        # (3) its MFU: the Trainer's probe (utils.hardware.step_flops) over
        # the card's peak from utils/hardware.PEAKS, recomputed here
        merged2 = goodput.stitch(gp2)
        port_flops = merged2["flops_per_step"]
        script_flops = 3 * 2 * get_model("vit-b16").forward_macs(224) * b
        peak = hardware.peak_bf16_flops()
        want_mfu = (None if not port_flops else port_flops * led2["counts"]["steps"]
                    / merged2["total_wall_s"] / (peak * 1))
        log(f"[resilience] mfu of the preempted run: {led2['mfu']} (the ledger's) against "
            f"{want_mfu} = flops_per_step x {led2['counts']['steps']} steps / "
            f"{merged2['total_wall_s']:.4f} s / ({tflops(peak)} x 1 card); "
            f"step_flops (FlopCounterMode on meta, 3 x the forward) {port_flops} against "
            f"the script's 3 x 2 x forward_macs x {b} = {script_flops} (tolerance "
            f"{MFU_FLOPS_RTOL:g} relative: both count the same products by shape) on {card}")
        if (led2["mfu"] is None or want_mfu is None
                or abs(led2["mfu"] - want_mfu) > 1e-9 * want_mfu
                or abs(port_flops - script_flops) > MFU_FLOPS_RTOL * script_flops):
            raise AssertionError(f"[resilience] mfu {led2['mfu']} vs {want_mfu}; "
                                 f"flops {port_flops} vs {script_flops}")
        out.update(emergency_s=emergency, goodput=led2)

        # (4) storage faults
        reg = get_registry()

        def retries():
            return sum(c.value for n, c in reg._counters.items()
                       if n.startswith("retry.attempts."))

        r0 = retries()
        st4, _, losses4, trainers4, _, _, _ = fit(
            "io_error@p=0.3:seed=7", os.path.join(root, "io"), every=1,
            metrics_path=os.path.join(root, "io.metrics.jsonl"),
            goodput_path=os.path.join(root, "io.goodput.jsonl"))
        n_retries = retries() - r0
        diff = differing(st4, clean)
        log(f"[resilience] io_error@p=0.3:seed=7 (a generation every step): "
            f"{n_retries} retries counted, generations "
            f"{trainers4[0].checkpointer.all_steps()}; {len(diff)} leaves differ from "
            f"the clean fit on {card}")
        if diff or dict(losses4) != clean_losses or n_retries < 1:
            raise AssertionError("[resilience] the io_error fit is not the clean fit")
        for spec, gen_every, newest, want_step in (
                ("ckpt_torn@2", every, steps, every),
                ("ckpt_corrupt@3:mode=truncate", 2, steps, steps - 2)):
            directory = os.path.join(root, spec.split("@")[0])
            fit(spec, directory, every=gen_every)
            torn = load_manifest(os.path.join(directory, str(newest))) is None
            template, _ = _vit_state(torch, host, fa.make_flash_attention())
            checker = Checkpointer(directory)
            restored, step_no = checker.restore(template)
            log(f"[resilience] {spec} (a generation every {gen_every}): generation "
                f"{newest} {'has no manifest' if torn else 'has its manifest'}; restore "
                f"fell back to step {step_no}, generations left {checker.all_steps()} "
                f"on {card}")
            if (step_no != want_step or restored.step != want_step
                    or newest in checker.all_steps()
                    or torn != spec.startswith("ckpt_torn")):
                raise AssertionError(f"[resilience] {spec}: restore landed on {step_no}")
            del template, restored

        # (5) prefetch off against on (on: the clean fit, and once more after)
        del st1, st2, st4
        st5, _, losses5, _, _, _, spans_0 = fit(prefetch=0)
        diff = differing(st5, clean)
        del st5
        _, _, _, _, _, _, spans_2 = fit(prefetch=2)
        _, _, _, _, _, _, spans_d = fit(anomaly_max_consecutive=2)
        p50 = {name: float(np.median(spans[1:])) for name, spans in (
            ("on, first", spans_c), ("off", spans_0), ("on, again", spans_2),
            ("on, detector", spans_d))}
        log(f"[resilience] prefetch=0 against prefetch=2: {len(diff)} leaves differ, "
            f"losses equal {dict(losses5) == clean_losses}; step p50 (CUDA events, "
            f"launch to launch, steps 2-{steps}) "
            f"{ {k: round(v, 2) for k, v in p50.items()} } ms on {card}")
        if diff or dict(losses5) != clean_losses:
            raise AssertionError("[resilience] prefetch changed the fit")
        out.update(p50_ms=p50)

        # (6) the profiler window and the tracer
        prof_dir = os.path.join(root, "profile")
        trace.configure(enabled=True)
        fit(profile_dir=prof_dir, profile_start=2, profile_steps=2)
        trace.configure(enabled=False)
        paths = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)]
        events = _json.load(open(paths[0]))["traceEvents"]
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        recorded = {k: sum(k in n for n in kernels)
                    for k in ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}
        step_spans = sum(e.get("name") == "train/step" for e in events)
        exported = os.path.join(root, "tracer.json")
        tracer_rb.export(exported)
        host_names = {e["name"] for e in _json.load(open(exported))["traceEvents"]}
        log(f"[resilience] profiler window steps 3-4 ({os.path.basename(paths[0])}): "
            f"recorded launches {recorded} (24 each made; not gated: the profiler "
            f"drops records), train/step ranges {step_spans}; the tracer's export "
            f"holds {sorted(n for n in host_names if '/' in n)} on {card}")
        if (len(paths) != 1 or not all(recorded.values()) or step_spans < 2
                or not {"train/data_wait", "train/step", "train/checkpoint",
                        "resilience/rollback"} <= host_names):
            raise AssertionError("[resilience] the profile or the tracer export lacks "
                                 "the flash kernels or the train spans")
    except BaseException:
        for proc, _ in (watchdog, preempted):  # every process it starts stops
            proc.kill()
            proc.communicate()
        shutil.rmtree(lm_dir, ignore_errors=True)
        raise
    finally:
        trace.configure(enabled=False)
        faults.install_plan("")
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()

    # (7) exit codes of the LM workload in subprocesses: the preempted run
    # and the watchdog's (started with the phase), then the rerun
    try:
        rc, _, err, secs = _lm_workload_wait(preempted)
        gens = Checkpointer(lm_dir).all_steps()
        log(f"[resilience] LM workload ({LM_LAYERS_PREEMPT} layers, d "
            f"{TRAIN['d_model']}, seq {TRAIN['seq_len']}, batch {TRAIN['batch_size']}, "
            f"flash, bf16, {LM_STEPS} steps) with DDLT_FAULTS=preempt@{LM_PREEMPT}: "
            f"exit {rc}, generations "
            f"{gens}, {secs:.1f} s on {card}")
        if rc != 75 or gens != [LM_PREEMPT]:
            raise AssertionError(f"[resilience] preempted LM: exit {rc}, {gens}\n{err[-3000:]}")
        rc, _, err, secs = _lm_workload("", argv)
        gens = Checkpointer(lm_dir).all_steps()
        resumed = f"resuming from step {LM_PREEMPT}" in err
        log(f"[resilience] rerun without faults: exit {rc}, resumed from "
            f"{LM_PREEMPT}: {resumed}, generations {gens}, {secs:.1f} s on {card}")
        if rc != 0 or not resumed or LM_STEPS not in gens:
            raise AssertionError(f"[resilience] resumed LM: exit {rc}, {gens}\n{err[-3000:]}")
    finally:
        shutil.rmtree(lm_dir, ignore_errors=True)
        rc, _, err, secs = _lm_workload_wait(watchdog, timeout=300)
    stacks = "ddlt watchdog: no step progress" in err and "File " in err
    log(f"[resilience] LM workload at its defaults with --step_deadline_s "
        f"{WATCHDOG['deadline_s']} and DDLT_FAULTS=data_stall@{WATCHDOG['stall_at']}:"
        f"secs={WATCHDOG['stall_s']}: exit {rc}, stacks on stderr {stacks}, "
        f"{secs:.1f} s on {card}")
    if rc != 70 or not stacks:
        raise AssertionError(f"[resilience] watchdog: exit {rc}\n{err[-3000:]}")
    out["launches"] = counts
    return out


def phase_moe_bert(torch, np, fa, card):
    """bert-base with a mixture of MOE_EXPERTS experts in every second layer
    through ``workloads.bert.main(num_experts=8, attention="flash")`` at its
    defaults (bf16, batch 8, seq 128, dropout 0.1), cut to 4 batches: the
    loss finite, the load-balance term and the share of token-slots dropped
    over capacity (from the router's own counts), step p50 and peak memory,
    exact launches of the bias kernels; then the f32 forward (eval, flash)
    on the card against the port on the CPU from the same weights: each MoE
    layer's expert choices compared first (flips reported), then the logits
    of the rows no flip reaches within MOE_LOGIT_RTOL."""
    from distributeddeeplearning_tpu_torch.models import bert as tbert
    from distributeddeeplearning_tpu_torch.models import moe
    from distributeddeeplearning_tpu_torch.train.state import tree_leaves, tree_map
    from distributeddeeplearning_tpu_torch.workloads import bert as wbert

    aux, kept, slots, gates = [], [], [], []
    real_mlp, real_route = moe.moe_mlp, moe.route

    def recording_mlp(*args, **kwargs):
        y, term = real_mlp(*args, **kwargs)
        if term is not None:
            aux.append(term.detach())
        return y, term

    def recording_route(*args, **kwargs):
        r = real_route(*args, **kwargs)
        kept.append(r.kept.sum())
        slots.append(r.gate_idx.shape[1] * r.n)
        gates.append(r.gate_idx)
        return r

    moe.moe_mlp, moe.route = recording_mlp, recording_route
    try:
        state, losses, step_ms, counts, plain, peak_gb = _bert_run(
            torch, np, fa, seq_len=128, attention="flash", dropout_rate=0.1,
            dtype_kw={}, num_experts=MOE_EXPERTS)
        layers, steps = 12, BERT_STEPS
        want = {c: 0 for c in FA_COUNTERS}
        want.update({"launches_bias_bf16": layers * (steps + BERT_EVAL_BATCHES),
                     "launches_dq_bias_bf16": layers * steps,
                     "launches_dkv_bias_bf16": layers * steps})
        if counts != want or plain:
            raise AssertionError(f"[moe-bert] launches {counts}, plain calls {plain} "
                                 f"(expected {want}, 0)")
        n_moe = sum(tbert.uses_moe(tbert.BertConfig(num_experts=MOE_EXPERTS), i)
                    for i in range(layers))
        terms = torch.stack(aux).float().cpu()
        if len(aux) != n_moe * steps or not torch.isfinite(terms).all():
            raise AssertionError(f"[moe-bert] {len(aux)} load-balance terms, "
                                 f"expected {n_moe * steps}")
        dropped = 1.0 - float(torch.stack(kept).sum().item()) / sum(slots)
        p50 = float(np.median(step_ms[1:]))
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        log(f"[moe-bert] bert-base, {MOE_EXPERTS} experts in {n_moe} of {layers} "
            f"layers, bf16 B=8 S=128 flash dropout 0.1: {n_params / 1e6:.1f} M params; "
            f"loss by step {[round(x, 5) for x in losses]}; load-balance term by step "
            f"(mean over the MoE layers) "
            f"{[round(float(x), 5) for x in terms.view(steps, n_moe).mean(1)]}; "
            f"token-slots dropped over capacity {dropped:.2%} (train and eval "
            f"passes); step p50 {p50:.2f} ms (CUDA-event spans, steps 2..{steps}), "
            f"peak memory {peak_gb:.2f} GB; launches {counts} on {card}")
        del state
        torch.cuda.empty_cache()

        # f32, card against CPU, routing compared first
        cfg = tbert.BertConfig(num_experts=MOE_EXPERTS, dropout_rate=0.0)
        host = tbert.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
        batch = next(wbert._batches(8, 128, cfg.vocab_size, cfg.num_classes, 42, 8,
                                    is_training=False))
        out, routes = {}, {}
        for dev in ("cpu", "cuda"):
            gates.clear()
            params = tree_map(lambda t: t.to(dev, copy=True), host)
            with torch.no_grad():
                logits = tbert.forward(
                    params, torch.as_tensor(batch["input"], device=dev), config=cfg,
                    dtype=torch.float32, attention_fn=fa.make_flash_attention(),
                    train=False,
                    attention_mask=torch.as_tensor(batch["attention_mask"], device=dev))
            out[dev] = logits.double().cpu().numpy()
            routes[dev] = [g.cpu() for g in gates]
    finally:
        moe.moe_mlp, moe.route = real_mlp, real_route
    flips = [(a != c).any(-1) for a, c in zip(routes["cpu"], routes["cuda"])]
    flipped_rows = set()
    for f in flips:
        flipped_rows |= set((f.nonzero().flatten() // 128).tolist())
    rows = [r for r in range(8) if r not in flipped_rows]
    ref = out["cpu"]
    err = (float(np.abs(out["cuda"][rows] - ref[rows]).max() / np.abs(ref).max())
           if rows else float("nan"))
    log(f"[moe-bert] f32 eval forward (flash), card against CPU: expert choices "
        f"flipped for {[int(f.sum()) for f in flips]} of {8 * 128} tokens in each MoE "
        f"layer (rows reached {sorted(flipped_rows)}); logits of the other rows "
        f"{err:.3e} of the largest |logit| (limit {MOE_LOGIT_RTOL:g}) on {card}")
    if len(flips) != n_moe or not rows or not err <= MOE_LOGIT_RTOL:
        raise AssertionError("[moe-bert] the card's f32 MoE forward left the CPU's")
    return {"p50_ms": p50, "dropped": dropped}


# ---- data parallelism (phase 26) --------------------------------------------

DP_STEPS = 3  # global batches of TRAIN's 8 rows, the same in every run
DP_LAYERS = 4  # (b)'s LM: TRAIN's width cut to 4 layers (the script's depth cut)
DP_SEED = 42  # the LM workload's seed: weights and token streams
DP_PEAK_LR = 3e-4  # the LM workload's base_lr
# per-step losses of two data-parallel runs of the same batches, relative:
# another summation order of the gradient (and the bf16 wire's rounding,
# fed back) moves the params by a fraction of a bf16-compute step
DP_LOSS_RTOL = 1e-2
# params after the last step, of the summed learning rates: an AdamW
# update is at most ~lr an element a step, and a gradient near 0 whose
# sign differs between two summation orders moves its element by up to
# that much; the median element must sit far closer
DP_PARAM_TOL = 2.0
DP_PARAM_MEDIAN_TOL = 1e-2
DP_BENCH = dict(model="resnet50", batch_size=64, image_size=224,
                num_warmup_batches=2, num_iters=2, num_batches_per_iter=2)
DP_WORKER_TIMEOUT = 420  # seconds a spawned rank may take


def _dp_batches(np):
    """DP_STEPS global batches of TRAIN's rows: the LM workload's token
    stream (seed DP_SEED)."""
    from distributeddeeplearning_tpu_torch.workloads import transformer

    b = TRAIN["batch_size"]
    return list(transformer._token_batches(b, TRAIN["seq_len"], TRAIN["vocab_size"],
                                           DP_SEED, b * DP_STEPS, repeat=False))


def _dp_lm_fit(torch, mesh, dev, batches, **kw):
    """The LM workload's model, optimizer and schedule (TRAIN's width cut to
    DP_LAYERS layers, bf16, flash, AdamW without a clip) trained on
    ``batches`` (global: each rank
    takes its rows) through ``build_train_step(mesh=mesh, **kw)``.
    Returns (state, per-step losses, per-step CUDA-event ms, the step)."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward,
        init_params,
        next_token_loss,
    )
    from distributeddeeplearning_tpu_torch.ops.flash_attention import (
        make_flash_attention,
    )
    from distributeddeeplearning_tpu_torch.parallel import shard_batch
    from distributeddeeplearning_tpu_torch.train.schedule import (
        warmup_linear_decay_schedule,
    )
    from distributeddeeplearning_tpu_torch.train.state import TrainState, adamw, tree_map
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    width = {**{k: TRAIN[k] for k in ("d_model", "num_heads", "d_ff", "vocab_size")},
             "num_layers": DP_LAYERS}
    params = init_params(torch.Generator().manual_seed(DP_SEED),
                         max_len=TRAIN["seq_len"], device=dev, **width)
    attention_fn = make_flash_attention(mesh=mesh, causal=True)

    def apply_fn(p, tokens, **_):
        p = tree_map(lambda a: a.to(torch.bfloat16), p)
        return forward(p, tokens, num_heads=TRAIN["num_heads"],
                       attention_fn=attention_fn).float()

    schedule = warmup_linear_decay_schedule(DP_PEAK_LR, len(batches))
    state = TrainState.create(params=params, apply_fn=apply_fn,
                              tx=adamw(schedule, grad_clip_norm=0.0))
    step = build_train_step(
        state, mesh=mesh, schedule=schedule, compute_dtype=torch.bfloat16,
        loss_fn=lambda lg, lb, label_smoothing=0.0: next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss}, **kw)
    if kw.get("comm_overlap"):
        state = step.prepare_state(state)
    losses, marks = [], []
    for batch in batches:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        state, metrics = step(state, shard_batch(mesh, batch))
        losses.append(metrics["loss"].detach())
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return state, [x.item() for x in losses], step_ms, step


def _param_gap(torch, params, ref):
    """(max |p - ref|, median |p - ref|) over every element of the LM's
    params (nested dicts of tensors, ``ref`` on any device)."""
    from distributeddeeplearning_tpu_torch.train.state import tree_zip

    diffs = [(a.detach().float() - b.to(a.device).float()).abs().reshape(-1)
             for a, b in tree_zip(params, ref)]
    whole = torch.cat(diffs)
    return whole.max().item(), whole.median().item()


class _LaunchShapes:
    """Records the batch size (``batches``) and the batch size and heads
    (``shapes``) of every K1, K2 and K3 launch and counts the plain
    versions' calls, by wrapping the flash module's launchers."""

    def __init__(self, fa):
        self.fa, self.batches, self.shapes, self.plain = fa, [], [], 0
        self._orig = (fa._launch, fa._bwd_launch, fa._dense_attention,
                      fa._dense_attention_bwd)

    def __enter__(self):
        fa, (launch, bwd, dense, dense_bwd) = self.fa, self._orig

        def launch_w(q, *a, **k):
            self.batches.append(("fwd", q.shape[0]))
            self.shapes.append(("fwd", q.shape[0], q.shape[2]))
            return launch(q, *a, **k)

        def bwd_w(kind, q, *a, **k):
            self.batches.append((kind, q.shape[0]))
            self.shapes.append((kind, q.shape[0], q.shape[2]))
            return bwd(kind, q, *a, **k)

        def plain(fn):
            def wrapper(*a, **k):
                self.plain += 1
                return fn(*a, **k)
            return wrapper

        fa._launch, fa._bwd_launch = launch_w, bwd_w
        fa._dense_attention, fa._dense_attention_bwd = plain(dense), plain(dense_bwd)
        return self

    def __exit__(self, *exc):
        (self.fa._launch, self.fa._bwd_launch, self.fa._dense_attention,
         self.fa._dense_attention_bwd) = self._orig


def _dp_lm_rank(torch, np, rank, world, ref_path):
    """Rank ``rank`` of phase 26(b): the f32 wire, then the bf16 wire with
    weight-update sharding, on its 4 rows of each global batch."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.parallel import collectives, create_mesh

    mesh = create_mesh()
    ref = torch.load(ref_path, map_location="cpu")
    batches = _dp_batches(np)
    out, f32_params = {}, None
    for name, kw in DP_WIRES:
        for c in FA_COUNTERS:
            setattr(fa, c, 0)
        collectives.reset_staged()
        torch.cuda.reset_peak_memory_stats()
        with _LaunchShapes(fa) as shapes:
            state, losses, step_ms, step = _dp_lm_fit(torch, mesh, "cuda:0", batches,
                                                      comm_overlap=True, **kw)
        gap = _param_gap(torch, state.params, ref)
        entry = {
            "losses": losses, "step_ms": step_ms, "gap": gap,
            "counts": {c: getattr(fa, c) for c in FA_COUNTERS},
            "launch_batches": sorted(set(shapes.batches)), "plain": shapes.plain,
            "staged": collectives.staged_ops(), "wire": step.wire_bytes(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        if f32_params is None:
            f32_params = _detached_copy(torch, state.params)
        else:
            entry["vs_f32_wire"] = _param_gap(torch, state.params, f32_params)
        out[name] = entry
        del state, step
        torch.cuda.empty_cache()
    return out


def _detached_copy(torch, tree, device=None):
    """A private copy of a nested dict of tensors (on ``device``)."""
    if isinstance(tree, dict):
        return {k: _detached_copy(torch, v, device) for k, v in tree.items()}
    return tree.detach().to(device or tree.device, copy=True)


DP_WIRES = (("f32-wire", {}),
            ("bf16-wire-wus", {"comm_dtype": "bf16", "weight_update_sharding": True}))


def _dp_lm_bench_rank(torch, np, rank, world, ref_path):
    """Rank ``rank`` of phase 26 (b), then of (c), in one spawn."""
    lm = _dp_lm_rank(torch, np, rank, world, ref_path)
    torch.cuda.empty_cache()
    return {"lm": lm, "bench": _dp_bench_rank(torch, np, rank, world)}


def _dp_bench_rank(torch, np, rank, world):
    """Rank ``rank`` of phase 26(c): the reference's synthetic benchmark
    with ``distributed=True``."""
    from distributeddeeplearning_tpu_torch.workloads import benchmark

    torch.cuda.reset_peak_memory_stats()
    result = benchmark.main(distributed=True, device="cuda:0", **DP_BENCH)
    return {"per_rank": result.img_sec_per_chip_mean, "ci": result.img_sec_per_chip_ci95,
            "total": result.img_sec_total, "num_devices": result.num_devices,
            "iter_s": result.iter_times_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _dp_worker(job, rank, world, port, args, results):
    """One spawned rank: joins a gloo group of ``world`` on localhost with
    the card's device 0 (the ranks share it) and runs ``job``."""
    try:
        import numpy as np
        import torch

        from distributeddeeplearning_tpu_torch.parallel import distributed

        distributed.initialize(force=True, coordinator_address=f"127.0.0.1:{port}",
                               num_processes=world, process_id=rank, backend="gloo",
                               device="cuda:0")
        set_peaks(torch)
        try:
            out = globals()[job](torch, np, rank, world, *args)
        finally:
            distributed.shutdown()
        results.put((rank, "ok", out))
    except BaseException:  # the parent fails the phase with it
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_ranks(job: str, world: int, *args, timeout: float = DP_WORKER_TIMEOUT):
    """``job`` of this module in ``world`` processes started by
    ``torch.multiprocessing`` spawn; each rank's result, in rank order.  A
    rank that fails or outlives ``timeout`` seconds fails the call, and
    every rank is stopped before it returns."""
    import queue

    import torch.multiprocessing as mp

    from distributeddeeplearning_tpu_torch.parallel.distributed import free_port

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_dp_worker, args=(job, r, world, port, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, status, out = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{job}: ranks {sorted(set(range(world)) - set(got))}"
                                   f" outlived {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"{job}: rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


class _Recorded:
    """A train step that keeps each step's loss (a device tensor) in
    ``losses``; the step's other attributes (``prepare_state``,
    ``wire_bytes``, ...) pass through."""

    def __init__(self, step):
        self.step, self.losses = step, []

    def __call__(self, state, batch):
        state, metrics = self.step(state, batch)
        self.losses.append(metrics["loss"].detach())
        return state, metrics

    def __getattr__(self, name):
        return getattr(self.step, name)


def _recording_build(tstep, built):
    """A ``build_train_step`` that appends each step it builds, as a
    :class:`_Recorded`, to ``built``."""
    original = tstep.build_train_step

    def build(*args, **kwargs):
        built.append(_Recorded(original(*args, **kwargs)))
        return built[-1]
    return build


def phase_data_parallel(torch, np, F, fa, card):
    """Phase 26 (module docstring): NCCL at a world of 1, a world of 2 over
    gloo on the one card, and the distributed flagship benchmark.  Returns
    (the K1-K3 launch counts of its runs, the bf16 K1-K3 entries at the
    per-rank shape B=4)."""
    import tempfile

    from distributeddeeplearning_tpu_torch.parallel import (
        collectives,
        create_mesh,
        distributed,
    )
    from distributeddeeplearning_tpu_torch.train import step as tstep
    from distributeddeeplearning_tpu_torch.workloads import transformer

    layers = TRAIN["num_layers"]
    bf16 = {"fwd": "launches_bf16", "dq": "launches_dq_bf16", "dkv": "launches_dkv_bf16"}
    launches = {}
    # (a) NCCL at a world of 1 -------------------------------------------
    t0 = time.perf_counter()
    address = f"127.0.0.1:{distributed.free_port()}"
    ctx = distributed.initialize(force=True, num_processes=1, process_id=0,
                                 coordinator_address=address, device="cuda")
    if ctx.backend != "nccl":
        raise AssertionError(f"expected an NCCL group on the card, got {ctx.backend}")
    runs = {}
    configs = (("comm-bf16-wus-accum2", dict(comm_overlap=True, comm_dtype="bf16",
                                              weight_update_sharding=True,
                                              accum_steps=2)),
               ("implicit", {}))
    try:
        for name, kw in configs:
            built = []
            original = tstep.build_train_step
            tstep.build_train_step = _recording_build(tstep, built)
            try:
                for c in FA_COUNTERS:
                    setattr(fa, c, 0)
                collectives.reset_staged()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                r0 = time.perf_counter()
                # one repeated batch, one eval batch an epoch
                state, result = transformer.main(
                    epochs=DP_STEPS, steps_per_epoch=1,
                    train_examples=TRAIN["batch_size"], attention="flash",
                    grad_clip_norm=0.0, distributed=True, device="cuda", **TRAIN,
                    **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - r0
                counts = {c: getattr(fa, c) for c in FA_COUNTERS}
            finally:
                tstep.build_train_step = original
            micro = kw.get("accum_steps", 1)
            want = {c: 0 for c in FA_COUNTERS}
            want.update({bf16["fwd"]: layers * (micro + 1) * DP_STEPS,
                         bf16["dq"]: layers * micro * DP_STEPS,
                         bf16["dkv"]: layers * micro * DP_STEPS})
            if counts != want:
                raise AssertionError(f"[dp-nccl] {name}: launches {counts}, "
                                     f"expected {want}")
            step = built[0]
            losses = [x.item() for x in step.losses]
            wire = (step.wire_bytes() if kw.get("comm_overlap")
                    else "implicit: one all-reduce of the gradient tree a step")
            staged = collectives.staged_ops()
            if staged:
                raise AssertionError(f"[dp-nccl] NCCL staged {staged} through the host")
            log(f"[dp-nccl] {name}: world 1, backend nccl, losses by step "
                f"{[round(x, 5) for x in losses]}, launches {counts} (12 a "
                f"forward: {micro} microbatch(es) a step + 1 eval), wall "
                f"{wall:.2f} s, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
                f" GB; wire bytes a step {wire}; staged through the host: none")
            runs[name] = losses
            launches[f"dp_nccl_{name}"] = {k: counts[v] for k, v in bf16.items()}
            del state, result
        a, b = runs["comm-bf16-wus-accum2"], runs["implicit"]
        rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
        log(f"[dp-nccl] comm_overlap (bf16 wire, WUS, accum 2) vs implicit: "
            f"|dloss| / loss by step {[f'{x:.2e}' for x in rel]} (tolerance "
            f"{DP_LOSS_RTOL:g})")
        if len(a) != DP_STEPS or len(b) != DP_STEPS or max(rel) > DP_LOSS_RTOL:
            raise AssertionError("[dp-nccl] the two paths' losses parted")
        log(f"[time] phase_data_parallel (a): {time.perf_counter() - t0:.1f} s")

        # the one-process implicit fit (b) is held to, on the NCCL mesh
        t0 = time.perf_counter()
        batches = _dp_batches(np)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, ref_losses, ref_ms, _ = _dp_lm_fit(torch, create_mesh(), ctx.device,
                                                  batches)
        ref_params = _detached_copy(torch, state.params, "cpu")
        ref_peak = torch.cuda.max_memory_allocated() / 1e9
        del state
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    lr_sum = _lr_sum(DP_STEPS)
    log(f"[dp-gloo] one-process implicit fit (B=8, world 1): losses "
        f"{[round(x, 5) for x in ref_losses]}, step ms {[round(x, 1) for x in ref_ms]}, "
        f"peak memory {ref_peak:.2f} GB on {card}")

    # (b) a world of 2 over gloo on the one card -------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref_params.pt")
        torch.save(ref_params, ref_path)
        # (c)'s benchmark runs on the same two ranks after (b): one spawn
        both = run_ranks("_dp_lm_bench_rank", 2, ref_path)
    ranks, bench = [b["lm"] for b in both], [b["bench"] for b in both]
    for rank, out in enumerate(ranks):
        for name, entry in out.items():
            want = {c: 0 for c in FA_COUNTERS}
            want.update({v: DP_LAYERS * DP_STEPS for v in bf16.values()})
            if entry["counts"] != want or entry["plain"]:
                raise AssertionError(f"[dp-gloo] rank {rank} {name}: launches "
                                     f"{entry['counts']}, plain calls {entry['plain']}")
            if entry["launch_batches"] != [("dkv", 4), ("dq", 4), ("fwd", 4)]:
                raise AssertionError(f"[dp-gloo] rank {rank} {name}: launches at "
                                     f"batch sizes {entry['launch_batches']}, not 4")
            rel = [abs(x - y) / abs(y) for x, y in zip(entry["losses"], ref_losses)]
            gap_max, gap_med = entry["gap"]
            p50 = float(np.median(entry["step_ms"][1:]))
            log(f"[dp-gloo] rank {rank} {name}: losses "
                f"{[round(x, 5) for x in entry['losses']]} (|dloss| / loss vs the "
                f"one-process fit {[f'{x:.2e}' for x in rel]}, tolerance "
                f"{DP_LOSS_RTOL:g}); params vs it: max {gap_max:.3e}, median "
                f"{gap_med:.3e} (summed lr {lr_sum:.3e}); step ms "
                f"{[round(x, 1) for x in entry['step_ms']]}, p50 (steps 2..) "
                f"{p50:.1f} against {float(np.median(ref_ms[1:])):.1f} for the "
                f"one-process step at B=8; K1/K2/K3 launches "
                f"{[entry['counts'][v] for v in bf16.values()]} at B=4, plain 0; "
                f"staged through the host by gloo: {entry['staged']}; wire bytes "
                f"a step {entry['wire']}; peak memory {entry['peak_gb']:.2f} GB on "
                f"{card}")
            if "vs_f32_wire" in entry:
                log(f"[dp-gloo] rank {rank}: the bf16 wire's params after "
                    f"{DP_STEPS} steps vs the f32 wire's: max "
                    f"{entry['vs_f32_wire'][0]:.3e}, median {entry['vs_f32_wire'][1]:.3e}")
            if (len(rel) != DP_STEPS or max(rel) > DP_LOSS_RTOL
                    or gap_max > DP_PARAM_TOL * lr_sum
                    or gap_med > DP_PARAM_MEDIAN_TOL * lr_sum):
                raise AssertionError(f"[dp-gloo] rank {rank} {name} left the "
                                     "one-process fit")
            launches[f"dp_gloo_rank{rank}_{name}"] = {
                k: entry["counts"][v] for k, v in bf16.items()}
    # the kernels at the per-rank shape the ranks launched them at
    per_rank = _flash_at(torch, F, fa, TRAIN["d_model"] // TRAIN["num_heads"],
                         TRAIN["num_heads"], TRAIN["batch_size"] // 2,
                         TRAIN["seq_len"], torch.bfloat16, card)
    for kern, entry in per_rank.items():
        entry["launches_a_rank_a_step"] = DP_LAYERS
    log(f"[dp-gloo] the bf16 K1, K2, K3 at the per-rank shape (B=4, as each "
        f"rank launched them, {DP_LAYERS} each a step): "
        f"{ {k: round(e['ms'], 4) for k, e in per_rank.items()} } ms, bounds "
        f"{ {k: round(e['bound_ms'], 4) for k, e in per_rank.items()} } ms on {card}")

    # (c) the flagship benchmark over 2 gloo ranks on the one card ------
    for rank, out in enumerate(bench):
        if out["num_devices"] != 2 or not out["per_rank"] > 0:
            raise AssertionError(f"[dp-bench] rank {rank}: {out}")
        log(f"[dp-bench] rank {rank}: {DP_BENCH['model']} bf16 batch "
            f"{DP_BENCH['batch_size']} a rank, {DP_BENCH['image_size']} px: "
            f"{out['per_rank']:.1f} +-{out['ci']:.1f} img/s a rank, "
            f"{out['total']:.1f} img/s in total over 2 ranks (windows "
            f"{[round(x, 3) for x in out['iter_s']]} s), peak memory "
            f"{out['peak_gb']:.2f} GB on {card}")
    log("[dp-bench] two ranks share one card: not a scaling figure")
    log(f"[time] phase_data_parallel (b) and (c): {time.perf_counter() - t0:.1f} s")
    return launches, per_rank


# ---- tensor-parallel serving (phase 27) ------------------------------------

TP_DEGREE = 2
TP_LOCAL_HEADS = SERVE["num_heads"] // TP_DEGREE
TP_WORKER_TIMEOUT = 420  # seconds a spawned TP rank may take (five runs)
TP_RUNS = (  # name, KV layout, weights, engine options: phase 27 (a)-(e)
    ("dense_f32", "dense", "f32", {}),
    ("paged_f32", "paged", "f32", {}),
    ("paged_int8", "paged", "f32", {"cache_dtype": "int8"}),
    ("dense_bf16", "dense", "bf16", {}),
    ("dense_int8_weights", "dense", "int8", {}),
)
TP_PROFILE_STEPS = 10  # decode steps of the dense f32 run's breakdown
# the TP runs' token budget: a quarter of the serving cells', since every
# decode step pays the ranks' gloo round trips (the script's depth cut)
TP_NEW_TOKENS = NEW_TOKENS // 4


def tp_layers(name: str) -> int:
    """A TP run's depth: every run at the first 3 of the serving cells' 12
    layers of the same weights (the script's depth cut: a forward pays 2 L
    + 1 gloo all-reduces a rank)."""
    del name
    return SERVE["num_layers"] // 4


#: prefill shape of K1-K3 over the local heads: one 512-token prompt
TP_FLASH = dict(b=1, s=512, d=64)


def _tp_params(torch, weights, layers=SERVE["num_layers"]):
    """The serving cells' weights (``serve_params``), their first
    ``layers`` blocks, as f32, bf16 (every leaf cast) or int8
    (``quantize_params``: int8 matmul weights)."""
    from distributeddeeplearning_tpu_torch.quant.calibrate import quantize_params
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    params = serve_params(torch)
    params["blocks"] = {k: v[:layers].contiguous() for k, v in params["blocks"].items()}
    if weights == "bf16":
        return tree_map(lambda t: t.to(torch.bfloat16), params)
    if weights == "int8":
        return quantize_params(params)
    return params


def _tree_bytes(tree) -> int:
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves

    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))


class _TPLaunches:
    """Records (heads, queries) of every K4 launch and the heads of every
    K1 launch, and counts the plain versions' calls, by wrapping the
    launchers of the decode and flash modules."""

    def __init__(self, fa, fd):
        self.fa, self.fd, self.k4, self.k1, self.plain = fa, fd, [], [], 0
        self._orig = (fd._launch, fa._launch, fd._paged_attention_plain, fd._attend,
                      fa._dense_attention)

    def __enter__(self):
        k4_launch, k1_launch = self._orig[:2]

        def k4(q4, *a, **k):
            self.k4.append((q4.shape[2], q4.shape[1]))
            return k4_launch(q4, *a, **k)

        def k1(q, *a, **k):
            self.k1.append(q.shape[2])
            return k1_launch(q, *a, **k)

        def plain(fn):
            def wrapper(*a, **k):
                self.plain += 1
                return fn(*a, **k)
            return wrapper

        self.fd._launch, self.fa._launch = k4, k1
        (self.fd._paged_attention_plain, self.fd._attend,
         self.fa._dense_attention) = (plain(f) for f in self._orig[2:])
        return self

    def __exit__(self, *exc):
        (self.fd._launch, self.fa._launch, self.fd._paged_attention_plain,
         self.fd._attend, self.fa._dense_attention) = self._orig


def _tp_step_profile(torch, np, engine):
    """Where a decode step's time goes (every slot prefilled with 300
    tokens, ``TP_PROFILE_STEPS`` steps at position 300), ms a step: the
    host wall and the host time inside the collectives (a host clock
    around each call of ``parallel.collectives``: a synchronous gloo
    collective waits for the card, stages through host memory and waits
    for the other rank), then, in a second window, the device's kernel
    time from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from distributeddeeplearning_tpu_torch.parallel import collectives

    toks, pos = fill_slots(np, engine, np.random.default_rng(5))
    engine.decode(toks, pos)
    torch.cuda.synchronize()
    spent = [0.0]
    originals = {n: getattr(collectives, n)
                 for n in ("all_reduce", "all_reduce_max", "all_gather")}

    def clocked(fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t
        return call

    for n, fn in originals.items():
        setattr(collectives, n, clocked(fn))
    try:
        t0 = time.perf_counter()
        for _ in range(TP_PROFILE_STEPS):
            engine.decode(toks, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TP_PROFILE_STEPS
    finally:
        for n, fn in originals.items():
            setattr(collectives, n, fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TP_PROFILE_STEPS):
            engine.decode(toks, pos)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(((e.key, e.self_device_time_total / 1e3 / TP_PROFILE_STEPS)
                  for e in events), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall, "collective_host_ms": spent[0] * 1e3 / TP_PROFILE_STEPS,
            "kernel_ms": kernels / TP_PROFILE_STEPS if kernels else None,
            "top": [(k[:60], ms) for k, ms in top]}


def _forced_logits(torch, engine, prompts, streams):
    """Teacher-forced logits of ``engine``'s prefill path (its weights, its
    mesh: ``forward_prefill`` with flash attention) over each prompt and
    the given stream: the rows that chose each generated token, per uid,
    in the weights' dtype."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward_prefill,
    )

    out = {}
    with torch.inference_mode():
        for uid, prompt in prompts.items():
            seq = list(prompt) + streams[uid][:-1]
            logits, _, _ = forward_prefill(
                engine.params, torch.tensor([seq], device="cuda:0"),
                num_heads=SERVE["num_heads"], attention="flash", mesh=engine.mesh)
            out[uid] = logits[0, len(prompt) - 1:]
    return out


def _tp_run(torch, np, fa, fd, run, tp, forced=None):
    """One run of phase 27 on ``tensor_parallel_engine(tp=tp)`` on cuda:0
    (``tp=1``: the plain engine): a warm-up as ``serve_engine``'s, then the
    serving cell's requests with every counter zeroed just before and read
    just after; with ``forced`` (tp=1's streams), the engine's
    teacher-forced logits over them too (as int16 bit patterns of the
    bf16 values).  Returns plain values."""
    from distributeddeeplearning_tpu_torch.parallel import collectives
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, tensor_parallel_engine,
    )

    name, layout, weights, kw = run
    opts = dict(kv_layout=layout, num_heads=SERVE["num_heads"], batch_slots=SLOTS,
                max_seq=MAX_SEQ, device="cuda:0", **kw)
    if layout == "paged":
        opts.update(page_size=PAGE, prefill_chunk=CHUNK)
    torch.cuda.reset_peak_memory_stats()
    params = _tp_params(torch, weights, tp_layers(name))
    full_bytes = _tree_bytes(params)
    engine, mesh = tensor_parallel_engine(params, tp=tp, **opts)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1 if layout == "dense" else 3)
    warm = (64, 128, 256, 512) if layout == "dense" else (72, 200)
    ContinuousBatchingScheduler(engine, max_new_tokens=2).run(
        [Request(uid=f"warm{n}", prompt=rng.integers(1, SERVE["vocab_size"], n).tolist())
         for n in warm])
    if layout == "paged":
        engine.reset_stats()
        engine.clear_prefix_cache()
    requests = serve_requests(np, layout)
    collectives.reset_counts()
    collectives.reset_staged()
    torch.cuda.synchronize()
    with _TPLaunches(fa, fd) as launched:
        results, report = ContinuousBatchingScheduler(
            engine, max_new_tokens=TP_NEW_TOKENS).run(requests)
        torch.cuda.synchronize()
    out = {
        "tokens": {r.uid: r.tokens for r in results}, "finish": report.finish_reasons,
        "hit_rate": report.prefix_hit_rate, "tp": report.tp,
        "layout_rules": report.layout_rules, "decode_steps": report.decode_steps,
        "prefills": engine.chunks_run if layout == "paged" else len(requests),
        "decode_p50_ms": report.decode_step_s["p50"] * 1e3,
        "ttft_p50_ms": report.ttft_s["p50"] * 1e3, "tokens_per_s": report.tokens_per_sec,
        "counts": collectives.counts(), "staged": collectives.staged_ops(),
        "k4": sorted(set(launched.k4)), "k4_launches": len(launched.k4),
        "k4_multi_query": sum(nq > 1 for _, nq in launched.k4),
        "k1": sorted(set(launched.k1)), "k1_launches": len(launched.k1),
        "plain": launched.plain, "param_bytes": _tree_bytes(engine.params),
        "full_param_bytes": full_bytes, "kv_bytes": engine.kv_bytes(),
        "kv_heads": engine.cache["k"].shape[3], "mesh": mesh is not None,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if name == "dense_f32":
        out["profile"] = _tp_step_profile(torch, np, engine)
    if forced is not None:
        prompts = {r.uid: r.prompt for r in requests}
        out["forced"] = {uid: t.view(torch.int16).cpu().numpy() for uid, t in
                         _forced_logits(torch, engine, prompts, forced).items()}
    del engine
    torch.cuda.empty_cache()
    return out


def _tp_rank(torch, np, rank, world, runs, forced):
    """Rank ``rank`` of phase 27: every run of ``runs`` at ``tp=world``
    (``forced``: tp=1's streams of the bf16 runs, by run)."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import flash_decode as fd

    out = {run[0]: _tp_run(torch, np, fa, fd, run, world, forced.get(run[0]))
           for run in runs}
    out["jax_loaded"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    return out


def _tp_mesh(rank):
    """Rank ``rank``'s mesh of ``tensor=TP_DEGREE``, built without a
    process group: the attention wrappers take its shape and rank only."""
    from distributeddeeplearning_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh

    shape = dict.fromkeys(AXIS_ORDER, 1)
    shape["tensor"] = TP_DEGREE
    return Mesh(shape=shape, size=TP_DEGREE, rank=rank)


def _local(t, rank, dim):
    """Rank ``rank``'s heads of ``t`` along ``dim``, contiguous (as a rank
    allocates its own cache)."""
    per = t.shape[dim] // TP_DEGREE
    return t.narrow(dim, rank * per, per).contiguous()


def _k4d(torch, F, fd, card):
    """K4(d): K4 over each rank's 6 heads of the dense [8, 12, 576, 12, 64]
    cache (f32, bf16 and int8 pages; bf16 q on bf16 pages as the bf16
    engine runs it, the int8 own-token overlay), through the wrappers'
    ``mesh=``: held against its plain version (K4_TOL; bf16 by hold_bf16
    too) and bitwise against the all-heads launch's rows for those heads;
    the f32 run timed beside its plain version, SDPA over the local heads
    and its bound, and the bf16 and int8 runs beside their bounds.
    Returns the JSON row's entry."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    slots, layers, s, h, hd = SLOTS, SERVE["num_layers"], MAX_SEQ, SERVE["num_heads"], 64
    g = torch.Generator(device="cuda").manual_seed(27)
    cache = {"k": torch.randn((slots, layers, s, h, hd), generator=g, device="cuda"),
             "v": torch.randn((slots, layers, s, h, hd), generator=g, device="cuda")}
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    qkv = torch.randn((slots, 3, h, hd), generator=g, device="cuda")
    variants = {}
    for pages in ("f32", "bf16", "int8"):
        if pages == "int8":
            kq, ks = quantize_kv(cache["k"])
            vq, vs = quantize_kv(cache["v"])
            full = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
            q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        else:
            dt = torch.bfloat16 if pages == "bf16" else torch.float32
            full = {n: t.to(dt) for n, t in cache.items()}
            q3, k_t, v_t = (qkv[:, i].to(dt) for i in range(3))
        variants[pages] = (full, q3, k_t, v_t)
    worst, bitwise, views = 0.0, True, {}
    for pages, (full, q3, k_t, v_t) in variants.items():
        int8 = pages == "int8"
        own = (k_t, v_t) if int8 else (None, None)
        local = [{n: _local(t, r, 3) for n, t in full.items()} for r in range(TP_DEGREE)]
        views[pages] = [
            [tuple(loc[n][:, i] if n in loc else None
                   for n in ("k", "v", "k_scale", "v_scale")) for i in range(layers)]
            for loc in local]
        for layer in (0, layers - 1):
            lv = tuple(full[n][:, layer] if n in full else None
                       for n in ("k", "v", "k_scale", "v_scale"))
            all_heads = fd.decode_attention_dense(q3, *lv, *own, pos)
            for r in range(TP_DEGREE):
                q_r = _local(q3, r, 1)
                own_r = tuple(None if t is None else _local(t, r, 1) for t in own)
                got = fd.decode_attention_dense(q_r, *views[pages][r][layer], *own_r,
                                                pos, mesh=_tp_mesh(r))
                posmat = pos.reshape(-1, 1)
                plain = fd._attend_f32(q_r[:, None], *fd._dense_history(
                    *views[pages][r][layer], *own_r, posmat), posmat)[:, 0]
                torch.cuda.synchronize()
                err = (got - plain).abs().max().item()
                same = torch.equal(got, all_heads[:, r * TP_LOCAL_HEADS:
                                                  (r + 1) * TP_LOCAL_HEADS])
                if pages == "bf16":
                    hold_bf16(got, plain, plain.float(), f"K4(d) bf16 rank {r}")
                log(f"[k4d] {pages} pages layer {layer} rank {r} (heads "
                    f"{r * TP_LOCAL_HEADS}..{(r + 1) * TP_LOCAL_HEADS - 1}): max|kernel "
                    f"- plain| {err:.3e} (tolerance {K4_TOL:g}); bitwise the all-heads "
                    f"launch's rows: {same}")
                worst, bitwise = max(worst, err), bitwise and same
                if not bool(torch.isfinite(got).all()) or err > K4_TOL or not same:
                    raise AssertionError(f"K4(d) {pages} rank {r} disagrees")
    # timed on rank 0's heads, alone on the card, cycling through the layers
    q0 = {p: _local(v[1], 0, 1) for p, v in variants.items()}
    own0 = {p: (_local(v[2], 0, 1), _local(v[3], 0, 1)) if p == "int8" else (None, None)
            for p, v in variants.items()}
    mesh0 = _tp_mesh(0)

    def run(pages):
        return lambda i: fd.decode_attention_dense(
            q0[pages], *views[pages][0][i % layers], *own0[pages], pos, mesh=mesh0)

    ms = {p: device_ms(torch, run(p), iters=120) for p in views}
    loop_ms = cuda_ms(torch, run("f32"), iters=120)
    plain_ms = device_ms(torch, lambda i: fd._gather_decode_dense(
        q0["f32"], *views["f32"][0][i % layers], None, None, pos), iters=60)
    mask = (torch.arange(s, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    lib = {p: [(k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))
               for k, v, _, _ in views[p][0]] for p in ("f32", "bf16")}
    lib_ms = {p: device_ms(torch, lambda i, p=p: F.scaled_dot_product_attention(
        q0[p][:, :, None], *lib[p][i % layers], attn_mask=mask), iters=60)
        for p in lib}
    hist = float((pos.long() + 1).sum().item())
    hl = TP_LOCAL_HEADS
    io = slots * hl * hd  # one query and one output row a slot and head
    bounds = {
        "f32": bound_ms(4.0 * (2 * hist * hl * hd + 2 * io) + 4.0 * 2 * slots,
                        4.0 * hist * hl * hd),
        "bf16": bound_ms(2.0 * 2 * hist * hl * hd + 2.0 * io + 4.0 * io + 4.0 * slots,
                         4.0 * hist * hl * hd),
        "int8": bound_ms(2 * hist * hl * (hd + 4) + 4.0 * 3 * io + 4.0 * io + 4.0 * slots,
                         4.0 * hist * hl * hd),
    }
    log(f"[k4d] per-rank shape b=8 h={hl} hd=64 S=576 (rank 0's heads): f32 pages "
        f"{ms['f32']:.4f} ms ({loop_ms:.4f} ms a launch in an event-timed loop), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms['f32']:.4f} ms, bound {bounds['f32'][0]:.4f} "
        f"ms ({bounds['f32'][1]}); bf16 pages {ms['bf16']:.4f} ms (sdpa bf16 "
        f"{lib_ms['bf16']:.4f}, bound {bounds['bf16'][0]:.4f}); int8 pages + overlay "
        f"{ms['int8']:.4f} ms (bound {bounds['int8'][0]:.4f}); all-heads rows bitwise: "
        f"{bitwise}; device times, alone on {card}")
    del cache, variants, views, lib
    torch.cuda.empty_cache()
    return dict(ms=ms["f32"], plain_ms=plain_ms, bound_ms=bounds["f32"][0],
                bound_by=bounds["f32"][1], library_ms=lib_ms["f32"], max_abs_err=worst,
                bf16_ms=ms["bf16"], bf16_bound_ms=bounds["bf16"][0],
                bf16_library_ms=lib_ms["bf16"], int8_ms=ms["int8"],
                int8_bound_ms=bounds["int8"][0], bitwise_all_heads=bitwise,
                shape=f"b=8 nq=1 h={hl} (a rank's heads of 12) hd=64 S=576 dense "
                      "layer views, pos 0..575; f32, bf16 (bf16 q) and int8 pages")


def _flash_bounds(b, h, s, d, bf):
    """(K1, K2, K3) bounds at a causal [b, s, h, d] shape: the bytes read
    and written once and the products of the visible pairs over the split
    TF32 rate (f32) or the dense bf16 rate."""
    peak = BF16_FLOPS_PER_S if bf else TF32X3_FLOPS_PER_S
    es = 2.0 if bf else 4.0
    pairs = b * h * _causal_pairs(s)
    head = es * b * s * h * d
    rows_in = 4 * head + 2 * 4.0 * b * h * s
    return {"fwd": bound_ms(4 * head + 4.0 * b * h * s, 4.0 * d * pairs, peak),
            "dq": bound_ms(rows_in + head, 6.0 * d * pairs, peak),
            "dkv": bound_ms(rows_in + 2 * head, 8.0 * d * pairs, peak)}


def _flash_tp(torch, F, fa, card):
    """K1-K3 through ``make_flash_attention(mesh)`` over each rank's 6
    heads at the prefill shape (B=1, S=512, D=64, causal; f32 and bf16),
    the local q, k, v strided views of the rank's own qkv projection:
    held against their plain versions (``_hold_flash``) and against the
    all-heads kernels' rows for those heads (output and gradients), then
    timed on rank 0's heads beside the plain versions, SDPA and the
    bounds.  Returns {dtype: {kernel: entry}}."""
    b, s, d = TP_FLASH["b"], TP_FLASH["s"], TP_FLASH["d"]
    h, hl = SERVE["num_heads"], TP_LOCAL_HEADS
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        g = torch.Generator(device="cuda").manual_seed(28)
        qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").to(dtype)
        do = torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype)
        full = qkv.clone().requires_grad_(True)
        q, k, v = (t.reshape(b, s, h, d) for t in full.split(h * d, dim=-1))
        o_all = fa.flash_attention(q, k, v, None, causal=True)
        (o_all.float() * do.float()).sum().backward()
        worst, same = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}, True
        for r in range(TP_DEGREE):
            cols = [j * h * d + r * hl * d for j in range(3)]
            mine = torch.cat([qkv[..., c:c + hl * d] for c in cols], -1)
            mine = mine.clone().requires_grad_(True)
            ql, kl, vl = (t.reshape(b, s, hl, d) for t in mine.split(hl * d, dim=-1))
            fn = fa.make_flash_attention(mesh=_tp_mesh(r), causal=True)
            o = fn(ql, kl, vl, None, dtype=dtype)
            (o.float() * _local(do, r, 2).float()).sum().backward()
            grad_all = torch.cat([full.grad[..., c:c + hl * d] for c in cols], -1)
            torch.cuda.synchronize()
            rows = (torch.equal(o, o_all[:, :, r * hl:(r + 1) * hl]),
                    torch.equal(mine.grad, grad_all))
            errs, (lse, _, do_r, delta, _) = _hold_flash(
                torch, fa, ql.detach(), kl.detach(), vl.detach(), True, seed=29 + r,
                what=f"{'bf16' if bf else 'f32'} local heads rank {r}")
            worst = {kern: max(worst[kern], e) for kern, e in errs.items()}
            same = same and all(rows)
            log(f"[flash-tp] {'bf16' if bf else 'f32'} rank {r}: K1-K3 over heads "
                f"{r * hl}..{(r + 1) * hl - 1} held against the plain versions (max "
                f"|kernel - plain| K1 {errs['fwd']:.3e}, K2 {errs['dq']:.3e}, K3 "
                f"{errs['dkv']:.3e}); bitwise the all-heads kernels' rows: output "
                f"{rows[0]}, gradients {rows[1]}")
            if not all(rows):
                # tolerated only within the plain versions' limits: another
                # grid over fewer heads may take another block shape
                err = (o.float() - o_all[:, :, r * hl:(r + 1) * hl].float()).abs().max()
                if err.item() > (bf16_ulp(o_all.float()) if bf else K1_TOL):
                    raise AssertionError(f"K1 over local heads rank {r}: {err.item()}")
            if r == 0:
                times = _time_flash(torch, F, fa, ql.detach(), kl.detach(), vl.detach(),
                                    do_r, lse, delta, causal=True)
        bounds = _flash_bounds(b, hl, s, d, bf)
        fwd_ms, fwd_plain, fwd_lib, dq_ms, dkv_ms, bwd_plain, bwd_lib = times
        shape = (f"B={b} H={hl} (a rank's heads of {h}) S={s} D={d} causal "
                 f"{'bf16' if bf else 'f32'}, strided views of the rank's qkv")
        out["bf16" if bf else "f32"] = {
            kern: dict(ms=ms, plain_ms=pl, bound_ms=bounds[kern][0],
                       bound_by=bounds[kern][1], library_ms=lib,
                       max_abs_err=worst[kern], bitwise_all_heads=same, shape=shape)
            for kern, ms, pl, lib in (("fwd", fwd_ms, fwd_plain, fwd_lib),
                                      ("dq", dq_ms, bwd_plain, bwd_lib),
                                      ("dkv", dkv_ms, bwd_plain, bwd_lib))}
        log(f"[flash-tp] {'bf16' if bf else 'f32'} B={b} H={hl} S={s} causal: K1 "
            f"{fwd_ms:.4f} ms (plain {fwd_plain:.4f}, sdpa {fwd_lib:.4f}, bound "
            f"{bounds['fwd'][0]:.4f} {bounds['fwd'][1]}), K2 {dq_ms:.4f} ms (bound "
            f"{bounds['dq'][0]:.4f}), K3 {dkv_ms:.4f} ms (bound {bounds['dkv'][0]:.4f}),"
            f" plain backward {bwd_plain:.4f}, sdpa backward {bwd_lib:.4f}; device "
            f"times, alone on {card}")
    return out


def _hold_bf16_streams(torch, np, name, one, got):
    """Run (d)'s check (module docstring, phase 27).  bf16 greedy decoding
    meets exact ties: tp=1's own logits hold top-2 gaps of 0 and of one
    bf16 ulp, where any other order of the row-parallel sums may pick the
    other token.  So the tp=2 path's teacher-forced logits over tp=1's
    streams are held to tp=1's by the bf16 rule (``hold_bf16``: against
    the f32 logits of the same weights, at most twice tp=1's error plus
    one ulp), and a tp=2 stream may leave tp=1's only at a token whose tp=1
    logit lies within that rule's limit of the row's largest.  Returns
    (worst error, its limit, the divergences)."""
    from distributeddeeplearning_tpu_torch.serve import tensor_parallel_engine
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    prompts = {r.uid: r.prompt for r in serve_requests(np, "dense")}
    params = _tp_params(torch, "bf16", tp_layers(name))
    engine, _ = tensor_parallel_engine(params, tp=1, num_heads=SERVE["num_heads"],
                                       batch_slots=SLOTS, max_seq=MAX_SEQ,
                                       device="cuda:0")
    plain = _forced_logits(torch, engine, prompts, one["tokens"])
    engine.params = tree_map(lambda t: t.float(), engine.params)
    ref = _forced_logits(torch, engine, prompts, one["tokens"])
    del engine, params
    worst, where = (0.0, 0.0), []
    for uid, want in one["tokens"].items():
        tp2 = torch.from_numpy(got["forced"][uid]).view(torch.bfloat16).to("cuda:0")
        err, _, limit = hold_bf16(tp2, plain[uid], ref[uid].float(),
                                  f"tensor-parallel {name} {uid} logits")
        worst = max(worst, (err, limit))
        have = got["tokens"][uid]
        if have != want:
            i = next(j for j, (a, b) in enumerate(zip(want, have)) if a != b)
            row = plain[uid][i].float()
            gap = (row.max() - row[have[i]]).item()
            where.append((uid, i, want[i], have[i], gap))
            if gap > limit:
                raise AssertionError(
                    f"tensor-parallel {name} {uid}: the stream leaves tp=1's at "
                    f"position {i} ({want[i]} -> {have[i]}) where tp=1's top logit "
                    f"leads by {gap}, beyond the bf16 limit {limit}")
    return worst, where


def phase_tensor_parallel(torch, np, F, fa, fd, card, runs=TP_RUNS):
    """Phase 27 (module docstring): the serve model over two gloo ranks
    sharing the card through ``tensor_parallel_engine(tp=2)``, held to the
    one-process engine run for run; then K4(d) and K1-K3 over local heads
    alone on the card.  Returns (the runs' per-rank results, the K4(d)
    entry, the K1-K3 entries)."""
    t0 = time.perf_counter()
    single = {run[0]: _tp_run(torch, np, fa, fd, run, 1) for run in runs}
    forced = {name: single[name]["tokens"] for name, _, weights, _ in runs
              if weights == "bf16"}
    t1 = time.perf_counter()
    ranks = run_ranks("_tp_rank", TP_DEGREE, runs, forced, timeout=TP_WORKER_TIMEOUT)
    t2 = time.perf_counter()
    log(f"[tp] tp=1 runs {t1 - t0:.1f} s in this process; tp={TP_DEGREE} over "
        f"{TP_DEGREE} spawned gloo ranks on cuda:0 {t2 - t1:.1f} s (two ranks share "
        f"one card: not a scaling figure)")
    if any(out["jax_loaded"] for out in ranks):
        raise AssertionError("a TP rank loaded jax")
    for name, layout, weights, _ in runs:
        one, got = single[name], [out[name] for out in ranks]
        layers = tp_layers(name)
        forwards = got[0]["prefills"] + got[0]["decode_steps"]
        want_counts = {"all_reduce": (2 * layers + 1) * forwards, "all_gather": forwards}
        if weights == "int8":
            want_counts["all_reduce_max"] = 2 * layers * forwards
        k4_want = layers * forwards if layout == "paged" else layers * got[0]["decode_steps"]
        k1_want = 0 if layout == "paged" else layers * got[0]["prefills"]
        for r, run in enumerate(got):
            checks = {
                "tokens == tp=1": weights == "bf16" or run["tokens"] == one["tokens"],
                "finish": run["finish"] == {"length": REQUESTS},
                "report tp": run["tp"] == TP_DEGREE and run["mesh"],
                f"KV heads {TP_LOCAL_HEADS}": run["kv_heads"] == TP_LOCAL_HEADS,
                "K4 launches": run["k4_launches"] == k4_want,
                f"K4 over {TP_LOCAL_HEADS} heads": {hd for hd, _ in run["k4"]}
                <= {TP_LOCAL_HEADS},
                "K4 chunks": run["k4_multi_query"] == (
                    layers * run["prefills"] if layout == "paged" else 0),
                "K1 launches": run["k1_launches"] == k1_want and set(run["k1"]) <= {
                    TP_LOCAL_HEADS},
                "no plain version": run["plain"] == 0,
                "collectives": run["counts"] == want_counts,
                "staged": run["staged"] == {"all_gather": forwards},
                "same forwards": (run["prefills"], run["decode_steps"]) == (
                    got[0]["prefills"], got[0]["decode_steps"]),
            }
            if layout == "paged":
                checks["hit rate == tp=1, > 0"] = (run["hit_rate"] == one["hit_rate"]
                                                   and run["hit_rate"] > 0)
            log(f"[tp] {name} rank {r}: {layers} layers, {forwards} forwards "
                f"({run['prefills']} "
                f"{'chunks' if layout == 'paged' else 'prefills'}, {run['decode_steps']} "
                f"decode steps); K4 {run['k4_launches']} launches {run['k4']} (heads, "
                f"queries), K1 {run['k1_launches']}, plain {run['plain']}; collectives "
                f"{run['counts']} (expected {want_counts}), staged through the host "
                f"{run['staged']}; a forward: "
                f"{ {op: n / forwards for op, n in run['counts'].items()} }")
            failed = [what for what, ok in checks.items() if not ok]
            if failed:
                raise AssertionError(f"tensor-parallel {name} rank {r}: {failed}")
        if got[0]["tokens"] != got[1]["tokens"]:
            raise AssertionError(f"{name}: the ranks' streams differ")
        if weights == "bf16":
            (err, limit), where = _hold_bf16_streams(torch, np, name, one, got[0])
            log(f"[tp] {name}: teacher-forced logits over tp=1's streams within the "
                f"bf16 rule (worst {err:.4f}, limit {limit:.4f}); "
                f"{sum(got[0]['tokens'][u] == t for u, t in one['tokens'].items())} of "
                f"{REQUESTS} streams == tp=1's, the others leave it only where tp=1's "
                f"top logit leads the tp=2 token by no more than the limit: (uid, "
                f"position, tp=1 token, tp=2 token, lead) {where}")
        log(f"[tp] {name}: tokens of both ranks {'vs' if weights == 'bf16' else '=='} "
            f"tp=1's ({REQUESTS} requests x {TP_NEW_TOKENS}); prefix hit rate {got[0]['hit_rate']} (tp=1 "
            f"{one['hit_rate']}); params a rank {got[0]['param_bytes'] / 1e6:.1f} MB of "
            f"{one['param_bytes'] / 1e6:.1f} MB at tp=1, KV a rank "
            f"{got[0]['kv_bytes'] / 1e6:.1f} MB of {one['kv_bytes'] / 1e6:.1f} MB; "
            f"decode step p50 {got[0]['decode_p50_ms']:.2f} / {got[1]['decode_p50_ms']:.2f}"
            f" ms a rank (tp=1 {one['decode_p50_ms']:.2f}), TTFT p50 "
            f"{got[0]['ttft_p50_ms']:.2f} / {got[1]['ttft_p50_ms']:.2f} ms (tp=1 "
            f"{one['ttft_p50_ms']:.2f}), tokens/s {got[0]['tokens_per_s']} / "
            f"{got[1]['tokens_per_s']} (tp=1 {one['tokens_per_s']}); peak memory "
            f"{got[0]['peak_gb']:.2f} / {got[1]['peak_gb']:.2f} GB a rank (tp=1 "
            f"{one['peak_gb']:.2f}, the full weights built first included) on {card}")
    for r, out in enumerate(ranks + [single]):
        p = out.get("dense_f32", {}).get("profile")
        if p is not None:
            log(f"[tp] dense f32 decode step (8 slots, pos 300) "
                f"{f'rank {r}' if r < len(ranks) else 'at tp=1'}: host wall "
                f"{p['wall_ms']:.3f} ms, of it inside collectives "
                f"{p['collective_host_ms']:.3f} ms; kernels {p['kernel_ms']} ms (a "
                f"profiled window); top kernels {p['top']} on {card}")
    k4d = _k4d(torch, F, fd, card)
    flash = _flash_tp(torch, F, fa, card)
    return ranks, k4d, flash


# -- phase 28: robust serving --------------------------------------------------

#: (a) the reference's overload traffic (bench.py:3052-3057) and burst
#: (OVERLOAD_r19.json's spec), replayed in real time
ROBUST_TENANTS = (("premium", 1.5), ("standard", 1.0), ("best_effort", 1.0))
ROBUST_BURST = "burst@1:tenant=best_effort:rps=40:secs=4:at=0.5"
ROBUST_SECS = 8.0  # bench.py --overload's schedule length
ROBUST_PROMPT, ROBUST_NEW = 16, 16  # its longest prompt and its token budget
ROBUST_SLOTS = 8
# pages for 2.5 of every 3 slots' worst case (a request's prompt and budget
# fit one 64-position page), as the reference sizes its scarce pool
ROBUST_PAGES = -(-ROBUST_SLOTS * 5 // 6)
# the explicit ledger capacity: the engine's committed bytes at rest plus
# this many requests' worst-case pages — the forecast gates admission
ROBUST_FORECAST_REQUESTS = 3
#: (b) the reference's TIER recipe (bench.py:3300-3345) at page 64
# the reference's TIER recipe at one measured round after the seed round
# (the recipe's 3 cut to 1: the script's time budget)
TIER_SESSIONS, TIER_ROUNDS, TIER_PREFIX_PAGES, TIER_NEW = 24, 1, 4, 4
FIDELITY_PROMPTS = 8  # (e): the first 8 of the paged cell's 16 prompts
TIER_TIMED_PAGES = 16  # pages a transfer time is averaged over
#: (d) the watchdog's deadline and the injected stall
ROBUST_WATCHDOG_S, ROBUST_STALL_S = 0.4, 1.0
#: (e) the reference's gate on int8-KV teacher-forced agreement
INT8_AGREEMENT_GATE = 0.99


#: every phase-28 run's launches, by run, for the kernels line
ROBUST_LAUNCHES = {}


def _robust_counts(fa, fd, engine, run):
    """Run ``run()`` with every counter zeroed just before and read just
    after; returns ``(its value, counts)``: K4 launches (all, int8,
    multi-query), K1 launches, the plain versions' calls, and the chunks
    the engine ran."""
    import torch

    _zero_counters(fa, fd)
    chunks0 = getattr(engine, "chunks_run", 0)
    torch.cuda.synchronize()
    with _TPLaunches(fa, fd) as rec:
        out = run()
        torch.cuda.synchronize()
    return out, {"k4": fd.launches, "k4_int8": fd.launches_int8,
                 "k4_multi_query": fd.launches_multi_query, "k1": fa.launches,
                 "plain": rec.plain,
                 "chunks": getattr(engine, "chunks_run", 0) - chunks0}


def _hold_counts(name, counts, *, steps, prefills=0, int8=False):
    """Exact launches of a serving run: K4 a layer for every chunk and
    every decode step (multi-query: the chunks), K1 a layer for every
    dense prefill, the plain versions never."""
    layers = SERVE["num_layers"]
    want = {"k4": layers * (counts["chunks"] + steps),
            "k4_int8": layers * (counts["chunks"] + steps) if int8 else 0,
            "k4_multi_query": layers * counts["chunks"], "k1": layers * prefills,
            "plain": 0}
    got = {k: counts[k] for k in want}
    ROBUST_LAUNCHES[name] = got
    log(f"[robust] {name}: launches {got} (expected {want}: {counts['chunks']} "
        f"chunks, {steps} decode steps, {prefills} dense prefills)")
    if got != want:
        raise AssertionError(f"{name}: unexpected launch counts {got}")


def _tie_or_raise(torch, params, prompt, got, want, what):
    """A resumed stream that leaves the uninterrupted one: held to a tie
    within the f32 rule at the first differing token — the two tokens'
    logits from one dense forward over the common history within
    ``LOGIT_RTOL`` of the largest |logit| — else a failure."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import forward

    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    toks = torch.tensor([list(prompt) + list(want[:i])], device="cuda")
    with torch.inference_mode():
        row = forward(params, toks, num_heads=SERVE["num_heads"],
                      attention="dense")[0, -1].float()
    gap = (row[got[i]] - row[want[i]]).abs().item()
    scale = row.abs().max().item()
    log(f"[robust] {what}: leaves the uninterrupted stream at token {i} "
        f"({got[i]} for {want[i]}): logit gap {gap:.3e}, largest |logit| "
        f"{scale:.3f}, tie rule {LOGIT_RTOL:g} of it")
    if not gap <= LOGIT_RTOL * scale:
        raise AssertionError(f"{what}: departure at token {i} is not a tie")


def _hold_streams(torch, params, prompts, got, want, what):
    """Each stream of ``got`` equals ``want``'s, or leaves it at a tie;
    returns how many left."""
    ties = 0
    for uid, toks in got.items():
        if toks != want[uid]:
            _tie_or_raise(torch, params, prompts[uid], toks, want[uid], f"{what} {uid}")
            ties += 1
    return ties


def _ledger_frame(torch, tag, extra_ledger=None):
    """The process ledger's reconciled frame, printed: owners, committed
    bytes, the host owners outside the forecast and the residual against
    ``torch.cuda.memory_allocated()`` beside the reference's 5% limit."""
    import gc

    from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger

    gc.collect()
    snap = get_ledger().snapshot()
    owners = {k: (v["bytes"], v["committed_bytes"]) for k, v in snap["owners"].items()}
    verdict = {True: "within", False: "over", None: "not measured"}[
        snap["residual_under_limit"]]
    log(f"[ledger] {tag}: owners (bytes, committed) {owners}; committed "
        f"{snap['committed_total_bytes']} of {snap['total_bytes']}; host owners "
        f"{snap['host_owners']} (outside the forecast); allocated "
        f"{snap['live_bytes']}, unaccounted {snap['unaccounted_bytes']} = "
        f"{snap['unaccounted_pct']}% (the reference's limit "
        f"{snap['residual_limit_pct']}%: {verdict}; allocated bytes include "
        f"every tensor of the process, the owners' or not)")
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None and snap["live_bytes"] is not None:
        # cuBLAS's workspaces come from the caching allocator and no owner
        # claims them: how much of the residual they are
        clear()
        again = get_ledger().snapshot()
        log(f"[ledger] {tag}: with cuBLAS's workspaces freed: allocated "
            f"{again['live_bytes']}, unaccounted {again['unaccounted_bytes']} = "
            f"{again['unaccounted_pct']}%")
    if extra_ledger is not None:
        forecast = extra_ledger.forecast(0)
        log(f"[ledger] {tag}: the run's explicit ledger: capacity "
            f"{forecast['capacity_bytes']}, committed {forecast['committed_bytes']}, "
            f"headroom {forecast['headroom_bytes']}, peak committed "
            f"{extra_ledger.peak_committed_bytes}")
    return snap


def _robust_overload(torch, np, fa, fd, card, params):
    """(a) overload: three tenants in real time, a best-effort burst, the
    forecast as the binding constraint."""
    from distributeddeeplearning_tpu_torch.obs.ledger import HBMLedger
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, PagedInferenceEngine, Request, TenantSpec,
        TrafficGenerator, poll_source,
    )
    from distributeddeeplearning_tpu_torch.serve.engine import _register_engine_owners
    from distributeddeeplearning_tpu_torch.utils import faults

    max_seq = ROBUST_PROMPT + ROBUST_NEW
    engine = PagedInferenceEngine(params, num_heads=SERVE["num_heads"],
                                  batch_slots=ROBUST_SLOTS, max_seq=max_seq,
                                  page_size=PAGE, num_pages=ROBUST_PAGES,
                                  prefill_chunk=CHUNK)
    rng = np.random.default_rng(5)
    ContinuousBatchingScheduler(engine, max_new_tokens=2).run(  # warm-up
        [Request(uid=f"w{n}", prompt=rng.integers(1, SERVE["vocab_size"], n).tolist())
         for n in (5, 12, 20, 31)])
    engine.reset_stats()
    engine.clear_prefix_cache()
    ledger = HBMLedger()
    _register_engine_owners(engine, ledger=ledger)
    ledger.set_capacity(ledger.committed_bytes()
                        + ROBUST_FORECAST_REQUESTS * engine.admit_bytes(ROBUST_PROMPT,
                                                                        ROBUST_NEW))
    tenants = tuple(TenantSpec(name=n, priority=n, rate_rps=r, arrival="poisson",
                               prompt_min=2, prompt_max=ROBUST_PROMPT)
                    for n, r in ROBUST_TENANTS)
    plan = faults.install_plan(ROBUST_BURST)
    try:
        schedule = TrafficGenerator(tenants, vocab_size=SERVE["vocab_size"],
                                    seed=0).schedule(ROBUST_SECS)
        if [e.kind for e in plan.events] != ["burst"]:
            raise AssertionError("the burst spec never fired")
    finally:
        faults.install_plan("")
    offered = {}
    for tr in schedule:
        offered[tr.request.priority] = offered.get(tr.request.priority, 0) + 1
    log(f"[robust] (a) overload: {len(schedule)} requests over {ROBUST_SECS} s "
        f"{offered} ({ROBUST_BURST}), {ROBUST_SLOTS} slots, {ROBUST_PAGES} pages of "
        f"{PAGE}, ledger capacity = committed + {ROBUST_FORECAST_REQUESTS} "
        f"requests' pages ({ledger.capacity_bytes} bytes)")
    sched = ContinuousBatchingScheduler(engine, max_new_tokens=ROBUST_NEW,
                                        shed_policy="shed", preempt_budget=2,
                                        hbm_ledger=ledger)
    (results, report), counts = _robust_counts(
        fa, fd, engine, lambda: sched.run([], poll=poll_source(schedule)))
    _hold_counts("(a) overload", counts, steps=report.decode_steps)
    if sorted(r.uid for r in results) != sorted(tr.request.uid for tr in schedule):
        raise AssertionError("(a): a request reached no terminal state, or two")
    bad = {r.finish_reason for r in results} - {"length", "eos", "shed", "preempted"}
    if bad:
        raise AssertionError(f"(a): unexpected finish reasons {bad}")
    for cls, row in sorted(report.per_class.items()):
        log(f"[robust] (a) {cls}: {row['requests']} requests, finish "
            f"{row['finish_reasons']}, TTFT p50 {row['ttft_s']['p50'] * 1e3:.1f} ms p99 "
            f"{row['ttft_s']['p99'] * 1e3:.1f} ms, TPOT p50 "
            f"{row['tpot_s']['p50'] * 1e3:.2f} ms p99 {row['tpot_s']['p99'] * 1e3:.2f} ms,"
            f" sheds {row['shed']}, preemptions {row['preemptions']} on {card}")
    hints = [r.retry_after_s for r in results if r.finish_reason == "shed"]
    log(f"[robust] (a) sheds {len(hints)}, preemptions {report.preemptions}, "
        f"retry_after_s min {min(hints, default=None)} max {max(hints, default=None)}"
        f"; decode step p50 {report.decode_step_s['p50'] * 1e3:.3f} ms, "
        f"{report.decode_steps} steps, wall {report.wall_s} s")
    if any(r.finish_reason == "shed" and r.priority != "best_effort" for r in results):
        raise AssertionError("(a): a class above best_effort was shed")
    if any(h is None or h <= 0 for h in hints):
        raise AssertionError("(a): a shed came without a retry hint")
    engine.allocator.check()
    if engine.allocator.pages_in_use:
        raise AssertionError("(a): pages leaked")
    # each preempted stream against the same request served alone
    resumed = [r for r in results if r.preemptions and r.finish_reason == "length"]
    by_uid = {tr.request.uid: tr.request for tr in schedule}
    alone = {}
    for r in resumed:
        res, _ = ContinuousBatchingScheduler(engine, max_new_tokens=ROBUST_NEW).run(
            [Request(uid=r.uid, prompt=list(by_uid[r.uid].prompt))])
        alone[r.uid] = res[0].tokens
    ties = _hold_streams(torch, params, {u: by_uid[u].prompt for u in alone},
                         {r.uid: r.tokens for r in resumed}, alone, "(a) resumed")
    log(f"[robust] (a) {len(resumed)} resumed streams (each cut at least once), "
        f"{len(resumed) - ties} equal to the request served alone, {ties} at a tie")
    frame = _ledger_frame(torch, "(a)", ledger)
    out = {"counts": counts, "report": report, "resumed": len(resumed), "ties": ties,
           "ledger": frame}
    del engine, sched
    return out


def _tier_transfer_ms(torch, dtype):
    """Per-page D2H (spill) and H2D (restore + pool write) times by CUDA
    events on a standalone pool of the serving geometry."""
    from distributeddeeplearning_tpu_torch.serve import HostPageTier, init_paged_cache

    heads = SERVE["num_heads"]
    pool = init_paged_cache(num_pages=TIER_TIMED_PAGES, num_layers=SERVE["num_layers"],
                            page_size=PAGE, num_heads=heads,
                            head_dim=SERVE["d_model"] // heads, dtype=dtype,
                            device="cuda")
    tier = HostPageTier(pool, TIER_TIMED_PAGES)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    tier.spill_in(pool, "warm", 1)
    tier.dispatch_restore("warm")
    tier.drain()
    torch.cuda.synchronize()
    ev[0].record()
    for p in range(1, TIER_TIMED_PAGES + 1):
        tier.spill_in(pool, p, p)
    ev[1].record()
    ev[2].record()
    for p in range(1, TIER_TIMED_PAGES + 1):
        for name, t in tier.dispatch_restore(p).items():
            pool[name][p].copy_(t)
    ev[3].record()
    ev[3].synchronize()
    tier.drain()
    tier.check()
    d2h = ev[0].elapsed_time(ev[1]) / TIER_TIMED_PAGES
    h2d = ev[2].elapsed_time(ev[3]) / TIER_TIMED_PAGES
    nbytes = tier.page_host_bytes
    return {"page_bytes": nbytes, "d2h_ms": d2h, "h2d_ms": h2d,
            "d2h_gb_s": nbytes / d2h / 1e6, "h2d_gb_s": nbytes / h2d / 1e6}


def _robust_tier(torch, np, fa, fd, card, params):
    """(b) the host tier: the reference's TIER recipe at page 64, f32 and
    int8, tiered and untiered."""
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, PagedInferenceEngine, Request,
    )

    vocab, heads = SERVE["vocab_size"], SERVE["num_heads"]
    prefix_len = TIER_PREFIX_PAGES * PAGE
    prompt_len = prefix_len + 1
    max_seq = prompt_len + 16 + PAGE  # the recipe's fits_tokens 16 + a page
    req_pages = -(-(prompt_len + TIER_NEW) // PAGE)
    num_pages = 2 * req_pages + 1  # barely two concurrent sequences
    host_pages = TIER_SESSIONS * TIER_PREFIX_PAGES + 4

    def paged(dtype, tiered, pages=num_pages):
        return PagedInferenceEngine(
            params, num_heads=heads, batch_slots=2, max_seq=max_seq, page_size=PAGE,
            num_pages=pages, prefill_chunk=CHUNK, cache_dtype=dtype,
            host_pages=host_pages if tiered else 0)

    def run(engine, reqs, name):
        (res, rep), counts = _robust_counts(fa, fd, engine, lambda: ContinuousBatchingScheduler(
            engine, max_new_tokens=TIER_NEW).run(
                [Request(uid=u, prompt=list(p)) for u, p in reqs]))
        _hold_counts(name, counts, steps=rep.decode_steps,
                     prefills=0 if engine.kv_layout == "paged" else len(reqs),
                     int8=engine.kv_dtype == "int8")
        return {r.uid: r.tokens for r in res}, rep, counts

    rng = np.random.default_rng(7)
    base = rng.integers(1, vocab, 2 * PAGE).tolist()
    # ends mid-chunk and mid-page (152, 216) and one past a page (257)
    bit_reqs = [(f"bit{i}", base + rng.integers(1, vocab, n - 2 * PAGE).tolist())
                for i, n in enumerate((152, 216, prompt_len))]
    prefixes = [rng.integers(1, vocab, prefix_len).tolist() for _ in range(TIER_SESSIONS)]

    def round_requests(r):
        return [(f"s{s}r{r}", prefixes[s] + [1 + (7 * s + 13 * r) % (vocab - 2)])
                for s in range(TIER_SESSIONS)]

    out = {"counts": {}}
    dense = InferenceEngine(params, num_heads=heads, batch_slots=2, max_seq=max_seq)
    dense_tokens, _, out["counts"]["dense"] = run(dense, bit_reqs, "(b) dense")
    del dense
    for dtype in ("float32", "int8"):
        tag = "f32" if dtype == "float32" else "int8"
        never, _, _ = run(paged(dtype, False, pages=24), bit_reqs, f"(b) {tag} never")
        eng = paged(dtype, True, pages=24)
        seeded, _, _ = run(eng, bit_reqs, f"(b) {tag} seeded")
        spilled = eng.spill_cold_pages(10**6)
        restored, rep, _ = run(eng, bit_reqs, f"(b) {tag} restored")
        eng.allocator.check()
        eng.tier.check()
        ok = seeded == never and restored == never and spilled > 0 \
            and rep.tier_restored_pages > 0
        if tag == "f32":
            ok = ok and never == dense_tokens
        log(f"[robust] (b) {tag} bit identity: spilled {spilled}, restored "
            f"{rep.tier_restored_pages}, tiered == untiered"
            f"{' == dense' if tag == 'f32' else ''}: {ok}")
        if not ok:
            raise AssertionError(f"(b) {tag}: tiered tokens differ")
        del eng
        runs = {}
        for tiered in (False, True):
            eng = paged(dtype, tiered)
            name = f"(b) {tag} {'tiered' if tiered else 'untiered'}"
            tokens, _, _ = run(eng, round_requests(0), f"{name} seed round")
            eng.reset_stats()
            spilled = restored = 0
            for r in range(1, TIER_ROUNDS + 1):
                toks, rep, counts = run(eng, round_requests(r), f"{name} round {r}")
                tokens.update(toks)
                spilled += rep.tier_spilled_pages
                restored += rep.tier_restored_pages
            eng.allocator.check()
            if eng.tier is not None:
                eng.tier.check()
            runs[tiered] = dict(tokens=tokens, hit=round(eng.prefix_hit_rate(), 4),
                                host=eng.prefix_hit_tokens_host, spilled=spilled,
                                restored=restored, counts=counts)
            if tiered:  # (f): the frame while the tiered engine holds host pages
                out[f"ledger_{tag}"] = _ledger_frame(torch, f"(b) {tag} tiered")
            log(f"[robust] {name}: {TIER_SESSIONS} sessions x {TIER_PREFIX_PAGES} prefix "
                f"pages over {num_pages} pool pages, host pool {host_pages} pages: "
                f"hit rate {runs[tiered]['hit']}, host hit tokens {runs[tiered]['host']},"
                f" spilled {spilled}, restored {restored} in {TIER_ROUNDS} rounds")
            del eng
        if runs[True]["tokens"] != runs[False]["tokens"]:
            raise AssertionError(f"(b) {tag}: tiered session tokens != untiered")
        if not runs[True]["hit"] > runs[False]["hit"]:
            raise AssertionError(f"(b) {tag}: the tier raised no hit rate")
        xfer = _tier_transfer_ms(torch, getattr(torch, dtype))
        log(f"[robust] (b) {tag} page transfers ({xfer['page_bytes']} bytes a page, "
            f"{TIER_TIMED_PAGES} pages, CUDA events): spill D2H {xfer['d2h_ms']:.4f} ms "
            f"({xfer['d2h_gb_s']:.2f} GB/s), restore H2D + pool write "
            f"{xfer['h2d_ms']:.4f} ms ({xfer['h2d_gb_s']:.2f} GB/s) on {card}; "
            f"link {_pcie_link()}")
        out[tag] = dict(bit=ok, runs=runs, xfer=xfer)
    return out


def _pcie_link() -> str:
    """The card's PCIe link as ``nvidia-smi -q`` reports it: the
    generation and width entries of its "GPU Link Info" block."""
    try:
        text = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                              timeout=60, check=True).stdout
    except Exception as exc:  # noqa: BLE001 — the link is context, not a check
        return f"not read ({exc})"
    lines = text.splitlines()
    start = next((i for i, line in enumerate(lines) if "GPU Link Info" in line), None)
    if start is None:
        return "no GPU Link Info in nvidia-smi -q"
    depth = len(lines[start]) - len(lines[start].lstrip())
    out, head = [], ""
    for line in lines[start + 1:]:
        if line.strip() and len(line) - len(line.lstrip()) <= depth:
            break
        if ":" not in line:
            head = line.strip()
        elif head in ("PCIe Generation", "Link Width"):
            key, value = (x.strip() for x in line.split(":", 1))
            out.append(f"{head} {key} {value}")
    return "; ".join(out) or "no generation or width in nvidia-smi -q"


def _robust_reload(torch, np, fa, fd, card, params, params_new):
    """(c) live reload mid-run, dense and paged: requests admitted after
    the barrier equal a fresh engine built from the new weights."""
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, PagedInferenceEngine, Request,
    )

    heads = SERVE["num_heads"]
    rng = np.random.default_rng(11)
    reqs = [Request(uid=f"rl{i}", prompt=rng.integers(
        1, SERVE["vocab_size"], int(n)).tolist()) for i, n in
        enumerate(rng.integers(64, 160, 6))]
    prompts = {r.uid: r.prompt for r in reqs}

    def build(layout, weights):
        kw = dict(num_heads=heads, batch_slots=2, max_seq=256)
        if layout == "dense":
            return InferenceEngine(weights, **kw)
        return PagedInferenceEngine(weights, page_size=PAGE, prefill_chunk=CHUNK, **kw)

    def serve(engine, subset):
        res, _ = ContinuousBatchingScheduler(engine, max_new_tokens=NEW_TOKENS // 2).run(
            [Request(uid=r.uid, prompt=list(r.prompt)) for r in subset])
        return {r.uid: r.tokens for r in res}

    out = {}
    for layout in ("dense", "paged"):
        engine = build(layout, params)
        sched = ContinuousBatchingScheduler(engine, max_new_tokens=NEW_TOKENS // 2)
        done, before = [], []

        def apply_reload(engine=engine, done=done, before=before):
            before.extend(done)  # every request admitted so far has finished
            engine.reload_params(params_new)

        def on_step(step, sched=sched):
            if step == 1:
                sched.request_reload(apply_reload)

        prefills = [0]
        if layout == "dense":
            real = engine.prefill

            def counted(*a, real=real, **k):
                prefills[0] += 1
                return real(*a, **k)

            engine.prefill = counted
        (results, report), counts = _robust_counts(
            fa, fd, engine, lambda: sched.run(
                [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs],
                on_step=on_step, on_complete=lambda r: done.append(r.uid)))
        _hold_counts(f"(c) {layout}", counts, steps=report.decode_steps,
                     prefills=prefills[0])
        got = {r.uid: r.tokens for r in results}
        old_set = [r for r in reqs if r.uid in before]
        new_set = [r for r in reqs if r.uid not in before]
        if not old_set or not new_set or sched.has_pending_reload:
            raise AssertionError(f"(c) {layout}: the reload was no barrier mid-run "
                                 f"({len(old_set)} before, {len(new_set)} after)")
        fresh = serve(build(layout, params_new), new_set)
        old = serve(build(layout, params), old_set)
        ties = _hold_streams(torch, params_new, prompts,
                             {u: got[u] for u in fresh}, fresh, f"(c) {layout} after")
        ties += _hold_streams(torch, params, prompts, {u: got[u] for u in old}, old,
                              f"(c) {layout} before")
        first = new_set[0].uid
        changed = fresh[first] != serve(build(layout, params), new_set[:1])[first]
        log(f"[robust] (c) {layout}: reload applied after {len(old_set)} requests; "
            f"{len(new_set)} admitted after it equal a fresh engine of the new "
            f"weights, the {len(old_set)} before it the old weights' ({ties} at a "
            f"tie); the new weights change {first}'s stream: {changed}")
        if not changed:
            raise AssertionError(f"(c) {layout}: the reload changed nothing")
        out[layout] = counts
        del engine, sched
    return out


class _RaisingDecode:
    """An engine whose ``decode`` raises a RuntimeError on the calls
    numbered in ``fail_at`` (a Python exception, not a CUDA fault)."""

    def __init__(self, engine, fail_at):
        self._engine, self._fail_at, self._calls = engine, set(fail_at), 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def decode(self, tokens, pos):
        self._calls += 1
        if self._calls in self._fail_at:
            raise RuntimeError(f"injected decode failure at call {self._calls}")
        return self._engine.decode(tokens, pos)


def _robust_faults(torch, np, fa, fd, card, params):
    """(d) the serve faults on the paged engine at full width."""
    import threading

    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, PagedInferenceEngine, Request,
    )
    from distributeddeeplearning_tpu_torch.utils import faults

    engine = PagedInferenceEngine(params, num_heads=SERVE["num_heads"], batch_slots=4,
                                  max_seq=256, page_size=PAGE, prefill_chunk=CHUNK)
    rng = np.random.default_rng(13)
    reqs = [Request(uid=f"f{i}", prompt=rng.integers(1, SERVE["vocab_size"], int(n)).tolist())
            for i, n in enumerate(rng.integers(40, 110, 6))]
    prompts = {r.uid: r.prompt for r in reqs}
    new = NEW_TOKENS // 2

    def run(name, spec="", wrap=None, **kw):
        faults.install_plan(spec)
        try:
            eng = wrap(engine) if wrap is not None else engine
            sched = ContinuousBatchingScheduler(eng, max_new_tokens=new, **{
                k: v for k, v in kw.items() if k != "run_kw"})
            (res, rep), counts = _robust_counts(fa, fd, engine, lambda: sched.run(
                [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs],
                **kw.get("run_kw", {})))
        finally:
            faults.install_plan("")
        _hold_counts(f"(d) {name}", counts, steps=rep.decode_steps)
        engine.allocator.check()
        if engine.allocator.pages_in_use:
            raise AssertionError(f"(d) {name}: pages leaked")
        return {r.uid: r for r in res}, rep

    clean, _ = run("clean")
    clean_tokens = {u: r.tokens for u, r in clean.items()}
    out = {}
    got, rep = run("decode_nan@3", "decode_nan@3")
    failed = [u for u, r in got.items() if r.finish_reason == "error"]
    nan_left = any(torch.isnan(leaf.float()).any().item() for leaf in engine.cache.values())
    ok = (rep.quarantined == 1 and len(failed) == 1
          and "non-finite" in got[failed[0]].error
          and got[failed[0]].tokens == clean_tokens[failed[0]][:len(got[failed[0]].tokens)]
          and all(r.tokens == clean_tokens[u] for u, r in got.items() if u not in failed)
          and not nan_left)
    log(f"[robust] (d) decode_nan: quarantined {rep.quarantined}, failed {failed}, the "
        f"rest equal the clean run, no NaN left in the pool (slot scrubbed): {ok}")
    if not ok:
        raise AssertionError("(d) decode_nan")
    fired = {}
    for name, spec in (("decode_stall", f"decode_stall@3:secs={ROBUST_STALL_S}"),
                       ("no stall", "")):
        event = threading.Event()
        run(name, spec, watchdog_deadline_s=ROBUST_WATCHDOG_S,
            watchdog_on_timeout=event.set)
        fired[name] = event.is_set()
    log(f"[robust] (d) watchdog at {ROBUST_WATCHDOG_S} s: fires on a "
        f"{ROBUST_STALL_S} s decode stall: {fired['decode_stall']}, quiet without: "
        f"{not fired['no stall']}")
    if not fired["decode_stall"] or fired["no stall"]:
        raise AssertionError(f"(d) watchdog {fired}")
    got, rep = run("reject_admit@1", "reject_admit@1")
    shed = [u for u, r in got.items() if r.finish_reason == "shed"]
    log(f"[robust] (d) reject_admit@1: shed {shed}, finish {rep.finish_reasons}")
    if len(shed) != 1 or got[shed[0]].tokens or rep.finish_reasons.get("length") != 5:
        raise AssertionError("(d) reject_admit")
    got, rep = run("decode exception", wrap=lambda e: _RaisingDecode(e, {3}))
    ties = _hold_streams(torch, params, prompts, {u: r.tokens for u, r in got.items()},
                         clean_tokens, "(d) requeued")
    log(f"[robust] (d) decode exception at call 3: {rep.decode_retries} requests "
        f"requeued once, finish {rep.finish_reasons}, streams equal the clean run "
        f"({ties} at a tie)")
    if rep.decode_retries < 1 or rep.finish_reasons != {"length": len(reqs)}:
        raise AssertionError("(d) decode exception requeue")
    out["ties"] = ties
    steps = []
    got, rep = run("should_drain", run_kw=dict(
        should_drain=lambda: len(steps) >= 2, on_step=steps.append))
    preempted = [u for u, r in got.items() if r.finish_reason == "preempted"]
    log(f"[robust] (d) should_drain after 2 steps: drained {rep.drained}, finish "
        f"{rep.finish_reasons}")
    if (not rep.drained or not preempted
            or any(got[u].tokens for u in preempted)
            or set(rep.finish_reasons) - {"length", "preempted"}):
        raise AssertionError("(d) drain")
    del engine
    return out


def _robust_int8_fidelity(torch, np, fa, fd, card, params):
    """(e) the reference's teacher-forced per-position agreement of int8 KV
    against f32 (bench.py:1100-1200), through ``capture_logits``."""
    from distributeddeeplearning_tpu_torch.serve import PagedInferenceEngine

    prompts = [list(r.prompt) for r in serve_requests(np, "paged")][:FIDELITY_PROMPTS]
    engines = {dtype: PagedInferenceEngine(
        params, num_heads=SERVE["num_heads"], batch_slots=SLOTS, max_seq=MAX_SEQ,
        page_size=PAGE, prefill_chunk=CHUNK, cache_dtype=dtype, capture_logits=True)
        for dtype in ("float32", "int8")}

    def stream(engine, prompt, teacher=None):
        steps = min(NEW_TOKENS - 1, MAX_SEQ - len(prompt) - 1)
        engine.prefill(0, prompt, max_new_tokens=steps + 1)
        logits = [engine.last_prefill_logits]
        tok, pos = np.zeros(SLOTS, np.int32), np.zeros(SLOTS, np.int32)
        for i in range(steps):
            tok[0] = int(np.argmax((logits if teacher is None else teacher)[i]))
            pos[0] = len(prompt) + i
            engine.decode(tok, pos)
            logits.append(engine.last_logits[0])
        engine.release(0)
        return logits

    counts = {}
    refs, counts["float32"] = _robust_counts(
        fa, fd, engines["float32"], lambda: [stream(engines["float32"], p) for p in prompts])
    q, counts["int8"] = _robust_counts(
        fa, fd, engines["int8"], lambda: [stream(engines["int8"], p, ref)
                                          for p, ref in zip(prompts, refs)])
    for dtype, c in counts.items():
        steps = sum(len(r) - 1 for r in refs)
        _hold_counts(f"(e) {dtype}", c, steps=steps, int8=dtype == "int8")
    agree = n = 0
    maes = []
    for ref, got in zip(refs, q):
        for lr, lq in zip(ref, got):
            maes.append(float(np.abs(lr - lq).mean()))
            agree += int(np.argmax(lr) == np.argmax(lq))
            n += 1
    rate = agree / n
    log(f"[robust] (e) int8 KV vs f32, teacher-forced over {len(prompts)} prompts: "
        f"per-position greedy agreement {rate:.4f} over {n} positions (the "
        f"reference's gate {INT8_AGREEMENT_GATE}: "
        f"{'met' if rate >= INT8_AGREEMENT_GATE else 'NOT met'}), logit MAE mean "
        f"{np.mean(maes):.3e} max {np.max(maes):.3e} on {card}")
    return {"agreement": rate, "positions": n, "counts": counts}


def phase_serve_robust(torch, np, fa, fd, card):
    """Robust serving at the serving geometry: (a) overload with priority
    classes, shedding and lossless preemption; (b) the host page tier;
    (c) live reload; (d) the serve faults; (e) int8-KV fidelity through
    ``capture_logits``; (f) ledger frames after (a) and (b)."""
    t0 = time.perf_counter()
    params = serve_params(torch)
    out = {"overload": _robust_overload(torch, np, fa, fd, card, params)}
    log(f"[time] (a) {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    out["tier"] = _robust_tier(torch, np, fa, fd, card, params)
    log(f"[time] (b) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    params_new = serve_params(torch, seed=1)
    out["reload"] = _robust_reload(torch, np, fa, fd, card, params, params_new)
    del params_new
    log(f"[time] (c) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["faults"] = _robust_faults(torch, np, fa, fd, card, params)
    log(f"[time] (d) {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["int8"] = _robust_int8_fidelity(torch, np, fa, fd, card, params)
    log(f"[time] (e) {time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    return out


# -- phase 29: the supervised serving fleet ------------------------------------

#: the fleet's replicas (two sharing the card), their token budget and the
#: fault matrix of the reference's failover test
FLEET_REPLICAS, FLEET_NEW = 2, 16
FLEET_FAULTS = "replica_death@3,decode_nan@5,decode_stall@8:secs=0.2"
#: requests served again after the live reload, and by the dense replica
FLEET_AFTER_RELOAD = FLEET_DENSE = 8
#: the card's free memory after the fault run, within this of before it
FLEET_MEM_SLACK = 1 << 30
#: every fleet phase-29 run's per-worker launches, for the kernels line
FLEET_LAUNCHES = {}


def _fleet_ckpt(params, directory):
    """``params`` saved once with the port's ``Checkpointer`` (generation 1)."""
    import types

    from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(directory)
    ckpt.save(1, types.SimpleNamespace(step=1, params=params, opt_state={},
                                       batch_stats={}))
    ckpt.close()
    return directory


def _one_process_tokens(params, requests, layout):
    """Greedy tokens of the one-process engine of the fleet's spec."""
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceEngine, PagedInferenceEngine, Request,
    )

    kw = dict(num_heads=SERVE["num_heads"], batch_slots=SLOTS, max_seq=MAX_SEQ)
    engine = (PagedInferenceEngine(params, page_size=PAGE, prefill_chunk=CHUNK, **kw)
              if layout == "paged" else InferenceEngine(params, **kw))
    results, _ = ContinuousBatchingScheduler(engine, max_new_tokens=FLEET_NEW).run(
        [Request(uid=r.uid, prompt=list(r.prompt)) for r in requests])
    return {r.uid: list(r.tokens) for r in results}


def _fleet_workers(run, report, *, dense=False):
    """Per worker incarnation of a run's final report: its kernels.*
    launch counters, held exactly where its exit report shows what it
    served (K4 a layer for every decode step and prefill chunk, K1 a
    layer for every dense prefill); every worker ready never loaded jax.
    A worker is named by its replica and, for a restart, its incarnation
    (``replica0``, ``replica0 restart1``), so a path keeps its name from
    run to run."""
    layers = SERVE["num_layers"]
    exits = {rep["pid"]: rep for rep in report.replica_reports if rep}
    names, spawned = {}, {}
    for info in report.worker_info.values():  # in spawn order
        k = spawned[info["replica"]] = spawned.get(info["replica"], 0) + 1
        names[info["pid"]] = f"replica{info['replica']}" + (
            f" restart{k - 1}" if k > 1 else "")
    out = {}
    for state in report.replica_metric_states:
        c = state.get("counters", {})
        key = names[state.get("pid")]
        got = {"k4": c.get("kernels.flash_decode.launches", 0),
               "k4_multi_query": c.get("kernels.flash_decode.launches_multi_query", 0),
               "k4_int8": c.get("kernels.flash_decode.launches_int8", 0),
               "k1": c.get("kernels.flash_attention.launches", 0)}
        out[key] = got
        rep = exits.get(state.get("pid"))  # a worker that exited cleanly
        if rep is not None:
            steps, served = rep["decode_steps"], rep["requests"]
            chunks = rep["chunks_run"]
            ok = (got["k4"] - got["k4_multi_query"] == layers * steps
                  and got["k4_int8"] == 0
                  and got["k4_multi_query"] == layers * chunks
                  and (got["k1"] == layers * served and chunks == 0
                       if dense else got["k1"] == 0 and (chunks > 0) == (served > 0)))
            log(f"[fleet] {run} {key}: launches {got} ({steps} decode steps, "
                f"{chunks} prefill chunks, {served} requests served; K4 {layers} "
                f"a decode step and a chunk"
                f"{', K1 ' + str(layers) + ' a prefill' if dense else ''})")
            if not ok or rep.get("jax_loaded"):
                raise AssertionError(f"[fleet] {run} {key}: launches {got} or jax")
    for key, info in report.worker_info.items():
        if info.get("jax_loaded"):
            raise AssertionError(f"[fleet] {run} {key} loaded jax")
    FLEET_LAUNCHES.update({f"fleet {run} {k}": v for k, v in out.items()})
    return out


def _fleet_figures(run, report, card):
    """Phase 29 (d)'s printed figures of one run's final report."""
    lat = report.fleet_latency
    ready = {k: i.get("spawn_to_ready_s", "not ready") for k, i in
             report.worker_info.items()}
    hbm = {k: round(v.get("hbm.peak_total_bytes", 0.0) / 1e9, 4)
           for k, v in report.hbm_watermarks.items()}
    log(f"[fleet] {run}: spawn to ready {ready} s; merged TTFT p50 "
        f"{lat['ttft_s'].get('p50')} p99 {lat['ttft_s'].get('p99')} s, TPOT p50 "
        f"{lat['tpot_s'].get('p50')} p99 {lat['tpot_s'].get('p99')} s "
        f"({lat['ttft_samples']} / {lat['tpot_samples']} samples); HBM peak a "
        f"replica {hbm} GB on {card}")


def phase_fleet(torch, np, card):
    """Phase 29 (module docstring): the supervised serving fleet at the
    serving geometry, two replicas sharing the card.  The fault run's and
    the dense run's workers spawn while (a) reloads and drains, and the
    restart comes up while (c) serves: a spawn is ~12 s of the phase."""
    import dataclasses
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch.obs import fleet as obs_fleet
    from distributeddeeplearning_tpu_torch.obs import trace as trace_mod
    from distributeddeeplearning_tpu_torch.serve import FleetRouter, ReplicaSpec, Request

    root = tempfile.mkdtemp(prefix="fleet-")
    requests = serve_requests(np, "dense")
    routers = []
    prior_tracer = trace_mod.get_tracer()
    try:
        t0 = time.perf_counter()
        params = serve_params(torch)
        ckpt_a = _fleet_ckpt(params, os.path.join(root, "a"))
        want_a = _one_process_tokens(params, requests, "paged")
        want_dense = _one_process_tokens(params, requests[:FLEET_DENSE], "dense")
        del params
        params_b = serve_params(torch, seed=1)
        ckpt_b = _fleet_ckpt(params_b, os.path.join(root, "b"))
        after = [Request(uid=f"post{i}", prompt=list(r.prompt))
                 for i, r in enumerate(requests[:FLEET_AFTER_RELOAD])]
        want_b = _one_process_tokens(params_b, after, "paged")
        del params_b
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
        log(f"[time] (setup: two checkpoints, three one-process runs) "
            f"{time.perf_counter() - t0:.1f} s")
        spec = ReplicaSpec(checkpoint_dir=ckpt_a, num_heads=SERVE["num_heads"],
                           batch_slots=SLOTS, max_seq=MAX_SEQ, kv_layout="paged",
                           page_size=PAGE, prefill_chunk=CHUNK,
                           max_new_tokens=FLEET_NEW, device="cuda")
        # the fault run traces: the router's tracer is this process's
        trace_dir = os.path.join(root, "trace")
        os.makedirs(trace_dir)
        tracer = trace_mod.set_tracer(trace_mod.Tracer(
            enabled=True, annotate=False, process_name="router",
            recorder=trace_mod.PROCESS_RECORDER))

        # (a) the clean fleet from a cold start, a live reload on the same
        # router, a drain
        t1 = time.perf_counter()
        clean = FleetRouter(spec, replicas=FLEET_REPLICAS, faults="")
        faulty = FleetRouter(dataclasses.replace(spec, trace_dir=trace_dir),
                             replicas=FLEET_REPLICAS, max_restarts=1,
                             max_redeliveries=2, faults=FLEET_FAULTS)
        dense = FleetRouter(dataclasses.replace(spec, kv_layout="dense"), replicas=1,
                            faults="")
        routers += [clean, faulty, dense]
        res, rep = clean.serve(requests, shutdown=False)
        first_token_s = rep.warmup_s
        got = {r.uid: list(r.tokens) for r in res}
        if got != want_a or rep.finish_reasons != {"length": REQUESTS}:
            raise AssertionError(f"[fleet] clean fleet != the one-process engine: "
                                 f"{rep.finish_reasons}")
        faulty.serve([], shutdown=False)  # spawn (b)'s and (c)'s workers now
        dense.serve([], shutdown=False)
        acks = clean.reload(ckpt_b, timeout_s=120)
        if sorted(acks) != list(range(FLEET_REPLICAS)) or not all(
                a.get("ok") for a in acks.values()):
            raise AssertionError(f"[fleet] reload acks {acks}")
        res_b, rep_b = clean.serve(after, shutdown=False)
        if {r.uid: list(r.tokens) for r in res_b} != want_b or rep_b.reloads != 1:
            raise AssertionError("[fleet] tokens after the reload barrier != a "
                                 "fresh engine of the new weights")
        clean.drain()
        _, rep_end = clean.serve([])
        if not rep_end.drained or any(r is None for r in rep_end.replica_reports):
            raise AssertionError("[fleet] the drain did not end both replicas cleanly")
        log(f"[fleet] (a) {REQUESTS} requests x {FLEET_NEW} over {FLEET_REPLICAS} "
            f"replicas (paged f32, page {PAGE}, chunk {CHUNK}, {SLOTS} slots each): "
            f"tokens == the one-process engine's; first streamed token "
            f"{first_token_s:.3f} s after serve() (spawn included); reload acks "
            f"{acks}; {FLEET_AFTER_RELOAD} requests after the barrier == a fresh "
            f"engine of the new weights; drained; workers jax-free")
        _fleet_workers("clean", rep_end)
        _fleet_figures("clean", rep_end, card)
        log(f"[time] (a) {time.perf_counter() - t1:.1f} s")

        # (b) the fault matrix, traced, both replicas ready first (a death
        # dealt to a replica that took no request would never fire)
        t1 = time.perf_counter()
        if not faulty.wait_ready():
            raise AssertionError("[fleet] the fault run's replicas did not come up")
        res, rep = faulty.serve(requests, shutdown=False)
        errors = [r for r in res if r.finish_reason == "error"]
        checks = {
            "one death": rep.replica_deaths == 1, "one restart": rep.restarts == 1,
            "no lost request": rep.lost_requests == 0,
            "one non-finite error": len(errors) == 1 and "non-finite" in (
                errors[0].error or ""),
            "every request once": sorted(r.uid for r in res) == sorted(
                r.uid for r in requests),
            "survivors == (a)": all(list(r.tokens) == want_a[r.uid] for r in res
                                    if r.finish_reason == "length"),
        }

        # (c) one dense replica through data_parallel_engine (K1 and K4(a)),
        # served while (b)'s restart comes up
        t2 = time.perf_counter()
        if not dense.wait_ready():
            raise AssertionError("[fleet] the dense replica did not come up")
        res_c, rep_c = dense.serve(requests[:FLEET_DENSE])
        if {r.uid: list(r.tokens) for r in res_c} != want_dense:
            raise AssertionError("[fleet] dense replica != the one-process dense engine")
        log(f"[fleet] (c) one dense replica (data_parallel_engine, flash prefill): "
            f"{FLEET_DENSE} requests x {FLEET_NEW} == the one-process dense engine's")
        _fleet_workers("dense", rep_c, dense=True)
        _fleet_figures("dense", rep_c, card)
        log(f"[time] (c) {time.perf_counter() - t2:.1f} s")

        checks["restart ready"] = faulty.wait_ready()
        _, rep_end = faulty.serve([])
        trace_mod.set_tracer(prior_tracer)
        merged = obs_fleet.merge_fleet_trace(
            tracer.to_chrome_trace(), obs_fleet.load_trace_shards(trace_dir),
            offsets_us=faulty.clock_offsets_us)
        requeued = sorted({(e.get("args") or {}).get("trace") for e in tracer.events
                           if e.get("name") == "fleet/request_requeued"} - {None})
        chains = {t: obs_fleet.check_failover_chain(c) for t, c in
                  obs_fleet.failover_chains(merged, requeued).items()}
        checks["a failover chain passes"] = any(c["ok"] for c in chains.values())
        free1 = free0
        for _ in range(100):  # a dead worker's context is freed as it is reaped
            free1 = torch.cuda.mem_get_info()[0]
            if free1 >= free0 - FLEET_MEM_SLACK:
                break
            time.sleep(0.1)
        checks["card memory back"] = free1 >= free0 - FLEET_MEM_SLACK
        log(f"[fleet] (b) {FLEET_FAULTS}, max_restarts 1, max_redeliveries 2: deaths "
            f"{rep.replica_deaths}, restarts {rep.restarts}, redeliveries "
            f"{rep.redeliveries}, lost {rep.lost_requests}, finish {rep.finish_reasons}, "
            f"error {[e.error for e in errors]}; survivors == (a)'s; failover chains "
            f"{sum(c['ok'] for c in chains.values())} of {len(chains)} requeued pass "
            f"check_failover_chain; the card's free memory {free0 / 1e9:.3f} GB "
            f"before the fleets, {free1 / 1e9:.3f} GB after them")
        failed = [what for what, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"[fleet] fault run: {failed}")
        _fleet_workers("faults", rep_end)
        _fleet_figures("faults", rep_end, card)
        log(f"[time] (b) with (c) {time.perf_counter() - t1:.1f} s")
    finally:
        trace_mod.set_tracer(prior_tracer)
        for router in routers:
            router.terminate()
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return FLEET_LAUNCHES


def _lr_sum(steps: int) -> float:
    """The summed learning rates of :func:`_dp_lm_fit`'s schedule."""
    from distributeddeeplearning_tpu_torch.train.schedule import (
        warmup_linear_decay_schedule,
    )

    sched = warmup_linear_decay_schedule(DP_PEAK_LR, steps)
    return sum(float(sched(i)) for i in range(steps))


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
    [_local_heads][_bias][_bf16] launches flash_<pass>_<f32 or bf16>_kernel
    (a row lists its instances with and without the bias); the
    flash_decode* wrappers
    share the flash_decode split and merge kernels (each row lists all
    their instances)."""
    if row_name.startswith("flash_decode"):
        name = "flash_decode"
    else:
        dtype = "_bf16" if row_name.endswith("_bf16") else "_f32"
        stem = (row_name.replace("_local_heads", "").replace("_bias", "")
                .replace("_bf16", ""))
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
    _zero_fa(fa)
    fd.launches = fd.launches_bf16 = fd.launches_int8 = 0
    fd.launches_multi_query = fd.launches_verify = 0


IMAGENET = dict(model="resnet50", batch=64, image_size=224, num_classes=1001,
                train_images=1024, train_shards=8, val_images=256, val_shards=2,
                host_seconds=1.5, host_batches=8,
                fed=dict(num_warmup_batches=4, num_iters=3, num_batches_per_iter=5))
U8_TOL = 0.5 + 1e-4  # uint8 rounding of the decoder's float pixels


class _ImagenetEarly:
    """Phase 30's shards and its ``python -m`` workload run (d), started
    with the script: a thread writes the shards (host work, beside the
    kernels' ``nvcc`` build), then starts (d) on them in a process of its
    own (cuDNN only: it needs none of the port's kernels).  ``main``
    waits for it before the first timed phase; the phase collects the
    shards and (d)'s result; ``close`` stops the process and removes the
    files."""

    def __init__(self):
        import tempfile
        import threading

        self.tmp = tempfile.mkdtemp(prefix="imagenet-")
        self.data = os.path.join(self.tmp, "shards")
        self.metrics = os.path.join(self.tmp, "metrics.jsonl")
        self.proc = self.error = self.meta = None
        self.gen_s = self.started = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from distributeddeeplearning_tpu_torch.data.bench_data import (
            generate_bench_shards,
        )

        try:
            cfg = IMAGENET
            t0 = time.perf_counter()
            self.meta = (
                generate_bench_shards(self.data, num_images=cfg["train_images"],
                                      num_shards=cfg["train_shards"], seed=0),
                generate_bench_shards(self.data, num_images=cfg["val_images"],
                                      num_shards=cfg["val_shards"], seed=1,
                                      split="validation"))
            self.gen_s = time.perf_counter() - t0
            # stderr to a file: -X importtime writes more than a pipe holds
            self.started = time.perf_counter()
            self.proc = subprocess.Popen(
                [sys.executable, "-X", "importtime", "-m",
                 "distributeddeeplearning_tpu_torch.workloads.imagenet",
                 "--data_format=tfrecords", f"--training_data_path={self.data}",
                 f"--validation_data_path={self.data}", "--epochs=1",
                 "--steps_per_epoch=4", f"--train_images={cfg['train_images']}",
                 f"--metrics_path={self.metrics}"],
                stdout=subprocess.DEVNULL,
                stderr=open(os.path.join(self.tmp, "workload.err"), "w"),
                cwd=os.path.dirname(os.path.abspath(__file__)))
        except BaseException as exc:  # noqa: BLE001 — raised where collected
            self.error = exc

    def shards(self):
        """(shard directory, (train, validation) manifests, seconds)."""
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.data, self.meta, self.gen_s

    def workload(self, timeout=600):
        """(d)'s (exit code, stderr, seconds from its start to its
        collection: at most its run time, metrics path)."""
        self.shards()
        try:
            rc = self.proc.wait(timeout=max(timeout - (time.perf_counter()
                                                       - self.started), 1))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        with open(os.path.join(self.tmp, "workload.err")) as f:
            return rc, f.read(), time.perf_counter() - self.started, self.metrics

    def close(self):
        import shutil

        self._thread.join()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def _host_rate(make):
    """``make()``'s batches on the host alone: one warm-up batch (the
    pool's start-up) untimed, then at least ``host_batches`` batches and
    ``host_seconds`` timed.  Returns img/s, the timed seconds and batches,
    the warm-up's seconds and the batches' shapes."""
    t0 = time.perf_counter()
    it = make()
    batch = next(it)
    warm = time.perf_counter() - t0
    shapes = {(batch["image"].shape, str(batch["image"].dtype))}
    images = batches = 0
    dt = 0.0
    t1 = time.perf_counter()
    while batches < IMAGENET["host_batches"] or dt < IMAGENET["host_seconds"]:
        batch = next(it)
        shapes.add((batch["image"].shape, str(batch["image"].dtype)))
        if len(batch["label"]) != IMAGENET["batch"]:
            raise AssertionError(f"[imagenet] a host batch of {len(batch['label'])}")
        images += len(batch["label"])
        batches += 1
        dt = time.perf_counter() - t1
    it.close()
    return dict(img_s=images / dt, s=dt, batches=batches, warmup_s=warm,
                shapes=sorted(map(str, shapes)))


def phase_imagenet(torch, np, card, early=None):
    """The ImageNet data plane and the ``imagenet`` workload at the
    reference's flagship settings (ResNet-50, 224 px, batch 64, bf16, 1001
    classes), no TensorFlow anywhere.  (a) Seeded ILSVRC-size JPEG shards
    from ``data.bench_data`` in a temporary directory, written from the
    script's start beside the kernels' build (``_ImagenetEarly``): train
    1024 images in 8 shards, validation 256 in 2; the record reader's C library
    (``ddlt_records.c``) must build with the host compiler (it fails the
    phase if it does not); the JPEG decoder's (``ddlt_image.c``, libjpeg)
    may not, and then PIL decodes: the built libraries and the decoder
    that ran are printed.  (b) Host rates, each pipeline alone with no
    device: the tf recipe (``data.tfrecords``), the native pipeline and the
    raw cache (built first, its build timed), batches of 64 timed after
    one warm-up batch for at least 1.5 s and 8 batches, img/s beside
    ``os.cpu_count()``.  (c) Fed against resident: one bf16 ResNet-50
    train step through ``train.benchmark.run_benchmark`` on one resident
    batch and through ``run_data_benchmark`` over the native and raw
    pipelines staged by ``prefetch_to_device`` (raw: uint8 across PCIe,
    ``uint8_normalizer`` on the card as the step's ``input_transform``),
    3 windows of 5 after 4 warmup batches each: fed img/s, resident
    img/s, their ratio; and on the card ``uint8_normalizer`` of the raw
    validation batch is within 0.5 + 1e-4 of the native float batch of the
    same records.  (d) The workload as users run it: ``python -m
    distributeddeeplearning_tpu_torch.workloads.imagenet
    --data_format=tfrecords`` with the default ``--input_pipeline=tf``, one
    epoch of 4 steps and validation over the 256 images, in a fresh
    process under ``-X importtime`` started on the shards as soon as they
    are written (beside the build; ``main`` waits for it before the first
    timed phase): the loss is finite, the eval metrics
    exist, and no import of jax or tensorflow is in its import log.  (e)
    Replay-free resume: ``imagenet.main(input_pipeline="raw")`` for 2
    steps with a checkpoint, then resumed to 4: the batches the resumed
    run drew from step 2 on equal an unstopped stream's batches 2 and 3
    (labels and pixels).  No kernel of the port is on this path (cuDNN's
    convolutions)."""
    import tempfile

    from distributeddeeplearning_tpu_torch.data import (
        _native,
        _native_build,
        _native_image,
        native_pipeline,
        raw_cache,
        tfrecords,
    )
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.benchmark import (
        run_benchmark,
        run_data_benchmark,
    )
    from distributeddeeplearning_tpu_torch.train.schedule import goyal_lr_schedule
    from distributeddeeplearning_tpu_torch.train.state import (
        create_train_state,
        sgd_momentum,
    )
    from distributeddeeplearning_tpu_torch.train.step import build_train_step
    from distributeddeeplearning_tpu_torch.utils.prefetch import prefetch_to_device
    from distributeddeeplearning_tpu_torch.workloads import imagenet

    cfg = IMAGENET
    b, size = cfg["batch"], cfg["image_size"]
    out = {"cpu_count": os.cpu_count()}
    early = early or _ImagenetEarly()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the shards (written from the script's start) and the C libraries
        data, (train_m, val_m), gen_s = early.shards()
        records_c = _native.native_available()
        image_c = _native_image.native_available()
        log(f"[imagenet] (a) shards: train {cfg['train_images']} in "
            f"{cfg['train_shards']}, validation {cfg['val_images']} in "
            f"{cfg['val_shards']}, mean JPEG {train_m['mean_jpeg_bytes']} / "
            f"{val_m['mean_jpeg_bytes']} bytes, written in {gen_s:.1f} s")
        log(f"[imagenet] (a) C libraries: {json.dumps(_native_build.build_log)}")
        log(f"[imagenet] (a) record reader: {'C' if records_c else 'Python'}; "
            f"JPEG decoder of the native pipeline: "
            f"{'C (libjpeg)' if image_c else 'PIL (ddlt_image.c did not build)'}")
        if not records_c:
            raise AssertionError("[imagenet] the C record reader did not build: "
                                 f"{_native_build.build_log.get('ddlt_records')}")
        out.update(record_reader="C" if records_c else "Python",
                   decoder="C" if image_c else "PIL")

        # (b) host rates, no device
        native_pipeline.decoded.update(c=0, pil=0)
        rates = {"tf": _host_rate(lambda: tfrecords.input_fn(
            data, True, b, image_size=size, seed=0))}
        rates["native"] = _host_rate(lambda: native_pipeline.native_input_fn(
            data, True, b, image_size=size, seed=0))
        t0 = time.perf_counter()
        cache = raw_cache.cache_path_for(data, True, size)
        raw_cache.build_raw_cache(data, cache, True, image_size=size)
        build_s = time.perf_counter() - t0
        rates["raw"] = _host_rate(lambda: raw_cache.raw_cache_input_fn(
            cache, True, b, seed=0))
        for name, r in rates.items():
            log(f"[imagenet] (b) host {name}: {r['img_s']:.1f} img/s "
                f"({r['batches']} batches of {b} at {size} px in {r['s']:.3f} s "
                f"after a {r['warmup_s']:.3f} s warm-up batch; {r['shapes']}) on "
                f"{os.cpu_count()} host cores")
        log(f"[imagenet] (b) raw cache build: {cfg['train_images']} images in "
            f"{build_s:.2f} s ({cfg['train_images'] / build_s:.1f} img/s, "
            f"{cfg['train_images'] * size * size * 3 / 1e6:.1f} MB); images "
            f"decoded by C / PIL so far: {native_pipeline.decoded}")
        out["host_img_s"] = {k: v["img_s"] for k, v in rates.items()}

        # (c) fed against resident, one step
        dev = torch.device("cuda")
        net = get_model(cfg["model"], num_classes=cfg["num_classes"],
                        dtype=torch.bfloat16)
        sched = goyal_lr_schedule(0.0125, 1, steps_per_epoch=5004)
        state = create_train_state(torch.Generator().manual_seed(0), net,
                                   (b, size, size, 3), sgd_momentum(sched),
                                   device=dev)
        step = build_train_step(state, schedule=sched, compute_dtype=torch.bfloat16)
        step_u8 = build_train_step(state, schedule=sched, compute_dtype=torch.bfloat16,
                                   input_transform=raw_cache.uint8_normalizer())
        resident = next(native_pipeline.native_input_fn(data, True, b, image_size=size,
                                                        seed=1))
        resident = {k: torch.as_tensor(v, device=dev) for k, v in resident.items()}
        fed = cfg["fed"]
        kw = dict(model_name=cfg["model"], batch_size_per_chip=b, num_devices=1, **fed)
        res = run_benchmark(step, state, resident, **kw)
        fed_rates = {}
        for name, fn, make in (
                ("native", step, lambda: native_pipeline.native_input_fn(
                    data, True, b, image_size=size, seed=2)),
                ("raw", step_u8, lambda: raw_cache.raw_cache_input_fn(
                    cache, True, b, seed=2))):
            staged = prefetch_to_device(make(), dev)
            try:
                fed_rates[name] = run_data_benchmark(fn, state, staged, **kw)
            finally:
                staged.close()
        synth = res.img_sec_per_chip_mean
        log(f"[imagenet] (c) resident batch: {synth:.1f} +-"
            f"{res.img_sec_per_chip_ci95:.1f} img/s ({cfg['model']} bf16 B={b} "
            f"{size} px, {fed['num_iters']} windows of "
            f"{fed['num_batches_per_iter']}) on {card}")
        for name, r in fed_rates.items():
            log(f"[imagenet] (c) fed {name}: {r.img_sec_per_chip_mean:.1f} +-"
                f"{r.img_sec_per_chip_ci95:.1f} img/s, {r.img_sec_per_chip_mean / synth:.3f}"
                f" of resident; host alone {out['host_img_s'][name]:.1f} img/s")
        out["resident_img_s"] = synth
        out["fed_img_s"] = {k: v.img_sec_per_chip_mean for k, v in fed_rates.items()}
        del state, step, step_u8, resident
        torch.cuda.empty_cache()
        val_cache = raw_cache.cache_path_for(data, False, size)
        raw_cache.build_raw_cache(data, val_cache, False, image_size=size)
        u8 = next(raw_cache.raw_cache_input_fn(val_cache, False, b))
        flt = next(native_pipeline.native_input_fn(data, False, b, image_size=size))
        if not np.array_equal(u8["label"], flt["label"]):
            raise AssertionError("[imagenet] raw and native eval order differ")
        on_card = raw_cache.uint8_normalizer(device=dev)(u8["image"])
        err = (on_card - torch.as_tensor(flt["image"], device=dev)).abs().max().item()
        log(f"[imagenet] (c) uint8_normalizer on the card vs the native float "
            f"batch of the same {b} records: max |diff| {err:.6f} (limit {U8_TOL})")
        if not (on_card.device.type == "cuda" and err <= U8_TOL):
            raise AssertionError(f"[imagenet] raw vs native {err} > {U8_TOL}")

        # (d) the workload through python -m, tf recipe, 4 steps + eval: the
        # process started on the shards from the script's start
        rc, stderr, wall, metrics = early.workload()
        if rc != 0:
            raise AssertionError(f"[imagenet] python -m ...workloads.imagenet failed: "
                                 f"{stderr[-3000:]}")
        imported = {ln.split("|")[-1].strip().split(".")[0]
                    for ln in stderr.splitlines() if ln.startswith("import time:")}
        with open(metrics) as f:
            row = json.loads(f.read().splitlines()[-1])
        log(f"[imagenet] (d) python -m ...workloads.imagenet --data_format="
            f"tfrecords (input_pipeline tf, resnet50 bf16 B={b} {size} px, 4 steps, "
            f"eval over {cfg['val_images']}; started with the script, beside the "
            f"kernels' build): exit 0 within {wall:.1f} s; row {row}; modules "
            f"imported: {len(imported)} top-level, jax {'jax' in imported}, "
            f"tensorflow {'tensorflow' in imported}")
        if "jax" in imported or "tensorflow" in imported or not imported:
            raise AssertionError(f"[imagenet] the workload imported jax or "
                                 f"tensorflow (or logged no imports): {sorted(imported)[:40]}")
        if not (math.isfinite(row["train_loss"]) and "val_top1" in row
                and math.isfinite(row["val_loss"])):
            raise AssertionError(f"[imagenet] bad metrics row {row}")
        out["workload"] = {"wall_s": wall, "train_loss": row["train_loss"],
                           "val_top1": row["val_top1"]}

        # (e) replay-free resume over the raw cache
        drawn = {}
        original = imagenet._batches

        def recording(*args, **kw2):
            it = original(*args, **kw2)
            if not args[2]:  # eval
                return it
            key = kw2.get("start_batch", 0)
            seen = drawn.setdefault(key, [])

            def gen():
                for batch in it:
                    seen.append((batch["label"].copy(),
                                 hashlib.sha256(batch["image"].tobytes()).digest()))
                    yield batch
            return gen()

        ckpt = os.path.join(tmp, "ckpt")
        run = dict(model=cfg["model"], data_format="tfrecords", input_pipeline="raw",
                   training_data_path=data, steps_per_epoch=2,
                   train_images=cfg["train_images"])
        imagenet._batches = recording
        t0 = time.perf_counter()
        try:
            first, _ = imagenet.main(epochs=1, save_filepath=ckpt, **run)
            resumed, fit = imagenet.main(epochs=2, save_filepath=ckpt, **run)
        finally:
            imagenet._batches = original
        resume_s = time.perf_counter() - t0
        stream = list(itertools.islice(original(
            "tfrecords", data, True, b, size, cfg["num_classes"], 42,
            input_pipeline="raw"), 4))
        want = [(x["label"], hashlib.sha256(x["image"].tobytes()).digest())
                for x in stream[2:4]]
        got = drawn.get(2, [])[:2]
        same = len(got) == 2 and all(np.array_equal(g[0], w[0]) and g[1] == w[1]
                                     for g, w in zip(got, want))
        log(f"[imagenet] (e) raw fit stopped at step {first.step}, resumed to "
            f"{resumed.step} (epochs run {fit.epochs_run}, loss "
            f"{fit.final_train_metrics.get('loss')}): factory calls from steps "
            f"{sorted(drawn)}; batches 2-3 == the unstopped stream's: {same}; "
            f"{resume_s:.1f} s")
        if not (first.step == 2 and resumed.step == 4 and 0 in drawn and same
                and math.isfinite(fit.final_train_metrics["loss"])):
            raise AssertionError("[imagenet] the resumed raw fit did not continue "
                                 "the unstopped stream")
        del first, resumed
    torch.cuda.empty_cache()
    return out


# ---- tensor-parallel and FSDP training (phase 31) ---------------------------

MP_RANKS = 4
MP_MESHES = (("tensor2-fsdp2", {"tensor": 2, "fsdp": 2}), ("fsdp4", {"fsdp": 4}),
             ("data2-tensor2", {"data": 2, "tensor": 2}))
#: (a) at TRAIN's width and sequence, cut to 4 layers (the script's depth
#: cut: a layer's step pays 4 gloo all-reduces of the activations)
MP_WIDTH = {**{k: TRAIN[k] for k in ("d_model", "num_heads", "d_ff", "vocab_size",
                                     "seq_len")}, "num_layers": 4}
MP_BATCH = 2  # rows a data shard: (a)'s global batch is 2 x 2 data shards
MP_STEPS = 3
MP_EVAL_BATCHES = 2  # a rank's eval pass: min(train_examples, 4 x global) / 2
# (b): f32 at full width, cut to 2 layers at seq 512; 4 global rows, 2 steps
MP_PARITY = dict(num_layers=2, seq_len=512, rows=4, steps=2)
MP_LOSS_RTOL = 1e-5
MP_GRAD_TOL = 1e-5  # of each leaf's largest |g|
#: (d): (b) on data=2 x tensor=2 over two slices, rank r reporting node
#: MP_SLICE_NODES[r] (torchrun's GROUP_RANK): ranks 0 and 2 on node 0
MP_SLICE_NAME = "data2-tensor2-slices"
MP_SLICE_NODES = (0, 1, 0, 1)
#: (c): the bf16 step after a restore on fsdp=4 against one process's
#: after a restore of the same generation, on the same global batch: the
#: same bf16 products over 1 row a rank instead of 4 in one GEMM, which
#: cuBLAS may sum in another order (a bf16 ulp is 2^-8 of the value)
MP_RESHARD_LOSS_RTOL = 1e-2
MP_NORM_RTOL = 1e-6
MP_REPLICATED = ("pos", "blocks/ln1", "blocks/ln2")
# the collectives of one train step on a rank of tensor=2 x fsdp=2 (data 1),
# written down before the first run on the card: 2 all-reduces a layer
# forward (Megatron's g after proj and w_out) and 2 backward (f's gradient
# at the qkv and w_in inputs), one of the replicated and tensor-split
# gradients over the data axes (the fsdp group here), one of the metrics,
# two of the clip norm (the fsdp-split class over fsdp, the tensor-split
# class over tensor); the embedding and the head gathered over fsdp
# forward and their gradients reduce-scattered backward
MP_STEP_COLLECTIVES = {"all_reduce": 4 * MP_WIDTH["num_layers"] + 4,
                       "all_gather": 2, "reduce_scatter": 2}


class _SpyAdamW:
    """AdamW (the port's), keeping the gradient tree and the clip norm of
    its first update: phase 31(b)'s view into the step."""

    def __init__(self, torch, schedule, clip):
        from distributeddeeplearning_tpu_torch.train.state import adamw, global_norm, tree_leaves

        self.inner = adamw(schedule, grad_clip_norm=clip)
        self.grad_clip_norm = clip
        self.seen, self.norms = None, []
        self._norm = lambda g: global_norm(tree_leaves(g))

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, opt_state, ok=None, *, grad_norm=None):
        norm = grad_norm if grad_norm is not None else self._norm(grads)
        self.norms.append(norm.detach().clone())
        if self.seen is None:
            self.seen = grads
        self.inner.apply(params, grads, opt_state, ok, grad_norm=grad_norm)


def _mp_batches(np, rows, seq, steps):
    from distributeddeeplearning_tpu_torch.workloads import transformer

    return list(transformer._token_batches(rows, seq, TRAIN["vocab_size"], DP_SEED,
                                           rows * steps, repeat=False))


def _mp_parity_fit(torch, np, mesh, clip):
    """Phase 31(b): the LM at full width, 2 layers, f32, flash, through
    ``build_train_step`` with the LM's rules on ``mesh`` (None: one
    process), AdamW's clip at ``clip``, over MP_PARITY's global batches.
    Returns (losses, the first step's global gradients on the CPU by
    name, the clip norms by step, the f32 K1-K3 launch counts)."""
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as pt
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.parallel import ParamLayout, shard_batch
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves
    from distributeddeeplearning_tpu_torch.train.schedule import constant_schedule
    from distributeddeeplearning_tpu_torch.train.state import TrainState, shard_state
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    geo = dict(MP_WIDTH, num_layers=MP_PARITY["num_layers"])
    seq = MP_PARITY["seq_len"]
    del geo["seq_len"]
    params = pt.init_params(torch.Generator().manual_seed(DP_SEED), max_len=seq,
                            device="cuda:0", **geo)

    sharded = mesh is not None and mesh.size > 1
    # the layout the state is laid out by, which the model reads its splits from
    layout = (ParamLayout.from_rules(mesh, params, pt.train_rules(mesh.shape["tensor"]),
                                     pt.LOGICAL_AXES) if sharded else None)

    def apply_fn(p, tokens, **_):
        return pt.forward(p, tokens, num_heads=TRAIN["num_heads"], attention="flash",
                          layout=layout)

    tx = _SpyAdamW(torch, constant_schedule(DP_PEAK_LR), clip)
    state = TrainState.create(params=params, apply_fn=apply_fn, tx=tx)
    if sharded:
        shard_state(state, layout)
    step = build_train_step(
        state, mesh=mesh if sharded else None, compute_dtype=torch.float32,
        loss_fn=lambda lg, lb, label_smoothing=0.0: pt.next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss})
    for c in FA_COUNTERS:
        setattr(fa, c, 0)
    losses = []
    for batch in _mp_batches(np, MP_PARITY["rows"], seq, MP_PARITY["steps"]):
        state, m = step(state, shard_batch(mesh, batch) if sharded else batch)
        losses.append(m["loss"].detach())
    grads = tx.seen if state.layout is None else state.layout.gather(tx.seen)
    named = {k: g.detach().float().cpu() for k, g in named_leaves(grads)}
    return ([x.item() for x in losses], named, [x.item() for x in tx.norms],
            {c: getattr(fa, c) for c in ("launches", "launches_dq", "launches_dkv")})


class _MPRecorded:
    """A train step that keeps, each step: the loss, the host and CUDA-event
    times, the host time inside collectives (``_ClockedCollectives.active``),
    the collectives it issued and staged (the counts zeroed around it) and
    a digest of this rank's replicated leaves after it."""

    def __init__(self, torch, step, replicated=MP_REPLICATED):
        self.torch, self.step, self.replicated = torch, step, replicated
        self.losses, self.wall_ms, self.marks, self.inside_ms = [], [], [], []
        self.collectives, self.staged, self.digests = [], [], []

    def __call__(self, state, batch):
        from distributeddeeplearning_tpu_torch.parallel import collectives
        from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves

        torch = self.torch
        torch.cuda.synchronize()
        collectives.reset_counts()
        collectives.reset_staged()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        clock = _ClockedCollectives.active
        inside = clock.s if clock else 0.0
        t0 = time.perf_counter()
        a.record()
        state, metrics = self.step(state, batch)
        b.record()
        torch.cuda.synchronize()
        self.wall_ms.append((time.perf_counter() - t0) * 1e3)
        self.inside_ms.append(((clock.s if clock else 0.0) - inside) * 1e3)
        self.marks.append((a, b))
        self.collectives.append(collectives.counts())
        self.staged.append(collectives.staged_ops())
        self.losses.append(metrics["loss"].item())
        named = dict(named_leaves(state.params))
        self.digests.append({k: hashlib.sha256(
            named[k].detach().cpu().contiguous().view(torch.uint8).numpy()
        ).hexdigest() for k in self.replicated})
        return state, metrics

    def __getattr__(self, name):
        return getattr(self.step, name)

    def event_ms(self):
        return [a.elapsed_time(b) for a, b in self.marks]


class _ClockedCollectives:
    """Adds the host seconds spent inside each call of ``parallel.
    collectives``' all-reduce, all-gather and reduce-scatter to ``s``."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter")
    active = None  # the clock running now, if any

    def __init__(self):
        from distributeddeeplearning_tpu_torch.parallel import collectives

        self.col, self.s = collectives, 0.0
        self._orig = {n: getattr(collectives, n) for n in self.NAMES}

    def __enter__(self):
        def clocked(fn):
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.s += time.perf_counter() - t
            return call
        for n, fn in self._orig.items():
            setattr(self.col, n, clocked(fn))
        _ClockedCollectives.active = self
        return self

    def __exit__(self, *exc):
        _ClockedCollectives.active = None
        for n, fn in self._orig.items():
            setattr(self.col, n, fn)


def _mp_main(torch, fa, built, **kw):
    """``workloads.transformer.main`` at TRAIN's width, bf16, flash, with
    every train step it builds recorded (``built``) and the K1-K3 counters
    zeroed just before; returns (state, fit, counts, launch shapes, plain
    calls, host seconds inside collectives, peak GB)."""
    from distributeddeeplearning_tpu_torch.train import step as tstep
    from distributeddeeplearning_tpu_torch.workloads import transformer

    original = tstep.build_train_step

    def build(*a, **k):
        built.append(_MPRecorded(torch, original(*a, **k)))
        return built[-1]

    tstep.build_train_step = build
    try:
        for c in FA_COUNTERS:
            setattr(fa, c, 0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _LaunchShapes(fa) as shapes, _ClockedCollectives() as clock:
            state, fit = transformer.main(
                epochs=1, attention="flash", compute_dtype="bfloat16",
                train_examples=2 * MP_BATCH, **MP_WIDTH, **kw)
        counts = {c: getattr(fa, c) for c in FA_COUNTERS}
    finally:
        tstep.build_train_step = original
    return (state, fit, counts, sorted(set(shapes.shapes)), shapes.plain, clock.s,
            torch.cuda.max_memory_allocated() / 1e9)


def _mp_expected_bytes(torch, mesh, layout):
    """This rank's parameter bytes as the sum of its shards' sizes: each
    leaf's global shape (TRAIN's) cut by its spec."""
    from distributeddeeplearning_tpu_torch.parallel.sharding import local_shape

    L, d, f, v, s = (MP_WIDTH[k] for k in ("num_layers", "d_model", "d_ff",
                                           "vocab_size", "seq_len"))
    shapes = {"embed": (v, d), "pos": (s, d), "head": (d, v), "blocks/qkv": (L, d, 3 * d),
              "blocks/proj": (L, d, d), "blocks/w_in": (L, d, f),
              "blocks/w_out": (L, f, d), "blocks/ln1": (L, d), "blocks/ln2": (L, d)}
    return sum(4 * math.prod(local_shape(shape, layout.specs[k], mesh))
               for k, shape in shapes.items())


def _mp_parity_entry(torch, np, mesh, clip, ref):
    """(b) on ``mesh`` against the one-process reference ``ref``: losses,
    norms, f32 K1-K3 launches, their gaps to ``ref`` and the worst
    gradient leaf's."""
    losses, grads, norms, counts = _mp_parity_fit(torch, np, mesh, clip)
    gaps = {k: ((g - ref["grads"][k]).abs().max() / ref["grads"][k].abs().max()).item()
            for k, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    entry = {
        "losses": losses, "norms": norms, "counts": counts,
        "loss_rel": [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])],
        "norm_rel": [abs(a - b) / abs(b) for a, b in zip(norms, ref["norms"])],
        "grad_gap": gaps[worst], "grad_worst": worst,
        "grad_keys": sorted(grads) == sorted(ref["grads"])}
    del grads
    torch.cuda.empty_cache()
    return entry


def _mp_restored_step(torch, np, mesh, save_dir):
    """Phase 31(c): a fresh LM at MP_WIDTH laid out on ``mesh`` (None: one
    process) restored from ``save_dir``'s newest generation, which (a)
    saved over ``tensor=2 x fsdp=2``, then one bf16 flash step on the
    first global batch of 2 x MP_BATCH rows.  Returns the restored step,
    whether the gathered params and AdamW moments are bitwise the
    generation's global arrays, the step's bf16 K1-K3 launches and their
    shapes, its loss, and the restore and step walls."""
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as pt
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.parallel import ParamLayout, shard_batch
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves
    from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
    from distributeddeeplearning_tpu_torch.train.schedule import constant_schedule
    from distributeddeeplearning_tpu_torch.train.state import (
        TrainState, adamw, shard_state, tree_map)
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    geo = dict(MP_WIDTH)
    seq = geo.pop("seq_len")
    params = pt.init_params(torch.Generator().manual_seed(DP_SEED + 1), max_len=seq,
                            device="cuda:0", **geo)
    sharded = mesh is not None and mesh.size > 1
    layout = (ParamLayout.from_rules(mesh, params, pt.train_rules(mesh.shape["tensor"]),
                                     pt.LOGICAL_AXES) if sharded else None)
    attention_fn = fa.make_flash_attention(mesh=mesh, causal=True) if sharded else None

    def apply_fn(p, tokens, **_):
        p = tree_map(lambda a: a.to(torch.bfloat16), p)
        return pt.forward(p, tokens, num_heads=TRAIN["num_heads"], attention="flash",
                          attention_fn=attention_fn, layout=layout).float()

    state = TrainState.create(params=params, apply_fn=apply_fn,
                              tx=adamw(constant_schedule(DP_PEAK_LR)))
    kw = {}
    if sharded:
        shard_state(state, layout)
        kw = dict(rules=pt.train_rules(mesh.shape["tensor"]), logical_axes=pt.LOGICAL_AXES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, at = tckpt.Checkpointer(save_dir, mesh=mesh if sharded else None).restore(state)
    restore_s = time.perf_counter() - t0
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    got = dict(named_leaves({k: layout.gather(v) for k, v in trees.items()}
                            if sharded else trees))
    item = {k: tckpt.read_item(os.path.join(save_dir, str(at), k))
            for k in ("params", "state")}

    def saved(name):
        top, rest = name.split("/", 1)
        key = "".join(f"['{p}']" for p in rest.split("/"))
        return (item["params"][key] if top == "params"
                else item["state"][f"['opt_state']['{top}']{key}"])

    bitwise = all(torch.equal(t.detach().cpu(), saved(k)) for k, t in got.items())
    del got
    step = build_train_step(
        state, mesh=mesh if sharded else None, compute_dtype=torch.bfloat16,
        loss_fn=lambda lg, lb, label_smoothing=0.0: pt.next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss}, **kw)
    batch = _mp_batches(np, 2 * MP_BATCH, seq, 1)[0]
    for c in FA_COUNTERS:
        setattr(fa, c, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _LaunchShapes(fa) as shapes:
        state, m = step(state, shard_batch(mesh, batch) if sharded else batch)
        loss = m["loss"].item()
    step_s = time.perf_counter() - t0
    counts = {c: getattr(fa, c) for c in FA_COUNTERS}
    del state, step
    torch.cuda.empty_cache()
    return {"step": at, "bitwise": bitwise, "counts": counts, "plain": shapes.plain,
            "shapes": sorted(set(shapes.shapes)), "loss": loss, "restore_s": restore_s,
            "step_s": step_s, "leaves": len(item["params"])}


def _mp_rank(torch, np, rank, world, ref_path, clip, save_dir):
    """Rank ``rank`` of phase 31: (b)'s three meshes against the
    one-process reference in ``ref_path``, then (a), the workload at
    tensor=2 x fsdp=2 checkpointed into ``save_dir`` and resumed."""
    from distributeddeeplearning_tpu_torch.parallel import MeshSpec, create_mesh
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves
    from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    ref = torch.load(ref_path, map_location="cpu")
    out = {"parity": {}}
    t0 = time.perf_counter()
    for name, spec in MP_MESHES:
        out["parity"][name] = _mp_parity_entry(
            torch, np, create_mesh(MeshSpec(**spec)), clip, ref)
    # (d) data=2 x tensor=2 over two slices, the nodes reported 0, 1, 0, 1
    os.environ["GROUP_RANK"] = str(MP_SLICE_NODES[rank])
    try:
        mesh = create_mesh(MeshSpec(data=2, tensor=2), num_slices=2)
    finally:
        del os.environ["GROUP_RANK"]
    with _LaunchShapes(fa) as shapes:
        entry = _mp_parity_entry(torch, np, mesh, clip, ref)
    entry.update(shapes=sorted(set(shapes.shapes)), plain=shapes.plain,
                 order=mesh.order, data_index=mesh.data_index(),
                 tensor_nodes=[MP_SLICE_NODES[r] for r in mesh.axis_ranks("tensor")],
                 data_nodes=[MP_SLICE_NODES[r] for r in mesh.axis_ranks("data_group")])
    out["parity"][MP_SLICE_NAME] = entry
    out["parity_s"] = time.perf_counter() - t0

    # (a) the workload at tensor=2 x fsdp=2 -----------------------------------
    t0 = time.perf_counter()
    built = []
    state, fit, counts, shapes, plain, coll_s, peak = _mp_main(
        torch, fa, built, tensor=2, fsdp=2, steps_per_epoch=MP_STEPS,
        batch_size=MP_BATCH, save_filepath=save_dir, distributed=True, device="cuda:0")
    step = built[0]
    layout = state.layout
    mesh = layout.mesh
    saved = {k: t.detach().cpu().clone() for k, t in named_leaves(
        {"params": state.params, "mu": state.opt_state["mu"],
         "nu": state.opt_state["nu"]})}
    out["a"] = {
        "losses": step.losses, "wall_ms": step.wall_ms, "event_ms": step.event_ms(),
        "inside_ms": step.inside_ms,
        "collectives": step.collectives, "staged": step.staged,
        "digests": step.digests, "counts": counts, "shapes": shapes, "plain": plain,
        "collective_host_s": coll_s, "peak_gb": peak,
        "eval": fit.final_eval_metrics, "step": state.step,
        "param_bytes": _tree_bytes(state.params),
        "opt_bytes": _tree_bytes({k: state.opt_state[k] for k in ("mu", "nu")}),
        "count_bytes": state.opt_state["count"].numel() * 4,
        "expected_bytes": _mp_expected_bytes(torch, mesh, layout),
        "data_index": mesh.data_index(), "tensor_index": mesh.axis_index("tensor"),
        "wall_s": time.perf_counter() - t0}
    del state, fit, built, step
    torch.cuda.empty_cache()

    # ... resumed from the generation for one more step -------------------
    t0 = time.perf_counter()
    restored = {}
    original = tckpt.Checkpointer.restore

    def restore(self, template, **kw):
        template, got = original(self, template, **kw)
        restored.update({k: t.detach().cpu().clone() for k, t in named_leaves(
            {"params": template.params, "mu": template.opt_state["mu"],
             "nu": template.opt_state["nu"]})})
        restored["step"] = got
        return template, got

    tckpt.Checkpointer.restore = restore
    built = []
    try:
        state, fit, counts2, _, _, _, _ = _mp_main(
            torch, fa, built, tensor=2, fsdp=2, steps_per_epoch=MP_STEPS + 1,
            batch_size=MP_BATCH, save_filepath=save_dir, distributed=True,
            device="cuda:0")
    finally:
        tckpt.Checkpointer.restore = original
    out["resume"] = {
        "restored_step": restored.pop("step", None), "step": state.step,
        "bitwise": sorted(restored) == sorted(saved) and all(
            torch.equal(restored[k], saved[k]) for k in saved),
        "losses": built[0].losses, "counts": counts2,
        "wall_s": time.perf_counter() - t0}
    del state, fit, built
    torch.cuda.empty_cache()
    # (c) the generation restored on fsdp=4, then one step there
    out["reshard"] = _mp_restored_step(torch, np, create_mesh(MeshSpec(fsdp=4)), save_dir)
    return out


def phase_model_parallel_train(torch, np, F, fa, card):
    """Phase 31 (module docstring): tensor-parallel and FSDP training over
    four gloo ranks sharing the card.  Tolerances of (b), f32, each mesh
    against one process on the card: the sharded step sums the same
    products in another order (row-parallel partial sums over the tensor
    group added in f32, gradients reduce-scattered over fsdp and summed
    over the data axes, the loss a mean of shard means), which moves f32
    results by a few ulps (the CPU tests measure 2.3e-7 relative on the
    losses and 4.9e-7 of a leaf's largest |g|); attention is the same
    kernels over fewer heads and rows, bitwise the all-heads rows (phase
    27).  So: losses within MP_LOSS_RTOL (1e-5) relative, each leaf's
    first-step gradient within MP_GRAD_TOL (1e-5) of its largest |g|, and
    the clip norm (set at half the unclipped first-step norm, so the
    mixed-tree norm decides the update) within MP_NORM_RTOL (1e-6)
    relative.  Returns (the bf16 K1-K3 launches a path, the f32 ones, the
    bf16 entries at the per-rank shape)."""
    import tempfile

    refs = _mp_references(torch, np, fa, card)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks("_mp_rank", MP_RANKS, *_mp_rank_args(torch, refs, tmp))
        one_restore = _mp_restored_step(torch, np, None, os.path.join(tmp, "mp-ckpt"))
    log(f"[time] phase_model_parallel_train (ranks): {time.perf_counter() - t0:.1f} s")
    return _mp_checks(torch, np, F, fa, card, ranks, refs, one_restore)


def _mp_references(torch, np, fa, card):
    """Phase 31's one-process references on the card: (b)'s losses,
    gradients and norms with the clip at half the unclipped first-step
    norm, and (a)'s one-process step p50 and peak at the same global
    batch."""
    t0 = time.perf_counter()
    # (b)'s one-process reference on the card, its clip at half the norm
    norm = _mp_parity_fit(torch, np, None, 1e30)[2][0]
    clip = norm / 2
    ref_losses, ref_grads, ref_norms, _ = _mp_parity_fit(torch, np, None, clip)
    log(f"[mp-parity] one process: f32, {MP_PARITY['num_layers']} layers at full "
        f"width, seq {MP_PARITY['seq_len']}, {MP_PARITY['rows']} rows: losses "
        f"{[round(x, 6) for x in ref_losses]}, unclipped first-step norm {norm:.6f}, "
        f"clip {clip:.6f}")
    # (a)'s one-process run at the same global batch (2 shards x 2 rows)
    built = []
    _, one_fit, one_counts, _, _, _, one_peak = _mp_main(
        torch, fa, built, steps_per_epoch=MP_STEPS, batch_size=2 * MP_BATCH,
        device="cuda")
    one = built[0]
    one_p50 = float(np.median(one.event_ms()[1:]))
    log(f"[mp-train] one process, B=4 (the sharded run's global batch): losses "
        f"{[round(x, 5) for x in one.losses]}, step ms (CUDA events) "
        f"{[round(x, 1) for x in one.event_ms()]}, p50 {one_p50:.1f}, peak memory "
        f"{one_peak:.2f} GB on {card}")
    del one_fit, built, one
    torch.cuda.empty_cache()
    log(f"[time] phase_model_parallel_train (one process): {time.perf_counter() - t0:.1f} s")
    return {"clip": clip, "ref": {"losses": ref_losses, "grads": ref_grads,
                                  "norms": ref_norms},
            "one_p50": one_p50, "one_peak": one_peak}


def _mp_rank_args(torch, refs, tmp):
    """``_mp_rank``'s arguments: the references saved under ``tmp`` (the
    ranks load them), the clip and the checkpoint directory."""
    ref_path = os.path.join(tmp, "mp-ref.pt")
    torch.save(refs.pop("ref"), ref_path)
    return ref_path, refs["clip"], os.path.join(tmp, "mp-ckpt")


def _mp_reshard_check(got, one, where, rows, card):
    """(c)'s checks of one restore-then-step: the generation's step, its
    arrays bitwise, bf16 K1-K3 launched once a layer at ``rows`` rows and
    all 12 heads, and the loss within MP_RESHARD_LOSS_RTOL of one
    process's from the same generation on the same global batch."""
    layers = MP_WIDTH["num_layers"]
    want = {c: 0 for c in FA_COUNTERS}
    want.update({"launches_bf16": layers, "launches_dq_bf16": layers,
                 "launches_dkv_bf16": layers})
    rel = abs(got["loss"] - one["loss"]) / abs(one["loss"])
    log(f"[mp-reshard] {where}: restored generation {got['step']} (saved on tensor=2 x "
        f"fsdp=2), {got['leaves']} params leaves and their moments bitwise: "
        f"{got['bitwise']}; restore {got['restore_s']:.2f} s; one step {got['step_s']:.2f} s, "
        f"loss {got['loss']:.5f} against one process's {one['loss']:.5f} (|d| / loss "
        f"{rel:.2e}, tolerance {MP_RESHARD_LOSS_RTOL:g}); bf16 K1/K2/K3 launches "
        f"{[got['counts'][c] for c in ('launches_bf16', 'launches_dq_bf16', 'launches_dkv_bf16')]}"
        f" at {got['shapes']} (B, H) on {card}")
    if (not got["bitwise"] or got["step"] != MP_STEPS + 1 or got["counts"] != want
            or got["plain"] or rel > MP_RESHARD_LOSS_RTOL or not math.isfinite(got["loss"])
            or got["shapes"] != [(k, rows, TRAIN["num_heads"]) for k in ("dkv", "dq", "fwd")]):
        raise AssertionError(f"[mp-reshard] {where}: {got}")


def _mp_checks(torch, np, F, fa, card, ranks, refs, one_restore):
    """Phase 31's checks of the ranks' results (its docstring), with
    ``one_restore``, (c)'s restore of the same generation in one process;
    then the bf16 K1-K3 at a rank's shape; returns what the phase
    returns."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa_mod

    layers = MP_WIDTH["num_layers"]
    heads = TRAIN["num_heads"] // 2
    bf16 = {"fwd": "launches_bf16", "dq": "launches_dq_bf16", "dkv": "launches_dkv_bf16"}
    f32 = {"fwd": "launches", "dq": "launches_dq", "dkv": "launches_dkv"}
    one_p50, one_peak = refs["one_p50"], refs["one_peak"]
    launches_bf16, launches_f32 = {}, {}
    # (b) --------------------------------------------------------------------
    for rank, out in enumerate(ranks):
        for name, got in out["parity"].items():
            want = {c: 0 for c in ("launches", "launches_dq", "launches_dkv")}
            per = MP_PARITY["num_layers"] * MP_PARITY["steps"]
            want.update({c: per for c in want})
            log(f"[mp-parity] rank {rank} {name}: losses {[round(x, 6) for x in got['losses']]}"
                f" (|dloss| / loss vs one process {[f'{x:.2e}' for x in got['loss_rel']]},"
                f" tolerance {MP_LOSS_RTOL:g}); first-step gradient: worst leaf "
                f"{got['grad_worst']} at {got['grad_gap']:.2e} of its largest |g| "
                f"(tolerance {MP_GRAD_TOL:g}); clip norms {[round(x, 6) for x in got['norms']]}"
                f" (relative {[f'{x:.2e}' for x in got['norm_rel']]}, tolerance "
                f"{MP_NORM_RTOL:g}); f32 K1/K2/K3 launches {list(got['counts'].values())}")
            if (not got["grad_keys"] or max(got["loss_rel"]) > MP_LOSS_RTOL
                    or got["grad_gap"] > MP_GRAD_TOL or got["norm_rel"][0] > MP_NORM_RTOL
                    or len(got["losses"]) != MP_PARITY["steps"]):
                raise AssertionError(f"[mp-parity] rank {rank} {name} left one process")
            if got["counts"] != want:
                raise AssertionError(f"[mp-parity] rank {rank} {name}: f32 launches "
                                     f"{got['counts']}, expected {want}")
            launches_f32[f"mp_parity_{name}_rank{rank}"] = {
                k: got["counts"][v] for k, v in f32.items()}
        # (d): the slice boundary outermost on data, K1-K3 at a rank's shape
        got = out["parity"][MP_SLICE_NAME]
        rows = MP_PARITY["rows"] // 2
        log(f"[mp-slices] rank {rank} on node {MP_SLICE_NODES[rank]}: data=2 x tensor=2 "
            f"over 2 slices, mesh order {got['order']}, data shard {got['data_index']}; "
            f"its tensor group's nodes {got['tensor_nodes']}, its data group's "
            f"{got['data_nodes']}; f32 K1-K3 launch shapes {got['shapes']} (B, H) on {card}")
        if (len(set(got["tensor_nodes"])) != 1 or set(got["data_nodes"]) != {0, 1}
                or tuple(got["order"] or ()) != (0, 2, 1, 3) or got["plain"]
                or got["shapes"] != [(k, rows, heads) for k in ("dkv", "dq", "fwd")]):
            raise AssertionError(f"[mp-slices] rank {rank}: {got}")
    # (a) --------------------------------------------------------------------
    a0 = ranks[0]["a"]
    for rank, out in enumerate(ranks):
        a, res = out["a"], out["resume"]
        want = {c: 0 for c in FA_COUNTERS}
        want.update({bf16["fwd"]: layers * (MP_STEPS + MP_EVAL_BATCHES),
                     bf16["dq"]: layers * MP_STEPS, bf16["dkv"]: layers * MP_STEPS})
        if a["counts"] != want or a["plain"]:
            raise AssertionError(f"[mp-train] rank {rank}: launches {a['counts']}, plain "
                                 f"{a['plain']}; expected {want}")
        if a["shapes"] != [("dkv", MP_BATCH, heads), ("dq", MP_BATCH, heads),
                           ("fwd", MP_BATCH, heads)]:
            raise AssertionError(f"[mp-train] rank {rank}: launch shapes {a['shapes']}")
        if a["losses"] != a0["losses"] or not all(math.isfinite(x) for x in a["losses"]):
            raise AssertionError(f"[mp-train] rank {rank}: losses {a['losses']} vs rank 0's "
                                 f"{a0['losses']}")
        if a["digests"] != a0["digests"]:
            raise AssertionError(f"[mp-train] rank {rank}: replicated leaves differ "
                                 "from rank 0's")
        if any(c != MP_STEP_COLLECTIVES for c in a["collectives"]):
            raise AssertionError(f"[mp-train] rank {rank}: collectives a step "
                                 f"{a['collectives']}, predicted {MP_STEP_COLLECTIVES}")
        if (a["param_bytes"] != a["expected_bytes"]
                or a["opt_bytes"] != 2 * a["expected_bytes"]):
            raise AssertionError(f"[mp-train] rank {rank}: param/optimizer bytes "
                                 f"{a['param_bytes']}/{a['opt_bytes']}, shards sum to "
                                 f"{a['expected_bytes']}")
        if not res["bitwise"] or res["restored_step"] != MP_STEPS or \
                res["step"] != MP_STEPS + 1 or not all(math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"[mp-train] rank {rank}: resume {res}")
        p50 = float(np.median(a["event_ms"][1:]))
        log(f"[mp-train] rank {rank} (data shard {a['data_index']}, tensor "
            f"{a['tensor_index']}) tensor=2 x fsdp=2, bf16, flash: losses "
            f"{[round(x, 5) for x in a['losses']]} (bitwise rank 0's), eval "
            f"{ {k: round(v, 5) for k, v in (a['eval'] or {}).items()} }; step ms "
            f"(CUDA events) {[round(x, 1) for x in a['event_ms']]}, p50 {p50:.1f} "
            f"against {one_p50:.1f} for one process at B=4; host wall a step "
            f"{[round(x, 1) for x in a['wall_ms']]} ms, of it inside collectives "
            f"{[round(x, 1) for x in a['inside_ms']]} ms "
            f"({a['collective_host_s']:.2f} s over the run, eval and checkpoint in); "
            f"collectives a step {a['collectives'][0]} (predicted "
            f"{MP_STEP_COLLECTIVES}), staged through the host by gloo "
            f"{a['staged'][0]}; K1/K2/K3 launches {[a['counts'][v] for v in bf16.values()]}"
            f" at B={MP_BATCH} H={heads}; params {a['param_bytes'] / 1e9:.4f} GB, "
            f"optimizer {(a['opt_bytes'] + a['count_bytes']) / 1e9:.4f} GB (the shards' "
            f"sum); peak memory {a['peak_gb']:.2f} GB against {one_peak:.2f} for one "
            f"process; wall {a['wall_s']:.1f} s; resumed from step "
            f"{res['restored_step']} bitwise ({res['wall_s']:.1f} s), step "
            f"{MP_STEPS + 1} loss {res['losses'][0]:.5f}; on {card}")
        launches_bf16[f"mp_train_rank{rank}"] = {k: a["counts"][v] for k, v in bf16.items()}
        launches_bf16[f"mp_resume_rank{rank}"] = {k: res["counts"][v]
                                                  for k, v in bf16.items()}
        # (c): the generation restored on fsdp=4 and one step there
        rs = out["reshard"]
        _mp_reshard_check(rs, one_restore, f"rank {rank} on fsdp=4", MP_BATCH // 2, card)
        launches_bf16[f"mp_reshard_rank{rank}"] = {k: rs["counts"][v]
                                                   for k, v in bf16.items()}
    _mp_reshard_check(one_restore, one_restore, "one process", 2 * MP_BATCH, card)
    launches_bf16["mp_reshard_one_process"] = {k: one_restore["counts"][v]
                                               for k, v in bf16.items()}
    log(f"[mp-parity] (b) on the ranks: {ranks[0]['parity_s']:.1f} s")
    per_rank = _flash_at(torch, F, fa_mod, TRAIN["d_model"] // TRAIN["num_heads"],
                         heads, MP_BATCH, TRAIN["seq_len"], torch.bfloat16, card)
    for entry in per_rank.values():
        entry["launches_a_rank_a_step"] = layers
    log(f"[mp-train] the bf16 K1, K2, K3 at a rank's shape (B={MP_BATCH}, H={heads} "
        f"of {TRAIN['num_heads']}, S {TRAIN['seq_len']}, {layers} each a step): "
        f"{ {k: round(e['ms'], 4) for k, e in per_rank.items()} } ms, SDPA "
        f"{ {k: round(e['library_ms'], 4) for k, e in per_rank.items()} }, bounds "
        f"{ {k: round(e['bound_ms'], 4) for k, e in per_rank.items()} } ms on {card}")
    return launches_bf16, launches_f32, per_rank


# ---- BERT and MoE BERT over fsdp, tensor and expert (phase 32) ---------------

BMP_RANKS = 4
#: (a) and (b): bert-base at the workload's defaults (bf16, batch 8 a data
#: shard, seq 128, dropout 0.1), flash; 3 steps over 2 distinct batches a
#: shard, then one eval pass of min(16, 4 x global) / 8 = 2 batches a rank
BMP_MAIN = dict(model="bert-base", batch_size=8, seq_len=128, attention="flash",
                compute_dtype="bfloat16", dropout_rate=0.1, epochs=1,
                train_examples=16, seed=42)
BMP_STEPS = 3
BMP_EVAL_BATCHES = 2
BMP_LAYERS = 12
BMP_HEADS = 6  # a tensor rank's heads of 12
BMP_EXPERTS = 8  # (b): 8 experts, top-2, capacity 1.25, every second layer
#: (c): f32, bert-base's width cut to 2 layers, seq 128, 4 global rows, 2 steps
BMP_PARITY = dict(num_layers=2, seq_len=128, rows=4, steps=2)
BMP_PARITY_MESHES = (("tensor2-fsdp2", {"tensor": 2, "fsdp": 2}, 0),
                     ("fsdp4", {"fsdp": 4}, 0), ("data2-tensor2", {"data": 2, "tensor": 2}, 0),
                     ("data2-expert2", {"data": 2, "expert": 2}, BMP_EXPERTS),
                     ("expert2-tensor2", {"expert": 2, "tensor": 2}, BMP_EXPERTS))
#: a leaf's gradient gap over its largest |g|, floored at this share of the
#: tree's largest: the key biases' gradient is 0 (softmax does not see a
#: constant a row) and reads f32 summation noise on both sides, 4.3e-10 of
#: the tree's largest |g| apart on the card (the CPU tests floor it at 1e-6)
BMP_GRAD_FLOOR = 1e-4
#: the leaves a data shard's ranks hold alike after every step under (a)'s
#: tensor=2 x fsdp=2: LayerNorms and the head whole, the embedding's and the
#: pooler bias's fsdp blocks (the same block on both tensor ranks)
BMP_REPLICATED = ("embed_ln/scale", "layer0/attention_ln/scale", "layer11/mlp_ln/bias",
                  "head/kernel", "pooler/bias", "token_embed/embedding")
# The collectives of one train step on a rank, written down before the
# first run on the card.  (a) tensor=2 x fsdp=2 (data 1), RULES_TP: a
# layer's forward makes 2 all-reduces (Megatron's g after the attention's
# out and after mlp_out) and its backward 2 (f's gradient at the q/k/v and
# mlp_in inputs): 4 x 12; one all-reduce of the gradients of the leaves
# not split over fsdp over the data axes (the fsdp group), one of the
# metrics, and four of the clip norm (the fsdp class over fsdp, the tensor
# class over tensor, the fsdp x tensor class over both); the leaves split
# over fsdp are gathered forward and reduce-scattered backward: a layer's
# q, k, v and out kernels, the out bias, the mlp_in and mlp_out kernels
# and the mlp_out bias (8 x 12), the two embeddings and the pooler kernel.
BMP_STEP_COLLECTIVES = {"all_reduce": 4 * BMP_LAYERS + 1 + 1 + 4,
                        "all_gather": 8 * BMP_LAYERS + 3,
                        "reduce_scatter": 8 * BMP_LAYERS + 3}
# (b) expert=2 x fsdp=2 (data 1), RULES_FSDP + RULES_EP, MoE in layers 1,
# 3, .., 11: each MoE layer's combine is summed over the expert group
# forward (g) and its input's gradient backward (f): 2 x 6; one gradient
# all-reduce over the data axes, one of the metrics, three of the clip norm
# (the fsdp class over fsdp, the fsdp x expert class over both).  Gathered
# over fsdp: a dense layer's q, k, v kernels and biases, out kernel and
# bias, mlp_in and mlp_out kernels and biases (12 x 6), a MoE layer's 8
# attention leaves, its router over fsdp and over expert and w_in, b_in,
# w_out, b_out (14 x 6), the embeddings and the pooler kernel (3); and a
# MoE layer's routing all-gathers the choice counts of the 2 data shards
# (6, C8: the global batch's routing).
BMP_MOE_COLLECTIVES = {"all_reduce": 2 * 6 + 1 + 1 + 3,
                       "all_gather": 12 * 6 + 14 * 6 + 3 + 6,
                       "reduce_scatter": 12 * 6 + 14 * 6 + 3}


def _bmp_batches(np, rows, seq, steps):
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    return list(SyntheticTextDataset(length=rows * steps, seq_len=seq,
                                     seed=DP_SEED).batches(rows))


def _bmp_parity_fit(torch, np, mesh, clip, experts):
    """Phase 32(c): bert-base's width at 2 layers (MoE BERT: layer 1 a
    mixture of ``experts``), f32, flash, through ``build_train_step`` with
    the reference workload's rules on ``mesh`` (None: one process), AdamW's
    clip at ``clip``.  Returns (losses, the first step's global gradients
    on the CPU by name, clip norms, f32 bias K1-K3 launches, the first
    step's expert choices a MoE layer on this rank's rows)."""
    from distributeddeeplearning_tpu_torch.models import bert as tbert
    from distributeddeeplearning_tpu_torch.models import moe
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.parallel import (
        RULES_DP, RULES_EP, RULES_FSDP, RULES_TP, ParamLayout, shard_batch)
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves
    from distributeddeeplearning_tpu_torch.train.schedule import constant_schedule
    from distributeddeeplearning_tpu_torch.train.state import TrainState, shard_state
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    cfg = tbert.BertConfig(num_layers=BMP_PARITY["num_layers"], dropout_rate=0.0,
                           num_experts=experts)
    params = tbert.init_params(cfg, torch.Generator().manual_seed(DP_SEED),
                               device="cuda:0")
    sharded = mesh is not None and mesh.size > 1
    kw, layout = {}, None
    if sharded:
        rules = (RULES_TP if mesh.shape["tensor"] > 1 else
                 RULES_FSDP if mesh.shape["fsdp"] > 1 else RULES_DP)
        rules = list(rules) + (list(RULES_EP) if experts else [])
        axes = tbert.logical_axes(cfg)
        layout = ParamLayout.from_rules(mesh, params, rules, axes)
        kw = dict(rules=rules, logical_axes=axes)
    attention = fa.make_flash_attention(mesh=mesh if sharded else None)

    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return tbert.forward(p, ids, config=cfg, dtype=torch.float32,
                             attention_fn=attention, train=train,
                             attention_mask=attention_mask, generator=generator,
                             layout=layout)

    tx = _SpyAdamW(torch, constant_schedule(DP_PEAK_LR), clip)
    state = TrainState.create(params=params, apply_fn=apply_fn, tx=tx)
    if sharded:
        shard_state(state, layout)
    step = build_train_step(state, mesh=mesh if sharded else None,
                            compute_dtype=torch.float32, **kw)
    for c in FA_COUNTERS:
        setattr(fa, c, 0)
    losses, choices = [], []
    real_route = moe.route

    def route(*a, **k):
        r = real_route(*a, **k)
        if len(losses) == 0:
            choices.append(r.gate_idx.cpu())
        return r

    moe.route = route
    try:
        for batch in _bmp_batches(np, BMP_PARITY["rows"], BMP_PARITY["seq_len"],
                                  BMP_PARITY["steps"]):
            state, m = step(state, shard_batch(mesh, batch) if sharded else batch)
            losses.append(m["loss"].detach())
    finally:
        moe.route = real_route
    grads = tx.seen if state.layout is None else state.layout.gather(tx.seen)
    named = {k: g.detach().float().cpu() for k, g in named_leaves(grads)}
    return ([x.item() for x in losses], named, [x.item() for x in tx.norms],
            {c: getattr(fa, c) for c in ("launches_bias", "launches_dq_bias",
                                         "launches_dkv_bias")}, choices)


class _MoeLog:
    """The kept token-slots, the token-slots routed and the load-balance
    terms of every MoE layer call, by wrapping ``models.moe``'s ``route``
    and ``moe_mlp`` (kept and routed over the global batch)."""

    def __init__(self):
        from distributeddeeplearning_tpu_torch.models import moe

        self.moe, self.kept, self.slots, self.aux = moe, [], [], []
        self._orig = (moe.route, moe.moe_mlp)

    def __enter__(self):
        route, mlp = self._orig

        def rec_route(*a, **k):
            r = route(*a, **k)
            self.kept.append(r.kept.sum())
            self.slots.append(r.gate_idx.shape[1] * r.n)
            return r

        def rec_mlp(*a, **k):
            y, aux = mlp(*a, **k)
            if aux is not None:
                self.aux.append(aux.detach())
            return y, aux

        self.moe.route, self.moe.moe_mlp = rec_route, rec_mlp
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.moe_mlp = self._orig


def _bmp_main(torch, fa, built, replicated=BMP_REPLICATED, **kw):
    """``workloads.bert.main`` at BMP_MAIN with every train step it builds
    recorded (``built``) and the K1-K3 counters zeroed just before;
    returns (state, fit, counts, launch shapes, plain calls, host seconds
    inside collectives, peak GB)."""
    from distributeddeeplearning_tpu_torch.train import step as tstep
    from distributeddeeplearning_tpu_torch.workloads import bert

    original = tstep.build_train_step

    def build(*a, **k):
        built.append(_MPRecorded(torch, original(*a, **k), replicated))
        return built[-1]

    tstep.build_train_step = build
    try:
        for c in FA_COUNTERS:
            setattr(fa, c, 0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _LaunchShapes(fa) as shapes, _ClockedCollectives() as clock:
            state, fit = bert.main(**{**BMP_MAIN, **kw})
        counts = {c: getattr(fa, c) for c in FA_COUNTERS}
    finally:
        tstep.build_train_step = original
    return (state, fit, counts, sorted(set(shapes.shapes)), shapes.plain, clock.s,
            torch.cuda.max_memory_allocated() / 1e9)


def _bert_base_shapes():
    """Every leaf's global shape in bert-base's tree, from its widths."""
    v, p, h, n, i, c = 30522, 512, 768, 12, 3072, 2
    shapes = {"token_embed/embedding": (v, h), "position_embed/embedding": (p, h),
              "embed_ln/scale": (h,), "embed_ln/bias": (h,), "pooler/kernel": (h, h),
              "pooler/bias": (h,), "head/kernel": (h, c), "head/bias": (c,)}
    for layer in range(BMP_LAYERS):
        pre = f"layer{layer}/"
        for name in ("query", "key", "value"):
            shapes[f"{pre}attention/{name}/kernel"] = (h, n, h // n)
            shapes[f"{pre}attention/{name}/bias"] = (n, h // n)
        shapes.update({f"{pre}attention/out/kernel": (n, h // n, h),
                       f"{pre}attention/out/bias": (h,), f"{pre}mlp_in/kernel": (h, i),
                       f"{pre}mlp_in/bias": (i,), f"{pre}mlp_out/kernel": (i, h),
                       f"{pre}mlp_out/bias": (h,)})
        for ln in ("attention_ln", "mlp_ln"):
            shapes[f"{pre}{ln}/scale"] = shapes[f"{pre}{ln}/bias"] = (h,)
    return shapes


def _bmp_expected_bytes(torch, state):
    """This rank's parameter bytes as the sum of its shards' sizes: each
    leaf's global shape (bert-base's) cut by its spec."""
    from distributeddeeplearning_tpu_torch.parallel.sharding import local_shape

    shapes = _bert_base_shapes()
    layout = state.layout
    return sum(4 * math.prod(local_shape(shape, layout.specs[k], layout.mesh))
               for k, shape in shapes.items())


def _bmp_rank(torch, np, rank, world, ref_path, clips, save_dir):
    """Rank ``rank`` of phase 32: (c)'s meshes against the one-process
    references in ``ref_path``, then (a), the workload at tensor=2 x fsdp=2
    checkpointed into ``save_dir`` and resumed, then (b), MoE bert-base at
    expert=2 x fsdp=2."""
    from distributeddeeplearning_tpu_torch.parallel import MeshSpec, create_mesh
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves
    from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    ref = torch.load(ref_path, map_location="cpu")
    out = {"parity": {}}
    t0 = time.perf_counter()
    for name, spec, experts in BMP_PARITY_MESHES:
        mesh = create_mesh(MeshSpec(**spec))
        want = ref[experts]
        losses, grads, norms, counts, choices = _bmp_parity_fit(
            torch, np, mesh, clips[experts], experts)
        rows = len(choices[0]) if choices else 0
        shard = mesh.data_index()
        flips = [int((c != w[shard * rows:(shard + 1) * rows]).any(-1).sum())
                 for c, w in zip(choices, want["choices"])]
        top = max(g.abs().max().item() for g in want["grads"].values())
        gaps = {k: ((g - want["grads"][k]).abs().max()
                    / max(want["grads"][k].abs().max().item(), BMP_GRAD_FLOOR * top)).item()
                for k, g in grads.items()}
        worst = max(gaps, key=gaps.get)
        out["parity"][name] = {
            "losses": losses, "norms": norms, "counts": counts, "flips": flips,
            "loss_rel": [abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])],
            "norm_rel": [abs(a - b) / abs(b) for a, b in zip(norms, want["norms"])],
            "grad_gap": gaps[worst], "grad_worst": worst,
            "grad_keys": sorted(grads) == sorted(want["grads"])}
        del grads
        torch.cuda.empty_cache()
    out["parity_s"] = time.perf_counter() - t0

    # (a) bert-base at tensor=2 x fsdp=2 --------------------------------------
    t0 = time.perf_counter()
    built = []
    state, fit, counts, shapes, plain, coll_s, peak = _bmp_main(
        torch, fa, built, tensor=2, fsdp=2, steps_per_epoch=BMP_STEPS,
        save_filepath=save_dir, distributed=True, device="cuda:0")
    step = built[0]
    mesh = state.layout.mesh
    saved = {k: t.detach().cpu().clone() for k, t in named_leaves(
        {"params": state.params, "mu": state.opt_state["mu"],
         "nu": state.opt_state["nu"]})}
    out["a"] = {
        "losses": step.losses, "wall_ms": step.wall_ms, "event_ms": step.event_ms(),
        "inside_ms": step.inside_ms, "collectives": step.collectives,
        "staged": step.staged, "digests": step.digests, "counts": counts,
        "shapes": shapes, "plain": plain, "collective_host_s": coll_s, "peak_gb": peak,
        "eval": fit.final_eval_metrics, "step": state.step,
        "param_bytes": _tree_bytes(state.params),
        "opt_bytes": _tree_bytes({k: state.opt_state[k] for k in ("mu", "nu")}),
        "count_bytes": state.opt_state["count"].numel() * 4,
        "expected_bytes": _bmp_expected_bytes(torch, state),
        "data_index": mesh.data_index(), "tensor_index": mesh.axis_index("tensor"),
        "wall_s": time.perf_counter() - t0}
    del state, fit, built, step
    torch.cuda.empty_cache()

    # ... resumed from the generation for one more step -------------------
    t0 = time.perf_counter()
    restored = {}
    original = tckpt.Checkpointer.restore

    def restore(self, template, **kw):
        template, got = original(self, template, **kw)
        restored.update({k: t.detach().cpu().clone() for k, t in named_leaves(
            {"params": template.params, "mu": template.opt_state["mu"],
             "nu": template.opt_state["nu"]})})
        restored["step"] = got
        return template, got

    tckpt.Checkpointer.restore = restore
    built = []
    try:
        state, fit, counts2, _, _, _, _ = _bmp_main(
            torch, fa, built, tensor=2, fsdp=2, steps_per_epoch=BMP_STEPS + 1,
            save_filepath=save_dir, distributed=True, device="cuda:0")
    finally:
        tckpt.Checkpointer.restore = original
    out["resume"] = {
        "restored_step": restored.pop("step", None), "step": state.step,
        "bitwise": sorted(restored) == sorted(saved) and all(
            torch.equal(restored[k], saved[k]) for k in saved),
        "losses": built[0].losses, "counts": counts2,
        "wall_s": time.perf_counter() - t0}
    del state, fit, built, saved, restored
    torch.cuda.empty_cache()

    # (b) MoE bert-base at expert=2 x fsdp=2 ----------------------------------
    t0 = time.perf_counter()
    built = []
    with _MoeLog() as moe_log:
        state, fit, counts, shapes, plain, coll_s, peak = _bmp_main(
            torch, fa, built, replicated=("embed_ln/scale", "head/kernel"),
            expert=2, fsdp=2, num_experts=BMP_EXPERTS, steps_per_epoch=BMP_STEPS,
            distributed=True, device="cuda:0")
    step = built[0]
    local = dict(named_leaves(state.params))
    out["b"] = {
        "losses": step.losses, "event_ms": step.event_ms(), "wall_ms": step.wall_ms,
        "inside_ms": step.inside_ms, "collectives": step.collectives,
        "digests": step.digests, "counts": counts, "shapes": shapes, "plain": plain,
        "peak_gb": peak, "eval": fit.final_eval_metrics,
        "experts_held": {k: tuple(t.shape) for k, t in local.items()
                         if k.endswith(("moe_mlp/w_in", "moe_mlp/w_out"))},
        "dropped": 1.0 - float(torch.stack(moe_log.kept).sum().item())
        / sum(moe_log.slots),
        "aux": [float(x) for x in moe_log.aux],
        "param_bytes": _tree_bytes(state.params),
        "wall_s": time.perf_counter() - t0}
    return out


def _bias_local_heads(torch, F, fa, card):
    """Phase 32(d): the bf16 bias K1, K2, K3 at a tensor rank's training
    shape (B=8, H=6 of 12, S=128, D=64, non-causal, a synthetic-text
    batch's mask), the local q, k, v strided views of each rank's own
    q/k/v projection: held against their plain versions
    (``_hold_flash``), bitwise against the all-heads launch's rows (output
    and gradients), then timed on rank 0's heads beside the plain
    versions, SDPA (bool mask) and its backward, with the bounds of the
    pairs the mask leaves visible.  Returns {kernel: entry}."""
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    b, s, d, h, hl = 8, BMP_MAIN["seq_len"], 64, 12, BMP_HEADS
    mask = next(SyntheticTextDataset(length=b, seq_len=s, seed=DP_SEED).batches(b))[
        "attention_mask"]
    keep = torch.from_numpy(mask).bool().cuda()
    g = torch.Generator(device="cuda").manual_seed(32)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").bfloat16()
    do = torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
    full = qkv.clone().requires_grad_(True)
    q, k, v = (t.reshape(b, s, h, d) for t in full.split(h * d, dim=-1))
    o_all = fa.flash_attention(q, k, v, keep[:, None, None, :])
    (o_all.float() * do.float()).sum().backward()
    bias = fa._mask_bias(keep[:, None, None, :], b, s)
    worst, same = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}, True
    for r in range(2):
        cols = [j * h * d + r * hl * d for j in range(3)]
        mine = torch.cat([qkv[..., c:c + hl * d] for c in cols], -1)
        mine = mine.clone().requires_grad_(True)
        ql, kl, vl = (t.reshape(b, s, hl, d) for t in mine.split(hl * d, dim=-1))
        fn = fa.make_flash_attention(mesh=_tp_mesh(r))
        o = fn(ql, kl, vl, keep[:, None, None, :], dtype=torch.bfloat16)
        (o.float() * _local(do, r, 2).float()).sum().backward()
        grad_all = torch.cat([full.grad[..., c:c + hl * d] for c in cols], -1)
        torch.cuda.synchronize()
        rows = (torch.equal(o, o_all[:, :, r * hl:(r + 1) * hl]),
                torch.equal(mine.grad, grad_all))
        errs, (lse, _, do_r, delta, _) = _hold_flash(
            torch, fa, ql.detach(), kl.detach(), vl.detach(), False, seed=33 + r,
            what=f"bf16 bias local heads rank {r}", bias=bias)
        worst = {kern: max(worst[kern], e) for kern, e in errs.items()}
        same = same and all(rows)
        log(f"[bert-mp] bf16 bias K1-K3 over heads {r * hl}..{(r + 1) * hl - 1} "
            f"(B={b} S={s}, BERT's mask): held against the plain versions (max "
            f"|kernel - plain| K1 {errs['fwd']:.3e}, K2 {errs['dq']:.3e}, K3 "
            f"{errs['dkv']:.3e}); bitwise the all-heads launch's rows: output "
            f"{rows[0]}, gradients {rows[1]}")
        if not all(rows):
            raise AssertionError(f"[bert-mp] bias K1-K3 over rank {r}'s heads differ "
                                 "from the all-heads launch's rows")
        if r == 0:
            times = _time_flash(torch, F, fa, ql.detach(), kl.detach(), vl.detach(),
                                do_r, lse, delta, causal=False, bias=bias, keep=keep)
    fwd_ms, fwd_plain, fwd_lib, dq_ms, dkv_ms, bwd_plain, bwd_lib = times
    # the work this batch's mask needs: every query row against its row's
    # visible keys (as phase_bias counts it)
    pairs = hl * s * int(keep.sum().item())
    head = 2.0 * b * s * hl * d
    small, bias_bytes = 4.0 * b * hl * s, 4.0 * b * s
    bounds = {"fwd": bound_ms(4 * head + small + bias_bytes, 4.0 * d * pairs,
                              BF16_FLOPS_PER_S),
              "dq": bound_ms(5 * head + 2 * small + bias_bytes, 6.0 * d * pairs,
                             BF16_FLOPS_PER_S),
              "dkv": bound_ms(6 * head + 2 * small + bias_bytes, 8.0 * d * pairs,
                              BF16_FLOPS_PER_S)}
    shape = (f"B={b} H={hl} (a tensor rank's heads of {h}) S={s} D={d} non-causal "
             f"bf16, BERT's mask ({int(keep.sum().item())} of {b * s} keys visible), "
             "strided views of the rank's q/k/v projection")
    log(f"[bert-mp] bf16 bias at B={b} H={hl} S={s} D={d}: K1 {fwd_ms:.4f} ms (plain "
        f"{fwd_plain:.4f}, sdpa {fwd_lib:.4f}, bound {bounds['fwd'][0]:.4f} "
        f"{bounds['fwd'][1]}), K2 {dq_ms:.4f} ms (bound {bounds['dq'][0]:.4f} "
        f"{bounds['dq'][1]}), K3 {dkv_ms:.4f} ms (bound {bounds['dkv'][0]:.4f} "
        f"{bounds['dkv'][1]}), plain backward {bwd_plain:.4f}, sdpa backward "
        f"{bwd_lib:.4f}; device times, on {card}")
    return {kern: dict(ms=ms, plain_ms=pl, bound_ms=bounds[kern][0],
                       bound_by=bounds[kern][1], library_ms=lib,
                       max_abs_err=worst[kern], bitwise_all_heads=same, shape=shape,
                       launches_a_rank_a_step=BMP_LAYERS)
            for kern, ms, pl, lib in (("fwd", fwd_ms, fwd_plain, fwd_lib),
                                      ("dq", dq_ms, bwd_plain, bwd_lib),
                                      ("dkv", dkv_ms, bwd_plain, bwd_lib))}


def phase_bert_model_parallel(torch, np, F, fa, card):
    """Phase 32 (module docstring): BERT and MoE BERT over the fsdp, tensor
    and expert axes on four gloo ranks sharing the card.  Tolerances of
    (c), f32, each mesh against one process on the card, as phase 31's:
    the sharded step sums the same products in other orders (partial sums
    over the tensor and expert groups added in f32, gradients
    reduce-scattered over fsdp, the loss a mean of shard means); the CPU
    tests (``tests/test_torch_bert_parallel.py``) measure 1.1e-7 relative
    on the losses and 4.3e-7 of a leaf's largest |g| on the gradients.  So:
    losses within MP_LOSS_RTOL (1e-5), each leaf's first-step gradient
    within MP_GRAD_TOL (1e-5) of its largest |g| floored at BMP_GRAD_FLOOR
    of the tree's (the key biases' exact-zero gradient), the clip norm (at
    half the unclipped first-step norm) within MP_NORM_RTOL (1e-6); MoE
    BERT's expert choices compared first, each rank's rows against one
    process's, no flip allowed.  Returns (the bf16 bias K1-K3 launches a
    path, the f32 ones, the entries at the per-rank shape)."""
    import tempfile

    refs = _bmp_references(torch, np, fa, card)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks("_bmp_rank", BMP_RANKS, *_bmp_rank_args(torch, refs, tmp))
    _log_bmp_ranks(ranks, t0)
    return _bmp_checks(torch, np, F, fa, card, ranks, refs)


def _bmp_references(torch, np, fa, card):
    """Phase 32's one-process references on the card: (c)'s losses,
    gradients, norms and expert choices (BERT and MoE BERT) with the clip
    at half the unclipped first-step norm, and (a)'s one process at the
    same global batch."""
    t0 = time.perf_counter()
    refs, clips = {}, {}
    for experts in (0, BMP_EXPERTS):
        norm = _bmp_parity_fit(torch, np, None, 1e30, experts)[2][0]
        clips[experts] = norm / 2
        losses, grads, norms, _, choices = _bmp_parity_fit(torch, np, None, norm / 2,
                                                           experts)
        refs[experts] = {"losses": losses, "grads": grads, "norms": norms,
                         "choices": choices}
        log(f"[bert-mp-parity] one process, {'MoE ' if experts else ''}bert-base "
            f"width, f32, {BMP_PARITY['num_layers']} layers, seq "
            f"{BMP_PARITY['seq_len']}, {BMP_PARITY['rows']} rows: losses "
            f"{[round(x, 6) for x in losses]}, unclipped first-step norm {norm:.6f}")
    # (a)'s one process at the same global batch (2 data shards x 8 rows)
    built = []
    state, _, _, _, _, _, one_peak = _bmp_main(
        torch, fa, built, batch_size=2 * BMP_MAIN["batch_size"],
        steps_per_epoch=BMP_STEPS, device="cuda")
    one = built[0]
    one_p50 = float(np.median(one.event_ms()[1:]))
    one_bytes = (_tree_bytes(state.params),
                 _tree_bytes({k: state.opt_state[k] for k in ("mu", "nu")}))
    log(f"[bert-mp] one process, B=16 (the sharded run's global batch): losses "
        f"{[round(x, 5) for x in one.losses]}, step ms (CUDA events) "
        f"{[round(x, 1) for x in one.event_ms()]}, p50 {one_p50:.1f}, params "
        f"{one_bytes[0] / 1e9:.4f} GB, optimizer {one_bytes[1] / 1e9:.4f} GB, peak "
        f"memory {one_peak:.2f} GB on {card}")
    del state, built, one
    torch.cuda.empty_cache()
    log(f"[time] phase_bert_model_parallel (one process): "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ref": refs, "clips": clips, "one_p50": one_p50, "one_peak": one_peak,
            "one_bytes": one_bytes}


def _bmp_restored_eval(torch, np, save_dir):
    """Phase 32(e): bert-base as (a)'s workload builds it, in one process,
    restored from ``save_dir``'s newest generation (saved over ``tensor=2 x
    fsdp=2`` by (a)'s resume), then one eval batch of the workload's eval
    stream (data shard 0's 8 rows) through ``build_eval_step`` at bf16 with
    flash.  Returns the restored step, whether the params and AdamW
    moments are bitwise the generation's, the metrics, the bias K1
    launches and shapes, and the restore wall."""
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.parallel.sharding import named_leaves
    from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
    from distributeddeeplearning_tpu_torch.train.schedule import constant_schedule
    from distributeddeeplearning_tpu_torch.train.state import TrainState, adamw
    from distributeddeeplearning_tpu_torch.train.step import build_eval_step
    from distributeddeeplearning_tpu_torch.workloads import bert

    net = get_model("bert-base", num_classes=2, vocab_size=30522,
                    dropout_rate=BMP_MAIN["dropout_rate"], dtype=torch.bfloat16,
                    attention_fn=fa.make_flash_attention(), num_experts=0)

    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return net(p, ids, train=train, attention_mask=attention_mask,
                   token_type_ids=token_type_ids, generator=generator)

    state = TrainState.create(
        params=net.init_params(torch.Generator().manual_seed(DP_SEED + 1), device="cuda:0"),
        apply_fn=apply_fn, tx=adamw(constant_schedule(1e-5)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, at = tckpt.Checkpointer(save_dir).restore(state)
    restore_s = time.perf_counter() - t0
    item = {k: tckpt.read_item(os.path.join(save_dir, str(at), k))
            for k in ("params", "state")}
    got = dict(named_leaves({"params": state.params, "mu": state.opt_state["mu"],
                             "nu": state.opt_state["nu"]}))

    def saved(name):
        top, rest = name.split("/", 1)
        key = "".join(f"['{p}']" for p in rest.split("/"))
        return (item["params"][key] if top == "params"
                else item["state"][f"['opt_state']['{top}']{key}"])

    bitwise = all(torch.equal(t.detach().cpu(), saved(k)) for k, t in got.items())
    step = build_eval_step(state, compute_dtype=torch.bfloat16)
    batch = next(bert._batches(BMP_MAIN["batch_size"], BMP_MAIN["seq_len"], 30522, 2,
                               BMP_MAIN["seed"], BMP_MAIN["train_examples"],
                               is_training=False))
    for c in FA_COUNTERS:
        setattr(fa, c, 0)
    with _LaunchShapes(fa) as shapes:
        metrics = {k: float(v) for k, v in step(state, batch).items()}
    counts = {c: getattr(fa, c) for c in FA_COUNTERS}
    del state, step
    torch.cuda.empty_cache()
    return {"step": at, "bitwise": bitwise, "leaves": len(item["params"]),
            "metrics": metrics, "counts": counts, "shapes": sorted(set(shapes.shapes)),
            "plain": shapes.plain, "restore_s": restore_s}


def _bmp_restore_check(got, card):
    """(e)'s checks: the generation's step, its arrays bitwise, finite
    metrics, the bf16 bias K1 once a layer at 8 rows and 12 heads."""
    want = {c: 0 for c in FA_COUNTERS}
    want["launches_bias_bf16"] = BMP_LAYERS
    log(f"[bert-reshard] one process: restored generation {got['step']} (saved on "
        f"tensor=2 x fsdp=2), {got['leaves']} params leaves and their moments bitwise: "
        f"{got['bitwise']}; restore {got['restore_s']:.2f} s; one eval batch "
        f"{ {k: round(v, 5) for k, v in got['metrics'].items()} }; bias K1 launches "
        f"{got['counts']['launches_bias_bf16']} at {got['shapes']} (B, H) on {card}")
    if (not got["bitwise"] or got["step"] != BMP_STEPS + 1 or got["counts"] != want
            or got["plain"] or not all(math.isfinite(v) for v in got["metrics"].values())
            or got["shapes"] != [("fwd", BMP_MAIN["batch_size"], 2 * BMP_HEADS)]):
        raise AssertionError(f"[bert-reshard] {got}")


def _bmp_rank_args(torch, refs, tmp):
    """``_bmp_rank``'s arguments: the references saved under ``tmp``, the
    clips and the checkpoint directory."""
    ref_path = os.path.join(tmp, "bmp-ref.pt")
    torch.save(refs.pop("ref"), ref_path)
    return ref_path, refs["clips"], os.path.join(tmp, "bmp-ckpt")


def _log_bmp_ranks(ranks, t0):
    log(f"[time] phase_bert_model_parallel (ranks): {time.perf_counter() - t0:.1f} s: "
        f"(c) {ranks[0]['parity_s']:.1f} s, (a) {ranks[0]['a']['wall_s']:.1f} s, its "
        f"resume {ranks[0]['resume']['wall_s']:.1f} s, (b) {ranks[0]['b']['wall_s']:.1f} s "
        "on rank 0")


def _bmp_checks(torch, np, F, fa, card, ranks, refs):
    """Phase 32's checks of the ranks' results (its docstring), then (d);
    returns what the phase returns."""
    bf16 = {"fwd": "launches_bias_bf16", "dq": "launches_dq_bias_bf16",
            "dkv": "launches_dkv_bias_bf16"}
    f32 = {"fwd": "launches_bias", "dq": "launches_dq_bias", "dkv": "launches_dkv_bias"}
    one_p50, one_peak, one_bytes = refs["one_p50"], refs["one_peak"], refs["one_bytes"]
    launches_bf16, launches_f32 = {}, {}
    problems = []  # every failed check, raised after all are logged
    # (c) --------------------------------------------------------------------
    for rank, out in enumerate(ranks):
        for name, got in out["parity"].items():
            per = BMP_PARITY["num_layers"] * BMP_PARITY["steps"]
            want = {c: per for c in f32.values()}
            log(f"[bert-mp-parity] rank {rank} {name}: expert choices flipped "
                f"{got['flips']} (tokens a MoE layer, compared first); losses "
                f"{[round(x, 6) for x in got['losses']]} (|dloss| / loss vs one process "
                f"{[f'{x:.2e}' for x in got['loss_rel']]}, tolerance {MP_LOSS_RTOL:g}); "
                f"first-step gradient: worst leaf {got['grad_worst']} at "
                f"{got['grad_gap']:.2e} of its scale (tolerance {MP_GRAD_TOL:g}); clip "
                f"norms relative {[f'{x:.2e}' for x in got['norm_rel']]} (tolerance "
                f"{MP_NORM_RTOL:g}); f32 bias K1/K2/K3 launches "
                f"{list(got['counts'].values())}")
            if any(got["flips"]):
                problems.append(f"[bert-mp-parity] rank {rank} {name}: expert "
                                f"choices flipped {got['flips']}")
            if (not got["grad_keys"] or max(got["loss_rel"]) > MP_LOSS_RTOL
                    or got["grad_gap"] > MP_GRAD_TOL or got["norm_rel"][0] > MP_NORM_RTOL
                    or len(got["losses"]) != BMP_PARITY["steps"]):
                problems.append(f"[bert-mp-parity] rank {rank} {name} left one "
                                "process")
            if got["counts"] != want:
                problems.append(f"[bert-mp-parity] rank {rank} {name}: f32 bias "
                                f"launches {got['counts']}, expected {want}")
            launches_f32[f"bert_mp_parity_{name}_rank{rank}"] = {
                k: got["counts"][v] for k, v in f32.items()}
    # (a) --------------------------------------------------------------------
    a0 = ranks[0]["a"]
    for rank, out in enumerate(ranks):
        a, res = out["a"], out["resume"]
        want = {c: 0 for c in FA_COUNTERS}
        want.update({bf16["fwd"]: BMP_LAYERS * (BMP_STEPS + BMP_EVAL_BATCHES),
                     bf16["dq"]: BMP_LAYERS * BMP_STEPS,
                     bf16["dkv"]: BMP_LAYERS * BMP_STEPS})
        b = BMP_MAIN["batch_size"]
        if a["counts"] != want or a["plain"]:
            problems.append(f"[bert-mp] rank {rank}: launches {a['counts']}, plain "
                            f"{a['plain']}; expected {want}")
        if a["shapes"] != [("dkv", b, BMP_HEADS), ("dq", b, BMP_HEADS),
                           ("fwd", b, BMP_HEADS)]:
            problems.append(f"[bert-mp] rank {rank}: launch shapes {a['shapes']}")
        if a["losses"] != a0["losses"] or not all(math.isfinite(x) for x in a["losses"]):
            problems.append(f"[bert-mp] rank {rank}: losses {a['losses']} vs rank "
                            f"0's {a0['losses']}")
        same_shard = [o["a"] for o in ranks if o["a"]["data_index"] == a["data_index"]]
        if any(o["digests"] != a["digests"] for o in same_shard):
            problems.append(f"[bert-mp] rank {rank}: the leaves its shard's ranks "
                            "hold alike differ")
        if any(c != BMP_STEP_COLLECTIVES for c in a["collectives"]):
            problems.append(f"[bert-mp] rank {rank}: collectives a step "
                            f"{a['collectives']}, predicted {BMP_STEP_COLLECTIVES}")
        if (a["param_bytes"] != a["expected_bytes"]
                or a["opt_bytes"] != 2 * a["expected_bytes"]):
            problems.append(f"[bert-mp] rank {rank}: param/optimizer bytes "
                            f"{a['param_bytes']}/{a['opt_bytes']}, shards sum to "
                            f"{a['expected_bytes']}")
        if not res["bitwise"] or res["restored_step"] != BMP_STEPS or \
                res["step"] != BMP_STEPS + 1 or not all(math.isfinite(x)
                                                        for x in res["losses"]):
            problems.append(f"[bert-mp] rank {rank}: resume {res}")
        p50 = float(np.median(a["event_ms"][1:]))
        share = sum(a["inside_ms"][1:]) / max(sum(a["wall_ms"][1:]), 1e-9)
        log(f"[bert-mp] rank {rank} (data shard {a['data_index']}, tensor "
            f"{a['tensor_index']}) bert-base tensor=2 x fsdp=2, bf16, flash, dropout "
            f"0.1: losses {[round(x, 5) for x in a['losses']]} (bitwise rank 0's), eval "
            f"{ {k: round(v, 5) for k, v in (a['eval'] or {}).items()} }; step ms (CUDA "
            f"events) {[round(x, 1) for x in a['event_ms']]}, p50 {p50:.1f} against "
            f"{one_p50:.1f} for one process at B=16; host wall a step "
            f"{[round(x, 1) for x in a['wall_ms']]} ms, inside collectives "
            f"{[round(x, 1) for x in a['inside_ms']]} ms ({share:.1%} of steps 2..); "
            f"collectives a step {a['collectives'][0]} (predicted "
            f"{BMP_STEP_COLLECTIVES}), staged through the host by gloo "
            f"{a['staged'][0]}; bf16 bias K1/K2/K3 launches "
            f"{[a['counts'][v] for v in bf16.values()]} at B={b} H={BMP_HEADS}; params "
            f"{a['param_bytes'] / 1e9:.4f} GB, optimizer "
            f"{(a['opt_bytes'] + a['count_bytes']) / 1e9:.4f} GB (the shards' sum) "
            f"against {one_bytes[0] / 1e9:.4f} / {one_bytes[1] / 1e9:.4f} for one "
            f"process; peak memory {a['peak_gb']:.2f} GB against {one_peak:.2f}; wall "
            f"{a['wall_s']:.1f} s; resumed from step {res['restored_step']} bitwise "
            f"({res['wall_s']:.1f} s), step {BMP_STEPS + 1} loss {res['losses'][0]:.5f}; "
            f"on {card}")
        launches_bf16[f"bert_mp_train_rank{rank}"] = {k: a["counts"][v]
                                                      for k, v in bf16.items()}
        launches_bf16[f"bert_mp_resume_rank{rank}"] = {k: res["counts"][v]
                                                       for k, v in bf16.items()}
    # (b) --------------------------------------------------------------------
    b0 = ranks[0]["b"]
    n_moe = BMP_LAYERS // 2
    for rank, out in enumerate(ranks):
        mb = out["b"]
        want = {c: 0 for c in FA_COUNTERS}
        want.update({bf16["fwd"]: BMP_LAYERS * (BMP_STEPS + BMP_EVAL_BATCHES),
                     bf16["dq"]: BMP_LAYERS * BMP_STEPS,
                     bf16["dkv"]: BMP_LAYERS * BMP_STEPS})
        held = set(mb["experts_held"].values())
        if mb["counts"] != want or mb["plain"] or mb["shapes"] != [
                ("dkv", 8, 12), ("dq", 8, 12), ("fwd", 8, 12)]:
            problems.append(f"[moe-mp] rank {rank}: launches {mb['counts']} at "
                            f"{mb['shapes']}, plain {mb['plain']}; expected {want}")
        if len(mb["experts_held"]) != 2 * n_moe or {s[0] for s in held} != {
                BMP_EXPERTS // 2}:
            problems.append(f"[moe-mp] rank {rank}: expert weights held "
                            f"{mb['experts_held']}")
        if any(c != BMP_MOE_COLLECTIVES for c in mb["collectives"]):
            problems.append(f"[moe-mp] rank {rank}: collectives a step "
                            f"{mb['collectives']}, predicted {BMP_MOE_COLLECTIVES}")
        if mb["losses"] != b0["losses"] or not all(math.isfinite(x) for x in mb["losses"]) \
                or any(o["b"]["digests"] != mb["digests"] for o in ranks):
            problems.append(f"[moe-mp] rank {rank}: losses {mb['losses']} or the "
                            "whole leaves differ from rank 0's")
        aux = [sum(mb["aux"][i * n_moe:(i + 1) * n_moe]) / n_moe for i in range(BMP_STEPS)]
        log(f"[moe-mp] rank {rank} MoE bert-base ({BMP_EXPERTS} experts, top-2, capacity "
            f"1.25, every second layer) expert=2 x fsdp=2, bf16, flash: losses "
            f"{[round(x, 5) for x in mb['losses']]} (bitwise rank 0's); experts held "
            f"{sorted(held)} (w_in, w_out in each of {n_moe} MoE layers); load-balance "
            f"term a step (mean over the MoE layers) {[round(x, 5) for x in aux]}; "
            f"token-slots dropped over capacity {mb['dropped']:.2%} (global batch, "
            f"train and eval passes); collectives a step {mb['collectives'][0]} "
            f"(predicted {BMP_MOE_COLLECTIVES}: 6 forward and 6 backward all-reduces "
            f"over expert, 6 routing all-gathers over the data shards); step ms "
            f"{[round(x, 1) for x in mb['event_ms']]}, host inside collectives "
            f"{[round(x, 1) for x in mb['inside_ms']]} ms; params "
            f"{mb['param_bytes'] / 1e9:.4f} GB, peak {mb['peak_gb']:.2f} GB; wall "
            f"{mb['wall_s']:.1f} s on {card}")
        launches_bf16[f"moe_mp_train_rank{rank}"] = {k: mb["counts"][v]
                                                     for k, v in bf16.items()}
    per_rank = _bias_local_heads(torch, F, fa, card)
    if problems:
        raise AssertionError("; ".join(problems))
    return launches_bf16, launches_f32, per_rank


def _model_axes_rank(torch, np, rank, world, mp_args, bmp_args):
    """Phases 31 and 32 on one rank of one spawn: ``_mp_rank`` then
    ``_bmp_rank``."""
    lm = _mp_rank(torch, np, rank, world, *mp_args)
    torch.cuda.empty_cache()
    return {"lm": lm, "bert": _bmp_rank(torch, np, rank, world, *bmp_args)}


def phase_model_axes(torch, np, F, fa, card):
    """Phases 31 and 32 with their rank work in one spawn of four gloo
    ranks (one start-up of four processes saved): both phases'
    one-process references, then the ranks (31's work, then 32's), then
    each phase's checks.  Returns (phase 31's results, phase 32's)."""
    import tempfile

    mp_refs = _mp_references(torch, np, fa, card)
    bmp_refs = _bmp_references(torch, np, fa, card)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks("_model_axes_rank", MP_RANKS,
                          _mp_rank_args(torch, mp_refs, tmp),
                          _bmp_rank_args(torch, bmp_refs, tmp))
        log(f"[time] phase_model_axes (ranks, phases 31 and 32): "
            f"{time.perf_counter() - t0:.1f} s")
        # the ranks' generations restored in this process: 31(c), 32(e)
        t1 = time.perf_counter()
        one_restore = _mp_restored_step(torch, np, None, os.path.join(tmp, "mp-ckpt"))
        bert_restore = _bmp_restored_eval(torch, np, os.path.join(tmp, "bmp-ckpt"))
        log(f"[time] phase_model_axes (one-process restores): "
            f"{time.perf_counter() - t1:.1f} s")
    _log_bmp_ranks([r["bert"] for r in ranks], t0)
    _bmp_restore_check(bert_restore, card)
    return (_mp_checks(torch, np, F, fa, card, [r["lm"] for r in ranks], mp_refs,
                       one_restore),
            _bmp_checks(torch, np, F, fa, card, [r["bert"] for r in ranks], bmp_refs))


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
    early = None
    try:
        resolve_device("cuda")  # TF32 off: the parity contract is f32
        set_peaks(torch)
        t_start = time.perf_counter()
        card = card_line()
        log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
        # phase 30's shards and its python -m run go beside the build
        early = _ImagenetEarly()
        t0 = time.perf_counter()
        times = _build.build_all()
        log(f"[build] {len(times)} kernels in {time.perf_counter() - t0:.2f} s "
            f"(parallel nvcc): {times}")
        t0 = time.perf_counter()
        early.shards()
        if early.proc is not None:
            early.proc.wait(timeout=600)  # nothing timed shares the card with it
        log(f"[build] phase 30's shards ({early.gen_s:.1f} s) and python -m run "
            f"beside the build; waited {time.perf_counter() - t0:.1f} s more for them")
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
        obs = timed(phase_obs_attrib, torch, np, fa, fd, card, dense_engine, paged)
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
        timed(phase_resnet, torch, np, card)
        timed(phase_resnet_parity, torch, np, card)
        timed(phase_image_short, torch, np, card)
        timed(phase_vit, torch, np, card)
        vit = timed(phase_vit_flash, torch, np, F, fa, card)
        resumed = timed(phase_resume, torch, np, fa, card)
        resilient = timed(phase_resilience, torch, np, fa, card)
        timed(phase_moe_bert, torch, np, fa, card)
        data_parallel, dp_shape = timed(phase_data_parallel, torch, np, F, fa, card)
        tp_ranks, k4d, flash_tp = timed(phase_tensor_parallel, torch, np, F, fa, fd, card)
        timed(phase_serve_robust, torch, np, fa, fd, card)
        timed(phase_fleet, torch, np, card)
        timed(phase_imagenet, torch, np, card, early)
        # phases 31 and 32, their ranks in one spawn
        (mp_bf16, mp_f32, mp_shape), (bmp_bf16, bmp_f32, bmp_shape) = timed(
            phase_model_axes, torch, np, F, fa, card)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1
    finally:
        if early is not None:
            early.close()
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
                                  for name, run in spec.items()},
                               **obs["breakdown"]["flash_decode"],
                               "obs_profiled_window": obs["window"]["k4"]}, **k4),
        dict(name="flash_decode_chunk", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=paged["chunk_f32"],
             launches_by_path={"serve_paged_f32": paged["chunk_f32"],
                               "obs_profiled_window": obs["window"]["chunks"]}, **k4b),
        dict(name="flash_decode_int8", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=paged["int8"],
             launches_by_path={"serve_paged_int8": paged["int8"],
                               **obs["breakdown"]["flash_decode_int8"]}, **k4c),
        dict(name="flash_decode_verify", route="cuda",
             source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
             replaces="distributeddeeplearning_tpu/ops/flash_decode.py:271",
             launches=sum(run["counts"]["verify"] for run in spec.values()),
             launches_by_path={**{name: run["counts"]["verify"]
                                  for name, run in spec.items()},
                               **obs["breakdown"]["flash_decode_verify"]}, **k4v),
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
    # the bf16 K1-K3 at ViT-B/16's shape (S 197, non-causal, no bias): held
    # and timed in phase_vit_flash, launched a ViT train step and by the
    # resumed fit of phase_resume
    for row in rows:
        kern = {"flash_attention_fwd_bf16": "fwd", "flash_attention_bwd_dq_bf16": "dq",
                "flash_attention_bwd_dkv_bf16": "dkv"}.get(row["name"])
        if kern is not None:
            counter = {"fwd": "launches_bf16", "dq": "launches_dq_bf16",
                       "dkv": "launches_dkv_bf16"}[kern]
            row["vit"] = vit[kern]
            row["launches_by_path"] = {
                **row.get("launches_by_path", {}), "vit_train_step": vit[kern]["launches"],
                "vit_fit": resumed["launches"][counter],
                "vit_resilience_fit": resilient["launches"][counter]}
    # the bf16 K1-K3 under data parallelism: phase 26's runs, each rank's
    # launches at its own rows (per rank per run)
    for row in rows:
        kern = {"flash_attention_fwd_bf16": "fwd", "flash_attention_bwd_dq_bf16": "dq",
                "flash_attention_bwd_dkv_bf16": "dkv"}.get(row["name"])
        if kern is not None:
            row["launches_by_path"].update(
                {path: counts[kern] for path, counts in data_parallel.items()})
            row["data_parallel"] = dp_shape[kern]
    # phase 27: K4 over a rank's heads under tensor parallelism (K4(d)), and
    # K1-K3 over a rank's heads (B10's tensor half): each rank's launches on
    # the tensor-parallel serving runs
    tp_k4 = {f"serve_tp_{run[0]}_rank{r}": out[run[0]]["k4_launches"]
             for r, out in enumerate(tp_ranks) for run in TP_RUNS}
    rows.append(dict(name="flash_decode_tp", route="cuda",
                     source="distributeddeeplearning_tpu_torch/csrc/flash_decode.cu",
                     replaces="distributeddeeplearning_tpu/ops/flash_decode.py:311",
                     launches=sum(out[run[0]]["k4_launches"] for out in tp_ranks[:1]
                                  for run in TP_RUNS),
                     launches_by_path=tp_k4, **k4d))
    for row in rows:
        kern, dtype = {"flash_attention_fwd": ("fwd", "f32"),
                       "flash_attention_bwd_dq": ("dq", "f32"),
                       "flash_attention_bwd_dkv": ("dkv", "f32"),
                       "flash_attention_fwd_bf16": ("fwd", "bf16"),
                       "flash_attention_bwd_dq_bf16": ("dq", "bf16"),
                       "flash_attention_bwd_dkv_bf16": ("dkv", "bf16")}.get(
                           row["name"], (None, None))
        if kern is None:
            continue
        runs = (("dense_f32", "dense_int8_weights") if dtype == "f32" else ("dense_bf16",))
        launched = {f"serve_tp_{name}_rank{r}": out[name]["k1_launches"] if kern == "fwd"
                    else 0 for r, out in enumerate(tp_ranks) for name in runs}
        row["tensor_parallel"] = {**flash_tp[dtype][kern], "launches": launched}
        row.setdefault("launches_by_path", {}).update(launched)
    # phase 28: each robust-serving run's launches of the kernels it runs
    # (f32 K4 decode and chunks, int8 K4, f32 K1 on the dense prefills)
    robust_rows = {
        "flash_decode": lambda c: 0 if c["k4_int8"] else c["k4"] - c["k4_multi_query"],
        "flash_decode_chunk": lambda c: 0 if c["k4_int8"] else c["k4_multi_query"],
        "flash_decode_int8": lambda c: c["k4_int8"],
        "flash_attention_fwd": lambda c: c["k1"]}
    for row in rows:
        pick = robust_rows.get(row["name"])
        if pick is not None:
            row.setdefault("launches_by_path", {}).update(
                {f"serve_robust {run}": pick(c) for run, c in ROBUST_LAUNCHES.items()
                 if pick(c)})
    # phase 29: each fleet worker's launches, from the states it shipped
    # (paged replicas: K4 decode and chunks; the dense replica: K4 and K1)
    fleet_rows = {
        "flash_decode": lambda c: c["k4"] - c["k4_multi_query"],
        "flash_decode_chunk": lambda c: c["k4_multi_query"],
        "flash_attention_fwd": lambda c: c["k1"]}
    for row in rows:
        pick = fleet_rows.get(row["name"])
        if pick is not None:
            row.setdefault("launches_by_path", {}).update(
                {path: pick(c) for path, c in FLEET_LAUNCHES.items() if pick(c)})
    # phase 31: K1-K3 over a rank's heads and rows in tensor-parallel and
    # FSDP training (bf16: (a)'s run and its resume, each rank's; f32: (b)'s
    # parity runs on the three meshes)
    for row in rows:
        kern, dtype = {"flash_attention_fwd": ("fwd", "f32"),
                       "flash_attention_bwd_dq": ("dq", "f32"),
                       "flash_attention_bwd_dkv": ("dkv", "f32"),
                       "flash_attention_fwd_bf16": ("fwd", "bf16"),
                       "flash_attention_bwd_dq_bf16": ("dq", "bf16"),
                       "flash_attention_bwd_dkv_bf16": ("dkv", "bf16")}.get(
                           row["name"], (None, None))
        if kern is None:
            continue
        launched = {path: c[kern] for path, c in
                    (mp_bf16 if dtype == "bf16" else mp_f32).items()}
        row.setdefault("launches_by_path", {}).update(launched)
        if dtype == "bf16":
            row["model_parallel"] = {**mp_shape[kern], "launches": launched}
    # phase 32: the bias K1-K3 over a rank's heads and rows in BERT's and MoE
    # BERT's training over model axes (bf16: (a), its resume and (b), each
    # rank's; f32: (c)'s parity runs on the five meshes)
    for row in rows:
        kern, dtype = {"flash_attention_fwd_bias": ("fwd", "f32"),
                       "flash_attention_bwd_dq_bias": ("dq", "f32"),
                       "flash_attention_bwd_dkv_bias": ("dkv", "f32"),
                       "flash_attention_fwd_bias_bf16": ("fwd", "bf16"),
                       "flash_attention_bwd_dq_bias_bf16": ("dq", "bf16"),
                       "flash_attention_bwd_dkv_bias_bf16": ("dkv", "bf16")}.get(
                           row["name"], (None, None))
        if kern is None:
            continue
        launched = {path: c[kern] for path, c in
                    (bmp_bf16 if dtype == "bf16" else bmp_f32).items()}
        row.setdefault("launches_by_path", {}).update(launched)
        if dtype == "bf16":
            row["model_parallel"] = {**bmp_shape[kern], "launches": launched}
    # ... and the same three kernels as rows of their own at a tensor rank's
    # shape, launched by rank 0 in (a) (bert-base, tensor=2 x fsdp=2)
    for kern, stem, src, line in (
            ("fwd", "flash_attention_fwd", "flash_attention_fwd.cu", 160),
            ("dq", "flash_attention_bwd_dq", "flash_attention_bwd.cu", 335),
            ("dkv", "flash_attention_bwd_dkv", "flash_attention_bwd.cu", 355)):
        entry = bmp_shape[kern]
        rows.append(dict(
            name=f"{stem}_local_heads_bias_bf16", route="cuda",
            source=f"distributeddeeplearning_tpu_torch/csrc/{src}",
            replaces=f"distributeddeeplearning_tpu/ops/flash_attention.py:{line}",
            launches=bmp_bf16["bert_mp_train_rank0"][kern],
            launches_by_path={path: c[kern] for path, c in bmp_bf16.items()},
            **{k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "shape",
                                     "bitwise_all_heads")}))
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

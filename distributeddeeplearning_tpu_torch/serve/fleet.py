"""Supervised multi-replica serving fleet, the port of ``serve/fleet.py``:
router and worker supervision.

The scheduler (:mod:`.scheduler`) isolates failures *within* a replica
(one request's deadline, NaN or prefill error never kills the batch), but
an engine process still dies with its process.  This module is the
cross-process half of serving resilience:

- :class:`FleetRouter` runs N **replica workers** (``multiprocessing``
  spawn: each worker owns a full engine and scheduler in its own process,
  with its own CUDA context; on a one-card machine every replica shares
  the card), load-balances requests onto the least-loaded live replica,
  and streams tokens and results back over one shared outbox queue;
- workers **heartbeat** from every scheduler loop turn and decode step;
  the router detects death by exit code (a crash, an injected
  ``replica_death``, the scheduler watchdog's exit 70), by heartbeat
  staleness (a hang the worker's own watchdog missed) or by a worker
  that never comes ready, restarts the replica up to ``max_restarts``
  times, and **requeues the dead replica's in-flight requests** (onto
  survivors, or the restarted replica once it is up);
- a requeued delivery carries the original prompt **plus every token
  already streamed** (budget reduced by the same amount), so a greedy
  retry continues the sequence bit-identically: decode equals the full
  forward, which makes the fleet's output under ``replica_death``
  indistinguishable from a fault-free run.  Tokens lost in the dying
  process's pipe merely shorten the preserved prefix; the retry
  regenerates them;
- delivery is **at-most-K**: past ``max_redeliveries`` retries a request
  finishes ``"error"`` and counts as *lost* instead of bouncing between
  dying replicas forever;
- **graceful drain**: :meth:`FleetRouter.drain` (or SIGTERM through
  :meth:`FleetRouter.install_signal_handler`) stops admission, lets
  active requests finish on their replicas and returns queued ones as
  ``"preempted"`` for a control plane to resubmit;
- **live weight reload**: :meth:`FleetRouter.reload` broadcasts a
  ``reload(ckpt_dir)`` control message down every replica's inbox FIFO;
  each worker verifies and restores the checkpoint
  (``train/checkpoint.py``) at its scheduler's idle barrier, active
  requests drained first, and swaps the weight set in place (same
  shapes: KV pages untouched, prefix cache dropped).  Greedy tokens after
  the reload are bit-identical to a fresh engine started from that
  checkpoint; a failed reload keeps the replica serving its OLD weights
  and reports the error in the ack.

On the card the router builds the kernels (``ops._build.build_all``)
before its first spawn, and a worker only loads the built libraries: a
worker that would compile for tens of seconds would miss its heartbeat,
so one that finds a library missing fails its spawn instead.  A worker
that cannot reach the card fails its spawn too (``spawn_error``); it
never serves on the CPU.  Each worker ships its kernel launch counts
(``kernels.*`` counters) with its metrics, so the router's merged
registry counts the launches made in every process.

Fault injection: the router **deals** the ``DDLT_FAULTS`` spec across
replicas (:func:`..utils.faults.deal_serve_faults`: serve-side kinds go
to exactly one replica each, everything else replicates) and each worker
installs its dealt slice through :func:`..utils.faults.install_plan`; a
restarted replica gets its slice with ``replica_death`` stripped so an
injected death is not replayed forever.

Everything the router observes lands on the obs timeline
(``fleet/replica_spawned`` / ``replica_died`` / ``replica_restarted`` /
``request_requeued`` / ``request_lost`` / ``drain_begin``), so a merged
trace (:mod:`..obs.fleet`) shows every recovery next to the decode steps
around it.  The port imports no ``jax``, in the router or the workers.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import re
import signal
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from distributeddeeplearning_tpu_torch.obs.fleet import (
    fleet_latency,
    fleet_latency_per_class,
)
from distributeddeeplearning_tpu_torch.obs.goodput import post_warmup_tokens_per_sec
from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger
from distributeddeeplearning_tpu_torch.obs.recorder import get_recorder
from distributeddeeplearning_tpu_torch.obs.registry import (
    get_registry,
    merge_states,
    summarize,
)
from distributeddeeplearning_tpu_torch.obs.trace import get_tracer
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    CompletedRequest,
    Request,
)
from distributeddeeplearning_tpu_torch.utils import faults as faults_mod

logger = logging.getLogger("ddlt.fleet")

__all__ = ["ReplicaSpec", "FleetReport", "FleetRouter", "serve_fleet",
           "DEFAULT_HEARTBEAT_TIMEOUT_S", "DEFAULT_READY_TIMEOUT_S"]

#: wire-uid separator: requests cross the process boundary as
#: ``uid<SEP>delivery`` so a message from a superseded delivery (one that
#: raced the replica's death) can never be stitched into the current one
_SEP = "\x1f"

#: default router bounds, sized for a worker's torch import, CUDA context
#: and params build or checkpoint restore (PERF.md
#: gives the spawn-to-ready seconds measured on the card).  A worker that
#: is not ready this long after its spawn is a spawn hang; one with work
#: outstanding that sends nothing for the heartbeat bound is a hang.
DEFAULT_READY_TIMEOUT_S = 120.0
DEFAULT_HEARTBEAT_TIMEOUT_S = 60.0

#: the kernels a replica's serving path launches (``ops/_build.py`` names)
SERVE_KERNELS = ("flash_attention_fwd", "flash_decode")


@dataclasses.dataclass
class ReplicaSpec:
    """Everything a spawned worker needs to build its engine: plain
    picklable data, because the worker process constructs the model and
    engine itself (parameter tensors never cross the process boundary).

    ``model`` holds :func:`..models.pipelined_transformer.init_params`
    kwargs (``num_layers``/``d_model``/``num_heads``/``d_ff``/
    ``vocab_size``/``max_len``), drawn from
    ``torch.Generator().manual_seed(seed)``; with ``checkpoint_dir`` set
    the worker restores params instead and ``model`` is ignored.  Every
    replica builds the IDENTICAL model (same seed or same checkpoint):
    failover bit-exactness requires it.  ``device`` is where each worker
    serves: the card unless the caller asks for ``"cpu"``.
    """

    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    quantize_weights: Optional[str] = None
    num_heads: int = 4
    batch_slots: int = 4
    max_seq: int = 64
    kv_layout: str = "paged"  # "paged" | "dense"
    page_size: int = 16
    num_pages: Optional[int] = None
    prefill_chunk: int = 16
    prefix_cache: bool = True          # paged engines only
    prefill_attention: str = "flash"   # dense engines only
    cache_dtype: Optional[str] = None  # e.g. "int8"
    # host-memory KV page tier (serve/kv_tier.py, paged engines only):
    # 0 disables; >0 gives each replica a pinned host pool of that many
    # pages for spilled cold prefix pages
    host_pages: int = 0
    tier_policy: str = "lru"
    decode_kernel: str = "auto"        # "auto" | "flash" | "gather"
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    max_new_tokens: int = 32
    request_deadline_s: Optional[float] = None
    watchdog_deadline_s: Optional[float] = None
    # multi-tenant overload protection, passed straight to each
    # worker's ContinuousBatchingScheduler: priority classes highest
    # first, the admission shed policy, and the per-request lossless-
    # preemption budget.  Tuple (not list) keeps the spec hashable-ish
    # and the default immutable across pickling.
    priority_classes: Tuple[str, ...] = (
        "premium", "standard", "best_effort",
    )
    shed_policy: str = "block"
    preempt_budget: int = 2
    # distributed tracing: when set, every worker enables its own tracer
    # (pid/process_name derived from the worker, replica context stamped
    # on every span) and exports a Chrome-trace SHARD here —
    # ``replica{K}-{pid}.trace.json`` — for obs.fleet.merge_fleet_trace
    # to align onto the router clock
    trace_dir: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.kv_layout not in ("paged", "dense"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'dense', got {self.kv_layout!r}"
            )
        if not self.checkpoint_dir and not self.model:
            raise ValueError(
                "ReplicaSpec needs either model dims or a checkpoint_dir"
            )
        if self.device != "cpu" and not re.fullmatch(r"cuda(:\d+)?", self.device):
            raise ValueError(
                f"device must be 'cuda', 'cuda:N' or 'cpu', got {self.device!r}"
            )
        if self.quantize_weights not in (None, "int8"):
            raise ValueError(
                f"quantize_weights must be None or 'int8', got "
                f"{self.quantize_weights!r}"
            )
        # mirror the scheduler's own validation HERE, before any worker
        # spawns: a bad knob should fail in the router process, not as N
        # spawn_errors after N torch imports
        classes = tuple(self.priority_classes)
        if not classes or any(
            not isinstance(c, str) or not c for c in classes
        ) or len(set(classes)) != len(classes):
            raise ValueError(
                "priority_classes must be unique non-empty class names, "
                f"got {self.priority_classes!r}"
            )
        if self.shed_policy not in ("block", "shed"):
            raise ValueError(
                f"shed_policy must be 'block' or 'shed', got "
                f"{self.shed_policy!r}"
            )
        if self.preempt_budget < 0:
            raise ValueError(
                f"preempt_budget must be >= 0, got {self.preempt_budget}"
            )
        if self.host_pages < 0:
            raise ValueError(
                f"host_pages must be >= 0, got {self.host_pages}"
            )
        if self.host_pages and self.kv_layout != "paged":
            raise ValueError(
                "host_pages requires kv_layout='paged' (the host tier "
                "spills KV pages; a dense cache has none)"
            )


@dataclasses.dataclass
class FleetReport:
    """Fleet-level accounting — the ``SERVE_RESILIENCE`` artifact body.

    Latency percentiles are measured on the ROUTER's clock (submit ->
    first streamed token -> completion), so cross-replica failover time
    and restart stalls are *inside* the numbers a client would feel, not
    hidden in per-replica reports.
    """

    replicas: int
    requests: int
    generated_tokens: int
    wall_s: float
    # tokens of OK requests over the POST-WARMUP window (wall minus the
    # time to the fleet's first streamed token: spawn, import, engine
    # build), via the shared helper obs/goodput.post_warmup_tokens_per_sec
    goodput_tokens_per_sec: float
    # the excluded warmup window itself (0.0 when no token ever streamed)
    warmup_s: float
    completed_ok: int              # finish_reason in ("eos", "length")
    errors: int
    error_rate: float
    finish_reasons: Dict[str, int]
    ttft_s: Dict[str, float]
    tpot_s: Dict[str, float]
    restarts: int = 0
    replica_deaths: int = 0
    redeliveries: int = 0
    # live weight reloads the router broadcast AND every live replica
    # acknowledged (serve/fleet.FleetRouter.reload)
    reloads: int = 0
    lost_requests: int = 0     # redelivery budget exhausted
    shed: int = 0              # admission-rejected deliveries observed
    drained: bool = False
    # final ServeReport dict per replica index for replicas that exited
    # cleanly (a dead-and-not-restarted replica leaves None)
    replica_reports: List[Optional[Dict[str, Any]]] = dataclasses.field(
        default_factory=list
    )
    # distributed tracing: the trace id minted for each uid at intake —
    # the correlation key the merged fleet timeline groups by
    trace_ids: Dict[str, str] = dataclasses.field(default_factory=dict)
    # mergeable metrics: the raw per-worker-incarnation registry states
    # (histogram buckets included) shipped over the outbox, the merged
    # fleet snapshot, and the fleet-level TTFT/TPOT percentile blocks
    # computed from BUCKET-merged histograms (never averaged percentiles)
    replica_metric_states: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    fleet_metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fleet_latency: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # flight-recorder dumps: router-side (replica deaths it observed) +
    # worker-side (injected deaths, quarantines, unhandled exceptions,
    # shipped over the outbox before the process died)
    flight_recorder_dumps: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list
    )
    # per-replica HBM attribution (obs/ledger.py): each worker exports
    # its ledger frame as hbm.* gauges with every metric ship, and the
    # router lifts the LAST shipped frame per (replica, pid) incarnation
    # here — which replica is closest to the memory cliff, by semantic
    # owner, without a new wire channel
    hbm_watermarks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    # per-replica host-tier watermarks (serve/kv_tier.py): the
    # ``serve.tier.*`` spill/restore/drop counters and host-pool peak
    # each worker rolls up at end of run, lifted per (replica, pid)
    # incarnation like hbm_watermarks — which replica is thrashing its
    # host pool, without a new wire channel.  Host BYTES ride
    # hbm_watermarks as ``hbm.kv_host_pages.*`` (ledger owner).
    tier_watermarks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    # per-priority-class accounting on the ROUTER clock: volume,
    # terminal mix, and TTFT/TPOT percentile blocks per class — the
    # numbers the premium-isolation gate and per-tenant SLO evaluation
    # read.  The unlabeled blocks above remain the all-traffic aggregate.
    per_class: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-class latency from the bucket-merged WORKER histograms
    # (`serve.ttft_s.<class>` ...) — the scheduler-clock counterpart of
    # per_class's router-clock percentiles, and what per-tenant SLOSpec
    # evaluation reads (obs.fleet.evaluate_class_slos)
    fleet_latency_per_class: Dict[str, Any] = dataclasses.field(
        default_factory=dict
    )
    # the ready handshake of every worker incarnation, keyed
    # ``replicaK-pid``: seconds from spawn to ready on the router clock,
    # the device it serves on, and whether ``jax`` was in its modules
    worker_info: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict
    )
    # engine-build failures the workers reported (each also a death)
    spawn_errors: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# -- worker side -----------------------------------------------------------


def _restore_params(spec: ReplicaSpec, ckpt_dir: str):
    """``(params, step)`` of the newest verified generation under
    ``ckpt_dir`` (int8-quantized after verification when the spec asks)."""
    from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer

    params, step = Checkpointer(ckpt_dir).restore_params(
        quantize_weights=spec.quantize_weights
    )
    if params is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return params, step


def _check_kernels_built() -> None:
    """A worker on the card only loads kernels the router built: a missing
    library fails the spawn instead of compiling in the worker."""
    from distributeddeeplearning_tpu_torch.ops import _build

    missing = [n for n in SERVE_KERNELS if not _build.library_path(n).exists()]
    if missing:
        raise RuntimeError(
            f"kernel libraries {missing} are not built: the router builds "
            "them (ops._build.build_all) before it spawns a worker"
        )


def _build_engine(spec: ReplicaSpec):
    """Construct this worker's engine from the spec (worker process only).
    Raises when the spec's device is the card and no card is reachable:
    a worker never falls back to the CPU."""
    import torch

    from distributeddeeplearning_tpu_torch._device import resolve_device
    from distributeddeeplearning_tpu_torch.serve.engine import (
        PagedInferenceEngine,
        data_parallel_engine,
    )

    device = resolve_device(spec.device)
    if device.type == "cuda":
        _check_kernels_built()
        if device.index is None:
            # a worker owns one card: name it, so data_parallel_engine
            # counts that card and not every card the host shows
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    else:
        # the replicas of a CPU fleet share the host's cores: one intra-op
        # thread each, or every worker's thread pool spins against the rest
        torch.set_num_threads(1)
    if spec.checkpoint_dir:
        params, _ = _restore_params(spec, spec.checkpoint_dir)
    else:
        from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
            init_params,
        )

        params = init_params(
            torch.Generator().manual_seed(spec.seed), **spec.model,
            device=device,
        )
        if spec.quantize_weights == "int8":
            from distributeddeeplearning_tpu_torch.quant.calibrate import (
                quantize_params,
            )

            params = quantize_params(params)
    common = dict(
        num_heads=spec.num_heads,
        batch_slots=spec.batch_slots,
        max_seq=spec.max_seq,
        temperature=spec.temperature,
        top_k=spec.top_k,
        cache_dtype=spec.cache_dtype,
        seed=spec.seed,
        decode_kernel=spec.decode_kernel,
        device=device,
    )
    if spec.kv_layout == "paged":
        return PagedInferenceEngine(
            params,
            page_size=spec.page_size,
            num_pages=spec.num_pages,
            prefill_chunk=spec.prefill_chunk,
            prefix_cache=spec.prefix_cache,
            host_pages=spec.host_pages,
            tier_policy=spec.tier_policy,
            **common,
        )
    engine, _ = data_parallel_engine(
        params, prefill_attention=spec.prefill_attention, **common
    )
    return engine


#: how often a worker ships its full registry state over the outbox (the
#: periodic half of "periodic + at drain" — a replica that dies between
#: ships loses at most this window of counter movement)
METRICS_SHIP_INTERVAL_S = 0.5


def _apply_reload(engine, spec: ReplicaSpec, ckpt_dir: str) -> Optional[int]:
    """Verify and restore a checkpoint's params into the RUNNING engine.

    The worker half of live weight reload, called by the scheduler at its
    idle barrier (between decode steps, never mid-request): the restore
    goes through the checkpoint layer's verified path (a corrupt latest
    generation falls back to the newest verified one, exactly like a
    restart would), then the engine swaps the weight set in place
    (``reload_params``: same shapes and dtypes, KV pages untouched,
    prefix cache dropped).  Returns the restored step.  Host I/O plus one
    upload: nothing here reads the card back.
    """
    params, step = _restore_params(spec, ckpt_dir)
    engine.reload_params(params)
    return step


def _hbm_watermarks(metric_states) -> Dict[str, Dict[str, float]]:
    """Per-replica ``hbm.*`` gauge frames lifted out of the shipped
    registry states — the FleetReport's per-replica HBM watermark view
    (``hbm.kv_pages.peak_bytes`` and friends, keyed ``replicaK-pid``)."""
    out: Dict[str, Dict[str, float]] = {}
    for state in metric_states:
        gauges = {
            name: g.get("value")
            for name, g in (state.get("gauges") or {}).items()
            if name.startswith("hbm.")
        }
        if gauges:
            key = (
                f"replica{state.get('replica_id', '?')}"
                f"-{state.get('pid', '?')}"
            )
            out[key] = gauges
    return out


def _tier_watermarks(metric_states) -> Dict[str, Dict[str, float]]:
    """Per-replica host-tier watermark frames lifted out of the shipped
    registry states — the ``serve.tier.*`` spill/restore/drop counters
    and host-pool peak gauge, keyed ``replicaK-pid`` like
    :func:`_hbm_watermarks`.  Empty for replicas serving without a tier
    (the counters never move, the gauge is never set)."""
    out: Dict[str, Dict[str, float]] = {}
    for state in metric_states:
        frame = {
            name: value
            for name, value in (state.get("counters") or {}).items()
            if name.startswith("serve.tier.")
        }
        frame.update({
            name: g.get("value")
            for name, g in (state.get("gauges") or {}).items()
            if name.startswith("serve.tier.")
        })
        if frame:
            key = (
                f"replica{state.get('replica_id', '?')}"
                f"-{state.get('pid', '?')}"
            )
            out[key] = frame
    return out


def _record_kernel_launches(registry) -> None:
    """Copy this process's kernel launch counters (``ops.flash_decode``
    and ``ops.flash_attention``: K4 and K1) into ``kernels.*`` counters.
    They are cumulative per process, as a shipped state is, so the
    router's merge sums them over every worker incarnation."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import flash_decode as fd

    for name, value in (
        ("kernels.flash_decode.launches", fd.launches),
        ("kernels.flash_decode.launches_int8", fd.launches_int8),
        ("kernels.flash_decode.launches_multi_query", fd.launches_multi_query),
        ("kernels.flash_attention.launches", fa.launches),
    ):
        registry.counter(name).value = int(value)


def _ship_metrics(outbox, replica_id: int) -> None:
    """Ship this worker's full mergeable registry state to the router.

    The state is host counters and histogram buckets by construction.
    The HBM ledger's current frame rides every ship as ``hbm.*`` gauges
    (host metadata math only: per-tensor bytes, never a buffer read), so
    the router's per-replica watermarks stay fresh to the last ship even
    across a replica death; the kernel launch counters ride it as
    ``kernels.*`` counters."""
    registry = get_registry()
    get_ledger().export_gauges(registry)
    _record_kernel_launches(registry)
    outbox.put(("metrics", replica_id, os.getpid(), registry.state()))


def _worker_main(
    replica_id: int,
    spec: ReplicaSpec,
    faults_spec: str,
    inbox,
    outbox,
    drain_event,
) -> None:
    """Replica worker entry point (runs in a spawned child process).

    Builds the engine, then drives the scheduler in live mode: ``poll``
    reads the inbox, every generated token / heartbeat / completion goes
    out through the shared outbox.  The dealt fault slice is installed
    OVER the inherited environment (every worker inherits the parent's
    full ``DDLT_FAULTS``; without :func:`faults.install_plan` each would
    fire every serve-side entry at its own local step).

    Observability: the worker stamps its identity on the metrics
    registry (every snapshot row attributable), periodically ships its
    mergeable registry state (plus a final ship at drain or death), and,
    with ``spec.trace_dir`` set, runs its own tracer (worker pid +
    ``replica-K`` process name, ``replica`` context on every span) and
    exports a Chrome-trace shard at exit, at injected death, and on an
    unhandled exception, so the merged fleet timeline keeps the dying
    replica's last spans.
    """
    plan = faults_mod.install_plan(faults_spec or "")

    from distributeddeeplearning_tpu_torch.obs import trace as trace_mod
    from distributeddeeplearning_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
    )

    get_registry().set_identity(
        replica_id=replica_id, process_name=f"replica-{replica_id}",
    )
    tracer = trace_mod.get_tracer()
    shard_path = None
    if spec.trace_dir:
        tracer = trace_mod.configure(
            enabled=True, annotate=False,
            process_name=f"replica-{replica_id}",
        ).set_context(replica=replica_id)
        shard_path = os.path.join(
            spec.trace_dir,
            f"replica{replica_id}-{os.getpid()}.trace.json",
        )

    def export_shard() -> None:
        """Best-effort shard write — called on every exit path (normal,
        injected death, crash); a failed write must not mask the exit."""
        if shard_path is None:
            return
        try:
            tracer.export(shard_path)
        except OSError:
            logger.warning("replica %d failed to write trace shard",
                           replica_id)

    def ship_dumps() -> None:
        dumps = get_recorder().drain_dumps()
        if dumps:
            outbox.put(("dumps", replica_id, dumps))

    try:
        engine = _build_engine(spec)
    except Exception as exc:  # noqa: BLE001 — report, then exit visibly
        outbox.put(("spawn_error", replica_id, f"{type(exc).__name__}: {exc}"))
        return
    # ready doubles as the clock HANDSHAKE: the worker reports its tracer
    # epoch (wall clock) + send time; the router turns that into a
    # per-worker clock-offset estimate for the shard merge (send->receive
    # delay bounds the estimate's error).  It also says where the engine
    # serves and whether anything pulled jax into this process.
    outbox.put(("ready", replica_id, {
        "pid": os.getpid(),
        "epoch_unix_s": tracer.epoch_unix_s,
        "sent_unix_s": time.time(),
        "device": str(engine.device),
        "jax_loaded": "jax" in sys.modules,
    }))

    closed = False
    last_hb = 0.0
    last_ship = 0.0

    def poll() -> Optional[List[Request]]:
        nonlocal closed, last_hb, last_ship
        # rate-limited liveness signal from the LOOP TOP, not just after
        # decode steps: without it a worker grinding through a long
        # chunked-prefill phase sends nothing for the whole phase and a
        # tight heartbeat timeout reads healthy work as a hang
        now = time.monotonic()
        if now - last_hb > 0.25:
            last_hb = now
            outbox.put(("hb", replica_id, -1))
        if now - last_ship > METRICS_SHIP_INTERVAL_S:
            # the periodic metric ship rides the same loop-top cadence:
            # full registry state (histogram buckets included) so the
            # router's fleet percentiles stay bucket-merged, and a death
            # between ships costs one interval of movement, not the run
            last_ship = now
            _ship_metrics(outbox, replica_id)
        if closed:
            return None
        fresh: List[Request] = []
        while True:
            try:
                msg = inbox.get_nowait()
            except queue_mod.Empty:
                break
            if msg is None:  # close sentinel: finish what we hold
                closed = True
                break
            if msg.get("control") == "reload":
                # live weight reload: the control message is a BARRIER in
                # the per-replica FIFO — requests delivered before it are
                # served by the old weights, requests after by the new —
                # and the scheduler applies it only at its idle barrier
                # (active work drains first, admission holds), so every
                # request sees exactly one weight set end to end
                schedule_reload(msg["ckpt_dir"])
                continue
            fresh.append(
                Request(
                    uid=msg["uid"],
                    prompt=msg["prompt"],
                    max_new_tokens=msg.get("max_new_tokens"),
                    deadline_s=msg.get("deadline_s"),
                    trace_id=msg.get("trace_id"),
                    # SLO identity crosses the wire with every delivery
                    # (redeliveries included) — the worker's priority
                    # queue and preemption ladder depend on it
                    tenant=msg.get("tenant", "default"),
                    priority=msg.get("priority", "standard"),
                )
            )
        return None if (closed and not fresh) else fresh

    pending_reload_dir: List[Optional[str]] = [None]

    def schedule_reload(ckpt_dir: str) -> None:
        superseded = pending_reload_dir[0]
        if superseded is not None and superseded != ckpt_dir:
            # a second reload arrived before the first reached the idle
            # barrier: last weight set wins, but the superseded
            # broadcast's router-side reload() is owed a definitive
            # answer — nack it instead of letting it time out
            outbox.put((
                "reload_error", replica_id,
                {"ckpt_dir": superseded,
                 "error": "superseded by a newer reload"},
            ))
        pending_reload_dir[0] = ckpt_dir

        def do_reload() -> None:
            if pending_reload_dir[0] == ckpt_dir:
                pending_reload_dir[0] = None
            try:
                with tracer.span(
                    "fleet/reload", cat="fleet", ckpt_dir=ckpt_dir,
                ):
                    step = _apply_reload(engine, spec, ckpt_dir)
            except Exception as exc:  # noqa: BLE001 — old weights keep serving
                logger.warning(
                    "replica %d reload from %s FAILED: %s",
                    replica_id, ckpt_dir, exc,
                )
                outbox.put((
                    "reload_error", replica_id,
                    {"ckpt_dir": ckpt_dir,
                     "error": f"{type(exc).__name__}: {exc}"},
                ))
            else:
                tracer.event(
                    "fleet/reload_done", cat="fleet", replica=replica_id,
                    ckpt_dir=ckpt_dir, step=step,
                )
                outbox.put((
                    "reload_done", replica_id,
                    {"ckpt_dir": ckpt_dir, "step": step},
                ))

        sched.request_reload(do_reload)

    def on_step(step: int) -> None:
        outbox.put(("hb", replica_id, step))
        if plan and plan.take_replica_death(step):
            # hard death, mid-service: no drain, no goodbye message.  The
            # injected death IS observable inside the worker, so the
            # black box gets flushed first: flight-recorder dump + final
            # metrics state onto the wire, trace shard to disk — then
            # os._exit, exactly as before.  (A REAL crash skips all of
            # this; the router-side recorder still dumps on detection.)
            get_recorder().dump(
                "replica_death (injected)", registry=get_registry(),
                replica=replica_id, step=step,
            )
            ship_dumps()
            _ship_metrics(outbox, replica_id)
            export_shard()
            # flush below only models "bytes already on the wire arrive"
            # (mp.Queue writes through a feeder thread; os._exit would
            # drop its buffer) — correctness does not depend on it, a
            # shorter preserved prefix just regenerates identically.
            outbox.close()
            outbox.join_thread()
            os._exit(1)

    def on_token(uid: str, token: int) -> None:
        outbox.put(("token", replica_id, uid, int(token)))

    def on_complete(result: CompletedRequest) -> None:
        outbox.put(("done", replica_id, dataclasses.asdict(result)))

    sched = ContinuousBatchingScheduler(
        engine,
        eos_id=spec.eos_id,
        max_new_tokens=spec.max_new_tokens,
        request_deadline_s=spec.request_deadline_s,
        watchdog_deadline_s=spec.watchdog_deadline_s,
        priority_classes=spec.priority_classes,
        shed_policy=spec.shed_policy,
        preempt_budget=spec.preempt_budget,
        # every result streams out through on_complete as it lands; the
        # worker may live for days, so it keeps only a window for its
        # exit report instead of every token it ever generated
        result_window=10_000,
    )
    try:
        _, report = sched.run(
            [],
            poll=poll,
            should_drain=drain_event.is_set,
            on_token=on_token,
            on_step=on_step,
            on_complete=on_complete,
        )
    except BaseException as exc:  # noqa: BLE001 — visible death > silent
        # unhandled worker exception: freeze the black box and ship it
        # before the process dies — the non-zero exit code remains the
        # authoritative death signal
        get_recorder().dump(
            "worker_exception", registry=get_registry(),
            replica=replica_id, error=f"{type(exc).__name__}: {exc}",
        )
        ship_dumps()
        export_shard()
        outbox.put(("crash", replica_id, f"{type(exc).__name__}: {exc}"))
        raise
    if sched.has_pending_reload:
        # the close sentinel beat the idle barrier: the reload never
        # applied and never will — a definitive NACK beats letting the
        # router's reload() wait out its whole ack timeout
        outbox.put((
            "reload_error", replica_id,
            {"ckpt_dir": pending_reload_dir[0],
             "error": "worker shut down before the reload applied"},
        ))
    # the drain half of "periodic + at drain": the final state carries
    # the scheduler's end-of-run histogram rollup (TTFT/TPOT buckets)
    _ship_metrics(outbox, replica_id)
    ship_dumps()
    export_shard()
    exit_report = report.to_dict()
    exit_report["jax_loaded"] = "jax" in sys.modules
    exit_report["pid"] = os.getpid()
    # prefill chunks run over the worker's life, beside its kernels.*
    # counters: each chunk launches the decode kernel's multi-query form
    # once a layer
    exit_report["chunks_run"] = getattr(engine, "chunks_run", 0)
    outbox.put(("exit", replica_id, exit_report))


# -- router side -----------------------------------------------------------


@dataclasses.dataclass
class _Replica:
    """Router-side view of one worker process."""

    index: int                      # stable replica index (0..N-1)
    proc: Any
    inbox: Any
    faults_spec: str
    spawned_at: float = 0.0         # arms the spawn-hang bound
    outstanding: set = dataclasses.field(default_factory=set)  # uids
    restarts_used: int = 0
    ready: bool = False             # engine built, scheduler loop live
    last_msg_at: Optional[float] = None  # arms heartbeat staleness
    exit_seen_at: Optional[float] = None  # clean-exit grace clock
    dead: bool = False              # terminal (death or retirement)
    report: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class _Flight:
    """Router-side lifecycle of one request uid.

    ``preserved`` holds tokens committed by PRIOR (dead/shed) deliveries;
    ``streamed`` holds tokens streamed by the CURRENT delivery.  On death
    the current stream is committed into ``preserved`` and rides the
    retry's prompt; on completion the worker's own token list for the
    delivery is authoritative and ``streamed`` (a prefix of it) is
    dropped — never both, so nothing double-counts.
    """

    req: Request
    submitted_at: float
    # the distributed-tracing correlation id minted at router intake —
    # rides every delivery to every replica, so the whole lifecycle
    # (including failovers) groups under ONE id in the merged timeline
    trace_id: str = ""
    # absolute (router-clock) deadline: fixed at submit so a redelivery
    # ships only the REMAINING window — re-basing would grant each
    # failover a fresh full deadline
    deadline_at: Optional[float] = None
    preserved: List[int] = dataclasses.field(default_factory=list)
    streamed: List[int] = dataclasses.field(default_factory=list)
    delivery: int = 0               # current delivery number (1-based)
    replica: Optional[int] = None   # index currently serving, if any
    avoid: Optional[int] = None     # replica that just shed this uid
    first_token_at: Optional[float] = None
    done: bool = False              # terminal: finalized exactly once

    def wire_uid(self) -> str:
        return f"{self.req.uid}{_SEP}{self.delivery}"


class FleetRouter:
    """Run ``replicas`` engine workers and serve a request stream across
    them with health-checked supervision and request failover.

    ``faults`` overrides the ``DDLT_FAULTS`` environment for dealing
    across workers (``None`` reads the environment).  A worker not ready
    :data:`DEFAULT_READY_TIMEOUT_S` after its spawn, or one with work
    outstanding that sends nothing for ``heartbeat_timeout_s`` (None
    disables that check), is terminated and handled as a death.  :meth:`terminate` stops every
    process the router ever spawned: call it in a ``finally``.
    """

    def __init__(
        self,
        spec: ReplicaSpec,
        *,
        replicas: int = 2,
        max_restarts: int = 1,
        max_redeliveries: int = 2,
        heartbeat_timeout_s: Optional[float] = DEFAULT_HEARTBEAT_TIMEOUT_S,
        faults: Optional[str] = None,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if max_redeliveries < 1:
            raise ValueError(
                f"max_redeliveries must be >= 1, got {max_redeliveries}"
            )
        if heartbeat_timeout_s is not None and heartbeat_timeout_s <= 0:
            raise ValueError(
                f"heartbeat_timeout_s must be > 0, got {heartbeat_timeout_s}"
            )
        self.spec = spec
        self.replicas = replicas
        self.max_restarts = max_restarts
        self.max_redeliveries = max_redeliveries
        self.heartbeat_timeout_s = heartbeat_timeout_s
        faults_text = (
            faults if faults is not None
            else os.environ.get(faults_mod.ENV_VAR, "")
        )
        self._dealt = faults_mod.deal_serve_faults(faults_text, replicas)
        # spawn context: CUDA cannot survive a fork, and each worker opens
        # its own context on the card
        self._ctx = mp.get_context("spawn")
        self._kernels_built = False
        # every process ever spawned, for terminate()
        self._procs: List[Any] = []
        # per worker incarnation: spawn time, then the ready handshake
        self._worker_info: Dict[str, Dict[str, Any]] = {}
        self._spawn_errors: List[str] = []
        self._drain_event = self._ctx.Event()
        self._outbox = self._ctx.Queue()
        self._members: List[_Replica] = []
        self.restarts = 0
        self.replica_deaths = 0
        self.redeliveries = 0
        self.lost_requests = 0
        self.shed_seen = 0
        self.reloads = 0
        # reload acknowledgements by replica index (reload_done /
        # reload_error payloads); reload() waits on these — filled by
        # serve()'s dispatch loop when one is running, by reload()'s own
        # idle pump otherwise
        self._reload_acks: Dict[int, Dict[str, Any]] = {}
        self._serving = False
        # messages reload()'s idle pump read but must not consume: a
        # serve() racing the pump re-dispatches these through its own
        # process() before touching the outbox (dropping a 'done' here
        # would strand its flight forever)
        self._stashed_msgs: List[Any] = []
        # handshake clock-offset estimates, keyed by worker pid: the
        # ready message carries the worker tracer's wall-clock epoch, so
        # the shard merge can align each worker's perf_counter timeline
        # onto the router clock (obs.fleet.merge_fleet_trace)
        self.clock_offsets_us: Dict[int, float] = {}
        # latest shipped registry state per worker INCARNATION (replica
        # index, pid) — states are cumulative per process, so last wins;
        # a restarted replica's fresh pid keeps its predecessor's final
        # shipped state in the merge instead of overwriting it
        self._metric_states: Dict[tuple, Dict[str, Any]] = {}
        self._worker_dumps: List[Dict[str, Any]] = []

    # -- lifecycle ---------------------------------------------------------

    def _build_kernels(self) -> None:
        """On the card, build every serving kernel in this process before
        the first spawn, so workers only load the libraries.  Without a
        card there is nothing to build for: the workers then fail their
        spawn on the missing device."""
        if self._kernels_built or self.spec.device == "cpu":
            return
        import torch

        if not torch.cuda.is_available():
            return
        from distributeddeeplearning_tpu_torch.ops import _build

        times = _build.build_all(SERVE_KERNELS)
        logger.info("fleet kernels built before spawn: %s", times)
        self._kernels_built = True

    def _spawn(self, index: int, faults_spec: str) -> _Replica:
        self._build_kernels()
        inbox = self._ctx.Queue()
        proc = self._ctx.Process(
            target=_worker_main,
            args=(
                index, self.spec, faults_spec, inbox, self._outbox,
                self._drain_event,
            ),
            name=f"ddlt-serve-replica-{index}",
            daemon=True,
        )
        proc.start()
        self._procs.append(proc)
        self._worker_info[f"replica{index}-{proc.pid}"] = {
            "replica": index, "pid": proc.pid,
            "spawned_at": time.perf_counter(),
        }
        get_tracer().event(
            "fleet/replica_spawned", cat="fleet", replica=index,
            pid=proc.pid, faults=faults_spec,
        )
        logger.info("replica %d spawned (pid %s)", index, proc.pid)
        return _Replica(
            index=index, proc=proc, inbox=inbox, faults_spec=faults_spec,
            spawned_at=time.perf_counter(),
        )

    def drain(self) -> None:
        """Begin graceful drain: workers stop admitting and finish their
        active requests; the router returns queued work ``"preempted"``."""
        if not self._drain_event.is_set():
            get_tracer().event("fleet/drain_begin", cat="fleet")
            logger.warning("fleet drain begun")
            self._drain_event.set()

    def terminate(self, timeout_s: float = 5.0) -> None:
        """Stop every process this router ever spawned (terminate, then
        kill what outlives ``timeout_s``) and mark every replica dead.
        Idempotent; the bounded cleanup a caller runs in a ``finally``."""
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self._procs:
            proc.join(timeout=timeout_s)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=timeout_s)
        for member in self._members:
            member.dead = True
            member.ready = False

    def install_signal_handler(
        self, signals: Sequence[int] = (signal.SIGTERM,)
    ) -> None:
        """SIGTERM -> drain (main thread only): a drained ``serve`` returns
        queued work ``"preempted"`` for a control plane to resubmit."""
        for sig in signals:
            signal.signal(sig, lambda *_: self.drain())

    def _shutdown_members(self) -> None:
        """Close inboxes, join workers, collect trailing reports.

        A replica still mid-spawn (restarted near the end, engine not
        built) is terminated instead of joined: every result is already
        in, and waiting out a torch import and engine build would bill
        cold-start time to the serving wall (its replica_reports entry
        stays None).
        """
        for member in self._members:
            if not member.dead:
                try:
                    member.inbox.put(None)
                except (ValueError, OSError):
                    pass
        joining = []
        for member in self._members:
            if member.dead:
                continue
            if not member.ready:
                member.proc.terminate()
                member.proc.join(timeout=5.0)
            else:
                joining.append(member)
        # Trailing messages: the dispatch loop exits the moment the last
        # RESULT lands, but each worker's drain-time payload (its exit
        # report, its FINAL metrics state carrying the scheduler's
        # end-of-run TTFT/TPOT histogram rollup, any flight-recorder
        # dumps) arrives after that, during shutdown.  They are read WHILE
        # the workers exit: a worker flushing more than the pipe holds
        # cannot exit until the router reads it.
        deadline = time.monotonic() + 60.0
        while (any(m.proc.is_alive() for m in joining)
               and time.monotonic() < deadline):
            try:
                self._take_trailing(self._outbox.get(timeout=0.1))
            except queue_mod.Empty:
                pass
        for member in joining:
            member.proc.join(timeout=0.5)
            if member.proc.exitcode is None:
                member.proc.terminate()
                member.proc.join(timeout=5.0)
        while True:
            try:
                # short timeout, not get_nowait: the workers have exited,
                # but the router-side queue thread may still be
                # deserializing their final flush
                self._take_trailing(self._outbox.get(timeout=0.25))
            except queue_mod.Empty:
                break
        # every worker is gone: mark the members terminal so a later
        # serve() respawns instead of dispatching onto dead inboxes, and
        # reload() refuses instead of waiting out its whole timeout
        for member in self._members:
            member.dead = True
            member.ready = False

    def _take_trailing(self, msg) -> None:
        """One message read during shutdown: exit reports, metric states,
        dumps and reload acks are kept; the rest is done with."""
        kind = msg[0]
        if kind == "exit":
            for member in self._members:
                if member.index == msg[1] and member.report is None:
                    member.report = msg[2]
        elif kind == "metrics":
            self._metric_states[(msg[1], msg[2])] = msg[3]
        elif kind == "dumps":
            self._worker_dumps.extend(msg[2])
        elif kind in ("reload_done", "reload_error"):
            # a reload() on another thread raced serve completion: its ack
            # arrives in the drain-time flush, and dropping it would leave
            # that reload() waiting out its whole timeout
            payload = dict(msg[2])
            payload["ok"] = kind == "reload_done"
            self._reload_acks[msg[1]] = payload

    # -- live weight reload ------------------------------------------------

    def reload(
        self, ckpt_dir: str, *, timeout_s: float = 300.0
    ) -> Dict[int, Dict[str, Any]]:
        """Broadcast a ``reload(ckpt_dir)`` control message to every live
        READY replica and block until each acknowledges (or the timeout).

        The message rides each replica's inbox FIFO, so it is a per-
        replica ordering barrier: requests delivered before it are served
        by the old weights, requests after by the new.  Each worker
        verifies + restores the checkpoint at its scheduler's idle
        barrier (between decode steps, active work drained first) and
        swaps the weight set in place (KV pages untouched), greedy tokens afterwards bit-identical to a fresh
        engine started from that checkpoint.

        Returns ``{replica_index: ack payload}`` (``ok`` False carries
        the worker's error; a worker that failed keeps serving the OLD
        weights).  Callable between :meth:`serve` calls
        (``serve(shutdown=False)`` first) or from another thread while a
        serve is running — the running dispatch loop harvests the acks.
        """
        targets = [m for m in self._members if not m.dead and m.ready]
        if not targets:
            raise RuntimeError(
                "no live ready replica to reload — serve(shutdown=False) "
                "first, or reload mid-serve from another thread"
            )
        self._reload_acks = {}
        get_tracer().event(
            "fleet/reload_begin", cat="fleet", ckpt_dir=str(ckpt_dir),
            replicas=[m.index for m in targets],
        )
        logger.info(
            "fleet reload -> %s (%d replica(s))", ckpt_dir, len(targets)
        )
        for member in targets:
            member.inbox.put(
                {"control": "reload", "ckpt_dir": str(ckpt_dir)}
            )
        want = {m.index for m in targets}

        def valid_acks() -> Dict[int, Dict[str, Any]]:
            # an ack counts for THIS reload only when it names this
            # ckpt_dir (or names none — the worker-shutdown nack): a
            # stale ack from a previous timed-out reload must not read
            # as this one's success
            return {
                rid: a for rid, a in self._reload_acks.items()
                if a.get("ckpt_dir") in (None, str(ckpt_dir))
            }

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not want <= set(valid_acks()):
            if self._serving:
                # a dispatch loop is pumping the outbox; stealing from it
                # here would drop serve messages — just wait for it to
                # fill the acks
                time.sleep(0.02)
                continue
            try:
                msg = self._outbox.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            self._pump_idle(msg)
        acks = valid_acks()
        for rid in sorted(want - set(acks)):
            acks[rid] = {
                "ok": False, "error": f"no ack within {timeout_s}s",
            }
        if all(a.get("ok") for a in acks.values()):
            # report field and registry counter move TOGETHER: both mean
            # "a reload every live replica acknowledged" — a failed or
            # timed-out broadcast must not read as a success anywhere
            self.reloads += 1
            get_registry().counter("fleet.reloads").inc()
        return acks

    def _pump_idle(self, msg) -> None:
        """Minimal message handling for the BETWEEN-serves window (no
        dispatch loop running): liveness, metrics, dumps and reload acks.
        Request-scoped kinds are STASHED, not dropped — a serve() that
        started on another thread while this pump held the outbox would
        otherwise lose a 'done'/'token' and wait on its flight forever
        (the serve loop re-dispatches the stash before reading the
        outbox)."""
        kind, rid = msg[0], msg[1]
        member = next(
            (m for m in self._members if m.index == rid and not m.dead),
            None,
        )
        if member is not None:
            member.last_msg_at = time.perf_counter()
        if kind == "metrics":
            self._metric_states[(rid, msg[2])] = msg[3]
        elif kind == "dumps":
            self._worker_dumps.extend(msg[2])
        elif kind in ("reload_done", "reload_error"):
            payload = dict(msg[2])
            payload["ok"] = kind == "reload_done"
            self._reload_acks[rid] = payload
            get_tracer().event(
                "fleet/reload_ack", cat="fleet", replica=rid,
                ok=payload["ok"],
            )
        elif kind == "ready":
            if member is not None:
                member.ready = True  # a worker coming up mid-pump counts
                self._note_ready(rid, msg[2])
        elif kind != "hb":
            self._stashed_msgs.append(msg)

    def wait_ready(self, timeout_s: float = DEFAULT_READY_TIMEOUT_S) -> bool:
        """Between serves, pump the outbox until every live replica (a
        restarted one included) is ready.  False at the timeout, or as
        soon as a live replica's process has exited."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            live = [m for m in self._members if not m.dead]
            if all(m.ready for m in live):
                return True
            if any(m.proc.exitcode is not None for m in live):
                return False
            try:
                msg = self._outbox.get(timeout=0.1)
            except queue_mod.Empty:
                continue
            self._pump_idle(msg)
        return False

    def _note_ready(self, rid: int, hs: Dict[str, Any]) -> None:
        """Record a worker's ready handshake: spawn-to-ready seconds on
        the router clock, its device, and whether it loaded jax."""
        info = self._worker_info.get(f"replica{rid}-{hs.get('pid')}")
        if info is None:
            return
        info["spawn_to_ready_s"] = round(
            time.perf_counter() - info["spawned_at"], 4
        )
        info["device"] = hs.get("device")
        info["jax_loaded"] = hs.get("jax_loaded")

    # -- serving -----------------------------------------------------------

    def serve(
        self,
        requests: Sequence[Request],
        *,
        shutdown: bool = True,
        poll: Optional[Callable[[], Optional[List[Request]]]] = None,
    ) -> tuple[List[CompletedRequest], FleetReport]:
        """Serve every request across the fleet; returns (results, report).

        Results preserve completion order.  Blocks until every request
        reaches a terminal state (or the fleet drains), then — with
        ``shutdown=True``, the default — shuts the workers down
        gracefully.  ``shutdown=False`` keeps the worker processes alive
        and idle, so a second ``serve`` call reuses them (no respawn, no
        rebuild): the multi-batch shape :meth:`reload` slots between:
        serve batch A, reload the fleet's weights, serve batch B on the
        same processes.

        ``poll`` is the router-level live source (same contract as the
        scheduler's: a list of fresh requests, or None = source closed)
        — :func:`..serve.traffic.poll_source` adapts a traffic schedule
        into one.  It is consulted only once at least one replica is
        READY, so a wall-clock schedule starts when the fleet can
        actually serve (torch import and engine build don't eat the
        schedule) — poll_source's clock starting at its first call is
        the other half of this contract.
        """
        trace = get_tracer()
        router_epoch_unix_s = trace.epoch_unix_s
        t_start = time.perf_counter()
        if not self._members or all(m.dead for m in self._members):
            self._members = [
                self._spawn(i, self._dealt[i]) for i in range(self.replicas)
            ]
        self._serving = True
        flights: Dict[str, _Flight] = {}
        backlog: List[str] = []  # uids waiting for a live replica
        results: List[CompletedRequest] = []
        finish_reasons: Dict[str, int] = {}
        # class rank for dispatch ordering / class-weighted load (lower
        # rank = higher priority); unknown classes sort LAST and the
        # worker's own admission validation rejects them with a clear
        # per-request error
        class_rank = {
            c: i for i, c in enumerate(self.spec.priority_classes)
        }
        n_classes = len(self.spec.priority_classes)
        intake_n = [0]

        def admit(req: Request, *, strict: bool) -> None:
            """Mint the flight + backlog entry for one request.  Upfront
            requests keep the raising contract (caller bug); polled
            duplicates are logged and skipped — a raise mid-loop would
            kill the router over one bad source entry."""
            if req.uid in flights or _SEP in req.uid:
                problem = (
                    "duplicate request uid" if req.uid in flights
                    else "uid contains the reserved delivery separator"
                )
                if strict:
                    raise ValueError(f"{problem}: {req.uid!r}")
                logger.warning("polled request dropped (%s): %r",
                               problem, req.uid)
                return
            arrived = time.perf_counter()
            deadline_s = (
                req.deadline_s
                if req.deadline_s is not None
                else self.spec.request_deadline_s
            )
            flights[req.uid] = _Flight(
                req=req,
                submitted_at=arrived,
                # trace id minted at ROUTER INTAKE (honoring a caller-
                # supplied one): the single correlation key every
                # delivery, every worker span and every recovery event
                # carries — distinct from the uid so propagation, not
                # coincidence, is what the merged timeline shows
                trace_id=req.trace_id or f"tr{intake_n[0]:04d}",
                deadline_at=(
                    arrived + deadline_s if deadline_s is not None else None
                ),
            )
            intake_n[0] += 1
            trace.event(
                "fleet/request_admitted", cat="fleet", uid=req.uid,
                tenant=req.tenant, priority=req.priority,
                trace=flights[req.uid].trace_id,
            )
            backlog.append(req.uid)

        for req in requests:
            admit(req, strict=True)

        def finalize(uid: str, payload: Dict[str, Any]) -> None:
            """Stitch a terminal result into the router view (idempotent:
            a death can race a completion — e.g. the worker's 'done' is
            harvested by the death's drain_burst AFTER the member was
            marked dead, so its outstanding set still holds the uid and
            handle_death would try to redeliver finished work)."""
            fl = flights[uid]
            if fl.done:
                return
            fl.done = True
            fl.replica = None
            done_at = time.perf_counter()
            ttft = (
                fl.first_token_at - fl.submitted_at
                if fl.first_token_at is not None
                else 0.0
            )
            res = CompletedRequest(
                uid=uid,
                prompt_len=len(fl.req.prompt),
                # "preempted" promises no tokens (resubmit replays the
                # whole request) — drop a dead delivery's preserved stream
                tokens=(
                    fl.preserved + list(payload["tokens"])
                    if payload["finish_reason"] != "preempted"
                    else []
                ),
                finish_reason=payload["finish_reason"],
                ttft_s=round(ttft, 6),
                total_s=round(done_at - fl.submitted_at, 6),
                error=payload.get("error"),
                queue_wait_s=payload.get("queue_wait_s", 0.0),
                # SLO identity from the FLIGHT (authoritative — router-
                # synthesized terminals have no worker payload to read);
                # shed backoff hint and preemption count ride the worker
                # payload when present
                tenant=fl.req.tenant,
                priority=fl.req.priority,
                retry_after_s=payload.get("retry_after_s"),
                preemptions=payload.get("preemptions", 0),
            )
            results.append(res)
            finish_reasons[res.finish_reason] = (
                finish_reasons.get(res.finish_reason, 0) + 1
            )

        def redeliver(
            uid: str, why: str, avoid: Optional[int],
            *, shed: bool = False, retry_after_s: Optional[float] = None,
        ) -> None:
            """Requeue one in-flight uid after a replica death or a shed
            — at most ``max_redeliveries`` retries, the current stream
            committed into ``preserved`` so the retry continues the
            sequence bit-identically.  ``shed=True`` marks an admission-
            time shed: if the retry budget is ALSO spent the request
            finishes terminal ``"shed"`` (an accounted, intentional
            rejection with a backoff hint) rather than a lost
            ``"error"`` — nothing was lost, the whole fleet is just
            overloaded and the client is told when to come back."""
            fl = flights[uid]
            if fl.done:
                return  # completion already raced in — nothing to redo
            fl.preserved = fl.preserved + fl.streamed
            fl.streamed = []
            fl.replica = None
            fl.avoid = avoid
            budget = (
                fl.req.max_new_tokens
                if fl.req.max_new_tokens is not None
                else self.spec.max_new_tokens
            )
            eos = self.spec.eos_id
            if len(fl.preserved) >= budget or (
                eos is not None and fl.preserved and fl.preserved[-1] == eos
            ):
                # the dead worker had already streamed the whole answer —
                # only its 'done' was lost.  A retry would ship
                # max_new_tokens=0 (worker-crashing) or decode past EOS
                # (bit-exactness-breaking); the stream itself is the
                # complete result, so finish it here.
                finalize(uid, {
                    "tokens": [],
                    "finish_reason": (
                        "eos"
                        if eos is not None
                        and fl.preserved
                        and fl.preserved[-1] == eos
                        else "length"
                    ),
                })
                return
            if fl.delivery - 1 >= self.max_redeliveries:
                if shed:
                    trace.event(
                        "fleet/request_shed", cat="fleet", uid=uid,
                        reason=why, trace=fl.trace_id,
                    )
                    finalize(uid, {
                        "tokens": [],
                        "finish_reason": "shed",
                        "error": (
                            f"shed fleet-wide after {why} "
                            f"({self.max_redeliveries} retries)"
                        ),
                        "retry_after_s": retry_after_s,
                    })
                    return
                self.lost_requests += 1
                trace.event(
                    "fleet/request_lost", cat="fleet", uid=uid, reason=why,
                    trace=fl.trace_id,
                )
                finalize(uid, {
                    "tokens": [],
                    "finish_reason": "error",
                    "error": (
                        f"redelivery budget spent "
                        f"({self.max_redeliveries}) after {why}"
                    ),
                })
                return
            self.redeliveries += 1
            trace.event(
                "fleet/request_requeued", cat="fleet", uid=uid,
                reason=why, preserved_tokens=len(fl.preserved),
                delivery=fl.delivery, trace=fl.trace_id,
            )
            backlog.append(uid)

        def deliver(member: _Replica, uid: str) -> None:
            fl = flights[uid]
            fl.delivery += 1
            fl.replica = member.index
            member.outstanding.add(uid)
            budget = (
                fl.req.max_new_tokens
                if fl.req.max_new_tokens is not None
                else self.spec.max_new_tokens
            )
            member.inbox.put({
                "uid": fl.wire_uid(),
                # the trace id crosses the wire WITH the delivery: the
                # worker's scheduler tags every span/event for this
                # request with it, whichever replica (or redelivery)
                # ends up serving it
                "trace_id": fl.trace_id,
                # failover continuation: everything already streamed rides
                # in the prompt; greedy decode then reproduces the
                # fault-free stream exactly (decode == full forward)
                "prompt": list(fl.req.prompt) + fl.preserved,
                "max_new_tokens": budget - len(fl.preserved),
                # priority propagates on EVERY delivery, redeliveries
                # included — a premium failover must not resume as an
                # anonymous "standard" request on the new replica
                "tenant": fl.req.tenant,
                "priority": fl.req.priority,
                # only the REMAINING window: the worker re-bases from its
                # own arrival clock, so shipping the raw relative value
                # would hand every redelivery a fresh full deadline
                "deadline_s": (
                    fl.deadline_at - time.perf_counter()
                    if fl.deadline_at is not None
                    else None
                ),
            })

        def current_flight(wire_uid: str) -> Optional[_Flight]:
            """Resolve a wire uid; None for a superseded delivery."""
            uid, _, delivery = wire_uid.rpartition(_SEP)
            fl = flights.get(uid)
            if fl is None or str(fl.delivery) != delivery:
                return None  # raced a death: the delivery was replaced
            return fl

        def process(msg) -> None:
            kind, rid = msg[0], msg[1]
            member = next(
                (m for m in self._members
                 if m.index == rid and not m.dead),
                None,
            )
            if member is not None:
                member.last_msg_at = time.perf_counter()
            if kind == "token":
                fl = current_flight(msg[2])
                if fl is not None and fl.replica == rid:
                    if fl.first_token_at is None:
                        fl.first_token_at = time.perf_counter()
                    fl.streamed.append(msg[3])
            elif kind == "done":
                payload = msg[2]
                fl = current_flight(payload["uid"])
                if fl is None or fl.replica != rid:
                    return  # stale result from a superseded delivery
                if member is not None:
                    member.outstanding.discard(fl.req.uid)
                # the worker's token list for this delivery subsumes the
                # streamed prefix — drop the stream, keep the authority
                fl.streamed = []
                if payload["finish_reason"] == "shed":
                    self.shed_seen += 1
                    redeliver(
                        fl.req.uid, f"shed by replica {rid}", avoid=rid,
                        shed=True,
                        retry_after_s=payload.get("retry_after_s"),
                    )
                    return
                finalize(fl.req.uid, payload)
            elif kind == "exit":
                if member is not None:
                    member.report = msg[2]
            elif kind == "spawn_error":
                # engine build failed: the worker reports and exits 0, so
                # the exit-code poll would read it as a CLEAN exit and
                # retire the replica without ever spending its restart
                # budget — treat the message itself as the death signal
                # (transient causes, e.g. a replicated io_error hitting
                # checkpoint restore, deserve the restart)
                logger.warning("replica %d spawn_error: %s", rid, msg[2])
                self._spawn_errors.append(f"replica {rid}: {msg[2]}")
                if member is not None:
                    handle_death(member, f"spawn_error: {msg[2]}")
            elif kind == "crash":
                # informational: the non-zero exit code is the reliable
                # death signal (the process is mid-raise right now)
                logger.warning("replica %d crash: %s", rid, msg[2])
            elif kind == "metrics":
                # latest mergeable registry state per worker incarnation
                # (cumulative per process — last wins; a restarted
                # replica's new pid is a NEW incarnation, so the dead
                # one's final state stays in the fleet merge)
                self._metric_states[(rid, msg[2])] = msg[3]
            elif kind == "dumps":
                # flight-recorder dumps the worker shipped before dying
                # (injected death / quarantine / unhandled exception)
                self._worker_dumps.extend(msg[2])
            elif kind in ("reload_done", "reload_error"):
                # live-reload acknowledgement: reload() (possibly on
                # another thread) waits on these
                payload = dict(msg[2])
                payload["ok"] = kind == "reload_done"
                self._reload_acks[rid] = payload
                trace.event(
                    "fleet/reload_ack", cat="fleet", replica=rid,
                    ok=payload["ok"],
                )
            elif kind == "ready" and member is not None:
                member.ready = True
                hs = msg[2]
                self._note_ready(rid, hs)
                if isinstance(hs, dict) and "epoch_unix_s" in hs:
                    # clock handshake: worker tracer epoch (wall clock)
                    # vs the router's — the per-shard offset estimate
                    # the fleet trace merge aligns with; the send->recv
                    # delay bounds how stale the estimate can be
                    self.clock_offsets_us[hs.get("pid")] = (
                        float(hs["epoch_unix_s"]) - router_epoch_unix_s
                    ) * 1e6
            # "hb" carries no payload beyond liveness, handled above

        def drain_burst(budget_s: float = 0.3) -> None:
            """Opportunistically process already-flushed messages — called
            on a death so tokens the dying worker got onto the wire are
            harvested into ``streamed`` before the requeue commits them."""
            deadline = time.monotonic() + budget_s
            while time.monotonic() < deadline:
                try:
                    process(self._outbox.get(timeout=0.02))
                except queue_mod.Empty:
                    break

        def handle_death(member: _Replica, how: str) -> None:
            member.dead = True
            self.replica_deaths += 1
            drain_burst()  # harvest the pipe before committing streams
            orphans = sorted(member.outstanding)
            trace.event(
                "fleet/replica_died", cat="fleet", replica=member.index,
                how=how, outstanding=len(member.outstanding),
                restarts_used=member.restarts_used,
                # the orphaned trace ids ride the death event, so a
                # per-trace chain in the merged timeline contains the
                # death that interrupted it (failover_chains groups on
                # these alongside per-request `trace` tags)
                trace_ids=[flights[uid].trace_id for uid in orphans],
            )
            # black-box trigger: freeze the ROUTER's recent view (fleet
            # events, dispatch spans, metric movements) at the moment the
            # death was observed — attached to the FleetReport
            get_recorder().dump(
                "replica_death", registry=get_registry(),
                replica=member.index, how=how, orphans=len(orphans),
            )
            logger.warning(
                "replica %d died (%s) with %d request(s) in flight",
                member.index, how, len(member.outstanding),
            )
            member.outstanding.clear()
            for uid in orphans:
                redeliver(
                    uid, f"replica {member.index} died ({how})",
                    avoid=None,
                )
            if (
                member.restarts_used < self.max_restarts
                and not self._drain_event.is_set()
            ):
                # the restarted process must not replay its own injected
                # death forever — strip replica_death from its slice
                respec = faults_mod.strip_kinds(
                    member.faults_spec, ("replica_death",)
                )
                fresh = self._spawn(member.index, respec)
                fresh.restarts_used = member.restarts_used + 1
                self.restarts += 1
                trace.event(
                    "fleet/replica_restarted", cat="fleet",
                    replica=member.index, attempt=fresh.restarts_used,
                )
                self._members[self._members.index(member)] = fresh

        def retire(member: _Replica) -> None:
            """Clean exit (code 0, nothing outstanding): not a death."""
            member.dead = True

        # --- dispatch loop ------------------------------------------------
        # Host bookkeeping only: queue pumps, health checks, least-loaded
        # dispatch.  The one blocking call is the outbox get with a short
        # timeout (the router's idle wait, not a device sync).
        # live router source: stays truthy while poll can still produce
        # requests — the loop condition keeps running even when every
        # admitted flight has finished
        more = poll is not None
        try:
            while len(results) < len(flights) or more:
                live = [m for m in self._members if not m.dead]
                if more:
                    if self._drain_event.is_set() or not live:
                        # draining (new arrivals would be preempted
                        # unserved) or fleet dead (nothing will ever
                        # serve them): close the source
                        more = False
                    elif any(m.ready for m in live):
                        # consult the source only once somebody can
                        # serve: poll_source starts its schedule clock
                        # at the first call, so spawn, import and build
                        # time never eats the traffic schedule
                        fresh = poll()
                        if fresh is None:
                            more = False
                        else:
                            for req in fresh:
                                admit(req, strict=False)
                if self._drain_event.is_set() and backlog:
                    # router-held work the drain will never admit: hand it to
                    # the control plane's resubmit path.  NOT one-shot — a
                    # replica dying DURING the drain redelivers its orphans
                    # into the backlog, and with every dispatch branch gated
                    # off by the drain nothing else would ever consume them
                    # (the loop would spin forever on len(results))
                    for uid in backlog:
                        finalize(uid, {
                            "tokens": [], "finish_reason": "preempted",
                        })
                    backlog.clear()
                if backlog and not live and not self._drain_event.is_set():
                    # no replica left and no restart budget: fail the
                    # stranded requests loudly instead of spinning forever
                    for uid in backlog:
                        self.lost_requests += 1
                        trace.event(
                            "fleet/request_lost", cat="fleet", uid=uid,
                            reason="no live replica",
                            trace=flights[uid].trace_id,
                        )
                        finalize(uid, {
                            "tokens": [], "finish_reason": "error",
                            "error": "no live replica (restart budget spent)",
                        })
                    backlog.clear()
                if backlog and live and not self._drain_event.is_set():
                    held: List[str] = []
                    # only READY replicas take work: a request put on a
                    # still-spawning replica's inbox would sit unserved
                    # through its whole torch import + engine build while a
                    # live replica idles (holding at the router keeps the
                    # choice open until somebody can actually serve)
                    ready = [m for m in live if m.ready]

                    def rank_of(uid: str) -> int:
                        return class_rank.get(
                            flights[uid].req.priority, n_classes - 1
                        )

                    def member_load(m: _Replica) -> int:
                        # class-WEIGHTED load: each outstanding request
                        # counts 2^(classes below it) — one premium
                        # outweighs any backlog of best_effort, so the
                        # least-loaded choice is really "least loaded
                        # with work that matters".  Single-class fleets
                        # degrade to the old outstanding-count exactly.
                        return sum(
                            1 << (n_classes - 1 - rank_of(ouid))
                            for ouid in m.outstanding
                        )

                    # dispatch in class order (stable: FIFO within a
                    # class) — the router-side half of "higher class
                    # always dequeues first"
                    for uid in sorted(backlog, key=rank_of):
                        fl = flights[uid]
                        if (
                            fl.deadline_at is not None
                            and time.perf_counter() > fl.deadline_at
                        ):
                            # expired while router-held (e.g. waiting out a
                            # restart): same terminal state the worker would
                            # give it, without burning a delivery
                            finalize(uid, {
                                "tokens": [], "finish_reason": "deadline",
                            })
                            continue
                        if not ready:
                            held.append(uid)
                            continue
                        pool = [
                            m for m in ready if m.index != fl.avoid
                        ] or ready  # avoid the shedder unless it is all we have
                        target = min(
                            pool,
                            key=lambda m: (
                                member_load(m), len(m.outstanding), m.index,
                            ),
                        )
                        # cap in-flight per replica at slots + a small ready
                        # queue: enough to keep the worker's admission loop
                        # fed, small enough that a death orphans (and redoes)
                        # at most one batch's worth of work.  Only SAME-OR-
                        # HIGHER-class outstanding work counts against the
                        # cap: lower-class work is preemptible on arrival,
                        # so a best_effort backlog must not stop a premium
                        # delivery from reaching the worker where the
                        # preemption ladder lives.  (Single-class traffic:
                        # identical to the old all-outstanding cap.)
                        my_rank = rank_of(uid)
                        blocking = sum(
                            1 for ouid in target.outstanding
                            if rank_of(ouid) <= my_rank
                        )
                        if blocking >= self.spec.batch_slots + 2:
                            held.append(uid)  # every replica saturated: hold
                            continue
                        deliver(target, uid)
                    backlog[:] = held
                if len(results) >= len(flights) and not more:
                    break
                # messages a concurrent reload()'s idle pump read off the
                # outbox before this loop started are re-dispatched first
                while self._stashed_msgs:
                    process(self._stashed_msgs.pop(0))
                try:
                    process(self._outbox.get(timeout=0.05))
                except queue_mod.Empty:
                    pass
                now = time.perf_counter()
                for member in list(self._members):
                    if member.dead:
                        continue
                    code = member.proc.exitcode
                    if code is not None:
                        if code != 0:
                            handle_death(member, f"exit code {code}")
                        else:
                            # clean exit: give the pipe a grace period to
                            # deliver trailing done/exit messages, then treat
                            # a still-outstanding request set as a death
                            if member.exit_seen_at is None:
                                member.exit_seen_at = now
                            if not member.outstanding and member.report is not None:
                                retire(member)
                            elif now - member.exit_seen_at > 2.0:
                                if member.outstanding:
                                    handle_death(member, "clean exit mid-flight")
                                else:
                                    retire(member)
                    elif (
                        self.heartbeat_timeout_s is not None
                        and member.last_msg_at is not None
                        and member.outstanding
                        and now - member.last_msg_at > self.heartbeat_timeout_s
                    ):
                        member.proc.terminate()
                        member.proc.join(timeout=5.0)
                        handle_death(member, "heartbeat timeout")
                    elif (
                        not member.ready
                        and now - member.spawned_at > DEFAULT_READY_TIMEOUT_S
                    ):
                        # hung BEFORE ready (a stuck checkpoint restore or
                        # CUDA init): no heartbeat ever arms the staleness
                        # check above and no work is outstanding, so
                        # without this bound the router would hold its
                        # backlog for this replica forever
                        member.proc.terminate()
                        member.proc.join(timeout=5.0)
                        handle_death(member, "spawn hang")

        finally:
            # cleared even when the dispatch loop raises: a stuck
            # True would make every later reload() sleep out its
            # whole timeout waiting for a loop that no longer exists
            self._serving = False
        if shutdown:
            self._shutdown_members()

        wall = time.perf_counter() - t_start
        ok = [r for r in results if r.finish_reason in ("eos", "length")]
        errors = sum(1 for r in results if r.finish_reason == "error")
        generated = sum(len(r.tokens) for r in results)
        good_tokens = sum(len(r.tokens) for r in ok)
        # post-warmup window: dividing by the WHOLE wall would count
        # replica spawn, torch import and engine build as serving.  The
        # warmup boundary is the router observing the fleet's FIRST
        # streamed token (engines are built from then on); the shared
        # helper in obs/goodput.py is the one definition of the rate.
        first_token = min(
            (
                fl.first_token_at for fl in flights.values()
                if fl.first_token_at is not None
            ),
            default=None,
        )
        warmup_s = (
            max(first_token - t_start, 0.0) if first_token is not None
            else 0.0
        )
        tpot = [
            (r.total_s - r.ttft_s) / (len(r.tokens) - 1)
            for r in ok
            if len(r.tokens) >= 2
        ]
        # fleet-level metrics: merge every worker incarnation's LAST
        # shipped registry state bucket-wise — the percentiles below are
        # exactly what one process recording every worker's samples
        # would report (obs.fleet.fleet_latency is THE one reader of
        # the merge, so the report and the obs layer cannot drift)
        metric_states = [
            self._metric_states[key] for key in sorted(self._metric_states)
        ]
        merged_registry = merge_states(metric_states)
        router_dumps = get_recorder().drain_dumps()
        # per-class rollup on the router clock: the same
        # completed-ok/TTFT/TPOT filters as the aggregates above, split
        # by the class each result carries
        per_class: Dict[str, Any] = {}
        for r in results:
            blk = per_class.setdefault(r.priority, {
                "requests": 0, "completed_ok": 0, "errors": 0,
                "shed": 0, "preempted": 0, "preemptions": 0,
                "finish_reasons": {}, "_ttft": [], "_tpot": [],
            })
            blk["requests"] += 1
            blk["finish_reasons"][r.finish_reason] = (
                blk["finish_reasons"].get(r.finish_reason, 0) + 1
            )
            blk["preemptions"] += r.preemptions
            if r.finish_reason in ("eos", "length"):
                blk["completed_ok"] += 1
                blk["_ttft"].append(r.ttft_s)
                if len(r.tokens) >= 2:
                    blk["_tpot"].append(
                        (r.total_s - r.ttft_s) / (len(r.tokens) - 1)
                    )
            elif r.finish_reason == "error":
                blk["errors"] += 1
            elif r.finish_reason == "shed":
                blk["shed"] += 1
            elif r.finish_reason == "preempted":
                blk["preempted"] += 1
        for blk in per_class.values():
            blk["ttft_s"] = summarize(blk.pop("_ttft"))
            blk["tpot_s"] = summarize(blk.pop("_tpot"))
        report = FleetReport(
            replicas=self.replicas,
            requests=len(flights),
            generated_tokens=generated,
            wall_s=round(wall, 4),
            goodput_tokens_per_sec=post_warmup_tokens_per_sec(
                good_tokens, wall, warmup_s
            ),
            warmup_s=round(warmup_s, 4),
            completed_ok=len(ok),
            errors=errors,
            error_rate=round(errors / len(flights), 4) if flights else 0.0,
            finish_reasons=finish_reasons,
            ttft_s=summarize([r.ttft_s for r in ok]),
            tpot_s=summarize(tpot),
            restarts=self.restarts,
            replica_deaths=self.replica_deaths,
            redeliveries=self.redeliveries,
            reloads=self.reloads,
            lost_requests=self.lost_requests,
            shed=self.shed_seen,
            drained=self._drain_event.is_set(),
            replica_reports=[m.report for m in self._members],
            trace_ids={
                uid: fl.trace_id for uid, fl in flights.items()
            },
            replica_metric_states=metric_states,
            fleet_metrics=merged_registry.snapshot(),
            fleet_latency=fleet_latency(merged_registry),
            fleet_latency_per_class=fleet_latency_per_class(
                merged_registry
            ),
            flight_recorder_dumps=router_dumps + self._worker_dumps,
            hbm_watermarks=_hbm_watermarks(metric_states),
            tier_watermarks=_tier_watermarks(metric_states),
            per_class=per_class,
            worker_info={
                key: {k: v for k, v in info.items() if k != "spawned_at"}
                for key, info in self._worker_info.items()
            },
            spawn_errors=list(self._spawn_errors),
        )
        reg = get_registry()
        reg.counter("fleet.replica_deaths").inc(self.replica_deaths)
        reg.counter("fleet.restarts").inc(self.restarts)
        reg.counter("fleet.redeliveries").inc(self.redeliveries)
        reg.counter("fleet.lost_requests").inc(self.lost_requests)
        return results, report


def serve_fleet(
    spec: ReplicaSpec,
    requests: Sequence[Request],
    *,
    replicas: int = 2,
    max_restarts: int = 1,
    max_redeliveries: int = 2,
    heartbeat_timeout_s: Optional[float] = DEFAULT_HEARTBEAT_TIMEOUT_S,
    faults: Optional[str] = None,
    install_signals: bool = False,
    poll: Optional[Callable[[], Optional[List[Request]]]] = None,
) -> tuple[List[CompletedRequest], FleetReport]:
    """One-call fleet serving: a :class:`FleetRouter` serving
    ``requests`` once; its workers are stopped whatever happens."""
    router = FleetRouter(
        spec,
        replicas=replicas,
        max_restarts=max_restarts,
        max_redeliveries=max_redeliveries,
        heartbeat_timeout_s=heartbeat_timeout_s,
        faults=faults,
    )
    if install_signals:
        router.install_signal_handler()
    try:
        return router.serve(requests, poll=poll)
    finally:
        router.terminate()

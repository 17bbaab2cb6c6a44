"""Continuous batching: a request queue feeding KV-cache slots
(``serve/scheduler.py``).

A slot is released the moment its sequence hits EOS or its token budget,
and the next queued prompt is admitted into it between decode steps while
the other slots decode on.  The loop is host-side and synchronous: one
decode step per iteration, admission between steps, and the engine's
decode readback the one designed sync per step.

With a paged engine (``engine.chunked_prefill``) admission is gated on
pages: a request that could never fit the pool fails, one that does not
fit now waits while anything is decoding or prefilling (and fails loudly
when nothing is), and an admitted prompt is prefilled ONE chunk per loop
iteration, before that iteration's decode step, so running requests stall
at most one chunk per step.

What it records: per-request TTFT (arrival -> first token) and queue wait
(arrival -> admission), TPOT (time per output token after the first), the
per-decode-step wall, mean slot occupancy and generated tokens/s, all
through the obs histogram (:func:`~..obs.registry.summarize`); in spec
mode also the acceptance rate, tokens per verify and the draft/verify
walls.  Request-lifecycle spans and events go to the obs tracer (no-ops
unless a caller enabled it), and the run's counters and histograms to the
process metrics registry.

Resilience — every failure is scoped to ONE request, never the batch:

- **deadlines** and **cancellation** (``request_cancel``): a queued
  request finishes ``"deadline"`` / ``"cancelled"`` without admission, an
  active one with its partial tokens, through the normal ``release``;
- **NaN quarantine**: a slot whose logits are not finite
  (``engine.last_finite``, read back with the tokens) is scrubbed and
  fails alone;
- **decode-exception requeue**: a Python exception out of
  ``engine.decode`` itself requeues every surviving slot ONCE — prompt
  extended by the tokens already generated, budget reduced, the preserved
  tokens stitched back into the result;
- **watchdog**: ``watchdog_deadline_s`` arms a
  :class:`~..train.resilience.StepWatchdog` over the loop (a hung decode
  -> stack dump + exit 70; ``watchdog_on_timeout`` overrides the exit);
- **live serving and drain**: ``run(poll=...)`` keeps the loop alive on an
  external request source; ``should_drain`` stops admission, finishes the
  active requests and returns queued ones ``"preempted"``;
- **live reload** (``request_reload``): applied at the next idle barrier,
  so every request is served by one weight set.

Multi-tenant overload: requests carry ``tenant`` / ``priority``; the queue
dequeues higher classes first (``priority_classes``, highest first); a
blocked higher-class head preempts the lowest-class active decode
LOSSLESSLY (its retry resumes the stream exactly, up to ``preempt_budget``
cuts, then it finishes terminal ``"preempted"``); with
``shed_policy="shed"`` a lowest-class head under memory pressure is shed
after ``shed_patience`` blocked iterations, with a ``retry_after_s`` hint.
Admission also asks the device-memory ledger's forecast
(``obs/ledger.py``: the request's worst-case bytes against the headroom)
before it admits.  With a host page tier on the engine, a preempted
request's private pages spill to the host before release and the resume
restores them, and a pump keeps a free-page cushion by demoting cold
prefix pages each iteration.

Deterministic chaos comes from ``DDLT_FAULTS`` (``decode_nan`` /
``decode_stall`` / ``reject_admit``, :mod:`..utils.faults`).

With a ``spec_decoder`` (:class:`~..spec.SpeculativeDecoder` over the same
engine) each decode step is a speculative step: every slot drafts up to K
tokens and commits 1..K+1 of them after one batched verify.  Per-slot
draft caps keep the verify writes inside the budget, the page reservation
and ``max_seq``; EOS cuts inside the committed run; the rejected tails
are rolled back in one scatter BEFORE completions release their slots.

The same requests, priorities and ledger capacity give the reference's
decisions: dequeue order, sheds, preemptions and requeues count loop
iterations, not time.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from distributeddeeplearning_tpu_torch.obs.recorder import get_recorder
from distributeddeeplearning_tpu_torch.obs.registry import (
    Histogram,
    get_registry,
    summarize,
)
from distributeddeeplearning_tpu_torch.obs.trace import get_tracer
from distributeddeeplearning_tpu_torch.utils import faults as faults_mod


@dataclasses.dataclass
class Request:
    """One generation request: a token-id prompt plus an optional
    per-request token budget (falls back to the scheduler default) and an
    optional deadline (seconds from intake; falls back to the scheduler's
    ``request_deadline_s``).

    ``trace_id`` is the distributed-tracing correlation id the fleet
    router mints at intake and carries across the worker boundary: every
    request-scoped span/event the scheduler emits is tagged with it, so
    a failover (death on one replica, completion on another) reads as
    ONE chain in the merged fleet timeline.

    ``tenant``/``priority`` are the multi-tenant SLO-class identity: the
    scheduler dequeues higher classes first, sheds the lowest class
    first under overload, and preempts lower-class decodes for a blocked
    higher-class head (see ``priority_classes`` on the scheduler).  The
    defaults keep single-tenant callers exactly where they were."""

    uid: str
    prompt: Sequence[int]
    max_new_tokens: Optional[int] = None
    deadline_s: Optional[float] = None
    trace_id: Optional[str] = None
    tenant: str = "default"
    priority: str = "standard"


#: terminal states a request can reach (``CompletedRequest.finish_reason``)
FINISH_REASONS = (
    "eos", "length", "error", "step_cap", "cancelled",
    "deadline",   # request ran past its deadline (partial tokens kept)
    "shed",       # admission rejected under overload (reject_admit fault,
    #               priority-aware load shedding, or router-level
    #               backpressure) — safe to retry elsewhere / later
    "preempted",  # drain (scheduler shutting down) or priority preemption
    #               with the per-request preemption budget spent; promises
    #               NO tokens — the control plane resubmits the request
)


@dataclasses.dataclass
class CompletedRequest:
    uid: str
    prompt_len: int
    tokens: List[int]
    finish_reason: str  # one of FINISH_REASONS
    ttft_s: float
    total_s: float
    error: Optional[str] = None  # set when finish_reason == "error"
    queue_wait_s: float = 0.0  # arrival -> admission (scheduler latency)
    tenant: str = "default"
    priority: str = "standard"
    # "shed" results only: the scheduler's estimate of when capacity
    # frees (seconds) — the client-side backoff hint
    retry_after_s: Optional[float] = None
    # lossless priority preemptions this request survived (each one cut
    # its decode and resumed it bit-identically elsewhere in the queue)
    preemptions: int = 0


@dataclasses.dataclass
class _SlotState:
    req: Request
    budget: int
    generated: List[int]
    next_pos: int  # position the NEXT decode input token occupies
    ttft_s: float
    queue_wait_s: float = 0.0
    deadline_at: Optional[float] = None  # absolute perf_counter deadline


@dataclasses.dataclass
class _ReqMeta:
    """Cross-delivery bookkeeping for one uid: survives a decode-exception
    requeue, so the final :class:`CompletedRequest` reports the ORIGINAL
    prompt length, the stitched token stream, and first-delivery latency."""

    arrival: float
    orig_prompt_len: int
    deadline_at: Optional[float] = None
    preserved: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    decode_retries: int = 0
    # lossless priority preemptions consumed (budgeted SEPARATELY from
    # decode_retries: a preemption is scheduler policy, not a failure,
    # and must never eat a request's failure-recovery life)
    preemptions: int = 0


@dataclasses.dataclass
class ServeReport:
    """Aggregate serving stats — the SERVE_*.json artifact body."""

    requests: int
    batch_slots: int
    generated_tokens: int
    prompt_tokens: int
    decode_steps: int
    wall_s: float
    tokens_per_sec: float
    ttft_s: Dict[str, float]
    decode_step_s: Dict[str, float]
    slot_occupancy_mean: float
    finish_reasons: Dict[str, int]
    # requests that ended with finish_reason == "error" (per-request fault
    # isolation: one bad request must not kill the batch)
    errors: int = 0
    # arrival -> admission percentiles: the scheduler-induced share of
    # TTFT, separated so queueing can't masquerade as prefill latency
    queue_wait_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-request time-per-output-token, (total - ttft) / (tokens - 1):
    # the steady-state latency a streaming client feels after the first
    # token (requests with < 2 tokens have no inter-token gap to measure)
    tpot_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # prefill shapes first met during THIS run
    prefill_compiles: int = 0
    kv_layout: str = "dense"
    # storage dtypes (quant provenance): an int8-KV or int8-weight
    # artifact is distinguishable from an f32 one without diffing configs
    kv_dtype: str = "float32"
    weights_dtype: str = "float32"
    # layout provenance: tensor-parallel degree the engine served at and
    # the partition-rule table that placed every array (count + digest,
    # ``parallel.sharding.layout_rules_provenance``) — a TP_* artifact is
    # meaningless without knowing which rule table produced the layout
    tp: int = 1
    layout_rules: str = ""
    # which attention kernel consumed the cache ("flash" =
    # ops.flash_decode, "gather" = the legacy dense read) — the QUANT
    # artifacts compare the two, so the report must say which ran
    decode_kernel: str = "gather"
    prefix_hit_rate: float = 0.0  # prompt tokens served from shared pages
    kv_bytes: int = 0  # KV pool bytes reserved
    # peak bytes committed to live sequences — equals kv_bytes under the
    # dense layout (the whole reservation is always committed)
    kv_bytes_peak: int = 0
    # resilience accounting: slots re-queued after a decode-step
    # exception, requests failed alone by the NaN quarantine, and whether
    # the run ended in a drain (SIGTERM/preemption — queued requests were
    # returned "preempted" for the control plane to resubmit)
    decode_retries: int = 0
    quarantined: int = 0
    drained: bool = False
    # decode-phase-only throughput: generated tokens over the summed wall
    # of the decode/spec steps alone.  ``tokens_per_sec`` divides by the
    # WHOLE run wall (prefill + compile + admission included), which
    # skews cross-config comparisons whenever prompt mixes or compile
    # budgets differ — this is the number decode-path changes (quant,
    # speculative decoding) are judged on
    decode_tokens_per_sec: float = 0.0
    # speculative decoding (spec/): provenance + the two numbers the
    # SPEC artifact gates on.  acceptance_rate = accepted drafts over
    # proposed drafts; tokens_per_verify = tokens committed per slot per
    # verify step (>= 1 — the amortization factor a spec config buys)
    speculative: bool = False
    drafter: Optional[str] = None
    draft_tokens: int = 0
    acceptance_rate: Optional[float] = None
    tokens_per_verify: Optional[float] = None
    # host wall of the draft dispatch chain / the verify dispatch +
    # readback, per spec step (zero-filled blocks on non-spec runs)
    draft_step_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    verify_step_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    # multi-tenant overload accounting: per-priority-class
    # latency/volume blocks — the UNLABELED blocks above stay the
    # all-traffic aggregate for committed-artifact schema compatibility
    # — plus the lossless-preemption event count
    per_class: Dict[str, Any] = dataclasses.field(default_factory=dict)
    preemptions: int = 0
    # KV host page tier (serve/kv_tier.py): spill/restore volume,
    # the host-tier share of prefix hits, and the host-pool watermark.
    # Zero-filled when no tier is attached, so artifact schemas stay
    # uniform across tiered and untiered runs.
    tier_enabled: bool = False
    tier_host_pages: int = 0
    tier_spilled_pages: int = 0
    tier_restored_pages: int = 0
    tier_dropped_pages: int = 0
    tier_host_pages_peak: int = 0
    tier_host_bytes_peak: int = 0
    # prompt tokens answered by a host-tier RESTORE (subset of the
    # prefix_hit_rate numerator): re-prefill compute the tier turned
    # into DMA
    tier_prefix_hit_tokens_host: int = 0
    # private pages demoted by the preemption path (victims resume
    # without re-prefilling their generated history)
    tier_preempt_spilled_pages: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def synthetic_requests(
    n: int,
    *,
    vocab_size: int,
    max_prompt: int,
    min_prompt: int = 2,
    shared_prefix_len: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> List[Request]:
    """``n`` random-token requests with lengths in [min_prompt, max_prompt]
    (the reference's generator: the same ``rng`` gives the same requests).

    ``shared_prefix_len > 0`` puts the SAME random prefix in front of
    every prompt — the system-prompt workload the paged engine's prefix
    cache is for."""
    if n < 1:
        raise ValueError(f"need at least 1 request, got {n}")
    rng = np.random.default_rng(0) if rng is None else rng
    hi = max(min_prompt, max_prompt)
    prefix: List[int] = (
        rng.integers(1, vocab_size, shared_prefix_len).tolist()
        if shared_prefix_len > 0
        else []
    )
    return [
        Request(
            uid=f"req{i}",
            prompt=prefix
            + rng.integers(
                1, vocab_size, rng.integers(min_prompt, hi + 1)
            ).tolist(),
        )
        for i in range(n)
    ]


# Percentile blocks route through the ONE streaming-histogram
# implementation in obs.registry (1% bounded relative error, exact
# mean/max) — the pre-obs per-site np.percentile math is gone, so every
# artifact's p50/p90/p99 means the same thing.
_percentiles = summarize


class _PriorityQueue:
    """Strict-priority pending queue, deque-shaped where the serve loop
    touches it: ``append`` routes by the request's class, ``popleft`` /
    ``[0]`` serve the head of the highest non-empty class, and
    ``appendleft`` returns a request to the FRONT of its own class — a
    requeued/preempted retry resumes ahead of its class peers but never
    jumps class.  Within a class, FIFO order is untouched, so an
    all-one-class workload behaves exactly like the old plain deque."""

    def __init__(self, rank: Dict[str, int]):
        self._rank = rank
        self._qs: List[deque] = [deque() for _ in rank]

    def append(self, req: Request) -> None:
        self._qs[self._rank[req.priority]].append(req)

    def appendleft(self, req: Request) -> None:
        self._qs[self._rank[req.priority]].appendleft(req)

    def popleft(self) -> Request:
        for q in self._qs:
            if q:
                return q.popleft()
        raise IndexError("pop from empty _PriorityQueue")

    def __getitem__(self, idx: int) -> Request:
        if idx != 0:
            raise IndexError("only the head ([0]) is addressable")
        for q in self._qs:
            if q:
                return q[0]
        raise IndexError("empty _PriorityQueue")

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs)


class ContinuousBatchingScheduler:
    """Drive an :class:`InferenceEngine` over a stream of requests."""

    def __init__(
        self,
        engine,
        *,
        eos_id: Optional[int] = None,
        max_new_tokens: int = 32,
        step_cap: Optional[int] = None,
        request_deadline_s: Optional[float] = None,
        watchdog_deadline_s: Optional[float] = None,
        watchdog_on_timeout: Optional[Callable[[], None]] = None,
        result_window: Optional[int] = None,
        spec_decoder=None,
        hbm_ledger="auto",
        priority_classes: Sequence[str] = (
            "premium", "standard", "best_effort",
        ),
        shed_policy: str = "block",
        preempt_budget: int = 2,
        shed_patience: int = 3,
    ):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if step_cap is not None and step_cap < 1:
            raise ValueError("step_cap must be >= 1")
        if request_deadline_s is not None and request_deadline_s <= 0:
            raise ValueError(
                f"request_deadline_s must be > 0, got {request_deadline_s}"
            )
        self.engine = engine
        self.eos_id = eos_id
        self.max_new_tokens = max_new_tokens
        # hard decode-step budget for smoke runs: when hit, active slots
        # complete as "step_cap" and unstarted requests as "cancelled",
        # so a scheduler/allocator regression can never hang CI
        self.step_cap = step_cap
        # default per-request deadline (Request.deadline_s overrides);
        # None = requests may run forever
        self.request_deadline_s = request_deadline_s
        # hot-loop watchdog (reuses train/resilience.StepWatchdog): if the
        # loop makes no progress for this long — a hung decode dispatch,
        # a dead collective — stacks are dumped and the process exits 70
        # so a supervisor (the fleet router, ddlt's control plane)
        # restarts it.  ``watchdog_on_timeout`` overrides the exit for
        # embedding/tests.
        self.watchdog_deadline_s = watchdog_deadline_s
        self.watchdog_on_timeout = watchdog_on_timeout
        # live-mode memory bound: keep only the last N CompletedRequests
        # (a fleet worker serving an open-ended stream already ships every
        # result out through on_complete — retaining all of them forever
        # would grow without bound).  None = retain everything (batch
        # semantics; run()'s return value is the full result set).
        # Aggregate counters (requests/tokens/finish_reasons) stay exact
        # either way; end-of-run percentiles cover the retained window.
        if result_window is not None and result_window < 1:
            raise ValueError(
                f"result_window must be >= 1, got {result_window}"
            )
        self.result_window = result_window
        # speculative decoding (spec.SpeculativeDecoder over this same
        # engine): each loop iteration drafts K tokens and verifies all
        # K+1 in one batched call, so slots advance a VARIABLE number of
        # tokens per step (1..K+1).  The decoder enforces greedy + f32
        # cache at construction; the scheduler only has to cap per-slot
        # draft lengths (budget / max_seq) and roll back rejected tails.
        if spec_decoder is not None and spec_decoder.engine is not engine:
            raise ValueError(
                "spec_decoder was built over a different engine than the "
                "scheduler drives — their caches would diverge silently"
            )
        self.spec_decoder = spec_decoder
        # HBM-ledger admission forecast (obs/ledger.py): before admitting
        # a request, the loop asks the ledger whether the request's
        # worst-case committed bytes still fit the predicted headroom —
        # backpressure by FORECAST, not by discovering the OOM mid-
        # decode.  "auto" resolves to the process ledger at run() (so
        # test swaps via set_ledger are honored); None disables.  With
        # no capacity configured (the CPU mesh) the check is one
        # attribute read.
        self.hbm_ledger = hbm_ledger
        # multi-tenant SLO classes, highest priority FIRST: the
        # queue dequeues higher classes first, admission sheds the LAST
        # class first (shed_policy="shed"), and a blocked higher-class
        # head preempts the lowest-class active decode losslessly, up to
        # preempt_budget cuts per request — the budget spent, the victim
        # finishes terminal "preempted" (graceful starvation, never a
        # livelock).  Requests default to priority "standard", so the
        # default tuple keeps single-tenant callers byte-identical.
        classes = tuple(priority_classes)
        if not classes or any(
            not isinstance(c, str) or not c for c in classes
        ):
            raise ValueError(
                "priority_classes must be a non-empty sequence of "
                f"non-empty class names, got {priority_classes!r}"
            )
        if len(set(classes)) != len(classes):
            raise ValueError(
                f"duplicate priority classes in {priority_classes!r}"
            )
        if shed_policy not in ("block", "shed"):
            raise ValueError(
                f"shed_policy must be 'block' or 'shed', got {shed_policy!r}"
            )
        if preempt_budget < 0:
            raise ValueError(
                f"preempt_budget must be >= 0, got {preempt_budget}"
            )
        if shed_patience < 0:
            raise ValueError(
                f"shed_patience must be >= 0, got {shed_patience}"
            )
        self.priority_classes = classes
        self.shed_policy = shed_policy
        self.preempt_budget = preempt_budget
        # consecutive blocked iterations a lowest-class head endures
        # before shedding while work is in flight: memory pressure is
        # often TRANSIENT (a completion two decode steps away frees the
        # pages), and a shed against one instantaneous reading throws
        # away a request that would have been admitted milliseconds
        # later.  0 = shed on first blocked pass.
        self.shed_patience = shed_patience
        self._class_rank = {c: i for i, c in enumerate(classes)}
        self._cancelled: set = set()
        # live weight reload: a callable applied at the
        # next IDLE BARRIER — single attribute store/load, so setting it
        # from another thread is safe
        self._pending_reload: Optional[Callable[[], Any]] = None

    def request_reload(self, apply_fn: Callable[[], Any]) -> None:
        """Schedule a live weight reload; ``apply_fn`` runs at the next
        idle barrier — no slot decoding, no prefill in flight — so every
        request is served end-to-end by exactly ONE weight set, and a
        request admitted after the reload decodes bit-identically to a
        fresh engine built from the new weights.  While the reload is
        pending, admission pauses (queued requests hold) and the active
        requests drain to completion; it never interrupts a decode step,
        let alone a token.  ``apply_fn`` must not raise (the fleet worker
        wraps its restore and reports errors over the outbox); a raise
        here is isolated, logged to the timeline, and serving continues
        on the old weights.  A second request before the first applied
        replaces it (last weight set wins)."""
        self._pending_reload = apply_fn

    @property
    def has_pending_reload(self) -> bool:
        """True when a requested reload has not applied yet — a worker
        shutting down checks this to NACK the reload instead of leaving
        the router waiting out its ack timeout."""
        return self._pending_reload is not None

    def request_cancel(self, uid: str) -> None:
        """Mark ``uid`` for cancellation; it finishes ``"cancelled"`` at
        the next loop boundary (queued: without admission; active: with
        its partial tokens, the slot freed through the normal release
        path).  A mark may arrive BEFORE the request itself (live mode:
        the cancel can beat the poll) — it waits and applies at intake.
        Safe to call from another thread: set add/discard are atomic and
        the loop never iterates the set while it could shrink."""
        self._cancelled.add(uid)

    def _finished(self, st: _SlotState) -> Optional[str]:
        if self.eos_id is not None and st.generated[-1] == self.eos_id:
            return "eos"
        if len(st.generated) >= st.budget:
            return "length"
        if st.next_pos >= self.engine.max_seq:
            return "length"  # cache full — no position left to write
        return None

    def _preemption_victim(
        self, active: Dict[int, "_SlotState"], head_rank: int
    ) -> Optional[int]:
        """Pick the active slot to cut for a blocked head of class rank
        ``head_rank``: the LOWEST class strictly below the head (never a
        peer — same-class traffic queues, it does not cannibalize), and
        within that class the slot with the LEAST streamed progress (the
        cheapest resume) — slot index breaks exact ties
        deterministically.  None = nothing strictly lower is decoding.

        The decision rides signals already on the host — class ranks,
        generated-token counts, slot ids — and never reads the device.
        """
        victim = None
        victim_key = None
        for slot, st in active.items():
            rank = self._class_rank.get(st.req.priority)
            if rank is None or rank <= head_rank:
                continue
            key = (-rank, len(st.generated), slot)
            if victim_key is None or key < victim_key:
                victim, victim_key = slot, key
        return victim

    def _tier_pump(self, engine, hbm_ledger) -> int:
        """One spill/prefetch pump pass per scheduler iteration.

        Retires landed host->device restores (freeing their pinned host
        slots), then — when the HBM forecast or the free-page count says
        pressure is near — demotes the coldest reclaimable prefix pages
        to the host tier ahead of demand, so allocation under load finds
        free pages instead of triggering the designed D2H copy
        synchronously inside ``alloc``'s evict hook.  Returns how many
        pages were spilled this pass (capped: the pump must stay a
        bounded slice of the iteration, not a stop-the-world sweep).

        The spill itself is the one designed sync, inside
        ``HostPageTier.spill_in``; this method reads only host-side
        counters and the ledger forecast.
        """
        engine.tier_inflight()  # retire landed prefetches
        target = max(1, engine.num_pages // 8)  # free-page cushion
        pressure = engine.allocator.free_pages < target
        if (
            not pressure
            and hbm_ledger is not None
            and hbm_ledger.capacity_bytes is not None
        ):
            forecast = hbm_ledger.forecast(0)
            pressure = (
                forecast["headroom_bytes"]
                < target * engine.page_bytes_each
            )
        if not pressure:
            return 0
        want = min(8, max(1, target - engine.allocator.free_pages))
        return engine.spill_cold_pages(want)

    def run(
        self,
        requests: Iterable[Request],
        *,
        poll: Optional[Callable[[], Optional[List[Request]]]] = None,
        should_drain: Optional[Callable[[], bool]] = None,
        on_token: Optional[Callable[[str, int], None]] = None,
        on_step: Optional[Callable[[int], None]] = None,
        on_complete: Optional[Callable[[CompletedRequest], None]] = None,
    ) -> tuple[List[CompletedRequest], ServeReport]:
        """Serve every request to completion; returns (results, report).

        Results preserve completion order (not submission order) — the
        continuous-batching signature: short requests admitted late can
        finish before long ones admitted early.

        Live-serving hooks (all optional; a fleet worker wires every one):

        - ``poll()`` is called once per loop iteration; it returns newly
          arrived requests (may be empty), or None meaning the source is
          closed — the loop then finishes what it holds and returns.
          With a ``poll`` the loop stays alive while idle.
        - ``should_drain()`` -> True stops admission: queued/mid-prefill
          requests finish ``"preempted"`` (no tokens — a control plane
          resubmits them), active requests decode to completion.
        - ``on_token(uid, token)`` streams each generated token.
        - ``on_step(decode_step)`` fires after each decode step
          (heartbeats, fault hooks).
        - ``on_complete(result)`` fires as each request reaches a
          terminal state (the same objects ``run`` returns).
        """
        engine = self.engine
        slots = engine.batch_slots
        chunked = getattr(engine, "chunked_prefill", False)
        # one trace clock for the whole request lifecycle: queue ->
        # prefill chunks -> decode steps -> completion (obs/trace.py;
        # no-op spans when tracing is disabled, which is the default)
        trace = get_tracer()
        # duck-typed engines (test fakes) may not implement the release
        # verb; dense engines no-op it anyway
        release = getattr(engine, "release", lambda _slot: None)
        # deterministic chaos (decode_nan / decode_stall / reject_admit);
        # falsy when DDLT_FAULTS is empty, so the hot loop pays one
        # truthiness check
        plan = faults_mod.get_plan()
        compiles_before = getattr(engine, "prefill_compiles", 0)
        # admission HBM forecast: resolved once per run (honors test-time
        # set_ledger swaps); duck-typed engines without admit_bytes opt
        # out implicitly
        if self.hbm_ledger == "auto":
            from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger

            hbm_ledger = get_ledger()
        else:
            hbm_ledger = self.hbm_ledger
        admit_bytes = getattr(engine, "admit_bytes", None)
        if admit_bytes is None:
            hbm_ledger = None
        # KV host page tier (serve/kv_tier.py), resolved once: the pump
        # and the preemption spill are no-ops for engines without one
        tier = getattr(engine, "tier", None)
        spill_slot_pages = (
            getattr(engine, "spill_slot_pages", None)
            if tier is not None else None
        )
        tier_preempt_spilled = 0
        t_start = time.perf_counter()

        active: Dict[int, _SlotState] = {}
        free = list(range(slots))
        # in-flight chunked prefills: (task, req, budget, queue_wait_s)
        prefilling: deque = deque()
        tokens_buf = np.zeros(slots, np.int32)
        pos_buf = np.zeros(slots, np.int32)
        # speculative decoding state: per-slot draft caps going in, kept
        # token counts coming out (keep == K+1 means "no rejected tail")
        spec = self.spec_decoder
        dlen_buf = np.zeros(slots, np.int32)
        keep_buf = np.zeros(slots, np.int32)
        # bounded when result_window is set (live mode) — see __init__.
        # Per-step timing/occupancy feed ONLY end-of-run aggregates, so
        # they stream into the obs histogram / running sums (O(1) memory
        # — a long-lived worker would otherwise grow raw sample lists
        # forever; this is also THE percentile implementation every
        # report block already routes through)
        results: deque = deque(maxlen=self.result_window)
        step_hist = Histogram("serve.decode_step_s")
        draft_hist = Histogram("serve.draft_step_s")
        verify_hist = Histogram("serve.verify_step_s")
        # process-registry latency histograms, fed per completion (see
        # finish()); bound once so the completion path pays no registry
        # lock per request
        _reg = get_registry()
        ttft_registry_hist = _reg.histogram("serve.ttft_s")
        tpot_registry_hist = _reg.histogram("serve.tpot_s")
        occ_sum = 0.0
        occ_n = 0               # attempted decode steps (incl. failed)
        n_decode_steps = 0      # exact count
        generated_count = 0     # exact token total (results may be windowed)
        prompt_tokens = 0
        # decode-phase-only accounting (the decode_tokens_per_sec
        # satellite): tokens produced by decode/spec steps over the
        # summed wall of exactly those steps — prefill, admission and
        # compile time excluded by construction
        decode_wall = 0.0
        decode_tokens = 0
        # spec accounting: proposed vs accepted drafts, committed tokens
        # per slot-verify (the amortization factor)
        spec_drafted = 0
        spec_accepted = 0
        spec_committed = 0
        spec_slot_steps = 0
        finish_reasons: Dict[str, int] = {}
        meta: Dict[str, _ReqMeta] = {}
        # per-priority-class accounting: local histograms feed the
        # report's per_class blocks; the lazily-bound registry histograms
        # (`serve.ttft_s.<class>` etc.) ride the periodic metric ship so
        # fleet-merged percentiles can split tails by class.  The
        # UNLABELED aggregates stay authoritative for committed-artifact
        # schema compatibility.
        class_stats: Dict[str, Dict[str, Any]] = {}
        class_registry_hists: Dict[str, Any] = {}

        def class_bucket(priority: str) -> Dict[str, Any]:
            cs = class_stats.get(priority)
            if cs is None:
                cs = class_stats[priority] = {
                    "requests": 0,
                    "preemptions": 0,
                    "ttft": Histogram(f"serve.ttft_s.{priority}"),
                    "tpot": Histogram(f"serve.tpot_s.{priority}"),
                    "qwait": Histogram(f"serve.queue_wait_s.{priority}"),
                    "finish_reasons": {},
                }
                class_registry_hists[priority] = (
                    _reg.histogram(f"serve.ttft_s.{priority}"),
                    _reg.histogram(f"serve.tpot_s.{priority}"),
                    _reg.histogram(f"serve.queue_wait_s.{priority}"),
                )
            return cs

        error_count = 0
        quarantined = 0
        decode_retries = 0
        preempted_events = 0

        def budget_of(req: Request) -> int:
            return (
                req.max_new_tokens
                if req.max_new_tokens is not None
                else self.max_new_tokens
            )

        def finish(result: CompletedRequest, pop_meta: bool = True) -> None:
            nonlocal generated_count
            results.append(result)
            generated_count += len(result.tokens)
            finish_reasons[result.finish_reason] = (
                finish_reasons.get(result.finish_reason, 0) + 1
            )
            # latency histograms feed the PROCESS registry per completion,
            # not in an end-of-run rollup: a fleet worker killed mid-run
            # has already recorded every request it finished, so the
            # periodic metric ship carries those buckets home and the
            # fleet percentiles keep the dead replica's completions.
            # (Failures with no tokens carry a hardcoded ttft_s=0.0 and
            # would drag the histogram toward 0 — same filters the
            # report blocks use.)
            cs = class_bucket(result.priority)
            cs["requests"] += 1
            cs["finish_reasons"][result.finish_reason] = (
                cs["finish_reasons"].get(result.finish_reason, 0) + 1
            )
            reg_ttft, reg_tpot, reg_qwait = class_registry_hists[
                result.priority
            ]
            if result.tokens:
                ttft_registry_hist.record(result.ttft_s)
                cs["ttft"].record(result.ttft_s)
                reg_ttft.record(result.ttft_s)
            if len(result.tokens) >= 2 and result.finish_reason not in (
                "cancelled", "preempted",
            ):
                tpot_v = (result.total_s - result.ttft_s) / (
                    len(result.tokens) - 1
                )
                tpot_registry_hist.record(tpot_v)
                cs["tpot"].record(tpot_v)
                reg_tpot.record(tpot_v)
            # same filter as the report's aggregate queue_wait block: a
            # never-admitted terminal state has no admission to wait for
            if result.finish_reason not in (
                "cancelled", "preempted", "shed", "deadline",
            ):
                cs["qwait"].record(result.queue_wait_s)
                reg_qwait.record(result.queue_wait_s)
            if pop_meta:
                # the uid is terminal: its cross-delivery bookkeeping is
                # dead weight from here on (a long-lived live loop would
                # otherwise leak one _ReqMeta per request forever).
                # pop_meta=False is the duplicate-uid rejection, whose
                # result must NOT tear down the original copy's live entry
                meta.pop(result.uid, None)
                # a cancel that raced this completion is spent — without
                # the discard a long-lived worker leaks one entry per
                # raced cancel AND pays the sweep's wall-clock read every
                # step forever
                self._cancelled.discard(result.uid)
            if on_complete is not None:
                on_complete(result)

        def complete(
            slot: int, st: _SlotState, reason: str,
            error: Optional[str] = None,
        ) -> None:
            nonlocal error_count
            now = time.perf_counter()
            m = meta[st.req.uid]
            finish(
                CompletedRequest(
                    uid=st.req.uid,
                    # a requeued delivery's prompt embeds earlier tokens;
                    # the caller-visible result restores the original
                    # prompt/output split and first-delivery latency
                    prompt_len=m.orig_prompt_len,
                    tokens=m.preserved + list(st.generated),
                    finish_reason=reason,
                    ttft_s=m.ttft_s if m.ttft_s is not None else st.ttft_s,
                    # arrival-based, not run-start-based: in live mode the
                    # loop may be hours old when this request arrived
                    total_s=round(now - m.arrival, 6),
                    error=error,
                    queue_wait_s=(
                        m.queue_wait_s
                        if m.queue_wait_s is not None
                        else st.queue_wait_s
                    ),
                    tenant=st.req.tenant,
                    priority=st.req.priority,
                    preemptions=m.preemptions,
                )
            )
            if reason == "error":
                error_count += 1
            trace.event(
                "serve/request_complete", uid=st.req.uid, reason=reason,
                tokens=len(m.preserved) + len(st.generated), ttft_s=st.ttft_s,
                trace=st.req.trace_id,
            )
            del active[slot]
            release(slot)  # paged: pages back to the pool
            free.append(slot)

        def fail_request(
            req: Request, exc: Optional[BaseException],
            queue_wait: float = 0.0, reason: str = "error",
            error: Optional[str] = None,
            retry_after: Optional[float] = None,
        ) -> None:
            """Per-request fault isolation: record the failure, keep serving.

            The slot (if any) was already released by the caller, so the
            remaining traffic is unaffected.
            """
            nonlocal error_count
            m = meta.get(req.uid)
            finish(
                CompletedRequest(
                    uid=req.uid,
                    prompt_len=(
                        m.orig_prompt_len if m is not None else len(req.prompt)
                    ),
                    # "preempted" promises NO tokens (the control plane
                    # resubmits the whole request; a partial stream here
                    # would be replayed as duplicates) — even when a
                    # decode-exception requeue preserved some before the
                    # drain caught the retry queued
                    tokens=(
                        list(m.preserved)
                        if m is not None and reason != "preempted"
                        else []
                    ),
                    finish_reason=reason,
                    ttft_s=(
                        m.ttft_s if m is not None and m.ttft_s is not None
                        else 0.0
                    ),
                    total_s=round(
                        time.perf_counter()
                        - (m.arrival if m is not None else t_start),
                        6,
                    ),
                    error=(
                        error if error is not None
                        else f"{type(exc).__name__}: {exc}"
                        if exc is not None
                        else None
                    ),
                    queue_wait_s=queue_wait,
                    tenant=req.tenant,
                    priority=req.priority,
                    retry_after_s=retry_after,
                    preemptions=m.preemptions if m is not None else 0,
                )
            )
            if reason == "error":
                error_count += 1
            trace.event(
                "serve/request_failed", uid=req.uid, reason=reason,
                trace=req.trace_id,
            )

        def activate(
            slot: int, req: Request, budget: int, first: int,
            queue_wait: float,
        ) -> None:
            """First token landed for a freshly-prefilled request (dense
            one-shot or final chunk — ONE implementation so the two paths
            cannot drift): build the slot state, record first-delivery
            latency against the request's ARRIVAL clock, stream the
            token, and complete immediately on EOS-out-of-prefill."""
            m = meta[req.uid]
            st = _SlotState(
                req=req,
                budget=budget,
                generated=[first],
                next_pos=len(req.prompt),
                ttft_s=round(time.perf_counter() - m.arrival, 6),
                queue_wait_s=queue_wait,
                deadline_at=m.deadline_at,
            )
            if m.ttft_s is None:
                m.ttft_s = st.ttft_s
                m.queue_wait_s = queue_wait
            if on_token is not None:
                on_token(req.uid, first)
            active[slot] = st
            reason = self._finished(st)
            if reason is not None:  # EOS straight out of prefill
                complete(slot, st, reason)

        n_requests = 0

        def intake(req: Request) -> bool:
            """Admit a request into the queue-side bookkeeping; admission
            validation lives HERE so a malformed prompt finishes "error"
            with a clear message instead of raising out of the loop."""
            nonlocal n_requests, prompt_tokens
            now = time.perf_counter()
            if req.uid in meta:
                # meta holds exactly the in-flight uids (entries are
                # popped on finish): a second copy would overwrite the
                # first's bookkeeping and the survivor would KeyError at
                # admission after the first finishes — reject it instead
                # of corrupting the original
                nonlocal error_count
                error_count += 1
                finish(CompletedRequest(
                    uid=req.uid,
                    prompt_len=len(req.prompt),
                    tokens=[],
                    finish_reason="error",
                    ttft_s=0.0,
                    total_s=0.0,
                    error="duplicate uid while the first copy is still "
                    "in flight — rejected at admission",
                    tenant=req.tenant,
                    priority=req.priority,
                ), pop_meta=False)
                return False
            deadline_s = (
                req.deadline_s
                if req.deadline_s is not None
                else self.request_deadline_s
            )
            n_requests += 1
            prompt_tokens += len(req.prompt)
            meta[req.uid] = _ReqMeta(
                arrival=now,
                orig_prompt_len=len(req.prompt),
                deadline_at=(
                    now + deadline_s if deadline_s is not None else None
                ),
            )
            # explicit None-check: a falsy 0 must not silently inherit the
            # scheduler default.  Rejected per-request ("error"), never
            # raised: in live/fleet mode a raise out of run() would kill
            # the whole worker over one malformed client request.
            if req.max_new_tokens is not None and req.max_new_tokens < 1:
                fail_request(
                    req, None,
                    error=(
                        f"max_new_tokens must be >= 1, got "
                        f"{req.max_new_tokens} — rejected at admission"
                    ),
                )
                return False
            if not req.prompt:
                fail_request(
                    req, None,
                    error="empty prompt rejected at admission",
                )
                return False
            if req.priority not in self._class_rank:
                # the priority queue routes by class rank — an unknown
                # class has no lane; reject with the serving vocabulary
                # instead of KeyError-ing the loop
                fail_request(
                    req, None,
                    error=(
                        f"unknown priority class {req.priority!r} (this "
                        f"scheduler serves {self.priority_classes}) — "
                        "rejected at admission"
                    ),
                )
                return False
            max_seq = getattr(engine, "max_seq", None)
            if max_seq is not None and len(req.prompt) >= max_seq:
                fail_request(
                    req, None,
                    error=(
                        f"prompt length {len(req.prompt)} leaves no room "
                        f"to generate (engine max_seq {max_seq}) — "
                        "rejected at admission"
                    ),
                )
                return False
            if plan and plan.maybe_reject_admit():
                # injected overload shedding: a "shed" result tells the
                # router this request is safe to retry elsewhere.  Rolled
                # ONCE here at intake — rolling in the admission loop
                # would re-draw for the same head-of-line request on
                # every iteration it sits blocked on page backpressure,
                # compounding @p= and burning @N opportunity counts
                fail_request(
                    req, None, reason="shed",
                    error="admission rejected (injected overload)",
                )
                return False
            pending.append(req)
            return True

        def requeue_active(slot: int, st: _SlotState, why: str) -> None:
            """Decode blew up under this slot through no fault of its own:
            give it ONE more life.  The retry request's prompt is the
            original prompt plus everything generated so far, so a greedy
            retry continues bit-identically (decode is pinned bit-exact
            against the full forward)."""
            nonlocal decode_retries
            m = meta[st.req.uid]
            if m.decode_retries >= 1:
                complete(
                    slot, st, "error",
                    error=f"decode failed twice ({why}); retry budget spent",
                )
                return
            m.decode_retries += 1
            decode_retries += 1
            if m.ttft_s is None and st.generated:
                m.ttft_s = st.ttft_s
                m.queue_wait_s = st.queue_wait_s
            m.preserved = m.preserved + list(st.generated)
            retry = Request(
                uid=st.req.uid,
                prompt=list(st.req.prompt) + list(st.generated),
                max_new_tokens=st.budget - len(st.generated),
                trace_id=st.req.trace_id,
                # the retry keeps its SLO identity — dropping these would
                # silently demote a premium request to "standard" exactly
                # when it is being retried after a fault
                tenant=st.req.tenant,
                priority=st.req.priority,
            )
            del active[slot]
            release(slot)
            free.append(slot)
            pending.appendleft(retry)
            trace.event(
                "serve/request_requeued", uid=st.req.uid, reason=why,
                preserved_tokens=len(m.preserved), trace=st.req.trace_id,
            )

        def retry_after_hint() -> float:
            """Backoff hint attached to a "shed" result: the soonest any
            active slot can free (remaining token budget x mean decode-
            step wall so far), clamped to a sane client backoff window.
            Host math over state already in hand — no device sync."""
            if not active:
                return 1.0
            avg = decode_wall / n_decode_steps if n_decode_steps else 0.05
            soonest = min(
                st.budget - len(st.generated) for st in active.values()
            )
            return round(min(30.0, max(0.05, soonest * avg)), 3)

        def preempt_slot(slot: int, st: _SlotState) -> None:
            """Cut the lowest-class active decode for a blocked higher-
            class head.  Within the per-request budget the cut is
            LOSSLESS — exactly the decode-exception requeue's shape: the retry's prompt
            is the original prompt plus every token already streamed, its
            budget is the remainder, so a greedy resume continues
            bit-identically (decode is pinned bit-exact against the full
            forward); the retry rejoins the FRONT of its own class and
            the slot frees through the normal ``release`` path, so shared
            prefix pages keep their refcounts (never scrubbed — scrub is
            for quarantine, not policy).  Budget spent: the victim
            finishes terminal "preempted" with NO tokens — graceful
            starvation; every cut either frees capacity for the head or
            retires the victim, so the loop can never livelock.

            With a host tier attached the victim's PRIVATE full pages
            are spilled host-side before release (instead of dissolving
            into the free list) — the retry's prefix walk restores them
            by DMA, so a preempted best-effort stream resumes without
            re-prefilling its generated history."""
            nonlocal preempted_events, tier_preempt_spilled
            m = meta[st.req.uid]
            if m.preemptions >= self.preempt_budget:
                del active[slot]
                release(slot)
                free.append(slot)
                fail_request(
                    st.req, None, queue_wait=st.queue_wait_s,
                    reason="preempted",
                    error=(
                        f"preemption budget ({self.preempt_budget}) spent "
                        "under sustained higher-class load"
                    ),
                )
                return
            m.preemptions += 1
            preempted_events += 1
            class_bucket(st.req.priority)["preemptions"] += 1
            if m.ttft_s is None and st.generated:
                m.ttft_s = st.ttft_s
                m.queue_wait_s = st.queue_wait_s
            m.preserved = m.preserved + list(st.generated)
            resume_tokens = list(st.req.prompt) + list(st.generated)
            retry = Request(
                uid=st.req.uid,
                prompt=resume_tokens,
                max_new_tokens=st.budget - len(st.generated),
                trace_id=st.req.trace_id,
                tenant=st.req.tenant,
                priority=st.req.priority,
            )
            del active[slot]
            # spill the victim's private full pages BEFORE release: the
            # copies need the pages still mapped; after release their
            # ids are free and the next alloc may overwrite them
            if spill_slot_pages is not None:
                tier_preempt_spilled += spill_slot_pages(
                    slot, resume_tokens
                )
            release(slot)
            free.append(slot)
            pending.appendleft(retry)
            trace.event(
                "serve/request_preempted", uid=st.req.uid,
                preserved_tokens=len(m.preserved),
                preemptions=m.preemptions, trace=st.req.trace_id,
            )

        shed_wait = {"uid": None, "passes": 0}

        def maybe_shed(req: Request) -> bool:
            """Admission-time load shedding: ONLY the lowest class (a
            premium/standard head can never shed — it blocks, preempts,
            or times out), ONLY under memory pressure (plain slot
            queueing is ordinary priority queueing, not overload), and
            ONLY when the policy opted in.  The "shed" result carries a
            ``retry_after_s`` backoff hint.

            Two additional guards keep the valve from over-relieving:

            - a requeued PREEMPTED stream is never shed — preemption is
              lossless by contract, so resumed work either completes or
              retires terminal "preempted" when its budget is spent; it
              does not get thrown away at the admission gate;
            - while work is in flight, the head must stay blocked for
              ``shed_patience`` consecutive iterations first — pressure
              a completion can relieve within a few decode steps is not
              overload.  With NOTHING in flight the pressure cannot
              self-resolve, so the head sheds immediately.
            """
            if self.shed_policy != "shed":
                return False
            if self._class_rank[req.priority] != len(
                self.priority_classes
            ) - 1:
                return False
            m = meta[req.uid]
            if m.preemptions or m.preserved:
                return False
            if active or prefilling:
                if shed_wait["uid"] != req.uid:
                    shed_wait["uid"] = req.uid
                    shed_wait["passes"] = 0
                shed_wait["passes"] += 1
                if shed_wait["passes"] <= self.shed_patience:
                    return False
            shed_wait["uid"] = None
            shed_wait["passes"] = 0
            pending.popleft()
            fail_request(
                req, None, reason="shed",
                error="admission shed under memory pressure (lowest "
                "priority class goes first)",
                retry_after=retry_after_hint(),
            )
            return True

        pending = _PriorityQueue(self._class_rank)
        for req in requests:
            intake(req)

        watchdog = None
        if self.watchdog_deadline_s is not None:
            from distributeddeeplearning_tpu_torch.train.resilience import (
                StepWatchdog,
            )

            watchdog = StepWatchdog(
                self.watchdog_deadline_s,
                on_timeout=self.watchdog_on_timeout,
            ).start()

        # The decode loop below has one designed sync a step: the token
        # readback inside engine.decode.
        capped = False
        draining = False
        # live mode: with a poll source the loop stays alive while idle
        # until the source closes (poll() -> None) or a drain begins
        more = poll is not None
        # deadline/cancel sweeps cost one wall-clock read per loop only
        # when something can actually expire
        try:
            while pending or active or prefilling or more:
                # loop liveness for the watchdog: a tick here means the host
                # loop is advancing — a hung decode dispatch stops ticking.
                # NOT armed until the first decode step has completed: the
                # first iteration contains the kernels' first launches,
                # which have nothing to do with the steady-state deadline
                # (same contract as the trainer, whose watchdog arms after
                # each epoch's first step)
                if watchdog is not None and n_decode_steps > 0:
                    watchdog.tick(n_decode_steps)
                if more and not draining:
                    fresh = poll()
                    if fresh is None:
                        more = False  # source closed: finish what we hold
                    else:
                        for req in fresh:
                            intake(req)
                if (
                    not draining
                    and should_drain is not None
                    and should_drain()
                ):
                    # graceful drain (SIGTERM): stop admitting, return queued
                    # work as "preempted" for the control plane's resubmit
                    # path, finish the requests already decoding
                    draining = True
                    # final inbox sweep BEFORE closing the source: a
                    # request delivered between our last poll and the
                    # drain signal must be reported "preempted" (its
                    # sender is owed a terminal state), not stranded
                    # unread in the inbox — a fleet router would
                    # misclassify the stranded uid as a replica death
                    if more:
                        fresh = poll()
                        for req in fresh or []:
                            intake(req)
                    more = False
                    trace.event(
                        "serve/drain_begin", cat="serve",
                        pending=len(pending), active=len(active),
                        prefilling=len(prefilling),
                    )
                    while prefilling:
                        task, req, budget, queue_wait = prefilling.popleft()
                        release(task.slot)
                        free.append(task.slot)
                        fail_request(req, None, queue_wait, reason="preempted")
                if draining and pending:
                    # NOT one-shot: a decode exception mid-drain requeues
                    # its surviving slots here, and with admission gated
                    # off nothing else would ever consume them (the loop
                    # would spin forever on `pending` never emptying)
                    while pending:
                        fail_request(pending.popleft(), None, reason="preempted")

                # live weight reload: applied ONLY at the idle barrier —
                # nothing decoding, nothing prefilling — so the swap is
                # between steps by construction and every request sees one
                # weight set end to end.  While pending, the admission
                # block below is gated off (active work drains, queued
                # work holds for the new weights).
                if (
                    self._pending_reload is not None
                    and not active
                    and not prefilling
                ):
                    apply_reload = self._pending_reload
                    self._pending_reload = None
                    try:
                        with trace.span("serve/reload_barrier"):
                            apply_reload()
                    except Exception as exc:  # noqa: BLE001 — old weights keep serving
                        trace.event(
                            "serve/reload_failed", cat="serve",
                            error=f"{type(exc).__name__}: {exc}",
                        )

                # deadline / cancellation sweep over in-flight work (queued
                # requests are checked at their admission attempt below)
                if self._cancelled or any(
                    st.deadline_at is not None for st in active.values()
                ):
                    now = time.perf_counter()
                    for slot, st in list(active.items()):
                        if st.req.uid in self._cancelled:
                            self._cancelled.discard(st.req.uid)
                            complete(slot, st, "cancelled")
                        elif (
                            st.deadline_at is not None and now > st.deadline_at
                        ):
                            # partial tokens kept; the slot frees through the
                            # normal release path (shared prefix pages keep
                            # their refcounts — freeing mid-decode is the same
                            # release a finished request takes)
                            complete(slot, st, "deadline")

                # Admit prompts into free slots — mid-flight: slots released in
                # the previous iteration take new work while the rest decode on.
                # Paged engines additionally gate on free PAGES: a request that
                # could strand mid-decode is left queued (backpressure) until
                # completions free its reservation.
                # priority preemption on SLOT pressure: a higher-class
                # head stuck behind zero free slots cuts the lowest-class
                # active decode (losslessly, budget permitting) instead
                # of waiting out the victim's full token budget.  One cut
                # per iteration — pressure relief is gradual by design.
                # Page/HBM pressure is handled inside the admission loop
                # below, where the blocked resource is known.
                if (
                    pending and not free and not draining
                    and self._pending_reload is None
                ):
                    head_rank = self._class_rank.get(pending[0].priority)
                    if head_rank is not None:
                        victim = self._preemption_victim(active, head_rank)
                        if victim is not None:
                            preempt_slot(victim, active[victim])

                # spill/prefetch pump: one pass per iteration retires
                # landed prefetches and keeps a free-page cushion by
                # demoting the coldest reclaimable prefix pages — the
                # designed D2H copy runs HERE, off the admission path,
                # instead of synchronously inside alloc's evict hook
                if tier is not None:
                    self._tier_pump(engine, hbm_ledger)

                hbm_committed = None  # ledger walk amortized per iteration
                while (
                    pending and not draining and free
                    # reload pending: hold admission so the active set
                    # drains to the idle barrier (queued requests are
                    # served by the NEW weights after the swap)
                    and self._pending_reload is None
                ):
                    req = pending[0]
                    budget = budget_of(req)
                    m = meta[req.uid]
                    if req.uid in self._cancelled:
                        pending.popleft()
                        self._cancelled.discard(req.uid)
                        fail_request(req, None, reason="cancelled")
                        continue
                    if (
                        m.deadline_at is not None
                        and time.perf_counter() > m.deadline_at
                    ):
                        # expired while queued: never admitted, no tokens
                        pending.popleft()
                        fail_request(req, None, reason="deadline")
                        continue
                    if chunked:
                        if not engine.fits(len(req.prompt), budget):
                            # exceeds the POOL — waiting can never admit it
                            pending.popleft()
                            fail_request(req, RuntimeError(
                                f"request needs "
                                f"{engine.required_pages(len(req.prompt), budget)}"
                                f" pages, pool holds {engine.num_pages}"
                            ))
                            continue
                        if not engine.can_admit(len(req.prompt), budget):
                            # PAGE pressure: with restores in flight the
                            # page accounting is mid-transition — fence
                            # them (admit gates until the prefetch
                            # LANDS) before cutting a victim against a
                            # transient reading
                            if tier is not None and engine.tier_inflight():
                                engine.drain_tier()
                                continue
                            # cut a strictly-lower-class
                            # decode (its pages release) and re-check;
                            # no victim -> shed the head if it is
                            # lowest-class and the policy allows
                            victim = self._preemption_victim(
                                active, self._class_rank[req.priority]
                            )
                            if victim is not None:
                                preempt_slot(victim, active[victim])
                                continue
                            # ONE shed per iteration, then yield to the
                            # decode step: shedding relieves pressure for
                            # the head, it must not cascade through the
                            # whole queue against one instantaneous
                            # reading while in-flight completions are a
                            # few steps from freeing the pages
                            if maybe_shed(req):
                                break
                            if active or prefilling:
                                break  # completions will free pages
                            # nothing in flight can free pages: fail loudly
                            # instead of spinning forever
                            pending.popleft()
                            fail_request(req, RuntimeError(
                                "page pool exhausted with no requests in "
                                "flight (pages leaked?)"
                            ))
                            continue
                    if hbm_ledger is not None:
                        # predicted-headroom backpressure (obs/ledger.py):
                        # free pages are necessary but not sufficient —
                        # the ledger forecasts COMMITTED HBM across every
                        # owner (params, other engines, quant scales),
                        # so admission waits while in-flight work holds
                        # the headroom instead of discovering the OOM
                        # mid-decode
                        extra = admit_bytes(len(req.prompt), budget)
                        if extra:
                            # the committed walk (a pytree traversal of
                            # every registered provider) runs at most
                            # once per scheduler iteration; admissions
                            # within the iteration add their worst-case
                            # reservation on top, so a burst can never
                            # over-admit against one stale reading
                            if (
                                hbm_committed is None
                                and hbm_ledger.capacity_bytes is not None
                            ):
                                hbm_committed = hbm_ledger.committed_bytes()
                            if not hbm_ledger.admit_ok(
                                extra, committed=hbm_committed
                            ):
                                # HBM-forecast pressure: same ladder as
                                # page pressure — fence in-flight
                                # prefetches first (landing frees host
                                # slots and settles the forecast), then
                                # preempt strictly lower, then shed a
                                # lowest-class head, then block on
                                # in-flight completions
                                if (
                                    tier is not None
                                    and engine.tier_inflight()
                                ):
                                    engine.drain_tier()
                                    hbm_committed = None
                                    continue
                                victim = self._preemption_victim(
                                    active, self._class_rank[req.priority]
                                )
                                if victim is not None:
                                    preempt_slot(victim, active[victim])
                                    # the cut released committed bytes;
                                    # the stale walk must not block the
                                    # re-check
                                    hbm_committed = None
                                    continue
                                # one shed per iteration (same pacing
                                # rule as the page ladder above)
                                if maybe_shed(req):
                                    break
                                if active or prefilling:
                                    # completions release committed bytes
                                    break
                                pending.popleft()
                                fail_request(req, RuntimeError(
                                    f"predicted HBM headroom exhausted: the "
                                    f"request would commit {extra} more bytes "
                                    "past the ledger capacity with nothing in "
                                    "flight to release any"
                                ))
                                continue
                            if hbm_committed is not None:
                                hbm_committed += extra
                    pending.popleft()
                    slot = free.pop()
                    # arrival-based: in live mode the loop may be hours
                    # old when this request arrived
                    queue_wait = round(time.perf_counter() - m.arrival, 6)
                    if chunked:
                        try:
                            with trace.span(
                                "serve/admit", uid=req.uid,
                                prompt_len=len(req.prompt),
                                trace=req.trace_id,
                            ):
                                task = engine.prefill_begin(
                                    slot, req.prompt, budget
                                )
                        except Exception as exc:  # noqa: BLE001 — per-request
                            release(slot)
                            fail_request(req, exc, queue_wait)
                            free.append(slot)
                            continue
                        prefilling.append((task, req, budget, queue_wait))
                        continue
                    try:
                        with trace.span(
                            "serve/prefill", uid=req.uid,
                            prompt_len=len(req.prompt),
                            trace=req.trace_id,
                        ):
                            first = engine.prefill(slot, req.prompt)
                    except Exception as exc:  # noqa: BLE001 — isolate per request
                        fail_request(req, exc, queue_wait)
                        free.append(slot)
                        continue
                    activate(slot, req, budget, first, queue_wait)

                # Advance ONE chunk of the oldest in-flight prefill, then fall
                # through to decode — the chunked-prefill interleave: running
                # requests stall at most one chunk's compute per step, not a
                # whole O(P²) prompt pass.
                if prefilling:
                    task, req, budget, queue_wait = prefilling[0]
                    m = meta[req.uid]
                    expired = (
                        m.deadline_at is not None
                        and time.perf_counter() > m.deadline_at
                    )
                    if expired or req.uid in self._cancelled:
                        # abandon mid-prefill: nothing streamed yet, pages
                        # released through the normal decref path
                        self._cancelled.discard(req.uid)
                        prefilling.popleft()
                        release(task.slot)
                        free.append(task.slot)
                        fail_request(
                            req, None, queue_wait,
                            reason="deadline" if expired else "cancelled",
                        )
                    else:
                        try:
                            with trace.span(
                                "serve/prefill_chunk", uid=req.uid,
                                offset=task.offset, trace=req.trace_id,
                            ):
                                first = engine.prefill_step(task)
                        except Exception as exc:  # noqa: BLE001 — per-request
                            prefilling.popleft()
                            release(task.slot)
                            fail_request(req, exc, queue_wait)
                            free.append(task.slot)
                        else:
                            if first is not None:  # final chunk landed
                                prefilling.popleft()
                                activate(
                                    task.slot, req, budget, first,
                                    queue_wait,
                                )

                if not active:
                    if more and not pending and not prefilling:
                        # idle live loop: nothing in flight, the source still
                        # open — back off so the poll doesn't busy-spin
                        time.sleep(0.001)
                    continue

                if spec is not None:
                    dlen_buf[:] = 0  # stale lanes must not draft
                for slot, st in active.items():
                    tokens_buf[slot] = st.generated[-1]
                    pos_buf[slot] = st.next_pos
                    if spec is not None:
                        # per-slot draft cap: emitted tokens (accepted +
                        # bonus) never exceed the remaining budget, so
                        # the verify write horizon stays inside the
                        # worst-case page reservation made at admission,
                        # and never walks off the position table.  0 =
                        # this slot runs a plain decode step through the
                        # verify program.
                        dlen_buf[slot] = max(0, min(
                            spec.draft_tokens,
                            st.budget - len(st.generated) - 1,
                            engine.max_seq - 1 - st.next_pos,
                        ))
                occ_sum += len(active) / slots
                occ_n += 1
                decode_step = n_decode_steps + 1  # 1-based, the fault clock
                if plan:
                    stall = plan.take_decode_stall(decode_step)
                    if stall is not None:
                        time.sleep(stall)  # injected hung-dispatch (watchdog)
                    if plan.has_decode_nan(decode_step):
                        # victim needs >= 1 decode-written position so the NaN
                        # lands in a private (never prefix-shared) cache
                        # region — no eligible slot leaves the fault armed
                        victim = min(
                            (
                                s for s, st in active.items()
                                if st.next_pos > len(st.req.prompt)
                            ),
                            default=None,
                        )
                        if victim is not None and plan.take_decode_nan(
                            decode_step
                        ):
                            poison = getattr(engine, "poison_slot", None)
                            if poison is None:
                                raise ValueError(
                                    "decode_nan fault fired but the engine "
                                    "has no poison_slot hook — the fault "
                                    "would be a silent no-op"
                                )
                            poison(victim, active[victim].next_pos - 1)
                t0 = time.perf_counter()
                res = None
                try:
                    if spec is not None:
                        # draft K + verify K+1 in one batched call; one
                        # readback carries tokens/acceptance/finiteness
                        with trace.span(
                            "serve/spec_step", active=len(active)
                        ):
                            res = spec.step(tokens_buf, pos_buf, dlen_buf)
                        out = None
                    else:
                        with trace.span(
                            "serve/decode_step", active=len(active)
                        ):
                            out = engine.decode(tokens_buf, pos_buf)
                except Exception as exc:  # noqa: BLE001
                    # The decode step failed batch-wide through no fault of
                    # any single request (a hung collective, a dispatch bug):
                    # requeue every active slot ONCE — prompt extended by the
                    # tokens already generated, so a greedy retry continues
                    # bit-identically — instead of failing them all.  A slot
                    # whose retry budget is spent completes "error".
                    for slot, st in list(active.items()):
                        requeue_active(
                            slot, st,
                            f"decode failed: {type(exc).__name__}: {exc}",
                        )
                    continue
                step_wall = time.perf_counter() - t0  # host math only
                step_hist.record(step_wall)
                decode_wall += step_wall
                n_decode_steps += 1
                if res is not None:
                    draft_hist.record(res.draft_s)
                    verify_hist.record(res.verify_s)
                    # full acceptance leaves no rejected tail to scrub
                    keep_buf[:] = spec.draft_tokens + 1
                    rollback_needed = False

                # NaN quarantine: engines report per-slot logit finiteness
                # from the SAME step's readback (no extra sync).  A poisoned slot
                # is scrubbed and fails alone — the batch decodes on.
                finite = (
                    res.finite if res is not None
                    else getattr(engine, "last_finite", None)
                )
                # spec mode defers completions until AFTER the batched
                # rollback: complete() releases the slot (paged: block
                # table row back to SCRATCH), and a rollback dispatched
                # after that would zero the dustbin instead of the freed
                # pages' rejected-draft tail
                finished: List = []
                for slot, st in list(active.items()):
                    if finite is not None and not finite[slot]:
                        quarantined += 1
                        scrub = getattr(engine, "scrub_slot", None)
                        if scrub is not None:
                            # zero the slot's decode-written region so the
                            # NaN cannot leak to the next occupant via the
                            # 0-weight * NaN-value softmax path (in spec
                            # mode this also covers the step's whole
                            # draft/verify write horizon, so the batched
                            # rollback can skip the slot)
                            scrub(slot, len(st.req.prompt))
                        trace.event(
                            "serve/request_quarantined", uid=st.req.uid,
                            step=decode_step, trace=st.req.trace_id,
                        )
                        # black-box trigger: freeze the flight-recorder
                        # ring (the last-N spans/events/metric deltas
                        # BEFORE the poison surfaced) — the fleet worker
                        # ships these dumps home with its report
                        get_recorder().dump(
                            "decode_quarantine", registry=get_registry(),
                            uid=st.req.uid, step=decode_step,
                        )
                        finished.append((
                            slot, st, "error",
                            "non-finite logits (quarantined at decode "
                            f"step {decode_step})",
                        ))
                        continue
                    if res is None:
                        toks = [int(out[slot])]
                    else:
                        # accepted drafts + the verifier's bonus token,
                        # cut at EOS (the tail past an accepted EOS was
                        # speculation over a finished sequence)
                        emitted = int(res.accepted[slot]) + 1
                        toks = [int(t) for t in res.tokens[slot, :emitted]]
                        if self.eos_id is not None and self.eos_id in toks:
                            toks = toks[: toks.index(self.eos_id) + 1]
                        spec_drafted += int(dlen_buf[slot])
                        spec_accepted += int(res.accepted[slot])
                        spec_committed += len(toks)
                        spec_slot_steps += 1
                        keep_buf[slot] = len(toks)
                        if len(toks) <= spec.draft_tokens:
                            rollback_needed = True
                    decode_tokens += len(toks)
                    for tok in toks:
                        st.generated.append(tok)
                        if on_token is not None:
                            on_token(st.req.uid, tok)
                    st.next_pos += len(toks)
                    reason = self._finished(st)
                    if reason is not None:
                        finished.append((slot, st, reason, None))
                if res is not None and rollback_needed:
                    # ONE batched dispatch zeroes every slot's rejected
                    # tail (positions >= pos + keep) — the batched form of
                    # scrub_slot(slot, from_pos); MUST run before the completions
                    # below release their slots
                    spec.rollback(pos_buf, keep_buf)
                for slot, st, reason, err in finished:
                    complete(slot, st, reason, error=err)

                if on_step is not None:
                    on_step(decode_step)

                if self.step_cap is not None and n_decode_steps >= self.step_cap:
                    capped = True
                    break

            if capped:
                # deadline semantics for smoke runs: everything still running
                # or queued is accounted for, nothing hangs
                for slot, st in list(active.items()):
                    complete(slot, st, "step_cap")
                while prefilling:
                    task, req, budget, queue_wait = prefilling.popleft()
                    release(task.slot)
                    free.append(task.slot)
                    fail_request(req, None, queue_wait, reason="cancelled")
                while pending:
                    fail_request(pending.popleft(), None, reason="cancelled")
        finally:
            # the watchdog must die with the loop: a lingering armed
            # watchdog would hard-exit the process long after run()
            # returned (or raised)
            if watchdog is not None:
                watchdog.stop()

        wall = time.perf_counter() - t_start
        generated = generated_count
        # steady-state streaming latency per request: the inter-token gap
        # after the first token landed (only measurable past 2 tokens)
        tpot = [
            (r.total_s - r.ttft_s) / (len(r.tokens) - 1)
            for r in results
            if len(r.tokens) >= 2
            and r.finish_reason not in ("cancelled", "preempted")
        ]
        report = ServeReport(
            requests=n_requests,
            batch_slots=slots,
            generated_tokens=generated,
            prompt_tokens=prompt_tokens,
            decode_steps=n_decode_steps,
            wall_s=round(wall, 4),
            tokens_per_sec=round(generated / wall, 2) if wall > 0 else 0.0,
            ttft_s=_percentiles([r.ttft_s for r in results]),
            decode_step_s=step_hist.summary(),
            slot_occupancy_mean=(
                round(occ_sum / occ_n, 4) if occ_n else 0.0
            ),
            finish_reasons=finish_reasons,
            errors=error_count,
            queue_wait_s=_percentiles(
                [r.queue_wait_s for r in results if r.finish_reason
                 not in ("cancelled", "preempted", "shed", "deadline")]
            ),
            tpot_s=_percentiles(tpot),
            prefill_compiles=(
                getattr(engine, "prefill_compiles", 0) - compiles_before
            ),
            kv_layout=getattr(engine, "kv_layout", "dense"),
            kv_dtype=getattr(engine, "kv_dtype", "float32"),
            weights_dtype=getattr(engine, "weights_dtype", "float32"),
            tp=getattr(engine, "tp", 1),
            layout_rules=getattr(engine, "layout_rules", ""),
            decode_kernel=getattr(engine, "decode_kernel", "gather"),
            prefix_hit_rate=(
                round(engine.prefix_hit_rate(), 4)
                if hasattr(engine, "prefix_hit_rate")
                else 0.0
            ),
            kv_bytes=(
                engine.kv_bytes() if hasattr(engine, "kv_bytes") else 0
            ),
            kv_bytes_peak=(
                engine.kv_bytes_peak()
                if hasattr(engine, "kv_bytes_peak")
                else 0
            ),
            decode_retries=decode_retries,
            quarantined=quarantined,
            drained=draining,
            decode_tokens_per_sec=(
                round(decode_tokens / decode_wall, 2)
                if decode_wall > 0 else 0.0
            ),
            speculative=spec is not None,
            drafter=spec.drafter_name if spec is not None else None,
            draft_tokens=spec.draft_tokens if spec is not None else 0,
            acceptance_rate=(
                round(spec_accepted / spec_drafted, 4)
                if spec_drafted else None
            ),
            tokens_per_verify=(
                round(spec_committed / spec_slot_steps, 4)
                if spec_slot_steps else None
            ),
            draft_step_s=draft_hist.summary(),
            verify_step_s=verify_hist.summary(),
            per_class={
                cls: {
                    "requests": cs["requests"],
                    "ttft_s": cs["ttft"].summary(),
                    "tpot_s": cs["tpot"].summary(),
                    "queue_wait_s": cs["qwait"].summary(),
                    "finish_reasons": dict(cs["finish_reasons"]),
                    "shed": cs["finish_reasons"].get("shed", 0),
                    "preempted": cs["finish_reasons"].get("preempted", 0),
                    "preemptions": cs["preemptions"],
                }
                for cls, cs in sorted(class_stats.items())
            },
            preemptions=preempted_events,
            tier_enabled=tier is not None,
            tier_host_pages=tier.host_pages if tier is not None else 0,
            tier_spilled_pages=(
                tier.spilled_pages if tier is not None else 0
            ),
            tier_restored_pages=(
                tier.restored_pages if tier is not None else 0
            ),
            tier_dropped_pages=(
                tier.dropped_pages if tier is not None else 0
            ),
            tier_host_pages_peak=(
                tier.host_pages_peak if tier is not None else 0
            ),
            tier_host_bytes_peak=(
                tier.host_pages_peak * tier.page_host_bytes
                if tier is not None else 0
            ),
            tier_prefix_hit_tokens_host=(
                getattr(engine, "prefix_hit_tokens_host", 0)
                if tier is not None else 0
            ),
            tier_preempt_spilled_pages=tier_preempt_spilled,
        )
        # end-of-run rollup into the process metrics registry (one
        # record_many per stream, NOT per step — the hot loop stays hot):
        # cross-run aggregates land in the registry's snapshots
        reg = get_registry()
        reg.counter("serve.requests").inc(n_requests)
        reg.counter("serve.generated_tokens").inc(generated)
        reg.counter("serve.errors").inc(error_count)
        reg.counter("serve.decode_retries").inc(decode_retries)
        reg.counter("serve.quarantined").inc(quarantined)
        # overload-protection counters: lossless preemption EVENTS (one
        # request may be cut several times) and terminal sheds.  The
        # per-class ttft/tpot/queue-wait histograms were fed per
        # completion in finish() — no rollup, same as the aggregates.
        reg.counter("serve.preemptions").inc(preempted_events)
        reg.counter("serve.shed").inc(finish_reasons.get("shed", 0))
        # ttft/tpot histograms were fed per completion in finish() —
        # recording them again here would double-count every request
        reg.histogram("serve.decode_step_s").merge(step_hist)
        reg.gauge("serve.tokens_per_sec").set(report.tokens_per_sec)
        reg.gauge("serve.decode_tokens_per_sec").set(
            report.decode_tokens_per_sec
        )
        reg.gauge("serve.slot_occupancy_mean").set(
            report.slot_occupancy_mean
        )
        if tier is not None:
            # host-tier health: fleet workers export these per replica,
            # so FleetReport watermarks show which replica is thrashing
            # its host pool (high drop rate = pool too small for the
            # prefix working set)
            reg.counter("serve.tier.spilled_pages").inc(tier.spilled_pages)
            reg.counter("serve.tier.restored_pages").inc(
                tier.restored_pages
            )
            reg.counter("serve.tier.dropped_pages").inc(tier.dropped_pages)
            reg.gauge("serve.tier.host_pages_peak").set(
                tier.host_pages_peak
            )
        if spec is not None:
            # the drafter-health gauge obs dashboards watch: an
            # acceptance-rate collapse is a throughput regression with
            # unchanged step times (every verify commits ~1 token)
            if report.acceptance_rate is not None:
                reg.gauge("serve.acceptance_rate").set(
                    report.acceptance_rate
                )
            if report.tokens_per_verify is not None:
                reg.gauge("serve.tokens_per_verify").set(
                    report.tokens_per_verify
                )
            reg.histogram("serve.draft_step_s").merge(draft_hist)
            reg.histogram("serve.verify_step_s").merge(verify_hist)
        return list(results), report

"""Continuous batching: a request queue feeding KV-cache slots
(``serve/scheduler.py``, the dense single-tenant core).

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

Every request ends in one terminal state (``FINISH_REASONS``); failures are
scoped to the request: a prefill exception, a passed deadline, a cancel, or
non-finite logits (the NaN quarantine: the slot is scrubbed and fails
alone while the batch decodes on).

With a ``spec_decoder`` (:class:`~..spec.SpeculativeDecoder` over the same
engine) each decode step is a speculative step: every slot drafts up to K
tokens and commits 1..K+1 of them after one batched verify.  Per-slot
draft caps keep the verify writes inside the budget, the page reservation
and ``max_seq``; EOS and the budget cut inside the committed run; the
rejected tails are rolled back in one scatter BEFORE completions release
their slots (a released paged slot's table row is scratch, so a later
rollback would miss its pages).

What it records: per-request TTFT (arrival -> first token) and queue wait
(arrival -> admission), TPOT (time per output token after the first), the
per-decode-step wall, mean slot occupancy and generated tokens/s; in spec
mode also the acceptance rate, tokens per verify and the draft/verify
walls.

Not in this slice: priority classes, preemption and shedding, the HBM
ledger, the host page tier, live reload, the watchdog, decode-exception
requeue, fault injection and the obs tracer/registry.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from distributeddeeplearning_tpu_torch.obs.registry import Histogram, summarize

FINISH_REASONS = ("eos", "length", "error", "step_cap", "cancelled", "deadline")


@dataclasses.dataclass
class Request:
    """One generation request: a token-id prompt, an optional token budget
    (default: the scheduler's) and an optional deadline in seconds from
    intake (default: the scheduler's ``request_deadline_s``)."""

    uid: str
    prompt: Sequence[int]
    max_new_tokens: Optional[int] = None
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class CompletedRequest:
    uid: str
    prompt_len: int
    tokens: List[int]
    finish_reason: str  # one of FINISH_REASONS
    ttft_s: float
    total_s: float
    error: Optional[str] = None
    queue_wait_s: float = 0.0


@dataclasses.dataclass
class _SlotState:
    req: Request
    budget: int
    generated: List[int]
    next_pos: int  # position the NEXT decode input token occupies
    ttft_s: float
    queue_wait_s: float
    deadline_at: Optional[float]


@dataclasses.dataclass
class ServeReport:
    """Aggregate serving stats of one ``run``."""

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
    errors: int = 0
    queue_wait_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    tpot_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    prefill_compiles: int = 0
    kv_layout: str = "dense"
    kv_dtype: str = "float32"
    weights_dtype: str = "float32"
    # layout provenance: the tensor-parallel degree the engine served at
    # and the partition-rule table that laid it out (count + digest,
    # ``parallel.sharding.layout_rules_provenance``)
    tp: int = 1
    layout_rules: str = ""
    decode_kernel: str = "flash"
    kv_bytes: int = 0
    kv_bytes_peak: int = 0
    quarantined: int = 0
    # generated tokens over the summed wall of the decode steps alone
    # (prefill and admission excluded)
    decode_tokens_per_sec: float = 0.0
    # prompt tokens served from shared prefix pages (paged engines)
    prefix_hit_rate: float = 0.0
    # speculative decoding: accepted over proposed drafts, and tokens
    # committed per slot per verify (>= 1: what a spec step amortizes)
    speculative: bool = False
    drafter: Optional[str] = None
    draft_tokens: int = 0
    acceptance_rate: Optional[float] = None
    tokens_per_verify: Optional[float] = None
    # host wall of the draft chain / verify + readback, per spec step
    draft_step_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    verify_step_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self):
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
        if shared_prefix_len > 0 else []
    )
    return [
        Request(
            uid=f"req{i}",
            prompt=prefix + rng.integers(
                1, vocab_size, rng.integers(min_prompt, hi + 1)
            ).tolist(),
        )
        for i in range(n)
    ]


class ContinuousBatchingScheduler:
    """Drive an :class:`~.engine.InferenceEngine` over a set of requests."""

    def __init__(
        self,
        engine,
        *,
        eos_id: Optional[int] = None,
        max_new_tokens: int = 32,
        step_cap: Optional[int] = None,
        request_deadline_s: Optional[float] = None,
        spec_decoder=None,
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
        # hard decode-step budget for smoke runs: active slots complete as
        # "step_cap", unstarted requests as "cancelled"
        self.step_cap = step_cap
        self.request_deadline_s = request_deadline_s
        if spec_decoder is not None and spec_decoder.engine is not engine:
            raise ValueError(
                "spec_decoder was built over a different engine than the "
                "scheduler drives — their caches would diverge silently")
        self.spec_decoder = spec_decoder
        self._cancelled: set = set()

    def request_cancel(self, uid: str) -> None:
        """Mark ``uid``; it finishes ``"cancelled"`` at the next loop
        boundary (queued: unadmitted; active: with its partial tokens)."""
        self._cancelled.add(uid)

    def _finished(self, st: _SlotState) -> Optional[str]:
        if self.eos_id is not None and st.generated[-1] == self.eos_id:
            return "eos"
        if len(st.generated) >= st.budget:
            return "length"
        if st.next_pos >= self.engine.max_seq:
            return "length"  # cache full — no position left to write
        return None

    def run(self, requests: Iterable[Request]):
        """Serve every request to a terminal state; returns
        ``(results in completion order, ServeReport)``."""
        engine = self.engine
        slots = engine.batch_slots
        chunked = getattr(engine, "chunked_prefill", False)
        t_start = time.perf_counter()
        active: Dict[int, _SlotState] = {}
        free = list(range(slots))
        pending: deque = deque()
        # in-flight chunked prefills: (task, req, budget, queue_wait,
        # deadline_at)
        prefilling: deque = deque()
        results: List[CompletedRequest] = []
        tokens_buf = np.zeros(slots, np.int32)
        pos_buf = np.zeros(slots, np.int32)
        # spec mode: per-slot draft caps going in, kept token counts out
        # (keep == K+1: no rejected tail)
        spec = self.spec_decoder
        dlen_buf = np.zeros(slots, np.int32)
        keep_buf = np.zeros(slots, np.int32)
        step_hist = Histogram("serve.decode_step_s")
        draft_hist = Histogram("serve.draft_step_s")
        verify_hist = Histogram("serve.verify_step_s")
        spec_drafted = spec_accepted = spec_committed = spec_slot_steps = 0
        occ_sum = 0.0
        n_steps = 0
        prompt_tokens = 0
        decode_wall = 0.0
        decode_tokens = 0
        quarantined = 0
        n_requests = 0
        arrivals: Dict[str, float] = {}
        compiles_before = engine.prefill_compiles

        def finish(req: Request, tokens: List[int], reason: str, *,
                   ttft: float = 0.0, queue_wait: float = 0.0,
                   error: Optional[str] = None) -> None:
            arrival = arrivals.pop(req.uid, t_start)
            self._cancelled.discard(req.uid)
            results.append(CompletedRequest(
                uid=req.uid, prompt_len=len(req.prompt), tokens=tokens,
                finish_reason=reason, ttft_s=ttft,
                total_s=round(time.perf_counter() - arrival, 6), error=error,
                queue_wait_s=queue_wait,
            ))

        def complete(slot: int, reason: str, error: Optional[str] = None):
            st = active.pop(slot)
            finish(st.req, list(st.generated), reason, ttft=st.ttft_s,
                   queue_wait=st.queue_wait_s, error=error)
            engine.release(slot)
            free.append(slot)

        def activate(slot: int, req: Request, budget: int, first: int,
                     queue_wait: float, deadline_at: Optional[float]) -> None:
            """The first token of a freshly prefilled request landed (one-
            shot or final chunk): the slot starts decoding, or completes
            at once on EOS out of prefill."""
            st = _SlotState(
                req=req, budget=budget, generated=[first],
                next_pos=len(req.prompt),
                ttft_s=round(time.perf_counter() - arrivals[req.uid], 6),
                queue_wait_s=queue_wait, deadline_at=deadline_at,
            )
            active[slot] = st
            reason = self._finished(st)
            if reason is not None:
                complete(slot, reason)

        def intake(req: Request) -> None:
            """Validate at intake: a malformed request finishes "error"
            with a clear message instead of raising out of the loop."""
            nonlocal n_requests, prompt_tokens
            if req.uid in arrivals:
                results.append(CompletedRequest(
                    uid=req.uid, prompt_len=len(req.prompt), tokens=[],
                    finish_reason="error", ttft_s=0.0, total_s=0.0,
                    error="duplicate uid while the first copy is still in "
                    "flight — rejected at admission",
                ))
                return
            arrivals[req.uid] = time.perf_counter()
            n_requests += 1
            prompt_tokens += len(req.prompt)
            if req.max_new_tokens is not None and req.max_new_tokens < 1:
                finish(req, [], "error", error=(
                    f"max_new_tokens must be >= 1, got {req.max_new_tokens} "
                    "— rejected at admission"))
            elif not req.prompt:
                finish(req, [], "error",
                       error="empty prompt rejected at admission")
            elif len(req.prompt) >= engine.max_seq:
                finish(req, [], "error", error=(
                    f"prompt length {len(req.prompt)} leaves no room to "
                    f"generate (engine max_seq {engine.max_seq}) — rejected "
                    "at admission"))
            else:
                pending.append(req)

        for req in requests:
            intake(req)

        def deadline_of(req: Request) -> Optional[float]:
            d = req.deadline_s if req.deadline_s is not None else self.request_deadline_s
            return None if d is None else arrivals[req.uid] + d

        capped = False
        while pending or active or prefilling:
            # cancellation / deadline sweep over the active slots
            if self._cancelled or any(
                st.deadline_at is not None for st in active.values()
            ):
                now = time.perf_counter()
                for slot, st in list(active.items()):
                    if st.req.uid in self._cancelled:
                        complete(slot, "cancelled")
                    elif st.deadline_at is not None and now > st.deadline_at:
                        complete(slot, "deadline")  # partial tokens kept

            # admit queued prompts into free slots between decode steps
            while pending and free:
                req = pending[0]
                deadline_at = deadline_of(req)
                if req.uid in self._cancelled:
                    finish(pending.popleft(), [], "cancelled")
                    continue
                if deadline_at is not None and time.perf_counter() > deadline_at:
                    finish(pending.popleft(), [], "deadline")
                    continue
                budget = (req.max_new_tokens if req.max_new_tokens is not None
                          else self.max_new_tokens)
                if chunked:
                    if not engine.fits(len(req.prompt), budget):
                        # larger than the POOL: waiting can never admit it
                        finish(pending.popleft(), [], "error", error=(
                            f"request needs "
                            f"{engine.required_pages(len(req.prompt), budget)}"
                            f" pages, pool holds {engine.num_pages}"))
                        continue
                    if not engine.can_admit(len(req.prompt), budget):
                        if active or prefilling:
                            break  # completions will free pages
                        # nothing in flight can free pages: fail loudly
                        # instead of spinning forever
                        finish(pending.popleft(), [], "error", error=(
                            "page pool exhausted with no requests in "
                            "flight (pages leaked?)"))
                        continue
                pending.popleft()
                slot = free.pop()
                queue_wait = round(time.perf_counter() - arrivals[req.uid], 6)
                try:
                    if chunked:
                        task = engine.prefill_begin(slot, req.prompt, budget)
                    else:
                        first = engine.prefill(slot, req.prompt)
                except Exception as exc:  # noqa: BLE001 — isolate per request
                    engine.release(slot)
                    free.append(slot)
                    finish(req, [], "error", queue_wait=queue_wait,
                           error=f"{type(exc).__name__}: {exc}")
                    continue
                if chunked:
                    prefilling.append((task, req, budget, queue_wait,
                                       deadline_at))
                else:
                    activate(slot, req, budget, first, queue_wait, deadline_at)

            # advance ONE chunk of the oldest in-flight prefill, then fall
            # through to the decode step: the chunked-prefill interleave
            if prefilling:
                task, req, budget, queue_wait, deadline_at = prefilling[0]
                expired = (deadline_at is not None
                           and time.perf_counter() > deadline_at)
                first = reason = error = None
                if expired or req.uid in self._cancelled:
                    reason = "deadline" if expired else "cancelled"
                else:
                    try:
                        first = engine.prefill_step(task)
                    except Exception as exc:  # noqa: BLE001 — per request
                        reason, error = "error", f"{type(exc).__name__}: {exc}"
                if reason is not None:
                    # abandoned mid-prefill: nothing streamed yet, the
                    # pages go back through the normal release
                    prefilling.popleft()
                    engine.release(task.slot)
                    free.append(task.slot)
                    finish(req, [], reason, queue_wait=queue_wait, error=error)
                elif first is not None:  # the final chunk landed
                    prefilling.popleft()
                    activate(task.slot, req, budget, first, queue_wait,
                             deadline_at)

            if not active:
                continue

            if spec is not None:
                dlen_buf[:] = 0  # stale lanes must not draft
            for slot, st in active.items():
                tokens_buf[slot] = st.generated[-1]
                pos_buf[slot] = st.next_pos
                if spec is not None:
                    # emitted tokens (accepted + bonus) never pass the
                    # budget, so verify writes stay inside the page
                    # reservation and the position table; 0 = a plain
                    # decode step through the verify pass
                    dlen_buf[slot] = max(0, min(
                        spec.draft_tokens,
                        st.budget - len(st.generated) - 1,
                        engine.max_seq - 1 - st.next_pos,
                    ))
            occ_sum += len(active) / slots
            t0 = time.perf_counter()
            if spec is not None:
                # observability slice: the spec-step span, and the
                # acceptance / tokens-per-verify gauges, go here
                res = spec.step(tokens_buf, pos_buf, dlen_buf)
            else:
                out = engine.decode(tokens_buf, pos_buf)
            step_wall = time.perf_counter() - t0
            step_hist.record(step_wall)
            decode_wall += step_wall
            n_steps += 1
            if spec is not None:
                draft_hist.record(res.draft_s)
                verify_hist.record(res.verify_s)
                keep_buf[:] = spec.draft_tokens + 1
                finite = res.finite
            else:
                finite = engine.last_finite
            # completions wait until after the rollback (see the module
            # docstring)
            finished = []
            for slot, st in list(active.items()):
                if finite is not None and not finite[slot]:
                    # NaN quarantine: zero the slot's decode-written region
                    # (in spec mode the whole step's write horizon, so the
                    # rollback skips the slot) so the NaN cannot reach the
                    # next occupant through a 0-weight x NaN-value product,
                    # and fail it alone
                    quarantined += 1
                    engine.scrub_slot(slot, len(st.req.prompt))
                    finished.append((slot, "error", (
                        f"non-finite logits (quarantined at decode step "
                        f"{n_steps})")))
                    continue
                if spec is None:
                    toks = [int(out[slot])]
                else:
                    # accepted drafts + the bonus token, cut at EOS (past
                    # an accepted EOS the drafts continued a finished
                    # sequence)
                    toks = res.tokens[slot, : int(res.accepted[slot]) + 1].tolist()
                    if self.eos_id is not None and self.eos_id in toks:
                        toks = toks[: toks.index(self.eos_id) + 1]
                    spec_drafted += int(dlen_buf[slot])
                    spec_accepted += int(res.accepted[slot])
                    spec_committed += len(toks)
                    spec_slot_steps += 1
                    keep_buf[slot] = len(toks)
                st.generated.extend(toks)
                st.next_pos += len(toks)
                decode_tokens += len(toks)
                reason = self._finished(st)
                if reason is not None:
                    finished.append((slot, reason, None))
            if spec is not None and (keep_buf <= spec.draft_tokens).any():
                spec.rollback(pos_buf, keep_buf)
            for slot, reason, error in finished:
                complete(slot, reason, error)
            if self.step_cap is not None and n_steps >= self.step_cap:
                capped = True
                break

        if capped:
            for slot in list(active):
                complete(slot, "step_cap")
            while prefilling:
                task, req, _, queue_wait, _ = prefilling.popleft()
                engine.release(task.slot)
                free.append(task.slot)
                finish(req, [], "cancelled", queue_wait=queue_wait)
            while pending:
                finish(pending.popleft(), [], "cancelled")

        wall = time.perf_counter() - t_start
        generated = sum(len(r.tokens) for r in results)
        finish_reasons: Dict[str, int] = {}
        for r in results:
            finish_reasons[r.finish_reason] = finish_reasons.get(r.finish_reason, 0) + 1
        tpot = [
            (r.total_s - r.ttft_s) / (len(r.tokens) - 1)
            for r in results
            if len(r.tokens) >= 2 and r.finish_reason != "cancelled"
        ]
        report = ServeReport(
            requests=n_requests,
            batch_slots=slots,
            generated_tokens=generated,
            prompt_tokens=prompt_tokens,
            decode_steps=n_steps,
            wall_s=round(wall, 4),
            tokens_per_sec=round(generated / wall, 2) if wall > 0 else 0.0,
            ttft_s=summarize([r.ttft_s for r in results if r.tokens]),
            decode_step_s=step_hist.summary(),
            slot_occupancy_mean=round(occ_sum / n_steps, 4) if n_steps else 0.0,
            finish_reasons=finish_reasons,
            errors=finish_reasons.get("error", 0),
            queue_wait_s=summarize([
                r.queue_wait_s for r in results
                if r.finish_reason not in ("cancelled", "deadline")
            ]),
            tpot_s=summarize(tpot),
            prefill_compiles=engine.prefill_compiles - compiles_before,
            kv_layout=engine.kv_layout,
            kv_dtype=engine.kv_dtype,
            weights_dtype=engine.weights_dtype,
            tp=engine.tp,
            layout_rules=engine.layout_rules,
            decode_kernel=engine.decode_kernel,
            kv_bytes=engine.kv_bytes(),
            kv_bytes_peak=engine.kv_bytes_peak(),
            quarantined=quarantined,
            decode_tokens_per_sec=(
                round(decode_tokens / decode_wall, 2) if decode_wall > 0 else 0.0
            ),
            prefix_hit_rate=(
                round(engine.prefix_hit_rate(), 4)
                if hasattr(engine, "prefix_hit_rate") else 0.0
            ),
            speculative=spec is not None,
            drafter=spec.drafter_name if spec is not None else None,
            draft_tokens=spec.draft_tokens if spec is not None else 0,
            acceptance_rate=(
                round(spec_accepted / spec_drafted, 4) if spec_drafted else None
            ),
            tokens_per_verify=(
                round(spec_committed / spec_slot_steps, 4)
                if spec_slot_steps else None
            ),
            draft_step_s=draft_hist.summary(),
            verify_step_s=verify_hist.summary(),
        )
        return results, report

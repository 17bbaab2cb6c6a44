"""Serving resilience in the port's scheduler held against the JAX
package's — the cases of ``tests/test_serve_resilience.py`` that need no
fleet, plus the decode-exception requeue: the serve fault hooks,
deadlines, cancellation, the injected admission reject, drain, duplicate
uids, live-mode latency, the watchdog, admission validation and the NaN
quarantine.

Decisions that count loop iterations (quarantine, sheds, requeues, drain)
are held to the reference's on the same requests and fault plan
(``_torch_robust.assert_same_decisions``).  Deadlines, live-mode latency
and the watchdog run on the clock: those are tested for their contract,
not against the reference's timings.  The watchdog takes
``watchdog_on_timeout`` (its default exit is 70).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from _torch_robust import (
    assert_same_decisions,
    by_uid,
    engine_pair,
    make_params,
    run_pair,
)
from distributeddeeplearning_tpu.serve import (
    ContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from distributeddeeplearning_tpu.utils import faults as jax_faults
from distributeddeeplearning_tpu_torch.obs.registry import get_registry
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    Request,
)
from distributeddeeplearning_tpu_torch.utils import faults
from distributeddeeplearning_tpu_torch.utils.retry import retry_call

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CFG = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=32)


@pytest.fixture(scope="module")
def params():
    return make_params(0, cfg=CFG)


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    """Tests install explicit plans; none may leak into the next test."""
    yield
    faults.install_plan("")
    jax_faults.install_plan("")


def _install(text):
    faults.install_plan(text)
    jax_faults.install_plan(text)


def _dense(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 24)
    return engine_pair(params, "dense", **kw)


def _paged(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 24)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return engine_pair(params, "paged", **kw)


# -- fault hooks ----------------------------------------------------------------

def test_reject_admit_fires_at_nth_admission_opportunity():
    plan = faults.FaultPlan(faults.parse_spec("reject_admit@2"))
    assert not plan.maybe_reject_admit()  # opportunity 1
    assert plan.maybe_reject_admit()      # the Nth
    assert not plan.maybe_reject_admit()  # one-shot


def test_serve_hooks_match_reference_plan():
    """The serve hooks fire at the same steps and opportunities as the
    reference plan's: at-or-after matching, the non-consuming NaN peek,
    seeded ``@p=`` rejects."""
    text = "decode_stall@3:secs=0.5,decode_nan@4,reject_admit@p=0.4:seed=3"
    ours = faults.FaultPlan(faults.parse_spec(text))
    ref = jax_faults.FaultPlan(jax_faults.parse_spec(text))
    traces = []
    for plan in (ours, ref):
        trace = [(plan.take_decode_stall(s), plan.has_decode_nan(s))
                 for s in range(1, 7)]
        trace += [plan.take_decode_nan(5), plan.take_decode_nan(6)]
        trace += [plan.maybe_reject_admit() for _ in range(20)]
        traces.append(trace)
    assert traces[0] == traces[1]
    assert traces[0][2] == (0.5, False) and traces[0][3] == (None, True)
    assert any(traces[0][8:]) and not all(traces[0][8:])
    assert ours.report() == [{"kind": e.kind, "step": e.step, "site": e.site}
                             for e in ref.events]


def test_retry_counters_match_injected_io_error_sequence():
    reg = get_registry()
    plan = faults.install_plan("io_error@2")

    def flaky():
        plan.maybe_io_error("test site")
        return "ok"

    label = "serve resilience test"
    attempts = reg.counter("retry.attempts.serve_resilience_test")
    giveups = reg.counter("retry.giveups.serve_resilience_test")
    a0, g0 = attempts.value, giveups.value
    assert retry_call(flaky, retries=2, base_delay=0.0, description=label) == "ok"
    assert retry_call(flaky, retries=2, base_delay=0.0, description=label) == "ok"
    assert attempts.value - a0 == 1
    assert giveups.value - g0 == 0
    plan = faults.install_plan("io_error@p=1.0")

    def doomed():
        plan.maybe_io_error("test site")

    with pytest.raises(IOError):
        retry_call(doomed, retries=3, base_delay=0.0, description=label)
    assert attempts.value - a0 == 1 + 3
    assert giveups.value - g0 == 1


# -- scheduler over a host-only engine ------------------------------------------

class _SlowFake:
    """Host-only engine: one token per decode, each decode sleeps."""

    batch_slots = 2
    max_seq = 64

    def __init__(self, step_s=0.02):
        self.step_s = step_s

    def prefill(self, slot, prompt):
        return 1

    def decode(self, tokens, pos):
        time.sleep(self.step_s)
        return np.full(self.batch_slots, 2, np.int32)


def test_deadline_expires_queued_request_without_admission():
    results, report = ContinuousBatchingScheduler(_SlowFake(), max_new_tokens=4).run([
        Request("ok", [1, 2]),
        Request("late", [3], deadline_s=1e-9),  # expired before admission
        Request("ok2", [4]),
    ])
    out = by_uid(results)
    assert out["late"].finish_reason == "deadline"
    assert out["late"].tokens == []
    assert out["ok"].finish_reason == out["ok2"].finish_reason == "length"
    assert report.finish_reasons["deadline"] == 1


def test_deadline_cuts_active_request_and_keeps_partial_tokens():
    (res,), _ = ContinuousBatchingScheduler(
        _SlowFake(step_s=0.05), max_new_tokens=1000,
    ).run([Request("r", [1, 2], deadline_s=0.2)])
    assert res.finish_reason == "deadline"
    assert 1 <= len(res.tokens) < 1000


def test_scheduler_default_deadline_applies_when_request_has_none():
    results, _ = ContinuousBatchingScheduler(
        _SlowFake(step_s=0.05), max_new_tokens=1000, request_deadline_s=0.2,
    ).run([Request("r", [1])])
    assert results[0].finish_reason == "deadline"


def test_request_cancel_finishes_cancelled_with_partial_tokens():
    """A cancel at decode step 3 cuts at the same token as the
    reference's."""
    out = []
    for sched_cls, req_cls in ((ContinuousBatchingScheduler, Request),
                               (JaxScheduler, JaxRequest)):
        sched = sched_cls(_SlowFake(step_s=0.01), max_new_tokens=1000)

        def on_step(step, sched=sched):
            if step == 3:
                sched.request_cancel("r")

        (res,), _ = sched.run([req_cls("r", [1])], on_step=on_step)
        out.append(res)
    assert out[0].finish_reason == out[1].finish_reason == "cancelled"
    assert 1 <= len(out[0].tokens) < 1000
    assert out[0].tokens == out[1].tokens


def test_reject_admit_fault_sheds_request(params):
    """``reject_admit@1`` sheds the first admission, as the reference's."""
    _install("reject_admit@1")
    ref, got = run_pair(_dense(params), [Request("a", [1, 2]), Request("b", [3])],
                        max_new_tokens=3)
    assert_same_decisions(ref, got)
    results, report = got
    shed = [r for r in results if r.finish_reason == "shed"]
    assert len(shed) == 1 and shed[0].tokens == []
    assert report.finish_reasons["shed"] == 1
    assert sum(r.finish_reason == "length" for r in results) == 1


def test_should_drain_preempts_queue_and_finishes_active():
    """Drain after two steps: the two decoding finish, the two queued
    come back "preempted" with no tokens — as the reference's."""
    out = []
    for sched_cls, req_cls in ((ContinuousBatchingScheduler, Request),
                               (JaxScheduler, JaxRequest)):
        steps = []
        results, report = sched_cls(_SlowFake(step_s=0.01), max_new_tokens=5).run(
            [req_cls(u, [i]) for i, u in enumerate("abcd", 1)],
            should_drain=lambda steps=steps: len(steps) >= 2,
            on_step=steps.append)
        out.append(([(r.uid, r.finish_reason, r.tokens) for r in results],
                    report.finish_reasons, report.drained))
    assert out[0] == out[1]
    results, reasons, drained = out[0]
    assert drained
    assert reasons == {"length": 2, "preempted": 2}
    assert all(toks == [] for uid, _, toks in results if uid in "cd")


def test_duplicate_uid_rejected_without_corrupting_first_copy():
    results, report = ContinuousBatchingScheduler(
        _SlowFake(step_s=0.005), max_new_tokens=3,
    ).run([Request("dup", [1, 2]), Request("dup", [3]), Request("ok", [4])])
    assert len(results) == 3
    assert sorted(r.finish_reason for r in results if r.uid == "dup") == \
        ["error", "length"]
    err = next(r for r in results if r.uid == "dup" and r.finish_reason == "error")
    assert "duplicate uid" in err.error
    assert report.errors == 1


def test_live_mode_latency_measured_from_arrival_not_run_start():
    calls = {"n": 0}

    def poll():
        calls["n"] += 1
        if calls["n"] < 200:
            return []  # ~200 idle passes (>= 0.2 s of back-off sleeps)
        if calls["n"] == 200:
            return [Request("late", [1, 2])]
        return None

    (res,), _ = ContinuousBatchingScheduler(
        _SlowFake(step_s=0.001), max_new_tokens=2).run([], poll=poll)
    assert res.finish_reason == "length"
    assert res.queue_wait_s < 0.15
    assert res.ttft_s < 0.15
    assert res.total_s < 0.15


def test_scheduler_watchdog_fires_on_stalled_decode():
    """An injected ``decode_stall`` longer than the deadline fires the
    watchdog (its exit overridden), and the loop recovers."""
    faults.install_plan("decode_stall@2:secs=1.0")
    fired = threading.Event()
    results, _ = ContinuousBatchingScheduler(
        _SlowFake(step_s=0.005), max_new_tokens=6, watchdog_deadline_s=0.25,
        watchdog_on_timeout=fired.set,
    ).run([Request("r", [1])])
    assert fired.is_set()
    assert results[0].finish_reason == "length"


def test_scheduler_watchdog_quiet_without_stall():
    fired = threading.Event()
    ContinuousBatchingScheduler(
        _SlowFake(step_s=0.005), max_new_tokens=6, watchdog_deadline_s=5.0,
        watchdog_on_timeout=fired.set,
    ).run([Request("r", [1])])
    assert not fired.is_set()


# -- admission validation ----------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_admission_rejects_empty_and_oversized_prompts(params, layout):
    engines = _dense(params) if layout == "dense" else _paged(params)
    ref, got = run_pair(engines, [
        Request("empty", []),
        Request("huge", list(range(1, 30))),  # >= max_seq 24: no room
        Request("ok", [1, 2, 3]),
    ], max_new_tokens=2)
    assert_same_decisions(ref, got)
    results, report = got
    out = by_uid(results)
    assert out["empty"].finish_reason == "error"
    assert "empty prompt" in out["empty"].error
    assert out["huge"].finish_reason == "error"
    assert "no room" in out["huge"].error
    assert out["ok"].finish_reason == "length"
    assert report.errors == 2


# -- the NaN quarantine --------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_nan_quarantine_fails_only_poisoned_request(params, layout):
    """``decode_nan@3`` fails the reference's victim alone; everyone else
    decodes on, bit-identical to the clean run."""
    build = _dense if layout == "dense" else _paged
    reqs = [Request(f"r{i}", p) for i, p in enumerate([[1, 2, 3], [4, 5],
                                                      [6, 7, 8, 9]])]
    clean_ref, clean = run_pair(build(params), reqs, max_new_tokens=6)
    assert_same_decisions(clean_ref, clean)
    _install("decode_nan@3")
    ref, got = run_pair(build(params), reqs, max_new_tokens=6)
    assert_same_decisions(ref, got)
    results, report = got
    assert report.quarantined == 1
    poisoned = [r.uid for r in results if r.finish_reason == "error"]
    assert len(poisoned) == 1
    faulted, clean_by = by_uid(results), by_uid(clean[0])
    assert "non-finite" in faulted[poisoned[0]].error
    pt = faulted[poisoned[0]].tokens
    assert pt == clean_by[poisoned[0]].tokens[: len(pt)]
    for uid, res in faulted.items():
        if uid != poisoned[0]:
            assert res.finish_reason == "length"
            assert res.tokens == clean_by[uid].tokens, uid


def test_quarantined_slot_is_scrubbed_for_next_occupant(params):
    _install("decode_nan@2")
    engines = _paged(params, batch_slots=1)
    ref, got = run_pair(engines, [Request("victim", [1, 2, 3]),
                                  Request("next", [4, 5])], max_new_tokens=5)
    assert_same_decisions(ref, got)
    results, report = got
    out = by_uid(results)
    assert report.quarantined == 1
    assert out["victim"].finish_reason == "error"
    assert out["next"].finish_reason == "length"
    assert len(out["next"].tokens) == 5
    for leaf in engines[1].cache.values():
        assert torch.isfinite(leaf.float()).all()


# -- the decode-exception requeue ---------------------------------------------------

class _RaisingDecode:
    """Wraps an engine; ``decode`` raises a RuntimeError on the calls
    numbered in ``fail_at`` (1-based) and delegates otherwise."""

    def __init__(self, engine, fail_at):
        self._engine = engine
        self._fail_at = set(fail_at)
        self._calls = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def decode(self, tokens, pos):
        self._calls += 1
        if self._calls in self._fail_at:
            raise RuntimeError(f"injected decode failure at call {self._calls}")
        return self._engine.decode(tokens, pos)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_exception_requeues_batch_once(params, layout):
    """A raised decode exception requeues every active slot once; the
    resumed streams equal the clean run's, and the reference requeues the
    same requests."""
    build = _dense if layout == "dense" else _paged
    reqs = [Request(f"r{i}", p) for i, p in enumerate([[1, 2, 3], [4, 5, 6, 7]])]
    clean_ref, clean = run_pair(build(params, max_seq=24), reqs, max_new_tokens=8)
    jeng, teng = build(params, max_seq=24)
    ref, got = run_pair((_RaisingDecode(jeng, {3}), _RaisingDecode(teng, {3})),
                        reqs, max_new_tokens=8)
    assert_same_decisions(ref, got)
    results, report = got
    assert report.decode_retries == 2
    assert report.finish_reasons == {"length": 2}
    for r in results:
        assert r.tokens == by_uid(clean[0])[r.uid].tokens
        # the caller sees the original prompt, not the requeued one
        assert r.prompt_len == len(next(q.prompt for q in reqs if q.uid == r.uid))


def test_decode_exception_twice_fails_with_spent_budget(params):
    """A second decode failure of a requeued request finishes it "error"
    (one retry a request), as the reference's."""
    reqs = [Request("r0", [1, 2, 3])]
    jeng, teng = _dense(params, batch_slots=1)
    ref, got = run_pair((_RaisingDecode(jeng, {2, 4}), _RaisingDecode(teng, {2, 4})),
                        reqs, max_new_tokens=8)
    assert_same_decisions(ref, got)
    (res,), report = got
    assert res.finish_reason == "error"
    assert "retry budget spent" in res.error
    assert report.decode_retries == 1
    assert len(res.tokens) >= 1

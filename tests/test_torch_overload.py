"""Overload survival in the port (``serve/scheduler.py``, ``serve/traffic.py``)
held against the JAX package: priority classes, lossless preemption,
admission-time shedding and the synthetic multi-tenant traffic — the cases
of ``tests/test_overload.py`` that need no fleet.

Every scheduler case runs the JAX scheduler over the JAX engine and the
port's over the port's, on the same requests and the same staged
arrivals, and holds the port to the reference's decisions: completion
order, finish reasons, preemptions, sheds with their retry hints, per-class
counts, decode steps and the token streams, exactly
(``_torch_robust.assert_same_decisions``); then the reference test's own
assertions run on the port's result.  The model is the raw random init,
and one case runs the margin profile (``_torch_robust``).  Traffic schedules are held to the
reference's ``TrafficGenerator`` exactly: arrival times, uids, prompts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_robust import (
    assert_same_decisions,
    by_uid,
    engine_pair,
    make_params,
    prompt,
    run_pair,
)
from distributeddeeplearning_tpu.obs.ledger import HBMLedger as JaxLedger
from distributeddeeplearning_tpu.serve import engine as jax_engine_mod
from distributeddeeplearning_tpu.serve import traffic as jax_traffic
from distributeddeeplearning_tpu.utils import faults as jax_faults
from distributeddeeplearning_tpu_torch.obs.ledger import HBMLedger
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    TenantSpec,
    TrafficGenerator,
    poll_source,
)
from distributeddeeplearning_tpu_torch.serve import engine as engine_mod
from distributeddeeplearning_tpu_torch.utils import faults

torch.set_num_threads(2)  # the suite runs six workers on eight cores


@pytest.fixture(scope="module")
def params():
    return make_params(0)


@pytest.fixture(autouse=True)
def _no_ambient_faults():
    faults.install_plan("")
    jax_faults.install_plan("")
    yield
    faults.install_plan("")
    jax_faults.install_plan("")


# -- priority queue + dequeue order -------------------------------------------

def test_priority_dequeue_order(params):
    """One slot, classes submitted in REVERSE priority order: completions
    come out premium, standard, best_effort, as the reference's do."""
    rng = np.random.default_rng(0)
    reqs = [
        Request(uid="be-0", prompt=prompt(rng), priority="best_effort"),
        Request(uid="be-1", prompt=prompt(rng), priority="best_effort"),
        Request(uid="std-0", prompt=prompt(rng), priority="standard"),
        Request(uid="prem-0", prompt=prompt(rng), priority="premium"),
        Request(uid="prem-1", prompt=prompt(rng), priority="premium"),
    ]
    ref, got = run_pair(engine_pair(params, "dense", batch_slots=1, max_seq=24),
                        reqs, max_new_tokens=3)
    assert_same_decisions(ref, got)
    results, rep = got
    assert [r.uid for r in results] == ["prem-0", "prem-1", "std-0", "be-0", "be-1"]
    assert rep.per_class["premium"]["requests"] == 2
    assert rep.per_class["best_effort"]["requests"] == 2
    assert rep.requests == 5
    assert rep.ttft_s["p99"] >= rep.ttft_s["p50"]


def test_unknown_priority_rejected(params):
    """An unknown class finishes "error" per request, never raises."""
    ref, got = run_pair(
        engine_pair(params, "dense", batch_slots=1, max_seq=24),
        [Request(uid="x", prompt=[1, 2], priority="platinum")], max_new_tokens=2)
    assert_same_decisions(ref, got)
    (res,), _ = got
    assert res.finish_reason == "error"
    assert "unknown priority class" in res.error


# -- lossless preemption --------------------------------------------------------

@pytest.mark.parametrize("layout,weights", [("dense", "raw"), ("paged", "raw"),
                                            ("paged", "margin")])
def test_preempted_resume_bit_identical(params, layout, weights):
    """A best_effort decode is cut by an arriving premium request (one slot),
    requeued and resumed: the same cut as the reference's, and its tokens
    EXACTLY those of an unpressured run."""
    if weights == "margin":
        params = make_params(0, margin=True)
    rng = np.random.default_rng(1)
    be = Request(uid="be", prompt=prompt(rng, 8), priority="best_effort")
    prem = Request(uid="prem", prompt=prompt(rng, 5), priority="premium")
    kw = dict(max_seq=32)
    if layout == "paged":
        kw.update(page_size=4, prefill_chunk=8)
    clean_ref, clean = run_pair(engine_pair(params, layout, batch_slots=2, **kw),
                                [be, prem], max_new_tokens=12)
    assert_same_decisions(clean_ref, clean)
    clean_tokens = {r.uid: list(r.tokens) for r in clean[0]}

    ref, got = run_pair(engine_pair(params, layout, batch_slots=1, **kw),
                        stages=((1, [be]), (5, [prem])), max_new_tokens=12,
                        preempt_budget=2)
    assert_same_decisions(ref, got)
    results, rep = got
    out = by_uid(results)
    assert out["prem"].finish_reason == out["be"].finish_reason == "length"
    assert out["be"].preemptions >= 1, "the cut never happened"
    assert rep.preemptions >= 1
    assert rep.per_class["best_effort"]["preemptions"] >= 1
    assert list(out["be"].tokens) == clean_tokens["be"]
    assert list(out["prem"].tokens) == clean_tokens["prem"]
    order = [r.uid for r in results]
    assert order.index("prem") < order.index("be")


def test_preempt_budget_exhaustion_terminal_never_livelocks(params):
    """preempt_budget=0: the first cut retires the victim terminal
    "preempted" with no tokens; the premium head proceeds."""
    rng = np.random.default_rng(2)
    be = Request(uid="be", prompt=prompt(rng, 8), priority="best_effort")
    prem = Request(uid="prem", prompt=prompt(rng, 5), priority="premium")
    ref, got = run_pair(engine_pair(params, "dense", batch_slots=1, max_seq=32),
                        stages=((1, [be]), (5, [prem])), max_new_tokens=12,
                        preempt_budget=0)
    assert_same_decisions(ref, got)
    results, rep = got
    out = by_uid(results)
    assert out["be"].finish_reason == "preempted"
    assert out["be"].tokens == []
    assert out["prem"].finish_reason == "length"
    assert rep.per_class["best_effort"]["preempted"] == 1


def _scarce(params, **kw):
    """The reference's scarce pool: 3 slots, pages for ~2.5 sequences."""
    return engine_pair(params, "paged", batch_slots=3, max_seq=32, page_size=8,
                       num_pages=11, prefill_chunk=8, **kw)


def test_pages_released_after_preempt_and_shed(params):
    """Shed and preempted finishes free their pages through the normal
    release: the allocator audit is green and no page is in use."""
    rng = np.random.default_rng(3)
    be = [Request(uid=f"be-{i}", prompt=prompt(rng, 12), priority="best_effort")
          for i in range(6)]
    prem = [Request(uid=f"prem-{i}", prompt=prompt(rng, 12), priority="premium")
            for i in range(2)]
    engines = _scarce(params)
    ref, got = run_pair(engines, stages=((1, be), (6, prem)), max_new_tokens=16,
                        shed_policy="shed", preempt_budget=2, shed_patience=0)
    assert_same_decisions(ref, got)
    results, rep = got
    assert len(results) == 8
    assert rep.per_class["best_effort"]["shed"] > 0 or rep.preemptions > 0
    engines[1].allocator.check()
    assert engines[1].allocator.pages_in_use == 0


# -- admission-time shedding ------------------------------------------------------

class _OneAdmitLedger:
    """Fake forecast: admits exactly one request, rejects the rest."""

    capacity_bytes = 1  # non-None: the committed walk engages

    def __init__(self):
        self.admitted = 0

    def committed_bytes(self):
        return 0

    def admit_ok(self, extra, committed=None):
        if self.admitted == 0:
            self.admitted += 1
            return True
        return False


def test_forecast_pressure_sheds_best_effort_not_premium(params):
    """Forecast pressure (the ledger admits one): premium completes, every
    best_effort head is shed with a retry_after_s hint."""
    rng = np.random.default_rng(4)
    reqs = [
        Request(uid="be-0", prompt=prompt(rng), priority="best_effort"),
        Request(uid="be-1", prompt=prompt(rng), priority="best_effort"),
        Request(uid="prem", prompt=prompt(rng), priority="premium"),
    ]
    ref, got = run_pair(
        engine_pair(params, "paged", batch_slots=2, max_seq=32, page_size=8,
                    prefill_chunk=8),
        reqs, max_new_tokens=4, shed_policy="shed", shed_patience=0,
        hbm_ledger=_OneAdmitLedger(), jax_sched_kw={"hbm_ledger": _OneAdmitLedger()})
    assert_same_decisions(ref, got)
    results, rep = got
    out = by_uid(results)
    assert out["prem"].finish_reason == "length"
    for uid in ("be-0", "be-1"):
        assert out[uid].finish_reason == "shed"
        assert out[uid].tokens == []
        assert out[uid].retry_after_s is not None and out[uid].retry_after_s > 0
    assert rep.per_class["best_effort"]["shed"] == 2
    assert rep.per_class["premium"]["shed"] == 0
    assert rep.finish_reasons == {"length": 1, "shed": 2}


def test_forecast_with_explicit_ledger_capacity_matches_reference(params):
    """A REAL ledger of each package with the same explicit capacity: the
    engines' committed bytes are the same, so the forecast admits, holds
    and sheds the same requests on both sides."""
    rng = np.random.default_rng(8)
    reqs = [Request(uid=f"be-{i}", prompt=prompt(rng, 10), priority="best_effort")
            for i in range(4)]
    reqs += [Request(uid=f"prem-{i}", prompt=prompt(rng, 10), priority="premium")
             for i in range(2)]
    jeng, teng = engines = engine_pair(params, "paged", batch_slots=4, max_seq=32,
                                       page_size=8, prefill_chunk=8)
    jled, tled = JaxLedger(), HBMLedger()
    jax_engine_mod._register_engine_owners(jeng, ledger=jled)
    engine_mod._register_engine_owners(teng, ledger=tled)
    assert tled.committed_bytes() == jled.committed_bytes()
    # room for the weights and two requests' worst-case pages
    capacity = tled.committed_bytes() + 2 * teng.admit_bytes(10, 12)
    jled.set_capacity(capacity)
    tled.set_capacity(capacity)
    ref, got = run_pair(engines, stages=((1, reqs[:4]), (4, reqs[4:])),
                        max_new_tokens=12, shed_policy="shed", shed_patience=1,
                        preempt_budget=1, hbm_ledger=tled,
                        jax_sched_kw={"hbm_ledger": jled})
    assert_same_decisions(ref, got)
    results, rep = got
    assert all(r.finish_reason == "length" for r in results
               if r.priority == "premium")
    # the forecast both cut best_effort decodes for premium and shed
    assert rep.preemptions > 0
    assert rep.per_class["best_effort"]["shed"] > 0
    assert rep.per_class["premium"]["shed"] == 0


def test_shed_policy_block_never_sheds(params):
    """The default policy only queues under page pressure."""
    rng = np.random.default_rng(5)
    reqs = [Request(uid=f"be-{i}", prompt=prompt(rng, 12), priority="best_effort")
            for i in range(5)]
    ref, got = run_pair(_scarce(params), reqs, max_new_tokens=8)
    assert_same_decisions(ref, got)
    _, rep = got
    assert rep.finish_reasons == {"length": 5}
    assert rep.per_class["best_effort"]["shed"] == 0


def test_shed_patience_rides_out_transient_pressure(params):
    """With enough patience, pressure that completions relieve sheds
    nothing."""
    rng = np.random.default_rng(6)
    reqs = [Request(uid=f"be-{i}", prompt=prompt(rng, 12), priority="best_effort")
            for i in range(4)]
    ref, got = run_pair(_scarce(params), reqs, max_new_tokens=4,
                        shed_policy="shed", shed_patience=1_000_000)
    assert_same_decisions(ref, got)
    assert got[1].finish_reasons == {"length": 4}


def test_preempted_stream_never_shed(params):
    """A stream once preempted is exempt from the shed valve."""
    rng = np.random.default_rng(7)
    be = [Request(uid=f"be-{i}", prompt=prompt(rng, 12), priority="best_effort")
          for i in range(6)]
    prem = [Request(uid=f"prem-{i}", prompt=prompt(rng, 12), priority="premium")
            for i in range(3)]
    ref, got = run_pair(_scarce(params), stages=((1, be), (6, prem)),
                        max_new_tokens=16, shed_policy="shed", preempt_budget=2,
                        shed_patience=0)
    assert_same_decisions(ref, got)
    assert any(r.preemptions for r in got[0])
    for r in got[0]:
        if r.preemptions > 0:
            assert r.finish_reason != "shed", r.uid


def test_scheduler_knob_validation(params):
    engine = InferenceEngine(params[1], num_heads=4, batch_slots=1, max_seq=16,
                             prefill_attention="dense", device="cpu")
    with pytest.raises(ValueError, match="shed_policy"):
        ContinuousBatchingScheduler(engine, shed_policy="drop")
    with pytest.raises(ValueError, match="preempt_budget"):
        ContinuousBatchingScheduler(engine, preempt_budget=-1)
    with pytest.raises(ValueError, match="shed_patience"):
        ContinuousBatchingScheduler(engine, shed_patience=-1)
    with pytest.raises(ValueError, match="priority_classes"):
        ContinuousBatchingScheduler(engine, priority_classes=())
    with pytest.raises(ValueError, match="duplicate"):
        ContinuousBatchingScheduler(engine, priority_classes=("a", "a"))
    with pytest.raises(ValueError, match="result_window"):
        ContinuousBatchingScheduler(engine, result_window=0)


# -- synthetic traffic --------------------------------------------------------------

_SPECS = (
    dict(name="prem", priority="premium", rate_rps=3.0),
    dict(name="be", priority="best_effort", rate_rps=5.0, arrival="bursty",
         burst_secs=1.0, burst_period_s=2.0),
)


def _tenants(extra=()):
    return tuple(TenantSpec(**s) for s in _SPECS + extra)


def _jax_tenants(extra=()):
    return tuple(jax_traffic.TenantSpec(**s) for s in _SPECS + extra)


def _rows(schedule):
    return [(t.at_s, t.request.uid, list(t.request.prompt), t.request.tenant,
             t.request.priority, t.request.max_new_tokens) for t in schedule]


def test_traffic_schedule_deterministic_and_equal_to_reference():
    a = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    ref = jax_traffic.TrafficGenerator(_jax_tenants(), vocab_size=61,
                                       seed=7).schedule(4.0)
    assert _rows(a) == _rows(ref)
    b = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    assert _rows(a) == _rows(b)
    c = TrafficGenerator(_tenants(), vocab_size=61, seed=8).schedule(4.0)
    assert [(t.at_s, t.request.uid) for t in a] != [(t.at_s, t.request.uid) for t in c]
    # adding a tenant never perturbs an existing tenant's schedule
    std = (dict(name="std", rate_rps=2.0),)
    widened = TrafficGenerator(_tenants(std), vocab_size=61, seed=7).schedule(4.0)
    assert _rows(widened) == _rows(jax_traffic.TrafficGenerator(
        _jax_tenants(std), vocab_size=61, seed=7).schedule(4.0))
    assert [(t.at_s, t.request.uid) for t in widened if t.request.tenant == "prem"] \
        == [(t.at_s, t.request.uid) for t in a if t.request.tenant == "prem"]
    for tr in a:
        assert tr.request.priority in ("premium", "best_effort")
        assert all(0 < tok < 61 for tok in tr.request.prompt)


def test_traffic_burst_fault_consumed():
    """A burst spec splices extra arrivals into the named tenant exactly
    once, the same arrivals as the reference's."""
    spec = "burst@1:tenant=be:rps=30:secs=2:at=0.5"
    base = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    faults.install_plan(spec)
    jax_faults.install_plan(spec)
    burst = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    ref = jax_traffic.TrafficGenerator(_jax_tenants(), vocab_size=61,
                                       seed=7).schedule(4.0)
    assert _rows(burst) == _rows(ref)
    n_be = sum(1 for t in burst if t.request.tenant == "be")
    assert n_be > sum(1 for t in base if t.request.tenant == "be") + 10
    assert [(t.at_s, t.request.uid) for t in burst if t.request.tenant == "prem"] \
        == [(t.at_s, t.request.uid) for t in base if t.request.tenant == "prem"]
    # consumed: a second build sees no burst
    again = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    assert len(again) == len(base)
    assert [e.kind for e in faults.get_plan().events] == ["burst"]


def test_traffic_slow_tenant_fault_scales_prompts():
    spec = "slow_tenant@1:tenant=be:factor=3"
    faults.install_plan(spec)
    jax_faults.install_plan(spec)
    slow = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    ref = jax_traffic.TrafficGenerator(_jax_tenants(), vocab_size=61,
                                       seed=7).schedule(4.0)
    assert _rows(slow) == _rows(ref)
    faults.install_plan("")
    base = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(4.0)
    assert max(len(t.request.prompt) for t in slow if t.request.tenant == "be") > \
        max(len(t.request.prompt) for t in base if t.request.tenant == "be")


def test_poll_source_replays_in_order():
    sched = TrafficGenerator(_tenants(), vocab_size=61, seed=7).schedule(2.0)
    clock = {"t": 0.0}
    poll = poll_source(sched, speedup=1.0, clock=lambda: clock["t"])
    got = list(poll())  # the clock starts here
    for _ in range(400):
        clock["t"] += 0.05
        batch = poll()
        if batch is None:
            break
        got.extend(batch)
    assert batch is None, "source never closed"
    assert [r.uid for r in got] == [t.request.uid for t in sched]


def test_traffic_validation():
    with pytest.raises(ValueError, match="arrival"):
        TenantSpec(name="x", arrival="lumpy")
    with pytest.raises(ValueError, match="rate_rps"):
        TenantSpec(name="x", rate_rps=0)
    with pytest.raises(ValueError, match="burst_secs"):
        TenantSpec(name="x", arrival="bursty", burst_secs=5.0, burst_period_s=2.0)
    with pytest.raises(ValueError, match="duplicate"):
        TrafficGenerator((TenantSpec(name="x"), TenantSpec(name="x")), vocab_size=61)
    with pytest.raises(ValueError, match="speedup"):
        poll_source([], speedup=0)

"""The port's fleet observability (``obs/fleet.py``, the tracer's context,
``post_warmup_tokens_per_sec``) held to the JAX package's on the same
inputs, and one traced chaos fleet observed end to end on the CPU."""

from __future__ import annotations

import copy
import dataclasses
import glob
import os

import numpy as np
import pytest

from distributeddeeplearning_tpu.obs import fleet as jfleet
from distributeddeeplearning_tpu.obs import goodput as jgoodput
from distributeddeeplearning_tpu.obs import profile as jprofile
from distributeddeeplearning_tpu.obs import recorder as jrecorder
from distributeddeeplearning_tpu.obs import registry as jregistry
from distributeddeeplearning_tpu.obs import trace as jtrace
from distributeddeeplearning_tpu_torch.obs import fleet as tfleet
from distributeddeeplearning_tpu_torch.obs import goodput as tgoodput
from distributeddeeplearning_tpu_torch.obs import recorder as trecorder
from distributeddeeplearning_tpu_torch.obs import registry as tregistry
from distributeddeeplearning_tpu_torch.obs import trace as ttrace

FLEET_MODEL = dict(num_layers=1, d_model=16, num_heads=2, d_ff=32,
                   vocab_size=97, max_len=32)


@pytest.fixture(autouse=True, scope="module")
def _own_tracer_and_recorder():
    """This file's own tracers and flight recorders in both packages, the
    previous ones restored afterwards."""
    prior = (ttrace.get_tracer(), trecorder.get_recorder(),
             jtrace.get_tracer(), jrecorder.get_recorder())
    trecorder.set_recorder(trecorder.FlightRecorder(capacity=64))
    ttrace.set_tracer(ttrace.Tracer(enabled=False,
                                    recorder=ttrace.PROCESS_RECORDER))
    jrecorder.set_recorder(jrecorder.FlightRecorder(capacity=64))
    jtrace.set_tracer(jtrace.Tracer(enabled=False,
                                    recorder=jtrace.PROCESS_RECORDER))
    yield
    ttrace.set_tracer(prior[0])
    trecorder.set_recorder(prior[1])
    jtrace.set_tracer(prior[2])
    jrecorder.set_recorder(prior[3])


# -- the tracer's additions ----------------------------------------------------


def test_tracer_context_stamps_every_span_and_event_like_the_reference():
    traces = []
    for mod in (jtrace, ttrace):
        t = mod.Tracer(enabled=True, annotate=False, pid=7,
                       process_name="replica-3").set_context(replica=3)
        with t.span("s", uid="r1"):
            pass
        t.event("e", replica=9)
        traces.append(t)
    for a, b in zip(*(t.events for t in traces)):
        assert (a["name"], a["ph"], a["args"]) == (b["name"], b["ph"], b["args"])
    assert traces[1].events[0]["args"] == {"replica": 3, "uid": "r1", "depth": 0}
    assert traces[1].events[1]["args"] == {"replica": 9}  # explicit args win
    assert traces[1].to_chrome_trace()["metadata"]["tracer_epoch_unix_s"] == \
        traces[1].epoch_unix_s
    traces[1].clear()
    assert traces[1].events == []


def test_tracer_attach_recorder_records_while_disabled():
    rec = trecorder.FlightRecorder(capacity=8)
    t = ttrace.Tracer(enabled=False).attach_recorder(rec)
    with t.span("serve/x"):
        pass
    t.event("fleet/y")
    assert [e["name"] for e in rec.entries()] == ["serve/x", "fleet/y"]
    t.attach_recorder(None)
    t.event("fleet/z")
    assert len(rec.entries()) == 2


@pytest.mark.parametrize("args", [(100, 10.0, 2.0), (100, 10.0, 0.0),
                                  (100, 10.0, 12.0), (100, 0.0, 1.0),
                                  (7, 3.5, -1.0), (0, 5.0, 1.0)])
def test_post_warmup_tokens_per_sec_matches_reference(args):
    assert tgoodput.post_warmup_tokens_per_sec(*args) == \
        jgoodput.post_warmup_tokens_per_sec(*args)


# -- trace shard merge and failover chains --------------------------------------


def _shard(pid, name, epoch_unix_s, events):
    return {
        "traceEvents": [{"ph": "M", "name": "process_name", "pid": pid,
                         "args": {"name": name}}, *events],
        "metadata": {"tracer_epoch_unix_s": epoch_unix_s, "host_pids": [pid],
                     "process_name": name},
    }


TID = "tr0003"
ROUTER = _shard(10, "router", 1000.0, [
    {"ph": "i", "s": "t", "name": "fleet/replica_died", "pid": 10, "tid": 1,
     "ts": 3.0e6, "args": {"trace_ids": [TID]}},
    {"ph": "i", "s": "t", "name": "fleet/request_requeued", "pid": 10,
     "tid": 1, "ts": 3.1e6, "args": {"trace": TID}},
])
# the dying replica served the request 1.5 s in on the router clock (its
# epoch is 1 s later); the survivor completes at 3.5 s, whose raw local ts
# would sort BEFORE the death without alignment
DYING = _shard(20, "replica-0", 1001.0, [
    {"ph": "X", "name": "serve/admit", "pid": 20, "tid": 1, "ts": 0.5e6,
     "dur": 10.0, "args": {"trace": TID}},
])
SURVIVOR = _shard(30, "replica-1", 1002.5, [
    {"ph": "i", "s": "t", "name": "serve/request_complete", "pid": 30,
     "tid": 1, "ts": 1.0e6, "args": {"trace": TID}},
])
# a shard whose pid collides with the router's and with another shard's
COLLIDE_A = _shard(10, "replica-0", 1000.0, [
    {"ph": "X", "name": "serve/a", "pid": 10, "tid": 1, "ts": 1.0, "dur": 1.0,
     "args": {}}])
COLLIDE_B = _shard(10, "replica-1", 1000.0, [
    {"ph": "X", "name": "serve/b", "pid": 10, "tid": 1, "ts": 1.0, "dur": 1.0,
     "args": {}}])

MERGE_CASES = {
    "skew_epoch": (ROUTER, [DYING, SURVIVOR], None),
    "skew_handshake": (ROUTER, [DYING, SURVIVOR], {20: 7.0e6}),
    "colliding_pids": (_shard(10, "router", 1000.0, []),
                       [COLLIDE_A, COLLIDE_B], None),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_fleet_trace_matches_reference(case):
    router, shards, offsets = MERGE_CASES[case]
    got = tfleet.merge_fleet_trace(copy.deepcopy(router), copy.deepcopy(shards),
                                   offsets_us=offsets)
    want = jfleet.merge_fleet_trace(copy.deepcopy(router), copy.deepcopy(shards),
                                    offsets_us=offsets)
    assert got == want
    assert tfleet.summarize_timeline(got) == jprofile.summarize_timeline(want)
    if case == "colliding_pids":
        pids = {e["name"]: e["pid"] for e in got["traceEvents"]
                if e.get("ph") == "X"}
        assert len({10, pids["serve/a"], pids["serve/b"]}) == 3
    if case == "skew_handshake":
        ev = next(e for e in got["traceEvents"] if e.get("name") == "serve/admit")
        assert ev["ts"] == pytest.approx(7.0e6 + 0.5e6, abs=1.0)


@pytest.mark.parametrize("drop", [None, "fleet/replica_died",
                                  "fleet/request_requeued",
                                  "serve/request_complete", "serve/admit"])
def test_failover_chains_and_check_match_reference(drop):
    merged = tfleet.merge_fleet_trace(ROUTER, [DYING, SURVIVOR])
    chains = tfleet.failover_chains(merged, [TID])
    assert chains == jfleet.failover_chains(merged, [TID])
    assert tfleet.failover_chains(merged) == jfleet.failover_chains(merged)
    chain = [e for e in chains[TID] if e["name"] != drop]
    verdict = tfleet.check_failover_chain(chain)
    assert verdict == jfleet.check_failover_chain(chain)
    assert verdict["ok"] is (drop is None)
    if drop is None:
        assert [e["name"] for e in chain] == [
            "serve/admit", "fleet/replica_died", "fleet/request_requeued",
            "serve/request_complete"]
        assert verdict["served_on_pid_before_death"] == [20]
        assert verdict["completed_on_pid"] == 30


# -- SLOs -------------------------------------------------------------------------

SLO_TEXTS = ("ttft_p99_s=2.0,tpot_p99_s=0.5,max_error_rate=0.01,max_lost_requests=0",
             "ttft_p99_s=1.0", "max_lost_requests=2", "", "p99=1.0", "ttft_p99_s")


@pytest.mark.parametrize("text", SLO_TEXTS)
def test_slo_parse_matches_reference(text):
    try:
        want = jfleet.SLOSpec.parse(text)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split(";")[0][:20]):
            tfleet.SLOSpec.parse(text)
        return
    got = tfleet.SLOSpec.parse(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()
    assert tfleet.SLOSpec.parse(got.describe()) == got


LATENCY = {"ttft_s": {"p99": 0.8}, "tpot_s": {"p99": 0.1},
           "ttft_samples": 10, "tpot_samples": 10}
EVAL_CASES = {
    "pass": ({"requests": 10, "errors": 0, "lost_requests": 0}, LATENCY),
    "violations": ({"requests": 10, "errors": 1, "lost_requests": 2},
                   {**LATENCY, "ttft_s": {"p99": 3.0}}),
    "no_samples": ({"requests": 5, "errors": 0, "lost_requests": 0},
                   {"ttft_s": {"p99": 0.0}, "tpot_s": {}, "ttft_samples": 0,
                    "tpot_samples": 0}),
    "no_requests": ({}, LATENCY),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_slo_evaluate_matches_reference(case):
    report, latency = EVAL_CASES[case]
    text = "ttft_p99_s=1.0,tpot_p99_s=0.2,max_error_rate=0,max_lost_requests=0"
    got = tfleet.SLOSpec.parse(text).evaluate(fleet_report=report, latency=latency)
    assert got == jfleet.SLOSpec.parse(text).evaluate(fleet_report=report,
                                                       latency=latency)
    # no requests: an error rate of 0, the latencies within their limits
    assert got["pass"] is (case in ("pass", "no_requests"))


CLASS_ENTRIES = (["premium:ttft_p99_s=0.5,tpot_p99_s=0.1",
                  "best_effort:max_error_rate=0.5"],
                 ["ttft_p99_s=0.5"],
                 ["premium:ttft_p99_s=1", "premium:tpot_p99_s=1"],
                 ["pre mium:ttft_p99_s=1"])


@pytest.mark.parametrize("entries", CLASS_ENTRIES, ids=["ok", "no_class",
                                                        "duplicate", "space"])
def test_parse_class_slos_matches_reference(entries):
    try:
        want = jfleet.parse_class_slos(entries)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:12]):
            tfleet.parse_class_slos(entries)
        return
    got = tfleet.parse_class_slos(entries)
    assert {k: v.describe() for k, v in got.items()} == {
        k: v.describe() for k, v in want.items()}


def _lat(ttft, tpot, samples=5):
    return {"ttft_s": {"p99": ttft}, "ttft_samples": samples,
            "tpot_s": {"p99": tpot}, "tpot_samples": samples}


CLASS_EVAL = {
    "pass": ({"per_class": {"premium": {"requests": 5, "errors": 0}},
              "lost_requests": 0}, {"premium": _lat(0.2, 0.01)}),
    "breach": ({"per_class": {"premium": {"requests": 5, "errors": 0}},
                "lost_requests": 0}, {"premium": _lat(0.9, 0.01)}),
    "empty": ({"per_class": {}, "lost_requests": 0}, {}),
    "lost": ({"per_class": {"premium": {"requests": 5, "errors": 0}},
              "lost_requests": 1}, {"premium": _lat(0.2, 0.01)}),
}


@pytest.mark.parametrize("case", sorted(CLASS_EVAL))
def test_evaluate_class_slos_matches_reference(case):
    report, per_class = CLASS_EVAL[case]
    entries = ["premium:ttft_p99_s=0.5"]
    got = tfleet.evaluate_class_slos(tfleet.parse_class_slos(entries),
                                     fleet_report=report,
                                     per_class_latency=per_class)
    assert got == jfleet.evaluate_class_slos(jfleet.parse_class_slos(entries),
                                             fleet_report=report,
                                             per_class_latency=per_class)
    assert got["pass"] is (case == "pass")


# -- fleet latency over shipped states --------------------------------------------


def _shipped(mod, samples_by_name, counters=None, *, replica):
    reg = mod.MetricsRegistry().set_identity(replica_id=replica,
                                              process_name=f"replica-{replica}")
    for name, xs in samples_by_name.items():
        reg.histogram(name).record_many(xs)
    for name, n in (counters or {}).items():
        reg.counter(name).inc(n)
    return reg.state()


def test_fleet_latency_over_states_both_packages_shipped():
    """A fast busy replica (the port's) and a small slow one (the
    reference's): the bucket-merged p99 sees the slow tail, where
    averaging per-replica percentiles would not; both packages' readers
    give the same blocks over the same shipped states, in either order,
    per class too."""
    rng = np.random.default_rng(0)
    fast = rng.lognormal(-2.0, 0.3, 100).tolist()
    states = [
        _shipped(tregistry, {"serve.ttft_s": fast, "serve.tpot_s": fast[:50],
                             "serve.ttft_s.premium": fast[:30]},
                 {"kernels.flash_decode.launches": 12}, replica=0),
        _shipped(jregistry, {"serve.ttft_s": [9.0] * 4,
                             "serve.tpot_s.best_effort": [0.5] * 3},
                 replica=1),
    ]
    for order in (states, states[::-1]):
        got = tfleet.fleet_latency(tregistry.merge_states(order))
        assert got == jfleet.fleet_latency(jregistry.merge_states(order))
        per = tfleet.fleet_latency_per_class(tregistry.merge_states(order))
        assert per == jfleet.fleet_latency_per_class(jregistry.merge_states(order))
    assert got["ttft_samples"] == 104
    assert got["ttft_s"]["p99"] == pytest.approx(9.0, rel=0.05)
    assert sorted(per) == ["best_effort", "premium"]
    assert per["premium"]["ttft_samples"] == 30
    assert per["best_effort"]["tpot_samples"] == 3
    assert tregistry.merge_states(states).counter(
        "kernels.flash_decode.launches").value == 12
    assert tfleet.TTFT_HISTOGRAM == "serve.ttft_s"
    assert tfleet.TPOT_HISTOGRAM == "serve.tpot_s"


# -- one traced chaos fleet, observed end to end ------------------------------------


@pytest.mark.timeout(280)
def test_observe_fleet_end_to_end_chaos(tmp_path):
    """A 2-replica port fleet through ``replica_death@3`` with tracing on:
    worker shards exported (the dying replica's too), merged onto the
    router clock, the failover traceable under one trace id, fleet
    TTFT/TPOT bucket-merged from attributable per-replica states, the
    death dumped on both sides of the process boundary, the SLOs met."""
    from distributeddeeplearning_tpu_torch.serve import ReplicaSpec
    from distributeddeeplearning_tpu_torch.serve.scheduler import (
        synthetic_requests,
    )

    spec = ReplicaSpec(model=FLEET_MODEL, seed=0, num_heads=2, batch_slots=2,
                       max_seq=32, kv_layout="paged", page_size=8,
                       prefill_chunk=8, max_new_tokens=8, device="cpu")
    reqs = synthetic_requests(8, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=10, rng=np.random.default_rng(0))
    trace_dir = str(tmp_path / "fleet-trace")
    os.makedirs(trace_dir)
    open(os.path.join(trace_dir, "replica9-1.trace.json"), "w").write("{}")
    # a death dealt to each replica: whichever serves three decode steps
    # dies, however skewed the two spawns are on a loaded host (the other
    # may take no request before the work is done)
    view = tfleet.observe_fleet(
        spec, reqs, replicas=2, trace_dir=trace_dir,
        faults="replica_death@3:replica=0,replica_death@3:replica=1",
        slo=tfleet.SLOSpec.parse("ttft_p99_s=120,tpot_p99_s=30,"
                                 "max_error_rate=0,max_lost_requests=0"),
        class_slos=tfleet.parse_class_slos(["standard:ttft_p99_s=120"]),
        heartbeat_timeout_s=45.0,
    )
    report = view["fleet_report"]
    assert report.replica_deaths >= 1 and report.lost_requests == 0
    assert sorted(r.uid for r in view["results"]) == sorted(r.uid for r in reqs)
    assert len(set(report.trace_ids.values())) == len(reqs)
    shards = glob.glob(os.path.join(trace_dir, "replica*.trace.json"))
    assert len(shards) >= 2 and not os.path.exists(
        os.path.join(trace_dir, "replica9-1.trace.json"))  # stale shard gone
    assert os.path.exists(view["merged_trace_path"])
    ok_chains = [t for t, c in view["failover"].items() if c["ok"]]
    assert ok_chains, view["failover"]
    names = [e["name"] for e in view["failover"][ok_chains[0]]["chain"]]
    assert names.index("fleet/replica_died") < names.index(
        "fleet/request_requeued") < len(names) - 1 - names[::-1].index(
        "serve/request_complete")
    assert view["fleet_latency"]["ttft_samples"] == len(reqs)
    for row in view["per_replica_metrics"]:
        assert isinstance(row["pid"], int) and isinstance(row["replica_id"], int)
    assert tfleet.fleet_latency(tregistry.merge_states(
        list(reversed(view["per_replica_metrics"])))) == view["fleet_latency"]
    reasons = {d["reason"] for d in view["flight_recorder_dumps"]}
    assert {"replica_death", "replica_death (injected)"} <= reasons
    assert view["slo"]["pass"], view["slo"]
    assert view["slo_per_tenant"]["pass"], view["slo_per_tenant"]
    assert view["timeline"]["event_counts"]["host_spans"] > 0
    # the shards carry each worker's replica context on every span
    worker_spans = [e for e in view["merged_trace"]["traceEvents"]
                    if e.get("ph") == "X" and e["name"].startswith("serve/")]
    assert worker_spans and all("replica" in e["args"] for e in worker_spans)

"""The port's supervised serving fleet (``serve/fleet.py``), its fault
helpers and ``data_parallel_engine``, held to the JAX package's.

The fleet tests spawn worker processes on the CPU at the reference's
``FLEET_MODEL`` size.  Each bounds its own waits (ready and heartbeat
timeouts, joins) and stops every worker it spawned in a ``finally``
(``FleetRouter.terminate``), so a hung fleet fails its test instead of
eating the suite's time.  One test runs the reference's fleet: both
packages take the fault matrix on the same weights (the JAX params carried
over through a port checkpoint).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.obs import recorder as jrecorder
from distributeddeeplearning_tpu.obs import trace as jtrace
from distributeddeeplearning_tpu.serve import engine as jengine
from distributeddeeplearning_tpu.serve import fleet as jfleet
from distributeddeeplearning_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
)
from distributeddeeplearning_tpu.utils import faults as jfaults
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.obs import recorder as trecorder
from distributeddeeplearning_tpu_torch.obs import trace as ttrace
from distributeddeeplearning_tpu_torch.serve import engine as tengine
from distributeddeeplearning_tpu_torch.serve import fleet as tfleet
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    synthetic_requests,
)
from distributeddeeplearning_tpu_torch.quant import calibrate as tcalib
from distributeddeeplearning_tpu_torch.quant import qtensor as tquant
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer
from distributeddeeplearning_tpu_torch.utils import faults as tfaults
from tests._torch_robust import jax_request

FLEET_MODEL = dict(num_layers=1, d_model=16, num_heads=2, d_ff=32,
                   vocab_size=97, max_len=32)
FAULT_MATRIX = "replica_death@3,decode_nan@5,decode_stall@8:secs=0.2"
#: every spawning test's own bounds (the timeout marker is inert without
#: pytest-timeout): its waits for ready replicas last at most READY_S, and
#: the router's own spawn bound is ``DEFAULT_READY_TIMEOUT_S``
READY_S = 90.0
HEARTBEAT_S = 45.0


@pytest.fixture(autouse=True, scope="module")
def _own_tracer_and_recorder():
    """This file's own tracers and flight recorders in both packages,
    the previous ones restored afterwards: a recorder or tracer left
    installed by another file must not see (or be fed) these runs."""
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


def _spec(**kw):
    for key, value in dict(model=FLEET_MODEL, seed=0, num_heads=2,
                           batch_slots=2, max_seq=32, kv_layout="paged",
                           page_size=8, prefill_chunk=8, max_new_tokens=8,
                           device="cpu").items():
        kw.setdefault(key, value)
    return tfleet.ReplicaSpec(**kw)


def _router(spec, **kw):
    kw.setdefault("faults", "")
    return tfleet.FleetRouter(spec, heartbeat_timeout_s=HEARTBEAT_S, **kw)


def _ready_router(spec, **kw):
    """A router whose replicas are all spawned and ready: a fault dealt to
    replica 0 then fires whatever the spawns' skew on a loaded host (a
    replica still starting takes no request)."""
    router = _router(spec, **kw)
    router.serve([], shutdown=False)
    assert router.wait_ready(READY_S)
    return router


def _serve(spec, reqs, **kw):
    router = _ready_router(spec, **kw)
    try:
        return router.serve(reqs)
    finally:
        router.terminate()


def _jax_serve(spec, reqs, **kw):
    """The reference's fleet, its replicas made ready first as
    :func:`_ready_router` does (through its idle pump: it has no
    ``wait_ready``)."""
    router = jfleet.FleetRouter(spec, **kw)
    try:
        router.serve([], shutdown=False)
        deadline = time.monotonic() + READY_S
        while not all(m.ready for m in router._members if not m.dead):
            assert time.monotonic() < deadline, "reference replicas not ready"
            try:
                router._pump_idle(router._outbox.get(timeout=0.1))
            except queue.Empty:
                pass
        return router.serve(reqs)
    finally:
        router._shutdown_members()


def _save_ckpt(directory, params):
    """A port checkpoint holding ``params`` as generation 1."""
    ckpt = Checkpointer(str(directory))
    ckpt.save(1, types.SimpleNamespace(step=1, params=params, opt_state={},
                                       batch_stats={}))
    ckpt.close()
    return str(directory)


def _engine_tokens(params, reqs, *, seed=0, max_new_tokens=8):
    """Greedy tokens of the one-process paged engine of the fleet spec."""
    eng = tengine.PagedInferenceEngine(
        params, num_heads=2, batch_slots=2, max_seq=32, page_size=8,
        prefill_chunk=8, seed=seed, device="cpu")
    res, _ = ContinuousBatchingScheduler(eng, max_new_tokens=max_new_tokens).run(
        [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs])
    return {r.uid: list(r.tokens) for r in res}


def _seed_params(seed=0):
    return tpt.init_params(torch.Generator().manual_seed(seed), **FLEET_MODEL,
                           device="cpu")


def _assert_workers_jax_free(report):
    assert report.worker_info
    for key, info in report.worker_info.items():
        if "spawn_to_ready_s" in info:
            assert info["jax_loaded"] is False, key
            assert info["device"] == "cpu", key
    for rep in report.replica_reports:
        if rep is not None:
            assert rep["jax_loaded"] is False


# -- fault helpers, against the reference -----------------------------------

SPECS = (
    "replica_death@3,decode_nan@5,io_error@p=0.5,decode_stall@8:secs=0.2",
    "replica_death@3:replica=1",
    FAULT_MATRIX,
    "replica_death@2",
    "reject_admit@2,decode_nan@1,replica_death@4,nan_loss@3",
    "",
)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_deal_serve_faults_matches_reference(text, n):
    assert tfaults.deal_serve_faults(text, n) == jfaults.deal_serve_faults(text, n)


@pytest.mark.parametrize("text", SPECS)
def test_strip_kinds_matches_reference(text):
    for kinds in (("replica_death",), ("decode_nan", "io_error")):
        assert tfaults.strip_kinds(text, kinds) == jfaults.strip_kinds(text, kinds)


@pytest.mark.parametrize("text", ["replica_death@3", "replica_death@1,decode_nan@2",
                                  "decode_nan@3"])
def test_take_replica_death_matches_reference(text):
    tplan = tfaults.FaultPlan(tfaults.parse_spec(text))
    jplan = jfaults.FaultPlan(jfaults.parse_spec(text))
    for step in (1, 2, 5, 6, 7):
        assert tplan.take_replica_death(step) == jplan.take_replica_death(step)
    assert tfaults.SERVE_KINDS == jfaults.SERVE_KINDS


def test_deal_serve_faults_refuses_no_replicas():
    with pytest.raises(ValueError, match="n_replicas"):
        tfaults.deal_serve_faults("replica_death@1", 0)


# -- spec and router validation ----------------------------------------------

BAD_SPECS = (
    dict(kv_layout="ring"),
    dict(model={}, checkpoint_dir=None),
    dict(priority_classes=("a", "a")),
    dict(shed_policy="drop"),
    dict(preempt_budget=-1),
    dict(host_pages=-1),
    dict(kv_layout="dense", host_pages=2),
)


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: ",".join(d))
def test_replica_spec_refuses_what_the_reference_refuses(bad):
    base = dict(model=FLEET_MODEL, num_heads=2)
    with pytest.raises(ValueError):
        jfleet.ReplicaSpec(**dict(base, **bad))
    with pytest.raises(ValueError):
        tfleet.ReplicaSpec(**dict(base, device="cpu", **bad))


@pytest.mark.parametrize("bad", [dict(device="tpu"), dict(device="cuda:x"),
                                 dict(quantize_weights="int4")])
def test_replica_spec_refuses_port_fields(bad):
    with pytest.raises(ValueError):
        tfleet.ReplicaSpec(model=FLEET_MODEL, **bad)
    assert tfleet.ReplicaSpec(model=FLEET_MODEL).device == "cuda"


@pytest.mark.parametrize("kw", [dict(replicas=0), dict(max_restarts=-1),
                                dict(max_redeliveries=0),
                                dict(heartbeat_timeout_s=0.0)])
def test_router_refuses_bad_bounds(kw):
    with pytest.raises(ValueError):
        tfleet.FleetRouter(_spec(), faults="", **kw)


@pytest.mark.parametrize("lift", ["_tier_watermarks", "_hbm_watermarks"])
def test_watermark_lifts_match_reference(lift):
    """The per-replica frames lifted out of shipped registry states, keyed
    ``replicaK-pid``; replicas without the metrics stay absent."""
    states = [
        {"replica_id": 0, "pid": 11,
         "counters": {"serve.tier.spilled_pages": 3, "serve.requests": 9},
         "gauges": {"serve.tier.host_pages_peak": {"value": 2.0},
                    "hbm.kv_pages.bytes": {"value": 4096.0}}},
        {"replica_id": 1, "pid": 22, "counters": {"serve.requests": 4},
         "gauges": {}},
        {"pid": 33, "counters": {}, "gauges": {"hbm.total_bytes": {"value": 1.0}}},
    ]
    assert getattr(tfleet, lift)(states) == getattr(jfleet, lift)(states)
    assert getattr(tfleet, lift)(states)


# -- data_parallel_engine ------------------------------------------------------


@pytest.mark.parametrize("slots", [8, 3])
def test_data_parallel_engine_matches_reference(slots):
    """The reference shards slots over the 8 fake CPU devices when they
    divide (8) and builds one device's engine otherwise (3); the port's
    CPU engine is the single-device one in both cases, with the same
    tokens.  The reference's sharded-slot engine fails its decode in this
    JAX version (as its own ``test_serve::test_sharded_cache_smoke``
    does), so the sharded case holds the port to the reference's
    single-device engine, which that mesh path is meant to equal."""
    jp = jpt.init_params(jax.random.key(0), **FLEET_MODEL)
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(num_heads=2, batch_slots=slots, max_seq=32,
              prefill_attention="dense")
    jeng, jmesh = jengine.data_parallel_engine(jp, **kw)
    teng, tmesh = tengine.data_parallel_engine(tp, device="cpu", **kw)
    assert (jmesh is not None) == (slots % len(jax.devices()) == 0)
    assert tmesh is None and isinstance(teng, tengine.InferenceEngine)
    if jmesh is not None:
        jeng = jengine.InferenceEngine(jp, **kw)
    reqs = synthetic_requests(6, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=10, rng=np.random.default_rng(5))
    jres, _ = JaxScheduler(jeng, max_new_tokens=6).run(
        [jax_request(r) for r in reqs])
    tres, _ = ContinuousBatchingScheduler(teng, max_new_tokens=6).run(reqs)
    assert {r.uid: list(r.tokens) for r in tres} == {
        r.uid: list(r.tokens) for r in jres}


def test_data_parallel_engine_refuses_slot_sharding_over_cards(monkeypatch):
    """Where the rule would shard slots over two cards in one process the
    port raises (ROADMAP A6) before building anything; slots that do not
    divide keep the one-card engine."""
    monkeypatch.setattr(tengine, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="A6"):
        tengine.data_parallel_engine(_seed_params(), num_heads=2,
                                     batch_slots=4, max_seq=32)


class _EngineStub:
    """Stands in for an engine on a card this machine lacks: records how
    it was built."""

    def __init__(self, params, **kw):
        self.kw = kw


def _four_cards(monkeypatch):
    """A host that shows four cards, with the engine stubbed out."""
    monkeypatch.setattr(tengine, "resolve_device",
                        lambda device=None: torch.device(device or "cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tengine, "InferenceEngine", _EngineStub)


@pytest.mark.parametrize("device,slots,shards", [("cuda", 8, True),
                                                 ("cuda", 6, False),
                                                 ("cuda:0", 8, False),
                                                 ("cuda:3", 4, False)])
def test_data_parallel_engine_counts_the_cards_it_may_use(monkeypatch, device,
                                                          slots, shards):
    """On a host with four cards, an engine on ``"cuda"`` may use all four
    and its slots would shard over them where they divide (which raises);
    one pinned to a card (``"cuda:N"``) counts that card alone and gets the
    one-card engine whatever its slot count."""
    _four_cards(monkeypatch)
    kw = dict(num_heads=2, batch_slots=slots, max_seq=32, device=device)
    if shards:
        with pytest.raises(NotImplementedError, match="A6"):
            tengine.data_parallel_engine(None, **kw)
        return
    engine, mesh = tengine.data_parallel_engine(None, **kw)
    assert mesh is None and isinstance(engine, _EngineStub)
    assert engine.kw["batch_slots"] == slots


def test_dense_fleet_worker_pins_its_card(monkeypatch, tmp_path):
    """A dense replica whose spec says ``"cuda"`` builds its engine on the
    card the worker owns (``cuda:N``), so a host that shows four cards
    does not make ``data_parallel_engine`` refuse its 8 slots."""
    from distributeddeeplearning_tpu_torch import _device

    _four_cards(monkeypatch)
    monkeypatch.setattr(_device, "resolve_device", tengine.resolve_device)
    monkeypatch.setattr(tfleet, "_check_kernels_built", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    params = _seed_params()
    monkeypatch.setattr(tfleet, "_restore_params", lambda spec, d: (params, 1))
    spec = _spec(model={}, checkpoint_dir=str(tmp_path), kv_layout="dense",
                 batch_slots=8, device="cuda")
    engine = tfleet._build_engine(spec)
    assert isinstance(engine, _EngineStub)
    assert engine.kw["device"] == torch.device("cuda", 0)
    assert engine.kw["batch_slots"] == 8


# -- int8 weights from a checkpoint ---------------------------------------------


def _leaf_pairs(tree, path=""):
    """(path, leaf) of a params tree, QTensors as leaves."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_pairs(tree[key], f"{path}/{key}")
    else:
        yield path, tree


def _assert_same_tree(got, want):
    got, want = dict(_leaf_pairs(got)), dict(_leaf_pairs(want))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w), key
        if isinstance(w, tquant.QTensor):
            assert torch.equal(g.values, w.values), key
            assert torch.equal(g.scales, w.scales), key
            assert (g.axis, g.block) == (w.axis, w.block), key
        else:
            assert torch.equal(g, w), key


def _flip_params(step_dir):
    """One flipped byte in the middle of a generation's ``params`` data."""
    path = step_dir / "params" / tckpt.DATA_NAME
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def test_restore_params_quantizes_only_verified_weights(tmp_path, monkeypatch):
    """``restore_params(quantize_weights="int8")`` equals
    ``quantize_params`` of the saved f32 params, leaf by leaf; a newest
    generation with a flipped params byte is rejected by its checksums
    before anything is quantized (the older one is served), and with every
    generation corrupt nothing is quantized at all."""
    ckpt = Checkpointer(str(tmp_path / "d"))
    older, newer = _seed_params(1), _seed_params(2)
    for step, params in ((1, older), (2, newer)):
        ckpt.save(step, types.SimpleNamespace(step=step, params=params,
                                              opt_state={}, batch_stats={}))
        ckpt.wait()
    got, step = ckpt.restore_params(quantize_weights="int8")
    assert step == 2
    _assert_same_tree(got, tcalib.quantize_params(newer))

    quantized = []
    real = tcalib.quantize_params
    monkeypatch.setattr(tcalib, "quantize_params",
                        lambda p: quantized.append(p) or real(p))
    _flip_params(tmp_path / "d" / "2")
    got, step = ckpt.restore_params(quantize_weights="int8")
    assert step == 1 and len(quantized) == 1
    _assert_same_tree(quantized[0], older)
    _assert_same_tree(got, real(older))
    _flip_params(tmp_path / "d" / "1")
    with pytest.raises(tckpt.CheckpointCorruptionError):
        ckpt.restore_params(quantize_weights="int8")
    assert len(quantized) == 1
    ckpt.close()


@pytest.mark.timeout(280)
def test_int8_fleet_replica_matches_the_one_process_int8_engine(tmp_path):
    """One replica serving a checkpoint with ``quantize_weights="int8"``
    streams the tokens of the one-process engine on
    ``quantize_params`` of the same f32 weights."""
    params = _seed_params(3)
    reqs = synthetic_requests(4, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=8, rng=np.random.default_rng(7))
    spec = _spec(model={}, checkpoint_dir=_save_ckpt(tmp_path / "w", params),
                 quantize_weights="int8")
    results, report = _serve(spec, reqs, replicas=1, max_restarts=0)
    assert report.completed_ok == len(reqs) and report.lost_requests == 0
    assert {r.uid: list(r.tokens) for r in results} == _engine_tokens(
        tcalib.quantize_params(params), reqs)


# -- the fleet against the reference's -----------------------------------------


@pytest.mark.timeout(280)
def test_fleet_fault_matrix_matches_reference(tmp_path):
    """Both packages' fleets take the fault matrix on the same weights: the
    reference from its seed, the port from a checkpoint of those params.
    Equal finish reasons, deaths, restarts and lost counts; every
    surviving request's tokens equal in both fleets and equal to the
    port's one-process engine (the fault-free answer); no lost request;
    the workers never load jax."""
    reqs = synthetic_requests(8, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=10, rng=np.random.default_rng(0))
    jp = jpt.init_params(jax.random.key(0), **FLEET_MODEL)
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    clean = _engine_tokens(tp, reqs)

    jspec = jfleet.ReplicaSpec(
        model=FLEET_MODEL, seed=0, num_heads=2, batch_slots=2, max_seq=32,
        kv_layout="paged", page_size=8, prefill_chunk=8, max_new_tokens=8)
    jres, jrep = _jax_serve(
        jspec, [jax_request(r) for r in reqs], replicas=2, max_restarts=1,
        max_redeliveries=2, heartbeat_timeout_s=HEARTBEAT_S + 120.0,
        faults=FAULT_MATRIX)

    spec = _spec(model={}, checkpoint_dir=_save_ckpt(tmp_path / "w", tp))
    tres, trep = _serve(spec, reqs, replicas=2, max_restarts=1,
                        max_redeliveries=2, faults=FAULT_MATRIX)

    for rep in (jrep, trep):
        assert rep.replica_deaths == 1 and rep.restarts == 1
        assert rep.lost_requests == 0 and rep.redeliveries >= 1
        assert rep.finish_reasons == {"error": 1, "length": len(reqs) - 1}
    assert trep.finish_reasons == jrep.finish_reasons
    assert sorted(r.uid for r in tres) == sorted(r.uid for r in reqs)
    errors = [r for r in tres if r.finish_reason == "error"]
    assert len(errors) == 1 and "non-finite" in errors[0].error
    jtok = {r.uid: list(r.tokens) for r in jres if r.finish_reason == "length"}
    for r in tres:
        if r.finish_reason == "length":
            assert list(r.tokens) == clean[r.uid], r.uid
            if r.uid in jtok:
                assert list(r.tokens) == jtok[r.uid], r.uid
    for uid, toks in jtok.items():
        assert toks == clean[uid], uid
    _assert_workers_jax_free(trep)
    # the restart got the dealt slice with replica_death stripped
    assert len(trep.worker_info) == 3
    reasons = {d["reason"] for d in trep.flight_recorder_dumps}
    assert {"replica_death", "replica_death (injected)"} <= reasons


# -- the rest of the port fleet --------------------------------------------------


@pytest.mark.timeout(280)
def test_fleet_death_without_restart_budget_completes_on_survivor():
    reqs = synthetic_requests(6, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=8, rng=np.random.default_rng(1))
    results, report = _serve(_spec(), reqs, replicas=2, max_restarts=0,
                             faults="replica_death@2")
    assert report.replica_deaths == 1
    assert report.restarts == 0
    assert report.lost_requests == 0
    assert report.completed_ok == len(reqs)  # the survivor served everything
    clean = _engine_tokens(_seed_params(), reqs)
    assert {r.uid: list(r.tokens) for r in results} == clean
    assert "jax" in sys.modules  # this process has it; the workers must not
    _assert_workers_jax_free(report)
    assert report.fleet_latency["ttft_samples"] >= 1
    # the spawn-to-ready handshake of both first incarnations
    readies = [i["spawn_to_ready_s"] for i in report.worker_info.values()
               if "spawn_to_ready_s" in i]
    assert len(readies) == 2 and all(0 < s < READY_S for s in readies)


@pytest.mark.timeout(280)
def test_fleet_drain_preempts_unfinished_and_reports_drained():
    router = _router(_spec(max_new_tokens=16), replicas=2)
    reqs = synthetic_requests(12, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=8, rng=np.random.default_rng(2))
    stop = threading.Event()

    def drain_when_live():
        deadline = time.monotonic() + READY_S
        while time.monotonic() < deadline and not stop.is_set():
            if any(m.ready for m in router._members):
                router.drain()
                return
            time.sleep(0.05)

    t = threading.Thread(target=drain_when_live, daemon=True)
    t.start()
    try:
        results, report = router.serve(reqs)
    finally:
        stop.set()
        t.join(timeout=5)
        router.terminate()
    assert report.drained
    assert sum(report.finish_reasons.values()) == len(reqs)
    assert report.lost_requests == 0
    for r in results:
        assert r.finish_reason in ("length", "preempted"), r
        if r.finish_reason == "preempted":
            assert r.tokens == []


@pytest.mark.timeout(280)
@pytest.mark.parametrize("mode", ["between_serves", "mid_serve_thread"])
def test_fleet_reload(tmp_path, mode):
    """``between_serves``: serve on checkpoint A, reload B with every
    replica acking, serve a second batch on the same processes, whose
    tokens equal a fresh engine of B.  ``mid_serve_thread``: reload from
    another thread while a serve runs; the dispatch loop harvests the acks
    and every request finishes."""
    params_b = _seed_params(2)
    dir_a = _save_ckpt(tmp_path / "a", _seed_params(1))
    dir_b = _save_ckpt(tmp_path / "b", params_b)
    spec = _spec(model={}, checkpoint_dir=dir_a)
    router = _router(spec, replicas=2)
    try:
        if mode == "between_serves":
            batch_a = synthetic_requests(
                4, vocab_size=FLEET_MODEL["vocab_size"], max_prompt=8,
                rng=np.random.default_rng(0))
            batch_b = [Request(uid=f"post{i}", prompt=r.prompt)
                       for i, r in enumerate(synthetic_requests(
                           4, vocab_size=FLEET_MODEL["vocab_size"],
                           max_prompt=8, rng=np.random.default_rng(1)))]
            _, rep_a = router.serve(batch_a, shutdown=False)
            assert rep_a.completed_ok == len(batch_a)
            assert router.wait_ready(READY_S)  # a slow spawn takes no ack
            acks = router.reload(dir_b, timeout_s=60)
            assert sorted(acks) == [0, 1]
            assert all(a["ok"] and a["step"] == 1 for a in acks.values()), acks
            res_b, rep_b = router.serve(batch_b)
            assert rep_b.completed_ok == len(batch_b)
            assert rep_b.reloads == 1
            assert {r.uid: list(r.tokens) for r in res_b} == _engine_tokens(
                params_b, batch_b)
            return
        reqs = synthetic_requests(8, vocab_size=FLEET_MODEL["vocab_size"],
                                  max_prompt=8, rng=np.random.default_rng(3))
        acks_box = {}
        stop = threading.Event()

        def reload_when_live():
            deadline = time.monotonic() + READY_S
            while time.monotonic() < deadline and not stop.is_set():
                if any(m.ready for m in router._members):
                    acks_box.update(router.reload(dir_b, timeout_s=60))
                    return
                time.sleep(0.05)

        t = threading.Thread(target=reload_when_live, daemon=True)
        t.start()
        try:
            # the workers stay up after the serve, so a reload that reaches
            # one after its last request still applies (it would otherwise
            # race the shutdown and be refused)
            results, report = router.serve(reqs, shutdown=False)
            t.join(timeout=70)
            assert not t.is_alive()
        finally:
            stop.set()
        assert sum(report.finish_reasons.values()) == len(reqs)
        assert report.lost_requests == 0
        assert acks_box and all(a.get("ok") for a in acks_box.values()), acks_box
    finally:
        router.terminate()
    with pytest.raises(RuntimeError, match="no live ready replica"):
        router.reload(dir_b, timeout_s=1)


@pytest.mark.timeout(280)
def test_fleet_spawn_error_never_falls_back_to_cpu():
    """A spec that asks for the card on a machine without one: every
    worker reports a spawn error and dies, nothing is served on the CPU,
    and the stranded requests fail loudly as lost."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the spec would serve on it")
    reqs = synthetic_requests(2, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=6, rng=np.random.default_rng(4))
    router = _router(dataclasses.replace(_spec(), device="cuda"), replicas=1,
                     max_restarts=0)
    try:
        results, report = router.serve(reqs)
    finally:
        router.terminate()
    assert report.spawn_errors and "CUDA" in report.spawn_errors[0]
    assert report.completed_ok == 0 and report.lost_requests == len(reqs)
    assert all(r.finish_reason == "error" for r in results)


@pytest.mark.timeout(280)
def test_fleet_restart_comes_ready_between_serves():
    """``wait_ready`` pumps the outbox between serves until the restarted
    replica is up; a later ``serve([])`` shuts both incarnations' successors
    down cleanly, and the report keeps the dead incarnation's handshake."""
    reqs = synthetic_requests(4, vocab_size=FLEET_MODEL["vocab_size"],
                              max_prompt=8, rng=np.random.default_rng(6))
    router = _ready_router(_spec(), replicas=2, max_restarts=1,
                           faults="replica_death@2")
    try:
        results, report = router.serve(reqs, shutdown=False)
        assert report.replica_deaths == 1 and report.restarts == 1
        assert report.completed_ok == len(reqs) and report.lost_requests == 0
        assert router.wait_ready(READY_S)
        _, end = router.serve([])
    finally:
        router.terminate()
    ready = [i for i in end.worker_info.values() if "spawn_to_ready_s" in i]
    assert len(end.worker_info) == 3 and len(ready) == 3
    assert all(rep is not None and rep["jax_loaded"] is False
               for rep in end.replica_reports)
    _assert_workers_jax_free(end)
    assert {r.uid: list(r.tokens) for r in results} == _engine_tokens(
        _seed_params(), reqs)

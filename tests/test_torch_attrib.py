"""The port's program cost attribution (``obs/attrib.py``), artifact schema
(``obs/schema.py``) and perf trajectory (``obs/history.py``), held to the
JAX package's on the CPU.

The reference runs as its own tests run it (``tests/test_attrib.py``,
``tests/test_obs.py``): ``tracked_jit`` over ``jax.jit`` programs and
``Lowered.cost_analysis()`` on the CPU backend.  Tolerances:

- a matrix product's FLOPs are equal (2 x M x N x K on both sides);
- a one-layer LM's serving programs: the port counts the matrix products
  exactly (held to the analytic count, 0 tolerance) and XLA adds its
  elementwise work, so ``0.75 <= port / reference <= 1`` — XLA's
  elementwise count (13-20% of its total at this width) sits inside that
  band; one layer because XLA counts a scanned layer stack's body once;
- ``bytes_accessed``: the reference's figure is XLA's pre-optimization
  count, HLO op by HLO op, and the port's counts ATen operations (one for
  a layer norm or a softmax, several HLO ops each), so the port's is at
  most the reference's (the ordering the module docstring states).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.obs import attrib as jattrib
from distributeddeeplearning_tpu.obs import history as jhistory
from distributeddeeplearning_tpu.obs import schema as jschema
from distributeddeeplearning_tpu.serve.engine import InferenceEngine as JDense
from distributeddeeplearning_tpu.serve.engine import PagedInferenceEngine as JPaged
from distributeddeeplearning_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JScheduler,
)
from distributeddeeplearning_tpu.serve.scheduler import synthetic_requests as jrequests
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.obs import attrib
from distributeddeeplearning_tpu_torch.obs import history as thistory
from distributeddeeplearning_tpu_torch.obs import schema as tschema
from distributeddeeplearning_tpu_torch.obs import trace as trace_mod
from distributeddeeplearning_tpu_torch.obs.recorder import (
    FlightRecorder,
    register_dump_context,
)
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagedInferenceEngine,
    synthetic_requests,
)
from distributeddeeplearning_tpu_torch.spec import SpeculativeDecoder
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(num_layers=1, d_model=32, num_heads=4, d_ff=64, vocab_size=61)
MAX_SEQ, SLOTS, PAGE = 48, 2, 8


@pytest.fixture(autouse=True)
def fresh_programs():
    """Each test's programs in registries of their own (both packages)."""
    old_t, old_j = attrib.get_programs(), jattrib.get_programs()
    attrib.set_programs(attrib.ProgramCostRegistry())
    jattrib.set_programs(jattrib.ProgramCostRegistry())
    yield
    attrib.set_programs(old_t)
    jattrib.set_programs(old_j)


# --- the registry ------------------------------------------------------------


def test_one_signature_per_new_shape_set_and_matmul_flops_match_xla():
    treg, jreg = attrib.ProgramCostRegistry(), jattrib.ProgramCostRegistry()
    tfn = treg.track("t.matmul", lambda a, b: a @ b)
    jfn = jreg.track("t.matmul", jax.jit(lambda a, b: a @ b))
    for n in (16, 16, 32):
        x = np.ones((n, n), np.float32)
        tfn(torch.from_numpy(x), torch.from_numpy(x))
        jfn(jnp.asarray(x), jnp.asarray(x))
    assert len(tfn.signatures) == len(jfn.signatures) == 2
    tflops = sorted(c.flops for c in tfn.collect())
    jflops = sorted(c.flops for c in jfn.collect())
    assert tflops == jflops == [2.0 * 16 ** 3, 2.0 * 32 ** 3]


def test_memory_columns_against_memory_analysis():
    treg, jreg = attrib.ProgramCostRegistry(), jattrib.ProgramCostRegistry()
    tfn = treg.track("t.add", lambda a: a + 1.0)
    jfn = jreg.track("t.add", jax.jit(lambda a: a + 1.0))
    tfn(torch.ones(64))
    jfn(jnp.ones((64,)))
    (t,) = tfn.collect(memory=True)
    (j,) = jfn.collect(memory=True)
    assert (t.argument_bytes, t.output_bytes) == (j.argument_bytes, j.output_bytes) == (256, 256)
    assert t.alias_bytes == 0
    # off the card there is no allocator peak: None, and the reason
    assert t.temp_bytes is None and "off the card" in t.error
    (plain,) = tfn.collect()
    assert plain.argument_bytes is None and plain.error is None


def test_in_place_program_records_and_collect_leaves_the_live_cache_bitwise():
    reg = attrib.ProgramCostRegistry()

    def write(cache, x, *, slot):
        cache["k"][slot] = x * 2.0
        return cache["k"].sum()

    fn = reg.track("t.donate", write, dynamic=("slot",))
    cache = {"k": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    for slot in range(3):  # a data argument: one signature
        fn(cache, torch.ones(8), slot=slot)
    assert len(fn.signatures) == 1
    before = cache["k"].clone()
    (cost,) = fn.collect(memory=True)
    assert cost.available
    assert torch.equal(cache["k"], before)  # bitwise: meta copies only
    assert cost.alias_bytes == 4 * 8 * 4  # the cache, written in place


def test_static_args_survive_rerunning():
    reg = attrib.ProgramCostRegistry()
    fn = reg.track("t.static", lambda a, flag: a * 2 if flag else a)
    fn(torch.ones(8), True)
    fn(torch.ones(8), False)
    costs = fn.collect()
    assert len(costs) == 2 and all(c.available and c.error is None for c in costs)
    assert sorted(c.bytes_accessed for c in costs) == [0.0, 64.0]


def test_attribute_forwarding():
    class Step:
        comm_overlap = True

        def __call__(self, x):
            return x + 1

        def wire_bytes(self):
            return {"total": 3}

    fn = attrib.ProgramCostRegistry().track("t.fwd", Step())
    assert fn.comm_overlap is True and fn.wire_bytes() == {"total": 3}
    assert torch.equal(fn(torch.zeros(2)), torch.ones(2))


def test_registry_holds_programs_weakly_and_skips_never_called():
    reg = attrib.ProgramCostRegistry()
    fn = reg.track("t.weak", lambda a: a)
    reg.track("t.nevercalled", lambda a: a)
    assert reg.names() == ["t.weak"]  # the never-called one is gone too
    assert reg.collect() == {}
    del fn
    gc.collect()
    assert reg.names() == []


def test_dump_table_never_reruns():
    calls = []

    def prog(a):
        calls.append(a.device.type)
        return a * 3

    reg = attrib.ProgramCostRegistry()
    fn = reg.track("t.dump", prog)
    fn(torch.ones(4))
    table = reg.dump_table()
    assert table and table[0]["name"] == "t.dump" and table[0]["available"] is False
    assert calls == ["cpu"]
    reg.collect()
    assert calls == ["cpu", "meta"]  # collect runs on meta, once
    assert reg.dump_table()[0]["available"] is True
    reg.dump_table()
    assert calls == ["cpu", "meta"]


def test_recorder_dump_carries_program_costs_and_survives_a_broken_provider():
    fn = attrib.tracked_jit("t.recorded", lambda a: a + 1)
    fn(torch.ones(2))
    payload = FlightRecorder(capacity=16).dump("unit_test")
    assert isinstance(payload["hbm_ledger"], dict)
    assert [row["name"] for row in payload["program_costs"]] == ["t.recorded"]

    def boom():
        raise RuntimeError("mid-crash provider")

    register_dump_context("broken_ctx", boom)
    try:
        payload = FlightRecorder(capacity=4).dump("unit_test")
        assert payload["broken_ctx"] is None
        assert payload["program_costs"][0]["name"] == "t.recorded"
    finally:
        register_dump_context("broken_ctx", None)


# --- FLOPs and bytes against XLA's cost model -------------------------------


def _lm_pair():
    jp = jpt.init_params(jax.random.key(0), max_len=MAX_SEQ, **LM)
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _serve_both(jp, tp):
    kw = dict(num_heads=LM["num_heads"], batch_slots=SLOTS, max_seq=MAX_SEQ)
    paged = dict(page_size=PAGE, prefill_chunk=PAGE)
    reqs = dict(vocab_size=LM["vocab_size"], max_prompt=12)
    # the registries hold programs weakly: the engines stay alive here
    jengines = (JDense(jp, **kw), JPaged(jp, **paged, **kw))
    for eng in jengines:
        JScheduler(eng, max_new_tokens=3).run(
            jrequests(3, rng=np.random.default_rng(0), **reqs))
    engines = (InferenceEngine(tp, device="cpu", **kw),
               PagedInferenceEngine(tp, device="cpu", **paged, **kw))
    for eng in engines:
        ContinuousBatchingScheduler(eng, max_new_tokens=3).run(
            synthetic_requests(3, rng=np.random.default_rng(0), **reqs))
    return jattrib.get_programs().collect(), attrib.get_programs().collect(memory=True)


def _decode_matmul_flops(slots):
    d, ff, v, h = LM["d_model"], LM["d_ff"], LM["vocab_size"], LM["num_heads"]
    weights = d * 3 * d + d * d + 2 * d * ff + d * v
    attention = 2 * 2 * h * MAX_SEQ * (d // h)  # QK and PV over the window
    return slots * (2 * weights + attention)


def _bytes_floor(name, cost, weights):
    """Bytes a program must move at least: a prefill reads the weights; a
    decode reads them and every slot's K/V window it attends; a chunk reads
    them and the pages its block table names (one slot's window); an
    insert reads its K/V source and writes as many bytes into the cache."""
    window = 2 * LM["num_layers"] * MAX_SEQ * LM["d_model"] * 4  # one slot's K and V
    if name.endswith(".insert"):
        return 2 * (cost.argument_bytes - SLOTS * window)
    return weights + {"prefill": 0, "decode": SLOTS * window,
                      "prefill_chunk": window}[name.rsplit(".", 1)[1]]


@pytest.mark.parametrize("name", ["serve.dense.float32.prefill",
                                  "serve.dense.float32.decode",
                                  "serve.dense.float32.insert",
                                  "serve.paged.float32.prefill_chunk"])
def test_flops_and_bytes_against_xla_cost_model(name):
    jp, tp = _lm_pair()
    weights = sum(t.nbytes for t in tstate.tree_leaves(tp))
    jcosts, tcosts = _serve_both(jp, tp)
    got = sorted(tcosts[name], key=lambda c: c.bytes_accessed)
    ref = sorted(jcosts[name], key=lambda c: c.bytes_accessed)
    assert len(got) == len(ref) >= 1  # the same buckets / chunk widths
    for t, j in zip(got, ref):
        if name.endswith(".insert"):  # a copy: XLA counts its index arithmetic
            assert t.flops == 0.0 and j.flops < 10
        else:
            assert 0.75 * j.flops <= t.flops <= j.flops, (t.flops, j.flops)
        # at least what the program must move, at most XLA's unfused count
        assert 0 < _bytes_floor(name, t, weights) <= t.bytes_accessed <= j.bytes_accessed
    if name.endswith(".decode"):
        assert got[0].flops == _decode_matmul_flops(SLOTS)


# --- the report ------------------------------------------------------------------


def _artifact(report, straggler):
    """The report framed as an ``ATTRIB_r*`` artifact (the reference's
    bench frame; the forecast and trajectory gates as that bench sets them
    when green)."""
    return {"metric": "attrib_programs_covered",
            "value": report["programs_covered"], "unit": "programs",
            "bench_revision": 24, "platform": "cpu", "virtual_pod": False,
            **report, "straggler": straggler,
            "gates": {**report["gates"], "forecast_backpressure": True,
                      "trajectory_green": True}}


def test_self_check_on_the_cpu_and_the_schema_verdicts():
    tracer = trace_mod.configure(enabled=True, annotate=False)
    try:
        ok, report = attrib.self_check(device="cpu")
    finally:
        trace_mod.configure(enabled=False)
    assert ok, report["gates"]
    assert report["expected_programs_missing"] == []
    for name in ("serve.dense.float32.prefill", "serve.dense.float32.decode",
                 "serve.paged.float32.prefill_chunk", "serve.paged.float32.decode",
                 "spec.paged.verify"):
        assert report["programs"][name]["flops"] > 0, name
    # no live-bytes counter off the card: not measured, never passed
    assert report["not_measured"] == ["owner_totals_match_live",
                                      "residual_under_limit"]
    assert report["owner_match_pct"] is None and report["unaccounted_hbm_pct"] is None
    assert report["peaks_source"].startswith("no card")
    roof = report["programs"]["serve.dense.float32.decode"]["roofline"]
    assert roof["roofline_available"] is False
    straggler = attrib.straggler_report([tracer.to_chrome_trace()])
    assert straggler["negative_spans"] == 0
    assert "serve/decode_step" in straggler["phases"]
    payload = json.loads(json.dumps(_artifact(report, straggler)))
    with pytest.raises(tschema.SchemaError) as tport:
        tschema.validate_attrib_payload(payload)
    with pytest.raises(jschema.SchemaError) as tref:
        jschema.validate_attrib_payload(payload)
    assert str(tport.value) == str(tref.value)
    # ... and the only violations are the unmeasured reconciliation's
    clauses = str(tport.value).split("; ")
    assert [c.split(" ")[0] for c in clauses] == [
        "ledger.live_bytes", "unaccounted_hbm_pct",
        "gates.owner_totals_match_live", "gates.residual_under_limit"]
    # with the reconciliation a card would measure, both accept it
    payload["ledger"].update(live_bytes=payload["ledger"]["total_bytes"],
                             unaccounted_pct=0.0)
    payload["unaccounted_hbm_pct"] = 0.0
    payload["gates"].update(owner_totals_match_live=True, residual_under_limit=True)
    tschema.validate_attrib_payload(payload)
    jschema.validate_attrib_payload(payload)


def test_reference_peaks_state_none_off_the_card():
    assert attrib.reference_peaks() == (
        None, None, "no card: no peaks are stated off the card")
    assert attrib.reference_peaks("NVIDIA H100 80GB HBM3")[:2] == (989.4, 3350.0)
    assert attrib.reference_peaks("NVIDIA A10")[0] is None


# --- pure functions against the reference ----------------------------------------


def _shard(process_name, pid, spans, epoch_shift_s=0.0):
    return {
        "traceEvents": [{"ph": "M", "name": "process_name", "pid": pid,
                         "args": {"name": process_name}}]
        + [{"ph": "X", "name": name, "cat": "host", "pid": pid, "tid": 1,
            "ts": ts, "dur": dur, "args": {}} for name, ts, dur in spans],
        "metadata": {"tracer_epoch_unix_s": 1e9 + epoch_shift_s,
                     "host_pids": [pid], "process_name": process_name},
    }


STRAGGLER_CASES = {
    "slowest-host": ([_shard("host-a", 11, [("train/step", 0.0, 1000.0),
                                            ("train/step", 2000.0, 1200.0)]),
                      _shard("host-b", 22, [("train/step", 0.0, 3000.0),
                                            ("train/step", 4000.0, 3400.0)])],
                     ("train/step",)),
    "skew": ([_shard("a", 1, [("serve/decode_step", 100.0, 500.0)], -3600.0),
              _shard("b", 2, [("serve/decode_step", 100.0, 900.0)], 7200.0)],
             ("serve/decode_step",)),
    "colliding-pids": ([_shard("host-a", 1, [("train/step", 0.0, 1000.0)]),
                        _shard("host-b", 1, [("train/step", 0.0, 3000.0)])], None),
    "bare-list": ([_shard("host-c", 7, [("train/step", 0.0, 500.0)])["traceEvents"]],
                  None),
    "bare-dict": ([{"displayTimeUnit": "ms"}], None),
    "negative": ([_shard("h", 3, [("serve/spec_step", 0.0, -5.0),
                                  ("serve/prefill_chunk", 1.0, 7.0)])], None),
}


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_report_and_phase_stats_match_the_reference(case):
    shards, phases = STRAGGLER_CASES[case]
    kw = {} if phases is None else {"phases": phases}
    assert attrib.straggler_report(shards, **kw) == jattrib.straggler_report(shards, **kw)
    events = [e for s in shards for e in (s.get("traceEvents", []) if isinstance(s, dict)
                                          else s)]
    assert attrib.step_phase_stats(events, **kw) == jattrib.step_phase_stats(events, **kw)


@pytest.mark.parametrize("args,kw", [
    ((1e12, 1e9), dict(peak_flops=1e12, interconnect_gbps=1.0, measured_step_s=4.0)),
    ((3e11, 5e10), dict(peak_flops=1e12, interconnect_gbps=50.0)),
    ((0.0, 0.0), dict(peak_flops=0.0, interconnect_gbps=0.0, measured_step_s=1.0)),
])
def test_compute_collective_split_matches_the_reference(args, kw):
    assert attrib.compute_collective_split(*args, **kw) == \
        jattrib.compute_collective_split(*args, **kw)


# --- artifact schema and trajectory ------------------------------------------


def _verdict(validate, path):
    try:
        validate(str(path))
    except Exception as exc:  # noqa: BLE001 — the verdict is the message
        return type(exc).__name__, str(exc)
    return "ok", ""


def _mutations():
    """(file name, payload) rejections the reference's tests pin, written
    by the test itself."""
    with open(os.path.join(REPO, "ATTRIB_r18.json")) as f:
        attrib_art = json.load(f)
    residual = json.loads(json.dumps(attrib_art))
    residual["unaccounted_hbm_pct"] = 40.0
    negative = json.loads(json.dumps(attrib_art))
    negative["straggler"]["negative_spans"] = 2
    no_gate = json.loads(json.dumps(attrib_art))
    del no_gate["gates"]["forecast_backpressure"]
    return [
        ("OBS_r99.json", json.dumps({"metric": "m", "value": 1, "unit": "x"})),
        ("X_r99.json", "{nope"),
        ("S_r99.json", json.dumps({"ttft_s": {"p50": 2.0, "p99": 1.0}})),
        ("ATTRIB_r97.json", json.dumps(residual)),
        ("ATTRIB_r98.json", json.dumps(negative)),
        ("ATTRIB_r99.json", json.dumps(no_gate)),
        ("E_r99.json", "{}"),
        ("M_r99.json", json.dumps({"metric": "m"})),
    ]


def test_validate_artifact_verdicts_match_the_reference(tmp_path):
    """Every committed revision artifact (each validator's accept case,
    copied into ``tmp_path``) and every rejection the reference's tests
    pin: the same verdict and the same message."""
    names = sorted(n for n in os.listdir(REPO) if "_r" in n and n.endswith(".json"))
    assert len(names) >= 30
    for name in names:
        shutil.copy(os.path.join(REPO, name), tmp_path / name)
    for name, text in _mutations():
        (tmp_path / name).write_text(text)
    kinds = set()
    for name in sorted(os.listdir(tmp_path)):
        got = _verdict(tschema.validate_artifact, tmp_path / name)
        assert got == _verdict(jschema.validate_artifact, tmp_path / name), name
        kinds.add(got[0])
    assert kinds == {"ok", "SchemaError"}
    assert [p for p, _ in tschema._PREFIX_VALIDATORS] == \
        [p for p, _ in jschema._PREFIX_VALIDATORS]


def _trajectory(tmp_path, r02=100.0):
    def write(name, payload):
        (tmp_path / name).write_text(payload if isinstance(payload, str)
                                     else json.dumps(payload))

    write("PERF_r01.json", {"metric": "tok", "value": 100.0, "unit": "tok/s",
                            "decode_tokens_per_sec": 100.0})
    write("PERF_r02.json", {"metric": "tok", "value": r02, "unit": "tok/s",
                            "decode_tokens_per_sec": r02})
    write("PERF_r03.json", '{"metric": "tok", "val')  # truncated mid-dump
    write("PERF_r04.json", "{}")  # empty container
    write("A_r01.json", {"metric": "m", "value": 1.0, "unit": "u",
                         "programs_covered": 10, "unaccounted_hbm_pct": 1.0})
    write("A_r02.json", {"metric": "m", "value": 1.0, "unit": "u",
                         "programs_covered": 9, "unaccounted_hbm_pct": 4.0})


def _as_tuples(x):
    return json.loads(json.dumps(x, default=lambda o: o.__dict__))


@pytest.mark.parametrize("r02", [100.0, 50.0])
def test_history_matches_the_reference(tmp_path, r02):
    _trajectory(tmp_path, r02)
    root = str(tmp_path)
    out = {}
    for tag, mod in (("port", thistory), ("ref", jhistory)):
        skipped = []
        points = mod.load_points(root, skipped=skipped)
        timeline = mod.build_timeline(points)
        regressions = mod.check_gates(timeline)
        out[tag] = (_as_tuples(points), skipped,
                    _as_tuples([r.describe() for r in regressions]),
                    mod.render_text(timeline, regressions),
                    _as_tuples(mod.timeline_digest(timeline, regressions)),
                    mod.run_history(root, gate=True))
    assert out["port"] == out["ref"]
    rc, text = out["port"][-1]
    assert "skipped malformed artifact" in text and "PERF_r03.json" in text
    assert "programs_covered" in text and rc == 1
    assert ("REGRESSION" in text) and (r02 < 100.0) == ("decode_tokens_per_sec" in
                                                        " ".join(out["port"][2]))
    assert {k: dataclasses.astuple(t) for k, t in thistory.TOLERANCES.items()} == \
        {k: dataclasses.astuple(t) for k, t in jhistory.TOLERANCES.items()}
    assert thistory.sparkline([1.0, 3.0, 2.0]) == jhistory.sparkline([1.0, 3.0, 2.0])


# --- the hooks -------------------------------------------------------------------


def _tiny_params():
    return tpt.init_params(torch.Generator().manual_seed(0), max_len=MAX_SEQ,
                           device="cpu", **{**LM, "num_layers": 2})


def _unhook(engine):
    """The engine with every tracked program replaced by its bare callable."""
    for name in ("_prefill_prog", "_insert_prog", "_decode_prog", "_scrub_prog",
                 "_chunk_prog"):
        prog = getattr(engine, name, None)
        if isinstance(prog, attrib.TrackedProgram):
            setattr(engine, name, prog._fn)
    return engine


def _requests(n=4):
    return synthetic_requests(n, vocab_size=LM["vocab_size"], max_prompt=12,
                              rng=np.random.default_rng(3))


@pytest.mark.parametrize("layout", ["dense", "paged", "paged-int8", "paged-spec"])
def test_hooked_engine_names_and_tokens_bitwise(layout):
    params = _tiny_params()
    kw = dict(num_heads=LM["num_heads"], batch_slots=SLOTS, max_seq=MAX_SEQ,
              device="cpu")
    if layout == "dense":
        make = lambda: InferenceEngine(params, **kw)  # noqa: E731
    else:
        make = lambda: PagedInferenceEngine(  # noqa: E731
            params, page_size=PAGE, prefill_chunk=PAGE,
            cache_dtype="int8" if layout == "paged-int8" else None, **kw)
    outs, alive = [], []  # the registry holds programs weakly
    for hooked in (True, False):
        eng = make() if hooked else _unhook(make())
        alive.append(eng)
        spec = (SpeculativeDecoder(eng, draft_tokens=2, draft_layers=1)
                if layout == "paged-spec" else None)
        alive.append(spec)
        if spec is not None and not hooked:
            spec._verify_prog = spec._verify_prog._fn
            spec._rollback_prog = spec._rollback_prog._fn
        done, _ = ContinuousBatchingScheduler(
            eng, max_new_tokens=4, spec_decoder=spec).run(_requests())
        outs.append({r.uid: list(r.tokens) for r in done})
        if layout == "dense":
            eng.scrub_slot(0, 1)
    assert outs[0] == outs[1]
    names = set(attrib.get_programs().names())
    kv = "int8" if layout == "paged-int8" else "float32"
    if layout == "dense":
        want = {f"serve.dense.{kv}.{p}" for p in ("prefill", "insert", "decode", "scrub")}
    else:
        want = {f"serve.paged.{kv}.{p}" for p in ("prefill_chunk", "decode")}
    if layout == "paged-spec":
        want |= {"spec.paged.verify", "spec.paged.rollback"}
    assert want <= names, (want, names)


def test_spec_spans_match_the_reference_scheduler():
    jparams = jpt.init_params(jax.random.key(0), max_len=MAX_SEQ,
                              **{**LM, "num_layers": 2})
    tparams = tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    from distributeddeeplearning_tpu.obs import trace as jtrace
    from distributeddeeplearning_tpu.spec.decode import SpeculativeDecoder as JSpec

    kw = dict(num_heads=LM["num_heads"], batch_slots=SLOTS, max_seq=MAX_SEQ,
              page_size=PAGE, prefill_chunk=PAGE)
    jt = jtrace.configure(enabled=True, annotate=False)
    tt = trace_mod.configure(enabled=True, annotate=False)
    try:
        jeng = JPaged(jparams, **kw)
        JScheduler(jeng, max_new_tokens=4, spec_decoder=JSpec(
            jeng, draft_tokens=2, draft_layers=1)).run(_requests())
        teng = PagedInferenceEngine(tparams, device="cpu", **kw)
        ContinuousBatchingScheduler(teng, max_new_tokens=4, spec_decoder=SpeculativeDecoder(
            teng, draft_tokens=2, draft_layers=1)).run(_requests())
    finally:
        jtrace.configure(enabled=False)
        trace_mod.configure(enabled=False)

    def spans(events):
        return sorted({(e["name"], e["args"].get("k")) for e in events
                       if e.get("ph") == "X" and e["name"].startswith("serve/spec.")})

    assert spans(tt.events) == spans(jt.events) == [
        ("serve/spec.draft_dispatch", 2), ("serve/spec.verify_dispatch", None)]


def _lm_state(vocab=LM["vocab_size"]):
    params = _tiny_params()

    def apply_fn(p, toks, **_):
        return tpt.forward(p, toks % vocab, num_heads=LM["num_heads"],
                           attention="flash")

    return tstate.TrainState.create(params=params, apply_fn=apply_fn,
                                    tx=tstate.adamw(lambda step: 1e-3))


def _lm_loss(logits, labels, *, label_smoothing=0.0):
    return tpt.next_token_loss(logits, labels)


def _lm_metrics(logits, labels, loss):
    return {"loss": loss.float()}


def _live_state(state):
    """The host step and a copy of every tensor of the state: params, the
    optimizer's moments and count, BatchNorm statistics."""
    leaves = [x for x in attrib._leaves([state.params, state.opt_state,
                                         state.batch_stats], [])
              if isinstance(x, torch.Tensor)]
    return state.step, [t.detach().clone() for t in leaves]


def test_train_and_eval_steps_register_and_count_the_whole_step():
    from distributeddeeplearning_tpu_torch.utils.hardware import step_flops

    state = _lm_state()
    train = tstep.build_train_step(state, compute_dtype=torch.float32,
                                   loss_fn=_lm_loss, metrics_fn=_lm_metrics)
    evaluate = tstep.build_eval_step(state, compute_dtype=torch.float32,
                                     loss_fn=_lm_loss, metrics_fn=_lm_metrics)
    toks = np.random.default_rng(0).integers(0, LM["vocab_size"], (4, 16)).astype(np.int32)
    batch = {"input": toks, "label": toks}
    for _ in range(2):
        state, _ = train(state, batch)
    evaluate(state, batch)
    before = _live_state(state)
    costs = attrib.get_programs().collect(memory=True)
    assert set(costs) == {"train.step.implicit", "train.step.eval"}
    after = _live_state(state)  # collect touched no live state
    assert after[0] == before[0] and len(after[1]) == len(before[1]) > 0
    for got, want in zip(after[1], before[1]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    (step,) = costs["train.step.implicit"]
    # the whole step (forward + backward products): 3 x the forward, plus
    # the plain backward's recomputed scores (half the attention forward)
    B, S, H, D = 4, 16, LM["num_heads"], LM["d_model"] // LM["num_heads"]
    attention = 2 * 2 * 2 * B * H * S * S * D  # two layers, QK and PV
    assert step.flops == step_flops(state, batch, compute_dtype=torch.float32) \
        + 0.5 * attention
    assert step.alias_bytes > 0  # params and moments, updated in place
    assert costs["train.step.eval"][0].flops > 0
    overlap = tstep.build_train_step(state, comm_overlap=True,
                                     compute_dtype=torch.float32,
                                     loss_fn=_lm_loss, metrics_fn=_lm_metrics)
    assert isinstance(overlap._fn, attrib.TrackedProgram)
    assert overlap._fn.name == "train.step.comm_overlap"

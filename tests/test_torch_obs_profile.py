"""The port's profiling harness (``obs/profile.py``) held to the JAX
package's on the CPU: the host/profile merge, the timeline digest, the
decode phase breakdown and the regression attribution.

The reference runs as ``tests/test_obs.py`` and ``tests/test_spec.py`` run
it.  Pure functions are held to equality; the breakdown to the reference's
keys, its invariants and the tokens the scheduler serves after it (equal
to the reference's: greedy f32 on the CPU).
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.obs import profile as jprofile
from distributeddeeplearning_tpu.serve.engine import PagedInferenceEngine as JPaged
from distributeddeeplearning_tpu.serve.scheduler import (
    ContinuousBatchingScheduler as JScheduler,
)
from distributeddeeplearning_tpu.serve.scheduler import synthetic_requests as jrequests
from distributeddeeplearning_tpu.spec.decode import SpeculativeDecoder as JSpec
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.obs import fleet as tfleet
from distributeddeeplearning_tpu_torch.obs import profile
from distributeddeeplearning_tpu_torch.obs import trace as trace_mod
from distributeddeeplearning_tpu_torch.obs.trace import Tracer
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    PagedInferenceEngine,
    synthetic_requests,
)
from distributeddeeplearning_tpu_torch.spec import SpeculativeDecoder

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

LM = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=61)
KW = dict(num_heads=4, batch_slots=2, max_seq=48, page_size=8, prefill_chunk=8)


# --- the merge -----------------------------------------------------------------


def _profile_trace(host_pid, window_ts, *, kernels=((5.0, 2.0), (9.0, 3.0))):
    """A torch.profiler-format export: the planted window annotation and a
    cpu_op on the host pid, a Python frame, kernels on the card's pid 0."""
    events = [
        {"ph": "M", "name": "process_name", "pid": host_pid, "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "profile/window",
         "pid": host_pid, "tid": 1, "ts": window_ts, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": host_pid,
         "tid": 1, "ts": window_ts + 1.0, "dur": 3.0},
        {"ph": "X", "cat": "python_function", "name": "engine.py(321): decode",
         "pid": host_pid, "tid": 1, "ts": window_ts + 0.5, "dur": 10.0},
    ]
    events += [{"ph": "X", "cat": "kernel", "name": "flash_decode_split",
                "pid": 0, "tid": 7, "ts": window_ts + at, "dur": dur}
               for at, dur in kernels]
    return {"traceEvents": events}


def _traced_window(tmp_path, shift_us):
    tracer = Tracer(enabled=True, annotate=False)
    with tracer.span("profile/window"):
        with tracer.span("serve/decode_step"):
            pass
    (window,) = [e for e in tracer.events if e["name"] == "profile/window"]
    device = tmp_path / profile.DEVICE_SUBDIR
    device.mkdir()
    (device / "profile.1.trace.json").write_text(json.dumps(
        _profile_trace(tracer.pid, window["ts"] - shift_us)))
    return tracer, window


def test_merge_recovers_a_planted_clock_shift(tmp_path):
    shift = 1.7e12  # a profile clock in epoch microseconds
    tracer, window = _traced_window(tmp_path, shift)
    merged = profile.merge_host_device(tracer, str(tmp_path))
    meta = merged["metadata"]
    assert meta["device_trace"] == "merged" and "clock_alignment" not in meta
    assert meta["clock_offset_us"] == pytest.approx(shift)
    kernels = [e for e in merged["traceEvents"] if e.get("cat") == "kernel"]
    # (to the float64 spacing of epoch microseconds, ~2.4e-4 us)
    assert [e["ts"] - window["ts"] for e in kernels] == pytest.approx([5.0, 9.0],
                                                                       abs=1e-3)
    # the profile's host-side events leave the tracer's pid
    (cpu_op,) = [e for e in merged["traceEvents"] if e.get("cat") == "cpu_op"]
    assert cpu_op["pid"] == tracer.pid + 1
    assert {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"
            and e["pid"] == tracer.pid} == {tracer.pid}
    assert all(e.get("cat") != "user_annotation" or e["pid"] != tracer.pid
               for e in merged["traceEvents"])
    # Python frames are dropped unless asked for
    assert not [e for e in merged["traceEvents"] if e.get("cat") == "python_function"]
    kept = profile.merge_host_device(tracer, str(tmp_path), keep_python_frames=True)
    assert len([e for e in kept["traceEvents"] if e.get("cat") == "python_function"]) == 1
    digest = profile.summarize_timeline(merged)
    assert digest["event_counts"]["host_spans"] == 2
    assert digest["event_counts"]["device_events"] == 4  # 2 kernels, op, annotation


def test_merge_without_a_profile_reports_absent(tmp_path):
    tracer = Tracer(enabled=True, annotate=False)
    with tracer.span("x"):
        pass
    assert profile.merge_host_device(tracer, str(tmp_path))["metadata"][
        "device_trace"] == "absent"
    assert profile.merge_host_device(tracer, None)["metadata"]["device_trace"] == "absent"
    assert profile.device_analysis(str(tmp_path), steps=1)["available"] is False


def test_merge_falls_back_to_coarse_alignment(tmp_path):
    tracer = Tracer(enabled=True, annotate=False)
    with tracer.span("other/span"):
        pass
    device = tmp_path / profile.DEVICE_SUBDIR
    device.mkdir()
    (device / "p.trace.json").write_text(json.dumps(_profile_trace(tracer.pid, 100.0)))
    meta = profile.merge_host_device(tracer, str(tmp_path))["metadata"]
    assert meta["clock_alignment"] == "coarse (no shared span name)"


def test_profile_and_merge_on_the_cpu(tmp_path):
    """A real torch.profiler window: the tracer's planted span name aligns
    the clocks (not the coarse fallback); the CPU profile has no kernel,
    so the roofline table reports itself unavailable, not an error."""
    tracer = Tracer(enabled=False)
    result, _, merged, path = profile.profile_and_merge(
        lambda: torch.ones(64, 64) @ torch.ones(64, 64), trace_dir=str(tmp_path),
        tracer=tracer)
    assert result.shape == (64, 64) and tracer.enabled is False
    meta = merged["metadata"]
    assert meta["device_trace"] == "merged" and "clock_alignment" not in meta
    with open(path) as f:
        assert json.load(f)["metadata"]["clock_offset_us"] == meta["clock_offset_us"]
    window = [e for e in merged["traceEvents"] if e.get("name") == "profile/window"]
    host = [e for e in window if e["pid"] == tracer.pid]
    prof = [e for e in window if e["pid"] != tracer.pid]
    assert len(host) == 1 and prof and prof[0]["ts"] == pytest.approx(host[0]["ts"])
    assert profile.summarize_timeline(merged)["event_counts"]["device_events"] > 0
    assert profile.device_analysis(str(tmp_path), steps=1)["available"] is False


# --- pure functions against the reference --------------------------------------


def _merged_fixture():
    return {
        "traceEvents": [
            {"ph": "M", "name": "process_name", "pid": 5, "args": {"name": "h"}},
            {"ph": "X", "name": "serve/decode_step", "pid": 5, "ts": 10.0, "dur": 900.0},
            {"ph": "X", "name": "serve/decode_step", "pid": 5, "ts": 1000.0, "dur": 1100.0},
            {"ph": "X", "name": "fusion.3", "pid": 9, "ts": 50.0, "dur": 300.0},
            {"ph": "X", "name": "k" * 100, "pid": 9, "ts": 60.0, "dur": 10.0},
            {"ph": "i", "name": "fleet/replica_died", "pid": 5, "ts": 2000.0,
             "args": {"replica": 1}},
        ],
        "metadata": {"host_pids": [5]},
    }


@pytest.mark.parametrize("limit", [1, 2, 120])
@pytest.mark.parametrize("meta", [True, False])
def test_summarize_timeline_matches_the_reference_and_fleet_reexports_it(limit, meta):
    merged = _merged_fixture()
    if not meta:
        merged.pop("metadata")
    assert profile.summarize_timeline(merged, limit=limit) == \
        jprofile.summarize_timeline(merged, limit=limit)
    assert tfleet.summarize_timeline is profile.summarize_timeline


OLD = {"decode_step_ms": 200.0,
       "phases_ms": {"page_gather": 5.0, "scale_dequant": 0.0,
                     "attention_mlp_other": 150.0}}
NEW = {"decode_step_ms": 210.0,
       "phases_ms": {"page_gather": 6.0, "scale_dequant": 0.0,
                     "attention_kernel": 90.0, "mlp_other": 80.0}}
NEW2 = dict(NEW, phases_ms=dict(NEW["phases_ms"], attention_kernel=120.0))
NONE = {"decode_step_ms": 1.0, "phases_ms": {"a": 1.0}}


@pytest.mark.parametrize("pair", [(OLD, NEW), (NEW, NEW2), (NEW2, NEW), (NONE, NEW)])
def test_attribute_regression_matches_the_reference(pair):
    got = profile.attribute_regression(*pair)
    assert got == jprofile.attribute_regression(*pair)
    if pair == (NEW, NEW2):
        assert got["hottest_phase"] == "attention_kernel"
        assert got["hottest_phase_delta_ms"] == 30.0


# --- the decode phase breakdown ------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jpt.init_params(jax.random.key(0), max_len=KW["max_seq"], **LM)
    return jp, tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _requests(seed):
    return synthetic_requests(3, vocab_size=LM["vocab_size"], max_prompt=12,
                              rng=np.random.default_rng(seed))


def _jrequests(seed):
    return jrequests(3, vocab_size=LM["vocab_size"], max_prompt=12,
                     rng=np.random.default_rng(seed))


@pytest.mark.parametrize("case", ["f32", "int8", "f32-spec"])
def test_decode_phase_breakdown_keys_invariants_and_next_tokens(params, case):
    jp, tp = params
    int8 = case == "int8"
    teng = PagedInferenceEngine(tp, device="cpu", cache_dtype="int8" if int8 else None,
                                **KW)
    jeng = JPaged(jp, cache_dtype=jax.numpy.int8 if int8 else None, **KW)
    ContinuousBatchingScheduler(teng, max_new_tokens=4).run(_requests(0))
    JScheduler(jeng, max_new_tokens=4).run(_jrequests(0))
    teng.prefill(0, [1, 2, 3], max_new_tokens=4)  # a live slot's pages
    jeng.prefill(0, [1, 2, 3], max_new_tokens=4)
    spec = case.endswith("spec")
    tspec = SpeculativeDecoder(teng, draft_tokens=2, draft_layers=1) if spec else None
    jspec = JSpec(jeng, draft_tokens=2, draft_layers=1) if spec else None
    got = profile.decode_phase_breakdown(teng, iters=2, warmup=1, spec_decoder=tspec)
    want = jprofile.decode_phase_breakdown(jeng, iters=2, warmup=1, spec_decoder=jspec)
    assert set(got) == set(want) and set(got["phases_ms"]) == set(want["phases_ms"])
    for key in ("kv_dtype", "weights_dtype", "iters"):
        assert got[key] == want[key], key
    ph = got["phases_ms"]
    # the whole step is attention + the rest, to rounding (the rest is
    # clamped at 0 when the attention loop outran the step)
    assert ph["attention_kernel"] + ph["mlp_other"] == pytest.approx(
        max(got["decode_step_ms"], ph["attention_kernel"]), abs=2e-3)
    # f32 pages have no dequant; int8's is a timed increment, >= 0
    assert ph["scale_dequant"] >= 0.0 and (int8 or ph["scale_dequant"] == 0.0)
    if spec:
        assert got["tokens_per_verify"] >= 1.0 and got["ms_per_committed_token"] > 0
        assert got["drafter"] == want["drafter"] and got["draft_tokens"] == 2
    # the scheduler's next tokens after the breakdown, as the reference's
    teng.release(0)
    jeng.release(0)
    tdone, _ = ContinuousBatchingScheduler(teng, max_new_tokens=4).run(_requests(1))
    jdone, _ = JScheduler(jeng, max_new_tokens=4).run(_jrequests(1))
    assert {r.uid: list(r.tokens) for r in tdone} == \
        {r.uid: [int(t) for t in r.tokens] for r in jdone}


def test_breakdown_spans_reach_the_process_tracer(params):
    _, tp = params
    teng = PagedInferenceEngine(tp, device="cpu", **KW)
    tracer = trace_mod.configure(enabled=True, annotate=False)
    try:
        ContinuousBatchingScheduler(teng, max_new_tokens=2).run(_requests(2))
        profile.decode_phase_breakdown(teng, iters=1, warmup=0)
    finally:
        trace_mod.configure(enabled=False)
    names = {e["name"] for e in tracer.events}
    assert {"serve/engine.decode_dispatch", "serve/decode_step"} <= names

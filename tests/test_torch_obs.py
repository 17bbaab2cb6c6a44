"""The port's observability (``obs/registry.py``, ``obs/trace.py``,
``obs/recorder.py``, TensorBoard's scalars) against the JAX package's, on
the CPU.

The same counter, gauge and histogram operations give the same registry
snapshots and mergeable states (timestamps and pids aside: they are the
process's own), ``merge_states`` folds them the same way, the same span
and event calls give the same tracer events (clock fields aside), the
flight recorder rings and dumps alike, and the trainer's TensorBoard
scalars — JSONL in the port, an event file in the reference — carry the
same (tag, value, step), values equal after the event file's float32
rounding.  Percentiles are exact equalities: both sides bucket with the
same arithmetic.
"""

from __future__ import annotations

import json
import math
import random

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.obs import recorder as jrec
from distributeddeeplearning_tpu.obs import registry as jreg
from distributeddeeplearning_tpu.obs import trace as jtrace
from distributeddeeplearning_tpu_torch.obs import recorder as trec
from distributeddeeplearning_tpu_torch.obs import registry as treg
from distributeddeeplearning_tpu_torch.obs import trace as ttrace
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.utils import faults as tfaults

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CLOCK = ("ts", "pid", "updated_at")


def _strip(row):
    """A snapshot or state without the process's clock and identity."""
    if isinstance(row, dict):
        return {k: _strip(v) for k, v in row.items() if k not in CLOCK}
    return row


def _drive(module, seed):
    """One registry through a seeded sequence of operations."""
    reg = module.MetricsRegistry(replica_id=seed, process_name=f"p{seed}")
    rng = random.Random(seed)
    for i in range(300):
        op = rng.random()
        if op < 0.3:
            reg.counter(f"c{i % 3}").inc(rng.randint(1, 4))
        elif op < 0.5:
            reg.gauge(f"g{i % 2}").set(rng.uniform(-5, 5))
        else:
            x = rng.choice([0.0, -1.0, rng.expovariate(3.0), rng.uniform(1e-6, 1e3)])
            reg.histogram(f"h{i % 4}", max_rel_err=0.01 if i % 4 else 0.05).record(x)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_and_states_equal_the_reference(seed):
    got, want = _drive(treg, seed), _drive(jreg, seed)
    assert _strip(got.snapshot(epoch=3)) == _strip(want.snapshot(epoch=3))
    assert _strip(got.state()) == _strip(want.state())


def test_merge_states_equals_the_reference():
    """Each package merges the other's shipped states: one fleet view."""
    tstates = [_drive(treg, s).state() for s in range(3)]
    jstates = [_drive(jreg, s).state() for s in range(3)]
    got, want = treg.merge_states(jstates), jreg.merge_states(tstates)
    assert _strip(got.snapshot()) == _strip(want.snapshot())
    assert _strip(got.state()) == _strip(want.state())


def test_histogram_merge_equals_recording_every_sample():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(size=2000).tolist() + [0.0] * 5
    whole, a, b = treg.Histogram("x"), treg.Histogram("x"), treg.Histogram("x")
    whole.record_many(xs)
    a.record_many(xs[::2])
    b.record_many(xs[1::2])
    a.merge(b)
    assert a.state()["buckets"] == whole.state()["buckets"]
    assert a.snapshot() == whole.snapshot()
    back = treg.Histogram.from_state(json.loads(json.dumps(a.state())))
    assert back.snapshot() == whole.snapshot()
    with pytest.raises(ValueError, match="error bounds"):
        a.merge(treg.Histogram("y", max_rel_err=0.05))
    empty = treg.Histogram.from_state(treg.Histogram("e").state())
    assert empty.count == 0 and math.isinf(empty.min)


def test_write_snapshot_retries_injected_io_errors_then_drops(tmp_path):
    """Site ``obs``: a transient injected failure is retried and the row
    lands; a plan that fails every time drops the row, counted."""
    reg = treg.MetricsRegistry()
    reg.counter("steps").inc(5)
    path = tmp_path / "obs.jsonl"
    tfaults.install_plan("io_error@1")
    try:
        assert reg.write_snapshot(str(path), epoch=1)
        tfaults.install_plan("io_error@p=1.0")
        assert not reg.write_snapshot(str(path), epoch=2)
    finally:
        tfaults.install_plan("")
    rows = [json.loads(x) for x in open(path)]
    assert [r["epoch"] for r in rows] == [1] and rows[0]["counters"]["steps"] == 5
    assert (reg.snapshots_written, reg.snapshots_dropped) == (1, 1)
    assert treg.get_registry().counter(
        f"retry.giveups.obs_snapshot_({path})").value >= 1


def _trace_calls(module, rec_module):
    rec = rec_module.FlightRecorder(capacity=4)
    tr = module.Tracer(enabled=True, pid=7, process_name="host", recorder=rec)
    with tr.span("train/step", step=1):
        with tr.span("ckpt/save", cat="io", step=1):
            tr.event("resilience/preempted", cat="resilience", step=1)
    with tr.span("train/data_wait", step=2):
        pass
    tr.event("resilience/rollback", step=2, to_step=0)
    return tr, rec


def _events(tr):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in tr.to_chrome_trace()["traceEvents"]]


def test_tracer_events_equal_the_reference():
    got, grec = _trace_calls(ttrace, trec)
    want, wrec = _trace_calls(jtrace, jrec)
    assert _events(got) == _events(want)
    assert [e["args"]["depth"] for e in got.events if e["ph"] == "X"] == [1, 0, 0]
    meta = got.to_chrome_trace()["metadata"]
    assert meta["host_pids"] == [7] and meta["process_name"] == "host"
    strip = lambda es: [{k: v for k, v in e.items() if k != "ts_us" and k != "dur_us"}  # noqa: E731
                        for e in es]
    assert strip(grec.entries()) == strip(wrec.entries())
    assert len(grec) == 4 and grec.records_total == 5  # the ring is bounded


def test_a_disabled_tracer_is_a_shared_no_op_or_the_recorder_span():
    bare = ttrace.Tracer(enabled=False)
    assert bare.span("a") is bare.span("b")
    bare.event("x")
    assert bare.events == []
    rec = trec.FlightRecorder()
    with ttrace.Tracer(enabled=False, recorder=rec).span("train/step", step=3):
        pass
    assert [e["name"] for e in rec.entries()] == ["train/step"]


def test_an_enabled_span_shows_up_in_a_torch_profile(tmp_path):
    """The port binds ``torch.profiler.record_function``: inside a profiler
    window each span is a named host range."""
    from torch.profiler import ProfilerActivity, profile

    tr = ttrace.Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("train/step", step=1):
            torch.ones(8).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "train/step" in names
    out = tmp_path / "host.json"
    assert tr.export(str(out)) == str(out)
    assert json.load(open(out))["traceEvents"][1]["name"] == "train/step"


def test_the_process_tracer_feeds_the_process_recorder():
    prev_rec, prev_tr = trec.get_recorder(), ttrace.get_tracer()
    try:
        rec = trec.set_recorder(trec.FlightRecorder(capacity=8))
        tr = ttrace.configure(enabled=False)
        tr.event("resilience/anomalous_step", step=4)
        treg.MetricsRegistry().counter("train.steps").inc(3)
        kinds = [(e["kind"], e["name"]) for e in rec.entries()]
        assert kinds == [("event", "resilience/anomalous_step"),
                         ("metric", "train.steps")]
        trec.register_dump_context("ctx", lambda: {"k": 1})
        trec.register_dump_context("bad", lambda: 1 / 0)
        dump = rec.dump("watchdog_fired", step=4)
        assert dump["ctx"] == {"k": 1} and dump["bad"] is None and dump["step"] == 4
        assert rec.drain_dumps() == [dump] and rec.dumps == []
    finally:
        trec.register_dump_context("ctx", None)
        trec.register_dump_context("bad", None)
        trec.set_recorder(prev_rec)
        ttrace.set_tracer(prev_tr)


def test_tensorboard_scalars_equal_the_reference_event_file(tmp_path):
    """The same scalars through the reference's ``TensorBoardLogger`` (a
    tf.summary event file) and the port's (``scalars.jsonl``)."""
    tf = pytest.importorskip("tensorflow")
    from distributeddeeplearning_tpu.train.loop import TensorBoardLogger as JTB

    epochs = [({"loss": 2.5, "top1": 0.125, "anomalous_steps": 1.0}, {"loss": 2.75}),
              ({"loss": 1.0 / 3.0, "top1": 0.5}, {"loss": 0.1})]
    jtb, ttb = JTB(str(tmp_path / "ref")), tloop.TensorBoardLogger(str(tmp_path / "port"))
    for epoch, (train, val) in enumerate(epochs):
        for tb in (jtb, ttb):
            tb.scalars("train", train, epoch)
            tb.scalars("val", val, epoch)
    jtb.flush()
    want = []
    for path in sorted((tmp_path / "ref").iterdir()):
        for event in tf.compat.v1.train.summary_iterator(str(path)):
            for v in event.summary.value:
                want.append((v.tag, float(tf.make_ndarray(v.tensor)), int(event.step)))
    rows = [json.loads(x) for x in open(tmp_path / "port" / tloop.SCALARS_NAME)]
    got = [(r["tag"], float(np.float32(r["value"])), r["step"]) for r in rows]
    assert got == want and len(got) == 7

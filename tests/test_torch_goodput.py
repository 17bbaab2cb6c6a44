"""The port's goodput ledger (``obs/goodput.py``) against the JAX package's,
on the CPU.

The same mark sequence under a patched clock gives the same segment rows,
key for key (the pid aside); each package's ``stitch`` reads the other's
file to the same summary; the redone-step accounting follows the run
lineage across incarnations; ``supervise`` interleaves its ``restart``
rows; the residual gate trips on an accounting gap.  Exact equalities
throughout: the clock is fake.
"""

from __future__ import annotations

import json

import pytest
import torch

from distributeddeeplearning_tpu.obs import goodput as jgood
from distributeddeeplearning_tpu.train import resilience as jres
from distributeddeeplearning_tpu_torch.obs import goodput as tgood
from distributeddeeplearning_tpu_torch.train import resilience as tres
from distributeddeeplearning_tpu_torch.utils import faults as tfaults

torch.set_num_threads(2)  # the suite runs six workers on eight cores


class FakeClock:
    """``time`` stand-in: perf_counter and time advance only by ``tick``."""

    def __init__(self, wall=1.7e9):
        self.now = 100.0
        self.wall0 = wall

    def tick(self, s):
        self.now += s

    def perf_counter(self):
        return self.now

    def monotonic(self):
        return self.now

    def time(self):
        return self.wall0 + self.now


def _incarnation(module, path, clock, *, resumed, steps, reason="completed",
                 gap=0.0):
    """One fit attempt's marks, the trainer's order: recovery, then per step
    data_wait + the step, a checkpoint, eval, an epoch rollup."""
    clock.tick(gap)
    ledger = module.GoodputLedger(str(path))
    ledger.begin()
    if resumed:
        ledger.set_resumed_step(resumed)
    else:
        ledger.fresh_start()
    clock.tick(0.5)
    ledger.mark("recovery")
    for i, step in enumerate(steps):
        clock.tick(0.01 * (i + 1))
        ledger.mark("data_wait")
        clock.tick(0.25 if i == 0 else 0.1)
        ledger.mark_step(step)
        if step % 3 == 0:
            clock.tick(0.07)
            ledger.mark("checkpoint_blocking")
            ledger.note("ckpt_save_block_s", 0.05)
    clock.tick(0.2)
    ledger.mark("eval")
    clock.tick(0.03)
    return ledger.end(reason)


def _run(module, path, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(module, "time", clock)
    segs = [_incarnation(module, path, clock, resumed=0, steps=[1, 2, 3, 4, 5],
                         reason="PreemptionError"),
            _incarnation(module, path, clock, resumed=3, steps=[4, 5, 6, 7, 8],
                         gap=1.5)]
    return segs


def _no_pid(row):
    return {k: v for k, v in row.items() if k != "pid"}


def test_segment_rows_equal_the_reference(tmp_path, monkeypatch):
    got = _run(tgood, tmp_path / "port.jsonl", monkeypatch)
    want = _run(jgood, tmp_path / "ref.jsonl", monkeypatch)
    assert [_no_pid(r) for r in got] == [_no_pid(r) for r in want]
    rows = [json.loads(x) for x in open(tmp_path / "port.jsonl")]
    assert [_no_pid(r) for r in rows] == [_no_pid(r) for r in want]
    second = got[1]
    assert second["counts"] == {"steps": 5, "steps_redone": 2}
    assert second["incarnation"] == 1 and second["run"] == 0


def _summary(module, path):
    out = module.summarize_ledger(module.stitch(str(path)))
    return out


def test_each_stitch_reads_the_other_packages_file(tmp_path, monkeypatch):
    _run(tgood, tmp_path / "port.jsonl", monkeypatch)
    _run(jgood, tmp_path / "ref.jsonl", monkeypatch)
    for path in (tmp_path / "port.jsonl", tmp_path / "ref.jsonl"):
        got, want = _summary(tgood, path), _summary(jgood, path)
        assert got == want
        assert got["residual_under_limit"] and got["unaccounted_pct"] < 1e-6
        assert got["mfu"] is None and got["mfu_omitted_reason"] == "flops_per_step unknown"
        assert got["seconds"]["recovery"] == pytest.approx(1.0 + 1.5)
        assert got["counts"]["steps_redone"] == 2
    a = tgood.stitch(str(tmp_path / "port.jsonl"))
    b = jgood.stitch(str(tmp_path / "ref.jsonl"))
    strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                       if k not in ("segment_rows", "restart_rows")}
    assert strip(a) == strip(b)


def test_a_fresh_run_on_a_reused_file_is_a_new_lineage(tmp_path, monkeypatch):
    path = tmp_path / "g.jsonl"
    clock = FakeClock()
    monkeypatch.setattr(tgood, "time", clock)
    _incarnation(tgood, path, clock, resumed=0, steps=[1, 2, 3])
    seg = _incarnation(tgood, path, clock, resumed=0, steps=[1, 2, 3], gap=50.0)
    assert seg["run"] == 1 and seg["counts"]["steps_redone"] == 0
    merged = tgood.stitch(str(path))
    assert merged["segments"] == 1 and merged["runs_in_file"] == 2
    assert merged["seconds"]["recovery"] == pytest.approx(0.5)


def test_the_residual_gate_trips_on_an_accounting_gap(tmp_path, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(tgood, "time", clock)
    seg = _incarnation(tgood, tmp_path / "g.jsonl", clock, resumed=0, steps=[1, 2])
    seg = dict(seg, wall_end=seg["wall_end"] + 0.1 * seg["duration_s"])
    summary = tgood.summarize_ledger(tgood.stitch([seg]))
    assert not summary["residual_under_limit"] and summary["unaccounted_pct"] > 2.0
    assert tgood.RESIDUAL_LIMIT_PCT == jgood.RESIDUAL_LIMIT_PCT == 2.0
    assert tgood.CATEGORIES == jgood.CATEGORIES
    with pytest.raises(ValueError, match="no ledger segments"):
        tgood.stitch([])


def test_a_disabled_ledger_marks_nothing():
    ledger = tgood.GoodputLedger()
    assert not ledger.enabled
    ledger.begin()
    ledger.mark("data_wait")
    ledger.mark_step(1)
    assert ledger.end() is None
    assert not tgood.get_ledger().enabled


def test_supervise_writes_restart_rows_as_the_reference(tmp_path):
    """The restart budget and the ledger's restart rows: the same rows
    (timestamps aside) from both supervisors."""
    rows = {}
    for name, module, goodput in (("port", tres, tgood), ("ref", jres, jgood)):
        path = tmp_path / f"{name}.jsonl"
        calls = []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise module.PreemptionError("preempted", step=3 + attempt)
            return "done"

        assert module.supervise(fn, max_restarts=2, ledger_path=str(path)) == ("done", 2)
        assert calls == [0, 1, 2]
        rows[name] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in goodput.read_rows(str(path))]
    assert rows["port"] == rows["ref"] == [
        {"kind": "restart", "attempt": 1, "error": "PreemptionError", "step": 3},
        {"kind": "restart", "attempt": 2, "error": "PreemptionError", "step": 4}]


def test_append_row_retries_an_injected_io_error(tmp_path):
    path = tmp_path / "g.jsonl"
    tfaults.install_plan("io_error@1")
    try:
        assert tgood.append_row(str(path), {"kind": "restart", "attempt": 1})
        tfaults.install_plan("io_error@p=1.0")
        assert not tgood.append_row(str(path), {"kind": "restart", "attempt": 2})
    finally:
        tfaults.install_plan("")
    assert [r["attempt"] for r in tgood.read_rows(str(path))] == [1]

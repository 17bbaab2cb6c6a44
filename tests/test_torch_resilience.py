"""The port's resilience layer (``train/resilience.py``, the retry policy,
the checkpointer's fault sites, the runner's exit code) against the JAX
package's, on the CPU.

Held to the reference: the anomaly detector's decisions on the same
(loss, grad-norm, flagged) sequences, the retry schedule's sleeps and
give-ups under the same seeded jitter and fake clock (deadline included),
the exit codes.  Held to the reference's contract: a real SIGTERM trips
the guard and ``uninstall`` restores the handler; the grace window's
remainder reaches ``save`` and ``wait``; the watchdog fires (in a
subprocess: exit 70 with every thread's stack on stderr), stays quiet
while ticked and unarmed before its first tick; ``supervise``'s restart
budget; ``run_from_argv`` exits 75 on ``PreemptionError``; the
checkpointer retries injected I/O errors and falls back past a torn and
a corrupt generation to the newest one that verifies.
"""

from __future__ import annotations

import io
import logging
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from distributeddeeplearning_tpu.train import resilience as jres
from distributeddeeplearning_tpu.utils import faults as jfaults
from distributeddeeplearning_tpu.utils import retry as jretry
from distributeddeeplearning_tpu_torch.obs.registry import get_registry
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import resilience as tres
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.utils import faults as tfaults
from distributeddeeplearning_tpu_torch.utils import retry as tretry
from distributeddeeplearning_tpu_torch.workloads import _runner as trunner

torch.set_num_threads(2)  # the suite runs six workers on eight cores

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_plans(monkeypatch):
    monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    tfaults.install_plan("")
    jfaults.install_plan("")
    yield
    tfaults.install_plan("")
    jfaults.install_plan("")


# ---- the anomaly detector -----------------------------------------------------

NAN, INF = float("nan"), float("inf")
SEQUENCES = [
    (2, [(NAN, None, None), (0.5, None, None), (1.0, INF, None), (0.5, 1.0, None),
         (NAN, None, None), (NAN, None, None), (0.1, None, None)]),
    (3, [(0.5, 1.0, False), (0.5, 1.0, True), (NAN, NAN, True), (0.4, 2.0, False),
         (0.4, NAN, None), (0.3, 1.0, True), (INF, 1.0, None)]),
    (1, [(0.5, 1.0, None), (-INF, None, None)]),
]


def _decisions(module, max_consecutive, seq):
    det = module.AnomalyDetector(max_consecutive)
    out = []
    for step, (loss, gn, flagged) in enumerate(seq, 1):
        try:
            out.append(det.observe(step, loss, gn, flagged=flagged))
        except module.AnomalyError as exc:
            out.append(("abort", exc.step, exc.consecutive))
            break
    return out, det.total, det.consecutive


@pytest.mark.parametrize("max_consecutive,seq", SEQUENCES)
def test_anomaly_detector_decides_as_the_reference(max_consecutive, seq):
    assert _decisions(tres, max_consecutive, seq) == _decisions(jres, max_consecutive, seq)
    with pytest.raises(ValueError):
        tres.AnomalyDetector(0)


def test_exit_codes_and_error_classes_match_the_reference():
    assert tres.RESUMABLE_EXIT_CODE == jres.RESUMABLE_EXIT_CODE == 75
    assert tres.WATCHDOG_EXIT_CODE == jres.WATCHDOG_EXIT_CODE == 70
    for name in ("PreemptionError", "AnomalyError"):
        assert issubclass(getattr(tres, name), tres.RestartableError)
    assert tres.AnomalyError("x", step=3, consecutive=2).consecutive == 2


# ---- the preemption guard -------------------------------------------------------

def test_a_real_sigterm_trips_the_guard_and_uninstall_restores_the_handler():
    guard = tres.PreemptionGuard(signals=(signal.SIGTERM,))
    prev = signal.getsignal(signal.SIGTERM)
    with guard:
        assert guard.installed and not guard.preempted()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not guard.preempted() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.preempted() and "SIGTERM" in guard.reason
    assert signal.getsignal(signal.SIGTERM) is prev and not guard.installed


def test_remaining_grace_counts_down_from_the_first_signal(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr(tres.time, "monotonic", lambda: clock["t"])
    guard = tres.PreemptionGuard(grace_s=30.0)
    assert guard.remaining_grace() is None
    guard.trigger("injected")
    clock["t"] += 12.0
    guard.trigger("again")  # the clock keeps the first signal's time
    assert guard.remaining_grace() == pytest.approx(18.0)
    clock["t"] += 100.0
    assert guard.remaining_grace() == 0.0
    g2 = tres.PreemptionGuard()
    g2.trigger("x")
    assert g2.remaining_grace() is None
    with pytest.raises(ValueError):
        tres.PreemptionGuard(grace_s=0)


def test_the_emergency_stop_passes_the_grace_remainder_to_save_and_wait():
    class FakeCkpt:
        def __init__(self):
            self.deadlines = []

        def save(self, step, state, *, deadline_s=None):
            self.deadlines.append(("save", deadline_s))

        def wait(self, *, deadline_s=None):
            self.deadlines.append(("wait", deadline_s))

    trainer = tloop.Trainer(lambda s, b: (s, {}), config=tloop.TrainerConfig(
        steps_per_epoch=1))
    trainer.checkpointer = FakeCkpt()
    guard = tres.PreemptionGuard(grace_s=60.0)
    guard.trigger("injected preempt")
    with pytest.raises(tres.PreemptionError) as exc:
        trainer._emergency_stop(5, None, None, guard)
    assert exc.value.step == 5
    assert [k for k, _ in trainer.checkpointer.deadlines] == ["save", "wait"]
    for _, deadline in trainer.checkpointer.deadlines:
        assert deadline is not None and 0.0 <= deadline <= 60.0
    trainer.checkpointer = FakeCkpt()
    with pytest.raises(tres.PreemptionError):
        trainer._emergency_stop(6, None, None, tres.PreemptionGuard())
    assert trainer.checkpointer.deadlines == [("save", None), ("wait", None)]


# ---- the watchdog -------------------------------------------------------------

def test_the_watchdog_fires_and_dumps_the_stacks():
    buf, fired = io.StringIO(), []
    wd = tres.StepWatchdog(0.2, on_timeout=lambda: fired.append(1), poll_s=0.02,
                           stream=buf)
    with wd:
        wd.tick(7)
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
    assert fired and wd.fired
    out = buf.getvalue()
    assert "ddlt watchdog" in out and "since step 7" in out
    assert "thread" in out.lower()


def test_the_watchdog_stays_quiet_while_ticked_and_before_its_first_tick():
    fired = []
    wd = tres.StepWatchdog(0.3, on_timeout=lambda: fired.append(1), poll_s=0.02)
    with wd:
        time.sleep(0.4)  # the build and warm-up: no tick yet
        for _ in range(8):
            wd.tick()
            time.sleep(0.05)
        wd.pause()
        time.sleep(0.5)  # paused: an idle gap must not fire
    assert not fired
    with pytest.raises(ValueError):
        tres.StepWatchdog(0)


def test_a_stalled_process_exits_70_with_its_stacks():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from distributeddeeplearning_tpu_torch.train.resilience import StepWatchdog\n"
        "wd = StepWatchdog(0.3, poll_s=0.05).start()\n"
        "wd.tick(7)\n"
        "time.sleep(20)\n"
        "print('survived')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == tres.WATCHDOG_EXIT_CODE == 70
    assert "survived" not in proc.stdout
    assert "ddlt watchdog: no step progress" in proc.stderr
    assert "since step 7" in proc.stderr
    assert "Thread" in proc.stderr and "File" in proc.stderr  # faulthandler's dump


# ---- supervise and the runner ---------------------------------------------------

def test_the_restart_budget_holds():
    calls = []

    def fn(attempt):
        calls.append(attempt)
        if len(calls) < 3:
            raise tres.RestartableError("again", step=len(calls))
        return "done"

    seen = []
    assert tres.supervise(fn, max_restarts=2,
                          on_restart=lambda n, e: seen.append((n, e.step))) == ("done", 2)
    assert calls == [0, 1, 2] and seen == [(1, 1), (2, 2)]
    calls.clear()
    with pytest.raises(tres.RestartableError):
        tres.supervise(fn, max_restarts=1)
    with pytest.raises(KeyError):
        tres.supervise(lambda a: {}["x"], max_restarts=3)  # not restartable


def test_run_from_argv_exits_75_on_preemption(capsys):
    def main(*, epochs: int = 1):
        raise tres.PreemptionError(f"preempted at step 3 of {epochs}", step=3)

    with pytest.raises(SystemExit) as exc:
        trunner.run_from_argv(main, ["--epochs", "2"])
    assert exc.value.code == tres.RESUMABLE_EXIT_CODE == 75
    assert "preempted at step 3 of 2" in capsys.readouterr().err

    def failing(*, epochs: int = 1):
        raise RuntimeError("real failure")

    with pytest.raises(RuntimeError, match="real failure"):
        trunner.run_from_argv(failing, [])


# ---- retry ---------------------------------------------------------------------

def _sleeps(module, fails, **kw):
    """The sleeps and outcome of one retry sequence under a fake clock that
    each attempt advances by 2 s."""
    clock = {"t": 0.0}
    slept, calls = [], []

    def sleep(d):
        slept.append(d)
        clock["t"] += d

    def fn():
        calls.append(1)
        clock["t"] += 2.0
        if len(calls) <= fails:
            raise IOError("down")
        return "ok"

    try:
        out = module.retry_call(fn, sleep=sleep, rng=random.Random(5),
                                clock=lambda: clock["t"], description="probe io", **kw)
    except IOError:
        out = "raised"
    return out, slept, len(calls)


@pytest.mark.parametrize("fails,kw", [
    (2, dict(retries=4)),
    (9, dict(retries=3, base_delay=0.5, max_delay=1.0)),
    (9, dict(retries=10, base_delay=1.0, max_delay=1.0, deadline_s=5.0)),
    (1, dict(retries=3, base_delay=100.0, max_delay=100.0, deadline_s=3.0)),
    (9, dict(retries=5, deadline_s=0.0)),
])
def test_retry_sleeps_and_gives_up_as_the_reference(fails, kw):
    got = _sleeps(tretry, fails, **kw)
    assert got == _sleeps(jretry, fails, **kw)
    if "deadline_s" in kw:
        assert sum(got[1]) <= kw["deadline_s"]


def test_retry_counts_attempts_and_giveups_in_the_registry():
    reg = get_registry()
    a0 = reg.counter("retry.attempts.count_probe").value
    g0 = reg.counter("retry.giveups.count_probe").value
    def fail():
        raise IOError("x")

    assert tretry.retry_call(lambda: 1, description="count probe") == 1
    with pytest.raises(IOError):
        tretry.retry_call(fail, retries=2, sleep=lambda s: None,
                          description="count probe")
    assert reg.counter("retry.attempts.count_probe").value == a0 + 2
    assert reg.counter("retry.giveups.count_probe").value == g0 + 1
    with pytest.raises(ValueError, match="deadline_s"):
        tretry.retry_call(lambda: None, deadline_s=-1.0)


def test_the_rate_limited_logger_counts_what_it_suppresses():
    clock = {"t": 0.0}
    lines = []
    rl = tretry.RateLimitedLogger(lambda msg, *a: lines.append(msg % a if a else msg),
                                  min_interval_s=60.0, clock=lambda: clock["t"])
    assert rl("drop %d", 1)
    for i in range(5):
        clock["t"] += 1.0
        assert not rl("drop %d", i)
    clock["t"] += 60.0
    assert rl("drop %d", 9)
    assert len(lines) == 2 and "5 similar suppressed" in lines[1]


def test_the_metrics_log_retries_then_drops_with_one_warning(tmp_path, caplog):
    path = tmp_path / "metrics.jsonl"
    tfaults.install_plan("io_error@1")
    log = tloop.MetricsLog(str(path))
    log.append({"epoch": 1})
    assert log.dropped_rows == 0 and '"epoch": 1' in path.read_text()
    tfaults.install_plan("io_error@p=1:seed=0")
    with caplog.at_level(logging.WARNING, logger="ddlt.train"):
        log.append({"epoch": 2})
        log.append({"epoch": 3})
    assert log.dropped_rows == 2 and '"epoch": 2' not in path.read_text()
    drops = [r for r in caplog.records if "dropped" in r.getMessage()]
    assert len(drops) == 1


# ---- the checkpointer's fault sites ---------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"dense": {"kernel": torch.randn(8, 5, generator=g),
                        "bias": torch.randn(5, generator=g)}}
    return tstate.TrainState.create(
        params=params, apply_fn=lambda p, x, **_: x @ p["dense"]["kernel"],
        tx=tstate.sgd_momentum(tsched.constant_schedule(0.05)))


def _saved(directory, steps, plan):
    tfaults.install_plan(plan)
    ckpt = tckpt.Checkpointer(str(directory), max_to_keep=10)
    states = {}
    for step in steps:
        st = _state(seed=step)
        st.step = step
        states[step] = st
        assert ckpt.save(step, st)
    ckpt.wait()
    tfaults.install_plan("")
    return ckpt, states


def test_save_and_wait_retry_through_injected_io_errors(tmp_path):
    ckpt, _ = _saved(tmp_path / "d", [1], "io_error@1,io_error@2")
    assert ckpt.latest_verified_step() == 1
    reg = get_registry()
    assert reg.counter("retry.attempts.checkpoint_save_(step_1)").value >= 1
    tfaults.install_plan("io_error@p=1:seed=0")
    try:
        with pytest.raises(tfaults.InjectedIOError):
            ckpt.save(2, _state(), deadline_s=0.0)
    finally:
        tfaults.install_plan("")
    assert ckpt.all_steps() == [1]


@pytest.mark.parametrize("mode", tckpt.CORRUPT_MODES)
def test_restore_falls_back_past_a_torn_and_a_corrupt_generation(tmp_path, mode):
    """Generations 1-4 with ``ckpt_torn@2`` (no manifest, data cut) and
    ``ckpt_corrupt@3:mode=...`` (the 3rd finalized generation, which is
    step 4): restore lands on step 3, the newest that verifies."""
    ckpt, states = _saved(tmp_path / "d", [1, 2, 3, 4],
                          f"ckpt_torn@2,ckpt_corrupt@3:mode={mode}")
    assert ckpt.latest_verified_step() == (3 if mode == "manifest" else 4)
    assert tckpt.load_manifest(tmp_path / "d" / "2") is None
    restored, step = tckpt.Checkpointer(str(tmp_path / "d")).restore(_state(seed=99))
    assert step == 3 and restored.step == 3
    for (k, x), (_, y) in zip(tckpt.flatten(restored.params),
                              tckpt.flatten(states[3].params)):
        assert torch.equal(x, y), k
    left = tckpt.Checkpointer(str(tmp_path / "d")).all_steps()
    assert left == [1, 3]  # the torn and the corrupt generation were evicted

"""Fault detection and reaction — the port of ``train/resilience.py``:
preemption guard, anomaly detector, step watchdog and the restart
supervisor.

The port's trainer resumes to the exact step (verified checkpoints, the
step-indexed batch factory); this module is what detects a fault and
reacts to one, and :mod:`..utils.faults` is how every path in it runs in
tests and on the card.

Exit-code contract (what a supervisor — a restart policy, the control
plane's resubmit loop — keys off):

- ``RESUMABLE_EXIT_CODE`` (75, BSD ``EX_TEMPFAIL``): the run checkpointed
  its exact step and asks to be restarted — emitted on preemption after
  the emergency checkpoint lands (``workloads._runner.run_from_argv``).
- ``WATCHDOG_EXIT_CODE`` (70, ``EX_SOFTWARE``): a step blew its deadline
  (a hung input source, a stuck collective); all-thread stacks were
  dumped to stderr first.  Restarting may help; the stacks say why.
"""

from __future__ import annotations

import faulthandler
import logging
import math
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional, Tuple

from distributeddeeplearning_tpu_torch.obs.recorder import get_recorder
from distributeddeeplearning_tpu_torch.obs.trace import get_tracer

logger = logging.getLogger("ddlt.resilience")

RESUMABLE_EXIT_CODE = 75  # EX_TEMPFAIL: checkpointed, restart me
WATCHDOG_EXIT_CODE = 70   # EX_SOFTWARE: step deadline blown, stacks dumped


class RestartableError(RuntimeError):
    """A failure after which restart-from-latest-checkpoint is the fix."""

    def __init__(self, msg: str, *, step: Optional[int] = None):
        super().__init__(msg)
        self.step = step


class PreemptionError(RestartableError):
    """Raised by the train loop AFTER the emergency checkpoint landed."""


class AnomalyError(RestartableError):
    """Too many consecutive non-finite steps — the model is diverging."""

    def __init__(self, msg: str, *, step: Optional[int] = None,
                 consecutive: int = 0):
        super().__init__(msg, step=step)
        self.consecutive = consecutive


class PreemptionGuard:
    """SIGTERM/SIGINT → a flag the hot loop checks each step.

    Spot and preemptible nodes deliver SIGTERM with a short grace window;
    an unhandled one kills the process mid-step and loses everything since
    the last periodic checkpoint.  The guard converts the signal into cooperative
    shutdown: the handler only sets a flag (async-signal-safe), the step
    loop notices it at the next boundary, writes a **synchronous** emergency
    checkpoint, and raises :class:`PreemptionError` so the process can exit
    with :data:`RESUMABLE_EXIT_CODE`.

    A second SIGINT falls through to the previous handler (double Ctrl-C
    still kills an interactive run immediately).

    ``grace_s`` is the preemption GRACE WINDOW: how long after the signal
    the platform waits before SIGKILL.  The guard stamps the signal's
    arrival time, and :meth:`remaining_grace` reports what is left of the
    window — the emergency-checkpoint path plumbs that remainder into the
    storage retry layer (``retry_call(deadline_s=...)``) so backoff can
    never sleep past the kill.  ``None`` = unknown window (no deadline
    plumbed; the old wall-clock-unbounded behavior).
    """

    def __init__(
        self,
        signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
        *,
        grace_s: Optional[float] = None,
    ):
        if grace_s is not None and grace_s <= 0:
            raise ValueError(f"grace_s must be > 0, got {grace_s}")
        self.signals = signals
        self.grace_s = grace_s
        self.triggered_at: Optional[float] = None
        self._flag = threading.Event()
        self.reason: Optional[str] = None
        self._previous: dict = {}
        self.installed = False

    def install(self) -> "PreemptionGuard":
        """Install handlers; no-op off the main thread (signal.signal would
        raise there — embedding callers just lose signal coverage, and
        injected preemptions still work via :meth:`trigger`)."""
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "PreemptionGuard: not on the main thread; signal handlers "
                "not installed (injected preemptions still honored)"
            )
            return self
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self.installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # non-main thread / exotic prev
                pass
        self._previous.clear()
        self.installed = False

    def _handle(self, signum, frame) -> None:
        if self._flag.is_set() and signum == signal.SIGINT:
            # Second Ctrl-C: the operator means it.
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                raise KeyboardInterrupt
        self.reason = f"signal {signal.Signals(signum).name}"
        if self.triggered_at is None:
            # arm the grace clock at the FIRST signal (time.monotonic is
            # async-signal-safe: a C call, no Python locks)
            self.triggered_at = time.monotonic()
        self._flag.set()
        get_tracer().event(
            "resilience/preemption_signal", cat="resilience",
            reason=self.reason,
        )

    def trigger(self, reason: str = "triggered") -> None:
        """Programmatic preemption (fault injection, tests)."""
        self.reason = reason
        if self.triggered_at is None:
            self.triggered_at = time.monotonic()
        self._flag.set()
        get_tracer().event(
            "resilience/preemption_signal", cat="resilience", reason=reason
        )

    def preempted(self) -> bool:
        return self._flag.is_set()

    def remaining_grace(self) -> Optional[float]:
        """Seconds left of the preemption grace window, floored at 0 —
        the deadline the emergency checkpoint's retries must fit inside.
        ``None`` when no window is configured or no signal has arrived."""
        if self.grace_s is None or self.triggered_at is None:
            return None
        return max(0.0, self.grace_s - (time.monotonic() - self.triggered_at))

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class AnomalyDetector:
    """Count non-finite loss/grad-norm steps; abort on a consecutive run.

    The step (``build_train_step(skip_nonfinite=True)``) already *skips*
    the poisoned update on the device; this host-side detector decides
    whether the run is still healthy: isolated blips are counted and
    tolerated, ``max_consecutive`` anomalous steps in a row raise
    :class:`AnomalyError` (which the Trainer can answer with a rollback to
    the last checkpoint, or a supervisor with a restart).
    """

    def __init__(self, max_consecutive: int = 3):
        if max_consecutive < 1:
            raise ValueError(
                f"max_consecutive must be >= 1, got {max_consecutive}"
            )
        self.max_consecutive = max_consecutive
        self.total = 0
        self.consecutive = 0

    def observe(
        self,
        step: int,
        loss: float,
        grad_norm: Optional[float] = None,
        flagged: Optional[bool] = None,
    ) -> bool:
        """Record one step's health; returns True when the step is anomalous.

        ``flagged`` is the step's own non-finite verdict when its guard
        computed one; otherwise finiteness of ``loss``/``grad_norm``
        decides.
        """
        anomalous = bool(flagged) if flagged is not None else (
            not math.isfinite(loss)
            or (grad_norm is not None and not math.isfinite(grad_norm))
        )
        if not anomalous:
            self.consecutive = 0
            return False
        self.total += 1
        self.consecutive += 1
        # an instant event on the obs timeline, not just a stderr line:
        # anomaly trips line up against the steps/checkpoints around them
        get_tracer().event(
            "resilience/anomalous_step", cat="resilience", step=step,
            loss=repr(loss), consecutive=self.consecutive,
        )
        logger.warning(
            "anomalous step %d (loss=%s, grad_norm=%s): update skipped "
            "(%d consecutive, %d total)",
            step, loss, grad_norm, self.consecutive, self.total,
        )
        if self.consecutive >= self.max_consecutive:
            get_tracer().event(
                "resilience/anomaly_abort", cat="resilience", step=step,
                consecutive=self.consecutive,
            )
            raise AnomalyError(
                f"{self.consecutive} consecutive non-finite steps "
                f"(last: step {step}, loss={loss})",
                step=step, consecutive=self.consecutive,
            )
        return True


def dump_all_stacks(out=None) -> None:
    """Write every thread's Python stack to ``out`` (default stderr).

    The one artifact that explains a hung collective: which thread sits in
    which blocking call on THIS host when the deadline blew.
    """
    out = out if out is not None else sys.stderr
    try:
        faulthandler.dump_traceback(file=out, all_threads=True)
    except Exception:  # out may be a text-only buffer without fileno
        import traceback

        frames = sys._current_frames()
        for tid, frame in frames.items():
            out.write(f"\n--- thread {tid} ---\n")
            out.write("".join(traceback.format_stack(frame)))
    try:
        out.flush()
    except Exception:
        pass


class StepWatchdog:
    """Background deadline on hot-loop progress — the hung-collective killer.

    On a multi-host mesh one dead host leaves every other host blocked
    *inside* a collective: no exception, no log line, the job burns
    budget until an outer timeout.  The watchdog thread fires when the gap
    between ``tick()`` calls exceeds ``deadline_s``: it dumps all-thread
    stacks and (by default) hard-exits with :data:`WATCHDOG_EXIT_CODE` so a
    supervisor restarts the run — ``on_timeout`` overrides the exit for
    embedding/tests.

    The watchdog arms on the FIRST ``tick()``: step 0 includes the kernels'
    compilation, whose duration has nothing to do with the steady-state
    deadline.  ``pause()`` disarms across known-slow phases (eval,
    epoch-end checkpoints); the next ``tick()`` re-arms.
    """

    def __init__(
        self,
        deadline_s: float,
        *,
        on_timeout: Optional[Callable[[], None]] = None,
        poll_s: Optional[float] = None,
        stream=None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self._poll_s = poll_s if poll_s is not None else min(deadline_s / 4, 1.0)
        self._stream = stream
        self._last_tick: Optional[float] = None
        self._last_step: Optional[int] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._watch, name="ddlt-step-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def tick(self, step: Optional[int] = None) -> None:
        """A step completed; reset (and arm) the deadline.  ``step`` gives
        the timeout report (and its trace event) the last step that made
        progress — the first thing a hang post-mortem asks."""
        with self._lock:
            self._last_tick = time.monotonic()
            if step is not None:
                self._last_step = step

    def pause(self) -> None:
        """Disarm until the next tick (eval, checkpoint, epoch boundary)."""
        with self._lock:
            self._last_tick = None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._poll_s * 4)
            self._thread = None

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                last = self._last_tick
            if last is None:
                continue
            elapsed = time.monotonic() - last
            if elapsed <= self.deadline_s:
                continue
            self.fired = True
            with self._lock:
                last_step = self._last_step
            # timeline first, stderr second: the trace event carries the
            # last-progressed step + timestamps so the hang shows up ON
            # the exported timeline next to whatever it was waiting on
            get_tracer().event(
                "resilience/watchdog_fired", cat="resilience",
                step=last_step, stalled_s=round(elapsed, 3),
                deadline_s=self.deadline_s,
            )
            # freeze the flight recorder BEFORE the stack dump: the ring
            # holds the last spans/events/metric deltas leading into the
            # stall — the first thing the post-mortem wants next to the
            # stacks (a fleet worker's supervisor collects the dump list)
            get_recorder().dump(
                "watchdog_fired", step=last_step,
                stalled_s=round(elapsed, 3), deadline_s=self.deadline_s,
            )
            stream = self._stream if self._stream is not None else sys.stderr
            print(
                f"ddlt watchdog: no step progress for {elapsed:.1f}s "
                f"since step {last_step} "
                f"(deadline {self.deadline_s}s) — dumping all thread stacks",
                file=stream,
            )
            dump_all_stacks(stream)
            if self.on_timeout is not None:
                self.on_timeout()
                # custom handler chose to keep the process: disarm so a
                # still-hung loop doesn't re-fire every poll interval
                with self._lock:
                    self._last_tick = None
                continue
            os._exit(WATCHDOG_EXIT_CODE)

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def supervise(
    fn: Callable[[int], object],
    *,
    max_restarts: int = 0,
    restart_on: Tuple[type, ...] = (RestartableError,),
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
    ledger_path: Optional[str] = None,
):
    """In-process restart loop: call ``fn(attempt)``, restarting on
    restartable failures up to ``max_restarts`` times.

    This is the single-process half of the supervision story (``ddlt train
    --max-restarts``); the cross-process half is the exit-code contract plus
    the control plane's resubmit loop.  ``fn`` must be restartable by
    construction — i.e. resume from its own checkpoints — or the loop just
    re-runs the failure.

    ``ledger_path`` is the goodput ledger's JSONL file (``obs/goodput.py``):
    when set, every restart appends a ``restart`` marker row from the
    SUPERVISOR's side — so the stitched ledger can cross-check that
    segments and restarts interleave (a segment the dying attempt failed
    to write is detectable, not silent) and charge the restart gap to the
    ``recovery`` category.

    Returns ``(result, restarts_used)``.  The final failure propagates.
    """
    restarts = 0
    while True:
        try:
            return fn(restarts), restarts
        except restart_on as exc:
            if restarts >= max_restarts:
                raise
            restarts += 1
            logger.warning(
                "restartable failure (%s: %s) — restart %d/%d from latest "
                "checkpoint", type(exc).__name__, exc, restarts, max_restarts,
            )
            if ledger_path:
                from distributeddeeplearning_tpu_torch.obs import goodput

                goodput.append_row(ledger_path, {
                    "kind": "restart",
                    "ts": time.time(),
                    "attempt": restarts,
                    "error": type(exc).__name__,
                    "step": getattr(exc, "step", None),
                })
            if on_restart is not None:
                on_restart(restarts, exc)

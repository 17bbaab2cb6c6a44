"""Span-based host tracer — the port of ``obs/trace.py``: one timeline for
the trainer's phases and its resilience events.

Nested host-side spans plus instant events, exported as Chrome-trace JSON
(``chrome://tracing`` / Perfetto open it directly).  Where the reference
passes each span through ``jax.profiler.TraceAnnotation``, the port enters
``torch.profiler.record_function``: inside a ``torch.profiler`` window on
the card (the trainer's ``profile_dir``) each span shows up by name on the
host lane, above the kernels it launched.

- **zero-sync**: nothing in the span path reads a tensor — spans time the
  host wall clock only, so instrumenting a hot loop never waits for the
  card;
- **near-zero cost when disabled**: ``span()`` on a disabled tracer with
  no flight recorder returns a shared no-op context manager without
  reading the clock or allocating an event.  The process tracer carries
  the process flight recorder (:mod:`.recorder`), so its disabled spans
  are the recorder's one-append spans instead.

Usage::

    tracer = get_tracer()                    # process-global, disabled
    tracer.enable()                          # or configure(enabled=True)
    with tracer.span("train/step", step=12):
        ...
    tracer.event("preempted", step=12)       # instant event
    tracer.export("trace.json")              # Chrome trace JSON
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from distributeddeeplearning_tpu_torch.obs import recorder as _recorder_mod
from distributeddeeplearning_tpu_torch.obs.recorder import (
    FlightRecorder,
    _RecorderSpan,
)

__all__ = [
    "Tracer",
    "PROCESS_RECORDER",
    "get_tracer",
    "set_tracer",
    "configure",
]

#: sentinel recorder binding: "whatever the PROCESS recorder currently
#: is", resolved at record time, so ``set_recorder`` swaps take effect on
#: the global tracer immediately
PROCESS_RECORDER: Any = object()


class _NullSpan:
    """The disabled-tracer span: a shared, stateless no-op (no clock read,
    no allocation)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


def _resolve(rec):
    return _recorder_mod._RECORDER if rec is PROCESS_RECORDER else rec


class _Span:
    """One live span: records a Chrome ``"X"`` (complete) event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0
        self._annotation = None

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        if tracer._annotate:
            # the same name inside a torch.profiler window (a no-op when
            # no profiler is recording)
            self._annotation = tracer._record_function(self._name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        tracer._depth_local.depth = getattr(tracer._depth_local, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        tracer = self._tracer
        depth = getattr(tracer._depth_local, "depth", 1)
        tracer._depth_local.depth = depth - 1
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        ctx = tracer._context
        args = {**ctx, **self._args} if ctx else dict(self._args)
        args["depth"] = depth - 1  # 0 = top-level
        tracer._events.append({
            "ph": "X",
            "name": self._name,
            "cat": self._cat,
            "pid": tracer.pid,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "ts": (self._t0 - tracer._epoch_perf) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "args": args,
        })
        rec = _resolve(tracer._recorder)
        if rec is not None and rec.enabled:
            # the flight recorder shadows the enabled tracer too
            rec.record("span", self._name, self._cat, self._t0,
                       (t1 - self._t0) * 1e6, self._args)


class Tracer:
    """Nested host spans + instant events on one monotonic clock.

    Events append to one list (atomic under the GIL) and nesting depth is
    tracked per thread, so the trainer loop and the watchdog thread report
    into the same tracer.
    """

    def __init__(
        self,
        *,
        enabled: bool = False,
        annotate: bool = True,
        pid: Optional[int] = None,
        process_name: Optional[str] = None,
        recorder: Optional[FlightRecorder] = None,
    ):
        self._enabled = enabled
        self._annotate_requested = annotate
        self._annotate = False
        self._record_function = None
        self.pid = int(pid) if pid is not None else os.getpid()
        self.process_name = process_name if process_name is not None else "ddlt-host"
        # default args stamped onto every span and event (a fleet worker
        # sets replica=k so every scheduler span carries its identity)
        self._context: Dict[str, Any] = {}
        self._recorder = recorder
        self._events: List[Dict[str, Any]] = []
        self._depth_local = threading.local()
        # perf_counter for span math, the wall clock to stamp the trace
        self._epoch_perf = time.perf_counter()
        self._epoch_wall = time.time()
        if enabled:
            self._resolve_annotation()

    def _resolve_annotation(self) -> None:
        """Bind ``torch.profiler.record_function`` lazily."""
        if not self._annotate_requested or self._record_function is not None:
            return
        from torch.profiler import record_function

        self._record_function = record_function
        self._annotate = True

    # -- control ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def epoch_unix_s(self) -> float:
        """Wall-clock time of this tracer's perf_counter epoch: the anchor
        the fleet trace merge aligns worker clocks with."""
        return self._epoch_wall

    def enable(self) -> "Tracer":
        self._enabled = True
        self._resolve_annotation()
        return self

    def disable(self) -> "Tracer":
        self._enabled = False
        return self

    def clear(self) -> None:
        self._events = []

    def set_context(self, **args: Any) -> "Tracer":
        """Merge default args stamped onto every later span and event."""
        self._context.update(args)
        return self

    def attach_recorder(self, recorder: Optional[FlightRecorder]) -> "Tracer":
        """Attach (or detach with None) a flight recorder: spans and events
        then land in its ring even while the tracer is disabled."""
        self._recorder = recorder
        return self

    # -- recording --------------------------------------------------------
    def span(self, name: str, cat: str = "host", **args):
        """Context manager timing a host-side phase.  Disabled tracer
        without a recorder: the shared no-op span.  With a flight recorder
        attached, the disabled path hands out the recorder's span (one
        ring append)."""
        if self._enabled:
            return _Span(self, name, cat, args)
        rec = _resolve(self._recorder)
        if rec is not None and rec.enabled:
            return _RecorderSpan(rec, name, cat, args)
        return _NULL_SPAN

    def event(self, name: str, cat: str = "host", **args) -> None:
        """Instant event (Chrome ``"i"``): watchdog trips, preemptions,
        anomalies, rollbacks.  Recorded into the attached flight recorder
        even when disabled."""
        rec = _resolve(self._recorder)
        if rec is not None and rec.enabled:
            rec.record_event(name, cat, args)
        if not self._enabled:
            return
        ctx = self._context
        self._events.append({
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "name": name,
            "cat": cat,
            "pid": self.pid,
            "tid": threading.get_ident() & 0xFFFFFFFF,
            "ts": (time.perf_counter() - self._epoch_perf) * 1e6,
            "args": {**ctx, **args} if ctx else dict(args),
        })

    # -- export -----------------------------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The ``{"traceEvents": [...]}`` Chrome/Perfetto container, with
        process metadata naming the host lane."""
        meta = [{"ph": "M", "name": "process_name", "pid": self.pid,
                 "args": {"name": self.process_name}}]
        return {
            "traceEvents": meta + list(self._events),
            "displayTimeUnit": "ms",
            "metadata": {
                "tracer_epoch_unix_s": self._epoch_wall,
                "clock": "perf_counter us since tracer epoch",
                "host_pids": [self.pid],
                "process_name": self.process_name,
            },
        }

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
        return path


# -- process-global tracer (disabled by default) --------------------------
# It carries the process flight recorder (resolved through the sentinel),
# so its spans and events land in the bounded ring while tracing is off.

_TRACER = Tracer(enabled=False, recorder=PROCESS_RECORDER)


def get_tracer() -> Tracer:
    """The process's tracer: disabled (recorder spans only) until a caller
    enables it."""
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def configure(
    *,
    enabled: bool,
    annotate: bool = True,
    pid: Optional[int] = None,
    process_name: Optional[str] = None,
) -> Tracer:
    """Install a fresh tracer with the given switches and return it (the
    process flight recorder stays attached)."""
    return set_tracer(Tracer(enabled=enabled, annotate=annotate, pid=pid,
                             process_name=process_name, recorder=PROCESS_RECORDER))

"""Crash flight recorder — the port of ``obs/recorder.py``: a bounded ring
of the last moments before a fault.

The tracer (:mod:`.trace`) is disabled by default because recording every
span forever is not free; the events worth the most are the ones nobody
chose to profile.  This module keeps them: a **bounded ring buffer**
(``collections.deque(maxlen=...)``) of recent spans, instant events and
metric deltas that stays ON while the tracer is off, and is frozen into a
dump when something goes wrong.  In the port the trainer's
:class:`~..train.resilience.StepWatchdog` dumps it before its stack dump,
and every injected fault (:mod:`..utils.faults`) lands in it, as do the
serve side's quarantine, replica-death and worker-crash dumps.

- **zero-sync**: entries are host timestamps and host scalars by
  contract, nothing on the record path reads a tensor;
- **bounded**: one deque append per record, memory capped by
  ``capacity``.

The recorder hooks in through the tracer (a disabled tracer with a
recorder attached returns a lightweight recording span instead of the
shared no-op) and through ``Counter.inc`` / ``Gauge.set`` (metric deltas),
so instrumentation sites need no second call.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "set_recorder",
    "register_dump_context",
]

#: how many dumps a recorder retains (a dump storm — e.g. a quarantine
#: per step — must not grow without bound either)
MAX_DUMPS = 8

#: Dump-context providers: name -> zero-arg callable returning a JSON-
#: ready block attached to every dump (the reference's attribution layer
#: registers its HBM-ledger frame here; registration is the dependency
#: direction, never an import from here).  Providers must be fast and
#: host-only (they run mid-failure); a raising provider is skipped, never
#: propagated.
_DUMP_CONTEXT: Dict[str, Any] = {}


def register_dump_context(name: str, provider) -> None:
    """Attach ``provider()``'s block to every future dump under
    ``name`` (last registration per name wins; ``None`` removes)."""
    if provider is None:
        _DUMP_CONTEXT.pop(name, None)
    else:
        _DUMP_CONTEXT[name] = provider


class _RecorderSpan:
    """The recording span a disabled-tracer-with-recorder hands out:
    times the phase on the host clock and appends ONE ring entry on exit
    (no tracer event list, no chrome-trace bookkeeping)."""

    __slots__ = ("_rec", "_name", "_cat", "_args", "_t0")

    def __init__(self, rec: "FlightRecorder", name: str, cat: str, args):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_RecorderSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._rec.record(
            "span", self._name, self._cat, self._t0,
            (t1 - self._t0) * 1e6, self._args,
        )


class FlightRecorder:
    """Bounded ring of recent spans / events / metric deltas.

    Entries are stored as tuples (kind, name, cat, ts_perf, dur_us, args)
    — converted to dicts only at dump time, so the record path is one
    append.  Thread-safe the same way the tracer is: deque appends are
    atomic under the GIL and the ring never shrinks concurrently.
    """

    def __init__(self, capacity: int = 256, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._ring: deque = deque(maxlen=capacity)
        self._epoch_perf = time.perf_counter()
        self._epoch_wall = time.time()
        self.dumps: List[Dict[str, Any]] = []
        self.records_total = 0

    # -- recording (zero-sync) ---------------------------------------------
    def record(
        self, kind: str, name: str, cat: str,
        ts_perf: float, dur_us: float, args,
    ) -> None:
        """Append one entry — host timestamps and host scalars only, by
        contract."""
        self._ring.append((kind, name, cat, ts_perf, dur_us, args))
        self.records_total += 1

    def record_event(self, name: str, cat: str = "host", args=None) -> None:
        self.record("event", name, cat, time.perf_counter(), 0.0, args)

    def record_metric(self, name: str, value) -> None:
        """One metric delta (a counter bump / gauge set), value is a host
        scalar by the registry's contract."""
        self.record(
            "metric", name, "metric", time.perf_counter(), 0.0, value,
        )

    def span(self, name: str, cat: str = "host", **args) -> _RecorderSpan:
        return _RecorderSpan(self, name, cat, args)

    # -- reading / dumping -------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def entries(self) -> List[Dict[str, Any]]:
        """The ring as JSON-ready dicts, oldest first; timestamps in µs
        since the recorder epoch (``epoch_unix_s`` anchors them)."""
        out = []
        for kind, name, cat, ts_perf, dur_us, args in list(self._ring):
            entry: Dict[str, Any] = {
                "kind": kind,
                "name": name,
                "cat": cat,
                "ts_us": round((ts_perf - self._epoch_perf) * 1e6, 1),
            }
            if kind == "span":
                entry["dur_us"] = round(dur_us, 1)
            if kind == "metric":
                entry["value"] = args
            elif args:
                entry["args"] = dict(args)
            out.append(entry)
        return out

    def dump(
        self,
        reason: str,
        *,
        registry=None,
        path: Optional[str] = None,
        **context: Any,
    ) -> Dict[str, Any]:
        """Freeze the ring into a dump dict (recorded in :attr:`dumps`,
        bounded), optionally attaching a metrics-registry snapshot and
        writing JSON to ``path``.  Never raises — the dump path runs in
        the middle of a failure and must not add one."""
        payload: Dict[str, Any] = {
            "reason": reason,
            "pid": os.getpid(),
            "ts_unix_s": time.time(),
            "epoch_unix_s": self._epoch_wall,
            "records_total": self.records_total,
            "entries": self.entries(),
            **context,
        }
        if registry is not None:
            try:
                payload["metrics"] = registry.snapshot()
            except Exception:  # pragma: no cover - defensive
                payload["metrics"] = None
        # registered context blocks (HBM ledger frame, program-cost
        # table, ...): best-effort, never overriding an explicit key —
        # the dump runs mid-failure and must survive a broken provider
        for name, provider in list(_DUMP_CONTEXT.items()):
            if name in payload:
                continue
            try:
                payload[name] = provider()
            except Exception:
                payload[name] = None
        self.dumps.append(payload)
        del self.dumps[:-MAX_DUMPS]
        if path is not None:
            try:
                import json

                with open(path, "w") as f:
                    json.dump(payload, f)
                    f.write("\n")
            except Exception:  # best-effort: the dump itself must not kill
                pass
        return payload

    def drain_dumps(self) -> List[Dict[str, Any]]:
        """Hand off (and clear) the accumulated dumps."""
        out, self.dumps = self.dumps, []
        return out


# -- process-global recorder (ON by default: it is the black box) ----------

_RECORDER: Optional[FlightRecorder] = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process's flight recorder — enabled by default (bounded cost:
    one deque append per span/event/metric on the hot paths)."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder()
    return _RECORDER


def set_recorder(recorder: Optional[FlightRecorder]):
    global _RECORDER
    _RECORDER = recorder
    return recorder

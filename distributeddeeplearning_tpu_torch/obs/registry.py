"""Metrics registry — the port of ``obs/registry.py``: counters, gauges and
streaming-percentile histograms.

The one quantile implementation the port routes through: the serve
scheduler's percentile blocks, the trainer's per-epoch rollups, the retry
layer's pressure counters.

The histogram is a log-linear bucket sketch: a sample ``x > 0`` lands in
bucket ``ceil(log(x) / log(1 + max_rel_err))``, so a percentile read back
from a bucket boundary is within ``max_rel_err`` of the exact order
statistic; count, sum, min and max are exact and percentiles are clamped
to [min, max].  Two histograms with one error bound merge bucket for
bucket, exactly.

Snapshots serialize the whole registry to a JSONL row, appended through
the retry layer and the ``DDLT_FAULTS`` ``io_error`` hook (site ``obs``):
transient storage failures retry, exhausted retries drop the row
(counted), and rows written before a restart survive it.  Rows carry the
same keys as the reference's, so either package's reader takes them.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterable, Optional

from distributeddeeplearning_tpu_torch.obs import recorder as _recorder_mod

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "merge_states",
    "summarize",
    "get_registry",
    "set_registry",
]

#: percentiles every summary reports
SUMMARY_PERCENTILES = (50.0, 90.0, 99.0)


class Counter:
    """Monotonic event count (requests served, anomalous steps, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n
        rec = _recorder_mod._RECORDER
        if rec is not None and rec.enabled:
            # metric deltas ride the flight-recorder ring (one bounded
            # append; the value is a host int by construction)
            rec.record_metric(self.name, self.value)


class Gauge:
    """Last-value-wins scalar (occupancy, images/sec, free pages, ...)."""

    __slots__ = ("name", "value", "updated_at")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self.updated_at: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)
        self.updated_at = time.time()
        rec = _recorder_mod._RECORDER
        if rec is not None and rec.enabled:
            rec.record_metric(self.name, self.value)


class Histogram:
    """Streaming percentile sketch over non-negative samples.

    Log-linear buckets: sample ``x`` lands in bucket
    ``ceil(log(x) / log(1 + max_rel_err))``, so any percentile read back
    from bucket boundaries is within ``max_rel_err`` (relative) of the
    exact order statistic.  Values ``<= 0`` share one underflow bucket
    (latencies are the target domain).  Memory is one int per occupied
    bucket — bounded by the dynamic range, not the sample count.
    """

    __slots__ = (
        "name", "max_rel_err", "_log_base", "_buckets",
        "count", "total", "min", "max",
    )

    def __init__(self, name: str = "", max_rel_err: float = 0.01):
        if not 0.0 < max_rel_err < 1.0:
            raise ValueError(
                f"max_rel_err must be in (0, 1), got {max_rel_err}"
            )
        self.name = name
        self.max_rel_err = max_rel_err
        self._log_base = math.log1p(max_rel_err)
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording --------------------------------------------------------
    def record(self, x: float) -> None:
        # callers pass host scalars by contract: never a tensor
        x = float(x)
        if x > 0.0:
            idx = math.ceil(math.log(x) / self._log_base)
        else:
            idx = None  # underflow bucket: zero / negative samples
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    def record_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.record(x)

    # -- reading ----------------------------------------------------------
    def _bucket_value(self, idx) -> float:
        if idx is None:
            return min(self.min, 0.0)
        # geometric midpoint of the bucket's (lo, hi] bounds
        hi = math.exp(idx * self._log_base)
        return hi / math.sqrt(1.0 + self.max_rel_err)

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]); 0.0 on an empty histogram."""
        if not self.count:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q} outside [0, 100]")
        # rank follows numpy's 'higher' convention: on small counts the
        # tail percentiles land on (or above) the interpolated value
        # instead of collapsing toward the median — p99 of 8 samples is
        # the 8th, not the 7th.  The bucket walk is monotone in q, so
        # p99 >= p90 >= p50 by construction.
        rank = q / 100.0 * (self.count - 1)
        target = math.ceil(rank) + 1
        seen = 0
        # underflow bucket sorts first (None < every finite sample > 0)
        keys = sorted(
            self._buckets, key=lambda k: -math.inf if k is None else k
        )
        for idx in keys:
            seen += self._buckets[idx]
            if seen >= target:
                v = self._bucket_value(idx)
                return min(max(v, self.min), self.max)
        return self.max  # pragma: no cover - walk always terminates above

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self, round_ndigits: int = 6) -> Dict[str, float]:
        """The percentile block every latency field in the artifacts uses:
        ``{"p50", "p90", "p99", "mean", "max"}`` (mean/max exact)."""
        if not self.count:
            return {
                **{f"p{int(q)}": 0.0 for q in SUMMARY_PERCENTILES},
                "mean": 0.0,
                "max": 0.0,
            }
        out = {
            f"p{int(q)}": round(self.percentile(q), round_ndigits)
            for q in SUMMARY_PERCENTILES
        }
        out["mean"] = round(self.mean, round_ndigits)
        out["max"] = round(self.max, round_ndigits)
        return out

    def merge(self, other: "Histogram") -> None:
        """EXACT bucket-wise merge: because both histograms share one
        bucketing function, ``a.merge(b)`` produces bucket-for-bucket the
        same sketch as recording every raw sample of both into one
        histogram — so fleet-level percentiles computed from merged
        worker buckets equal the single-process answer, which averaging
        per-worker percentiles never does.  Commutative and associative
        (merge order cannot change the result); mismatched error bounds
        refuse instead of silently mixing incompatible grids."""
        if other._log_base != self._log_base:
            raise ValueError("cannot merge histograms with different error bounds")
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, **self.summary()}

    # -- mergeable wire form ----------------------------------------------
    def state(self) -> Dict[str, Any]:
        """JSON-safe full state (buckets included, underflow keyed "u")
        — the wire form fleet workers ship so the router can rebuild and
        bucket-merge exactly, not approximate from percentiles."""
        return {
            "name": self.name,
            "max_rel_err": self.max_rel_err,
            "count": self.count,
            "total": self.total,
            "min": None if math.isinf(self.min) else self.min,
            "max": None if math.isinf(self.max) else self.max,
            "buckets": {
                "u" if idx is None else str(idx): n
                for idx, n in self._buckets.items()
            },
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Histogram":
        h = cls(
            state.get("name", ""),
            float(state.get("max_rel_err", 0.01)),
        )
        h.count = int(state["count"])
        h.total = float(state["total"])
        h.min = math.inf if state["min"] is None else float(state["min"])
        h.max = -math.inf if state["max"] is None else float(state["max"])
        h._buckets = {
            None if k == "u" else int(k): int(n)
            for k, n in state.get("buckets", {}).items()
        }
        return h


def summarize(xs, max_rel_err: float = 0.01) -> Dict[str, float]:
    """Percentile block of a finished sample list — the drop-in for the
    scheduler's old ``_percentiles`` and any bench-side quantile math:
    one histogram implementation, one key set."""
    h = Histogram(max_rel_err=max_rel_err)
    h.record_many(xs)
    return h.summary()


class MetricsRegistry:
    """Named counters/gauges/histograms plus JSONL snapshotting.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent by
    name), so instrumentation sites don't coordinate construction.
    """

    def __init__(
        self,
        *,
        replica_id: Optional[int] = None,
        process_name: Optional[str] = None,
    ):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # process identity: every snapshot row / shipped state carries it,
        # so fleet JSONL streams are attributable (and the OBS_FLEET
        # schema can reject anonymous per-replica rows)
        self.replica_id = replica_id
        self.process_name = process_name
        self.snapshots_written = 0
        self.snapshots_dropped = 0

    def set_identity(self, *, replica_id: Optional[int] = None,
                     process_name: Optional[str] = None) -> "MetricsRegistry":
        """Stamp this process's identity (a fleet worker calls it once at
        startup) onto every later snapshot row and shipped state."""
        if replica_id is not None:
            self.replica_id = replica_id
        if process_name is not None:
            self.process_name = process_name
        return self

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, max_rel_err: float = 0.01) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, max_rel_err)
            return self._histograms[name]

    def snapshot(self, **extra: Any) -> Dict[str, Any]:
        """One JSON-ready row of everything the process has recorded.

        Rows carry process identity (``pid`` always; ``replica_id`` /
        ``process`` when stamped) so a fleet's interleaved JSONL stream
        stays attributable — an anonymous row used to be indistinguishable
        across workers."""
        with self._lock:
            row: Dict[str, Any] = {
                "ts": time.time(),
                "pid": os.getpid(),
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {
                    n: g.value for n, g in self._gauges.items()
                    if g.value is not None
                },
                "histograms": {
                    n: h.snapshot() for n, h in self._histograms.items()
                },
            }
            if self.replica_id is not None:
                row["replica_id"] = self.replica_id
            if self.process_name is not None:
                row["process"] = self.process_name
            row.update(extra)
            return row

    def state(self) -> Dict[str, Any]:
        """Full mergeable state: counters/gauges plus EVERY histogram's
        buckets (not just its percentile summary) — what fleet workers
        ship over the outbox so the router computes fleet percentiles
        from bucket-merged sketches, never by averaging per-replica
        percentiles."""
        with self._lock:
            state: Dict[str, Any] = {
                "pid": os.getpid(),
                "ts": time.time(),
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {
                    n: {"value": g.value, "updated_at": g.updated_at}
                    for n, g in self._gauges.items()
                    if g.value is not None
                },
                "histograms": {
                    n: h.state() for n, h in self._histograms.items()
                },
            }
            if self.replica_id is not None:
                state["replica_id"] = self.replica_id
            if self.process_name is not None:
                state["process"] = self.process_name
            return state

    def merge_state(self, state: Dict[str, Any]) -> "MetricsRegistry":
        """Fold one shipped :meth:`state` into this registry: counters
        add, gauges keep the freshest ``updated_at``, histograms merge
        bucket-wise (exact — see :meth:`Histogram.merge`)."""
        for name, value in state.get("counters", {}).items():
            self.counter(name).value += int(value)
        for name, g in state.get("gauges", {}).items():
            gauge = self.gauge(name)
            at = g.get("updated_at") or 0.0
            if gauge.updated_at is None or at >= gauge.updated_at:
                gauge.value = g.get("value")
                gauge.updated_at = at
        for name, hstate in state.get("histograms", {}).items():
            incoming = Histogram.from_state(hstate)
            self.histogram(
                name, max_rel_err=incoming.max_rel_err
            ).merge(incoming)
        return self

    def write_snapshot(self, path: str, **extra: Any) -> bool:
        """Append one snapshot row to ``path`` (JSONL), best-effort.

        Runs through the retry helper and the ``DDLT_FAULTS`` ``io_error``
        hook — same contract as checkpoint/metrics writes: transient
        storage failures retry, exhausted retries DROP the row (counted)
        rather than killing the run.  Append-only, so rows written before
        a crash/restart survive it.
        """
        from distributeddeeplearning_tpu_torch.utils import faults as faults_mod
        from distributeddeeplearning_tpu_torch.utils.retry import retry_call

        line = json.dumps(self.snapshot(**extra)) + "\n"

        def _write() -> None:
            faults_mod.get_plan().maybe_io_error("obs")
            with open(path, "a") as f:
                f.write(line)

        try:
            retry_call(
                _write, retries=3, base_delay=0.05, max_delay=2.0,
                description=f"obs snapshot ({path})",
            )
        except Exception:
            self.snapshots_dropped += 1
            return False
        self.snapshots_written += 1
        return True


def merge_states(states: Iterable[Dict[str, Any]]) -> MetricsRegistry:
    """Merge shipped registry states into one fleet-level registry —
    merge order cannot change the result (counter addition and bucket
    addition are commutative/associative; gauges resolve by timestamp)."""
    merged = MetricsRegistry(process_name="fleet-merged")
    for state in states:
        merged.merge_state(state)
    return merged


# -- process-global registry ----------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = registry
    return registry

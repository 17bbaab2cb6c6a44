"""Streaming-percentile histogram — a private copy of ``obs/registry.py``'s
``Histogram`` and ``summarize`` (the reference's module pulls in jax through
its package).  The serve scheduler's percentile blocks route through it, so
a port report's p50/p90/p99 mean what the reference's mean.

Log-linear buckets: a sample ``x > 0`` lands in bucket
``ceil(log(x) / log(1 + max_rel_err))``, so a percentile read back from a
bucket boundary is within ``max_rel_err`` of the exact order statistic.
Count, sum, min and max are exact; percentiles are clamped to [min, max].
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

SUMMARY_PERCENTILES = (50.0, 90.0, 99.0)


class Histogram:
    """Streaming percentile sketch over non-negative samples."""

    __slots__ = ("name", "max_rel_err", "_log_base", "_buckets",
                 "count", "total", "min", "max")

    def __init__(self, name: str = "", max_rel_err: float = 0.01):
        if not 0.0 < max_rel_err < 1.0:
            raise ValueError(f"max_rel_err must be in (0, 1), got {max_rel_err}")
        self.name = name
        self.max_rel_err = max_rel_err
        self._log_base = math.log1p(max_rel_err)
        self._buckets: Dict = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, x: float) -> None:
        x = float(x)
        idx = math.ceil(math.log(x) / self._log_base) if x > 0.0 else None
        self._buckets[idx] = self._buckets.get(idx, 0) + 1
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def record_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.record(x)

    def _bucket_value(self, idx) -> float:
        if idx is None:
            return min(self.min, 0.0)
        # geometric midpoint of the bucket's (lo, hi] bounds
        return math.exp(idx * self._log_base) / math.sqrt(1.0 + self.max_rel_err)

    def percentile(self, q: float) -> float:
        """The q-th percentile (numpy's 'higher' rank); 0.0 when empty."""
        if not self.count:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q} outside [0, 100]")
        target = math.ceil(q / 100.0 * (self.count - 1)) + 1
        seen = 0
        for idx in sorted(self._buckets,
                          key=lambda k: -math.inf if k is None else k):
            seen += self._buckets[idx]
            if seen >= target:
                return min(max(self._bucket_value(idx), self.min), self.max)
        return self.max  # pragma: no cover - the walk always terminates

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self, round_ndigits: int = 6) -> Dict[str, float]:
        """``{"p50", "p90", "p99", "mean", "max"}`` (mean and max exact)."""
        if not self.count:
            out = {f"p{int(q)}": 0.0 for q in SUMMARY_PERCENTILES}
            out.update(mean=0.0, max=0.0)
            return out
        out = {f"p{int(q)}": round(self.percentile(q), round_ndigits)
               for q in SUMMARY_PERCENTILES}
        out["mean"] = round(self.mean, round_ndigits)
        out["max"] = round(self.max, round_ndigits)
        return out


def summarize(xs, max_rel_err: float = 0.01) -> Dict[str, float]:
    """Percentile block of a finished sample list."""
    h = Histogram(max_rel_err=max_rel_err)
    h.record_many(xs)
    return h.summary()

"""Bounded exponential backoff with full jitter — the port of
``utils/retry.py``, the I/O retry policy of the checkpointer, the metrics
log, registry snapshots and the goodput ledger.

- **bounded**: at most ``retries`` re-attempts, then the last exception
  propagates: a retry loop must never turn a hard failure into a hang;
- **exponential with full jitter**: the attempt-``i`` sleep is drawn
  uniformly from ``[0, min(max_delay, base_delay * 2**i)]``, which
  decorrelates writers that failed together;
- **deadline-aware** (``deadline_s``): the emergency checkpoint runs
  inside the preemption grace window, where a backoff schedule that
  outlives the window turns a savable run into a killed one.  Once the
  budget is spent the last failure propagates at once, and no sleep may
  overshoot what is left of the window.

``sleep``/``rng``/``clock`` are injectable so tests check the bounds
without sleeping.  Every retry and every give-up is counted in the
process metrics registry (``retry.attempts.<label>`` /
``retry.giveups.<label>``, label = the call's ``description`` with
spaces collapsed): the retry pressure of each call site.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional

logger = logging.getLogger("ddlt.retry")


def _counter_label(fn: Callable, description: str) -> str:
    """Call-site label for the registry counters: the human description
    (spaces -> ``_``) or the function name."""
    label = description or getattr(fn, "__name__", "operation")
    return "_".join(label.split())


def _count(kind: str, label: str) -> None:
    # lazy import: obs.registry's snapshot path itself writes through
    # retry_call, so a top-level import here would be circular
    from distributeddeeplearning_tpu_torch.obs.registry import get_registry

    get_registry().counter(f"retry.{kind}.{label}").inc()


def backoff_delays(
    retries: int,
    *,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    rng: Optional[random.Random] = None,
):
    """Yield the ``retries`` jittered sleeps of one retry sequence.

    Exposed separately so the bound is testable as data: delay ``i`` is
    uniform in ``[0, min(max_delay, base_delay * 2**i)]``.
    """
    rng = rng if rng is not None else random
    for attempt in range(retries):
        cap = min(max_delay, base_delay * (2.0 ** attempt))
        yield rng.uniform(0.0, cap)


def retry_call(
    fn: Callable,
    *args,
    retries: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 5.0,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    description: str = "",
    deadline_s: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``; on any ``Exception`` retry up to
    ``retries`` times with full-jitter backoff.  The final failure
    re-raises.  ``description`` names the operation in the warning log
    lines and the registry counters.

    ``deadline_s`` bounds the WHOLE retry sequence on the wall clock
    (measured by ``clock`` from the first attempt's start): once the
    budget is spent, the current failure re-raises instead of sleeping —
    and no single sleep may overshoot the remaining window.  This is how
    the emergency-checkpoint path keeps its backoff inside the preemption
    grace window (a retry schedule that sleeps past the SIGKILL saves
    nothing).  ``None`` (the default) keeps the unbounded behavior.
    """
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if deadline_s is not None and deadline_s < 0:
        raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
    t0 = clock()
    delays = backoff_delays(
        retries, base_delay=base_delay, max_delay=max_delay, rng=rng
    )
    label = _counter_label(fn, description)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as exc:
            if attempt >= retries:
                # exhausted: the caller sees the exception; the counter is
                # how a chaos bench sees it (RateLimitedLogger may have
                # suppressed the log line)
                _count("giveups", label)
                raise
            delay = next(delays)
            if deadline_s is not None:
                remaining = deadline_s - (clock() - t0)
                if remaining <= 0.0:
                    # budget spent: re-raising NOW is the only move that
                    # can still leave grace for whatever comes after
                    _count("giveups", label)
                    logger.warning(
                        "%s failed (%s); retry deadline %.2fs exhausted — "
                        "giving up without sleeping",
                        description or getattr(fn, "__name__", "operation"),
                        exc, deadline_s,
                    )
                    raise
                delay = min(delay, remaining)
            attempt += 1
            _count("attempts", label)
            logger.warning(
                "%s failed (%s); retry %d/%d in %.2fs",
                description or getattr(fn, "__name__", "operation"),
                exc, attempt, retries, delay,
            )
            sleep(delay)


class RateLimitedLogger:
    """Emit at most one log line per ``min_interval_s``, counting the rest.

    The drop-path companion of :func:`retry_call`: when an append-only log
    write keeps failing, the operator needs ONE line saying rows are being
    dropped — not one line per dropped row flooding the very log stream
    that still works.
    """

    def __init__(self, log: Callable, *, min_interval_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self._log = log
        self._min_interval_s = min_interval_s
        self._clock = clock
        self._last: Optional[float] = None
        self.suppressed = 0
        self.emitted = 0

    def __call__(self, msg: str, *fmt_args) -> bool:
        """Log ``msg`` if the interval allows; returns True when emitted."""
        now = self._clock()
        if self._last is not None and now - self._last < self._min_interval_s:
            self.suppressed += 1
            return False
        suffix = (
            f" ({self.suppressed} similar suppressed)" if self.suppressed else ""
        )
        self._log(msg + suffix, *fmt_args)
        self._last = now
        self.emitted += 1
        self.suppressed = 0
        return True

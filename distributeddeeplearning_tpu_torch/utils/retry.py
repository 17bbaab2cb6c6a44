"""Bounded exponential backoff with full jitter — the port of
``utils/retry.py``'s ``retry_call``, the I/O retry policy the
checkpointer's writes go through.

- **bounded**: at most ``retries`` re-attempts, then the last exception
  propagates: a retry loop must never turn a hard failure into a hang;
- **exponential with full jitter**: the attempt-``i`` sleep is drawn
  uniformly from ``[0, min(max_delay, base_delay * 2**i)]``, which
  decorrelates writers that failed together.

``sleep`` and ``rng`` are injectable so tests check the bounds without
sleeping.  The reference's deadline, per-call hooks and registry counters
serve its preemption and chaos layers (ROADMAP A4's remainder) and come
with them.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional

logger = logging.getLogger("ddlt.retry")


def backoff_delays(retries: int, *, base_delay: float = 0.1,
                   max_delay: float = 5.0, rng: Optional[random.Random] = None):
    """The ``retries`` jittered sleeps of one retry sequence: delay ``i`` is
    uniform in ``[0, min(max_delay, base_delay * 2**i)]``."""
    rng = rng if rng is not None else random
    for attempt in range(retries):
        cap = min(max_delay, base_delay * (2.0 ** attempt))
        yield rng.uniform(0.0, cap)


def retry_call(fn: Callable, *args, retries: int = 3, base_delay: float = 0.1,
               max_delay: float = 5.0, sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None, description: str = "",
               **kwargs):
    """``fn(*args, **kwargs)``, retried on any ``Exception`` up to
    ``retries`` times with full-jitter backoff; the final failure
    re-raises.  ``description`` names the operation in the log."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    delays = backoff_delays(retries, base_delay=base_delay, max_delay=max_delay,
                            rng=rng)
    name = description or getattr(fn, "__name__", "operation")
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:
            if attempt == retries:
                raise
            delay = next(delays)
            logger.warning("%s failed (%s); retry %d/%d in %.2fs", name, exc,
                           attempt + 1, retries, delay)
            sleep(delay)

"""Wall-clock timer usable as context manager or decorator — the port of
``utils/timer.py``: one implementation, monotonic clock, an optional
callback for log routing and an optional histogram every stop feeds, and
an ``elapsed`` property usable while still running.  It reads the host's
clock: around work on the card it measures the enqueue unless the work
ends in ``torch.cuda.synchronize()``."""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional


class Timer:
    """Measure elapsed wall-clock seconds::

        with Timer() as t:
            work()
        print(t.elapsed)

        @Timer(report=log.info, prefix="train")
        def step(...): ...
    """

    def __init__(self, report: Optional[Callable[[str], None]] = None,
                 prefix: Optional[str] = None, round_ndigits: int = 4,
                 histogram=None):
        self._report = report
        self._prefix = prefix
        self._round = round_ndigits
        # anything with .record(seconds), e.g. an obs.registry.Histogram
        self._histogram = histogram
        self._start: Optional[float] = None
        self._stop: Optional[float] = None

    def start(self) -> "Timer":
        self._start = time.monotonic()
        self._stop = None
        return self

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer.stop() called before start()")
        self._stop = time.monotonic()
        if self._histogram is not None:
            self._histogram.record(self.elapsed)
        if self._report is not None:
            self._report(f"{self._prefix or 'elapsed'}: {round(self.elapsed, self._round)}s")
        return self.elapsed

    @property
    def running(self) -> bool:
        return self._start is not None and self._stop is None

    @property
    def elapsed(self) -> float:
        if self._start is None:
            return 0.0
        end = self._stop if self._stop is not None else time.monotonic()
        return end - self._start

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Timer(self._report, prefix=self._prefix or fn.__name__,
                       round_ndigits=self._round, histogram=self._histogram):
                return fn(*args, **kwargs)

        return wrapper


def timer(**kwargs) -> Timer:
    """Decorator-style alias, as the reference's ``@timer(...)``."""
    return Timer(**kwargs)

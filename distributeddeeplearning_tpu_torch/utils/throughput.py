"""Examples/sec measurement — the port of ``utils/throughput.py`` (pure
Python, the same class).

Parity with ``ExamplesPerSecondHook`` (``TensorFlow_imagenet/src/utils.py:15-75``):
logs average examples/sec since start and instantaneous examples/sec over the
last window, every ``every_n_steps`` steps at the *global* batch size
(batch × world size), plus the end-of-run summary the reference prints in
``_log_summary`` (``resnet_main.py:184-200``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional


class ExamplesPerSecondTracker:
    def __init__(
        self,
        global_batch_size: int,
        every_n_steps: int = 100,
        report: Optional[Callable[[str], None]] = None,
    ):
        self.global_batch_size = global_batch_size
        self.every_n_steps = every_n_steps
        self._report = report or logging.getLogger("ddlt.throughput").info
        self._start: Optional[float] = None
        self._window_start: Optional[float] = None
        self._total_steps = 0
        self._window_steps = 0
        self.average_examples_per_sec = 0.0
        self.current_examples_per_sec = 0.0

    def begin(self) -> None:
        now = time.monotonic()
        self._start = now
        self._window_start = now

    def after_step(self, n_steps: int = 1) -> None:
        if self._start is None:
            self.begin()
        self._total_steps += n_steps
        self._window_steps += n_steps
        if self._window_steps >= self.every_n_steps:
            now = time.monotonic()
            total_elapsed = now - self._start
            window_elapsed = now - self._window_start
            if total_elapsed > 0:
                self.average_examples_per_sec = (
                    self.global_batch_size * self._total_steps / total_elapsed
                )
            if window_elapsed > 0:
                self.current_examples_per_sec = (
                    self.global_batch_size * self._window_steps / window_elapsed
                )
            self._report(
                "Average examples/sec: %.1f (%.1f current), step = %d"
                % (
                    self.average_examples_per_sec,
                    self.current_examples_per_sec,
                    self._total_steps,
                )
            )
            self._window_start = now
            self._window_steps = 0

    def summary(self, total_examples: Optional[int] = None) -> float:
        """End-of-run images/sec = total images / wall-clock."""
        if self._start is None:
            return 0.0
        elapsed = time.monotonic() - self._start
        if total_examples is None:
            total_examples = self._total_steps * self.global_batch_size
        return total_examples / elapsed if elapsed > 0 else 0.0

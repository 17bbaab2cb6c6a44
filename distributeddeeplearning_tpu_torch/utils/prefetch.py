"""Host-to-device input prefetch — the port of ``utils/prefetch.py``:
overlap the next batches' copies with the card's work on this one.

A worker thread pulls up to ``size`` batches ahead of the consumer.  On
the card it puts each batch's arrays in pinned host memory and copies
them with ``non_blocking=True`` on a side CUDA stream, then records an
event there; the consumer's stream waits on that event (a device-side
wait: the host does not block), and each staged tensor is marked with
``record_stream`` for the consumer's stream, without which the caching
allocator could hand a tensor's memory back to the side stream while the
consumer's kernels still read it.  On the CPU the worker only wraps the
arrays as tensors (no copy, no streams).

Bounded queue (backpressure); ``close()`` reaps the worker thread
deterministically (draining the queue until the thread joins), and an
exception from the source iterator (a ``DataStreamDeath``, a stream that
stops) is raised at the consumer's ``next()`` **in order**: when the
consumer reaches that position, never before the batches staged ahead of
it.  The worker runs ahead of the consumer: up to ``size`` staged batches
(plus one in flight) are pulled from the source beyond what was yielded
and are dropped on close.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

logger = logging.getLogger("ddlt.prefetch")

_SENTINEL = object()


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Iterator over device-staged batches with a reapable worker thread."""

    def __init__(self, batches: Iterator, device, *, size: int = 2):
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        self._batches = batches
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._done = False
        self._closed = False
        self.thread = threading.Thread(target=self._work, name="ddlt-prefetch",
                                       daemon=True)
        self.thread.start()

    def _stage(self, batch):
        """``(staged batch, event or None)``: every array leaf as a tensor
        on the device, copied on the side stream."""
        if self._stream is None:
            return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if isinstance(v, (np.ndarray, torch.Tensor)):
                    t = torch.as_tensor(v)
                    if t.device.type == "cpu":
                        t = t.pin_memory()
                    v = t.to(self.device, non_blocking=True)
                out[k] = v
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _work(self) -> None:
        try:
            for b in self._batches:
                if self._stop.is_set():
                    return
                self._q.put(self._stage(b))
            self._q.put(_SENTINEL)
        except BaseException as exc:  # noqa: BLE001 — re-raised at next()
            self._q.put(_WorkerError(exc))

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._closed:
            raise RuntimeError("prefetch iterator used after close()")
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, _WorkerError):
            self._done = True
            raise item.exc
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                    v.record_stream(consumer)
        return batch

    def __del__(self):
        # GC safety net: unblock and release the worker WITHOUT joining (no
        # blocking in a finalizer); deterministic reaping is close()'s job
        try:
            self._stop.set()
            while True:
                self._q.get_nowait()
        except Exception:
            pass

    def close(self, timeout: float = 5.0) -> None:
        """Stop and reap the worker: set the stop flag, then drain the
        queue until the thread joins (it can be blocked in ``put`` at any
        of its three put sites), bounded by ``timeout`` (a worker stuck
        inside the source cannot be interrupted; it is daemonic and is
        reported, not waited on forever)."""
        self._closed = True
        if not self.thread.is_alive():
            return
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self.thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                logger.warning(
                    "prefetch worker did not exit within %.1fs of close() — "
                    "blocked inside the input source? (daemon thread leaked)",
                    timeout)
                return


def prefetch_to_device(batches: Iterator, device, *, size: int = 2) -> PrefetchIterator:
    """Yield each batch of ``batches`` with its arrays staged on ``device``,
    ``size`` deep from a background thread.  Call ``close()`` to reap the
    worker."""
    return PrefetchIterator(batches, device, size=size)

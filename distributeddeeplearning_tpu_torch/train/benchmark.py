"""Synthetic throughput benchmark harness — the port of ``train/benchmark.py``.

N warmup batches, then ``num_iters`` timed windows of ``num_batches_per_iter``
train steps each; img/s per device is reported as the mean ±1.96σ over the
windows, and the total as devices x mean.

Each window is bounded by a host read of one step's loss (``float``, the
only sync of the loop), and the read for window i happens only after
window i+1's steps have been launched, so the device never drains between
windows and the read's latency cancels out of the window-to-window
deltas.  One extra window is launched first and not measured: the
warmup's read drained the device, and that window pays the refill.  This
overlap holds only while nothing inside a step syncs the host: the port's
train step reads no device value (``train/step.py``).

One departure from the reference's loop, which reads its last measured
window with nothing launched behind it: there, when the host launches
steps more slowly than the device runs them (an eager PyTorch step can),
that window's delta covers no launching and comes out near 0 s, and the
mean is meaningless.  The port launches one more unmeasured window after
the last measured one, so every measured read follows the next window's
launches, as the rule says; its loss is read at the end to drain the
device.  The step count is ``num_warmup_batches + (num_iters + 2) *
num_batches_per_iter``, one window more than the reference's.

Under data parallelism (one process per device) every rank runs the
loop on its rows; the step's gradient all-reduce keeps the ranks in
lockstep, so each rank's windows time the world's step, and
``num_devices`` (the world, by default the process group's size) turns
the per-device rate into the total.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, List, Optional

from distributeddeeplearning_tpu_torch.parallel.distributed import process_count


@dataclasses.dataclass
class BenchmarkResult:
    model: str
    batch_size_per_chip: int
    num_devices: int
    img_sec_per_chip_mean: float
    img_sec_per_chip_ci95: float
    img_sec_total: float
    iter_times_s: List[float]

    def summary_lines(self) -> List[str]:
        return [
            f"Model: {self.model}",
            f"Batch size: {self.batch_size_per_chip} per chip",
            f"Number of chips: {self.num_devices}",
            f"Img/sec per chip: {self.img_sec_per_chip_mean:.1f} "
            f"+-{self.img_sec_per_chip_ci95:.1f}",
            f"Total img/sec on {self.num_devices} chip(s): "
            f"{self.img_sec_total:.1f} "
            f"+-{self.img_sec_per_chip_ci95 * self.num_devices:.1f}",
        ]


def _windowed_benchmark(
    step_fn: Callable,
    state,
    next_batch: Callable[[], object],
    *,
    model_name: str,
    batch_size_per_chip: int,
    num_devices: int,
    num_warmup_batches: int,
    num_iters: int,
    num_batches_per_iter: int,
    log: Optional[Callable[[str], None]],
    label: str,
) -> BenchmarkResult:
    """Warmup, then ``num_iters + 2`` overlapped windows (the first and the
    last not measured); t[i] is the host time at which window i's last
    loss was read, and the deltas give the windows' img/s."""
    global_batch = batch_size_per_chip * num_devices

    if log:
        log(f"Running {label}warmup ({num_warmup_batches} batches)...")
    metrics = None
    for _ in range(num_warmup_batches):
        state, metrics = step_fn(state, next_batch())
    if metrics is not None:
        float(metrics["loss"])  # wait for the warmup to finish

    if log:
        log(
            f"Running {label}benchmark ({num_iters} iters x "
            f"{num_batches_per_iter} batches)..."
        )
    img_secs: List[float] = []
    iter_times: List[float] = []
    t_prev = None
    pending = None  # window i-1's metrics, read after window i is launched
    for _ in range(num_iters + 2):
        for _ in range(num_batches_per_iter):
            state, metrics = step_fn(state, next_batch())
        if pending is not None:
            float(pending["loss"])
            now = time.perf_counter()
            if t_prev is not None:
                dt = now - t_prev
                iter_times.append(dt)
                img_secs.append(
                    global_batch * num_batches_per_iter / dt / num_devices
                )
            t_prev = now
        pending = metrics
    float(pending["loss"])  # the trailing window drains, not measured

    mean = statistics.fmean(img_secs)
    stdev = statistics.stdev(img_secs) if len(img_secs) > 1 else 0.0
    result = BenchmarkResult(
        model=model_name,
        batch_size_per_chip=batch_size_per_chip,
        num_devices=num_devices,
        img_sec_per_chip_mean=mean,
        img_sec_per_chip_ci95=1.96 * stdev,
        img_sec_total=mean * num_devices,
        iter_times_s=iter_times,
    )
    if log:
        for line in result.summary_lines():
            log(line)
    return result


def run_benchmark(
    step_fn: Callable,
    state,
    batch,
    *,
    model_name: str = "model",
    batch_size_per_chip: int = 64,
    num_devices: Optional[int] = None,
    num_warmup_batches: int = 10,
    num_iters: int = 10,
    num_batches_per_iter: int = 10,
    log: Optional[Callable[[str], None]] = None,
) -> BenchmarkResult:
    """Benchmark ``step_fn(state, batch) -> (state, metrics)`` on one
    resident ``batch`` (already on the device)."""
    return _windowed_benchmark(
        step_fn,
        state,
        lambda: batch,
        model_name=model_name,
        batch_size_per_chip=batch_size_per_chip,
        num_devices=num_devices or process_count(),
        num_warmup_batches=num_warmup_batches,
        num_iters=num_iters,
        num_batches_per_iter=num_batches_per_iter,
        log=log,
        label="",
    )


def run_data_benchmark(
    step_fn: Callable,
    state,
    device_batches,
    *,
    model_name: str = "model",
    batch_size_per_chip: int = 64,
    num_devices: Optional[int] = None,
    num_warmup_batches: int = 10,
    num_iters: int = 10,
    num_batches_per_iter: int = 10,
    log: Optional[Callable[[str], None]] = None,
) -> BenchmarkResult:
    """The same, each step taking the next batch of ``device_batches``, so
    the rate includes the input pipeline.  Raises ``StopIteration`` if it
    runs dry before ``num_warmup_batches + (num_iters + 2) *
    num_batches_per_iter`` batches."""
    it = iter(device_batches)
    return _windowed_benchmark(
        step_fn,
        state,
        lambda: next(it),
        model_name=model_name,
        batch_size_per_chip=batch_size_per_chip,
        num_devices=num_devices or process_count(),
        num_warmup_batches=num_warmup_batches,
        num_iters=num_iters,
        num_batches_per_iter=num_batches_per_iter,
        log=log,
        label="data-fed ",
    )

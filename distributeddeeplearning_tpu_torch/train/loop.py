"""The training loop — the single-process core of ``train/loop.py``.

:class:`Trainer` runs epochs x ``steps_per_epoch`` train steps, an eval
pass after each epoch, one JSONL metrics row per epoch, and returns a
:class:`FitResult`.  Step metrics accumulate ON THE DEVICE (one small add
per step); the host synchronises only every ``log_every`` steps and at the
end of each epoch, because a per-step readback would make the host wait
for the card every step and stop it from queueing the next one.

Checkpointing and resume, TensorBoard, the profiler window, the preemption
guard, the anomaly detector, the step watchdog, registry snapshots and the
goodput ledger are ROADMAP item 12's remainder: asking for any of them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

logger = logging.getLogger("ddlt.train")

# fields of the reference's TrainerConfig that belong to item 12's remainder
_NOT_YET = ("checkpoint_dir", "checkpoint_every_steps", "tensorboard_dir",
            "profile_dir", "preemption_guard", "anomaly_max_consecutive",
            "anomaly_rollback", "step_deadline_s", "obs_metrics_path",
            "goodput_path")


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 90
    steps_per_epoch: int = 0
    eval_steps: Optional[int] = None  # None = drain the eval iterator
    global_batch_size: int = 0
    log_every: int = 100
    metrics_path: Optional[str] = None  # per-epoch JSONL rows
    # resume only matters with a checkpoint_dir, as in the reference
    resume: bool = True
    # -- ROADMAP item 12's remainder: raise when set --
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: Optional[int] = None
    tensorboard_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    preemption_guard: Optional[bool] = None
    anomaly_max_consecutive: Optional[int] = None
    anomaly_rollback: bool = False
    step_deadline_s: Optional[float] = None
    obs_metrics_path: Optional[str] = None
    goodput_path: Optional[str] = None


class MetricsLog:
    """Append-only JSONL of per-epoch metric rows (local paths).  Best
    effort: a failed write is counted in ``dropped_rows`` and logged, and
    never stops training."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.dropped_rows = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, row: Dict[str, Any]) -> None:
        if not self.path:
            return
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError as exc:
            self.dropped_rows += 1
            logger.warning("metrics row dropped (%d so far, path %s): %s",
                           self.dropped_rows, self.path, exc)


@dataclasses.dataclass
class FitResult:
    epochs_run: int
    final_train_metrics: Dict[str, float]
    final_eval_metrics: Optional[Dict[str, float]]
    total_images: int
    train_wall_seconds: float
    anomalous_steps: int = 0
    rollbacks: int = 0

    @property
    def images_per_second(self) -> float:
        return self.total_images / max(self.train_wall_seconds, 1e-9)


def _sync(metrics: Dict[str, torch.Tensor]) -> None:
    """Wait for the device that holds ``metrics`` (no-op on the CPU)."""
    v = next(iter(metrics.values()), None)
    if v is not None and v.device.type == "cuda":
        torch.cuda.synchronize(v.device)


class Trainer:
    def __init__(self, train_step: Callable, *,
                 eval_step: Optional[Callable] = None, config: TrainerConfig):
        if config.steps_per_epoch <= 0:
            raise ValueError("steps_per_epoch must be positive")
        for name in _NOT_YET:
            if getattr(config, name) not in (None, False):
                raise NotImplementedError(
                    f"TrainerConfig.{name}: checkpoints, TensorBoard, the "
                    "profiler window and the resilience/goodput layer are "
                    "ROADMAP item 12's remainder, not in the port yet"
                )
        self.train_step = train_step
        self.eval_step = eval_step
        self.config = config
        self.metrics_log = MetricsLog(config.metrics_path)

    def fit(self, state, train_batches: Iterator,
            eval_batches_factory: Optional[Callable[[], Iterator]] = None):
        """Run the epoch loop; returns ``(state, FitResult)``."""
        cfg = self.config
        train_t0 = time.monotonic()
        total_images = 0
        train_metrics: Dict[str, float] = {}
        eval_metrics: Optional[Dict[str, float]] = None
        for epoch in range(cfg.epochs):
            acc = None
            epoch_t0 = log_t0 = time.monotonic()
            for step_i in range(cfg.steps_per_epoch):
                state, metrics = self.train_step(state, next(train_batches))
                acc = metrics if acc is None else {
                    k: acc[k] + v for k, v in metrics.items()}
                total_images += cfg.global_batch_size
                if (step_i + 1) % cfg.log_every == 0:
                    _sync(acc)
                    now = time.monotonic()
                    logger.info("examples/sec: %.2f", cfg.global_batch_size
                                * cfg.log_every / max(now - log_t0, 1e-9))
                    log_t0 = now
            train_metrics = {k: float(v) / cfg.steps_per_epoch
                             for k, v in acc.items()}
            epoch_train_wall = time.monotonic() - epoch_t0
            logger.info("epoch %d/%d: %s", epoch + 1, cfg.epochs,
                        {k: round(v, 4) for k, v in train_metrics.items()})
            if self.eval_step is not None and eval_batches_factory is not None:
                eval_metrics = self.evaluate(state, eval_batches_factory())
                logger.info("epoch %d validation: %s", epoch + 1,
                            {k: round(v, 4) for k, v in eval_metrics.items()})
            row: Dict[str, Any] = {"epoch": epoch + 1}
            row.update({f"train_{k}": v for k, v in train_metrics.items()})
            if eval_metrics:
                row.update({f"val_{k}": v for k, v in eval_metrics.items()})
            row["images_per_second"] = (
                cfg.steps_per_epoch * cfg.global_batch_size
            ) / max(epoch_train_wall, 1e-9)
            if epoch == 0:
                # the first epoch's wall includes the kernel builds and the
                # first-call warm-up of the CUDA libraries
                row["includes_compile"] = True
            self.metrics_log.append(row)
        result = FitResult(
            epochs_run=cfg.epochs,
            final_train_metrics=train_metrics,
            final_eval_metrics=eval_metrics,
            total_images=total_images,
            train_wall_seconds=time.monotonic() - train_t0,
        )
        if total_images:
            logger.info("total images/sec: %.2f", result.images_per_second)
        return state, result

    def evaluate(self, state, eval_batches: Iterator) -> Dict[str, float]:
        """Size-weighted mean of the eval metrics over the batches (at most
        ``eval_steps``); sums stay on the device until the final read."""
        limit = self.config.eval_steps
        sums: Dict[str, torch.Tensor] = {}
        total_weight = steps = 0
        for batch in eval_batches:
            if limit is not None and steps >= limit:
                break
            size = len(next(iter(batch.values())))
            for k, v in self.eval_step(state, batch).items():
                sums[k] = v * size if k not in sums else sums[k] + v * size
            total_weight += size
            steps += 1
        if not sums or total_weight == 0:
            return {}
        return {k: float(v) / total_weight for k, v in sums.items()}

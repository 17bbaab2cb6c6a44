"""Host-side utilities of the port (``utils/`` of the reference): logging,
metrics, the timer, the retry policy, the examples/sec tracker, and the
modules imported by name (``faults``, ``hardware``, ``prefetch``,
``roofline``)."""

from distributeddeeplearning_tpu_torch.utils.logging_utils import (
    get_logger,
    is_primary,
    setup_logging,
)
from distributeddeeplearning_tpu_torch.utils.metrics import (
    AverageMeter,
    accuracy_topk,
    confidence_interval_95,
    pmean_metrics,
    topk_correct,
)
from distributeddeeplearning_tpu_torch.utils.retry import (
    RateLimitedLogger,
    backoff_delays,
    retry_call,
)
from distributeddeeplearning_tpu_torch.utils.throughput import ExamplesPerSecondTracker
from distributeddeeplearning_tpu_torch.utils.timer import Timer, timer

__all__ = [
    "AverageMeter",
    "ExamplesPerSecondTracker",
    "RateLimitedLogger",
    "Timer",
    "accuracy_topk",
    "backoff_delays",
    "confidence_interval_95",
    "get_logger",
    "is_primary",
    "pmean_metrics",
    "retry_call",
    "setup_logging",
    "timer",
    "topk_correct",
]

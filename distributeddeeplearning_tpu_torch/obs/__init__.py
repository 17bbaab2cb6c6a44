"""Observability of the port: the metrics registry and its percentile
histogram (``registry``), the span tracer (``trace``), the crash flight
recorder (``recorder``) and the goodput ledger (``goodput``)."""

from distributeddeeplearning_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    summarize,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
           "summarize"]

"""Observability of the port: the metrics registry and its percentile
histogram (``registry``), the span tracer (``trace``), the crash flight
recorder (``recorder``), the goodput ledger (``goodput``) and the
device-memory ledger by owner (``ledger``)."""

from distributeddeeplearning_tpu_torch.obs.ledger import (
    HBMLedger,
    get_ledger,
    set_ledger,
)
from distributeddeeplearning_tpu_torch.obs.recorder import (
    FlightRecorder,
    get_recorder,
    set_recorder,
)
from distributeddeeplearning_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
    summarize,
)
from distributeddeeplearning_tpu_torch.obs.trace import (
    Tracer,
    get_tracer,
    set_tracer,
)

__all__ = ["Counter", "FlightRecorder", "Gauge", "HBMLedger", "Histogram",
           "MetricsRegistry", "Tracer", "get_ledger", "get_recorder",
           "get_registry", "get_tracer", "set_ledger", "set_recorder",
           "set_registry", "set_tracer", "summarize"]

"""Observability of the port (the reference's ``obs/``):

- :mod:`.trace` — nested host spans + instant events with
  ``torch.profiler.record_function`` pass-through, exported as
  Chrome-trace JSON; zero-sync and near-zero-cost when disabled;
- :mod:`.registry` — counters, gauges and streaming-percentile
  histograms, snapshotted to JSONL;
- :mod:`.recorder` — the crash flight recorder: a bounded ring of recent
  spans, events and metric deltas that stays on with the tracer disabled;
- :mod:`.fleet` — fleet-scale merge: worker trace shards on the router's
  clock, bucket-merged metrics and the SLO gate;
- :mod:`.goodput` — the goodput ledger: a training run's wall classified
  into named categories, with run-level MFU and the residual gate;
- :mod:`.ledger` — the device-memory ledger by owner, its reconciliation
  against the allocator and the admission forecast;
- :mod:`.attrib` — per-program cost attribution: every engine and step
  program's FLOPs and bytes (counted on ``meta`` copies), achieved-vs-
  roofline per program, straggler timing and the compute-vs-collective
  estimate;
- :mod:`.profile` — a ``torch.profiler`` window merged with the host spans
  onto one clock, the per-phase decode breakdown (the int8 decode
  attribution) and the regression attribution;
- :mod:`.schema` and :mod:`.history` — artifact validation and the
  perf-trajectory tracker (pure Python, the reference's own copies).
"""

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
    merge_states,
    set_registry,
    summarize,
)
from distributeddeeplearning_tpu_torch.obs.trace import (
    Tracer,
    configure,
    get_tracer,
    set_tracer,
)

__all__ = ["Counter", "FlightRecorder", "Gauge", "HBMLedger", "Histogram",
           "MetricsRegistry", "Tracer", "configure", "get_ledger", "get_recorder",
           "get_registry", "get_tracer", "merge_states", "set_ledger",
           "set_recorder", "set_registry", "set_tracer", "summarize"]

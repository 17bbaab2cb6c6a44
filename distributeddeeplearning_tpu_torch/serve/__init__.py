"""Serving stack of the port: dense and paged KV caches, the host page
tier beneath the paged pool, the engines (tensor-parallel over processes
too), continuous batching with chunked prefill, priority classes,
shedding, lossless preemption and live reload, and synthetic
multi-tenant traffic, and the supervised multi-replica fleet."""

from distributeddeeplearning_tpu_torch.serve.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    PrefillTask,
    data_parallel_engine,
    prompt_bucket,
    sample_logits,
    tensor_parallel_engine,
)
from distributeddeeplearning_tpu_torch.serve.fleet import (
    FleetReport,
    FleetRouter,
    ReplicaSpec,
    serve_fleet,
)
from distributeddeeplearning_tpu_torch.serve.kv_cache import (
    SCRATCH_PAGE,
    OutOfPages,
    PageAllocator,
    cache_bytes,
    cache_sharding,
    init_cache,
    init_paged_cache,
    insert_pages,
    insert_sequence,
    page_bytes,
    pages_for,
)
from distributeddeeplearning_tpu_torch.serve.kv_tier import (
    TIER_POLICIES,
    HostPageTier,
)
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    FINISH_REASONS,
    CompletedRequest,
    ContinuousBatchingScheduler,
    Request,
    ServeReport,
    synthetic_requests,
)
from distributeddeeplearning_tpu_torch.serve.traffic import (
    TenantSpec,
    TimedRequest,
    TrafficGenerator,
    poll_source,
)

__all__ = [
    "FINISH_REASONS",
    "SCRATCH_PAGE",
    "TIER_POLICIES",
    "CompletedRequest",
    "ContinuousBatchingScheduler",
    "FleetReport",
    "FleetRouter",
    "HostPageTier",
    "InferenceEngine",
    "OutOfPages",
    "PageAllocator",
    "PagedInferenceEngine",
    "PrefillTask",
    "ReplicaSpec",
    "Request",
    "ServeReport",
    "TenantSpec",
    "TimedRequest",
    "TrafficGenerator",
    "cache_bytes",
    "cache_sharding",
    "data_parallel_engine",
    "init_cache",
    "init_paged_cache",
    "insert_pages",
    "insert_sequence",
    "page_bytes",
    "pages_for",
    "poll_source",
    "prompt_bucket",
    "sample_logits",
    "serve_fleet",
    "synthetic_requests",
    "tensor_parallel_engine",
]

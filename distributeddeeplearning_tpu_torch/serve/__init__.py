"""Serving stack of the port: dense and paged KV caches, the engines and
continuous batching with chunked prefill."""

from distributeddeeplearning_tpu_torch.serve.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    PrefillTask,
    prompt_bucket,
    sample_logits,
)
from distributeddeeplearning_tpu_torch.serve.kv_cache import (
    SCRATCH_PAGE,
    OutOfPages,
    PageAllocator,
    cache_bytes,
    init_cache,
    init_paged_cache,
    insert_pages,
    insert_sequence,
    page_bytes,
    pages_for,
)
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    CompletedRequest,
    ContinuousBatchingScheduler,
    Request,
    ServeReport,
    synthetic_requests,
)

__all__ = [
    "SCRATCH_PAGE",
    "CompletedRequest",
    "ContinuousBatchingScheduler",
    "InferenceEngine",
    "OutOfPages",
    "PageAllocator",
    "PagedInferenceEngine",
    "PrefillTask",
    "Request",
    "ServeReport",
    "cache_bytes",
    "init_cache",
    "init_paged_cache",
    "insert_pages",
    "insert_sequence",
    "page_bytes",
    "pages_for",
    "prompt_bucket",
    "sample_logits",
    "synthetic_requests",
]

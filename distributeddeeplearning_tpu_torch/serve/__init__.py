"""Serving stack of the port: dense and paged KV caches, the engines
(tensor-parallel over processes too) and continuous batching with chunked
prefill."""

from distributeddeeplearning_tpu_torch.serve.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    PrefillTask,
    prompt_bucket,
    sample_logits,
    tensor_parallel_engine,
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
    "cache_sharding",
    "init_cache",
    "init_paged_cache",
    "insert_pages",
    "insert_sequence",
    "page_bytes",
    "pages_for",
    "prompt_bucket",
    "sample_logits",
    "synthetic_requests",
    "tensor_parallel_engine",
]

"""Serving stack of the port: dense KV cache, engine, continuous batching."""

from distributeddeeplearning_tpu_torch.serve.engine import (
    InferenceEngine,
    prompt_bucket,
    sample_logits,
)
from distributeddeeplearning_tpu_torch.serve.kv_cache import (
    cache_bytes,
    init_cache,
    insert_sequence,
)
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    CompletedRequest,
    ContinuousBatchingScheduler,
    Request,
    ServeReport,
    synthetic_requests,
)

__all__ = [
    "CompletedRequest",
    "ContinuousBatchingScheduler",
    "InferenceEngine",
    "Request",
    "ServeReport",
    "cache_bytes",
    "init_cache",
    "insert_sequence",
    "prompt_bucket",
    "sample_logits",
    "synthetic_requests",
]

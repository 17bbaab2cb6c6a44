"""Observability of the port: the percentile histogram the serve reports use."""

from distributeddeeplearning_tpu_torch.obs.registry import Histogram, summarize

__all__ = ["Histogram", "summarize"]

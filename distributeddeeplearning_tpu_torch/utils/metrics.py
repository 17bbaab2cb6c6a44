"""Training metrics: running averages, top-k accuracy, the mean over the
ranks — the port of ``utils/metrics.py``.

The train and eval steps compute accuracy on the card
(``train.step.classification_metrics`` reads :func:`topk_correct`) and
reduce it over the data-parallel group; the host-side meters here only
aggregate already-reduced scalars over time.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


class AverageMeter:
    """Current value, running sum and average of a scalar stream (the
    reference's; ``obs.registry`` supersedes it for new code)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


def topk_correct(logits: torch.Tensor, labels, k: int) -> torch.Tensor:
    """The number of rows (f32) whose label is among the top-k logits,
    ties broken to the lower index as ``jax.lax.top_k`` breaks them (the
    first maximum for k = 1; a stable descending sort otherwise)."""
    k = min(k, logits.shape[-1])
    scores = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    if k == 1:
        top = scores.argmax(dim=-1, keepdim=True)
    else:
        top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    return (top == labels[:, None]).any(dim=-1).float().sum()


def accuracy_topk(logits: torch.Tensor, labels,
                  ks: Tuple[int, ...] = (1, 5)) -> Dict[str, torch.Tensor]:
    """Top-k accuracies as fractions in [0, 1] (the reference's PyTorch
    recipe reports percent)."""
    batch = logits.shape[0]
    return {f"top{k}": topk_correct(logits, labels, k) / batch for k in ks}


def pmean_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The mean of a metrics dict over the ranks of ``group`` (the
    reference's ``lax.pmean`` over a named axis): one all-reduce a dtype
    for the whole dict (``parallel.collectives.pmean``); the dict itself
    without a process group."""
    from distributeddeeplearning_tpu_torch.parallel import collectives

    return collectives.pmean(dict(metrics), group)


def confidence_interval_95(samples) -> Tuple[float, float]:
    """mean and 1.96 sigma of a sample list (population sigma) — the
    reference benchmark's reporting convention."""
    n = len(samples)
    if n == 0:
        return 0.0, 0.0
    mean = sum(samples) / n
    var = sum((s - mean) ** 2 for s in samples) / n
    return mean, 1.96 * math.sqrt(var)

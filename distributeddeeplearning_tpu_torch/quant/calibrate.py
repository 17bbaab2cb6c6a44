"""Post-training weight quantization of the LM's parameters
(``quant/calibrate.py``).

:func:`quantize_params` turns the matmul weights (``blocks.{qkv, proj,
w_in, w_out}`` and ``head``) into :class:`~.qtensor.QTensor` leaves with
per-output-channel f32 scales; the embedding, position table and
layer-norm gains stay f32.  Two scale observers: absmax (exact range) and
a per-channel percentile of ``|w|`` (the outlier tail saturates, the bulk
gets the finer grid).  :func:`calibrate_params` quantizes, runs a few
prompts through the f32 and the int8 forward, and reports per-position
logit error and greedy agreement.

The reference's ``abstract_quantized_params`` (``jax.eval_shape`` for the
static audit) has no counterpart yet: the port has no static analysis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.quant.qtensor import QTensor, quantize

Params = Dict[str, Any]

#: Block-stack matmul leaves that quantize (contraction dim at -2 after
#: the leading [L] dim, so the QTensor metadata holds per layer too).
BLOCK_MATMUL_LEAVES = ("qkv", "proj", "w_in", "w_out")


class AbsmaxObserver:
    """scale = max|w| per channel — the default, exact-range observer."""

    def __call__(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        return x.abs().amax(dim=axis, keepdim=True)


class PercentileObserver:
    """scale = the ``percentile``-th percentile of |w| per channel.

    A sort along ``axis`` and numpy's linear interpolation between the two
    neighbouring order statistics, in f32 as ``jnp.percentile`` computes
    it: ``q = percentile / 100 * (n - 1)``, ``lo = floor(q)``, ``hi =
    ceil(q)``, ``a[lo] * (1 - (q - lo)) + a[hi] * (q - lo)``; a channel
    holding a NaN gives NaN.  (``torch.quantile`` refuses inputs above
    2^24 elements, and the head alone holds 768 x 32768.)"""

    def __init__(self, percentile: float = 99.9):
        if not 0.0 < percentile <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], got {percentile}")
        self.percentile = percentile

    def __call__(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        a = x.abs()
        n = a.shape[axis]
        q = (torch.tensor(self.percentile, dtype=torch.float32) / 100) * (n - 1)
        lo, hi = torch.floor(q), torch.ceil(q)
        hi_w = q - lo
        lo_w = 1 - hi_w
        srt = torch.sort(a, dim=axis).values
        lo_v = srt.narrow(axis, int(lo), 1)
        hi_v = srt.narrow(axis, int(hi), 1)
        out = lo_v * lo_w.to(a.device) + hi_v * hi_w.to(a.device)
        return torch.where(torch.isnan(a).any(dim=axis, keepdim=True),
                           float("nan"), out)


def _make_observer(method: str, percentile: float):
    if method == "absmax":
        return AbsmaxObserver()
    if method == "percentile":
        return PercentileObserver(percentile)
    raise ValueError(f"unknown observer method {method!r}")


def quantize_params(params: Params, *, method: str = "absmax",
                    percentile: float = 99.9,
                    block: Optional[int] = None) -> Params:
    """The parameter dict with its matmul weights as int8 QTensors
    (per-output-channel scales, ``axis=-2``); embed/pos/ln pass through as
    the same tensors.  Quantizing an already-quantized tree raises:
    requantizing int8 codes would double the error silently."""
    observer = _make_observer(method, percentile)

    def q(w):
        if isinstance(w, QTensor):
            raise ValueError("params are already quantized")
        return quantize(w, axis=-2, block=block, observer=observer)

    out = dict(params)
    out["blocks"] = dict(params["blocks"])
    for name in BLOCK_MATMUL_LEAVES:
        out["blocks"][name] = q(params["blocks"][name])
    out["head"] = q(params["head"])
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_dtype(params: Params) -> str:
    """``"int8"`` when any matmul leaf is a QTensor, else the parameters'
    dtype name (``"float32"``) — the ``weights_dtype`` of a ServeReport."""
    leaves = list(_leaves(params))
    if any(isinstance(leaf, QTensor) for leaf in leaves):
        return "int8"
    return str(leaves[0].dtype).replace("torch.", "")


@dataclasses.dataclass
class CalibrationReport:
    """Quantized-vs-f32 fidelity over the calibration prompts."""

    num_prompts: int
    num_positions: int  # real (unpadded) positions compared
    logit_mae: float  # mean |logit_q - logit_f32| over real positions
    logit_mae_max: float  # worst single position's mean-abs-error
    greedy_agreement: float  # fraction of positions with equal argmax
    method: str
    percentile: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@torch.inference_mode()
def calibrate_params(params: Params, prompts: Sequence[Sequence[int]], *,
                     num_heads: int, method: str = "absmax",
                     percentile: float = 99.9, block: Optional[int] = None,
                     attention: str = "dense"):
    """Quantize the weights, then measure them: each calibration prompt
    runs through the f32 and the quantized forward, compared position by
    position.  Prompts are zero-padded to one batch (the forward is
    causal, so padding never reaches a real position) and only real
    positions count.  Returns ``(qparams, report)``."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        forward,
    )

    if not prompts:
        raise ValueError("calibration needs at least one prompt")
    if any(len(p) < 1 for p in prompts):
        raise ValueError("empty calibration prompt")
    qparams = quantize_params(params, method=method, percentile=percentile,
                              block=block)
    lens = [len(p) for p in prompts]
    tokens = np.zeros((len(prompts), max(lens)), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = np.asarray(p, np.int64)
    toks = torch.from_numpy(tokens).to(params["embed"].device)
    logits_f = forward(params, toks, num_heads=num_heads,
                       attention=attention).float().cpu().numpy()
    logits_q = forward(qparams, toks, num_heads=num_heads,
                       attention=attention).float().cpu().numpy()
    maes: List[float] = []
    agree = total = 0
    for i, n in enumerate(lens):
        err = np.abs(logits_q[i, :n] - logits_f[i, :n])  # [n, vocab]
        maes.extend(err.mean(axis=-1).tolist())
        agree += int((logits_q[i, :n].argmax(-1)
                      == logits_f[i, :n].argmax(-1)).sum())
        total += n
    report = CalibrationReport(
        num_prompts=len(prompts),
        num_positions=total,
        logit_mae=round(float(np.mean(maes)), 6),
        logit_mae_max=round(float(np.max(maes)), 6),
        greedy_agreement=round(agree / total, 4),
        method=method,
        percentile=percentile if method == "percentile" else None,
    )
    return qparams, report

"""KV-cache quantization — the KV part of ``quant/qtensor.py``.

Symmetric int8 with one f32 scale per stored K/V vector (per position and
head, over the head dim): ``x ≈ values * scale`` with ``values`` in
[-127, 127].  KV pages are written one token (decode) or one chunk
(prefill) at a time, so the scale granularity is at most one write: a
page-wide scale would have to requantize the page on every append.

The op order is the reference's — ``amax``, ``max(amax, EPS) / QMAX``,
``round(x / scale)`` (half to even in both frameworks), clip — with a true
division, never a multiply by a reciprocal, so codes and scales match the
JAX function bitwise on the same inputs.

The weight side (``QTensor``, ``quantize``, ``qdot``, ``qmatmul``) waits
for a later slice.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

#: Largest int8 code used; -128 stays unused (symmetric grid).
QMAX = 127.0
#: Floor on scales so an all-zero vector divides cleanly to zeros.
EPS = 1e-12


def quantized_cache(cache: Mapping[str, torch.Tensor]) -> bool:
    """True when a KV cache carries the int8 layout's scale leaves
    (``{"k", "v", "k_scale", "v_scale"}``) — the one layout predicate the
    model and the cache accounting share."""
    return "k_scale" in cache


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize K/V vectors ``[..., h, hd] -> (int8 [..., h, hd], f32
    scales [..., h])`` — one scale per head per position."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=EPS) / QMAX  # [..., h]
    values = torch.clamp(torch.round(x / scale[..., None]), -QMAX, QMAX)
    return values.to(torch.int8), scale


def dequantize_kv(values: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[..., h, hd] int8 * [..., h] -> [..., h, hd]`` in ``dtype``."""
    return (values.to(torch.float32) * scale[..., None]).to(dtype)

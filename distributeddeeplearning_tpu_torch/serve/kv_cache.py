"""Preallocated, slot-indexed dense KV cache (``serve/kv_cache.py``).

Layout: ``k, v: [batch_slots, n_layers, max_seq, n_heads, head_dim]``,
slot-major, allocated once and updated IN PLACE — where the reference
donated the buffers to each jitted touch, the port writes into them.
Sequence lengths are not device state: the scheduler owns per-slot
positions and passes them into every decode step.

This slice has the f32 dense layout only; the int8 layout is slice 3 and
the paged pool slice 2.
"""

from __future__ import annotations

from typing import Dict

import torch

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device

Cache = Dict[str, torch.Tensor]


def init_cache(
    *,
    batch_slots: int,
    num_layers: int,
    max_seq: int,
    num_heads: int,
    head_dim: int,
    device: DeviceLike = None,
) -> Cache:
    """Zero-filled f32 ``{"k", "v"}``, each [slots, L, S, h, hd].  Zeros
    are never read: the decode position mask hides every position above a
    slot's length, and admission overwrites from 0."""
    dev = resolve_device(device)
    shape = (batch_slots, num_layers, max_seq, num_heads, head_dim)
    return {"k": torch.zeros(shape, device=dev),
            "v": torch.zeros(shape, device=dev)}


def insert_sequence(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                    slot: int) -> Cache:
    """Write one prefilled prompt's K/V into ``slot``, positions [0, P),
    in place.  ``k``/``v``: [1, L, P, h, hd] (or [L, P, h, hd]) from
    ``forward_prefill``; P may be the padded prompt bucket — the padding
    lands above the slot's length and stays masked.  Returns ``cache``."""
    if k.dim() == 5:
        k, v = k[0], v[0]
    p = k.shape[1]
    cache["k"][slot, :, :p].copy_(k)
    cache["v"][slot, :, :p].copy_(v)
    return cache


def cache_bytes(cache: Cache) -> int:
    """Total cache footprint in bytes, over every leaf."""
    return sum(t.numel() * t.element_size() for t in cache.values())

"""Flash attention forward — the port of ``ops/flash_attention.py``.

On a CUDA tensor :func:`flash_attention_core` launches the hand-written
kernel ``csrc/flash_attention_fwd.cu`` (the counterpart of the Pallas
``_kernel`` launched by ``_flash_fwd_pallas``): causal or not, f32, head
dim 64, any sequence length.  On a CPU tensor it runs the kernel's plain
version, :func:`_dense_attention`, which is the reference's
``_dense_attention`` extended to return the log-sum-exp in nats.  There
is no fallback between the two and no switch: the tensor's device decides,
and a CUDA tensor the kernel cannot take raises.

The TPU wrapper's dense fallback for small auto-selected blocks is not
carried over: it worked around the TPU grid, and the CUDA kernel masks
its own ragged last tile, so every prompt bucket (192, 576, ...) runs the
kernel.  The key-padding mask is supported by the plain version only; on
the card it raises until BERT, its consumer, is ported.

Forward only: the backward kernels (TPU ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel``) come with training.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

NEG_BIG = -1e30  # finite mask fill; -inf poisons the online-softmax max
HEAD_DIM = 64  # the kernel's head dim

#: kernel launches since the counter was last reset
launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention_fwd").flash_attention_fwd_f32
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 9
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _dense_attention(q, k, v, mask, *, causal: bool):
    """Plain attention with the kernel's semantics: f32 softmax, key-
    padding ``mask`` (bool, broadcastable to [B, 1, 1, S]) and causal
    triangle filled with -1e30.  [B, S, H, D] in; returns ``(o [B, S, H,
    D], lse [B, H, S])`` with lse the log-sum-exp of the masked scores in
    nats."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / d ** 0.5)
    if mask is not None:
        key_mask = torch.broadcast_to(mask, (b, 1, 1, s))
        scores = torch.where(key_mask, scores, NEG_BIG)
    if causal:
        tril = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(tril, scores, NEG_BIG)
    lse = torch.logsumexp(scores, dim=-1)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v), lse


def _check_operand(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(
            f"flash_attention: {name} is {t.dtype}; the CUDA kernel takes "
            "float32 only (bf16 comes with the wgmma kernel)"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} shape {tuple(t.shape)} != {shape}")
    if t.stride(3) != 1 or any(st % 4 for st in t.stride()[:3]):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous head dim and "
            f"strides divisible by 4 (got {t.stride()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def _launch(q, k, v, *, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on [B, S, H, 64] f32 views (strided in place)."""
    global launches
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(
            f"flash_attention: the CUDA kernel takes head dim {HEAD_DIM}, "
            f"got {d}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, (b, s, h, d))
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only; the backward kernels "
            "come with training (port slice 5)"
        )
    o = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.data_ptr(), lse.data_ptr(), b, h, s, int(causal),
            1.0 / d ** 0.5, stream,
        )
    _build.check(code, "flash_attention_fwd_f32")
    launches += 1
    return o, lse


def flash_attention_core(q, k, v, *, causal: bool = False):
    """``(o [B, S, H, D], lse [B, H, S] nats)`` for [B, S, H, D] inputs —
    the CUDA kernel on a CUDA tensor, its plain version on a CPU one."""
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return _dense_attention(q, k, v, None, causal=causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    causal: bool = False,
) -> torch.Tensor:
    """Drop-in attention, [B, S, H, D] in and out (the reference's
    ``flash_attention`` without its TPU block arguments).

    ``mask``: bool key padding, broadcastable to [B, 1, 1, S] — plain
    version only for now.  ``causal=True`` applies the autoregressive
    triangle inside the kernel, skipping the tiles above the diagonal."""
    if mask is not None:
        if q.device.type == "cuda":
            raise NotImplementedError(
                "flash_attention: the key-padding mask is not in the CUDA "
                "kernel yet (its consumer, BERT, is port slice 6)"
            )
        return _dense_attention(q, k, v, mask, causal=causal)[0]
    return flash_attention_core(q, k, v, causal=causal)[0]

"""Flash attention, forward and backward — the port of ``ops/flash_attention.py``.

On CUDA tensors :func:`flash_attention_core` launches hand-written kernels:
``csrc/flash_attention_fwd.cu`` for the forward (the counterpart of the
Pallas ``_kernel`` launched by ``_flash_fwd_pallas``) and, when a gradient
is taken, ``csrc/flash_attention_bwd.cu`` for the backward (the dQ pass and
the dK/dV pass, counterparts of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
launched by ``_flash_bwd_pallas``).  Causal or not, f32, head dim 64, any
sequence length.  On CPU tensors the same code runs the kernels' plain
versions: :func:`_dense_attention` (the reference's ``_dense_attention``
extended to return the log-sum-exp in nats) and :func:`_dense_attention_bwd`
(the backward recomputed from the saved lse, with the kernels' arithmetic).
There is no fallback between the two and no switch: the tensor's device
decides, and a CUDA tensor the kernels cannot take raises.

The glue is :class:`_FlashAttention`, a ``torch.autograd.Function`` (the
reference's ``custom_vjp`` in ``_make_core``): forward runs K1 and saves
``(q, k, v, o, lse)``; backward computes delta = rowsum(dO * O) in PyTorch,
outside the kernels, as the reference does in XLA, then runs the dQ pass
and the dK/dV pass.  Gradients come back as contiguous [B, S, H, D]
tensors; autograd concatenates them into the qkv projection's gradient.

The TPU wrapper's dense fallback for small auto-selected blocks is not
carried over: it worked around the TPU grid, and the CUDA kernels mask
their own ragged last tile, so every sequence length runs the kernels.  The
key-padding mask is supported by the plain version only; on the card it
raises until BERT, its consumer, is ported.

``launches``, ``launches_dq`` and ``launches_dkv`` count kernel launches
(never plain-version calls), so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

NEG_BIG = -1e30  # finite mask fill; -inf poisons the online-softmax max
HEAD_DIM = 64  # the kernels' head dim

#: forward (K1) kernel launches since the counter was last reset
launches = 0
#: backward dQ-pass (K2) kernel launches
launches_dq = 0
#: backward dK/dV-pass (K3) kernel launches
launches_dkv = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry point -> (library, argtypes); every one returns a cudaError_t
_SIGNATURES = {
    "flash_attention_fwd_f32": (
        "flash_attention_fwd",
        [_P] * 3 + [_LL] * 9 + [_P] * 2 + [_I] * 4 + [ctypes.c_float, _P]),
    "flash_attention_bwd_dq_f32": (
        "flash_attention_bwd", [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P]),
    "flash_attention_bwd_dkv_f32": (
        "flash_attention_bwd", [_P] * 9 + [_I] * 4 + [ctypes.c_float, _P]),
}
_fns = {}


def _kernel_fn(name: str):
    """The ctypes entry point ``name``, its library built at first use."""
    fn = _fns.get(name)
    if fn is None:
        lib, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


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


def _dense_attention_bwd(q, k, v, do, lse, delta, *, causal: bool):
    """Plain backward with K2/K3's exact semantics, [B, S, H, D] in and
    out: P is recomputed from the saved ``lse`` ([B, H, S], nats), masked
    entries are exactly 0, dS = P * (dO V^T - delta) * scale with ``delta``
    = rowsum(dO * O) [B, H, S]; returns ``(dq, dk, dv)``."""
    s, d = q.shape[1], q.shape[3]
    scale = 1.0 / d ** 0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.exp(scores - lse[..., None])
    if causal:
        tril = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        p = torch.where(tril, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v).float()
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype), k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype), q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype), do)
    return dq, dk, dv


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


def _check_inputs(**named) -> None:
    """Shape, type, layout and device checks shared by the three kernels."""
    q = named["q"]
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(
            f"flash_attention: the CUDA kernel takes head dim {HEAD_DIM}, "
            f"got {d}"
        )
    for name, t in named.items():
        _check_operand(name, t, (b, s, h, d))
        if t.device != q.device:
            raise ValueError("flash_attention: operands on different devices")


def _launch(q, k, v, *, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run K1 on [B, S, H, 64] f32 views (strided in place)."""
    global launches
    _check_inputs(q=q, k=k, v=v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = _kernel_fn("flash_attention_fwd_f32")
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


def _bwd_launch(name, q, k, v, do, lse, delta, outs, *, causal: bool):
    """Check the backward's operands and launch entry point ``name``
    writing ``outs``."""
    _check_inputs(q=q, k=k, v=v, do=do)
    b, s, h, d = q.shape
    for label, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) or (
            not t.is_contiguous() or t.device != q.device
        ):
            raise ValueError(
                f"flash_attention: {label} must be contiguous f32 [{b}, {h}, "
                f"{s}] on {q.device}"
            )
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, do) for i in range(3))
    )
    with torch.cuda.device(q.device):
        code = _kernel_fn(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ctypes.addressof(strides),
            *(t.data_ptr() for t in outs), b, h, s, int(causal),
            1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, name)


def _launch_bwd_dq(q, k, v, do, lse, delta, *, causal: bool) -> torch.Tensor:
    """K2, the dQ pass, on [B, S, H, 64] f32 views; ``lse`` and ``delta``
    contiguous [B, H, S] f32.  Returns dQ [B, S, H, 64] contiguous."""
    global launches_dq
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch("flash_attention_bwd_dq_f32", q, k, v, do, lse, delta, (dq,),
                causal=causal)
    launches_dq += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """K3, the dK/dV pass, same operands; returns ``(dK, dV)``."""
    global launches_dkv
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _bwd_launch("flash_attention_bwd_dkv_f32", q, k, v, do, lse, delta,
                (dk, dv), causal=causal)
    launches_dkv += 1
    return dk, dv


def _launch_bwd(q, k, v, do, lse, delta, *, causal: bool):
    """K2 then K3: ``(dq, dk, dv)``."""
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    return (dq, *_launch_bwd_dkv(q, k, v, do, lse, delta, causal=causal))


def _forward(q, k, v, *, causal: bool):
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return _dense_attention(q, k, v, None, causal=causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2/K3 backward (plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _forward(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # e.g. the stride-0 gradient of a plain sum
        # delta = rowsum(dO * O), [B, H, S], outside the kernels (the
        # reference computes it in XLA); one O(S*D) elementwise reduce
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = _launch_bwd(q, k, v, do, lse, delta, causal=ctx.causal)
        else:
            dq, dk, dv = _dense_attention_bwd(q, k, v, do, lse, delta,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_core(q, k, v, *, causal: bool = False):
    """``(o [B, S, H, D], lse [B, H, S] nats)`` for [B, S, H, D] inputs —
    the CUDA kernels on CUDA tensors, their plain versions on CPU ones.
    Differentiable in q, k and v (lse carries no gradient)."""
    return _FlashAttention.apply(q, k, v, causal)


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
    version only for now (differentiated by autograd).  ``causal=True``
    applies the autoregressive triangle inside the kernels, skipping the
    tiles above the diagonal in the forward and in both backward passes."""
    if mask is not None:
        if q.device.type == "cuda":
            raise NotImplementedError(
                "flash_attention: the key-padding mask is not in the CUDA "
                "kernel yet (its consumer, BERT, is port slice 6)"
            )
        return _dense_attention(q, k, v, mask, causal=causal)[0]
    return flash_attention_core(q, k, v, causal=causal)[0]

"""Flash attention, forward and backward — the port of ``ops/flash_attention.py``.

On CUDA tensors :func:`flash_attention_core` launches hand-written kernels:
``csrc/flash_attention_fwd.cu`` for the forward (the counterpart of the
Pallas ``_kernel`` launched by ``_flash_fwd_pallas``) and, when a gradient
is taken, ``csrc/flash_attention_bwd.cu`` for the backward (the dQ pass and
the dK/dV pass, counterparts of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
launched by ``_flash_bwd_pallas``).  Causal or not, head dim 16, 32 or 64
(:data:`HEAD_DIMS`: the reference's serve, trainer and benchmark
geometries), any sequence length, in either of the two dtypes the Pallas
kernels run:
float32 (SIMT kernels, full f32 arithmetic) or bfloat16 (tensor-core
kernels, bf16 operands with f32 accumulation).  The dtype picks the entry
point; all operands share it.  On CPU tensors the same code runs the
kernels' plain versions: :func:`_dense_attention` (the reference's
``_dense_attention`` extended to return the log-sum-exp in nats) and
:func:`_dense_attention_bwd` (the backward recomputed from the saved lse).
Both round where the Pallas kernels round, so a bf16 plain version differs
from the kernels only in the order of its sums.  There is no fallback
between kernel and plain version and no switch: the tensor's device
decides, and a CUDA tensor the kernels cannot take raises.

The glue is :class:`_FlashAttention`, a ``torch.autograd.Function`` (the
reference's ``custom_vjp`` in ``_make_core``): forward runs K1 and saves
``(q, k, v, o, lse)``; backward computes delta = rowsum(dO * O) in f32 in
PyTorch, outside the kernels, as the reference does in XLA, then runs the
dQ pass and the dK/dV pass.  O and the gradients come back in the input
dtype (the reference's ``out_dtype=x.dtype``), as contiguous [B, S, H, D]
tensors; autograd concatenates the gradients into the qkv projection's.

The TPU wrapper's dense fallback for small auto-selected blocks is not
carried over: it worked around the TPU grid, and the CUDA kernels mask
their own ragged last tile, so every sequence length runs the kernels.  The
key-padding mask is supported by the plain version only; on the card it
raises until BERT, its consumer, is ported.

``launches``, ``launches_dq`` and ``launches_dkv`` count f32 kernel
launches, ``launches_bf16``, ``launches_dq_bf16`` and ``launches_dkv_bf16``
bf16 ones (never plain-version calls), so a run can show which kernels it
went through.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

NEG_BIG = -1e30  # finite mask fill; -inf poisons the online-softmax max
#: head dims the kernels are built for (bf16 mma.sync takes a head dim
#: that is a multiple of its 16-deep k-step)
HEAD_DIMS = (16, 32, 64)

#: f32 forward (K1) kernel launches since the counter was last reset
launches = 0
#: f32 backward dQ-pass (K2) kernel launches
launches_dq = 0
#: f32 backward dK/dV-pass (K3) kernel launches
launches_dkv = 0
#: bf16 forward (K1) kernel launches
launches_bf16 = 0
#: bf16 dQ-pass (K2) kernel launches
launches_dq_bf16 = 0
#: bf16 dK/dV-pass (K3) kernel launches
launches_dkv_bf16 = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 3 + [_LL] * 9 + [_P] * 2 + [_I] * 5 + [ctypes.c_float, _P]
_DQ_ARGS = [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P]
_DKV_ARGS = [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]
# (pass, dtype) -> (entry point, library, argtypes, launch counter); every
# entry point returns a cudaError_t
_ENTRY = {
    ("fwd", torch.float32): ("flash_attention_fwd_f32", "flash_attention_fwd",
                             _FWD_ARGS, "launches"),
    ("fwd", torch.bfloat16): ("flash_attention_fwd_bf16", "flash_attention_fwd",
                              _FWD_ARGS, "launches_bf16"),
    ("dq", torch.float32): ("flash_attention_bwd_dq_f32", "flash_attention_bwd",
                            _DQ_ARGS, "launches_dq"),
    ("dq", torch.bfloat16): ("flash_attention_bwd_dq_bf16", "flash_attention_bwd",
                             _DQ_ARGS, "launches_dq_bf16"),
    ("dkv", torch.float32): ("flash_attention_bwd_dkv_f32", "flash_attention_bwd",
                             _DKV_ARGS, "launches_dkv"),
    ("dkv", torch.bfloat16): ("flash_attention_bwd_dkv_bf16",
                              "flash_attention_bwd", _DKV_ARGS,
                              "launches_dkv_bf16"),
}
_fns = {}


def _kernel_fn(kind: str, dtype: torch.dtype):
    """``(entry point name, ctypes function)`` of pass ``kind`` for
    ``dtype``, its library built at first use."""
    name, lib, argtypes, _ = _ENTRY[(kind, dtype)]
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return name, fn


def _count(kind: str, dtype: torch.dtype) -> None:
    """One more launch of pass ``kind`` in ``dtype``."""
    counter = _ENTRY[(kind, dtype)][3]
    globals()[counter] += 1


def _dense_attention(q, k, v, mask, *, causal: bool):
    """Plain attention with the kernel's semantics, [B, S, H, D] in; returns
    ``(o [B, S, H, D] in the input dtype, lse [B, H, S] f32 in nats)``.

    Key-padding ``mask`` (bool, broadcastable to [B, 1, 1, S]) and the
    causal triangle are filled with -1e30.  It rounds where the Pallas
    kernel rounds: S = Q K^T from the operands upcast to f32 (the kernel's
    f32-accumulated product, exact for bf16 operands up to the order of
    its sums); P = exp(S - max) in f32, rounded to ``v.dtype`` only as the
    operand of P V; the row sums l of the f32 P, clamped at 1e-30;
    O = (P V) / l rounded to the input dtype once.  For f32 operands every
    rounding step is the identity."""
    b, s, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    if mask is not None:
        key_mask = torch.broadcast_to(mask, (b, 1, 1, s))
        scores = torch.where(key_mask, scores, NEG_BIG)
    if causal:
        tril = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(tril, scores, NEG_BIG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E741
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _dense_attention_bwd(q, k, v, do, lse, delta, *, causal: bool):
    """Plain backward with K2/K3's semantics, [B, S, H, D] in and out (the
    input dtype): P is recomputed in f32 from f32 S = Q K^T and the saved
    ``lse`` ([B, H, S], nats), masked entries exactly 0; dP = dO V^T in
    f32; dS = P * (dP - delta) * scale with ``delta`` = rowsum(dO * O)
    [B, H, S] f32.  As in the Pallas kernels, dS is rounded to the operand
    dtype before dS K and dS^T Q, P before P^T dO, and dQ, dK, dV once at
    the end; returns ``(dq, dk, dv)``."""
    s, d = q.shape[1], q.shape[3]
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(scores - lse[..., None])
    if causal:
        tril = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        p = torch.where(tril, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_operand(name: str, t: torch.Tensor, shape, dtype) -> None:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"flash_attention: {name} is {t.dtype}; the CUDA kernels take "
            "float32 or bfloat16"
        )
    if t.dtype != dtype:
        raise TypeError(
            f"flash_attention: {name} is {t.dtype} but q is {dtype}; all "
            "operands must share one dtype"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} shape {tuple(t.shape)} != {shape}")
    # 16-byte rows: float4 loads (f32) and cp.async / ldmatrix (bf16)
    if t.stride(3) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous head dim and "
            f"strides that are multiples of 16 bytes (got {t.stride()} "
            f"elements of {t.element_size()} bytes)"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def _check_inputs(**named) -> None:
    """Shape, type, layout and device checks shared by the kernels."""
    q = named["q"]
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: the CUDA kernels take head dims {HEAD_DIMS}, "
            f"got {d}"
        )
    for name, t in named.items():
        _check_operand(name, t, (b, s, h, d), q.dtype)
        if t.device != q.device:
            raise ValueError("flash_attention: operands on different devices")


def _launch(q, k, v, *, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run K1 (f32 or bf16, q's dtype) on [B, S, H, D] views (strided in
    place): ``(o [B, S, H, D] in q's dtype, lse [B, H, S] f32)``."""
    _check_inputs(q=q, k=k, v=v)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    name, fn = _kernel_fn("fwd", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.data_ptr(), lse.data_ptr(), b, h, s, d, int(causal),
            1.0 / d ** 0.5, stream,
        )
    _build.check(code, name)
    _count("fwd", q.dtype)
    return o, lse


def _bwd_launch(kind, q, k, v, do, lse, delta, outs, *, causal: bool):
    """Check the backward's operands and launch pass ``kind`` ("dq" or
    "dkv") in q's dtype, writing ``outs``."""
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
    name, fn = _kernel_fn(kind, q.dtype)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ctypes.addressof(strides),
            *(t.data_ptr() for t in outs), b, h, s, d, int(causal),
            1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, name)
    _count(kind, q.dtype)


def _launch_bwd_dq(q, k, v, do, lse, delta, *, causal: bool) -> torch.Tensor:
    """K2, the dQ pass, on [B, S, H, D] views in one dtype (f32 or bf16);
    ``lse`` and ``delta`` contiguous [B, H, S] f32.  Returns dQ [B, S, H,
    D] contiguous in q's dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("dq", q, k, v, do, lse, delta, (dq,), causal=causal)
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """K3, the dK/dV pass, same operands; returns ``(dK, dV)``."""
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _bwd_launch("dkv", q, k, v, do, lse, delta, (dk, dv), causal=causal)
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
        # dO in the operands' dtype, as the reference's bwd casts it;
        # contiguous for e.g. the stride-0 gradient of a plain sum
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * O) in f32, [B, H, S], outside the kernels (the
        # reference computes it in XLA); one O(S*D) elementwise reduce
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = _launch_bwd(q, k, v, do, lse, delta, causal=ctx.causal)
        else:
            dq, dk, dv = _dense_attention_bwd(q, k, v, do, lse, delta,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_core(q, k, v, *, causal: bool = False):
    """``(o [B, S, H, D] in the input dtype, lse [B, H, S] f32 nats)`` for
    [B, S, H, D] f32 or bf16 inputs — the CUDA kernels on CUDA tensors,
    their plain versions on CPU ones.  Differentiable in q, k and v (lse
    carries no gradient; the gradients come back in the input dtype)."""
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

"""Flash attention, forward and backward — the port of ``ops/flash_attention.py``.

On CUDA tensors :func:`flash_attention_core` launches hand-written kernels:
``csrc/flash_attention_fwd.cu`` for the forward (the counterpart of the
Pallas ``_kernel`` launched by ``_flash_fwd_pallas``) and, when a gradient
is taken, ``csrc/flash_attention_bwd.cu`` for the backward (the dQ pass and
the dK/dV pass, counterparts of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
launched by ``_flash_bwd_pallas``).  Causal or not, head dim 8, 16, 32 or
64 (:data:`HEAD_DIMS`: the reference's serve, trainer and benchmark
geometries), any sequence length, in either of the two dtypes the Pallas
kernels run: float32 (tensor-core kernels on ``mma.sync`` in split TF32,
three TF32 products a product, which keeps f32 accuracy) or bfloat16
(tensor-core kernels on ``wgmma`` with TMA-fed tiles, bf16 operands with
f32 accumulation).  The dtype picks the entry point; all operands share
it.  The f32 forward is built for head dims 8, 16, 32 and 64; the f32
backward and every bf16 kernel for 16, 32 and 64
(:data:`KERNEL_HEAD_DIMS`: bf16 ``wgmma`` steps k by 16), and a head dim
of 8 runs them at 16 on zero-padded copies (:func:`pad_head_dim`,
:func:`strip_head_dim`), which is exact -- zero columns add nothing to
Q K^T and give zero output columns -- with the scale 1/sqrt(8) of the
caller's head dim.  On CPU
tensors the same code runs the kernels' plain versions:
:func:`_dense_attention` (the reference's ``_dense_attention`` extended to
return the log-sum-exp in nats) and
:func:`_dense_attention_bwd` (the backward recomputed from the saved lse).
Both round where the Pallas kernels round, so a bf16 plain version differs
from the kernels only in the order of its sums.  ``meta`` tensors (shapes
only: ``utils.hardware.step_flops`` counts a model's FLOPs on them) take
the plain forward too.  There is no fallback
between kernel and plain version and no switch: the tensor's device
decides, and a CUDA tensor the kernels cannot take raises.

Key padding.  :func:`flash_attention` turns a boolean ``mask`` into the
reference's additive bias, ``bias2 = where(mask, 0, -1e30)`` as a
contiguous [B, S] f32 shared by each batch row's heads, and every pass adds
it to its scores (the Pallas kernels' ``has_bias``).  It is a term of the
softmax, not a skip, so a row whose keys are all masked attends uniformly
to the keys it can see by position, as in the reference; the bias gets no
gradient.  The kernels take it in a variant built with ``HAS_BIAS`` and
launch the unbiased variant when there is no mask (the LM and serving
paths).  The Pallas kernels add it to base-2 scores; the f32 kernels and
the plain versions work in nats and add ``bias * ln 2``, which gives the
reference's lse bit for bit on a fully masked row too.

The glue is :class:`_FlashAttention`, a ``torch.autograd.Function`` (the
reference's ``custom_vjp`` in ``_make_core``): forward runs K1 and saves
``(q, k, v, bias, o, lse)``; backward computes delta = rowsum(dO * O) in
f32 in PyTorch, outside the kernels, as the reference does in XLA, then
runs the dQ pass and the dK/dV pass.  O and the gradients come back in the
input dtype (the reference's ``out_dtype=x.dtype``), as contiguous
[B, S, H, D] tensors; autograd concatenates the gradients into the qkv
projection's.

The TPU wrapper's dense fallback for small auto-selected blocks is not
carried over: it worked around the TPU grid, and the CUDA kernels mask
their own ragged last tile, so every sequence length runs the kernels.

``launches``, ``launches_dq`` and ``launches_dkv`` count f32 kernel
launches, ``launches_bf16``, ``launches_dq_bf16`` and ``launches_dkv_bf16``
bf16 ones, and the same names with ``_bias`` before the dtype
(``launches_bias``, ``launches_dq_bias_bf16``, ...) the launches of the
bias variants; never plain-version calls.  A run can so show which kernels
it went through.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

NEG_BIG = -1e30  # finite mask fill; -inf poisons the online-softmax max
LN2 = 0.6931471805599453  # the reference's base-2 bias in nats
#: head dims every kernel is built for (the bf16 wgmma products take a head
#: dim that is a multiple of their 16-deep k-step)
KERNEL_HEAD_DIMS = (16, 32, 64)
#: head dims the wrappers take: the kernels' own, and 8 (natively in the
#: f32 forward, through padding in the other kernels)
HEAD_DIMS = (8,) + KERNEL_HEAD_DIMS
#: the kernel head dim a padded head dim runs at (all but the f32 forward)
PADDED_HEAD_DIM = {8: 16}

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
#: launches of the key-padding-bias variants, pass and dtype as above
launches_bias = 0
launches_dq_bias = 0
launches_dkv_bias = 0
launches_bias_bf16 = 0
launches_dq_bias_bf16 = 0
launches_dkv_bias_bf16 = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 4 + [_LL] * 9 + [_P] * 2 + [_I] * 5 + [ctypes.c_float, _P]
_DQ_ARGS = [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]
_DKV_ARGS = [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P]
# pass -> (library, entry point prefix, argtypes, counter prefix); the
# entry points are <prefix>_f32 and <prefix>_bf16 and return a cudaError_t
_PASSES = {
    "fwd": ("flash_attention_fwd", "flash_attention_fwd", _FWD_ARGS, "launches"),
    "dq": ("flash_attention_bwd", "flash_attention_bwd_dq", _DQ_ARGS,
           "launches_dq"),
    "dkv": ("flash_attention_bwd", "flash_attention_bwd_dkv", _DKV_ARGS,
            "launches_dkv"),
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns = {}


def _kernel_fn(kind: str, dtype: torch.dtype):
    """``(entry point name, ctypes function)`` of pass ``kind`` for
    ``dtype``, its library built at first use."""
    lib, prefix, argtypes, _ = _PASSES[kind]
    name = f"{prefix}_{_SUFFIX[dtype]}"
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return name, fn


def bf16_block_rows(b: int, h: int, s: int) -> int:
    """The query rows a block of the bf16 forward takes at (B, H, S) on
    the current CUDA device: 192, 128 or 64, by the launcher's rule in
    ``csrc/flash_attention_fwd.cu`` (``fwd_bf16_block_rows``)."""
    fn = _build.load("flash_attention_fwd").flash_attention_fwd_bf16_block_rows
    return int(fn(b, h, s))


def f32_block_rows(b: int, h: int, s: int) -> int:
    """The query rows a block of the f32 forward takes at (B, H, S) on the
    current CUDA device: 128 or 64, by the launcher's rule in
    ``csrc/flash_attention_fwd.cu`` (``fwd_f32_block_rows``)."""
    fn = _build.load("flash_attention_fwd").flash_attention_fwd_f32_block_rows
    return int(fn(b, h, s))


def f32_bwd_block_rows(kind: str, b: int, h: int, s: int) -> int:
    """The rows a block of the f32 backward's pass ``kind`` ("dq": query
    rows, "dkv": key rows; 128 or 64) owns at (B, H, S) on the current
    CUDA device, by the launcher's rule in ``csrc/flash_attention_bwd.cu``
    (``bwd_f32_block_rows``)."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_f32_block_rows
    return int(fn(("dq", "dkv").index(kind), b, h, s))


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """A [..., D] tensor the kernels can take: a contiguous copy zero-padded
    to :data:`PADDED_HEAD_DIM` at a padded head dim, else ``t`` itself."""
    d = t.shape[-1]
    if d not in PADDED_HEAD_DIM:
        return t
    return torch.nn.functional.pad(t, (0, PADDED_HEAD_DIM[d] - d))


def strip_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """The first ``d`` columns of a [..., D] kernel output, contiguous (the
    inverse of :func:`pad_head_dim` on its outputs)."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def bf16_bwd_block_rows(kind: str, b: int, h: int, s: int) -> int:
    """The rows a block of the bf16 backward's pass ``kind`` ("dq": query
    rows, 192, 128 or 64; "dkv": key rows, 128 or 64) owns at (B, H, S) on
    the current CUDA device, by the launcher's rule in
    ``csrc/flash_attention_bwd.cu`` (``bwd_bf16_block_rows``)."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_bf16_block_rows
    return int(fn(("dq", "dkv").index(kind), b, h, s))


def _count(kind: str, dtype: torch.dtype, has_bias: bool) -> None:
    """One more launch of pass ``kind`` in ``dtype`` (bias variant or not)."""
    counter = (_PASSES[kind][3] + ("_bias" if has_bias else "")
               + ("_bf16" if dtype == torch.bfloat16 else ""))
    globals()[counter] += 1


def _mask_bias(mask: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """The reference's key-padding bias from a boolean ``mask``
    broadcastable to [B, 1, 1, S]: a contiguous [B, S] f32 tensor of 0
    (attend) or -1e30 (masked), on the mask's device (ref
    ``flash_attention.py:511-515``)."""
    key_mask = torch.broadcast_to(mask.bool(), (b, 1, 1, s))[:, 0, 0, :]
    return torch.where(key_mask, 0.0, NEG_BIG).float().contiguous()


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / d ** 0.5 if scale is None else scale


def _scores(q, k, bias, scale=None):
    """f32 S = Q K^T * scale (default 1/sqrt(D)), [B, H, Sq, Sk], plus the
    key bias in nats."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(
        q.shape[3], scale)
    if bias is not None:
        scores = scores + (bias * LN2)[:, None, None, :]
    return scores


def _dense_attention(q, k, v, bias, *, causal: bool, scale=None):
    """Plain attention with the kernel's semantics, [B, S, H, D] in; returns
    ``(o [B, S, H, D] in the input dtype, lse [B, H, S] f32 in nats)``.

    ``bias`` is the key-padding bias of :func:`_mask_bias` ([B, S] f32 of
    0 / -1e30, or None), added to the scores in nats (x ln 2, the
    reference's base-2 units); the causal triangle is filled with -1e30,
    below every biased score.  It rounds where the Pallas kernel rounds:
    S = Q K^T from the operands upcast to f32 (the kernel's f32-accumulated
    product, exact for bf16 operands up to the order of its sums);
    P = exp(S - max) in f32, rounded to ``v.dtype`` only as the operand of
    P V; the row sums l of the f32 P, clamped at 1e-30; O = (P V) / l
    rounded to the input dtype once.  For f32 operands every rounding step
    is the identity.  ``scale`` replaces 1/sqrt(D) (a padded head dim
    keeps its own)."""
    s = q.shape[1]
    scores = _scores(q, k, bias, scale)
    if causal:
        tril = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(tril, scores, NEG_BIG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E741
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _dense_attention_bwd(q, k, v, do, lse, delta, *, causal: bool, bias=None,
                         scale=None):
    """Plain backward with K2/K3's semantics, [B, S, H, D] in and out (the
    input dtype): P is recomputed in f32 from f32 S = Q K^T (plus ``bias``
    in nats, as in :func:`_dense_attention`) and the saved ``lse`` ([B, H,
    S], nats), causally masked entries exactly 0; dP = dO V^T in f32;
    dS = P * (dP - delta) * scale with ``delta`` = rowsum(dO * O) [B, H, S]
    f32.  As in the Pallas kernels, dS is rounded to the operand dtype
    before dS K and dS^T Q, P before P^T dO, and dQ, dK, dV once at the
    end; returns ``(dq, dk, dv)``.  ``scale`` replaces 1/sqrt(D)."""
    s = q.shape[1]
    scale = _scale(q.shape[3], scale)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = torch.exp(_scores(q, k, bias, scale) - lse[..., None])
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


def _check_operand(name: str, t: torch.Tensor, shape, dtype,
                   layout: bool = True) -> None:
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
    if not layout:
        return
    # 16-byte rows: float4 loads (f32) and the bf16 kernels' TMA tensor
    # maps (16-byte base and strides)
    if t.stride(3) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous head dim and "
            f"strides that are multiples of 16 bytes (got {t.stride()} "
            f"elements of {t.element_size()} bytes)"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def _check_inputs(pad: bool = True, **named):
    """Shape, type, layout and device checks shared by the kernels; returns
    the operands as the kernels take them: zero-padded copies at a padded
    head dim when ``pad`` (every kernel but the f32 forward), else the
    views themselves, checked for layout."""
    q = named["q"]
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: the CUDA kernels take head dims {HEAD_DIMS} "
            f"(8 in the f32 forward, elsewhere on copies zero-padded to 16), "
            f"got {d}"
        )
    out = []
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError("flash_attention: operands on different devices")
        # a padded copy is a fresh contiguous tensor: only views need the
        # layout check
        padded = pad and d in PADDED_HEAD_DIM
        _check_operand(name, t, (b, s, h, d), q.dtype, layout=not padded)
        out.append(pad_head_dim(t) if padded else t)
    return out


def _check_bias(bias, b: int, s: int, device) -> None:
    if bias is not None and (
        bias.dtype != torch.float32 or tuple(bias.shape) != (b, s)
        or not bias.is_contiguous() or bias.device != device
    ):
        raise ValueError(
            f"flash_attention: the key-padding bias must be contiguous f32 "
            f"[{b}, {s}] on {device} (got {bias.dtype} {tuple(bias.shape)} "
            f"on {bias.device})"
        )


def _launch(q, k, v, *, causal: bool, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run K1 (f32 or bf16, q's dtype; the bias variant when ``bias`` is a
    [B, S] f32 key-padding bias) on [B, S, H, D] views (strided in place;
    in bf16, zero-padded copies at head dim 8, which the f32 kernel takes
    as it is): ``(o [B, S, H, D] in q's dtype, lse [B, H, S] f32)``."""
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5  # the caller's head dim, before any padding
    q, k, v = _check_inputs(pad=q.dtype != torch.float32, q=q, k=k, v=v)
    _check_bias(bias, b, s, q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    name, fn = _kernel_fn("fwd", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.data_ptr(), lse.data_ptr(), b, h, s, q.shape[3], int(causal),
            scale, stream,
        )
    _build.check(code, name)
    _count("fwd", q.dtype, bias is not None)
    return strip_head_dim(o, d), lse


def _bwd_launch(kind, q, k, v, do, lse, delta, *, causal: bool, bias):
    """Check the backward's operands and launch pass ``kind`` ("dq" or
    "dkv") in q's dtype; returns its outputs (dQ, or dK and dV) as
    contiguous [B, S, H, D] tensors (at head dim 8 the kernels run on
    zero-padded copies and the padding is stripped)."""
    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5  # the caller's head dim, before any padding
    q, k, v, do = _check_inputs(q=q, k=k, v=v, do=do)
    _check_bias(bias, b, s, q.device)
    # lse and delta: the bf16 dK/dV pass loads them by TMA (16-byte base)
    for label, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) or (
            not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16
        ):
            raise ValueError(
                f"flash_attention: {label} must be contiguous, 16-byte aligned "
                f"f32 [{b}, {h}, {s}] on {q.device}"
            )
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, do) for i in range(3))
    )
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
            for _ in range(1 if kind == "dq" else 2)]
    name, fn = _kernel_fn(kind, q.dtype)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ctypes.addressof(strides),
            *(t.data_ptr() for t in outs), b, h, s, q.shape[3], int(causal),
            scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, name)
    _count(kind, q.dtype, bias is not None)
    return [strip_head_dim(t, d) for t in outs]


def _launch_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, bias=None) -> torch.Tensor:
    """K2, the dQ pass, on [B, S, H, D] views in one dtype (f32 or bf16);
    ``lse`` and ``delta`` contiguous [B, H, S] f32, ``bias`` as in
    :func:`_launch`.  Returns dQ [B, S, H, D] contiguous in q's dtype."""
    return _bwd_launch("dq", q, k, v, do, lse, delta, causal=causal,
                       bias=bias)[0]


def _launch_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, bias=None):
    """K3, the dK/dV pass, same operands; returns ``(dK, dV)``."""
    return tuple(_bwd_launch("dkv", q, k, v, do, lse, delta, causal=causal,
                             bias=bias))


def _launch_bwd(q, k, v, do, lse, delta, *, causal: bool, bias=None):
    """K2 then K3: ``(dq, dk, dv)``."""
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, causal=causal, bias=bias)
    return (dq, *_launch_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                 bias=bias))


def _forward(q, k, v, bias, *, causal: bool):
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, bias=bias)
    if q.device.type in ("cpu", "meta"):  # meta: shapes only (utils.hardware)
        return _dense_attention(q, k, v, bias, causal=causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2/K3 backward (plain versions on CPU tensors); the
    key-padding bias rides along and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool):
        o, lse = _forward(q, k, v, bias, causal=causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        # dO in the operands' dtype, as the reference's bwd casts it;
        # contiguous for e.g. the stride-0 gradient of a plain sum
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * O) in f32, [B, H, S], outside the kernels (the
        # reference computes it in XLA); one O(S*D) elementwise reduce
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        if q.device.type == "cuda":
            dq, dk, dv = _launch_bwd(q, k, v, do, lse, delta,
                                     causal=ctx.causal, bias=bias)
        else:
            dq, dk, dv = _dense_attention_bwd(q, k, v, do, lse, delta,
                                              causal=ctx.causal, bias=bias)
        return dq, dk, dv, None, None


def flash_attention_core(q, k, v, *, causal: bool = False, bias=None):
    """``(o [B, S, H, D] in the input dtype, lse [B, H, S] f32 nats)`` for
    [B, S, H, D] f32 or bf16 inputs — the CUDA kernels on CUDA tensors,
    their plain versions on CPU ones.  ``bias``: the [B, S] f32 key-padding
    bias of :func:`_mask_bias`, or None.  Differentiable in q, k and v (lse
    and the bias carry no gradient; the gradients come back in the input
    dtype)."""
    return _FlashAttention.apply(q, k, v, bias, causal)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    dtype: Optional[torch.dtype] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Drop-in attention, [B, S, H, D] in and out (the reference's
    ``flash_attention`` without its TPU block arguments).

    ``mask``: bool key padding, broadcastable to [B, 1, 1, S] (True =
    attend), added to the scores as the reference's -1e30 bias in every
    pass.  ``dtype``: the output's dtype (the reference's ``out_dtype``);
    None keeps the inputs'.  ``causal=True`` applies the autoregressive
    triangle inside the kernels, skipping the tiles above the diagonal in
    the forward and in both backward passes."""
    bias = None if mask is None else _mask_bias(mask, q.shape[0], q.shape[1])
    o = flash_attention_core(q, k, v, causal=causal, bias=bias)[0]
    return o if dtype is None else o.to(dtype)


def make_flash_attention(block_q: Optional[int] = None,
                         block_k: Optional[int] = None, mesh=None,
                         causal: bool = False):
    """An ``attention_fn(q, k, v, mask, *, dtype)`` for the models (ref
    ``make_flash_attention``).  ``block_q`` and ``block_k`` size the TPU
    grid and are ignored: the CUDA kernels pick their own tiles.

    With a ``mesh`` each rank runs K1 (and K2/K3 in the backward) on what
    it holds: one process per device holds only its shard, so there is
    nothing to shard (the reference ``shard_map``s the kernels, batch over
    the data axes and heads over ``tensor``).  Over ``data * fsdp`` > 1
    that is the rank's own rows; over ``tensor`` > 1 its own heads, ``H =
    heads / tp`` of ``[B, S, H, D]`` q, k and v (the column-parallel qkv
    projection's slice), with the key-padding mask, which has no head dim,
    whole.  Heads are independent, so no collective runs.  ``mask=None``
    stays None, so the kernels run without a bias."""
    del block_q, block_k

    def attention_fn(q, k, v, mask, *, dtype):
        return flash_attention(q, k, v, mask, dtype=dtype, causal=causal)

    return attention_fn

"""int8 tensors for the port: weights (``QTensor``, ``qdot``) and KV pages.

Symmetric int8 throughout: ``x ≈ values * scales`` with ``values`` in
[-127, 127] (-128 stays unused, so ``|dequant| <= amax`` exactly).  The
op order is the reference's — ``amax``, ``max(amax, EPS) / QMAX``,
``round(x / scale)`` (half to even in both frameworks), clip — with a true
division, never a multiply by a reciprocal, so codes and scales match the
JAX functions bitwise on the same inputs.

Weights.  A :class:`QTensor` holds int8 ``values`` and f32 keepdims
``scales``; the quantized (contraction) axis is addressed NEGATIVELY
(``axis=-2`` for a ``[..., K, N]`` weight), so a stacked ``[L, K, N]``
leaf indexed by layer (``qt[i]``) or cut to its first layers
(``qt[:M]``) is still a valid QTensor with the same metadata.
:func:`qdot` is the int8 product: activations quantize per row (absmax
over K), the product runs int8 x int8 with int32 accumulation
(``torch._int_mm``: cuBLASLt on the card), and the accumulator is
rescaled once by ``a_scale ⊗ w_scale``.  Block-quantized, non-2-D or
other-axis weights take the dequantize-then-matmul path, under exactly
the reference's condition; a failed int8 product raises, it never falls
back.

KV pages.  One f32 scale per stored K/V vector (per position and head,
over the head dim).  KV pages are written one token (decode) or one chunk
(prefill) at a time, so the scale granularity is at most one write: a
page-wide scale would have to requantize the page on every append.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

#: Largest int8 code used; -128 stays unused (symmetric grid).
QMAX = 127.0
#: Floor on scales so an all-zero vector divides cleanly to zeros.
EPS = 1e-12
#: ``torch._int_mm`` on CUDA refuses ``M <= 16`` rows (PyTorch 2.11 on the
#: H100: "self.size(0) needs to be greater than 16"); rows of an integer
#: product do not interact, so fewer rows are zero-padded to this many.
INT_MM_MIN_ROWS = 17
#: ... and K and N that are not multiples of this ("size(1) needs to be a
#: multiple of 8") ...
INT_MM_MULTIPLE = 8
#: ... and K below this: probed on the H100 (PyTorch 2.11, CUDA 12.8) at
#: M in {17, 40} and N from 192 to 2304, cuBLASLt returned
#: CUBLAS_STATUS_NOT_SUPPORTED at every K <= 96 and ran K in {128, 264,
#: 768}.  Zero columns of ``a`` against zero rows of ``b`` add exactly 0 to
#: an int32 sum and extra output columns are dropped, so K and N are
#: zero-padded to shapes it takes.
INT_MM_MIN_K = 128


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor: ``dequant = values.float() * scales``.

    ``values``: int8; ``scales``: f32, keepdims (broadcastable against
    ``values``, or against its block split); ``axis``: the NEGATIVE index
    of the reduced (contraction) dim; ``block``: elements per scale block
    along ``axis`` (None = one scale per output channel)."""

    values: torch.Tensor
    scales: torch.Tensor
    axis: int = -2
    block: Optional[int] = None

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading (layer) dims of values and scales together:
        ``qt[i]`` is layer ``i``, ``qt[:M]`` the first ``M`` layers."""
        return QTensor(self.values[idx], self.scales[idx], self.axis, self.block)

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scales.to(device),
                       self.axis, self.block)

    def __repr__(self) -> str:
        return (f"QTensor(int8{list(self.values.shape)}, "
                f"scales{list(self.scales.shape)}, axis={self.axis}, "
                f"block={self.block})")


def _block_split(x: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """``[..., K, ...] -> [..., K // block, block, ...]``: the block dim
    lands at the same negative index ``axis`` pointed at."""
    split = x.dim() + axis
    K = x.shape[axis]
    return x.reshape(*x.shape[:split], K // block, block, *x.shape[split + 1:])


def quantize(x: torch.Tensor, *, axis: int = -2, block: Optional[int] = None,
             observer=None) -> QTensor:
    """Quantize ``x`` to int8 with per-channel (or per-block) f32 scales.

    ``axis`` is the reduced dim, addressed negatively (default -2: the
    contraction dim of a ``[..., K, N]`` weight, so one scale per output
    channel); ``block`` splits that dim into groups with one scale each.
    ``observer(x, axis)`` replaces the absmax reduction
    (:class:`~.calibrate.PercentileObserver` clips the outlier tail)."""
    if axis >= 0:
        axis -= x.dim()
    x = x.to(torch.float32)
    if block is not None:
        K = x.shape[axis]
        if K % block:
            raise ValueError(f"block {block} must divide dim {K} (axis {axis})")
        xb = _block_split(x, axis, block)
        amax = (observer(xb, axis) if observer is not None
                else xb.abs().amax(dim=axis, keepdim=True))
        scales = torch.clamp(amax, min=EPS) / QMAX
        values = torch.clamp(torch.round(xb / scales), -QMAX, QMAX)
        return QTensor(values.reshape(x.shape).to(torch.int8), scales, axis,
                       block)
    amax = (observer(x, axis) if observer is not None
            else x.abs().amax(dim=axis, keepdim=True))
    scales = torch.clamp(amax, min=EPS) / QMAX
    values = torch.clamp(torch.round(x / scales), -QMAX, QMAX).to(torch.int8)
    return QTensor(values, scales, axis, None)


def dequantize(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``values * scales`` back to ``dtype`` (exact for the stored grid)."""
    v = qt.values.to(torch.float32)
    if qt.block is not None:
        vb = _block_split(v, qt.axis, qt.block)
        return (vb * qt.scales).reshape(v.shape).to(dtype)
    return (v * qt.scales).to(dtype)


def _zero_pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` [r, c] in the top-left corner of a zero [rows, cols] tensor
    (``t`` itself when nothing is added)."""
    if tuple(t.shape) == (rows, cols):
        return t
    out = t.new_zeros((rows, cols))
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _padded_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of ``a`` [M, K] and ``b`` [K, N] with M raised to
    :data:`INT_MM_MIN_ROWS`, K to a multiple of :data:`INT_MM_MULTIPLE` of
    at least :data:`INT_MM_MIN_K` and N to a multiple of
    :data:`INT_MM_MULTIPLE` by zero padding, the result cut back to
    [M, N]: the same int32 values, exactly."""
    (M, K), N = a.shape, b.shape[1]
    up = lambda n: -(-n // INT_MM_MULTIPLE) * INT_MM_MULTIPLE  # noqa: E731
    kp = max(up(K), INT_MM_MIN_K)
    a = _zero_pad(a, max(M, INT_MM_MIN_ROWS), kp)
    b = _zero_pad(b, kp, up(N))
    return torch._int_mm(a.contiguous(), b)[:M, :N]


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8 -> [M, N] int32``, exact.

    ``torch._int_mm`` (cuBLASLt on the card), which on CUDA takes neither
    ``M <= 16``, nor K or N that are not multiples of 8, nor a small K:
    there the operands are zero-padded to shapes it takes and the result
    cut back (:func:`_padded_int_mm`), which leaves every int32 sum as it
    was.  There is no dequantized fallback."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands are {a.dtype} and {b.dtype}")
    if a.device.type == "cuda":
        return _padded_int_mm(a, b)
    return torch._int_mm(a.contiguous(), b)


def qdot(x: torch.Tensor, qt: QTensor, *, group=None) -> torch.Tensor:
    """``x [..., K] @ qt [K, N] -> [..., N]`` with int8 compute.

    Per-row activation scales (absmax over K), an int8 x int8 product
    accumulated in int32, then ``(acc * a_scale) * w_scale`` in f32.
    Non-2-D, block-quantized or other-axis weights take the dequantize
    path — the reference's condition, and its only one.

    ``group``: a row-parallel product, whose K is split over the ranks of
    the process group (``x`` and ``qt`` hold this rank's part of K, the
    weight's scales are whole).  A row's absmax is then the max over the
    WHOLE K, so the local one is all-reduced with MAX before quantizing
    (a rank's own absmax would put its codes on another grid), and the
    int32 partial accumulators are summed exactly over the group before
    the rescale — what GSPMD computes for the reference's sharded
    contraction, and bit for bit the unsplit product's result."""
    from distributeddeeplearning_tpu_torch.parallel import collectives

    if qt.values.dim() != 2 or qt.axis != -2 or qt.block is not None:
        out = x @ dequantize(qt, x.dtype)
        return out if group is None else collectives.all_reduce(out.contiguous(), group)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        collectives.all_reduce_max(amax, group)
    a_scale = torch.clamp(amax, min=EPS) / QMAX  # [..., 1]
    xq = torch.clamp(torch.round(xf / a_scale), -QMAX, QMAX).to(torch.int8)
    K, N = qt.values.shape
    acc = int8_matmul(xq.reshape(-1, K), qt.values)
    if group is not None:
        acc = collectives.all_reduce(acc.contiguous(), group)
    acc = acc.reshape(*x.shape[:-1], N)
    w_scale = qt.scales.reshape(-1)  # [N] (keepdims [1, N] flattened)
    return (acc.to(torch.float32) * a_scale * w_scale).to(x.dtype)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """The model's one matmul dispatch: :func:`qdot` for a QTensor weight,
    plain ``@`` otherwise — so f32 and int8 parameter trees run the same
    code."""
    if isinstance(w, QTensor):
        return qdot(x, w)
    return x @ w


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

"""Decode attention over the KV cache — the port of ``ops/flash_decode.py``.

:func:`paged_attention` is the wrapper of the hand-written kernel
``csrc/flash_decode.cu`` (the counterpart of the Pallas ``_kernel``
launched by ``_pallas_attention``).  It keeps the TPU kernel's contract —
queries ``[b, nq, h, hd]``, a page pool addressed through block tables,
per-query visibility ``posmat [b, nq]`` — so the paged cache, chunked
prefill and speculative verify extend the same kernel later.  This slice
launches it with ``nq = 1`` over the dense cache (variant (a): f32, no
int8, no own-token overlay).

The dense layout reaches the kernel the way ``_dense_as_pages`` did on the
TPU, with zero data movement: the per-layer cache view ``[slots, S, h,
hd]`` is not contiguous (its slot stride is ``L*S*h*hd``), so instead of a
reshape each slot's row is ONE page of ``S`` positions, read in place
through its strides with identity block tables.  A ``.contiguous()`` here
would copy the whole cache once per generated token.

On a CPU tensor the wrapper runs the kernel's plain version (for the dense
path that is :func:`_gather_decode_dense`, the reference's legacy read);
on a CUDA tensor it launches the kernel or raises.  ``launches`` counts
kernel launches only.

Positions past a slot's ``pos`` are masked in both versions, never judged
by content: the dense engine leaves a previous occupant's stale K/V (and a
quarantined slot's NaN) behind that mask.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

NEG_BIG = -1e30  # finite mask fill, matching the gather reference
HEAD_DIM = 64  # the kernel's head dim

#: ``--decode-kernel`` choices: "auto" resolves to "flash" (the CUDA
#: kernel; its plain version on the CPU), "gather" forces the legacy read.
#: The reference's "pallas"/"xla" pins name TPU implementations the port
#: does not have.
KERNELS = ("auto", "flash", "gather")

#: kernel launches since the counter was last reset
launches = 0

_fn = None
_identity_tables: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def resolve_kernel(kernel: str) -> str:
    """Normalize a ``--decode-kernel`` choice to ``"flash"``/``"gather"``."""
    if kernel not in KERNELS:
        raise ValueError(
            f"unknown decode kernel {kernel!r} (choices: {KERNELS})"
        )
    return "flash" if kernel == "auto" else kernel


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("flash_decode").flash_decode_f32
        fn.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 3
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _sqrt_dim(hd: int, device) -> torch.Tensor:
    # the score DIVISOR, as the gather reference computes it
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=device))


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"paged_attention: {name} is {t.dtype}; f32 only")
    if t.stride(-1) != 1 or any(st % 2 for st in t.stride()[:-1]):
        raise ValueError(
            f"paged_attention: {name} needs a contiguous head dim and even "
            f"strides (got {t.stride()})"
        )
    if t.data_ptr() % 8:
        raise ValueError(f"paged_attention: {name} is not 8-byte aligned")


def _check_index(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"paged_attention: {name} must be contiguous int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"paged_attention: {name} shape {tuple(t.shape)} != {shape}"
        )


def _launch(q4, k_pages, v_pages, tables, posmat) -> torch.Tensor:
    global launches
    b, nq, h, hd = q4.shape
    if hd != HEAD_DIM:
        raise ValueError(
            f"paged_attention: the CUDA kernel takes head dim {HEAD_DIM}, "
            f"got {hd}"
        )
    if k_pages.shape != v_pages.shape or k_pages.stride() != v_pages.stride():
        raise ValueError("paged_attention: K and V pools differ in layout")
    if k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (h, hd):
        raise ValueError(
            f"paged_attention: pool shape {tuple(k_pages.shape)} is not "
            f"[P, page_size, {h}, {hd}]"
        )
    for name, t in (("q", q4), ("k_pages", k_pages), ("v_pages", v_pages)):
        _check_f32(name, t)
    nb = tables.shape[1] if tables.dim() == 2 else -1
    _check_index("tables", tables, (b, nb))
    _check_index("posmat", posmat, (b, nq))
    for t in (k_pages, v_pages, tables, posmat):
        if t.device != q4.device:
            raise ValueError("paged_attention: operands on different devices")
    out = torch.empty((b, nq, h, hd), dtype=torch.float32, device=q4.device)
    fn = _kernel_fn()
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        code = fn(
            q4.data_ptr(), q4.stride(0), q4.stride(1), q4.stride(2),
            k_pages.data_ptr(), v_pages.data_ptr(),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            tables.data_ptr(), nb, k_pages.shape[1],
            posmat.data_ptr(), out.data_ptr(), b, nq, h, stream,
        )
    _build.check(code, "flash_decode_f32")
    launches += 1
    return out


def _paged_attention_plain(q4, k_pages, v_pages, tables, posmat):
    """The kernel's plain version: gather the pages into the dense
    [b, nb*page_size, h, hd] history, then masked softmax attention."""
    b, nq, h, hd = q4.shape
    s = tables.shape[1] * k_pages.shape[1]
    k_seq = k_pages[tables.long()].reshape(b, s, h, hd)
    v_seq = v_pages[tables.long()].reshape(b, s, h, hd)
    scores = torch.einsum("bqhd,bshd->bqhs", q4, k_seq) / _sqrt_dim(hd, q4.device)
    cols = torch.arange(s, device=q4.device)
    visible = cols[None, None, :] <= posmat[:, :, None]
    scores = torch.where(visible[:, :, None, :], scores, NEG_BIG)
    attn = torch.softmax(scores, dim=-1).to(v_seq.dtype)
    return torch.einsum("bqhs,bshd->bqhd", attn, v_seq)


def paged_attention(q4, k_pages, v_pages, tables, posmat) -> torch.Tensor:
    """Attention of ``q4`` [b, nq, h, hd] over pool pages ``k_pages``/
    ``v_pages`` [P, page_size, h, hd] (strided views allowed) addressed
    through ``tables`` [b, nb] int32; query ``(b, i)`` sees positions
    ``<= posmat[b, i]`` (int32, >= 0).  Returns [b, nq, h, hd] f32 — the
    CUDA kernel on a CUDA tensor, its plain version on a CPU one."""
    if q4.device.type == "cuda":
        return _launch(q4, k_pages, v_pages, tables, posmat)
    if q4.device.type == "cpu":
        return _paged_attention_plain(q4, k_pages, v_pages, tables, posmat)
    raise ValueError(f"paged_attention: unsupported device {q4.device}")


def _dense_as_pages(k_l: torch.Tensor) -> torch.Tensor:
    """Identity block tables [b, 1] that make each slot row of a dense
    [b, S, h, hd] cache layer one page of S positions — the pool IS the
    layer view, so nothing moves.  Cached per (b, device)."""
    key = (k_l.shape[0], k_l.device)
    tables = _identity_tables.get(key)
    if tables is None:
        tables = torch.arange(
            k_l.shape[0], dtype=torch.int32, device=k_l.device
        )[:, None]
        _identity_tables[key] = tables
    return tables


def decode_attention_dense(
    q3, k_l, v_l, k_s, v_s, k_t, v_t, pos, *, kernel: str = "auto",
):
    """Single-token decode attention over the dense [b, S, h, hd] cache
    layer (the reference's contract: ``q3``/``k_t``/``v_t`` [b, h, hd],
    ``pos`` [b] int32; ``k_l``/``v_l`` already hold the current token at
    ``pos``).  Returns ctx [b, h, hd].

    ``kernel``: ``"auto"``/``"flash"`` run :func:`paged_attention` over the
    zero-copy page view; ``"gather"`` the legacy read."""
    if k_s is not None or v_s is not None:
        raise NotImplementedError(
            "int8 KV cache is port slice 3; this slice serves f32 caches"
        )
    if resolve_kernel(kernel) == "gather" or q3.device.type == "cpu":
        return _gather_decode_dense(q3, k_l, v_l, None, None, k_t, v_t, pos)
    posmat = pos.to(torch.int32).reshape(-1, 1)
    out = paged_attention(q3[:, None], k_l, v_l, _dense_as_pages(k_l), posmat)
    return out[:, 0]


def _gather_decode_dense(q3, k_l, v_l, k_s, v_s, k_t, v_t, pos):
    """Legacy dense decode attention (the reference's f32 branch): the
    kernel's plain version on the dense layout."""
    if k_s is not None:
        raise NotImplementedError("int8 KV cache is port slice 3")
    b, num_heads, hd = q3.shape
    s = k_l.shape[1]
    scores = torch.einsum("bhd,bshd->bhs", q3, k_l) / _sqrt_dim(hd, q3.device)
    visible = torch.arange(s, device=q3.device)[None, :] <= pos[:, None]
    scores = torch.where(visible[:, None, :], scores, NEG_BIG)
    attn = torch.softmax(scores, dim=-1).to(v_l.dtype)
    return torch.einsum("bhs,bshd->bhd", attn, v_l)

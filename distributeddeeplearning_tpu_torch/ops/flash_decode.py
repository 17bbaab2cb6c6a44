"""Attention over the KV cache — the port of ``ops/flash_decode.py``.

:func:`paged_attention` is the wrapper of the hand-written kernel
``csrc/flash_decode.cu`` (the counterpart of the Pallas ``_kernel``
launched by ``_pallas_attention``).  It keeps the TPU kernel's contract —
queries ``[b, nq, h, hd]``, a page pool addressed through block tables,
per-query visibility ``posmat [b, nq]`` — in these variants:

- (a) ``nq = 1``: decode (:func:`decode_attention_dense`,
  :func:`decode_attention_paged`);
- (b) ``nq > 1``: the chunked-prefill history (:func:`chunk_attention`,
  ``b = 1``, ``nq = C``) and speculative verify
  (:func:`verify_attention_paged`, :func:`verify_attention_dense`,
  ``b`` slots, ``nq = K + 1``);
- (c) int8 pages with f32 scales per (position, head), dequantized in the
  tile; decode also overlays the slot's exact in-flight K/V at its own
  position (``nq = 1`` only, as the reference); chunked prefill attends
  the cache-roundtripped values of its own chunk too, with no overlay, so
  quantized prefill does not depend on where chunk boundaries fall.

Queries (and the overlay's K/V) are f32 or bf16, pages f32, bf16 or int8,
in every pairing (the engines serve f32 or bf16 weights over f32, bf16 or
int8 caches), and the head dim is 8, 16, 32 or 64 (:data:`HEAD_DIMS`;
the reference serves at 8 in its ``bench.py --small`` geometry, where an
int8 page row is 8 bytes and the kernel copies it whole).  The
kernel widens every bf16 value to f32 and computes in f32, as the Pallas
kernel does; the output is f32.

The kernel runs in two passes from one C call.  The split pass cuts each
slot's history at absolute positions into spans of :data:`SPAN` positions
and runs a block per (span, head, slot): it stages the span's K/V rows in
shared memory once and serves every query of the slot from that tile,
writing each query's online-softmax state ``(m, l, acc)`` to an f32
scratch (:func:`scratch_shape`, sized by :func:`split_count` from the
number of addressable positions alone).  The merge pass combines a query's
spans in ascending order.  :func:`_split_merge_plain` models the same
algebra in plain PyTorch for the tests.

Every pool is read in place through its strides.  The paged pool's
per-layer view ``cache["k"][:, layer]`` is [P, ps, h, hd] with page stride
``L*ps*h*hd``; the dense layout's per-layer view [slots, S, h, hd] is read
as ONE page of ``S`` positions per slot with identity block tables (the
TPU's ``_dense_as_pages``, with zero data movement).  A ``.contiguous()``
on either would copy the whole cache once per layer per step.

On a CPU tensor each wrapper runs the kernel's plain version
(:func:`_paged_attention_plain`, which follows the kernel's arithmetic:
every operand widened to f32); on a CUDA tensor it launches the kernel or
raises.  ``kernel="gather"`` runs the reference's legacy read
(``--decode-kernel gather``, its ``_gather_decode_*``) on either device:
the same math in f32, and in bf16 the reference's rounding — scores from
a bf16 product, softmax in f32, probabilities cast to the value dtype, a
bf16 product.  ``launches`` counts kernel launches only;
``launches_int8``, ``launches_bf16`` and ``launches_multi_query`` count
the launches over int8 pages, those with a bf16 query or bf16 pages, and
those with ``nq > 1`` among them; ``launches_verify`` the verify
wrappers' launches.

Positions past a query's ``posmat`` are masked in both versions, never
judged by content: an engine leaves a previous occupant's stale K/V (and a
quarantined slot's NaN) behind that mask.

(d) Tensor parallelism (the reference's ``_pallas_tp``): with a ``mesh``
whose ``tensor`` axis is above 1, :func:`decode_attention_dense`,
:func:`decode_attention_paged` and :func:`chunk_attention` take THIS
RANK's heads: q, the pools, their scales and the own-token rows hold
``h / tp`` heads, the block tables and positions are whole (the ``attn/``
rules of ``parallel.sharding.LAYOUT_RULES``, resolved by
:func:`attention_partition_specs`).  Heads are independent in attention,
so each rank launches the same kernel over its local heads and no
collective runs; where the reference's ``shard_map`` assembles the global
output, the port's caller keeps the local one (the row-parallel
projection after it sums over ranks).  The operands' head counts are
checked against each other under the mesh.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build
from distributeddeeplearning_tpu_torch.quant.qtensor import dequantize_kv

NEG_BIG = -1e30  # finite mask fill, matching the gather reference
#: head dims the kernel is built for
HEAD_DIMS = (8, 16, 32, 64)
#: the kernel's query (and overlay) dtypes, and its page dtypes by code
QUERY_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: ``--decode-kernel`` choices: "auto" resolves to "flash" (the CUDA
#: kernel; its plain version on the CPU), "gather" forces the legacy read.
#: The reference's "pallas"/"xla" pins name TPU implementations the port
#: does not have.
KERNELS = ("auto", "flash", "gather")

#: kernel launches since the counter was last reset (every variant)
launches = 0
#: of those, launches of the int8 variant (c)
launches_int8 = 0
#: of those, launches with a bf16 query or bf16 pages
launches_bf16 = 0
#: of those, launches with more than one query per slot (variant (b))
launches_multi_query = 0
#: of those, launches made by the speculative-verify wrappers (nq = K+1)
launches_verify = 0

#: positions a split block stages: ``SPAN`` in ``csrc/flash_decode.cu``,
#: mirrored here to size the scratch.  Never a function of the page size,
#: the table width, nq, the batch or the history length.
SPAN = 64

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (
    [_P, _I] + [_L] * 3 + [_P] * 2 + [_I] + [_L] * 3 + [_P] * 2 + [_L] * 3
    + [_P] * 2 + [_L] * 2 + [_P, _I, _I] + [_P] * 2 + [_I, _P] + [_I] * 4
    + [_P]
)
_fn: Optional[ctypes._CFuncPtr] = None
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
        fn = _build.load("flash_decode").flash_decode
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _sqrt_dim(hd: int, device) -> torch.Tensor:
    # the score DIVISOR, as the gather reference computes it
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=device))


def split_count(positions: int) -> int:
    """Split blocks a slot's history of ``positions`` addressable positions
    (``nb * page_size``) takes at :data:`SPAN` positions each: a function
    of the positions alone, so a paged pool and the dense layout of the
    same history get the same grid."""
    return -(-positions // SPAN)


def scratch_shape(b: int, nq: int, h: int, hd: int,
                  positions: int) -> Tuple[int, ...]:
    """The split pass's f32 scratch: ``(m, l, acc[hd])`` for every (slot,
    query, head, split)."""
    return (b, nq, h, split_count(positions), hd + 2)


def _check_rows(name: str, t: torch.Tensor, dtypes, align: int) -> None:
    """The head dim contiguous and, for ``align`` 16 (the pools, whose rows
    the kernel copies 16 bytes a thread), every other stride and the base
    on 16 bytes -- or on the row's own size where a row is shorter (an
    int8 row at head dim 8, which the kernel copies whole)."""
    if t.dtype not in dtypes:
        raise TypeError(
            f"paged_attention: {name} is {t.dtype}, needs one of "
            f"{[str(d).replace('torch.', '') for d in dtypes]}")
    if t.stride(-1) != 1:
        raise ValueError(
            f"paged_attention: {name} needs a contiguous head dim "
            f"(got strides {t.stride()})")
    if align:
        align = min(align, t.shape[-1] * t.element_size())
    if align and (any(st * t.element_size() % align for st in t.stride()[:-1])
                  or t.data_ptr() % align):
        raise ValueError(
            f"paged_attention: {name} rows must start on {align} bytes "
            f"(strides {t.stride()} of {t.element_size()}-byte elements, "
            f"base {t.data_ptr() % align} bytes past it)")


def _check_index(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"paged_attention: {name} must be contiguous int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"paged_attention: {name} shape {tuple(t.shape)} != {shape}"
        )


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor, shape) -> None:
    if tuple(a.shape) != tuple(shape) or a.shape != b.shape \
            or a.stride() != b.stride():
        raise ValueError(
            f"paged_attention: {name} shapes {tuple(a.shape)}/{tuple(b.shape)} "
            f"or strides differ, expected {tuple(shape)} for both"
        )


def _launch(q4, k_pages, v_pages, tables, posmat, k_scale, v_scale, k_own,
            v_own) -> torch.Tensor:
    global launches, launches_int8, launches_bf16, launches_multi_query
    b, nq, h, hd = q4.shape
    if hd not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention: the CUDA kernel takes head dims {HEAD_DIMS}, "
            f"got {hd}"
        )
    if k_pages.dim() != 4 or tuple(k_pages.shape[2:]) != (h, hd):
        raise ValueError(
            f"paged_attention: pool shape {tuple(k_pages.shape)} is not "
            f"[P, page_size, {h}, {hd}]"
        )
    _check_pair("K/V pools", k_pages, v_pages, k_pages.shape)
    int8 = k_scale is not None
    _check_rows("q", q4, QUERY_DTYPES, 0)
    pool_dtypes = (torch.int8,) if int8 else (torch.float32, torch.bfloat16)
    _check_rows("k_pages", k_pages, pool_dtypes, 16)
    _check_rows("v_pages", v_pages, pool_dtypes, 16)
    nb = tables.shape[1] if tables.dim() == 2 else -1
    _check_index("tables", tables, (b, nb))
    _check_index("posmat", posmat, (b, nq))
    operands = [k_pages, v_pages, tables, posmat]
    own = (None, None, 0, 0)
    scales = (None, None, 0, 0, 0)
    if int8:
        _check_pair("scale pools", k_scale, v_scale, k_pages.shape[:3])
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("paged_attention: scale pools must be float32")
        operands += [k_scale, v_scale]
        scales = (k_scale.data_ptr(), v_scale.data_ptr(), *k_scale.stride())
        if k_own is not None:
            _check_pair("k_own/v_own", k_own, v_own, (b, h, hd))
            _check_rows("k_own", k_own, (q4.dtype,), 0)
            _check_rows("v_own", v_own, (q4.dtype,), 0)
            operands += [k_own, v_own]
            own = (k_own.data_ptr(), v_own.data_ptr(), *k_own.stride()[:2])
    if any(t.device != q4.device for t in operands):
        raise ValueError("paged_attention: operands on different devices")
    part = torch.empty(scratch_shape(b, nq, h, hd, nb * k_pages.shape[1]),
                       dtype=torch.float32, device=q4.device)
    out = torch.empty((b, nq, h, hd), dtype=torch.float32, device=q4.device)
    with torch.cuda.device(q4.device):
        code = _kernel_fn()(
            q4.data_ptr(), QUERY_DTYPES[q4.dtype], *q4.stride()[:3],
            k_pages.data_ptr(), v_pages.data_ptr(),
            PAGE_DTYPES[k_pages.dtype], *k_pages.stride()[:3], *scales, *own,
            tables.data_ptr(), nb, k_pages.shape[1], posmat.data_ptr(),
            part.data_ptr(), part.shape[3], out.data_ptr(), b, nq, h,
            hd, torch.cuda.current_stream(q4.device).cuda_stream)
    _build.check(code, "flash_decode")
    launches += 1
    launches_int8 += int8
    launches_bf16 += torch.bfloat16 in (q4.dtype, k_pages.dtype)
    launches_multi_query += nq > 1
    return out


def _attend(q4, k_seq, v_seq, posmat):
    """Masked softmax attention of ``q4`` [b, nq, h, hd] over the dense
    history [b, s, h, hd]: query ``(b, i)`` sees positions ``<=
    posmat[b, i]``, in the reference's gather arithmetic: the scores'
    product in the operands' promoted dtype, promoted to f32 before the
    division by ``sqrt(hd)`` (``jnp`` promotes a bf16 array divided by an
    f32 one; torch keeps a 0-d f32 divisor's bf16 operand bf16, hence the
    explicit cast), the softmax in f32, the probabilities cast to the
    value dtype, and their product in it.  In f32 every cast is the
    identity."""
    hd = q4.shape[-1]
    s = k_seq.shape[1]
    dt = torch.promote_types(q4.dtype, k_seq.dtype)
    scores = torch.einsum("bqhd,bshd->bqhs", q4.to(dt), k_seq.to(dt)).float()
    scores = scores / _sqrt_dim(hd, q4.device)
    cols = torch.arange(s, device=q4.device)
    visible = cols[None, None, :] <= posmat[:, :, None]
    scores = torch.where(visible[:, :, None, :], scores, NEG_BIG)
    attn = torch.softmax(scores, dim=-1).to(v_seq.dtype)
    return torch.einsum("bqhs,bshd->bqhd", attn, v_seq)


def _attend_f32(q4, k_seq, v_seq, posmat):
    """The kernel's arithmetic: every operand widened to f32 (the Pallas
    kernel's ``astype(f32)``), then :func:`_attend`; returns f32."""
    return _attend(q4.float(), k_seq.float(), v_seq.float(), posmat)


def _overlay(seq, own, posmat):
    """``seq`` [b, s, h, hd] with each slot's row at its own position
    (``posmat[:, 0]``) replaced by ``own`` [b, h, hd]."""
    cols = torch.arange(seq.shape[1], device=seq.device)
    at = (cols[None, :] == posmat[:, :1])[..., None, None]
    return torch.where(at, own[:, None], seq)


def _gather_pages(k_pages, v_pages, tables, k_scale=None, v_scale=None):
    """The dense [b, nb*page_size, h, hd] histories the block tables
    address (dequantized on an int8 pool)."""
    b = tables.shape[0]
    s = tables.shape[1] * k_pages.shape[1]
    idx = tables.long()
    if k_scale is not None:
        k_seq = dequantize_kv(k_pages[idx], k_scale[idx])
        v_seq = dequantize_kv(v_pages[idx], v_scale[idx])
    else:
        k_seq, v_seq = k_pages[idx], v_pages[idx]
    return (k_seq.reshape(b, s, *k_pages.shape[2:]),
            v_seq.reshape(b, s, *v_pages.shape[2:]))


def _paged_history(k_pages, v_pages, tables, posmat, k_scale=None,
                   v_scale=None, k_own=None, v_own=None):
    """The dense [b, nb*page_size, h, hd] K/V histories the block tables
    address: dequantized on an int8 pool, with the own token overlaid when
    given."""
    k_seq, v_seq = _gather_pages(k_pages, v_pages, tables, k_scale, v_scale)
    if k_own is not None:
        k_seq = _overlay(k_seq, k_own, posmat)
        v_seq = _overlay(v_seq, v_own, posmat)
    return k_seq, v_seq


def _paged_attention_plain(q4, k_pages, v_pages, tables, posmat,
                           k_scale=None, v_scale=None, k_own=None, v_own=None):
    """The kernel's plain version: the histories of :func:`_paged_history`,
    then masked softmax attention in the kernel's f32 arithmetic."""
    return _attend_f32(q4, *_paged_history(k_pages, v_pages, tables, posmat,
                                           k_scale, v_scale, k_own, v_own),
                       posmat)


def _split_merge_plain(q4, k_pages, v_pages, tables, posmat, k_scale=None,
                       v_scale=None, k_own=None, v_own=None):
    """A plain model of the kernel's two passes, used by the tests: the
    histories of :func:`_paged_history` widened to f32, cut at absolute
    positions into spans of :data:`SPAN`; per (slot, query, head, span)
    ``m`` = the max visible score, ``l`` = the sum of
    ``exp(s - m)`` and ``acc`` = their product with V over visible
    positions only ((-inf, 0, 0) for a span the query does not reach);
    then the merge: ``e = exp(m - max m)`` (0 where m = -inf), ``out =
    sum(acc e) / max(sum(l e), 1e-30)``.  Positions past a query's last
    are excluded from V as well, as the kernel never reads them."""
    b, nq, h, hd = q4.shape
    k_seq, v_seq = (t.float() for t in _paged_history(
        k_pages, v_pages, tables, posmat, k_scale, v_scale, k_own, v_own))
    s = k_seq.shape[1]
    ns = split_count(s)
    pad = k_seq.new_zeros((b, ns * SPAN - s, h, hd))
    kt = torch.cat([k_seq, pad], 1).reshape(b, ns, SPAN, h, hd)
    vt = torch.cat([v_seq, pad], 1).reshape(b, ns, SPAN, h, hd)
    last = posmat.long().clamp(max=s - 1)
    cols = torch.arange(ns * SPAN, device=q4.device).reshape(ns, SPAN)
    vis = cols[None, None] <= last[:, :, None, None]  # [b, nq, ns, span]
    scores = torch.einsum("bqhd,bnthd->bqhnt", q4.float(), kt)
    scores = scores / _sqrt_dim(hd, q4.device)
    seen = vis[:, :, None]  # [b, nq, 1, ns, span]
    scores = torch.where(seen, scores, float("-inf"))
    m = scores.amax(-1)  # [b, nq, h, ns]
    p = torch.where(seen, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(-1)
    v_seen = torch.where(vis[..., None, None], vt[:, None], 0.0)
    acc = torch.einsum("bqhnt,bqnthd->bqhnd", p, v_seen)
    e = torch.where(m == float("-inf"), 0.0, torch.exp(m - m.amax(-1, keepdim=True)))
    o = (acc * e[..., None]).sum(-2)
    return o / (l * e).sum(-1).clamp_min(1e-30)[..., None]


def paged_attention(q4, k_pages, v_pages, tables, posmat, k_scale=None,
                    v_scale=None, k_own=None, v_own=None) -> torch.Tensor:
    """Attention of ``q4`` [b, nq, h, hd] over pool pages ``k_pages``/
    ``v_pages`` [P, page_size, h, hd] (strided views allowed) addressed
    through ``tables`` [b, nb] int32; query ``(b, i)`` sees positions
    ``<= posmat[b, i]`` (int32, >= 0).

    int8 pools come with f32 scale pools ``k_scale``/``v_scale`` [P,
    page_size, h]; ``k_own``/``v_own`` [b, h, hd] in q's dtype then
    overlay each slot's exact in-flight K/V at ``posmat[:, 0]`` (``nq ==
    1`` only).  ``q4`` is f32 or bf16, the pools f32, bf16 or int8.
    Returns [b, nq, h, hd] f32 — the CUDA kernel on a CUDA tensor, its
    plain version on a CPU one."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: pass both scale pools or neither")
    if (k_own is None) != (v_own is None):
        raise ValueError("paged_attention: pass both own K and V or neither")
    if k_own is not None:
        if k_scale is None:
            raise ValueError(
                "paged_attention: the own-token overlay belongs to int8 pools")
        if q4.shape[1] != 1:
            # the overlay sits at query 0's position: a multi-query
            # overlay would put every row's own token at the wrong place
            raise ValueError(
                "own-token overlay supports single-query decode only "
                f"(nq={q4.shape[1]})"
            )
    if q4.device.type == "cuda":
        return _launch(q4, k_pages, v_pages, tables, posmat, k_scale,
                       v_scale, k_own, v_own)
    if q4.device.type == "cpu":
        return _paged_attention_plain(q4, k_pages, v_pages, tables, posmat,
                                      k_scale, v_scale, k_own, v_own)
    raise ValueError(f"paged_attention: unsupported device {q4.device}")


def attention_partition_specs(operands, *, mesh):
    """The specs of the kernel's operands under a tensor-parallel mesh,
    resolved through the ``attn/`` rules of the layout table.
    ``operands``: name -> tensor (None entries, absent kernel slots, are
    skipped).  Returns ``(names, in_specs, out_spec)``."""
    from distributeddeeplearning_tpu_torch.parallel import sharding as layout

    names = [k for k, v in operands.items() if v is not None]
    in_specs = tuple(layout.spec_for(f"attn/{k}", shape=tuple(operands[k].shape),
                                     mesh=mesh) for k in names)
    out_spec = layout.spec_for("attn/out", shape=tuple(operands["q"].shape), mesh=mesh)
    return names, in_specs, out_spec


def _check_local_heads(mesh, **operands) -> None:
    """Under ``tensor > 1``: every operand the ``attn/`` rules split over
    ``tensor`` holds as many heads as q (this rank's ``h / tp``); tables
    and positions are whole.  ``operands`` are named as the rules name
    them (``q``, ``k_pages``, ``k_scale``, ``k_own``, ...)."""
    from distributeddeeplearning_tpu_torch.parallel.mesh import tensor_parallel_size

    tp = tensor_parallel_size(mesh)
    if tp <= 1:
        return
    # without a mesh the specs are the rules' own entries (no divisibility
    # drop), which locate each operand's head dim
    names, specs, _ = attention_partition_specs(operands, mesh=None)
    heads = {name: operands[name].shape[dim]
             for name, spec in zip(names, specs)
             for dim, entry in enumerate(spec) if entry == "tensor"}
    if len(set(heads.values())) > 1:
        raise ValueError(
            f"attention under tensor={tp}: the operands' local head counts "
            f"differ ({heads}); each rank passes its own h/tp heads of q, the "
            "pools, their scales and the own-token rows")


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


def _own(k_s, k_t, v_t):
    """The decode overlay's operands: the in-flight K/V on int8 caches."""
    return (k_t, v_t) if k_s is not None else (None, None)


def _own_operands(k_s, k_t, v_t):
    """The overlay's operands by their ``attn/`` rule names."""
    k_own, v_own = _own(k_s, k_t, v_t)
    return {"k_own": k_own, "v_own": v_own}


def decode_attention_dense(
    q3, k_l, v_l, k_s, v_s, k_t, v_t, pos, *, kernel: str = "auto", mesh=None,
):
    """Single-token decode attention over the dense [b, S, h, hd] cache
    layer (the reference's contract: ``q3``/``k_t``/``v_t`` [b, h, hd],
    ``pos`` [b] int32; ``k_l``/``v_l`` already hold the current token at
    ``pos``; ``k_s``/``v_s`` [b, S, h] f32 scales of an int8 cache, else
    None).  Returns ctx [b, h, hd]: f32 from the kernel and its plain
    version, the value dtype from the gather read.

    ``kernel``: ``"auto"``/``"flash"`` run :func:`paged_attention` over the
    zero-copy page view (its plain version on the dense layout on the
    CPU); ``"gather"`` the legacy read.  ``mesh``: under ``tensor > 1``
    every head operand is this rank's slice (module docstring, (d))."""
    _check_local_heads(mesh, q=q3[:, None], k_pages=k_l, v_pages=v_l,
                       k_scale=k_s, v_scale=v_s, **_own_operands(k_s, k_t, v_t))
    if resolve_kernel(kernel) == "gather":
        return _gather_decode_dense(q3, k_l, v_l, k_s, v_s, k_t, v_t, pos)
    if q3.device.type == "cpu":
        posmat = pos.reshape(-1, 1)
        return _attend_f32(q3[:, None], *_dense_history(
            k_l, v_l, k_s, v_s, k_t, v_t, posmat), posmat)[:, 0]
    posmat = pos.to(torch.int32).reshape(-1, 1)
    out = paged_attention(q3[:, None], k_l, v_l, _dense_as_pages(k_l), posmat,
                          k_s, v_s, *_own(k_s, k_t, v_t))
    return out[:, 0]


def _dense_history(k_l, v_l, k_s, v_s, k_t, v_t, posmat):
    """The dense layer's K/V histories as attention reads them: on an int8
    cache dequantized, with the exact current token overlaid."""
    if k_s is None:
        return k_l, v_l
    return (_overlay(dequantize_kv(k_l, k_s), k_t, posmat),
            _overlay(dequantize_kv(v_l, v_s), v_t, posmat))


def _gather_decode_dense(q3, k_l, v_l, k_s, v_s, k_t, v_t, pos):
    """Legacy dense decode attention (the reference's ``_gather_decode_
    dense``), in its rounding (:func:`_attend`)."""
    posmat = pos.reshape(-1, 1)
    return _attend(q3[:, None], *_dense_history(k_l, v_l, k_s, v_s, k_t, v_t,
                                                posmat), posmat)[:, 0]


def decode_attention_paged(
    q3, k_l, v_l, k_s, v_s, k_t, v_t, pos, block_tables, *,
    kernel: str = "auto", mesh=None,
):
    """Single-token decode attention over the paged pool.

    ``q3``/``k_t``/``v_t``: [b, h, hd] (query and the exact in-flight
    token); ``k_l``/``v_l``: [P, ps, h, hd] this layer's pool view, already
    holding the current token's write; ``k_s``/``v_s``: [P, ps, h] f32 or
    None; ``pos``: [b]; ``block_tables``: [b, nb] int32.  Returns ctx
    [b, h, hd].  ``mesh``: as :func:`decode_attention_dense`'s."""
    _check_local_heads(mesh, q=q3[:, None], k_pages=k_l, v_pages=v_l,
                       k_scale=k_s, v_scale=v_s, **_own_operands(k_s, k_t, v_t))
    if resolve_kernel(kernel) == "gather":
        return _gather_decode_paged(q3, k_l, v_l, k_s, v_s, k_t, v_t, pos,
                                    block_tables)
    posmat = pos.to(torch.int32).reshape(-1, 1)
    out = paged_attention(q3[:, None], k_l, v_l, block_tables, posmat,
                          k_s, v_s, *_own(k_s, k_t, v_t))
    return out[:, 0]


def _gather_decode_paged(q3, k_l, v_l, k_s, v_s, k_t, v_t, pos, block_tables):
    """Legacy paged decode attention (the reference's ``_gather_decode_
    paged``): block-table gather, dequant and own-token select at history
    granularity, in the reference's rounding (:func:`_attend`)."""
    posmat = pos.reshape(-1, 1)
    return _attend(q3[:, None], *_paged_history(
        k_l, v_l, block_tables, posmat, k_s, v_s, *_own(k_s, k_t, v_t)),
        posmat)[:, 0]


def chunk_attention(q_c, k_l, v_l, k_s, v_s, block_table, posns, *,
                    kernel: str = "auto", mesh=None):
    """Chunked-prefill history attention: ``q_c`` [C, h, hd] at logical
    positions ``posns`` [C] against ONE sequence's pages (``block_table``
    [nb] int32).  No own-token overlay on int8 pools: prefill attends the
    cache-roundtripped values, so quantized prefill does not depend on
    where the chunk boundaries fall.  Returns ctx [C, h, hd].  ``mesh``:
    as :func:`decode_attention_dense`'s."""
    _check_local_heads(mesh, q=q_c[None], k_pages=k_l, v_pages=v_l,
                       k_scale=k_s, v_scale=v_s)
    if resolve_kernel(kernel) == "gather":
        return _gather_chunk(q_c, k_l, v_l, k_s, v_s, block_table, posns)
    return paged_attention(q_c[None], k_l, v_l, block_table[None],
                           posns.to(torch.int32)[None], k_s, v_s)[0]


def _gather_chunk(q_c, k_l, v_l, k_s, v_s, block_table, posns):
    """Legacy chunk attention (the reference's ``_gather_chunk``)."""
    posmat = posns[None]
    return _attend(q_c[None], *_paged_history(
        k_l, v_l, block_table[None], posmat, k_s, v_s), posmat)[0]


def verify_attention_paged(q4, k_l, v_l, block_tables, posmat, *,
                           kernel: str = "auto"):
    """Speculative-verify attention over the paged pool: ``q4`` [b, K1, h,
    hd] with per-query positions ``posmat`` [b, K1] int32 through
    ``block_tables`` [b, nb] — the kernel at ``nq = K1``, every query of a
    slot served from the same staged tiles by the same code, so column
    ``j`` is computed exactly as an ``nq = 1`` launch at ``posmat[:, j]``
    would compute it.  f32 pools only (the verify pass refuses int8
    upstream).  Returns ctx [b, K1, h, hd]; ``kernel="gather"`` or a CPU
    tensor runs the plain version."""
    global launches_verify
    if resolve_kernel(kernel) == "gather" or q4.device.type == "cpu":
        return _verify_dense_math(q4, *_gather_pages(k_l, v_l, block_tables),
                                  posmat)
    out = paged_attention(q4, k_l, v_l, block_tables, posmat)
    launches_verify += 1
    return out


def verify_attention_dense(q4, k_l, v_l, posmat, *, kernel: str = "auto"):
    """Speculative-verify attention over the dense cache layer ``k_l``/
    ``v_l`` [b, S, h, hd] (f32), through the zero-copy page view on the
    card; a query whose ``posmat`` passes ``S - 1`` sees the whole row, as
    in the plain version.  Returns ctx [b, K1, h, hd]."""
    global launches_verify
    if resolve_kernel(kernel) == "gather" or q4.device.type == "cpu":
        return _verify_dense_math(q4, k_l, v_l, posmat)
    out = paged_attention(q4, k_l, v_l, _dense_as_pages(k_l), posmat)
    launches_verify += 1
    return out



def _verify_dense_math(q4, k_seq, v_seq, posmat):
    """The verify pass's plain math over dense histories [b, s, h, hd]:
    the masked attention of :func:`_attend`, one query column at a time.
    Column ``j`` is then computed exactly as a decode step's ``nq = 1``
    attention at ``posmat[:, j]`` — the per-query independence the kernel
    has by design — so on the CPU too a verify pass reproduces a
    sequential decode walk bitwise.  (A single einsum over all K1 columns
    takes another BLAS path than the decode's one-row product and rounds
    differently.)"""
    return torch.cat([_attend(q4[:, j:j + 1], k_seq, v_seq, posmat[:, j:j + 1])
                      for j in range(q4.shape[1])], dim=1)

"""Time the flash-attention kernels of one checkout of the PyTorch port on
one card.

    python3 scripts/time_flash.py [--root DIR] [--tag NAME] [--only f32_k1|bf16_bwd|f32_bwd]

``--root`` is the directory that holds ``distributeddeeplearning_tpu_torch``
(default: the checkout this script lies in), so that two checkouts can be
timed on one card in one sitting, each building its own kernels; run them
interleaved (A, B, B, A) and compare only times taken together.  Rows:

- ``K1_f32`` ... ``K3_bf16``: the unmasked K1, K2, K3 in f32 and bf16 at
  the LM training shape (B=8, H=12, S=2048, D=64, causal; q, k, v as
  strided views of one qkv tensor);
- ``bf16_k1``: bf16 K1 beside one ``scaled_dot_product_attention`` call on
  the same inputs (``library_ms``) and its bound (``chip_smoke.bound_ms``
  at the bf16 tensor-core peak) at
  ``train`` (the training shape), ``prefill`` (B=1, H=12, S=512, D=64,
  causal: the bf16 serving prompt pass), ``bias512`` and ``bias128``
  (B=8, H=12, D=64, non-causal, the key-padding bias of a
  ``SyntheticTextDataset`` batch's mask, seed 42: BERT fine-tuning at seq
  512 and 128; SDPA gets the same boolean mask), ``d8``, ``d16`` and
  ``d32`` (``chip_smoke.HEADDIM_GEOMETRY``'s shapes, causal).  Where the
  checkout's forward library has it, each entry also gives
  ``block_rows``, the query rows a block its launcher picks;
- ``f32_k1``: the f32 K1 (split TF32 on the tensor cores) at the same
  rows, f32 inputs, beside one f32 SDPA call (``library_ms``, and the
  kernels it ran, ms a call each, under ``library_kernels``), with bounds
  at the split-TF32 rate (``bound_ms``) and at the f32 FMA rate of the
  CUDA cores (``fma_bound_ms``), ``event_ms`` and ``library_event_ms``
  (CUDA events around back-to-back calls, ``chip_smoke.cuda_ms``: a
  cross-check of the profiler's times) and ``block_rows`` where the
  checkout's forward library has ``flash_attention_fwd_f32_block_rows``;
- ``bf16_bwd``: bf16 K2 (dQ) and K3 (dK/dV) at ``bf16_k1``'s shapes
  but ``prefill`` (:data:`BWD_ROWS`), each row with ``dq_ms``,
  ``dkv_ms``, their sum, ``delta_ms`` (the wrapper's rowsum(dO * O), so
  that ``whole_ms`` is the port's whole backward), ``library_ms`` (autograd
  through one SDPA call, its whole backward), both bounds
  (``chip_smoke.bound_ms`` at 6 D and 8 D flops a visible pair), each
  pass's TFLOP/s and, where the checkout's backward library has it,
  ``block_rows`` (the rows a block owns, per pass);
- ``f32_bwd``: the same for the f32 K2 and K3 (split TF32 on the tensor
  cores) at the same rows, f32 inputs, with both
  bounds at the split-TF32 rate (a third of the dense TF32 peak,
  ``chip_smoke.TF32X3_FLOPS_PER_S``) and at the f32 FMA rate of the CUDA
  cores (``*_fma_bound_ms``), ``block_rows`` from the checkout's
  ``flash_attention_bwd_f32_block_rows`` where it has one, and
  ``*_event_ms``: K2, K3 and SDPA's backward timed again by CUDA events
  around back-to-back calls (``chip_smoke.cuda_ms``), a cross-check of the
  profiler's times; every backward row also names the kernels SDPA's
  backward ran (``library_kernels``, ms a call each);
- ``encode_us``: the host time of one TMA tensor-map encode, three of
  which (four with the bias) the bf16 forward's launcher makes a call
  (:func:`encode_us`).

``--only f32_k1`` (``bf16_bwd``, ``f32_bwd``) times those rows alone.
``--digest`` times nothing: it prints, for each backward row, the sha256
of the f32 K2 and K3 outputs on inputs that do not depend on the
checkout's kernels (lse and O from the plain forward, a seeded dO), and of
those inputs, so that two checkouts' f32 backward kernels can be shown
bitwise equal.

Times are ``chip_smoke.py``'s ``device_ms``: the device time a call takes,
summed by torch.profiler over 20 calls after 3 warm-up calls, host launch
gaps left out.  ``chip_smoke.py`` is always this script's own checkout's;
only the port's package comes from ``--root``.  Prints the card as
``nvidia-smi`` names it, then one JSON line."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

B, H, S, D = 8, 12, 2048, 64
#: name -> (B, H, S, D, causal, masked) of the K1 rows (bf16 and f32)
K1_ROWS = {
    "train": (B, H, S, D, True, False),
    "prefill": (1, 12, 512, 64, True, False),
    "bias512": (8, 12, 512, 64, False, True),
    "bias128": (8, 12, 128, 64, False, True),
    **{f"d{d}": (b, h, s, d, True, False)
       for d, (h, b, s) in cs.HEADDIM_GEOMETRY.items()},
}

#: name -> (B, H, S, D, causal, masked) of the backward rows (bf16 and
#: f32): every K1 row but the serving prompt pass, which takes no gradient
BWD_ROWS = {name: row for name, row in K1_ROWS.items() if name != "prefill"}


def encode_us(torch, repeats: int = 5, n: int = 2000) -> float:
    """Host microseconds of one ``cuTensorMapEncodeTiled`` call for a
    strided [8, 2048, 12, 64] bf16 view (the map the bf16 forward's launcher
    encodes three times a call, four with a bias): the driver's function
    through ctypes, the least of ``repeats`` loops of ``n`` calls, less a
    loop of the same ctypes call to ``cuDriverGetVersion``."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    enc = cuda.cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    enc.restype = ctypes.c_int
    buf = ctypes.create_string_buffer(128 + 64)
    tmap = ctypes.c_void_p((ctypes.addressof(buf) + 63) // 64 * 64)
    qkv = torch.empty((B, S, 3 * H * D), dtype=torch.bfloat16, device="cuda")
    dims = (u64 * 4)(D, H, S, B)
    strides = (u64 * 3)(D * 2, 3 * H * D * 2, S * 3 * H * D * 2)
    box, ones = (u32 * 4)(D, 1, 128, 1), (u32 * 4)(1, 1, 1, 1)
    # bf16 = 9, no interleave, 128-byte swizzle = 3, L2 256 B = 3, zero fill
    args = (tmap, 9, 4, ctypes.c_void_p(qkv.data_ptr()), dims, strides, box,
            ones, 0, 3, 3, 0)
    if enc(*args) != 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused the map")
    version = ctypes.c_int()
    null = lambda: cuda.cuDriverGetVersion(ctypes.byref(version))  # noqa: E731

    def best(fn):
        out = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out = min(out, time.perf_counter() - t0)
        return out / n * 1e6

    return best(lambda: enc(*args)) - best(null)


def _row_inputs(torch, fa, row, dtype=None):
    """q, k, v in ``dtype`` (default bf16; strided views of one qkv tensor),
    the key-padding bias and its boolean mask (None unless masked), and the
    visible (query, key) pairs at one ``(B, H, S, D, causal, masked)``
    row."""
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    b, h, s, d, causal, masked = row
    q, k, v = cs.qkv_views(torch, b, s, h, d, dtype or torch.bfloat16, seed=s + d)
    bias = keep = None
    pairs = b * h * cs._causal_pairs(s) if causal else b * h * s * s
    if masked:
        mask = next(SyntheticTextDataset(length=b, seq_len=s, seed=42).batches(b))[
            "attention_mask"]
        keep = torch.from_numpy(mask).bool().cuda()
        bias = fa._mask_bias(keep[:, None, None, :], b, s)
        pairs = h * s * int(keep.sum().item())  # query rows x visible keys
    return q, k, v, bias, keep, pairs


def _shape(row) -> str:
    b, h, s, d, causal, masked = row
    return (f"B={b} H={h} S={s} D={d} {'causal' if causal else 'non-causal'}"
            + (" bias" if masked else ""))


def k1_row(torch, F, fa, name, block_rows, dtype):
    """K1 in ``dtype``, SDPA and the bound at one row of :data:`K1_ROWS`
    (f32: at the split-TF32 rate, and at the FMA rate beside it)."""
    f32 = dtype == torch.float32
    b, h, s, d, causal, masked = K1_ROWS[name]
    q, k, v, bias, keep, pairs = _row_inputs(torch, fa, K1_ROWS[name], dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None if keep is None else keep[:, None, None, :]

    def run(i):
        return fa.flash_attention_core(q, k, v, causal=causal, bias=bias)

    def sdpa(i):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask,
                                              is_causal=causal)

    ms = cs.device_ms(torch, run)
    lib_kernels = {}  # the library call's kernels by name, ms a call
    lib_ms = cs.device_ms(torch, sdpa, by_kernel=lib_kernels)
    es = 4.0 if f32 else 2.0
    nbytes = es * 4 * b * s * h * d + 4.0 * b * h * s + (4.0 * b * s if masked else 0)
    flops = 4.0 * d * pairs
    bms, by = cs.bound_ms(nbytes, flops, cs.TF32X3_FLOPS_PER_S if f32
                          else cs.BF16_FLOPS_PER_S)
    entry = dict(ms=ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                 tflops=flops / ms / 1e9, shape=_shape(K1_ROWS[name]))
    if f32:
        # the CUDA cores' FMA rate, the route of the earlier kernel; CUDA
        # events around 20 back-to-back calls (launch gaps included)
        entry["fma_bound_ms"], entry["fma_bound_by"] = cs.bound_ms(nbytes, flops)
        entry["event_ms"] = cs.cuda_ms(torch, run, iters=20)
        entry["library_event_ms"] = cs.cuda_ms(torch, sdpa, iters=20)
        entry["library_kernels"] = lib_kernels
    if block_rows is not None:
        entry["block_rows"] = block_rows(b, h, s)
    return entry


def bwd_row(torch, F, fa, row, block_rows, dtype):
    """K2 and K3 in ``dtype``, the wrapper's delta, autograd through SDPA
    and both bounds at one ``(B, H, S, D, causal, masked)`` row (f32: at
    the split-TF32 rate, and at the FMA rate beside it)."""
    f32 = dtype == torch.float32
    b, h, s, d, causal, masked = row
    q, k, v, bias, keep, pairs = _row_inputs(torch, fa, row, dtype)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias)
    g = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)

    def delta_fn():  # the wrapper's delta (ops/flash_attention.py backward)
        return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

    delta = delta_fn()
    dq_ms = cs.device_ms(torch, lambda i: fa._launch_bwd_dq(
        q, k, v, do, lse, delta, causal=causal, bias=bias))
    dkv_ms = cs.device_ms(torch, lambda i: fa._launch_bwd_dkv(
        q, k, v, do, lse, delta, causal=causal, bias=bias))
    delta_ms = cs.device_ms(torch, lambda i: delta_fn())
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=None if keep is None else keep[:, None, None, :],
        is_causal=causal)
    lib_kernels = {}  # the library backward's kernels by name, ms a call
    lib_ms = cs.device_ms(torch, lambda i: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=10,
        by_kernel=lib_kernels)
    head = (4.0 if f32 else 2.0) * b * s * h * d  # one [B, S, H, D] tensor
    rows_in = 4 * head + 2 * 4.0 * b * h * s + (4.0 * b * s if masked else 0)
    peak = cs.TF32X3_FLOPS_PER_S if f32 else cs.BF16_FLOPS_PER_S
    b_dq = cs.bound_ms(rows_in + head, 6.0 * d * pairs, peak)
    b_dkv = cs.bound_ms(rows_in + 2 * head, 8.0 * d * pairs, peak)
    entry = dict(dq_ms=dq_ms, dkv_ms=dkv_ms, sum_ms=dq_ms + dkv_ms,
                 delta_ms=delta_ms, whole_ms=dq_ms + dkv_ms + delta_ms,
                 library_ms=lib_ms, dq_bound_ms=b_dq[0], dq_bound_by=b_dq[1],
                 dkv_bound_ms=b_dkv[0], dkv_bound_by=b_dkv[1],
                 dq_tflops=6.0 * d * pairs / dq_ms / 1e9,
                 dkv_tflops=8.0 * d * pairs / dkv_ms / 1e9,
                 library_kernels=lib_kernels, shape=_shape(row))
    if f32:
        # a cross-check of the profiler's times: CUDA events around 20
        # back-to-back calls (launch gaps included)
        entry["dq_event_ms"] = cs.cuda_ms(torch, lambda i: fa._launch_bwd_dq(
            q, k, v, do, lse, delta, causal=causal, bias=bias), iters=20)
        entry["dkv_event_ms"] = cs.cuda_ms(torch, lambda i: fa._launch_bwd_dkv(
            q, k, v, do, lse, delta, causal=causal, bias=bias), iters=20)
        entry["library_event_ms"] = cs.cuda_ms(torch, lambda i: torch.autograd.grad(
            out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=10)
        # the CUDA cores' FMA rate, the route of the earlier kernels
        for kind, flops in (("dq", 6.0), ("dkv", 8.0)):
            fma = cs.bound_ms(rows_in + (1 if kind == "dq" else 2) * head,
                              flops * d * pairs)
            entry[f"{kind}_fma_bound_ms"], entry[f"{kind}_fma_bound_by"] = fma
    if block_rows is not None:  # the backward library's rule, per pass
        entry["block_rows"] = {"dq": block_rows(0, b, h, s),
                               "dkv": block_rows(1, b, h, s)}
    return entry


def bwd_digests(torch, fa, row):
    """sha256 of the f32 K2 and K3 outputs at one backward row, with lse
    and delta from the plain forward on the card, and of lse and delta."""
    import hashlib

    b, h, s, d, causal, masked = row
    q, k, v, bias, _, _ = _row_inputs(torch, fa, row, torch.float32)
    o, lse = fa._dense_attention(q, k, v, bias, causal=causal)
    g = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(o.shape, generator=g, device="cuda")
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, causal=causal, bias=bias)
    dk, dv = fa._launch_bwd_dkv(q, k, v, do, lse, delta, causal=causal, bias=bias)
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
            for name, t in (("lse", lse), ("delta", delta), ("dq", dq), ("dk", dk),
                            ("dv", dv))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("f32_k1", "bf16_bwd", "f32_bwd"), default=None,
                    help="time these rows alone")
    ap.add_argument("--digest", action="store_true",
                    help="print digests of the f32 K2/K3 outputs instead of times")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    cs.set_peaks(torch)  # bounds over the card's peaks (utils/hardware.PEAKS)
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    if args.digest:
        print(json.dumps({"tag": args.tag, "root": args.root, "digests": {
            name: bwd_digests(torch, fa, row) for name, row in BWD_ROWS.items()
            if row[3] in fa.HEAD_DIMS}}))
        return 0
    out = {}
    fwd_lib = _build.load("flash_attention_fwd")
    bwd_lib = _build.load("flash_attention_bwd")
    # a head dim the checkout's wrappers do not take (8 before they padded
    # it) is left out
    takes = lambda row: row[3] in fa.HEAD_DIMS  # noqa: E731
    if args.only in (None, "f32_k1"):
        rows_fn = getattr(fwd_lib, "flash_attention_fwd_f32_block_rows", None)
        out["f32_k1"] = {name: k1_row(torch, F, fa, name, rows_fn, torch.float32)
                         for name, row in K1_ROWS.items() if takes(row)}
    for key, dtype in (("bf16_bwd", torch.bfloat16), ("f32_bwd", torch.float32)):
        if args.only in (None, key):
            name = f"flash_attention_bwd_{key.split('_')[0]}_block_rows"
            rows_fn = getattr(bwd_lib, name, None)
            out[key] = {name: bwd_row(torch, F, fa, row, rows_fn, dtype)
                        for name, row in BWD_ROWS.items() if takes(row)}
    for dtype in (() if args.only else (torch.float32, torch.bfloat16)):
        q, k, v = cs.qkv_views(torch, B, S, H, D, dtype, seed=0)
        o, lse = fa.flash_attention_core(q, k, v, causal=True)
        g = torch.Generator(device="cuda").manual_seed(1)
        do = torch.randn(o.shape, generator=g, device="cuda").to(dtype)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        out[f"K1_{tag}"] = cs.device_ms(
            torch, lambda i: fa.flash_attention_core(q, k, v, causal=True))
        out[f"K2_{tag}"] = cs.device_ms(torch, lambda i: fa._launch_bwd_dq(
            q, k, v, do, lse, delta, causal=True))
        out[f"K3_{tag}"] = cs.device_ms(torch, lambda i: fa._launch_bwd_dkv(
            q, k, v, do, lse, delta, causal=True))
        del q, k, v, o, lse, do, delta
    if not args.only:
        rows_fn = getattr(fwd_lib, "flash_attention_fwd_bf16_block_rows", None)
        out["bf16_k1"] = {name: k1_row(torch, F, fa, name, rows_fn, torch.bfloat16)
                          for name, row in K1_ROWS.items() if takes(row)}
        out["encode_us"] = encode_us(torch)
    card = cs.card_line()
    print(card)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "shape": f"B={B} H={H} S={S} D={D} causal", "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the flash-attention kernels of one checkout of the PyTorch port on
one card.

    python3 scripts/time_flash.py [--root DIR] [--tag NAME] [--only bf16_bwd]

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
  512 and 128; SDPA gets the same boolean mask), ``d16`` and ``d32``
  (``chip_smoke.HEADDIM_GEOMETRY``'s shapes, causal).  Where the
  checkout's forward library has it, each entry also gives
  ``block_rows``, the query rows a block its launcher picks;
- ``bf16_bwd``: bf16 K2 (dQ) and K3 (dK/dV) at ``bf16_k1``'s shapes
  but ``prefill`` (:data:`BWD_ROWS`), each row with ``dq_ms``,
  ``dkv_ms``, their sum, ``delta_ms`` (the wrapper's rowsum(dO * O), so
  that ``whole_ms`` is the port's whole backward), ``library_ms`` (autograd
  through one SDPA call, its whole backward), both bounds
  (``chip_smoke.bound_ms`` at 6 D and 8 D flops a visible pair), each
  pass's TFLOP/s and, where the checkout's backward library has it,
  ``block_rows`` (the rows a block owns, per pass);
- ``encode_us``: the host time of one TMA tensor-map encode, three of
  which (four with the bias) the bf16 forward's launcher makes a call
  (:func:`encode_us`).

``--only bf16_bwd`` times the ``bf16_bwd`` rows alone.

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
#: name -> (B, H, S, D, causal, masked) of the bf16 K1 rows
K1_ROWS = {
    "train": (B, H, S, D, True, False),
    "prefill": (1, 12, 512, 64, True, False),
    "bias512": (8, 12, 512, 64, False, True),
    "bias128": (8, 12, 128, 64, False, True),
    **{f"d{d}": (b, h, s, d, True, False)
       for d, (h, b, s) in cs.HEADDIM_GEOMETRY.items()},
}

#: name -> (B, H, S, D, causal, masked) of the bf16 backward rows
BWD_ROWS = {name: K1_ROWS[name] for name in ("train", "bias512", "bias128", "d16", "d32")}


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


def _row_inputs(torch, fa, row):
    """bf16 q, k, v (strided views of one qkv tensor), the key-padding bias
    and its boolean mask (None unless masked), and the visible (query, key)
    pairs at one ``(B, H, S, D, causal, masked)`` row."""
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    b, h, s, d, causal, masked = row
    q, k, v = cs.qkv_views(torch, b, s, h, d, torch.bfloat16, seed=s + d)
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


def bf16_k1_row(torch, F, fa, name, block_rows):
    """bf16 K1, SDPA and the bound at one row of :data:`K1_ROWS`."""
    b, h, s, d, causal, masked = K1_ROWS[name]
    q, k, v, bias, keep, pairs = _row_inputs(torch, fa, K1_ROWS[name])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None if keep is None else keep[:, None, None, :]

    ms = cs.device_ms(torch, lambda i: fa.flash_attention_core(
        q, k, v, causal=causal, bias=bias))
    lib_ms = cs.device_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal))
    nbytes = 2.0 * 4 * b * s * h * d + 4.0 * b * h * s + (4.0 * b * s if masked else 0)
    bms, by = cs.bound_ms(nbytes, 4.0 * d * pairs, cs.BF16_FLOPS_PER_S)
    entry = dict(ms=ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                 tflops=4.0 * d * pairs / ms / 1e9, shape=_shape(K1_ROWS[name]))
    if block_rows is not None:
        entry["block_rows"] = block_rows(b, h, s)
    return entry


def bf16_bwd_row(torch, F, fa, name, block_rows):
    """bf16 K2 and K3, the wrapper's delta, autograd through SDPA and both
    bounds at one row of :data:`BWD_ROWS`."""
    b, h, s, d, causal, masked = BWD_ROWS[name]
    q, k, v, bias, keep, pairs = _row_inputs(torch, fa, BWD_ROWS[name])
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias)
    g = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()

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
    lib_ms = cs.device_ms(torch, lambda i: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=10)
    head = 2.0 * b * s * h * d  # one [B, S, H, D] bf16 tensor
    rows_in = 4 * head + 2 * 4.0 * b * h * s + (4.0 * b * s if masked else 0)
    b_dq = cs.bound_ms(rows_in + head, 6.0 * d * pairs, cs.BF16_FLOPS_PER_S)
    b_dkv = cs.bound_ms(rows_in + 2 * head, 8.0 * d * pairs, cs.BF16_FLOPS_PER_S)
    entry = dict(dq_ms=dq_ms, dkv_ms=dkv_ms, sum_ms=dq_ms + dkv_ms,
                 delta_ms=delta_ms, whole_ms=dq_ms + dkv_ms + delta_ms,
                 library_ms=lib_ms, dq_bound_ms=b_dq[0], dq_bound_by=b_dq[1],
                 dkv_bound_ms=b_dkv[0], dkv_bound_by=b_dkv[1],
                 dq_tflops=6.0 * d * pairs / dq_ms / 1e9,
                 dkv_tflops=8.0 * d * pairs / dkv_ms / 1e9,
                 shape=_shape(BWD_ROWS[name]))
    if block_rows is not None:  # the backward library's rule, per pass
        entry["block_rows"] = {"dq": block_rows(0, b, h, s),
                               "dkv": block_rows(1, b, h, s)}
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("bf16_bwd",), default=None,
                    help="time these rows alone")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    out = {}
    bwd_rows_fn = getattr(_build.load("flash_attention_bwd"),
                          "flash_attention_bwd_bf16_block_rows", None)
    out["bf16_bwd"] = {name: bf16_bwd_row(torch, F, fa, name, bwd_rows_fn)
                       for name in BWD_ROWS}
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
        rows_fn = getattr(_build.load("flash_attention_fwd"),
                          "flash_attention_fwd_bf16_block_rows", None)
        out["bf16_k1"] = {name: bf16_k1_row(torch, F, fa, name, rows_fn)
                          for name in K1_ROWS}
        out["encode_us"] = encode_us(torch)
    card = cs.card_line()
    print(card)
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "shape": f"B={B} H={H} S={S} D={D} causal", "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

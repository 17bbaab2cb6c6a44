"""Time the flash-attention kernels of one checkout of the PyTorch port on
one card.

    python3 scripts/time_flash.py [--root DIR] [--tag NAME]

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
- ``encode_us``: the host time of one TMA tensor-map encode, three of
  which (four with the bias) the bf16 forward's launcher makes a call
  (:func:`encode_us`).

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


def bf16_k1_row(torch, F, fa, name, block_rows):
    """bf16 K1, SDPA and the bound at one row of :data:`K1_ROWS`."""
    from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

    b, h, s, d, causal, masked = K1_ROWS[name]
    q, k, v = cs.qkv_views(torch, b, s, h, d, torch.bfloat16, seed=s + d)
    bias = keep = None
    pairs = b * h * cs._causal_pairs(s) if causal else b * h * s * s
    if masked:
        mask = next(SyntheticTextDataset(length=b, seq_len=s, seed=42).batches(b))[
            "attention_mask"]
        keep = torch.from_numpy(mask).bool().cuda()
        bias = fa._mask_bias(keep[:, None, None, :], b, s)
        pairs = h * s * int(keep.sum().item())  # query rows x visible keys
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None if keep is None else keep[:, None, None, :]

    ms = cs.device_ms(torch, lambda i: fa.flash_attention_core(
        q, k, v, causal=causal, bias=bias))
    lib_ms = cs.device_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal))
    nbytes = 2.0 * 4 * b * s * h * d + 4.0 * b * h * s + (4.0 * b * s if masked else 0)
    bms, by = cs.bound_ms(nbytes, 4.0 * d * pairs, cs.BF16_FLOPS_PER_S)
    entry = dict(ms=ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                 tflops=4.0 * d * pairs / ms / 1e9,
                 shape=f"B={b} H={h} S={s} D={d} {'causal' if causal else 'non-causal'}"
                       + (" bias" if masked else ""))
    if block_rows is not None:
        entry["block_rows"] = block_rows(b, h, s)
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
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
    for dtype in (torch.float32, torch.bfloat16):
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

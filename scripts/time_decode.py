"""Time the decode-attention kernel K4 of one checkout of the PyTorch port
at the shapes of ``PERF.md``'s K4 rows, on one card.

    python3 scripts/time_decode.py [--root DIR] [--tag NAME] [--serve]

``--root`` is the directory that holds ``distributeddeeplearning_tpu_torch``
(default: the checkout this script lies in), so that two checkouts can be
timed on one card in one sitting, each building its own kernel: run them
interleaved (A, B, B, A) and compare only times taken together.  The rows
go through the public wrappers every checkout has:

- ``a``: f32 decode on the dense cache's strided layer views, b=8, h=12,
  hd=64, S=576, positions 0..575;
- ``b``: an f32 chunk, b=1, nq=64 at positions 512..575, through a
  scrambled 9-page table of a 73-page pool (page 64);
- ``verify``: f32, b=8, nq=5 at pos + 0..4;
- ``c``: int8 pages with the own-token overlay, b=8, nq=1;
- ``bf16``: bf16 pages under bf16 queries, b=8, nq=1;
- ``int8_bf16q``: int8 pages under bf16 queries and overlay;
- ``d16_*`` / ``d32_*``: a, b, verify, c and bf16 at head dims 16 (h=4)
  and 32 (h=8) on 2-layer pools.

``--serve`` also runs the serving cells of ``chip_smoke.py`` with its
weights, requests and engines (``serve_params``, ``serve_requests``,
``serve_engine``): dense f32 and bf16, paged f32, int8 and bf16.  Each
cell reports tokens/s and the decode step p50 of the scheduler's run,
then profiles 10 decode steps of 8 slots at position 300
(``fill_slots``, ``profile_share``): host wall, kernel time, busy share
and the decode kernel's time (every kernel whose name holds
``flash_decode``).

Each time is ``chip_smoke.py``'s ``device_ms`` over 120 calls (the device
time a call takes, host launch gaps left out; ``kernels`` splits it by
kernel), the calls cycling through the pool's layers so the history is
not served from L2.  ``chip_smoke.py`` is always this script's own
checkout's; only the port's package comes from ``--root``.  Prints the
card as ``nvidia-smi`` names it, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

POS = (0, 575, 17, 300, 64, 511, 128, 450)
SPEC_POS = cs.SPEC_POS
SLOTS, S, PAGE, PAGES, C, K1 = (cs.SLOTS, cs.MAX_SEQ, cs.PAGE, cs.POOL_PAGES,
                                cs.CHUNK, cs.SPEC_K + 1)


def rows_at(torch, fd, hd, h, layers, prefix=""):
    """{row name: fn(i)} at head dim ``hd`` with ``h`` heads over pools of
    ``layers`` layers (the call cycles layer i % layers)."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(hd)
    dense = [torch.randn((SLOTS, layers, S, h, hd), generator=g, device="cuda")
             for _ in range(2)]
    pool = [torch.randn((PAGES + 1, layers, PAGE, h, hd), generator=g, device="cuda")
            for _ in range(2)]
    ipool = [quantize_kv(t) for t in pool]  # (codes, scales) for K and V
    bpool = [t.bfloat16() for t in pool]
    perm = torch.randperm(PAGES, generator=torch.Generator().manual_seed(hd))
    tables = (perm + 1).reshape(SLOTS, S // PAGE).to(torch.int32).cuda()
    pos = torch.tensor(POS, dtype=torch.int32, device="cuda")
    vpos = torch.tensor(SPEC_POS, dtype=torch.int32, device="cuda")
    posmat = (vpos[:, None] + torch.arange(K1, device="cuda")).to(torch.int32)
    qkv = torch.randn((SLOTS, 3, h, hd), generator=g, device="cuda")
    q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    qb, kb_t, vb_t = q3.bfloat16(), k_t.bfloat16(), v_t.bfloat16()
    q_c = torch.randn((C, 3, h, hd), generator=g, device="cuda")[:, 0]
    posns = 512 + torch.arange(C, device="cuda")
    q4 = torch.randn((SLOTS, K1, 3 * h * hd), generator=g, device="cuda")[..., : h * hd]
    q4 = q4.reshape(SLOTS, K1, h, hd)
    L = layers
    dv = lambda i: (dense[0][:, i % L], dense[1][:, i % L])  # noqa: E731
    pv = lambda i: (pool[0][:, i % L], pool[1][:, i % L])  # noqa: E731
    bv = lambda i: (bpool[0][:, i % L], bpool[1][:, i % L])  # noqa: E731
    iv = lambda i: (ipool[0][0][:, i % L], ipool[1][0][:, i % L],  # noqa: E731
                    ipool[0][1][:, i % L], ipool[1][1][:, i % L])
    rows = {
        "a": lambda i: fd.decode_attention_dense(q3, *dv(i), None, None, None, None,
                                                 pos),
        "b": lambda i: fd.chunk_attention(q_c, *pv(i), None, None, tables[0], posns),
        "verify": lambda i: fd.verify_attention_paged(q4, *pv(i), tables, posmat),
        "c": lambda i: fd.decode_attention_paged(q3, *iv(i), k_t, v_t, pos, tables),
        "bf16": lambda i: fd.decode_attention_paged(qb, *bv(i), None, None, None,
                                                    None, pos, tables),
    }
    if not prefix:
        rows["int8_bf16q"] = lambda i: fd.decode_attention_paged(
            qb, *iv(i), kb_t, vb_t, pos, tables)
    return {prefix + name: fn for name, fn in rows.items()}


def time_rows(torch, fd):
    """({row: device ms a call}, {row: {kernel: device ms a call}})."""
    out, kernels = {}, {}
    for hd, h, layers, prefix in ((64, 12, 12, ""), (16, 4, 2, "d16_"),
                                  (32, 8, 2, "d32_")):
        for name, fn in rows_at(torch, fd, hd, h, layers, prefix).items():
            kernels[name] = {}
            out[name] = cs.device_ms(torch, fn, iters=120, warmup=5,
                                     by_kernel=kernels[name])
        torch.cuda.empty_cache()
    return out, kernels


CELLS = (  # name, layout, weights dtype, engine options
    ("dense_f32", "dense", "float32", {}),
    ("paged_f32", "paged", "float32", {}),
    ("paged_int8", "paged", "float32", {"cache_dtype": "int8"}),
    ("dense_bf16", "dense", "bfloat16", {}),
    ("paged_bf16", "paged", "bfloat16", {}),
)


def serve_cells(torch):
    """Tokens/s, decode step p50 and a profiled decode step of each cell."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.serve import ContinuousBatchingScheduler
    from distributeddeeplearning_tpu_torch.train.state import tree_map

    params = cs.serve_params(torch)
    out = {}
    for name, layout, dtype, kw in CELLS:
        p = params if dtype == "float32" else tree_map(lambda t: t.bfloat16(), params)
        engine = cs.serve_engine(torch, np, p, layout, (64, 72, 200, 512), 1, **kw)
        torch.cuda.synchronize()
        _, report = ContinuousBatchingScheduler(
            engine, max_new_tokens=cs.NEW_TOKENS).run(cs.serve_requests(np, layout))
        toks, pos = cs.fill_slots(np, engine, np.random.default_rng(1))
        engine.decode(toks, pos)
        wall, busy, top, _ = cs.profile_share(torch, lambda: engine.decode(toks, pos), 10)
        k4 = sum(ms for key, ms in top if "flash_decode" in key)
        out[name] = {"tokens_per_sec": report.tokens_per_sec,
                     "decode_step_p50_ms": report.decode_step_s["p50"] * 1e3,
                     "profiled_step_wall_ms": wall, "profiled_step_kernel_ms": busy,
                     "busy_share": busy / wall if busy else None, "k4_ms": k4}
        for slot in range(SLOTS):
            engine.release(slot)
        del engine
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--serve", action="store_true",
                    help="also run the serving cells (decode step p50, busy share)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import flash_decode as fd

    result = {"tag": args.tag, "root": args.root}
    result["ms"], result["kernels"] = time_rows(torch, fd)
    if args.serve:
        result["serve"] = serve_cells(torch)
    card = cs.card_line()
    result["card"] = card
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Error of the f32 flash-attention backward (and forward) against float64,
on one card.

    python3 scripts/bwd_accuracy.py [--root DIR] [--tag NAME]

For causal and full attention at S 576 to 4096 (B=4..1, H=12, D=64, q, k,
v as strided views of one qkv tensor, a random dO, the f32 forward's lse
and delta = rowsum(dO O)), prints per gradient: the kernels' (K2, K3)
largest error over the largest |gradient| of a float64 backward from the
same inputs, lse and delta; the plain f32 backward's (cuBLAS, TF32 off)
and autograd through f32 SDPA's the same way; and the kernels against the
plain version as the card tests hold them (of max(|plain|, 1)).  For the
forward: O of K1, of the plain version and of f32 SDPA over the largest
|O| of a float64 forward, and lse's largest error (K1, plain).  A single
TF32 product keeps 11 bits (errors near 1e-3 of the max), split TF32 or
f32 FMA near 1e-6, so SDPA's error tells which it computes in.
``--root``: the directory that holds the port's package (default this
checkout), so that two versions can be read in one call.  Prints one JSON
line."""

from __future__ import annotations

import argparse
import json
import os
import sys

#: (S, B, causal) of the rows
ROWS = ((576, 4, True), (2048, 2, True), (2048, 2, False), (4096, 1, True))


def row_errors(torch, fa, s, b, causal, h=12, d=64):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(s)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda")
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    o, lse = fa.flash_attention_core(q, k, v, causal=causal)
    do = torch.randn(o.shape, generator=g, device="cuda")
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal)
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    sdpa = [t.transpose(1, 2) for t in torch.autograd.grad(
        o_sdpa, (qt, kt, vt), do.transpose(1, 2))]
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    tril = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    x = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / d ** 0.5
    if causal:
        x = torch.where(tril, x, float("-inf"))
    lse64 = torch.logsumexp(x, -1)
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.exp(x - lse64[..., None]), vd)
    o_plain, lse_plain = fa._dense_attention(q, k, v, None, causal=causal)
    top = o64.abs().max().item()
    out = {"o": {"kernel_vs_f64": (o.double() - o64).abs().max().item() / top,
                 "plain_vs_f64": (o_plain.double() - o64).abs().max().item() / top,
                 "sdpa_vs_f64": (o_sdpa.detach().transpose(1, 2).double() - o64)
                 .abs().max().item() / top},
           "lse": {"kernel_vs_f64": (lse.double() - lse64).abs().max().item(),
                   "plain_vs_f64": (lse_plain.double() - lse64).abs().max().item()}}
    del x, o64, o_plain
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qd, kd) / d ** 0.5
                  - lse.double()[..., None])
    if causal:
        p = torch.where(tril, p, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd)
              - delta.double()[..., None]) / d ** 0.5
    ref = (torch.einsum("bhqk,bkhd->bqhd", ds, kd),
           torch.einsum("bhqk,bqhd->bkhd", ds, qd),
           torch.einsum("bhqk,bqhd->bkhd", p, dod))
    for name, gt, pl, sd, rf in zip(("dq", "dk", "dv"), got, plain, sdpa, ref):
        top = rf.abs().max().item()
        out[name] = {
            "kernel_vs_f64": (gt.double() - rf).abs().max().item() / top,
            "plain_vs_f64": (pl.double() - rf).abs().max().item() / top,
            "sdpa_vs_f64": (sd.double() - rf).abs().max().item() / top,
            "kernel_vs_plain": (gt - pl).abs().max().item()
            / max(pl.abs().max().item(), 1.0)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bwd_accuracy: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(args.root))
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    rows = {}
    for s, b, causal in ROWS:
        rows[f"S={s} B={b} {'causal' if causal else 'full'}"] = row_errors(
            torch, fa, s, b, causal)
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "root": args.root,
                      "card": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The accuracy argument of the f32 flash backward's split-TF32 products,
emulated on the CPU.

The f32 K2 and K3 (``csrc/flash_attention_bwd.cu``) run every product on
the tensor cores as three TF32 products: each f32 operand x is split into
hi = tf32(x) and lo = tf32(x - hi), where tf32() keeps 10 explicit mantissa
bits and rounds the 13 dropped ones to nearest, ties away from zero (as
``cvt.rna.tf32.f32`` does), and a b is summed as a_lo b_hi + a_hi b_lo +
a_hi b_hi in f32, eight terms (one m16n8k8 k-step) at a time.  Each
TF32 x TF32 product is exact in f32, so the emulation here -- the same
split and the same three f32-accumulated products per 8-deep step, in the
kernels' order -- shows before any card run that the kernels can hold the
port's f32 parity: dQ, dK and dV of one head of the LM training shape (S =
2048, D = 64, causal) stay within a tenth of ``BWD_RTOL`` (1e-4 of the
largest |gradient|, ``chip_smoke.py``) of the float64 result, while a
single TF32 product (hi only) does not hold ``BWD_RTOL`` itself.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(2)  # the suite runs six workers on eight cores

S, D = cs.TRAIN["seq_len"], cs.TRAIN["d_model"] // cs.TRAIN["num_heads"]
K_STEP = 8  # the depth of one m16n8k8 product


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero: half of the 13
    dropped bits' range added to the sign-magnitude pattern carries into
    the kept bits exactly when they are at least half, then they are
    cleared (the kernels' ``tf32_rna``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma3(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels compute it: per 8-deep step, in
    ascending order, a_lo b_hi, then a_hi b_lo, then a_hi b_hi added to an
    f32 accumulator (``terms=1``: a_hi b_hi alone, a plain TF32 product)."""
    ah, al = split(a)
    bh, bl = split(b)
    c = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], K_STEP):
        k = slice(k0, k0 + K_STEP)
        if terms == 3:
            c = c + al[:, k] @ bh[k]
            c = c + ah[:, k] @ bl[k]
        c = c + ah[:, k] @ bh[k]
    return c


def _backward(q, k, v, do, lse, delta, scale, terms):
    """dQ, dK, dV of one causal head, every product through :func:`mma3`
    and the elementwise steps in f32, as K2 and K3 take them."""
    tril = torch.ones((S, S), dtype=torch.bool).tril()
    s = mma3(q, k.T, terms)
    p = torch.where(tril, torch.exp(s * scale - lse[:, None]), 0.0)
    dp = mma3(do, v.T, terms)
    ds = p * (dp - delta[:, None]) * scale
    return mma3(ds, k, terms), mma3(ds.T, q, terms), mma3(p.T, do, terms)


def _reference(q, k, v, do, scale):
    """The forward's lse and delta = rowsum(dO O), and the backward, all in
    float64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    tril = torch.ones((S, S), dtype=torch.bool).tril()
    s = torch.where(tril, q @ k.T * scale, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[:, None])
    o = p @ v
    delta = (do * o).sum(-1)
    ds = p * (do @ v.T - delta[:, None]) * scale
    return lse, delta, (ds @ k, ds.T @ q, p.T @ do)


def test_tf32_rounds_like_cvt_rna():
    # a tie with an even last kept bit goes up (away from zero), unlike
    # round-to-even; below half goes down; the sign does not matter
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11), 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, 1.0,
                         -(1.0 + 2.0 ** -10), 0.0])
    assert torch.equal(tf32(x), want)
    # ten explicit mantissa bits: the low 13 of every result are clear
    x = torch.randn(10000)
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + lo carries ~22 bits: x - (hi + lo) is within 2^-21 of |x|
    assert ((x - (hi + lo)).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_backward_holds_a_tenth_of_the_f32_tolerance(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32))
                   for _ in range(4))
    scale = 1.0 / D ** 0.5
    lse, delta, want = _reference(q, k, v, do, scale)
    got = _backward(q, k, v, do, lse.float(), delta.float(), scale, terms=3)
    plain = _backward(q, k, v, do, lse.float(), delta.float(), scale, terms=1)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        top = w.abs().max().item()
        err = (g.double() - w).abs().max().item()
        assert err <= cs.BWD_RTOL / 10 * top, (name, err / top)
        # one TF32 product keeps ~11 bits: it misses BWD_RTOL itself
        assert (p.double() - w).abs().max().item() > cs.BWD_RTOL * top, name

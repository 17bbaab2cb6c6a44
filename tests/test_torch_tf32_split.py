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

The f32 K1 (``csrc/flash_attention_fwd.cu``) runs the same products: per
64-key tile, S = Q K^T a k-step at a time, the online softmax on the f32
scores (in base 2 without a bias, in nats with one), and P V summed in a
fresh accumulator that is added to O in f32.  Emulated in that order, O
and lse of one head of the training shape (causal) and of BERT's bias
shape (S = 512, a synthetic-text key mask, and a head whose keys are all
masked) stay within a tenth of ``K1_TOL`` of float64; a fully masked
row's lse is -1e30 ln 2 in f32, as the plain version gives it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset

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


BN = 64  # keys a streamed tile of the f32 forward
NEG_BIG = -1e30
LN2, LOG2E = 0.6931471805599453, 1.4426950408889634


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def _forward(q, k, v, scale, causal, bias=None, terms=3):
    """O and lse (nats) of one head as the f32 K1 computes them: per 64-key
    tile S = Q K^T through :func:`mma3`; without ``bias`` the max on the
    unscaled scores and P = exp2(S * scale log2 e - m) in base 2, with it
    ([S] f32, 0 or -1e30) scores S * scale + bias ln 2 in nats and P =
    exp2((x - m) log2 e); masked keys -1e30; l from the f32 P; O rescaled by
    the tile's correction, then the tile's P V through :func:`mma3` (a
    fresh accumulator) added in f32.  Tiles wholly above a row's diagonal
    change nothing here: their P is 0 and their correction 1."""
    s_len = q.shape[0]
    rows = torch.arange(s_len)[:, None]
    sl2 = _f32(scale * LOG2E)
    m = torch.full((s_len,), float("-inf"))
    l = torch.zeros(s_len)  # noqa: E741
    acc = torch.zeros_like(q)
    for k0 in range(0, s_len, BN):
        keys = torch.arange(k0, min(k0 + BN, s_len))[None, :]
        x = mma3(q, k[k0:k0 + BN].T, terms)
        if bias is not None:
            x = x * _f32(scale) + bias[k0:k0 + BN] * _f32(LN2)
        if causal:
            x = torch.where(keys <= rows, x, NEG_BIG)
        mx = x.amax(-1)
        if bias is None:
            m_new = torch.maximum(m, mx * sl2)
            corr = torch.exp2(m - m_new)
            # one fused multiply-add: the f64 product of two f32 is exact
            p = torch.exp2((x.double() * sl2 - m_new[:, None].double()).float())
        else:
            m_new = torch.maximum(m, mx)
            corr = torch.exp2((m - m_new) * _f32(LOG2E))
            p = torch.exp2((x - m_new[:, None]) * _f32(LOG2E))
        l = l * corr + p.sum(-1)  # noqa: E741
        acc = acc * corr[:, None] + mma3(p, v[k0:k0 + BN], terms)
        m = m_new
    ll = l.clamp_min(1e-30)
    lse = (m + torch.log2(ll)) * _f32(LN2) if bias is None else m + torch.log(ll)
    return acc / ll[:, None], lse


def _forward_reference(q, k, v, scale, causal, bias=None):
    """O and lse in float64 (the bias in nats: bias ln 2)."""
    q, k, v = (t.double() for t in (q, k, v))
    x = q @ k.T * scale
    if bias is not None:
        x = x + bias.double() * LN2
    if causal:
        x = torch.where(torch.ones_like(x, dtype=torch.bool).tril(), x, NEG_BIG)
    m = x.amax(-1, keepdim=True)
    p = torch.exp(x - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    return p @ v / l, (m + torch.log(l))[:, 0]


def _forward_errors(q, k, v, causal, bias=None, terms=3):
    """max |O - O64| and max |lse - lse64| of :func:`_forward`."""
    scale = 1.0 / q.shape[1] ** 0.5
    o, lse = _forward(q, k, v, scale, causal, bias, terms)
    o64, lse64 = _forward_reference(q, k, v, scale, causal, bias)
    return ((o.double() - o64).abs().max().item(),
            (lse.double() - lse64).abs().max().item())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_forward_holds_a_tenth_of_k1_tol_at_the_training_shape(seed):
    rng = np.random.default_rng(seed + 10)
    q, k, v = (torch.from_numpy(rng.normal(size=(S, D)).astype(np.float32))
               for _ in range(3))
    err_o, err_lse = _forward_errors(q, k, v, causal=True)
    assert err_o <= cs.K1_TOL / 10 and err_lse <= cs.K1_TOL / 10, (err_o, err_lse)
    # one TF32 product keeps ~11 bits: it misses K1_TOL itself
    assert max(_forward_errors(q, k, v, causal=True, terms=1)) > cs.K1_TOL


def test_split_tf32_forward_holds_a_tenth_of_k1_tol_with_the_bert_bias():
    """One head at BERT's timed shape (S = 512, D = 64, non-causal) under
    each of two key masks: a synthetic-text batch row's, and one with
    every key masked (its rows attend uniformly to all keys, and their lse
    is -1e30 ln 2 in f32, the plain version's value)."""
    s_len, d = cs.BIAS_TIMED["s"], cs.BIAS_TIMED["d"]
    mask = next(SyntheticTextDataset(length=2, seq_len=s_len, seed=42)
                .batches(2))["attention_mask"][0]
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(s_len, d)).astype(np.float32))
               for _ in range(3))
    scale = 1.0 / d ** 0.5
    for keep in (torch.from_numpy(mask).bool(), torch.zeros(s_len, dtype=torch.bool)):
        bias = torch.where(keep, 0.0, NEG_BIG).float()
        o, lse = _forward(q, k, v, scale, False, bias)
        o64, lse64 = _forward_reference(q, k, v, scale, False, bias)
        assert (o.double() - o64).abs().max().item() <= cs.K1_TOL / 10
        if keep.any():
            assert 0 < int(keep.sum()) < s_len
            assert (lse.double() - lse64).abs().max().item() <= cs.K1_TOL / 10
        else:  # every key masked: the mean of V, lse exactly -1e30 ln 2
            assert torch.equal(lse, torch.full((s_len,), _f32(NEG_BIG) * _f32(LN2)))
            assert (o64 - v.double().mean(0)).abs().max().item() < 1e-12


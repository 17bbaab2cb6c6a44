"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
elsewhere.  They import neither jax nor the JAX package, so they run on a
machine with PyTorch for CUDA and the CUDA toolkit alone:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(``--noconftest``: ``tests/conftest.py`` belongs to the JAX suite and
imports jax.)  The kernels build from ``csrc/`` at first use.

Tolerances: both sides are float32 with TF32 off; the kernels sum in
another order than cuBLAS and use natural-base online softmax, so they
differ from the plain version by rounding only — 1e-4 absolute on
outputs of magnitude ~1 leaves a margin of ~100x over the f32 error of
sums over <= 576 terms.  The backward's gradients reach ~10 at these
shapes and sum up to S terms twice (dP, then dQ/dK), so they are held to
1e-4 of their largest magnitude.

The bf16 kernels round where their plain version rounds (P and dS to bf16
as product operands, outputs to bf16 once), so the two differ by the
order of f32 sums, which can move a rounded P or dS by one bf16 ulp and
an output by one.  Each output is held against an f32 reference from the
same bf16 inputs with no bf16 rounding: the kernel's error there may be
at most twice the plain version's plus one bf16 ulp of the largest
|output|.  lse is f32 on both sides and stays within 1e-4.

The key-padding bias variants of K1-K3 are held the same way, with masks
from synthetic text lengths plus a row of length 1, a full row and a row
with every key masked (its lse, -1e30 * ln 2, equal on both sides bit for
bit); masked keys of every other row get dK = dV = 0 exactly.

Every kernel takes head dims 8, 16, 32 and 64 (the f32 K1 at 8 natively,
the other flash kernels on copies zero-padded to 16); the cases at 8, 16
and 32 run at the same tolerances.  The f32 forward (K1 on split-TF32
`mma.sync`) is held to its plain version at 1e-4 at every head dim, S in
{1, 37, 64, 130, 576, 2048}, causal and not, with and without a bias that
masks a row and a whole 64-key tile, at each of its block sizes; on
poisoned views; two launches must agree bit for bit; and at head dim 8
the wrapper makes no padding copy for it.  The f32 backward (K2 and K3 on split-TF32 `mma.sync`) is
held to the plain backward at 1e-4 of the largest |gradient| at every
head dim, S in {37, 64, 130, 576, 2048}, causal and not, with and without
a bias that masks a row and a whole 64-key tile, at both of its block
sizes; on poisoned views; and two launches must agree bit for bit.  The bf16 forward (wgmma on TMA tiles) is held at
every head dim, S in {1, 37, 64, 65, 127, 129, 576, 2048}, causal and not,
with and without a bias, at batches that make its launcher take each of
its block sizes (64, 128 and 192 query rows), and on views cut from a
longer buffer whose rows past S are NaN.  The bf16 backward (K2 and K3
on wgmma and TMA) is held the same way: every head dim, S in {37, 64,
130, 576, 2048}, causal and not, with and without a bias that masks a row
and a whole 64-key tile, each of its block sizes; on poisoned views; and
two launches must agree bit for bit.  At ViT-B/16's attention shape (S 197, 196 patches and the CLS token,
ragged against every block size; B 2 and the benchmark's 64; non-causal,
no bias) K1-K3 are held the same way in f32 and bf16, and the flash
``attention_fn``'s gradients through autograd.  The decode kernel on bf16 pages (and bf16
queries) widens every value to f32 in registers, so it is held BITWISE to
the same kernel on f32 copies of the same values, and to its plain
version at 1e-4.

Under tensor parallelism (K4(d), and K1-K3 through
``make_flash_attention(mesh)``) each rank runs the same kernels over its
6 of the serve model's 12 heads, as contiguous copies of its slice (as a
rank allocates its cache and projects its qkv): held to the plain version
at 1e-4 (bf16 by the rule above) and to the all-heads launch's rows for
those heads, bitwise for K4, whose blocks each serve one head.
"""

from __future__ import annotations

import math

import pytest
import torch

from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset
from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
from distributeddeeplearning_tpu_torch.ops import flash_decode as fd

pytestmark = pytest.mark.cuda

ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv_views(s, h=12, d=64, b=1, seed=0):
    """q, k, v as the model's qkv split makes them: strided [b, s, h, d]
    views of one [b, s, 3*h*d] tensor."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda")
    q, k, v = qkv.split(h * d, dim=-1)
    return tuple(t.reshape(b, s, h, d) for t in (q, k, v))


@pytest.mark.parametrize("s", [1, 37, 64, 128, 192, 576])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, s, causal):
    q, k, v = _qkv_views(s)
    before = fa.launches
    o, lse = fa.flash_attention_core(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    o_ref, lse_ref = fa._dense_attention(q, k, v, None, causal=causal)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o - o_ref).abs().max().item() <= ATOL
    assert (lse - lse_ref).abs().max().item() <= ATOL


def test_flash_attention_kernel_rejects_what_it_cannot_take(cuda):
    # head dims 32 and 8 (the f32 forward's own instance) run against
    # their plain versions; 40 and 24 are no head dim the kernels are built
    # for or padded to and are refused in either dtype
    for d in (32, 8):
        q, k, v = _qkv_views(16, h=2, d=d)
        before = fa.launches
        o, lse = fa.flash_attention_core(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert fa.launches == before + 1 and o.shape == q.shape
        o_ref, lse_ref = fa._dense_attention(q, k, v, None, causal=True)
        assert (o - o_ref).abs().max().item() <= ATOL
        assert (lse - lse_ref).abs().max().item() <= ATOL
    for d in (40, 24):
        q, k, v = _qkv_views(16, h=2, d=d)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_core(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention_core(q.bfloat16(), k.bfloat16(), v.bfloat16())
    q, k, v = _qkv_views(16)
    # a key-padding mask runs the bias variant; a bias of another shape,
    # dtype or device is refused
    before = (fa.launches, fa.launches_bias)
    fa.flash_attention(q, k, v, torch.ones(1, 16, dtype=torch.bool,
                                           device="cuda"), causal=True)
    assert (fa.launches, fa.launches_bias) == (before[0], before[1] + 1)
    for bad in (torch.zeros(1, 15, device="cuda"),
                torch.zeros(1, 16, device="cuda", dtype=torch.float64),
                torch.zeros(1, 16)):
        with pytest.raises(ValueError, match="key-padding bias"):
            fa.flash_attention_core(q, k, v, bias=bad)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_core(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_core(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention_core(q.bfloat16(), k, v)
    before = fa.launches_bf16
    o, _ = fa.flash_attention_core(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert o.dtype == torch.bfloat16 and fa.launches_bf16 == before + 1
    # a bf16 row stride of 4 elements is 8 bytes: cp.async needs 16
    odd = torch.zeros((1, 16, 12 * 64 + 4), dtype=torch.bfloat16, device="cuda")
    view = odd[..., :768].reshape(1, 16, 12, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention_core(view, view, view)


@pytest.mark.parametrize("s", [1, 37, 64, 128, 576])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_kernels_match_plain(cuda, s, causal):
    """K2 (dQ) and K3 (dK, dV) against the plain backward on strided qkv
    views at B=2, H=12, D=64, with the forward's own lse and a random dO;
    each kernel launches once."""
    q, k, v = _qkv_views(s, b=2, seed=s)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal)
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(7), device="cuda")
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    before = (fa.launches_dq, fa.launches_dkv)
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    want = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(), 1.0)


def test_gradients_through_the_function_match_dense_autograd(cuda):
    """torch.autograd.grad through flash_attention (K1 + K2/K3) == autograd
    through the plain dense attention, on views of one qkv leaf."""
    b, s, h, d = 2, 200, 12, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda",
                      requires_grad=True)

    def loss(attn):
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        return (attn(q, k, v) ** 2).sum()

    before = fa.launches_dq
    (g_flash,) = torch.autograd.grad(
        loss(lambda q, k, v: fa.flash_attention(q, k, v, None, causal=True)), qkv)
    assert fa.launches_dq == before + 1
    (g_dense,) = torch.autograd.grad(
        loss(lambda q, k, v: fa._dense_attention(q, k, v, None, causal=True)[0]),
        qkv)
    assert (g_flash - g_dense).abs().max().item() <= 1e-4 * g_dense.abs().max().item()


def _bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest |x| (8 significant bits)."""
    top = x.abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _hold_bf16(got, plain, ref, what):
    """``got`` (kernel, bf16) within twice the plain version's error
    against the f32 ``ref`` plus one bf16 ulp of max |ref|."""
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all(), what
    err = (got.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    assert err <= 2 * plain_err + _bf16_ulp(ref), (what, err, plain_err)


def _bf16_qkv(s, b=2, h=12, d=64, seed=0):
    """bf16 q, k, v as strided [b, s, h, d] views of one [b, s, 3*h*d]
    bf16 tensor (row stride 3*768 elements), as the model makes them."""
    q, k, v = _qkv_views(s, h=h, d=d, b=b, seed=seed)
    qkv = torch.cat([q, k, v], dim=2).reshape(b, s, 3 * h * d).bfloat16()
    q, k, v = qkv.split(h * d, dim=-1)
    return tuple(t.reshape(b, s, h, d) for t in (q, k, v))


@pytest.mark.parametrize("s", [37, 64, 576, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_kernels_match_plain(cuda, s, causal):
    """bf16 K2 (dQ) and K3 (dK, dV) on strided views with the bf16
    forward's lse and a random bf16 dO, against the bf16 plain backward
    and the f32 backward from the same inputs and lse."""
    q, k, v = _bf16_qkv(s, seed=s + 1)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal)
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(7), device="cuda").bfloat16()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    before = (fa.launches_dq, fa.launches_dkv, fa.launches_dq_bf16,
              fa.launches_dkv_bf16)
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv, fa.launches_dq_bf16,
            fa.launches_dkv_bf16) == (before[0], before[1], before[2] + 1,
                                      before[3] + 1)
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    ref = fa._dense_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                  lse, delta, causal=causal)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        _hold_bf16(g, p, r, name)


def test_bf16_gradients_through_the_function(cuda):
    """autograd through flash_attention on a bf16 qkv leaf runs the bf16
    K1, K2, K3 once each and returns a bf16 gradient held like the
    kernels' outputs against autograd through the f32 plain attention."""
    b, s, h, d = 2, 200, 12, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").bfloat16()

    def grad(attn, dtype):
        leaf = base.to(dtype).requires_grad_(True)
        q, k, v = (t.reshape(b, s, h, d) for t in leaf.split(h * d, dim=-1))
        (out,) = torch.autograd.grad((attn(q, k, v).float() ** 2).sum(), leaf)
        return out

    before = (fa.launches_bf16, fa.launches_dq_bf16, fa.launches_dkv_bf16)
    got = grad(lambda q, k, v: fa.flash_attention(q, k, v, None, causal=True),
               torch.bfloat16)
    assert (fa.launches_bf16, fa.launches_dq_bf16, fa.launches_dkv_bf16) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    plain = grad(lambda q, k, v: fa._dense_attention(q, k, v, None, causal=True)[0],
                 torch.bfloat16)
    ref = grad(lambda q, k, v: fa._dense_attention(q, k, v, None, causal=True)[0],
               torch.float32)
    _hold_bf16(got, plain, ref, "dqkv")


# ---- bf16 K1 on wgmma and TMA: every shape, every block choice ------------

#: sequence lengths of the bf16 forward's card tests: one row, ragged
#: tiles, both sides of the 64-row and 128-key tile edges, a serving prompt
#: and the training length
BF16_K1_S = [1, 37, 64, 65, 127, 129, 576, 2048]


def _expected_block_rows(b, h, s):
    """The launcher's rule, restated: 192-row blocks when the grid gives
    every SM four, 128 when it gives every SM one, else 64."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if b * h * -(-s // 192) >= 4 * sms:
        return 192
    return 128 if b * h * -(-s // 128) >= sms else 64


def _batch_for_rows(rows, h, s, rule=None):
    """The smallest batch (from 2) at which the launcher takes ``rows``-row
    blocks for (h, s) on this card (``rule``: the forward's by default)."""
    rule = rule or fa.bf16_block_rows
    for b in range(2, 4096):
        if rule(b, h, s) == rows:
            return b
    pytest.fail(f"no batch gives {rows}-row blocks at h={h} s={s}")


def _keep_with_dead_row(b, s, seed):
    """[b, s] bool key mask: random keys kept, the last row fully masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    keep = torch.rand((b, s), generator=g, device="cuda") < 0.7
    keep[0, 0] = True
    keep[-1] = False
    return keep


def test_bf16_forward_block_rows_follow_the_rule(cuda):
    """The launcher's block-row choice at the main path's shapes (the LM
    training step, BERT at seq 512 and 128, bf16 serving prefill, the
    default geometries' head dims 16 and 32) and at the edges of each
    choice, against the rule restated here."""
    shapes = [(8, 12, 2048), (8, 12, 512), (8, 12, 128), (1, 12, 512),
              (4, 4, 512), (8, 8, 128), (1, 1, 1), (2, 4, 2048), (12, 4, 2048)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes += [(sms, 1, 128), (sms - 1, 1, 128), (4 * sms, 1, 192),
               (4 * sms - 1, 1, 192)]
    for b, h, s in shapes:
        assert fa.bf16_block_rows(b, h, s) == _expected_block_rows(b, h, s), (b, h, s)
    assert {fa.bf16_block_rows(b, h, s) for b, h, s in shapes} == {64, 128, 192}


@pytest.mark.parametrize("rows", [64, 128, 192])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", BF16_K1_S)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bf16_forward_kernel_matches_plain(cuda, d, s, causal, bias, rows):
    """bf16 K1 against its plain version and the f32 reference at every
    head dim and S, causal and not, with and without a key-padding bias
    that masks one row fully, at a batch that makes the launcher take
    ``rows``-row blocks (64: one consumer warpgroup; 128 and 192: two and
    three sharing each K/V tile); one launch through the right counter."""
    h = 2 if rows == 64 else 4
    b = _batch_for_rows(rows, h, s)
    q, k, v = _bf16_qkv(s, b=b, h=h, d=d, seed=s + d + rows)
    bias_t = None
    if bias:
        bias_t = fa._mask_bias(_keep_with_dead_row(b, s, s + d)[:, None, None, :], b, s)
    names = ("launches_bf16", "launches_bias_bf16", "launches", "launches_bias")
    before = [getattr(fa, n) for n in names]
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == (
        [0, 1, 0, 0] if bias else [1, 0, 0, 0])
    o_plain, lse_plain = fa._dense_attention(q, k, v, bias_t, causal=causal)
    o_ref, _ = fa._dense_attention(q.float(), k.float(), v.float(), bias_t,
                                   causal=causal)
    _hold_bf16(o, o_plain, o_ref, "o")
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all()
    assert (lse - lse_plain).abs().max().item() <= ATOL
    if bias:  # the fully masked row: -1e30 * ln 2, as the plain version
        assert torch.equal(lse[-1], lse_plain[-1]) and (lse[-1] < -6e29).all()


@pytest.mark.parametrize("rows", [64, 192])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bf16_forward_reads_only_its_views(cuda, d, causal, bias, rows):
    """q, k, v cut from a longer buffer [B, S + 40, 3*H*D] (so the batch
    stride is not S times the row stride) whose rows past S are NaN: the
    tensor maps span the views exactly, so the output is finite and equal,
    bit for bit, to the output on the same buffer with those rows zero,
    and it holds to the plain version."""
    s, h = 200, 4
    b = _batch_for_rows(rows, h, s)
    g = torch.Generator(device="cuda").manual_seed(d + rows)
    buf = torch.randn((b, s + 40, 3 * h * d), generator=g, device="cuda").bfloat16()
    bias_t = None
    if bias:
        bias_t = fa._mask_bias(_keep_with_dead_row(b, s, d)[:, None, None, :], b, s)

    def views(t):
        return tuple(x.reshape(b, s, h, d) for x in t[:, :s].split(h * d, dim=-1))

    clean, poisoned = buf.clone(), buf.clone()
    clean[:, s:] = 0
    poisoned[:, s:] = float("nan")
    q, k, v = views(poisoned)
    assert q.stride(0) != s * q.stride(1)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    qc, kc, vc = views(clean)
    o_c, lse_c = fa.flash_attention_core(qc, kc, vc, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert torch.equal(o, o_c) and torch.equal(lse, lse_c)
    o_plain, lse_plain = fa._dense_attention(qc, kc, vc, bias_t, causal=causal)
    o_ref, _ = fa._dense_attention(qc.float(), kc.float(), vc.float(), bias_t,
                                   causal=causal)
    _hold_bf16(o, o_plain, o_ref, "o")
    assert (lse - lse_plain).abs().max().item() <= ATOL


# ---- bf16 K2/K3 on wgmma and TMA: every shape, every block choice ---------

#: sequence lengths of the bf16 backward's card tests: ragged tiles, S not
#: a multiple of 4 (the 1-D lse, delta and bias windows), both sides of the
#: 64- and 128-row edges, a serving prompt and the training length
BF16_BWD_S = [37, 64, 130, 576, 2048]


def _bwd_keep(b, s, seed):
    """[b, s] bool key mask: right padding of random lengths (key 0 always
    kept), the keys of the second 64-key tile masked in every row (a whole
    masked tile), and the last row fully masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    keep = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    keep[:, 64:128] = False
    keep[:, 0] = True
    keep[-1] = False
    return keep


def _bwd_inputs(b, s, h, d, causal, bias, seed):
    """bf16 strided q, k, v, the bf16 forward's o and lse, a random bf16 dO,
    delta and (with ``bias``) the key-padding bias of :func:`_bwd_keep`."""
    q, k, v = _bf16_qkv(s, b=b, h=h, d=d, seed=seed)
    keep = bias_t = None
    if bias:
        keep = _bwd_keep(b, s, seed)
        bias_t = fa._mask_bias(keep[:, None, None, :], b, s)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(seed + 1), device="cuda").bfloat16()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, bias_t, keep


def _dq_rows(b, h, s):
    return fa.bf16_bwd_block_rows("dq", b, h, s)


def test_bf16_backward_block_rows_follow_the_rule(cuda):
    """The backward launcher's block-row choice at the main path's shapes
    and at the edges of each choice, against the rule restated here: the
    dQ pass takes the forward's, the dK/dV pass the same but never 192
    (three consumer warpgroups cap a thread at 128 registers, and the
    dK/dV pass spills there at head dim 64)."""
    shapes = [(8, 12, 2048), (8, 12, 512), (8, 12, 128), (4, 4, 512),
              (8, 8, 128), (1, 1, 1), (2, 4, 2048), (12, 4, 2048)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes += [(sms, 1, 128), (sms - 1, 1, 128), (4 * sms, 1, 192),
               (4 * sms - 1, 1, 192)]
    for b, h, s in shapes:
        want = _expected_block_rows(b, h, s)
        assert _dq_rows(b, h, s) == want, (b, h, s)
        assert fa.bf16_bwd_block_rows("dkv", b, h, s) == min(want, 128), (b, h, s)
    assert {_dq_rows(b, h, s) for b, h, s in shapes} == {64, 128, 192}


@pytest.mark.parametrize("rows", [64, 128, 192])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", BF16_BWD_S)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bf16_backward_wgmma_kernels_match_plain(cuda, d, s, causal, bias, rows):
    """bf16 K2 and K3 against the bf16 plain backward and the f32 backward
    of the same inputs (hold_bf16's limit) at every head dim and S, causal
    and not, with and without a key-padding bias (a fully masked row and a
    fully masked 64-key tile), at a batch that makes the launcher take
    ``rows``-row blocks in the dQ pass (and with them 64-, 128- and 128-row
    blocks in the dK/dV pass); one launch each through the right counter;
    masked keys of every row that sees a key get dK = dV = 0 exactly."""
    h = 2 if rows == 64 else 4
    b = _batch_for_rows(rows, h, s, _dq_rows)
    q, k, v, do, lse, delta, bias_t, keep = _bwd_inputs(
        b, s, h, d, causal, bias, seed=s + d + rows)
    names = ("launches_dq_bf16", "launches_dkv_bf16", "launches_dq_bias_bf16",
             "launches_dkv_bias_bf16", "launches_dq", "launches_dkv")
    before = [getattr(fa, n) for n in names]
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == (
        [0, 0, 1, 1, 0, 0] if bias else [1, 1, 0, 0, 0, 0])
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                    bias=bias_t)
    ref = fa._dense_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                  lse, delta, causal=causal, bias=bias_t)
    for name, gt, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        _hold_bf16(gt, p, r, name)
    if bias:
        masked = ~keep
        masked[-1] = False
        assert (got[1][masked] == 0).all() and (got[2][masked] == 0).all()


@pytest.mark.parametrize("rows", [64, 192])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bf16_backward_reads_only_its_views(cuda, d, causal, bias, rows):
    """q, k, v and dO cut from longer buffers [B, S + 40, 3*H*D] and
    [B, S + 40, H*D] (so the batch stride is not S times the row stride)
    whose rows past S are NaN: dQ, dK and dV are finite and equal, bit for
    bit, to the gradients on the same buffers with those rows zero, and
    they hold to the plain backward."""
    s, h = 130, 4
    b = _batch_for_rows(rows, h, s, _dq_rows)
    g = torch.Generator(device="cuda").manual_seed(d + rows)
    buf = torch.randn((b, s + 40, 3 * h * d), generator=g, device="cuda").bfloat16()
    dbuf = torch.randn((b, s + 40, h * d), generator=g, device="cuda").bfloat16()
    bias_t = None
    if bias:
        bias_t = fa._mask_bias(_bwd_keep(b, s, d)[:, None, None, :], b, s)

    def views(t, u):
        q, k, v = (x.reshape(b, s, h, d) for x in t[:, :s].split(h * d, dim=-1))
        return q, k, v, u[:, :s].reshape(b, s, h, d)

    grads = []
    for fill in (0.0, float("nan")):
        t, u = buf.clone(), dbuf.clone()
        t[:, s:] = fill
        u[:, s:] = fill
        q, k, v, do = views(t, u)
        assert q.stride(0) != s * q.stride(1) and do.stride(0) != s * do.stride(1)
        o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        grads.append(fa._launch_bwd(q, k, v, do, lse, delta, causal=causal,
                                    bias=bias_t))
    torch.cuda.synchronize()
    for clean, poisoned in zip(*grads):
        assert torch.isfinite(poisoned).all() and torch.equal(clean, poisoned)
    q, k, v, do = views(buf, dbuf)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                    bias=bias_t)
    ref = fa._dense_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                  lse, delta, causal=causal, bias=bias_t)
    for name, gt, p, r in zip(("dq", "dk", "dv"), grads[0], plain, ref):
        _hold_bf16(gt, p, r, name)


@pytest.mark.parametrize("rows", [64, 128, 192])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_is_bitwise_repeatable(cuda, causal, bias, rows):
    """Two launches of each pass on the same inputs give bitwise equal dQ,
    dK and dV: every output element has one owner, which sums its tiles in
    a fixed order (no atomics)."""
    s, h, d = 576, 4, 64
    b = _batch_for_rows(rows, h, s, _dq_rows)
    q, k, v, do, lse, delta, bias_t, _ = _bwd_inputs(b, s, h, d, causal, bias,
                                                     seed=rows)
    first = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias_t)
    second = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


# ---- f32 K2/K3 on split TF32: every shape, head dim and block choice -----

#: head dims of the f32 backward's card tests: the kernels' three and 8,
#: which runs them at 16 on zero-padded copies
F32_BWD_D = [8, 16, 32, 64]
#: the f32 backward's tolerance: of the largest |plain gradient| (at least
#: 1), as chip_smoke.py's BWD_RTOL
F32_BWD_RTOL = 1e-4


def _f32_rows(kind):
    return lambda b, h, s: fa.f32_bwd_block_rows(kind, b, h, s)


def _f32_bwd_inputs(b, s, h, d, causal, bias, seed):
    """f32 strided q, k, v, the f32 forward's o and lse, a random dO,
    delta and (with ``bias``) the key-padding bias of :func:`_bwd_keep`."""
    q, k, v = _qkv_views(s, h=h, d=d, b=b, seed=seed)
    keep = bias_t = None
    if bias:
        keep = _bwd_keep(b, s, seed)
        bias_t = fa._mask_bias(keep[:, None, None, :], b, s)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(seed + 1), device="cuda")
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, bias_t, keep


def _hold_f32(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), (what, name)
        err = (g - w).abs().max().item()
        assert err <= F32_BWD_RTOL * max(w.abs().max().item(), 1.0), (what, name, err)


def test_f32_backward_block_rows_follow_the_rule(cuda):
    """The f32 backward launcher's block-row choice, per pass, at the main
    path's shapes and at the edges, against the rule restated here: 128
    owned rows when the grid at 128 covers at least half the SMs, else
    64."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    half = -(-sms // 2)
    shapes = [(8, 12, 2048), (8, 12, 512), (8, 12, 128), (4, 4, 512),
              (8, 8, 128), (4, 4, 64), (1, 1, 1), (half, 1, 128),
              (half - 1, 1, 128), (1, half, 1), (1, 1, 128 * (half - 1))]
    for b, h, s in shapes:
        want = 128 if 2 * b * h * -(-s // 128) >= sms else 64
        for kind in ("dq", "dkv"):
            assert fa.f32_bwd_block_rows(kind, b, h, s) == want, (kind, b, h, s)
    assert {fa.f32_bwd_block_rows("dq", *x) for x in shapes} == {64, 128}


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", BF16_BWD_S)
@pytest.mark.parametrize("d", F32_BWD_D)
def test_f32_backward_tf32_kernels_match_plain(cuda, d, s, causal, bias, rows):
    """f32 K2 and K3 (split TF32 on mma.sync) against the plain backward at
    every head dim and S, causal and not, with and without a key-padding
    bias (a fully masked row and a fully masked 64-key tile), at a batch
    that makes the launcher take ``rows``-row blocks in both passes; one
    launch each through the right counter; masked keys of every row that
    sees a key get dK = dV = 0 exactly."""
    h = 1 if rows == 64 else 4
    b = _batch_for_rows(rows, h, s, _f32_rows("dq"))
    assert fa.f32_bwd_block_rows("dkv", b, h, s) == rows
    q, k, v, do, lse, delta, bias_t, keep = _f32_bwd_inputs(
        b, s, h, d, causal, bias, seed=s + d + rows)
    names = ("launches_dq", "launches_dkv", "launches_dq_bias",
             "launches_dkv_bias", "launches_dq_bf16", "launches_dkv_bf16")
    before = [getattr(fa, n) for n in names]
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == (
        [0, 0, 1, 1, 0, 0] if bias else [1, 1, 0, 0, 0, 0])
    assert all(g.shape == q.shape and g.is_contiguous() for g in got)
    want = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                   bias=bias_t)
    _hold_f32(got, want, (d, s, causal, bias, rows))
    if bias:
        masked = ~keep
        masked[-1] = False
        assert (got[1][masked] == 0).all() and (got[2][masked] == 0).all()


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", F32_BWD_D)
def test_f32_backward_reads_only_its_views(cuda, d, causal, bias, rows):
    """f32 q, k, v and dO cut from longer buffers [B, S + 40, 3*H*D] and
    [B, S + 40, H*D] whose rows past S are NaN: dQ, dK and dV are finite
    and equal, bit for bit, to the gradients on the same buffers with those
    rows zero, and they hold to the plain backward."""
    s, h = 130, 4
    b = _batch_for_rows(rows, h, s, _f32_rows("dq"))
    g = torch.Generator(device="cuda").manual_seed(d + rows)
    buf = torch.randn((b, s + 40, 3 * h * d), generator=g, device="cuda")
    dbuf = torch.randn((b, s + 40, h * d), generator=g, device="cuda")
    bias_t = None
    if bias:
        bias_t = fa._mask_bias(_bwd_keep(b, s, d)[:, None, None, :], b, s)

    def views(t, u):
        q, k, v = (x.reshape(b, s, h, d) for x in t[:, :s].split(h * d, dim=-1))
        return q, k, v, u[:, :s].reshape(b, s, h, d)

    grads = []
    for fill in (0.0, float("nan")):
        t, u = buf.clone(), dbuf.clone()
        t[:, s:] = fill
        u[:, s:] = fill
        q, k, v, do = views(t, u)
        assert q.stride(0) != s * q.stride(1) and do.stride(0) != s * do.stride(1)
        o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        grads.append(fa._launch_bwd(q, k, v, do, lse, delta, causal=causal,
                                    bias=bias_t))
    torch.cuda.synchronize()
    for clean, poisoned in zip(*grads):
        assert torch.isfinite(poisoned).all() and torch.equal(clean, poisoned)
    q, k, v, do = views(buf, dbuf)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    want = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                   bias=bias_t)
    _hold_f32(grads[0], want, (d, causal, bias, rows))


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_backward_is_bitwise_repeatable(cuda, causal, bias, rows):
    """Two launches of each f32 pass on the same inputs give bitwise equal
    dQ, dK and dV: one owner per output element, a fixed order, no
    atomics."""
    s, h, d = 576, 4, 64
    b = _batch_for_rows(rows, h, s, _f32_rows("dq"))
    q, k, v, do, lse, delta, bias_t, _ = _f32_bwd_inputs(b, s, h, d, causal,
                                                         bias, seed=rows)
    first = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias_t)
    second = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


# ---- f32 K1 on split TF32: every head dim, shape and block choice ---------

#: sequence lengths of the f32 forward's card tests: one row, ragged tiles
#: (37, 130: S not a multiple of 4 either), one whole 64-key tile, a
#: serving prompt and the training length
F32_K1_S = [1, 37, 64, 130, 576, 2048]
#: (S, block rows) of those tests: every block size the launcher takes at
#: each S (128 only above 64)
F32_K1_CASES = [(s, rows) for s in F32_K1_S for rows in (64, 128)
                if rows == 64 or s > 64]


def test_f32_forward_block_rows_follow_the_rule(cuda):
    """The f32 forward launcher's block-row choice at the main path's
    shapes (the LM training step, BERT at seq 512 and 128, serving
    prefill, the default geometries' head dims 8, 16 and 32) and at the
    edges, against the rule restated here: 128 query rows when S > 64 and
    the grid at 128 covers at least half the SMs, else 64."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    half = -(-sms // 2)
    shapes = [(8, 12, 2048), (8, 12, 512), (8, 12, 128), (1, 12, 512),
              (4, 4, 64), (4, 4, 512), (8, 8, 128), (1, 1, 1),
              (half, 1, 128), (half - 1, 1, 128), (half, 1, 64),
              (half, 1, 65), (1, 1, 128 * half), (1, 1, 128 * (half - 1))]
    for b, h, s in shapes:
        want = 128 if s > 64 and 2 * b * h * -(-s // 128) >= sms else 64
        assert fa.f32_block_rows(b, h, s) == want, (b, h, s)
    assert {fa.f32_block_rows(*x) for x in shapes} == {64, 128}


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,rows", F32_K1_CASES)
@pytest.mark.parametrize("d", F32_BWD_D)
def test_f32_forward_tf32_kernel_matches_plain(cuda, d, s, rows, causal, bias):
    """f32 K1 (split TF32 on mma.sync) against its plain version at every
    head dim (8 natively) and S, causal and not, with and without a
    key-padding bias (a fully masked row, whose lse is the plain version's
    bit for bit, and a fully masked 64-key tile), at a batch that makes the
    launcher take ``rows``-row blocks; one launch through the right
    counter."""
    h = 4 if rows == 128 else 1
    b = _batch_for_rows(rows, h, s, fa.f32_block_rows)
    q, k, v = _qkv_views(s, h=h, d=d, b=b, seed=s + d + rows)
    keep = bias_t = None
    if bias:
        keep = _bwd_keep(b, s, s + d)
        bias_t = fa._mask_bias(keep[:, None, None, :], b, s)
    names = ("launches", "launches_bias", "launches_bf16", "launches_bias_bf16")
    before = [getattr(fa, n) for n in names]
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == (
        [0, 1, 0, 0] if bias else [1, 0, 0, 0])
    assert o.shape == q.shape and o.is_contiguous() and lse.shape == (b, h, s)
    o_plain, lse_plain = fa._dense_attention(q, k, v, bias_t, causal=causal)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o - o_plain).abs().max().item() <= ATOL
    assert (lse - lse_plain).abs().max().item() <= ATOL
    if bias:  # the fully masked row: -1e30 * ln 2, as the plain version
        assert torch.equal(lse[-1], lse_plain[-1]) and (lse[-1] < -6e29).all()


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", F32_BWD_D)
def test_f32_forward_reads_only_its_views(cuda, d, causal, bias, rows):
    """f32 q, k, v cut from a longer buffer [B, S + 40, 3*H*D] (so the
    batch stride is not S times the row stride) whose rows past S are NaN:
    the output is finite and equal, bit for bit, to the output on the same
    buffer with those rows zero, and it holds to the plain version."""
    s, h = 130, 4 if rows == 128 else 1
    b = _batch_for_rows(rows, h, s, fa.f32_block_rows)
    g = torch.Generator(device="cuda").manual_seed(d + rows)
    buf = torch.randn((b, s + 40, 3 * h * d), generator=g, device="cuda")
    bias_t = None
    if bias:
        bias_t = fa._mask_bias(_bwd_keep(b, s, d)[:, None, None, :], b, s)

    def views(t):
        return tuple(x.reshape(b, s, h, d) for x in t[:, :s].split(h * d, dim=-1))

    outs = []
    for fill in (0.0, float("nan")):
        t = buf.clone()
        t[:, s:] = fill
        q, k, v = views(t)
        assert q.stride(0) != s * q.stride(1)
        outs.append(fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t))
    torch.cuda.synchronize()
    for clean, poisoned in zip(*outs):
        assert torch.isfinite(poisoned).all() and torch.equal(clean, poisoned)
    q, k, v = views(buf)
    o_plain, lse_plain = fa._dense_attention(q, k, v, bias_t, causal=causal)
    assert (outs[0][0] - o_plain).abs().max().item() <= ATOL
    assert (outs[0][1] - lse_plain).abs().max().item() <= ATOL


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_forward_is_bitwise_repeatable(cuda, causal, bias, rows):
    """Two launches of the f32 forward on the same inputs give bitwise
    equal O and lse: one owner warp per query row, a fixed order, no
    atomics."""
    s, d = 576, 64
    h = 4 if rows == 128 else 1
    b = _batch_for_rows(rows, h, s, fa.f32_block_rows)
    q, k, v = _qkv_views(s, h=h, d=d, b=b, seed=rows)
    bias_t = None
    if bias:
        bias_t = fa._mask_bias(_bwd_keep(b, s, rows)[:, None, None, :], b, s)
    first = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    second = fa.flash_attention_core(q, k, v, causal=causal, bias=bias_t)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_f32_forward_takes_head_dim_8_without_padding_copies(cuda, monkeypatch):
    """At head dim 8 the f32 forward runs its own instance on the views
    themselves: the wrapper makes no zero-padded copy (the f32 backward
    and the bf16 forward still pad each operand to 16)."""
    copies = []
    pad = fa.pad_head_dim

    def counting_pad(t):
        out = pad(t)
        if out is not t:
            copies.append(tuple(out.shape))
        return out

    monkeypatch.setattr(fa, "pad_head_dim", counting_pad)
    b, s, h, d = 2, 130, 4, 8
    q, k, v = _qkv_views(s, h=h, d=d, b=b, seed=8)
    o, lse = fa.flash_attention_core(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert copies == [] and o.shape == (b, s, h, d)
    o_plain, lse_plain = fa._dense_attention(q, k, v, None, causal=True)
    assert (o - o_plain).abs().max().item() <= ATOL
    assert (lse - lse_plain).abs().max().item() <= ATOL
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(9), device="cuda")
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    fa._launch_bwd(q, k, v, do, lse, delta, causal=True)
    assert copies == [(b, s, h, 16)] * 8  # q, k, v, dO for each pass
    copies.clear()
    fa.flash_attention_core(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    assert copies == [(b, s, h, 16)] * 3


def test_flash_decode_kernel_on_strided_cache_view(cuda):
    """K4(a) at the serve shapes on the strided layer view of a real
    [slots, L, S, h, hd] cache, unequal positions including 0 and S-1, and
    NaN planted past each slot's position (stale history stays masked)."""
    slots, layers, s, h, hd = 8, 3, 576, 12, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    cache_k = torch.randn((slots, layers, s, h, hd), generator=g, device="cuda")
    cache_v = torch.randn((slots, layers, s, h, hd), generator=g, device="cuda")
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450],
                       dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos.tolist()):
        if p + 1 < s:
            cache_k[b, :, p + 1] = float("nan")
    k_l, v_l = cache_k[:, 1], cache_v[:, 1]
    assert not k_l.is_contiguous()
    q3 = torch.randn((slots, h, hd), generator=g, device="cuda")
    before = fd.launches
    out = fd.decode_attention_dense(q3, k_l, v_l, None, None, None, None, pos)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    ref = fd._gather_decode_dense(q3, k_l, v_l, None, None, None, None, pos)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATOL


def test_flash_decode_kernel_nan_history_is_nonfinite(cuda):
    """A NaN key at a visible position makes that slot's output NaN (the
    quarantine signal) and leaves the other slots finite."""
    slots, s, h, hd = 2, 40, 12, 64
    k = torch.randn((slots, s, h, hd), device="cuda")
    v = torch.randn((slots, s, h, hd), device="cuda")
    k[0, 5] = float("nan")
    pos = torch.tensor([10, 10], dtype=torch.int32, device="cuda")
    q3 = torch.randn((slots, h, hd), device="cuda")
    out = fd.decode_attention_dense(q3, k, v, None, None, None, None, pos)
    assert not torch.isfinite(out[0]).any()
    assert torch.isfinite(out[1]).all()


def test_paged_kernel_with_multi_query_posmat(cuda):
    """The kernel's full contract: several pages per slot through a
    shuffled block table and nq > 1 queries with their own positions."""
    b, nq, h, hd, ps, nb = 3, 4, 12, 64, 16, 5
    pool = b * nb + 1
    kp = torch.randn((pool, ps, h, hd), device="cuda")
    vp = torch.randn((pool, ps, h, hd), device="cuda")
    perm = torch.randperm(pool - 1)[: b * nb] + 1
    tables = perm.reshape(b, nb).to(torch.int32).cuda()
    posmat = torch.tensor([[0, 5, 16, 79], [3, 3, 40, 41], [15, 16, 17, 60]],
                          dtype=torch.int32, device="cuda")
    q4 = torch.randn((b, nq, h, hd), device="cuda")
    out = fd.paged_attention(q4, kp, vp, tables, posmat)
    ref = fd._paged_attention_plain(q4, kp, vp, tables, posmat)
    assert (out - ref).abs().max().item() <= ATOL


def _pool(layers, pages, ps, h, hd, dtype, seed):
    """A [pages + 1, L, ps, h, hd] K/V pool of random values in ``dtype``
    (int8: through the port's quantize_kv, as {"k", "v", "k_scale",
    "v_scale"})."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = {}
    for name in ("k", "v"):
        x = torch.randn((pages + 1, layers, ps, h, hd), generator=g, device="cuda")
        if dtype == torch.int8:
            pool[name], pool[f"{name}_scale"] = quantize_kv(x)
        else:
            pool[name] = x.to(dtype)
    return pool


def _scrambled_tables(b, nb, pages, seed=0):
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(pages, generator=g)[: b * nb] + 1  # never page 0
    return perm.reshape(b, nb).to(torch.int32).cuda()


@pytest.mark.parametrize("offset", [0, 37, 512])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_chunk_kernel_on_strided_scrambled_pool(cuda, offset, int8):
    """K4(b) (and K4(c) without overlay): b=1, nq=64 chunk queries at
    ``offset + arange(64)`` over a scrambled table, read through the
    strided layer view of a [73, L, 64, 12, 64] pool."""
    layers, pages, ps, h, hd, C = 2, 72, 64, 12, 64, 64
    if int8:
        cache = _pool(layers, pages, ps, 12, 64, torch.int8, seed=offset)
    else:
        g = torch.Generator(device="cuda").manual_seed(offset)
        cache = {n: torch.randn((pages + 1, layers, ps, h, hd), generator=g,
                                device="cuda") for n in ("k", "v")}
    views = {n: t[:, 1] for n, t in cache.items()}
    assert not views["k"].is_contiguous()
    table = _scrambled_tables(1, 9, pages, seed=offset)[0]
    q = torch.randn((C, 3, h, hd), device="cuda")[:, 0]  # strided like qkv
    posns = offset + torch.arange(C, device="cuda")
    before = (fd.launches, fd.launches_int8, fd.launches_multi_query)
    out = fd.chunk_attention(q, views["k"], views["v"], views.get("k_scale"),
                             views.get("v_scale"), table, posns)
    torch.cuda.synchronize()
    assert (fd.launches, fd.launches_int8, fd.launches_multi_query) == (
        before[0] + 1, before[1] + int8, before[2] + 1)
    ref = fd._gather_chunk(q, views["k"], views["v"], views.get("k_scale"),
                           views.get("v_scale"), table, posns)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATOL


def test_int8_decode_kernel_with_overlay(cuda):
    """K4(c) decode: b=8, nq=1 over scrambled int8 pages with the exact
    in-flight K/V overlaid at each slot's position, positions 0..575."""
    layers, pages, h, hd = 2, 72, 12, 64
    cache = _pool(layers, pages, 64, 12, 64, torch.int8, seed=3)
    views = [t[:, 0] for t in (cache["k"], cache["v"], cache["k_scale"],
                               cache["v_scale"])]
    tables = _scrambled_tables(8, 9, pages, seed=3)
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    qkv = torch.randn((8, 3, h, hd), device="cuda")
    q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    before = fd.launches_int8
    out = fd.decode_attention_paged(q3, *views, k_t, v_t, pos, tables)
    torch.cuda.synchronize()
    assert fd.launches_int8 == before + 1
    ref = fd._gather_decode_paged(q3, *views, k_t, v_t, pos, tables)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATOL
    # the overlay really is read: another own token changes the output
    other = fd.decode_attention_paged(q3, *views, k_t + 1.0, v_t.contiguous(),
                                      pos, tables)
    assert (other - out).abs().max().item() > 1e-3


def test_int8_nan_scale_is_confined_to_its_slot(cuda):
    layers, pages, h, hd = 1, 18, 12, 64
    cache = _pool(layers, pages, 64, 12, 64, torch.int8, seed=4)
    tables = _scrambled_tables(2, 9, pages, seed=4)
    cache["k_scale"][tables[0, 2].item(), 0, 5, 3] = float("nan")
    views = [t[:, 0] for t in (cache["k"], cache["v"], cache["k_scale"],
                               cache["v_scale"])]
    pos = torch.tensor([300, 300], dtype=torch.int32, device="cuda")
    q3, k_t, v_t = torch.randn((3, 2, h, hd), device="cuda").unbind(0)
    out = fd.decode_attention_paged(q3, *views, k_t, v_t, pos, tables)
    assert torch.isnan(out[0, 3]).all()
    assert torch.isfinite(out[1]).all()
    assert torch.isfinite(out[0, :3]).all() and torch.isfinite(out[0, 4:]).all()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_decode_equals_dense_decode_bitwise(cuda, int8):
    """The kernel's sums run in an order set by the absolute position
    alone, so the same K/V read as 64-position pages through a scrambled
    table and as one dense row give the same bits."""
    b, s, h, hd, ps = 4, 576, 12, 64, 64
    nb = s // ps
    g = torch.Generator(device="cuda").manual_seed(5)
    dense = {n: torch.randn((b, 2, s, h, hd), generator=g, device="cuda")
             for n in ("k", "v")}
    if int8:
        from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

        for n in ("k", "v"):
            dense[n], dense[f"{n}_scale"] = quantize_kv(dense[n])
    tables = _scrambled_tables(b, nb, b * nb, seed=5)
    pool = {n: torch.zeros((b * nb + 1, 2, ps) + t.shape[3:], dtype=t.dtype,
                           device="cuda") for n, t in dense.items()}
    for n, t in dense.items():
        for bi in range(b):
            for j in range(nb):
                pool[n][tables[bi, j]] = t[bi, :, j * ps:(j + 1) * ps]
    pos = torch.tensor([0, 63, 64, 575], dtype=torch.int32, device="cuda")
    qkv = torch.randn((b, 3, h, hd), generator=g, device="cuda")
    scales = lambda c: (c.get("k_scale"), c.get("v_scale"))  # noqa: E731
    dv = [t[:, 1] if t is not None else None
          for t in (dense["k"], dense["v"], *scales(dense))]
    pv = [t[:, 1] if t is not None else None
          for t in (pool["k"], pool["v"], *scales(pool))]
    a = fd.decode_attention_dense(qkv[:, 0], *dv, qkv[:, 1], qkv[:, 2], pos)
    p = fd.decode_attention_paged(qkv[:, 0], *pv, qkv[:, 1], qkv[:, 2], pos, tables)
    assert torch.equal(a, p)


def _verify_inputs(b=8, k1=5, layers=2, pages=73, ps=64, h=12, hd=64, seed=11):
    """A [pages, L, ps, h, hd] f32 pool with scrambled tables, queries as
    the model's strided qkv split [b, K1, h, hd], and ``posmat = pos +
    arange(K1)`` with ``pos`` spread over the 9-page window."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = {n: torch.randn((pages, layers, ps, h, hd), generator=g, device="cuda")
            for n in ("k", "v")}
    tables = _scrambled_tables(b, 9, pages - 1, seed=seed)
    qkv = torch.randn((b, k1, 3 * h * hd), generator=g, device="cuda")
    q4 = qkv[..., : h * hd].reshape(b, k1, h, hd)
    pos = torch.tensor([0, 571, 17, 300, 64, 507, 128, 450][:b], dtype=torch.int32,
                       device="cuda")
    posmat = (pos[:, None] + torch.arange(k1, device="cuda")).to(torch.int32)
    return pool, tables, q4, posmat


def test_verify_kernel_matches_plain_on_both_layouts(cuda):
    """K4 at nq = K+1 = 5 through the verify wrappers: the paged pool's
    strided layer view and the dense layer view (identity tables), against
    the plain version; each launch counts once."""
    pool, tables, q4, posmat = _verify_inputs()
    k_l, v_l = pool["k"][:, 1], pool["v"][:, 1]
    before = (fd.launches_verify, fd.launches_multi_query)
    out = fd.verify_attention_paged(q4, k_l, v_l, tables, posmat)
    ref = fd.verify_attention_paged(q4, k_l, v_l, tables, posmat, kernel="gather")
    assert (out - ref).abs().max().item() <= ATOL
    dense_k, dense_v = (t[:8, 1] for t in (pool["k"], pool["v"]))  # [8, 64, 12, 64]
    dpos = posmat % 60
    out_d = fd.verify_attention_dense(q4, dense_k, dense_v, dpos)
    ref_d = fd._verify_dense_math(q4, dense_k, dense_v, dpos)
    assert (out_d - ref_d).abs().max().item() <= ATOL
    assert (fd.launches_verify - before[0], fd.launches_multi_query - before[1]) == (2, 2)


def test_verify_column_equals_single_query_launch_bitwise(cuda):
    """Column j of the nq = 5 launch is, bit for bit, an nq = 1 launch of
    the same query row at ``pos + j`` — the property that makes a verify
    pass reproduce a sequential decode walk's attention."""
    pool, tables, q4, posmat = _verify_inputs()
    k_l, v_l = pool["k"][:, 0], pool["v"][:, 0]
    out = fd.verify_attention_paged(q4, k_l, v_l, tables, posmat)
    for j in range(q4.shape[1]):
        one = fd.paged_attention(q4[:, j:j + 1], k_l, v_l, tables,
                                 posmat[:, j:j + 1].contiguous())
        assert torch.equal(out[:, j:j + 1], one), j


@pytest.mark.parametrize("rows", [8, 40])
@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072), (3072, 768),
                                 (768, 32768)])
def test_int8_matmul_exact_and_qdot_rescale(cuda, rows, k, n):
    """The int8 x int8 product on the card (``torch._int_mm``, rows padded
    to its minimum) equals a float64 product of the same codes exactly
    (|acc| < 2^53), and qdot's output is within 1e-6 relative of a float64
    rescale of that accumulator."""
    from distributeddeeplearning_tpu_torch.quant import qtensor as qt

    g = torch.Generator(device="cuda").manual_seed(rows + k + n)
    x = torch.randn((rows, k), generator=g, device="cuda")
    w = qt.quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02)
    a_scale = torch.clamp(x.abs().amax(-1, keepdim=True), min=qt.EPS) / qt.QMAX
    xq = torch.clamp(torch.round(x / a_scale), -qt.QMAX, qt.QMAX).to(torch.int8)
    acc = qt.int8_matmul(xq, w.values)
    assert acc.dtype == torch.int32 and acc.shape == (rows, n)
    assert torch.equal(acc.double(), xq.double() @ w.values.double())
    f64 = acc.double() * a_scale.double() * w.scales.double()
    got = qt.qdot(x, w).double()
    assert ((got - f64).abs() <= 1e-6 * f64.abs()).all()


# ---- head dims 16 and 32 -------------------------------------------------

@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("s", [37, 576])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_kernels_at_small_head_dims(cuda, d, s, causal):
    """f32 K1, K2, K3 at head dims 8, 16 and 32 on strided qkv views (the
    reference's serve and trainer geometries: 4 and 8 heads; 8 runs the
    kernels at 16 on zero-padded copies)."""
    h = 64 // d * 2
    q, k, v = _qkv_views(s, h=h, d=d, b=2, seed=s + d)
    o, lse = fa.flash_attention_core(q, k, v, causal=causal)
    o_ref, lse_ref = fa._dense_attention(q, k, v, None, causal=causal)
    assert (o - o_ref).abs().max().item() <= ATOL
    assert (lse - lse_ref).abs().max().item() <= ATOL
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(d), device="cuda")
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    before = (fa.launches_dq, fa.launches_dkv)
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    want = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(), 1.0)


@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("s", [37, 576])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernels_at_small_head_dims(cuda, d, s, causal):
    """bf16 K1, K2, K3 at head dims 8, 16 and 32: bf16 rows of 32 and 64
    bytes read by TMA from a qkv row of 3*h*d (8: zero-padded copies of
    32-byte rows)."""
    h = 64 // d * 2
    q, k, v = _bf16_qkv(s, h=h, d=d, seed=s + d)
    before = fa.launches_bf16
    o, lse = fa.flash_attention_core(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches_bf16 == before + 1
    o_plain, lse_plain = fa._dense_attention(q, k, v, None, causal=causal)
    o_ref, _ = fa._dense_attention(q.float(), k.float(), v.float(), None,
                                   causal=causal)
    _hold_bf16(o, o_plain, o_ref, "o")
    assert (lse - lse_plain).abs().max().item() <= ATOL
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(d), device="cuda").bfloat16()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal)
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal)
    ref = fa._dense_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                  lse, delta, causal=causal)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        _hold_bf16(g, p, r, name)


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("query", ["float32", "bfloat16"])
def test_decode_kernel_every_query_page_pair(cuda, hd, pages, query):
    """K4 decode (b=8, nq=1; int8 with the own-token overlay) and a 64-query
    chunk over scrambled pages, for every query/page dtype pair and head
    dim, against the plain version; the bf16 query and pages widen to the
    bits an f32 launch on the same values gives."""
    qdt, pdt = getattr(torch, query), getattr(torch, pages)
    h = 768 // 64 if hd == 64 else 4
    pool = _pool(2, 72, 64, h, hd, pdt, seed=hd)
    views = [pool[n][:, 1] if n in pool else None
             for n in ("k", "v", "k_scale", "v_scale")]
    tables = _scrambled_tables(8, 9, 72, seed=hd)
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    qkv = torch.randn((8, 3, h, hd), device="cuda").to(qdt)
    q3, k_t, v_t = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    q_c = torch.randn((64, 3, h, hd), device="cuda").to(qdt)[:, 0]
    posns = 500 + torch.arange(64, device="cuda")
    before = (fd.launches, fd.launches_bf16, fd.launches_int8)
    out = fd.decode_attention_paged(q3, *views, k_t, v_t, pos, tables)
    out_c = fd.chunk_attention(q_c, *views, tables[1], posns)
    torch.cuda.synchronize()
    bf16 = torch.bfloat16 in (qdt, pdt)
    assert (fd.launches, fd.launches_bf16, fd.launches_int8) == (
        before[0] + 2, before[1] + 2 * bf16, before[2] + 2 * (pdt == torch.int8))
    assert out.dtype == out_c.dtype == torch.float32
    own = (k_t, v_t) if pdt == torch.int8 else (None, None)
    ref = fd._paged_attention_plain(q3[:, None], *views[:2], tables, pos[:, None],
                                    *views[2:], *own)[:, 0]
    ref_c = fd._paged_attention_plain(q_c[None], *views[:2], tables[1][None],
                                      posns.to(torch.int32)[None], *views[2:])[0]
    for o, r in ((out, ref), (out_c, ref_c)):
        assert torch.isfinite(o).all()
        assert (o - r).abs().max().item() <= ATOL
    if bf16:
        widen = lambda t: t.float() if t is not None and t.dtype == torch.bfloat16 else t  # noqa: E731
        f32 = fd.decode_attention_paged(widen(q3), *map(widen, views), widen(k_t),
                                        widen(v_t), pos, tables)
        f32_c = fd.chunk_attention(widen(q_c), *map(widen, views), tables[1], posns)
        assert torch.equal(out, f32) and torch.equal(out_c, f32_c)


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_equals_dense_and_verify_column_bitwise_every_head_dim(cuda, hd, dtype):
    """At every head dim and page dtype: the same K/V read as 64-position
    pages through a scrambled table and as one dense row give the same
    bits, and (f32 and bf16 pools) a verify column at nq = 5 is an nq = 1
    launch at pos + j."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    pdt = getattr(torch, dtype)
    b, s, h, ps = 4, 576, 4, 64
    nb = s // ps
    g = torch.Generator(device="cuda").manual_seed(hd)
    dense = {n: torch.randn((b, 2, s, h, hd), generator=g, device="cuda")
             for n in ("k", "v")}
    for n in ("k", "v"):
        if pdt == torch.int8:
            dense[n], dense[f"{n}_scale"] = quantize_kv(dense[n])
        else:
            dense[n] = dense[n].to(pdt)
    tables = _scrambled_tables(b, nb, b * nb, seed=hd)
    pool = {n: torch.zeros((b * nb + 1, 2, ps) + t.shape[3:], dtype=t.dtype,
                           device="cuda") for n, t in dense.items()}
    for n, t in dense.items():
        for bi in range(b):
            for j in range(nb):
                pool[n][tables[bi, j]] = t[bi, :, j * ps:(j + 1) * ps]
    pos = torch.tensor([0, 63, 64, 570], dtype=torch.int32, device="cuda")
    qdt = torch.float32 if pdt == torch.float32 else torch.bfloat16
    qkv = torch.randn((b, 3, h, hd), generator=g, device="cuda").to(qdt)
    dv = [dense[n][:, 1] if n in dense else None
          for n in ("k", "v", "k_scale", "v_scale")]
    pv = [pool[n][:, 1] if n in pool else None
          for n in ("k", "v", "k_scale", "v_scale")]
    a = fd.decode_attention_dense(qkv[:, 0], *dv, qkv[:, 1], qkv[:, 2], pos)
    p = fd.decode_attention_paged(qkv[:, 0], *pv, qkv[:, 1], qkv[:, 2], pos, tables)
    assert torch.equal(a, p)
    if pdt == torch.int8:
        return
    q4 = torch.randn((b, 5, h, hd), generator=g, device="cuda").to(qdt)
    posmat = (pos[:, None] + torch.arange(5, device="cuda")).to(torch.int32)
    out = fd.verify_attention_paged(q4, pv[0], pv[1], tables, posmat)
    for j in range(5):
        one = fd.paged_attention(q4[:, j:j + 1], pv[0], pv[1], tables,
                                 posmat[:, j:j + 1].contiguous())
        assert torch.equal(out[:, j:j + 1], one), j


def test_decode_kernel_refuses_other_head_dims_and_dtypes(cuda):
    tables = _scrambled_tables(1, 2, 4, seed=0)
    pos = torch.tensor([9], dtype=torch.int32, device="cuda")
    # the kernel takes head dims 8, 16, 32 and 64; 48 and 24 are refused
    for hd in (48, 24):
        pool = _pool(1, 4, 8, 2, hd, torch.float32, seed=0)
        q = torch.randn((1, 1, 2, hd), device="cuda")
        with pytest.raises(ValueError, match="head dims"):
            fd.paged_attention(q, pool["k"][:, 0], pool["v"][:, 0], tables,
                               pos[:, None])
    pool = _pool(1, 4, 8, 2, 8, torch.int8, seed=0)
    q = torch.randn((1, 1, 2, 8), device="cuda")
    out = fd.paged_attention(q, pool["k"][:, 0], pool["v"][:, 0], tables,
                             pos[:, None], pool["k_scale"][:, 0],
                             pool["v_scale"][:, 0])
    ref = fd._paged_attention_plain(q, pool["k"][:, 0], pool["v"][:, 0], tables,
                                    pos[:, None], pool["k_scale"][:, 0],
                                    pool["v_scale"][:, 0])
    assert (out - ref).abs().max().item() <= ATOL
    pool = _pool(1, 4, 8, 2, 32, torch.float16, seed=0)
    with pytest.raises(TypeError, match="k_pages"):
        fd.paged_attention(torch.randn((1, 1, 2, 32), device="cuda"),
                           pool["k"][:, 0], pool["v"][:, 0], tables, pos[:, None])


def test_int8_matmul_pads_k_and_n_on_the_card(cuda):
    """``torch._int_mm`` on the card takes K and N only in multiples of 8,
    and no K <= 96: the head of the reference's ``ddlt serve`` geometry
    (K = 64, N = 257), the trainer's vocabulary (1031) and odd K go
    through the zero-padded product and equal the CPU result."""
    from distributeddeeplearning_tpu_torch.quant import qtensor as qt

    g = torch.Generator().manual_seed(0)
    for m, k, n in ((8, 68, 257), (40, 64, 257), (3, 68, 1031), (17, 128, 192),
                    (8, 256, 1031), (17, 100, 264)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        got = qt.int8_matmul(a.cuda(), b.cuda())
        assert got.shape == (m, n)
        assert torch.equal(got.cpu(), qt.int8_matmul(a, b))


# ---- the key-padding bias (K1-K3 built with HAS_BIAS) ----------------------

def _padding_bias(b, s, seed):
    """[b, s] f32 key-padding bias: synthetic-text lengths, then rows of
    length 1, s and 0 (every key masked)."""
    mask = next(SyntheticTextDataset(length=b, seq_len=s, vocab_size=50,
                                     seed=seed).batches(b))["attention_mask"]
    keep = torch.from_numpy(mask).bool()
    keep[1] = torch.arange(s) < 1
    keep[2] = True
    keep[3] = False
    return fa._mask_bias(keep.cuda()[:, None, None, :], b, s), keep.cuda()


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 37, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_kernels_match_plain(cuda, dtype, d, s, causal):
    """K1, K2, K3 with the bias against their plain versions, once each
    through the bias counters (the unbiased ones untouched)."""
    dt = getattr(torch, dtype)
    b, h = 4, 128 // d
    q, k, v = _qkv_views(s, h=h, d=d, b=b, seed=s + d)
    if dt == torch.bfloat16:
        q, k, v = _bf16_qkv(s, b=b, h=h, d=d, seed=s + d)
    bias, keep = _padding_bias(b, s, seed=d + s)
    sfx = "_bf16" if dt == torch.bfloat16 else ""
    names = [f"launches{sfx}", f"launches_bias{sfx}", f"launches_dq{sfx}",
             f"launches_dq_bias{sfx}", f"launches_dkv{sfx}",
             f"launches_dkv_bias{sfx}"]
    before = [getattr(fa, n) for n in names]
    o, lse = fa.flash_attention_core(q, k, v, causal=causal, bias=bias)
    g = torch.Generator(device="cuda").manual_seed(d)
    do = torch.randn(o.shape, generator=g, device="cuda").to(dt)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=causal, bias=bias)
    torch.cuda.synchronize()
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == [0, 1, 0, 1, 0, 1]
    o_plain, lse_plain = fa._dense_attention(q, k, v, bias, causal=causal)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (lse - lse_plain).abs().max().item() <= ATOL
    assert torch.equal(lse[3], lse_plain[3]) and (lse[3] < -6e29).all()
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=causal,
                                    bias=bias)
    if dt == torch.float32:
        assert (o - o_plain).abs().max().item() <= ATOL
        for gt, w in zip(got, plain):
            assert torch.isfinite(gt).all()
            assert (gt - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(), 1.0)
    else:
        o_ref, _ = fa._dense_attention(q.float(), k.float(), v.float(), bias,
                                       causal=causal)
        _hold_bf16(o, o_plain, o_ref, "o")
        ref = fa._dense_attention_bwd(q.float(), k.float(), v.float(),
                                      do.float(), lse, delta, causal=causal,
                                      bias=bias)
        for name, gt, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
            if s == 1 and name != "dv":
                # one key: P = 1 and dS = dP - delta, exactly 0 but for the
                # f32 rounding of two D-term sums (~D * 2^-24 of |dO||V|)
                assert gt.abs().max().item() <= 1e-5, name
                assert p.abs().max().item() <= 1e-5, name
                continue
            _hold_bf16(gt, p, r, name)
    masked = ~keep
    masked[3] = False
    dk, dv = got[1], got[2]
    assert (dk[masked] == 0).all() and (dv[masked] == 0).all()


def test_bias_gradients_through_the_function(cuda):
    """autograd through flash_attention with a [B, 1, 1, S] mask on a bf16
    qkv leaf: the bias variants of K1, K2, K3 once each, a gradient held
    against autograd through the f32 plain attention with the same bias.
    No row is fully masked here: for such a row the kernels (and the
    reference's Pallas backward) recompute P = exp(S - lse) = 1 from an lse
    that has lost its log S to rounding, where autograd through the plain
    forward differentiates P = 1/S; ``test_bias_kernels_match_plain`` pins
    that row against the plain backward."""
    b, s, h, d = 4, 128, 12, 64
    _, keep = _padding_bias(b, s, seed=1)
    keep[3] = torch.arange(s, device="cuda") < 5
    bias = fa._mask_bias(keep[:, None, None, :], b, s)
    base = torch.randn((b, s, 3 * h * d), generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda").bfloat16()

    def grad(attn, dtype):
        leaf = base.to(dtype).requires_grad_(True)
        q, k, v = (t.reshape(b, s, h, d) for t in leaf.split(h * d, dim=-1))
        (out,) = torch.autograd.grad((attn(q, k, v).float() ** 2).sum(), leaf)
        return out

    names = ("launches_bias_bf16", "launches_dq_bias_bf16", "launches_dkv_bias_bf16")
    before = [getattr(fa, n) for n in names]
    got = grad(lambda q, k, v: fa.flash_attention(q, k, v, keep[:, None, None, :]),
               torch.bfloat16)
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == [1, 1, 1]
    plain = grad(lambda q, k, v: fa._dense_attention(q, k, v, bias, causal=False)[0],
                 torch.bfloat16)
    ref = grad(lambda q, k, v: fa._dense_attention(q, k, v, bias, causal=False)[0],
               torch.float32)
    _hold_bf16(got, plain, ref, "dqkv")


# ---- the split decode kernel: span boundaries, layouts, poisoned history ---

SPLIT_S = 576


def _split_history(hd, dtype, seed, b=6, h=4):
    """Dense [b, 2, S, h, hd] K/V (int8: through quantize_kv, with scales)
    and its layer view; the queries in the pages' query dtype."""
    from distributeddeeplearning_tpu_torch.quant.qtensor import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    dense = {n: torch.randn((b, 2, SPLIT_S, h, hd), generator=g, device="cuda")
             for n in ("k", "v")}
    for n in ("k", "v"):
        if dtype == torch.int8:
            dense[n], dense[f"{n}_scale"] = quantize_kv(dense[n])
        else:
            dense[n] = dense[n].to(dtype)
    qdt = torch.float32 if dtype == torch.float32 else torch.bfloat16
    qkv = torch.randn((b, 3, h, hd), generator=g, device="cuda").to(qdt)
    return dense, qkv


def _as_pages(dense, ps, seed):
    """The same contents as a pool of ``ps``-position pages [P, 2, ps, ...]
    through scrambled tables (page 0 never used)."""
    b = dense["k"].shape[0]
    nb = SPLIT_S // ps
    tables = _scrambled_tables(b, nb, b * nb, seed=seed)
    pool = {n: torch.zeros((b * nb + 1, 2, ps) + t.shape[3:], dtype=t.dtype,
                           device="cuda") for n, t in dense.items()}
    rows = tables.long().reshape(-1)
    for n, t in dense.items():
        pool[n][rows] = t.reshape(b, 2, nb, ps, *t.shape[3:]).transpose(1, 2).reshape(
            b * nb, 2, ps, *t.shape[3:])
    return pool, tables


def _views(c, layer=1):
    return [c[n][:, layer] if n in c else None for n in ("k", "v", "k_scale", "v_scale")]


@pytest.mark.parametrize("ps", [16, 64, SPLIT_S])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8", "int8_overlay"])
def test_split_kernel_boundaries_layouts_and_poison(cuda, pages, hd, ps):
    """Decode at positions 0, SPAN-1, SPAN, SPAN+1, 2*SPAN and S-1 (one slot
    each): the dense layer view and ``ps``-position pages give the same
    bits; NaN-poisoned rows past each slot's position leave the output
    finite and bitwise unchanged; the plain version agrees within ATOL."""
    dtype = torch.int8 if pages.startswith("int8") else getattr(torch, pages)
    span = fd.SPAN
    dense, qkv = _split_history(hd, dtype, seed=hd + ps)
    pos = torch.tensor([0, span - 1, span, span + 1, 2 * span, SPLIT_S - 1],
                       dtype=torch.int32, device="cuda")
    own = (qkv[:, 1], qkv[:, 2]) if pages == "int8_overlay" else (None, None)
    q4, posmat = qkv[:, :1], pos[:, None]
    pool, tables = _as_pages(dense, ps, seed=hd)
    ident = torch.arange(6, dtype=torch.int32, device="cuda")[:, None]
    dv, pv = _views(dense), _views(pool)
    a = fd.paged_attention(q4, dv[0], dv[1], ident, posmat, dv[2], dv[3], *own)
    p = fd.paged_attention(q4, pv[0], pv[1], tables, posmat, pv[2], pv[3], *own)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    assert torch.equal(a, p)
    ref = fd._paged_attention_plain(q4, dv[0], dv[1], ident, posmat, dv[2], dv[3], *own)
    assert (a - ref).abs().max().item() <= ATOL
    poisoned = {n: t.clone() for n, t in dense.items()}
    for bi, t in enumerate(pos.tolist()):
        if t + 1 < SPLIT_S:
            poisoned["k"][bi, :, t + 1:] = (
                float("nan") if dtype != torch.int8 else 127)
            poisoned["v"][bi, :, t + 1:] = float("nan") if dtype != torch.int8 else -127
            if dtype == torch.int8:
                poisoned["k_scale"][bi, :, t + 1:] = float("nan")
                poisoned["v_scale"][bi, :, t + 1:] = float("nan")
    xv = _views(poisoned)
    x = fd.paged_attention(q4, xv[0], xv[1], ident, posmat, xv[2], xv[3], *own)
    assert torch.equal(a, x)


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
def test_split_kernel_folded_queries_equal_single_query_launches(cuda, pages, hd):
    """A verify pass (b = 6, nq = 5 at pos + j) column j equals the nq = 1
    launch at pos + j, and each query of a 64-query chunk (b = 1, positions
    500..563) equals a decode launch at its position, bit for bit: the tile
    is shared, each query's arithmetic is its own."""
    dtype = getattr(torch, pages)
    span = fd.SPAN
    dense, _ = _split_history(hd, dtype, seed=3 * hd)
    pool, tables = _as_pages(dense, 64, seed=hd)
    k, v, ks, vs = _views(pool)
    qdt = torch.float32 if dtype == torch.float32 else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(hd)
    pos = torch.tensor([0, span - 3, span, 2 * span - 1, 300, SPLIT_S - 5],
                       dtype=torch.int32, device="cuda")
    posmat = (pos[:, None] + torch.arange(5, device="cuda")).to(torch.int32)
    q4 = torch.randn((6, 5, 4, hd), generator=g, device="cuda").to(qdt)
    out = fd.paged_attention(q4, k, v, tables, posmat, ks, vs)
    for j in range(5):
        one = fd.paged_attention(q4[:, j:j + 1], k, v, tables,
                                 posmat[:, j:j + 1].contiguous(), ks, vs)
        assert torch.equal(out[:, j:j + 1], one), j
    q_c = torch.randn((64, 4, hd), generator=g, device="cuda").to(qdt)
    posns = 500 + torch.arange(64, device="cuda")
    out_c = fd.chunk_attention(q_c, k, v, ks, vs, tables[2], posns)
    for i in (0, 11, 12, 13, 63):
        one = fd.paged_attention(q_c[i][None, None], k, v, tables[2][None],
                                 posns[i:i + 1].to(torch.int32)[None], ks, vs)
        assert torch.equal(out_c[i][None], one[0]), i
    assert torch.isfinite(out).all() and torch.isfinite(out_c).all()


# ---- the ViT shape: S = 197 (196 patches and the CLS token), non-causal,
# no bias; ragged against every query-block size and the 64/128-key tiles

VIT_S, VIT_H, VIT_D = 197, 12, 64


@pytest.mark.parametrize("b", [2, 64])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_flash_kernels_at_the_vit_shape(cuda, dtype, b):
    """K1, K2 and K3 at ViT-B/16's attention shape (B = 64 is the
    benchmark's batch), non-causal, unbiased, on strided qkv views: f32
    within ATOL (K1) and 1e-4 of the largest |gradient| (K2, K3) of the
    plain versions; bf16 by the bf16 rule against the f32 result of the
    same inputs; lse within ATOL; one launch of each unbiased kernel of
    the dtype."""
    q, k, v = (_bf16_qkv(VIT_S, b=b, h=VIT_H, d=VIT_D, seed=b) if dtype == "bf16"
               else _qkv_views(VIT_S, h=VIT_H, d=VIT_D, b=b, seed=b))
    sfx = "_bf16" if dtype == "bf16" else ""
    names = [f"launches{sfx}", f"launches_dq{sfx}", f"launches_dkv{sfx}"]
    before = [getattr(fa, n) for n in names]
    o, lse = fa.flash_attention_core(q, k, v, causal=False)
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(b + 1), device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = fa._launch_bwd(q, k, v, do, lse, delta, causal=False)
    torch.cuda.synchronize()
    assert [getattr(fa, n) - x for n, x in zip(names, before)] == [1, 1, 1]
    o_plain, lse_plain = fa._dense_attention(q, k, v, None, causal=False)
    plain = fa._dense_attention_bwd(q, k, v, do, lse, delta, causal=False)
    assert (lse - lse_plain).abs().max().item() <= ATOL
    if dtype == "f32":
        assert (o - o_plain).abs().max().item() <= ATOL
        for name, g, p in zip(("dq", "dk", "dv"), got, plain):
            assert torch.isfinite(g).all(), name
            assert (g - p).abs().max().item() <= ATOL * max(p.abs().max().item(), 1.0)
        return
    qf, kf, vf = q.float(), k.float(), v.float()
    _hold_bf16(o, o_plain, fa._dense_attention(qf, kf, vf, None, causal=False)[0], "o")
    ref = fa._dense_attention_bwd(qf, kf, vf, do.float(), lse, delta, causal=False)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        _hold_bf16(g, p, r, name)


def test_vit_attention_gradients_through_the_function(cuda):
    """The flash ``attention_fn`` at the ViT shape in bf16, forward and
    backward through autograd, against autograd through the f32 plain
    attention of the same bf16 inputs (bf16 rule against that f32
    result, with the bf16 plain backward as the yardstick)."""
    b = 8
    q, k, v = (t.detach().requires_grad_(True)
               for t in _bf16_qkv(VIT_S, b=b, h=VIT_H, d=VIT_D, seed=5))
    attention = fa.make_flash_attention()
    o = attention(q, k, v, None, dtype=torch.bfloat16)
    do = torch.randn(o.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(6), device="cuda").bfloat16()
    got = torch.autograd.grad(o, (q, k, v), do)
    _, lse = fa._dense_attention(q.detach(), k.detach(), v.detach(), None,
                                 causal=False)
    delta = (do.float() * o.detach().float()).sum(-1).transpose(1, 2).contiguous()
    plain = fa._dense_attention_bwd(q.detach(), k.detach(), v.detach(), do, lse,
                                    delta, causal=False)
    ref = fa._dense_attention_bwd(*(t.detach().float() for t in (q, k, v)),
                                  do.float(), lse, delta, causal=False)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        _hold_bf16(g, p, r, name)


# -- tensor parallelism: the kernels over a rank's heads ------------------------

TP_H, TP_LOCAL = 12, 6


def _tp_mesh(rank):
    from distributeddeeplearning_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh

    shape = dict.fromkeys(AXIS_ORDER, 1)
    shape["tensor"] = TP_H // TP_LOCAL
    return Mesh(shape=shape, size=shape["tensor"], rank=rank)


def _rank_heads(t, rank, dim):
    return t.narrow(dim, rank * TP_LOCAL, TP_LOCAL).contiguous()


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("pages", ["f32", "bf16", "int8"])
def test_k4d_over_local_heads(cuda, layout, pages):
    """K4(d) at the per-rank decode shape (b=8, 6 heads, hd=64, S=576; int8
    with the own-token overlay, bf16 under bf16 queries): each rank's
    launch against the plain version and bitwise against the all-heads
    launch's rows."""
    b, s, hd, ps = 8, 576, 64, 64
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[pages]
    qt = torch.bfloat16 if pages == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(31)
    qkv = torch.randn((b, 3, TP_H, hd), generator=g, device="cuda").to(qt)
    own = (qkv[:, 1], qkv[:, 2]) if pages == "int8" else (None, None)
    pos = torch.tensor([0, 575, 17, 300, 64, 511, 128, 450], dtype=torch.int32,
                       device="cuda")
    if layout == "dense":
        cache = _pool(1, b - 1, s, TP_H, hd, dtype, seed=32)  # [b, 1, S, h, hd]
        tables = None
    else:
        cache = _pool(1, b * (s // ps), ps, TP_H, hd, dtype, seed=32)
        tables = _scrambled_tables(b, s // ps, b * (s // ps), seed=33)
    names = ("k", "v", "k_scale", "v_scale")

    def attend(q, leaves, own, mesh=None):
        views = [leaves[n][:, 0] if n in leaves else None for n in names]
        if tables is None:
            return fd.decode_attention_dense(q, *views, *own, pos, mesh=mesh)
        return fd.decode_attention_paged(q, *views, *own, pos, tables, mesh=mesh)

    full = attend(qkv[:, 0], cache, own)
    for r in range(TP_H // TP_LOCAL):
        local = {n: _rank_heads(t, r, 3) for n, t in cache.items()}
        q = _rank_heads(qkv[:, 0], r, 1)
        own_r = tuple(None if t is None else _rank_heads(t, r, 1) for t in own)
        got = attend(q, local, own_r, _tp_mesh(r))
        views = [local[n][:, 0] if n in local else None for n in names]
        tab = tables if tables is not None else torch.arange(
            b, dtype=torch.int32, device="cuda")[:, None]
        plain = fd._paged_attention_plain(q[:, None], views[0], views[1], tab,
                                          pos[:, None], views[2], views[3],
                                          *own_r)[:, 0]
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got - plain).abs().max().item() <= ATOL
        assert torch.equal(got, full[:, r * TP_LOCAL:(r + 1) * TP_LOCAL])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_k4d_chunk_over_local_heads(cuda, int8):
    """A 64-query chunk over a rank's 6 heads of a scrambled pool: plain
    version at 1e-4, the all-heads launch's rows bitwise."""
    ps, nb, c = 64, 9, 64
    pool = _pool(1, 73, ps, TP_H, 64, torch.int8 if int8 else torch.float32, seed=34)
    table = _scrambled_tables(1, nb, 73, seed=35)[0]
    posns = 512 + torch.arange(c, device="cuda")
    q = torch.randn((c, TP_H, 64), generator=torch.Generator(device="cuda").manual_seed(36),
                    device="cuda")
    names = ("k", "v", "k_scale", "v_scale")
    leaves = lambda p: [p[n][:, 0] if n in p else None for n in names]  # noqa: E731
    full = fd.chunk_attention(q, *leaves(pool), table, posns)
    for r in range(TP_H // TP_LOCAL):
        local = {n: _rank_heads(t, r, 3) for n, t in pool.items()}
        q_r = _rank_heads(q, r, 1)
        got = fd.chunk_attention(q_r, *leaves(local), table, posns, mesh=_tp_mesh(r))
        lv = leaves(local)
        plain = fd._paged_attention_plain(q_r[None], lv[0], lv[1], table[None],
                                          posns.to(torch.int32)[None], lv[2], lv[3])[0]
        torch.cuda.synchronize()
        assert (got - plain).abs().max().item() <= ATOL
        assert torch.equal(got, full[:, r * TP_LOCAL:(r + 1) * TP_LOCAL])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_over_local_heads(cuda, dtype):
    """K1, and K2/K3 in its backward, through ``make_flash_attention(mesh)``
    over a rank's 6 heads (B=1, S=512, causal; q, k, v strided views of
    the rank's own qkv projection): output and gradients against the
    plain versions (f32 1e-4; bf16 the rule above against the f32
    reference) and against the all-heads kernels' rows."""
    b, s, d = 1, 512, 64
    g = torch.Generator(device="cuda").manual_seed(37)
    qkv = torch.randn((b, s, 3 * TP_H * d), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, s, TP_H, d), generator=g, device="cuda").to(dtype)
    full = qkv.clone().requires_grad_(True)
    o_all = fa.flash_attention(*(t.reshape(b, s, TP_H, d)
                                 for t in full.split(TP_H * d, -1)), None, causal=True)
    (o_all.float() * do.float()).sum().backward()
    for r in range(TP_H // TP_LOCAL):
        cols = [j * TP_H * d + r * TP_LOCAL * d for j in range(3)]
        mine = torch.cat([qkv[..., c:c + TP_LOCAL * d] for c in cols], -1)
        mine.requires_grad_(True)
        q, k, v = (t.reshape(b, s, TP_LOCAL, d) for t in mine.split(TP_LOCAL * d, -1))
        fn = fa.make_flash_attention(mesh=_tp_mesh(r), causal=True)
        o = fn(q, k, v, None, dtype=dtype)
        do_r = _rank_heads(do, r, 2)
        (o.float() * do_r.float()).sum().backward()
        grads = [mine.grad[..., c:c + TP_LOCAL * d] for c in (0, TP_LOCAL * d,
                                                             2 * TP_LOCAL * d)]
        grad_all = [full.grad[..., c:c + TP_LOCAL * d] for c in cols]
        o_p, lse = fa._dense_attention(q.detach(), k.detach(), v.detach(), None,
                                       causal=True)
        delta = (do_r.float() * o.detach().float()).sum(-1).transpose(1, 2).contiguous()
        plain = fa._dense_attention_bwd(q.detach(), k.detach(), v.detach(), do_r, lse,
                                        delta, causal=True)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            assert (o - o_p).abs().max().item() <= ATOL
            for gt, pl in zip(grads, plain):
                pl = pl.reshape(b, s, TP_LOCAL * d)
                assert (gt - pl).abs().max().item() <= ATOL * max(pl.abs().max().item(), 1)
        else:
            qf, kf, vf = (t.detach().float() for t in (q, k, v))
            ref = fa._dense_attention(qf, kf, vf, None, causal=True)[0]
            err, plain_err = ((x.float() - ref).abs().max().item() for x in (o, o_p))
            top = ref.abs().max().item()
            assert err <= 2 * plain_err + 2.0 ** (math.floor(math.log2(top)) - 7)
        o_rows = o_all[:, :, r * TP_LOCAL:(r + 1) * TP_LOCAL]
        if not torch.equal(o, o_rows):  # fewer heads may take another block shape
            tol = ATOL if dtype == torch.float32 else 2.0 ** (
                math.floor(math.log2(o_rows.abs().max().item())) - 7)
            assert (o.float() - o_rows.float()).abs().max().item() <= tol
        for gt, ga in zip(grads, grad_all):
            scale = max(ga.abs().max().item(), 1.0)
            tol = ATOL * scale if dtype == torch.float32 else scale * 2.0 ** -7
            assert (gt.float() - ga.float()).abs().max().item() <= tol

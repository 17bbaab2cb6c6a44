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
sums over <= 576 terms.
"""

from __future__ import annotations

import pytest
import torch

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
    q, k, v = _qkv_views(16, h=2, d=32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_core(q, k, v, causal=True)
    q, k, v = _qkv_views(16)
    with pytest.raises(NotImplementedError, match="mask"):
        fa.flash_attention(q, k, v, torch.ones(1, 16, dtype=torch.bool,
                                               device="cuda"), causal=True)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_core(q.double(), k.double(), v.double())


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

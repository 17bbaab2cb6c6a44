"""The port's flash-attention backward against the JAX package, on the CPU.

Here the port runs the backward kernels' plain version
(``_dense_attention_bwd``, through the ``torch.autograd.Function`` the
kernels hang from, since the tensors lie on the CPU); the JAX side runs
the Pallas backward kernels themselves in interpret mode
(``_flash_bwd_pallas`` with 16 x 16 tiles, so several q and k tiles and the
causal tile skips of both passes really run).  Inputs are made with numpy
from a seed and handed to both.

Tolerance 1e-5 absolute: both sides are f32; the Pallas kernels work in
base 2 and sum tile by tile, the plain version sums whole rows in natural
base.  Gradients here are O(1) with sums over <= 64 terms, where the gap
is a few ulp (~1e-6).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

ATOL = 1e-5


def _inputs(b, s, h, d, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(n)]


def _to3(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from3(x3, b, h):
    bh, s, d = x3.shape
    return np.asarray(x3).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_backward_interpret(causal):
    """dQ, dK, dV of the port's plain backward == the Pallas dq and dk/dv
    kernels in interpret mode at S=64 with 16x16 tiles, from the same
    explicit lse (the Pallas forward's) and dO; delta is rowsum(dO * O) on
    both sides."""
    b, s, h, d = 2, 64, 3, 8
    q, k, v, do = _inputs(b, s, h, d, n=4)
    bias = jnp.zeros((b, s), jnp.float32)
    o3, lse3 = jfa._flash_fwd_pallas(
        _to3(q), _to3(k), _to3(v), bias, heads=h, block_q=16, block_k=16,
        out_dtype=jnp.float32, causal=causal, has_bias=False,
    )
    want = jfa._flash_bwd_pallas(
        _to3(q), _to3(k), _to3(v), bias, o3, lse3, _to3(do), heads=h,
        block_q=16, block_k=16, causal=causal, has_bias=False,
    )
    o = torch.from_numpy(_from3(o3, b, h).copy())
    lse = torch.from_numpy(np.array(lse3).reshape(b, h, s))
    tdo = torch.from_numpy(do)
    delta = (tdo * o).sum(-1).transpose(1, 2).contiguous()
    got = tfa._dense_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), tdo, lse, delta,
        causal=causal,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _from3(w, b, h), atol=ATOL)


def test_autograd_through_the_port_matches_jax_grad():
    """torch.autograd.grad of (o**2).sum() through the port's causal
    flash_attention == jax.grad through the JAX flash_attention (Pallas
    forward and backward in interpret mode), as the reference's own
    test_causal_gradients_match_dense does against dense."""
    b, s, h, d = 2, 32, 2, 8
    q, k, v = _inputs(b, s, h, d, seed=6)

    def loss_jax(q, k, v):
        o = jfa.flash_attention(q, k, v, None, dtype=jnp.float32, block_q=16,
                                block_k=16, causal=True)
        return (o ** 2).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, None, causal=True)
    got = torch.autograd.grad((o ** 2).sum(), (tq, tk, tv))
    # (o**2) gradients reach ~10 here (one ulp ~1e-6); the gap is ~2e-6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_equal_autograd_through_plain_forward(causal):
    """Inside the port: the Function's backward (recomputation from lse)
    == autograd through the plain forward, on strided views of one qkv
    leaf, including a ragged length."""
    b, s, h, d = 2, 37, 2, 8
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * h * d)).astype(np.float32))
    qkv.requires_grad_(True)

    def grad(attn):
        q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
        return torch.autograd.grad((attn(q, k, v) ** 2).sum(), qkv)[0]

    got = grad(lambda q, k, v: tfa.flash_attention(q, k, v, None, causal=causal))
    want = grad(lambda q, k, v: tfa._dense_attention(q, k, v, None, causal=causal)[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_cpu_function_never_launches_the_kernels():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(1, 16, 2, 64))
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    o = tfa.flash_attention(q, k, v, None, causal=True)
    torch.autograd.grad(o.sum(), (q, k, v))
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before


def test_inference_mode_runs_the_forward_only():
    """Under inference_mode (the serving prefill) the Function records no
    graph and its output needs no gradient."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 8, seed=4))
    with torch.inference_mode():
        o = tfa.flash_attention(q, k, v, None, causal=True)
    assert not o.requires_grad
    np.testing.assert_allclose(
        o.numpy(), tfa._dense_attention(q, k, v, None, causal=True)[0].numpy(),
        atol=0,
    )

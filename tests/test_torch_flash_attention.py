"""The port's flash attention (``distributeddeeplearning_tpu_torch.ops.
flash_attention``) against the JAX package, on the CPU.

Here the port runs the kernel's plain version (the tensors lie on the
CPU); the JAX side runs the Pallas kernel itself in interpret mode
(``_flash_fwd_pallas`` with explicit blocks, so several q and k tiles and
the causal tile skip really run), or ``flash_attention``'s dense fallback
on a sequence whose auto-selected block falls below the floor.  Inputs are
made with numpy from a seed and handed to both.

Tolerance 1e-5 absolute: both sides are f32, but the Pallas kernel works in
base 2 with an online softmax over tiles (T1: only the nats interface of
lse is shared) and sums in another order.  lse reaches ~6 here, where one
f32 ulp is 4.8e-7; the observed gap is ~1 ulp and thread-count-dependent
summation order moves it by a few, so 1e-5 (~20 ulp) holds the math
without depending on the order.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops/__init__ re-exports a function of the same name
jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

ATOL = 1e-5


def _inputs(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def _to3(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel_interpret(causal):
    """O and lse (nats) of the port's plain attention == the Pallas kernel
    run in interpret mode at S=64 with 16x16 tiles."""
    b, s, h, d = 2, 64, 3, 8
    q, k, v = _inputs(b, s, h, d)
    o3, lse3 = jfa._flash_fwd_pallas(
        _to3(q), _to3(k), _to3(v), jnp.zeros((b, s), jnp.float32), heads=h,
        block_q=16, block_k=16, out_dtype=jnp.float32, causal=causal,
        has_bias=False,
    )
    o_ref = np.asarray(o3).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    lse_ref = np.asarray(lse3).reshape(b, h, s)
    o, lse = tfa.flash_attention_core(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal
    )
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)


def test_plain_matches_pallas_kernel_with_padding_bias():
    """The key-padding mask of the plain version == the kernel's additive
    -1e30 bias (indexed per batch row, shared across heads)."""
    b, s, h, d = 2, 32, 2, 8
    q, k, v = _inputs(b, s, h, d, seed=1)
    keep = np.ones((b, s), bool)
    keep[0, 20:] = False
    keep[1, 5:] = False
    bias = np.where(keep, 0.0, jfa.NEG_BIG).astype(np.float32)
    o3, _ = jfa._flash_fwd_pallas(
        _to3(q), _to3(k), _to3(v), jnp.asarray(bias), heads=h, block_q=16,
        block_k=16, out_dtype=jnp.float32, causal=True, has_bias=True,
    )
    o_ref = np.asarray(o3).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    o = tfa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(keep)[:, None, None, :], causal=True,
    )
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)


@pytest.mark.parametrize("s", [24, 1032])
def test_matches_jax_flash_attention_wrapper(s):
    """Against the JAX wrapper with auto blocks: at S=24 it runs the kernel
    as one tile; at S=1032 the auto block (8) falls under the floor and it
    warns and takes its dense path.  The port has no such fallback and
    agrees with both."""
    b, h, d = 1, 2, 8
    q, k, v = _inputs(b, s, h, d, seed=s)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jfa._WARNED_FALLBACKS.clear()  # the fallback warns once per shape
    if s > jfa.AUTO_BLOCK_FLOOR and jfa._auto_block(s) < jfa.AUTO_BLOCK_FLOOR:
        with pytest.warns(UserWarning, match="falling back to dense"):
            want = jfa.flash_attention(jq, jk, jv, None, dtype=jnp.float32,
                                       causal=True)
    else:
        want = jfa.flash_attention(jq, jk, jv, None, dtype=jnp.float32,
                                   causal=True)
    got = tfa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), None, causal=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_lse_is_in_nats_and_first_row_attends_itself():
    """T1: lse is log(sum(exp(scores))) in natural base; under the causal
    triangle row 0 sees only key 0, so its output is v[0] exactly."""
    b, s, h, d = 1, 9, 2, 4
    q, k, v = (torch.from_numpy(x) for x in _inputs(b, s, h, d, seed=3))
    o, lse = tfa.flash_attention_core(q, k, v, causal=True)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    want = torch.log(torch.where(mask, scores.exp(), 0.0).sum(-1))
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o[:, 0], v[:, 0])


def test_cpu_tensor_never_launches_the_kernel():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 64))
    before = tfa.launches
    tfa.flash_attention(q, k, v, None, causal=True)
    tfa.flash_attention_core(q, k, v, causal=False)
    assert tfa.launches == before

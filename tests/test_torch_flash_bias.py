"""The key-padding bias of the port's flash attention against the JAX
package's Pallas kernels, on the CPU.

The port runs its kernels' plain versions here (CPU tensors); the JAX side
runs ``_flash_fwd_pallas`` / ``_flash_bwd_pallas`` with ``has_bias=True``
in interpret mode, with explicit 16 x 16 blocks so several q and k tiles
(and the causal skips) really run.  Inputs are made with numpy from a seed
and handed to both.  The masks come from the port's ``SyntheticTextDataset``
lengths, plus a row of length 1, a full row and a row with every key
masked: there the reference attends uniformly to the keys it can see by
position (its bias is an additive term), and so must the port.

Tolerances.  f32: 1e-5 absolute on O, lse and the gradients (values of
order 1; the Pallas kernel sums in another order and in base 2,
``tests/test_torch_flash_attention.py``).  A fully masked row's lse is
-1e30 * ln 2 on both sides, equal bit for bit (the port adds the bias in
nats as bias * ln 2, the reference in base 2 and converts at the end).
bf16: within one bf16 ulp of the largest |value|, the rule of
``tests/test_torch_bf16.py`` (both sides round P and dS to bf16 at the same
places and differ in the order of their f32 sums); lse stays f32.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTextDataset
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)  # the suite runs six workers on eight cores
# With torch's MKL vector math on the CPU, the first call of a function in
# a pytest-xdist worker process can come back at low accuracy (exp was seen
# 1.5e-4 relative off on its first call, within an ulp from the second call
# on); one warm-up call of each function the comparisons use, at import,
# keeps that first call out of every comparison.
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))

ATOL = 1e-5
B, S, H = 4, 32, 2
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _keep(b=B, s=S, seed=0):
    """[b, s] bool: a synthetic-text length, then lengths 1, s and 0."""
    batch = next(SyntheticTextDataset(length=b, seq_len=s, vocab_size=50,
                                      seed=seed).batches(b))
    keep = batch["attention_mask"].astype(bool)
    keep[1] = np.arange(s) < 1
    keep[2] = True
    keep[3] = False
    return keep


def _inputs(d, dtype, seed, n=4):
    """n numpy f32 [B, S, H, d] arrays, on the bf16 grid for bf16."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(np.float32))
        out.append(x.to(dtype).float().numpy())
    return out


def _to3(x, jdtype):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d), jdtype)


def _from3(x3):
    bh, s, d = x3.shape
    return np.asarray(jnp.asarray(x3, jnp.float32)).reshape(B, H, s, d).transpose(
        0, 2, 1, 3)


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _close(got, want, dtype, what):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    if dtype == torch.float32:
        np.testing.assert_allclose(g, want, atol=ATOL, err_msg=what)
        return
    top = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert float(np.abs(g - want).max()) <= ulp, (what, float(np.abs(g - want).max()), ulp)


def _pallas(q, k, v, do, bias, dtype, causal):
    jd = DTYPES[dtype][1]
    q3, k3, v3, do3 = (_to3(x, jd) for x in (q, k, v, do))
    kw = dict(heads=H, block_q=16, block_k=16, causal=causal, has_bias=True)
    o3, lse3 = jfa._flash_fwd_pallas(q3, k3, v3, jnp.asarray(bias),
                                     out_dtype=jd, **kw)
    grads = jfa._flash_bwd_pallas(q3, k3, v3, jnp.asarray(bias), o3, lse3, do3,
                                  **kw)
    return o3, lse3, grads


def test_mask_bias_is_the_references_bias_bitwise():
    keep = _keep()
    want = np.where(keep, 0.0, jfa.NEG_BIG).astype(np.float32)
    got = tfa._mask_bias(torch.from_numpy(keep)[:, None, None, :], B, S)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # a [B, S] 0/1 int mask broadcasts the same way
    got = tfa._mask_bias(torch.from_numpy(keep.astype(np.int32))[:, None, None, :],
                         B, S)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_forward_and_backward_with_bias_match_pallas(dtype, d, causal):
    """O, lse, dQ, dK and dV of the plain versions with the bias == the
    Pallas kernels with has_bias=True; backward from the Pallas forward's
    O and lse and the same dO."""
    tdt = DTYPES[dtype][0]
    q, k, v, do = _inputs(d, tdt, seed=d + 7 * causal)
    keep = _keep(seed=d)
    bias = np.where(keep, 0.0, jfa.NEG_BIG).astype(np.float32)
    o3, lse3, grads = _pallas(q, k, v, do, bias, dtype, causal)
    tq, tk, tv, tdo = (_t(x, tdt) for x in (q, k, v, do))
    tbias = torch.from_numpy(bias)
    o, lse = tfa._dense_attention(tq, tk, tv, tbias, causal=causal)
    assert o.dtype == tdt and lse.dtype == torch.float32
    _close(o, _from3(o3), tdt, "o")
    want_lse = np.asarray(lse3).reshape(B, H, S)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL)
    # the fully masked row: the reference's -1e30 * ln 2, bit for bit
    np.testing.assert_array_equal(lse.numpy()[3], want_lse[3])
    assert np.all(want_lse[3] < -6e29)
    o_ref = _t(_from3(o3), tdt)
    lse_ref = torch.from_numpy(np.array(want_lse))
    delta = (tdo.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    got = tfa._dense_attention_bwd(tq, tk, tv, tdo, lse_ref, delta,
                                   causal=causal, bias=tbias)
    for name, g, w in zip(("dq", "dk", "dv"), got, grads):
        assert g.dtype == tdt
        _close(g, _from3(w), tdt, name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fully_masked_row_attends_uniformly_to_what_it_sees(dtype, causal):
    """A row with every key masked: O is the mean of V over the keys it
    sees by position (all of them, or 0..r under the causal triangle), as
    the reference's additive bias gives, and not 0."""
    tdt = DTYPES[dtype][0]
    q, k, v = (_t(x, tdt) for x in _inputs(16, tdt, seed=3, n=3))
    bias = tfa._mask_bias(torch.from_numpy(_keep())[:, None, None, :], B, S)
    o, _ = tfa._dense_attention(q, k, v, bias, causal=causal)
    vf = v[3].float()
    if causal:
        want = vf.cumsum(0) / torch.arange(1, S + 1)[:, None, None]
    else:
        want = vf.mean(0, keepdim=True).expand(S, H, 16)
    _close(o[3], want.numpy(), tdt, "uniform mean")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_keys_get_exactly_zero_dk_dv(dtype, causal):
    """Through the autograd Function: every masked key of a row that sees
    any key gets dK = dV = 0 exactly (P = 0 there), and the unmasked keys
    do not; the fully masked row's keys are the exception, as in the
    reference (each of its queries attends to all of them)."""
    tdt = DTYPES[dtype][0]
    q, k, v, do = (_t(x, tdt).requires_grad_(True) for x in _inputs(32, tdt, seed=5))
    keep = _keep(seed=11)
    mask = torch.from_numpy(keep)[:, None, None, :]
    o = tfa.flash_attention(q, k, v, mask, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do.detach())
    masked = torch.from_numpy(~keep)
    masked[3] = False
    assert int(masked.sum()) > 0
    assert (dk[masked] == 0).all() and (dv[masked] == 0).all()
    seen = torch.from_numpy(keep)
    assert (dv[seen].abs().amax(-1) > 0).any()
    assert (dk[3] != 0).any() and (dv[3] != 0).any()


def test_flash_attention_wrapper_and_gradients_match_jax_with_mask():
    """The public wrapper with a [B, 1, 1, S] mask, f32, causal: output and
    jax.grad through the reference's flash_attention(block_q=block_k=16)
    == the port's output and autograd gradients."""
    q, k, v, do = _inputs(64, torch.float32, seed=9)
    keep = _keep(seed=2)
    jmask = jnp.asarray(keep)[:, None, None, :]

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, jmask, dtype=jnp.float32, block_q=16,
                                block_k=16, causal=True)
        return jnp.sum(o * jnp.asarray(do)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, torch.from_numpy(keep)[:, None, None, :],
                            causal=True)
    tg = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=ATOL)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_the_bias_gets_no_gradient():
    """As the reference's bwd returns zeros for bias2, the Function returns
    none: a bias that asks for a gradient gets nothing from it."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(16, torch.float32, seed=1, n=3))
    bias = tfa._mask_bias(torch.from_numpy(_keep())[:, None, None, :], B, S)
    bias.requires_grad_(True)
    o, _ = tfa.flash_attention_core(q, k, v, bias=bias)
    (g,) = torch.autograd.grad(o.sum(), (bias,), allow_unused=True,
                               materialize_grads=True)
    assert g is not None and (g == 0).all()


@pytest.mark.parametrize("jdtype", [jnp.bfloat16, jnp.float32])
def test_dtype_casts_the_output(jdtype):
    """``dtype=`` is the reference's out_dtype: f32 operands give bf16 O
    equal to the f32 O rounded once, as the JAX wrapper's."""
    q, k, v, _ = _inputs(32, torch.float32, seed=4)
    keep = _keep(seed=4)
    tdt = torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(keep)[:, None, None, :],
                              dtype=tdt)
    assert got.dtype == tdt
    want = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               jnp.asarray(keep)[:, None, None, :], dtype=jdtype,
                               block_q=16, block_k=16)
    assert want.dtype == jdtype
    full = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(keep)[:, None, None, :])
    assert torch.equal(got, full.to(tdt))
    _close(got, np.asarray(jnp.asarray(want, jnp.float32)), tdt, "o")


def test_make_flash_attention_binds_causal_and_refuses_a_mesh():
    q, k, v, _ = _inputs(16, torch.float32, seed=6)
    keep = torch.from_numpy(_keep())[:, None, None, :]
    fn = tfa.make_flash_attention(block_q=128, block_k=128, causal=True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    assert torch.equal(fn(*t, keep, dtype=torch.float32),
                       tfa.flash_attention(*t, keep, causal=True))

    class Mesh:
        size = 2
        shape = {"data": 2, "fsdp": 1, "tensor": 1}

    # a data mesh: each rank runs the kernels on its own rows
    on_mesh = tfa.make_flash_attention(mesh=Mesh(), causal=True)
    assert torch.equal(on_mesh(*t, keep, dtype=torch.float32),
                       tfa.flash_attention(*t, keep, causal=True))
    # a tensor mesh: each rank runs the kernels on its own heads (here the
    # first of the two), the mask whole
    Mesh.shape = {"data": 1, "fsdp": 1, "tensor": 2}
    local = [x[:, :, :1].contiguous() for x in t]
    on_heads = tfa.make_flash_attention(mesh=Mesh(), causal=True)
    torch.testing.assert_close(on_heads(*local, keep, dtype=torch.float32),
                               tfa.flash_attention(*t, keep, causal=True)[:, :, :1])


def test_cpu_tensors_with_a_mask_never_launch_a_kernel():
    counters = [c for c in dir(tfa) if c.startswith("launches")]
    assert len(counters) == 12
    before = {c: getattr(tfa, c) for c in counters}
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(64, torch.float32, seed=8, n=3))
    o = tfa.flash_attention(q, k, v, torch.from_numpy(_keep())[:, None, None, :])
    o.sum().backward()
    assert {c: getattr(tfa, c) for c in counters} == before

"""The port's decode attention (``distributeddeeplearning_tpu_torch.ops.
flash_decode``) against the JAX package, on the CPU.

The port runs the kernel's plain version here.  The JAX side runs its
Pallas kernel in interpret mode (``kernel="pallas"``, the dense cache
viewed as pages through ``_dense_as_pages``) and its legacy gather read
(``kernel="gather"``), which is bitwise what ``"auto"`` resolves to on the
CPU (T3).  Inputs come from numpy with a seed, positions are unequal per
slot, and the history past each slot's position holds stale values and
NaN: both sides must mask by position, never by content (T8).

Tolerance 1e-5 absolute against the Pallas kernel (online softmax over
32-position tiles: another summation order) and 5e-6 against the gather
read (the same einsum/softmax program, differing only in library
reduction order).  Outputs are ~1-3 in magnitude (one f32 ulp <= 2.4e-7);
the observed gap is a few ulp, and the margin keeps the tests independent
of the thread count's summation order.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import flash_decode as tfd

jfd = importlib.import_module("distributeddeeplearning_tpu.ops.flash_decode")

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

B, S, H, HD = 3, 160, 2, 8  # S=160 tiles into five 32-position blocks
POS = np.array([0, 77, S - 1], np.int32)


def _case(seed=0, stale=True):
    rng = np.random.default_rng(seed)
    q3 = rng.normal(size=(B, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    if stale:
        for b, p in enumerate(POS):
            k[b, p + 1:] = np.nan  # a quarantined previous occupant
            v[b, p + 1:] = 1e6  # stale, large, never weighted
    return q3, k, v


def _jax(q3, k, v, kernel):
    out = jfd.decode_attention_dense(
        jnp.asarray(q3), jnp.asarray(k), jnp.asarray(v), None, None,
        None, None, jnp.asarray(POS), kernel=kernel,
    )
    return np.asarray(out)


def _port(q3, k, v, kernel="auto"):
    return tfd.decode_attention_dense(
        torch.from_numpy(q3), torch.from_numpy(k), torch.from_numpy(v),
        None, None, None, None, torch.from_numpy(POS), kernel=kernel,
    ).numpy()


@pytest.mark.parametrize("jax_kernel,atol", [("pallas", 1e-5), ("gather", 5e-6)])
def test_plain_decode_matches_jax(jax_kernel, atol):
    q3, k, v = _case()
    want = _jax(q3, k, v, jax_kernel)
    assert np.isfinite(want).all()
    got = _port(q3, k, v)
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_array_equal(got, _port(q3, k, v, kernel="gather"))


def test_history_past_pos_never_read():
    """T8: stale and NaN history past ``pos`` changes nothing."""
    q3, k, v = _case(seed=2)
    _, k_clean, v_clean = _case(seed=2, stale=False)
    np.testing.assert_array_equal(_port(q3, k, v), _port(q3, k_clean, v_clean))


def test_pos_zero_attends_only_itself():
    q3, k, v = _case(seed=3)
    got = _port(q3, k, v)
    np.testing.assert_array_equal(got[0], v[0, 0])


def test_strided_cache_layer_view():
    """The dense cache's per-layer view is not contiguous; reading it in
    place gives what a contiguous copy gives."""
    q3, k, v = _case(seed=4, stale=False)
    cache_k = torch.zeros((B, 3, S, H, HD))
    cache_v = torch.zeros((B, 3, S, H, HD))
    cache_k[:, 1] = torch.from_numpy(k)
    cache_v[:, 1] = torch.from_numpy(v)
    assert not cache_k[:, 1].is_contiguous()
    got = tfd.decode_attention_dense(
        torch.from_numpy(q3), cache_k[:, 1], cache_v[:, 1], None, None, None,
        None, torch.from_numpy(POS),
    )
    np.testing.assert_array_equal(got.numpy(), _port(q3, k, v))


def test_paged_plain_matches_jax_pallas_multi_query():
    """The kernel contract beyond this slice's use: pages through a
    shuffled block table and several queries per slot, against the JAX
    Pallas kernel on the same pool."""
    rng = np.random.default_rng(5)
    ps, nb, nq = 8, 4, 3
    pool = B * nb + 1
    kp = rng.normal(size=(pool, ps, H, HD)).astype(np.float32)
    vp = rng.normal(size=(pool, ps, H, HD)).astype(np.float32)
    tables = (rng.permutation(pool - 1)[: B * nb] + 1).reshape(B, nb).astype(np.int32)
    posmat = np.array([[0, 9, 31], [5, 5, 20], [7, 8, 16]], np.int32)
    q4 = rng.normal(size=(B, nq, H, HD)).astype(np.float32)
    want = np.asarray(jfd._pallas_attention(
        jnp.asarray(q4), jnp.asarray(kp), jnp.asarray(vp), None, None,
        jnp.asarray(tables), jnp.asarray(posmat), block=ps,
    ))
    got = tfd.paged_attention(*(torch.from_numpy(x) for x in (q4, kp, vp, tables, posmat)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_resolve_kernel_contract():
    assert tfd.resolve_kernel("auto") == "flash"
    assert tfd.resolve_kernel("flash") == "flash"
    assert tfd.resolve_kernel("gather") == "gather"
    with pytest.raises(ValueError, match="unknown decode kernel"):
        tfd.resolve_kernel("pallas")


def test_int8_cache_is_a_later_slice():
    q3, k, v = (torch.from_numpy(x) for x in _case(stale=False))
    scales = torch.ones((B, S, H))
    with pytest.raises(NotImplementedError, match="slice 3"):
        tfd.decode_attention_dense(q3, k, v, scales, scales, None, None,
                                   torch.from_numpy(POS))


def test_cpu_tensor_never_launches_the_kernel():
    before = tfd.launches
    _port(*_case())
    assert tfd.launches == before

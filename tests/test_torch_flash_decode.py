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

The paged pool, chunked-prefill and int8 cases (the kernel's variants (b)
and (c)) are held to the JAX package's own bound, stated beside them.
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


# -- paged pools, chunked prefill and int8 (K4 variants (b) and (c)) --------
#
# Identical pools go to both sides: int8 codes and f32 scales are made
# with numpy, so only the attention's arithmetic differs.  Tolerance
# atol 2e-6 + rtol 1e-5, the JAX package's own bound between its Pallas
# kernel and its gather read (tests/test_flash_decode.py:196-198): outputs
# are ~1e-1..1, and the Pallas side sums in 8-position tiles.

PS, NB = 8, 4  # page 8 >= the reference's Pallas block floor
POOL = B * NB + 2


def _pools(rng, int8):
    """K/V pools [POOL, PS, H, HD] (int8 codes + f32 scales [POOL, PS, H],
    or f32), and scrambled block tables [B, NB] that never use page 0."""
    if int8:
        k, v = (rng.integers(-127, 128, size=(POOL, PS, H, HD), dtype=np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.1, size=(POOL, PS, H)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=(POOL, PS, H, HD)).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    tables = (rng.permutation(POOL - 1)[: B * NB] + 1).reshape(B, NB)
    return k, v, ks, vs, tables.astype(np.int32)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


ATOL, RTOL = 2e-6, 1e-5


@pytest.mark.parametrize("jax_kernel", ["pallas", "gather"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_decode_plain_matches_jax(jax_kernel, int8):
    """decode_attention_paged through scrambled tables, unequal positions
    (0, mid-page, the table's last position); on int8 with the exact
    in-flight token overlaid at each slot's position."""
    rng = np.random.default_rng(11)
    k, v, ks, vs, tables = _pools(rng, int8)
    q3, k_t, v_t = (rng.normal(size=(B, H, HD)).astype(np.float32)
                    for _ in range(3))
    pos = np.array([0, 13, NB * PS - 1], np.int32)
    want = np.asarray(jfd.decode_attention_paged(
        *map(_j, (q3, k, v, ks, vs, k_t, v_t, pos, tables)),
        page_size=PS, kernel=jax_kernel))
    got = tfd.decode_attention_paged(
        *map(_t, (q3, k, v, ks, vs, k_t, v_t, pos, tables))).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    gather = tfd.decode_attention_paged(
        *map(_t, (q3, k, v, ks, vs, k_t, v_t, pos, tables)), kernel="gather")
    np.testing.assert_array_equal(got, gather.numpy())


@pytest.mark.parametrize("jax_kernel", ["pallas", "gather"])
def test_int8_dense_decode_plain_matches_jax(jax_kernel):
    """The dense layout's int8 branch (dequantized history, own token
    overlaid), through the reference's dense page view."""
    rng = np.random.default_rng(12)
    k, v = (rng.integers(-127, 128, size=(B, S, H, HD), dtype=np.int8)
            for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.1, size=(B, S, H)).astype(np.float32)
              for _ in range(2))
    q3, k_t, v_t = (rng.normal(size=(B, H, HD)).astype(np.float32)
                    for _ in range(3))
    want = np.asarray(jfd.decode_attention_dense(
        *map(_j, (q3, k, v, ks, vs, k_t, v_t, POS)), kernel=jax_kernel))
    got = tfd.decode_attention_dense(
        *map(_t, (q3, k, v, ks, vs, k_t, v_t, POS))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("jax_kernel", ["pallas", "gather"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("offset", [0, 12])
def test_chunk_attention_plain_matches_jax(jax_kernel, int8, offset):
    """chunk_attention at b=1, nq=C over one scrambled table, at offset 0
    and at 12 (mid-page, the prefix-hit shape); no overlay on int8."""
    rng = np.random.default_rng(13 + offset)
    k, v, ks, vs, tables = _pools(rng, int8)
    C = 16
    q_c = rng.normal(size=(C, H, HD)).astype(np.float32)
    posns = (offset + np.arange(C)).astype(np.int32)
    want = np.asarray(jfd.chunk_attention(
        *map(_j, (q_c, k, v, ks, vs, tables[1], posns)),
        page_size=PS, kernel=jax_kernel))
    got = tfd.chunk_attention(*map(_t, (q_c, k, v, ks, vs, tables[1], posns)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_int8_nan_scale_fails_only_its_slot_and_only_when_visible():
    """A NaN scale is the int8 quarantine signal: at a visible position it
    makes that slot's output NaN and no other; past the slot's position it
    is never read."""
    rng = np.random.default_rng(14)
    k, v, ks, vs, tables = _pools(rng, True)
    q3, k_t, v_t = (torch.from_numpy(rng.normal(size=(B, H, HD)).astype(np.float32))
                    for _ in range(3))
    pos = torch.tensor([20, 20, 20], dtype=torch.int32)
    ks_t = torch.from_numpy(ks)
    ks_t[tables[0, 1], 3] = float("nan")  # slot 0, position 11: visible
    ks_t[tables[1, 3], 0] = float("nan")  # slot 1, position 24: past pos
    out = tfd.decode_attention_paged(
        q3, _t(k), _t(v), ks_t, _t(vs), k_t, v_t, pos, _t(tables))
    assert torch.isnan(out[0]).all()
    assert torch.isfinite(out[1:]).all()


def test_overlay_needs_one_query_and_an_int8_pool():
    rng = np.random.default_rng(15)
    k, v, ks, vs, tables = _pools(rng, True)
    own = torch.zeros((B, H, HD))
    q4 = torch.zeros((B, 2, H, HD))
    posmat = torch.zeros((B, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="single-query"):
        tfd.paged_attention(q4, _t(k), _t(v), _t(tables), posmat, _t(ks),
                            _t(vs), own, own)
    kf = torch.zeros((POOL, PS, H, HD))
    with pytest.raises(ValueError, match="int8"):
        tfd.paged_attention(q4[:, :1], kf, kf, _t(tables), posmat[:, :1],
                            None, None, own, own)


def test_cpu_tensor_never_launches_the_kernel():
    before = (tfd.launches, tfd.launches_int8, tfd.launches_multi_query)
    _port(*_case())
    rng = np.random.default_rng(16)
    k, v, ks, vs, tables = _pools(rng, True)
    q_c = torch.zeros((8, H, HD))
    tfd.chunk_attention(q_c, _t(k), _t(v), _t(ks), _t(vs), _t(tables[0]),
                        torch.arange(8))
    assert (tfd.launches, tfd.launches_int8, tfd.launches_multi_query) == before

"""The decode kernel's split-and-merge design, modelled on the CPU.

The CUDA kernel (``csrc/flash_decode.cu``) cuts each slot's history at
absolute positions into spans of ``SPAN`` positions, runs a
block per (span, head, slot) and merges the spans' online-softmax states
in a second pass.  It has no CPU mode, so these tests hold what the CPU
can reach:

- the Python helpers that size the split grid and scratch are functions
  of the number of addressable positions alone (so paged and dense reads
  of one history get the same grid);
- the wrapper's row checks ask for what the kernel's 16-byte copies need;
- the plain model of the two passes (``_split_merge_plain``) against the
  JAX Pallas kernel in interpret mode (``_pallas_attention``, as
  ``tests/test_torch_flash_decode.py`` runs it) and against the gather
  math (``_attend``), on histories that end at and across span
  boundaries, queries that leave later spans empty, stale history past
  each position, a NaN key and int8 pages with the own-token overlay;
- the plain model gives paged == dense bitwise at page sizes 4 and 16.

Tolerances are ``tests/test_torch_flash_decode.py``'s: 1e-5 absolute
against the Pallas kernel (it sums in page-sized tiles, the model in
spans), 5e-6 against the gather math (one softmax over the whole row);
outputs are ~1 in magnitude and the observed gaps are a few f32 ulps.
int8 pools hold dequantized values up to 12.7 (codes up to 127 times
scales up to 0.1; one f32 ulp there is 9.5e-7), and an output is a sum of
such terms in another order on each side, whatever its own size: they are
held to 2.5e-5 absolute, about 26 ulps of the largest term (the worst gap
seen is 1.1e-5).
"""

from __future__ import annotations

import importlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.ops import flash_decode as tfd

jfd = importlib.import_module("distributeddeeplearning_tpu.ops.flash_decode")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

B, H, HD = 3, 2, 16
PALLAS_TOL = dict(atol=1e-5, rtol=0)
ATTEND_TOL = dict(atol=5e-6, rtol=0)
INT8_TOL = dict(atol=2.5e-5, rtol=0)


# -- the grid and scratch helpers ----------------------------------------------

@pytest.mark.parametrize("positions", [64, 192, 576])
def test_split_grid_is_a_function_of_positions_alone(positions):
    """Every (nb, page size) that addresses ``positions`` positions gets one
    grid and one scratch shape; the count is the ceiling of positions over
    SPAN."""
    shapes = {tfd.scratch_shape(8, 5, 12, 64, (positions // ps) * ps)
              for ps in (4, 16, 64, positions)}
    assert shapes == {(8, 5, 12, -(-positions // tfd.SPAN), 66)}
    span = tfd.SPAN
    assert [tfd.split_count(n) for n in (1, span, span + 1)] == [1, 1, 2]


def test_span_mirrors_the_kernel_source():
    """The wrapper sizes the scratch with the SPAN the kernel is built with
    (the C entry point refuses any other split count)."""
    src = pathlib.Path(tfd.__file__).parent.parent / "csrc" / "flash_decode.cu"
    built = re.findall(r"constexpr int SPAN = (\d+);", src.read_text())
    assert built == [str(tfd.SPAN)]


@pytest.mark.parametrize("hd", tfd.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_row_check_takes_the_engines_layer_views(hd, dtype):
    """The per-layer views of a [P, L, ps, h, hd] pool and of a dense
    [slots, L, S, h, hd] cache start every row on 16 bytes."""
    for shape in ((5, 3, 4, 2, hd), (2, 3, 40, 2, hd)):
        view = torch.zeros(shape, dtype=dtype)[:, 1]
        assert not view.is_contiguous()
        tfd._check_rows("k_pages", view, (dtype,), 16)


def test_row_check_refuses_rows_off_16_bytes():
    pool = torch.zeros((4, 8, 2, 20))
    with pytest.raises(ValueError, match="16 bytes"):
        tfd._check_rows("k_pages", pool[..., 2:18], (torch.float32,), 16)
    narrow = torch.zeros((4, 8, 2, 24), dtype=torch.int8)[..., :16]
    with pytest.raises(ValueError, match="16 bytes"):
        tfd._check_rows("k_pages", narrow, (torch.int8,), 16)
    with pytest.raises(ValueError, match="contiguous head dim"):
        tfd._check_rows("q", torch.zeros((2, 1, 2, 16)).transpose(2, 3),
                        (torch.float32,), 0)
    # a query may be any strided slice with a contiguous head dim
    qkv = torch.zeros((2, 1, 3 * 2 * 16 + 1))
    tfd._check_rows("q", qkv[..., 1:33].reshape(2, 1, 2, 16), (torch.float32,), 0)


# -- the plain model against the Pallas kernel and the gather math -------------

PS, NB = 16, 12  # 192 positions: three spans of 64, twelve of 16
S = PS * NB


def _inputs(seed, int8=False, nq=1):
    """A scrambled [NB * B + 1, PS, H, HD] pool (int8 codes + f32 scales, or
    f32), tables that never use page 0, and queries."""
    rng = np.random.default_rng(seed)
    pool = NB * B + 1
    if int8:
        k, v = (rng.integers(-127, 128, size=(pool, PS, H, HD), dtype=np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.1, size=(pool, PS, H)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=(pool, PS, H, HD)).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    tables = (rng.permutation(pool - 1)[: B * NB] + 1).reshape(B, NB)
    q4 = rng.normal(size=(B, nq, H, HD)).astype(np.float32)
    return q4, k, v, ks, vs, tables.astype(np.int32), rng


def _poison_past(k, v, tables, posmat, key=np.nan, value=1e6):
    """Stale history past each slot's largest position: NaN keys and large
    values, as a quarantined previous occupant leaves them."""
    k, v = k.copy(), v.copy()
    for b in range(B):
        for t in range(int(posmat[b].max()) + 1, S):
            page, row = tables[b, t // PS], t % PS
            k[page, row] = key
            v[page, row] = value
    return k, v


def _pallas(q4, k, v, ks, vs, tables, posmat, own=(None, None)):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return np.asarray(jfd._pallas_attention(
        j(q4), j(k), j(v), j(ks), j(vs), j(tables), j(posmat), block=PS,
        k_own=j(own[0]), v_own=j(own[1])))


def _torch(*xs):
    """numpy to torch; bf16 arrays (ml_dtypes) by way of f32, which is exact."""
    def one(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.ascontiguousarray(x))
    return [one(x) for x in xs]


def _model(q4, k, v, ks, vs, tables, posmat, own=(None, None)):
    return tfd._split_merge_plain(*_torch(q4, k, v, tables, posmat, ks, vs,
                                          *own)).numpy()


def _gather(q4, k, v, ks, vs, tables, posmat, own=(None, None)):
    return tfd._paged_attention_plain(*_torch(q4, k, v, tables, posmat, ks, vs,
                                              *own)).numpy()


# positions at and around the span boundaries (SPAN 64)
BOUNDARY_POS = [[0, 63, 64, 65, 128, S - 1]]
MULTI_POS = np.array([[0, 5, 15, 16, 17], [63, 64, 65, 100, 127],
                      [128, 140, 150, 160, S - 1]], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 1, 2, 3, 4, 5])
def test_model_at_span_boundaries_matches_pallas(dtype, pos):
    """Decode (nq = 1) with each slot's last position at 0, SPAN-1, SPAN,
    SPAN+1, 2*SPAN or S-1 (one slot each), stale history past it; f32 or
    bf16 pages (widened to f32 on both sides)."""
    q4, k, v, _, _, tables, _ = _inputs(20 + pos)
    if dtype == "bfloat16":
        k, v = (x.astype(jnp.bfloat16) for x in (k, v))
    at = BOUNDARY_POS[0][pos]
    posmat = np.array([[at], [max(at - 1, 0)], [min(at + 1, S - 1)]], np.int32)
    kp, vp = _poison_past(k, v, tables, posmat)
    want = _pallas(q4, kp, vp, None, None, tables, posmat)
    assert np.isfinite(want).all()
    got = _model(q4, kp, vp, None, None, tables, posmat)
    np.testing.assert_allclose(got, want, **PALLAS_TOL)
    np.testing.assert_allclose(got, _gather(q4, k, v, None, None, tables, posmat),
                               **ATTEND_TOL)
    # the stale rows change nothing: not read, not weighted
    np.testing.assert_array_equal(
        got, _model(q4, k, v, None, None, tables, posmat))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_model_with_queries_leaving_spans_empty_matches_pallas(int8):
    """Five queries a slot (a verify pass's or a chunk's shape) with unequal
    last positions: the earlier queries leave the later spans of their
    slot empty, which must weigh nothing."""
    q4, k, v, ks, vs, tables, _ = _inputs(30 + int8, int8=int8, nq=5)
    want = _pallas(q4, k, v, ks, vs, tables, MULTI_POS)
    got = _model(q4, k, v, ks, vs, tables, MULTI_POS)
    np.testing.assert_allclose(got, want, **(INT8_TOL if int8 else PALLAS_TOL))
    np.testing.assert_allclose(got, _gather(q4, k, v, ks, vs, tables, MULTI_POS),
                               **(INT8_TOL if int8 else ATTEND_TOL))


def test_model_int8_with_overlay_matches_pallas():
    """int8 pages with f32 scales, the slot's exact in-flight K/V overlaid at
    its own position (decode), positions across span boundaries."""
    q4, k, v, ks, vs, tables, rng = _inputs(40, int8=True)
    own = tuple(rng.normal(size=(B, H, HD)).astype(np.float32) for _ in range(2))
    posmat = np.array([[0], [64], [S - 1]], np.int32)
    want = _pallas(q4, k, v, ks, vs, tables, posmat, own)
    got = _model(q4, k, v, ks, vs, tables, posmat, own)
    np.testing.assert_allclose(got, want, **INT8_TOL)
    np.testing.assert_allclose(got, _gather(q4, k, v, ks, vs, tables, posmat, own),
                               **INT8_TOL)
    # the overlay is read: another own token moves the output
    other = _model(q4, k, v, ks, vs, tables, posmat, (own[0], own[1] + 1))
    assert np.abs(other - got).max() > 1e-3


def test_model_nan_key_poisons_its_slot_only():
    """A NaN key at a visible position makes its slot's output NaN, as the
    Pallas kernel's does; the queries of that slot that do not reach it,
    and the other slots, stay finite."""
    q4, k, v, _, _, tables, _ = _inputs(50, nq=5)
    k = k.copy()
    k[tables[1, 70 // PS], 70 % PS] = np.nan  # slot 1, position 70
    want = _pallas(q4, k, v, None, None, tables, MULTI_POS)
    got = _model(q4, k, v, None, None, tables, MULTI_POS)
    np.testing.assert_allclose(got, want, **PALLAS_TOL)
    sees = MULTI_POS[1] >= 70
    assert np.isnan(got[1, sees]).all()
    assert np.isfinite(got[1, ~sees]).all()
    assert np.isfinite(got[[0, 2]]).all()


def test_model_nan_scale_poisons_its_slot_only_when_visible():
    q4, k, v, ks, vs, tables, rng = _inputs(51, int8=True)
    own = tuple(rng.normal(size=(B, H, HD)).astype(np.float32) for _ in range(2))
    posmat = np.array([[100], [100], [100]], np.int32)
    ks = ks.copy()
    ks[tables[0, 80 // PS], 80 % PS, 1] = np.nan  # slot 0, visible
    ks[tables[1, 150 // PS], 150 % PS, 0] = np.nan  # slot 1, past its position
    got = _model(q4, k, v, ks, vs, tables, posmat, own)
    assert np.isnan(got[0, :, 1]).all() and np.isfinite(got[0, :, 0]).all()
    assert np.isfinite(got[1:]).all()


# -- paged == dense, bitwise, in the plain model ---------------------------------

@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_model_paged_equals_dense_bitwise(ps, dtype):
    """The same history read through scrambled tables of ``ps``-position
    pages and as one dense page of S per slot (identity tables) gives the
    same bits; int8 with the overlay."""
    rng = np.random.default_rng(60 + ps)
    nb = S // ps
    k = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    ks = vs = None
    own = (None, None)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, size=(B, S, H, HD), dtype=np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.1, size=(B, S, H)).astype(np.float32)
                  for _ in range(2))
        own = tuple(torch.from_numpy(rng.normal(size=(B, H, HD)).astype(np.float32))
                    for _ in range(2))
    dense = [torch.from_numpy(x) if x is not None else None for x in (k, v, ks, vs)]
    if dtype == "bfloat16":
        dense[:2] = [t.bfloat16() for t in dense[:2]]
    tables = (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    pools = []
    for t in dense:
        if t is None:
            pools.append(None)
            continue
        pool = torch.zeros((B * nb + 1, ps) + tuple(t.shape[2:]), dtype=t.dtype)
        pool[torch.from_numpy(tables).long().reshape(-1)] = t.reshape(
            B * nb, ps, *t.shape[2:])
        pools.append(pool)
    q4 = torch.from_numpy(rng.normal(size=(B, 1, H, HD)).astype(np.float32))
    if dtype == "bfloat16":
        q4 = q4.bfloat16()
    posmat = torch.tensor([[0], [64], [S - 1]], dtype=torch.int32)
    ident = torch.arange(B, dtype=torch.int32)[:, None]
    a = tfd._split_merge_plain(q4, dense[0], dense[1], ident, posmat, dense[2],
                               dense[3], *own)
    p = tfd._split_merge_plain(q4, pools[0], pools[1], torch.from_numpy(tables),
                               posmat, pools[2], pools[3], *own)
    assert torch.isfinite(a).all()
    assert torch.equal(a, p)

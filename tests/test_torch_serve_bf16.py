"""bf16 serving in the port against the JAX package, on the CPU: bf16
weights on bf16 KV pages, dense and paged, through the decode kernel's
plain version (the default path) and the reference's gather read.

The reference serves whatever dtype the weights have, and its cache
defaults to that dtype (``serve/engine.py:364-365`` dense, ``:761-762``
paged); its Pallas decode kernel widens bf16 pages to f32 in the tile.  The
port's default path on the CPU runs the kernel's plain version, which
follows the Pallas arithmetic (every operand widened to f32, f32 out), and
``decode_kernel="gather"`` follows the reference's ``_gather_decode_*``
(scores from a bf16 product, softmax in f32, probabilities cast to the
value dtype, a bf16 product).  So the pairs held together here are: the
port's default engines against the JAX engines with
``decode_kernel="pallas"`` (interpret mode), and the port's gather engines
against the JAX engines' default (which is the gather read off the TPU).

Tolerances.  Greedy streams are held to EXACT equality on margin-profiled
weights (the tied 4x embedding head, ``tests/test_torch_serve.py``), whose
top-2 logit gaps dwarf bf16 rounding noise.  At these widths that profile
makes greedy repeat the last prompt token, so it cannot see attention;
the teacher-forced logits of the raw random init, which do depend on it,
are held to 2 bf16 ulps of the largest |logit| (the bound
``tests/test_torch_bf16.py`` states for the bf16 forward: two ulp-level
rounding differences of two libraries can meet in one logit).  The decode
kernel's plain version on bf16 inputs is f32 arithmetic on the same
values as the Pallas kernel's: 1e-5 absolute plus 1e-5 relative.  Inside
the port, paged and dense decode and a prefix hit and a cold run compute
the same arithmetic on the same values and are held BITWISE.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.serve import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    PagedInferenceEngine as JaxPagedEngine,
    Request as JaxRequest,
    cache_bytes as jax_cache_bytes,
    init_cache as jax_init_cache,
    init_paged_cache as jax_init_paged_cache,
    page_bytes as jax_page_bytes,
)
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.ops import flash_decode as tfd
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagedInferenceEngine,
    Request,
    cache_bytes,
    init_cache,
    init_paged_cache,
    page_bytes,
    synthetic_requests,
)

jfd = importlib.import_module("distributeddeeplearning_tpu.ops.flash_decode")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CFG = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=97,
           max_len=64)
HEADS, HD = CFG["num_heads"], CFG["d_model"] // CFG["num_heads"]
LOGIT_ULPS = 2
ATOL, RTOL = 1e-5, 1e-5
DENSE = dict(num_heads=HEADS, batch_slots=2, max_seq=32)
PAGED = dict(DENSE, page_size=8, prefill_chunk=8)  # page 8: the Pallas floor


def _ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest |x|."""
    top = float(np.abs(x).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_bf16(profile):
    p = jpt.init_params(jax.random.key(0), **CFG)
    if profile == "margin":
        p["embed"] = p["embed"] * 4.0
        p["head"] = p["embed"].T
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)


@pytest.fixture(scope="module", params=["margin", "raw"])
def weights(request):
    """(profile, JAX bf16 params, the port's copy of them)."""
    jp = _jax_bf16(request.param)
    return request.param, jp, tpt.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, CFG["vocab_size"], rng.integers(3, 20)).tolist()
            for i in range(n)}


# ---- the two repairs -------------------------------------------------------

def test_params_from_numpy_carries_bf16_leaves_bit_for_bit():
    """Repair: numpy's view of a JAX bf16 array has an extension dtype that
    ``torch.from_numpy`` refuses; every leaf now arrives as a torch bf16
    tensor with the same 16-bit patterns."""
    jp = _jax_bf16("raw")
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for name in ("embed", "pos", "head", "blocks"):
        want = jp[name]
        got = tp[name]
        pairs = ([(got[k], want[k]) for k in want] if isinstance(want, dict)
                 else [(got, want)])
        for g, w in pairs:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), np.asarray(w).view(np.int16))


def test_gather_scores_are_f32_before_the_division(monkeypatch):
    """Repair: the gather read's scores, the product of bf16 operands, are
    promoted to f32 before the division by sqrt(hd), as ``jnp`` promotes a
    bf16 array divided by an f32 one, so its softmax runs in f32; the
    output is in the value dtype and matches the reference's
    ``_gather_decode_dense`` on the same bf16 inputs within one bf16 ulp.
    (torch kept the division, and so the softmax, in bf16.)"""
    seen = []
    softmax = torch.softmax

    def spy(x, *args, **kwargs):
        seen.append(x.dtype)
        return softmax(x, *args, **kwargs)

    rng = np.random.default_rng(7)
    b, s, h, hd = 3, 40, 2, 32  # sqrt(32) is no power of two
    pos = np.array([0, 17, s - 1], np.int32)
    q3, k, v = (torch.from_numpy(3 * rng.normal(size=shape).astype(np.float32))
                .bfloat16() for shape in ((b, h, hd), (b, s, h, hd), (b, s, h, hd)))
    monkeypatch.setattr(torch, "softmax", spy)
    got = tfd._gather_decode_dense(q3, k, v, None, None, None, None,
                                   torch.from_numpy(pos))
    monkeypatch.undo()
    assert seen == [torch.float32] and got.dtype == torch.bfloat16
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    want = jfd._gather_decode_dense(j(q3), j(k), j(v), None, None, None, None,
                                    jnp.asarray(pos))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_ulp(_f32(want)), rtol=0)


# ---- the decode kernel's plain version on bf16 ---------------------------

@pytest.mark.parametrize("nq", [1, 4])
@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_bf16_plain_kernel_matches_pallas_interpret(nq, pages):
    """bf16 queries over bf16 pages (and over int8 pages, with the bf16
    own-token overlay at nq = 1): the kernel's plain version == the JAX
    ``_pallas_attention`` in interpret mode on the same values, page 8,
    a scrambled table, per-query positions; both return f32."""
    rng = np.random.default_rng(nq + len(pages))
    b, h, ps, nb = 3, HEADS, 8, 4
    pool = b * nb + 2
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).bfloat16()  # noqa: E731
    if pages == "int8":
        k, v = (torch.from_numpy(rng.integers(-127, 128, size=(pool, ps, h, HD),
                                              dtype=np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.1, size=(pool, ps, h))
                                   .astype(np.float32)) for _ in range(2))
    else:
        k, v = (bf(rng.normal(size=(pool, ps, h, HD))) for _ in range(2))
        ks = vs = None
    tables = torch.from_numpy((rng.permutation(pool - 1)[: b * nb] + 1)
                              .reshape(b, nb).astype(np.int32))
    q4 = bf(rng.normal(size=(b, nq, h, HD)))
    posmat = torch.from_numpy(np.sort(rng.integers(0, nb * ps, size=(b, nq)),
                                      axis=1).astype(np.int32))
    own = [None, None]
    if pages == "int8" and nq == 1:
        own = [bf(rng.normal(size=(b, h, HD))) for _ in range(2)]
    got = tfd.paged_attention(q4, k, v, tables, posmat, ks, vs, *own)
    assert got.dtype == torch.float32

    def j(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.numpy())

    want = np.asarray(jfd._pallas_attention(
        *map(j, (q4, k, v, ks, vs, tables, posmat)), block=ps,
        k_own=j(own[0]), v_own=j(own[1])))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ---- the engines against the JAX engines ---------------------------------

PAIRINGS = {  # port decode_kernel -> the JAX decode_kernel following the same math
    "gather": "auto",
    "auto": "pallas",
}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kernel", sorted(PAIRINGS))
def test_bf16_engines_match_jax_engines(weights, layout, kernel):
    """The same requests through the JAX engine and the port's on the same
    bf16 weights: both report bf16 weights on a bf16 cache of the same
    bytes; greedy streams are equal on margin-profiled weights."""
    profile, jp, tp = weights
    prompts = _prompts()
    kw = DENSE if layout == "dense" else PAGED
    jcls, tcls = ((JaxEngine, InferenceEngine) if layout == "dense"
                  else (JaxPagedEngine, PagedInferenceEngine))
    jeng = jcls(jp, decode_kernel=PAIRINGS[kernel], **kw)
    teng = tcls(tp, decode_kernel=kernel, device="cpu", **kw)
    assert (teng.kv_dtype, teng.weights_dtype) == (jeng.kv_dtype,
                                                   jeng.weights_dtype) == (
        "bfloat16", "bfloat16")
    assert teng.kv_bytes() == jax_cache_bytes(jeng.cache)
    jres, jrep = JaxScheduler(jeng, max_new_tokens=6).run(
        [JaxRequest(uid=u, prompt=p) for u, p in prompts.items()])
    tres, trep = ContinuousBatchingScheduler(teng, max_new_tokens=6).run(
        [Request(uid=u, prompt=p) for u, p in prompts.items()])
    assert trep.kv_bytes_peak == jrep.kv_bytes_peak
    assert (trep.kv_dtype, trep.weights_dtype) == ("bfloat16", "bfloat16")
    if profile == "margin":
        assert {r.uid: r.tokens for r in tres} == {r.uid: r.tokens for r in jres}


def _teacher_forced(prefill, decode, tokens, prompt_len):
    """Logits of the prompt's last position, then of one decode step per
    following token: [len(tokens) - prompt_len, vocab] as f32 numpy."""
    out = [prefill(tokens[:prompt_len])]
    for pos in range(prompt_len, len(tokens) - 1):
        out.append(decode(tokens[pos], pos))
    return np.stack(out)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kernel", sorted(PAIRINGS))
def test_bf16_teacher_forced_logits_match_jax(layout, kernel):
    """Raw weights, whose logits depend on attention: the prompt pass (the
    flash prefill on the dense layout, 8-token chunks on the paged one)
    then a decode step per token, bf16 cache, against the JAX model
    functions on the same bf16 weights and tokens."""
    jp = _jax_bf16("raw")
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(3).integers(1, CFG["vocab_size"], 26).tolist()
    plen, L, S, PS = 13, CFG["num_layers"], 32, 8
    jk = PAIRINGS[kernel]
    if layout == "dense":
        jc = {"c": jax_init_cache(batch_slots=1, num_layers=L, max_seq=S,
                                  num_heads=HEADS, head_dim=HD, dtype=jnp.bfloat16)}
        tc = init_cache(batch_slots=1, num_layers=L, max_seq=S, num_heads=HEADS,
                        head_dim=HD, dtype=torch.bfloat16, device="cpu")

        def jpre(toks):
            lg, k, v = jpt.forward_prefill(jp, jnp.asarray([toks], jnp.int32),
                                           num_heads=HEADS, attention="flash")
            jc["c"] = {"k": jc["c"]["k"].at[0, :, :len(toks)].set(k[0]),
                       "v": jc["c"]["v"].at[0, :, :len(toks)].set(v[0])}
            return _f32(lg[0, -1])

        def jdec(tok, pos):
            lg, jc["c"] = jpt.forward_decode(
                jp, jnp.asarray([tok], jnp.int32), jc["c"],
                jnp.asarray([pos], jnp.int32), num_heads=HEADS, kernel=jk)
            return _f32(lg[0])

        def tpre(toks):
            lg, k, v = tpt.forward_prefill(tp, torch.tensor([toks]),
                                           num_heads=HEADS, attention="flash")
            tc["k"][0, :, :len(toks)] = k[0]
            tc["v"][0, :, :len(toks)] = v[0]
            return _f32(lg[0, -1])

        def tdec(tok, pos):
            lg, _ = tpt.forward_decode(tp, torch.tensor([tok]), tc,
                                       torch.tensor([pos], dtype=torch.int32),
                                       num_heads=HEADS, kernel=kernel)
            return _f32(lg[0])
    else:
        nb = S // PS
        table = np.arange(nb, 0, -1, dtype=np.int32)  # reversed: pages 4..1
        jc = {"c": jax_init_paged_cache(num_pages=nb, num_layers=L, page_size=PS,
                                        num_heads=HEADS, head_dim=HD,
                                        dtype=jnp.bfloat16)}
        tc = init_paged_cache(num_pages=nb, num_layers=L, page_size=PS,
                              num_heads=HEADS, head_dim=HD, dtype=torch.bfloat16,
                              device="cpu")

        def jpre(toks):
            lg = None
            for off in range(0, len(toks), PS):
                lg, jc["c"] = jpt.forward_prefill_chunk(
                    jp, jnp.asarray([toks[off:off + PS]], jnp.int32), jc["c"],
                    jnp.asarray(table), jnp.int32(off), num_heads=HEADS,
                    page_size=PS, kernel=jk)
            return _f32(lg[0, (len(toks) - 1) % PS])

        def jdec(tok, pos):
            lg, jc["c"] = jpt.forward_decode_paged(
                jp, jnp.asarray([tok], jnp.int32), jc["c"],
                jnp.asarray([pos], jnp.int32), jnp.asarray(table[None]),
                num_heads=HEADS, page_size=PS, kernel=jk)
            return _f32(lg[0])

        def tpre(toks):
            lg = None
            for off in range(0, len(toks), PS):
                lg, _ = tpt.forward_prefill_chunk(
                    tp, torch.tensor([toks[off:off + PS]]), tc,
                    torch.from_numpy(table), off, num_heads=HEADS, kernel=kernel)
            return _f32(lg[0, (len(toks) - 1) % PS])

        def tdec(tok, pos):
            lg, _ = tpt.forward_decode_paged(
                tp, torch.tensor([tok]), tc, torch.tensor([pos], dtype=torch.int32),
                torch.from_numpy(table[None]), num_heads=HEADS, kernel=kernel)
            return _f32(lg[0])

    want = _teacher_forced(jpre, jdec, tokens, plen)
    got = _teacher_forced(tpre, tdec, tokens, plen)
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_ULPS * _ulp(want), (err, _ulp(want))


# ---- bitwise invariants inside the port ----------------------------------

@pytest.mark.parametrize("kernel", sorted(PAIRINGS))
def test_bf16_paged_decode_equals_dense_decode_bitwise(kernel):
    """Same bf16 cache contents, S a multiple of the page: the paged walk's
    logits and the dense walk's are the same bits at every position."""
    jp = _jax_bf16("raw")
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    b, S, PS, L = 2, 32, 8, CFG["num_layers"]
    nb = S // PS
    pool = init_paged_cache(num_pages=b * nb, num_layers=L, page_size=PS,
                            num_heads=HEADS, head_dim=HD, dtype=torch.bfloat16,
                            device="cpu")
    dense = init_cache(batch_slots=b, num_layers=L, max_seq=S, num_heads=HEADS,
                       head_dim=HD, dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(4)
    tables = torch.from_numpy((rng.permutation(b * nb) + 1).reshape(b, nb)
                              .astype(np.int32))
    toks = rng.integers(0, CFG["vocab_size"], (S, b)).astype(np.int32)
    for i in range(S):
        tok, pos = torch.from_numpy(toks[i]), torch.full((b,), i, dtype=torch.int32)
        a, _ = tpt.forward_decode_paged(tp, tok, pool, pos, tables,
                                        num_heads=HEADS, kernel=kernel)
        d, _ = tpt.forward_decode(tp, tok, dense, pos, num_heads=HEADS,
                                  kernel=kernel)
        assert a.dtype == torch.bfloat16 and torch.equal(a, d), f"position {i}"


def test_bf16_prefix_hit_equals_cold_run(weights):
    """Shared-prefix traffic (a 12-token prefix, page 4, chunk 16: hits
    start mid-chunk) on bf16 pages: the prefix cache hits and the streams
    equal a run without it; pages are accounted at 2 bytes an element."""
    _, _, tp = weights
    reqs = synthetic_requests(6, vocab_size=CFG["vocab_size"], max_prompt=12,
                              min_prompt=4, shared_prefix_len=12,
                              rng=np.random.default_rng(3))
    kw = dict(num_heads=HEADS, batch_slots=2, max_seq=48, page_size=4,
              prefill_chunk=16, device="cpu")

    def run(**extra):
        eng = PagedInferenceEngine(tp, **kw, **extra)
        res, rep = ContinuousBatchingScheduler(eng, max_new_tokens=6).run(
            [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs])
        eng.allocator.check()
        return {r.uid: r.tokens for r in res}, rep

    hit, hrep = run()
    cold, crep = run(prefix_cache=False)
    assert hrep.prefix_hit_rate > 0 and crep.prefix_hit_rate == 0
    assert hit == cold
    assert hrep.kv_dtype == "bfloat16"


def test_bf16_cache_layouts_and_bytes_match_the_reference():
    """``tests/test_serve.py:122-126``: a bf16 cache counts 2-byte
    elements — half an f32 cache of the same shape — in both layouts,
    and the port's shapes and bytes equal the reference's."""
    kw = dict(num_layers=2, num_heads=HEADS, head_dim=HD)
    dense = init_cache(batch_slots=2, max_seq=16, dtype=torch.bfloat16,
                       device="cpu", **kw)
    jdense = jax_init_cache(batch_slots=2, max_seq=16, dtype=jnp.bfloat16, **kw)
    pool = init_paged_cache(num_pages=5, page_size=4, dtype=torch.bfloat16,
                            device="cpu", **kw)
    jpool = jax_init_paged_cache(num_pages=5, page_size=4, dtype=jnp.bfloat16,
                                 **kw)
    for ours, ref in ((dense, jdense), (pool, jpool)):
        assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == {
            k: (tuple(v.shape), torch.bfloat16) for k, v in ref.items()}
    assert cache_bytes(dense) == jax_cache_bytes(jdense) == 2 * 2 * 2 * 16 * 2 * HEADS * HD
    assert page_bytes(pool) == jax_page_bytes(jpool) == cache_bytes(pool) // 6
    f32 = init_cache(batch_slots=2, max_seq=16, device="cpu", **kw)
    assert 2 * cache_bytes(dense) == cache_bytes(f32)

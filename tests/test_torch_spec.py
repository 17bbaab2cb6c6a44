"""The port's speculative decoding on the CPU (``forward_verify*``, ``spec/``
and the scheduler's spec mode) against the JAX package and against the
reference's own pins (``tests/test_spec.py``).

Parameters are the JAX test's RAW ``init_params`` at its CFG (4 layers,
d 32, 4 heads, ff 64, vocab 61): the margin profile makes greedy decoding
repeat the last prompt token at this size, which would hide attention;
raw weights give a shallow drafter real rejections (acceptance < 1).

Tolerances.
- Inside the port, one verify pass equals a sequential decode walk
  BITWISE on the CPU — logits and cache writes.  The plain attention
  computes each query column as a decode step computes its one query (the
  CUDA kernel's per-query independence), and the CPU GEMMs of two or more
  rows do not depend on the row count.  The card is checked separately
  (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
- Port vs JAX verify logits: ``atol 5e-5, rtol 1e-5`` with equal argmax,
  the other port tests' bound (~3e-9 measured).
- Greedy streams (spec vs non-spec inside the port, and port vs the JAX
  spec scheduler): exact; acceptance rates and step counts equal JAX's.
- Rollback: positions past the kept prefix are zero bitwise, and a
  forced-rejection run's cache equals a never-drafted run's bitwise
  (scratch page excluded: it is the dustbin for masked lanes).
"""

from __future__ import annotations

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
)
from distributeddeeplearning_tpu.spec import SpeculativeDecoder as JaxSpecDecoder
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagedInferenceEngine,
    Request,
    insert_sequence,
    synthetic_requests,
)
from distributeddeeplearning_tpu_torch.spec import (
    Drafter,
    SpeculativeDecoder,
    TruncatedDrafter,
    build_drafter,
)

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=4, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=64)
HEADS = CFG["num_heads"]
MAX_SEQ = CFG["max_len"]
ATOL, RTOL = 5e-5, 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jpt.init_params(jax.random.key(0), **CFG)


@pytest.fixture(scope="module")
def params(jparams):
    return tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _dense(params, slots=3, **kw):
    return InferenceEngine(params, num_heads=HEADS, batch_slots=slots,
                           max_seq=MAX_SEQ, device="cpu", **kw)


def _paged(params, slots=3, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return PagedInferenceEngine(params, num_heads=HEADS, batch_slots=slots,
                                max_seq=MAX_SEQ, device="cpu", **kw)


def _requests(n=7, seed=0):
    return [Request(uid=r.uid, prompt=list(r.prompt))
            for r in synthetic_requests(n, vocab_size=CFG["vocab_size"],
                                        max_prompt=12, min_prompt=3,
                                        rng=np.random.default_rng(seed))]


def _run(engine, spec_decoder=None, max_new_tokens=9, eos_id=None, reqs=None):
    results, report = ContinuousBatchingScheduler(
        engine, max_new_tokens=max_new_tokens, eos_id=eos_id,
        spec_decoder=spec_decoder,
    ).run(reqs if reqs is not None else _requests())
    return {r.uid: r.tokens for r in results}, report


def _jax_spec_run(jparams, layout, max_new_tokens=9, **spec_kw):
    kw = dict(num_heads=HEADS, batch_slots=3, max_seq=MAX_SEQ,
              rng=jax.random.key(1))
    if layout == "paged":
        eng = JaxPagedEngine(jparams, page_size=8, prefill_chunk=8, **kw)
    else:
        eng = JaxEngine(jparams, **kw)
    sd = JaxSpecDecoder(eng, draft_tokens=3, **spec_kw)
    results, report = JaxScheduler(eng, max_new_tokens=max_new_tokens,
                                   spec_decoder=sd).run(
        [JaxRequest(uid=r.uid, prompt=list(r.prompt)) for r in _requests()])
    return {r.uid: r.tokens for r in results}, report


# -- model level: one verify pass IS a sequential decode walk -----------------

B, K1, PLEN = 3, 4, 6


def _walk_inputs():
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, CFG["vocab_size"], (B, PLEN)).tolist()
    pend = rng.integers(1, CFG["vocab_size"], B).astype(np.int32)
    return prompts, pend


def _seeded(params, layout, prompts):
    eng = _dense(params, slots=B) if layout == "dense" else _paged(params, slots=B)
    for i, p in enumerate(prompts):
        if layout == "dense":
            _, k, v = tpt.forward_prefill(params, torch.tensor([p]), num_heads=HEADS)
            insert_sequence(eng.cache, k, v, i)
        else:
            eng.prefill(i, p, max_new_tokens=K1 + 2)
    return eng


def _verify(params, layout, eng, mat, pos, dlen, kernel="auto"):
    args = (params, torch.from_numpy(mat), eng.cache,
            torch.from_numpy(pos), torch.from_numpy(dlen))
    with torch.inference_mode():
        if layout == "dense":
            return tpt.forward_verify(*args, num_heads=HEADS, kernel=kernel)[0]
        return tpt.forward_verify_paged(*args, eng.device_tables(),
                                        num_heads=HEADS, kernel=kernel)[0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_equals_sequential_decode_bitwise_and_matches_jax(jparams, params,
                                                                 layout):
    """Per-position logits of ONE batched verify == K1 sequential decode
    steps, bitwise, with the same cache writes; and the JAX verify on the
    same inputs within the logit tolerance."""
    prompts, pend = _walk_inputs()
    eng_a = _seeded(params, layout, prompts)
    toks, pos = torch.from_numpy(pend.copy()), torch.full((B,), PLEN, dtype=torch.int32)
    walk = []
    with torch.inference_mode():
        for _ in range(K1):
            if layout == "dense":
                lg, _ = tpt.forward_decode(params, toks, eng_a.cache, pos,
                                           num_heads=HEADS)
            else:
                lg, _ = tpt.forward_decode_paged(params, toks, eng_a.cache, pos,
                                                 eng_a.device_tables(),
                                                 num_heads=HEADS)
            walk.append(lg.clone())
            toks, pos = torch.argmax(lg, -1).to(torch.int32), pos + 1
    walk = torch.stack(walk, dim=1).numpy()  # [B, K1, V]
    mat = np.zeros((B, K1), np.int32)
    mat[:, 0] = pend
    mat[:, 1:] = walk[:, :-1].argmax(-1)
    start, dlen = np.full(B, PLEN, np.int32), np.full(B, K1 - 1, np.int32)
    eng_b = _seeded(params, layout, prompts)
    got = _verify(params, layout, eng_b, mat, start, dlen).numpy()
    np.testing.assert_array_equal(got, walk)
    for key in ("k", "v"):
        assert torch.equal(eng_b.cache[key], eng_a.cache[key]), key

    # the JAX verify on the same caches and drafts
    jcache = {k: jnp.asarray(_seeded(params, layout, prompts).cache[k].numpy())
              for k in ("k", "v")}
    jargs = (jparams, jnp.asarray(mat), jcache, jnp.asarray(start), jnp.asarray(dlen))
    if layout == "dense":
        want, _ = jpt.forward_verify(*jargs, num_heads=HEADS)
    else:
        want, _ = jpt.forward_verify_paged(*jargs, jnp.asarray(eng_b.block_tables),
                                           num_heads=HEADS, page_size=8)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_verify_invalid_columns_write_nothing(params, layout):
    """Columns past ``draft_len`` leave the cache as it was (dense: their
    wrapped targets rewrite what is there; paged: the scratch page), and
    ``draft_len = 0`` is exactly a decode step."""
    prompts, pend = _walk_inputs()
    eng = _seeded(params, layout, prompts)
    before = {k: v.clone() for k, v in eng.cache.items()}
    mat = np.tile(pend[:, None], (1, K1)).astype(np.int32)
    start = np.array([PLEN, PLEN, MAX_SEQ - 2], np.int32)  # slot 2 near the end
    got = _verify(params, layout, eng, mat, start, np.array([0, 2, 1], np.int32))
    ref = _seeded(params, layout, prompts)
    with torch.inference_mode():
        if layout == "dense":
            step, _ = tpt.forward_decode(params, torch.from_numpy(pend), ref.cache,
                                         torch.from_numpy(start), num_heads=HEADS)
        else:
            step, _ = tpt.forward_decode_paged(
                params, torch.from_numpy(pend), ref.cache, torch.from_numpy(start),
                ref.device_tables(), num_heads=HEADS)
    assert torch.equal(got[0, 0], step[0])
    lo = 1 if layout == "paged" else 0
    written = {0: [PLEN], 1: [PLEN, PLEN + 1, PLEN + 2], 2: [MAX_SEQ - 2, MAX_SEQ - 1]}
    for key in ("k", "v"):
        after = eng.cache[key]
        for slot, where in written.items():
            if layout == "dense":
                row_a, row_b = after[slot], before[key][slot]
            else:
                pages = eng._slot_pages[slot]
                row_a = torch.cat([after[p] for p in pages], dim=1)
                row_b = torch.cat([before[key][p] for p in pages], dim=1)
            keep = torch.ones(row_a.shape[1], dtype=torch.bool)
            keep[[w for w in where if w < row_a.shape[1]]] = False
            assert torch.equal(row_a[:, keep], row_b[:, keep]), (key, slot)
        if layout == "paged":
            used = sorted({p for s in eng._slot_pages.values() for p in s})
            spare = [p for p in range(lo, after.shape[0]) if p not in used]
            assert torch.equal(after[spare], before[key][spare])


def test_verify_rejects_the_int8_cache(params):
    cache = {"k": torch.zeros((1, 1, 4, 2, 2), dtype=torch.int8),
             "v": torch.zeros((1, 1, 4, 2, 2), dtype=torch.int8),
             "k_scale": torch.zeros((1, 1, 4, 2)), "v_scale": torch.zeros((1, 1, 4, 2))}
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="f32 cache"):
        tpt.forward_verify(params, torch.zeros((1, 2), dtype=torch.int32), cache,
                           z, z, num_heads=HEADS)
    with pytest.raises(ValueError, match="f32 cache"):
        tpt.forward_verify_paged(params, torch.zeros((1, 2), dtype=torch.int32),
                                 cache, z, z, torch.zeros((1, 1), dtype=torch.int32),
                                 num_heads=HEADS)


# -- scheduler level: spec greedy == non-spec greedy == the JAX spec run -----

@pytest.fixture(scope="module")
def paged_baseline(params):
    return _run(_paged(params))


@pytest.mark.parametrize("drafter,kw", [
    ("truncated", dict(draft_layers=1)),   # shallow: real rejections
    ("truncated", dict(draft_layers=4)),   # full depth: acceptance 1.0
    ("int8", dict()),
])
def test_spec_greedy_paged_equals_baseline_and_jax(jparams, params, paged_baseline,
                                                   drafter, kw):
    base_tokens, base_rep = paged_baseline
    eng = _paged(params)
    sd = SpeculativeDecoder(eng, drafter=drafter, draft_tokens=3, **kw)
    tokens, rep = _run(eng, spec_decoder=sd)
    assert tokens == base_tokens
    jtokens, jrep = _jax_spec_run(jparams, "paged", drafter=drafter, **kw)
    assert tokens == jtokens
    assert (rep.acceptance_rate, rep.tokens_per_verify, rep.decode_steps) == (
        jrep.acceptance_rate, jrep.tokens_per_verify, jrep.decode_steps)
    assert rep.speculative and rep.drafter == drafter and rep.draft_tokens == 3
    assert rep.tokens_per_verify >= 1.0
    assert rep.draft_step_s["max"] > 0 and rep.verify_step_s["max"] > 0
    assert rep.decode_steps <= base_rep.decode_steps
    if kw.get("draft_layers") == 1:
        assert 0.0 < rep.acceptance_rate < 1.0  # rejections really happen
    if kw.get("draft_layers") == CFG["num_layers"]:
        assert rep.acceptance_rate == 1.0
        assert rep.decode_steps <= base_rep.decode_steps / 2
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


def test_spec_greedy_dense_equals_baseline_and_jax(jparams, params):
    base_tokens, _ = _run(_dense(params))
    eng = _dense(params)
    sd = SpeculativeDecoder(eng, drafter="truncated", draft_tokens=3, draft_layers=1)
    tokens, rep = _run(eng, spec_decoder=sd)
    assert tokens == base_tokens
    jtokens, jrep = _jax_spec_run(jparams, "dense", drafter="truncated",
                                  draft_layers=1)
    assert tokens == jtokens
    assert rep.acceptance_rate == jrep.acceptance_rate
    assert 0.0 < rep.acceptance_rate < 1.0


def test_int8_weight_engine_with_int8_drafter_reuses_its_tree(params):
    """An engine serving int8 weights drafts with its own tree: drafter ==
    verifier, acceptance 1.0, tokens equal the int8 engine's own."""
    from distributeddeeplearning_tpu_torch.quant.calibrate import quantize_params

    qparams = quantize_params(params)
    base, _ = _run(_paged(qparams))
    eng = _paged(qparams)
    sd = SpeculativeDecoder(eng, drafter="int8", draft_tokens=3)
    assert sd.drafter._dparams is eng.params
    tokens, rep = _run(eng, spec_decoder=sd)
    assert tokens == base and rep.acceptance_rate == 1.0
    assert rep.weights_dtype == "int8"


class _CacheScribblingGarbageDrafter(Drafter):
    """Proposes ``token`` every time AND writes real truncated K/V at the
    draft positions (the JAX test's adversary).  With a token the greedy
    streams never emit (:func:`_absent_token`), acceptance is 0, every
    step commits only the bonus token, and the rollback must erase every
    write.  (The JAX test proposes token 0, which these raw-weight streams
    do emit: there both packages measure acceptance 0.1379.)"""

    name = "garbage-scribble"

    def __init__(self, token: int, layers: int):
        self.token = token
        self.layers = layers

    def bind(self, engine):
        self._inner = TruncatedDrafter(self.layers)
        self._inner.bind(engine)

    def propose(self, cache, tokens, pos):
        _, cache = self._inner.propose(cache, tokens, pos)
        return torch.full_like(tokens, self.token), cache


def _absent_token(*streams) -> int:
    """The smallest token id none of the greedy ``streams`` emits."""
    seen = {t for stream in streams for toks in stream.values() for t in toks}
    return min(set(range(CFG["vocab_size"])) - seen)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_forced_rejection_rolls_back_to_the_never_drafted_cache(params, layout):
    build = _dense if layout == "dense" else _paged
    reqs = _requests(n=2)
    base_eng = build(params, slots=2)
    base_tokens, _ = _run(base_eng, reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    eng = build(params, slots=2)
    garbage = _CacheScribblingGarbageDrafter(_absent_token(base_tokens), 2)
    sd = SpeculativeDecoder(eng, drafter=garbage, draft_tokens=3)
    tokens, rep = _run(eng, spec_decoder=sd,
                       reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    assert tokens == base_tokens
    assert rep.acceptance_rate == 0.0
    assert rep.tokens_per_verify == 1.0
    lo = 1 if layout == "paged" else 0
    for key in base_eng.cache:
        assert torch.equal(eng.cache[key][lo:], base_eng.cache[key][lo:]), key


def _decoded_pair(params, build):
    """Two slots with bucket-aligned 8-token prompts and four decode steps
    (positions 8..11 written)."""
    eng = build(params, slots=2)
    for slot, p in enumerate((list(range(1, 9)), list(range(11, 19)))):
        if build is _paged:
            eng.prefill(slot, p, max_new_tokens=8)
        else:
            eng.prefill(slot, p)
    toks, pos = np.array([1, 2], np.int32), np.array([8, 8], np.int32)
    for _ in range(4):
        toks = eng.decode(toks, pos)
        pos = pos + 1
    return eng


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_rollback_equals_scrub_slot(params, layout):
    """The batched rollback is ``scrub_slot(slot, pos + keep)`` over the
    spec write horizon: slot 0 cut at 10, slot 1 at 9; positions below
    stay bitwise, the ones at and above are zero."""
    build = _dense if layout == "dense" else _paged
    eng_a, eng_b = _decoded_pair(params, build), _decoded_pair(params, build)
    sd = SpeculativeDecoder(eng_a, drafter="truncated", draft_layers=1,
                            draft_tokens=3)
    sd.rollback(np.array([8, 8], np.int32), np.array([2, 1], np.int32))
    eng_b.scrub_slot(0, 10)
    eng_b.scrub_slot(1, 9)
    lo = 1 if layout == "paged" else 0
    for key in eng_a.cache:
        assert torch.equal(eng_a.cache[key][lo:], eng_b.cache[key][lo:]), key
    before = _decoded_pair(params, build)
    for slot, cut in ((0, 10), (1, 9)):
        for key in ("k", "v"):
            if layout == "dense":
                row, ref = eng_a.cache[key][slot], before.cache[key][slot]
            else:
                row = torch.cat([eng_a.cache[key][p] for p in eng_a._slot_pages[slot]], 1)
                ref = torch.cat([before.cache[key][p] for p in before._slot_pages[slot]], 1)
            assert torch.equal(row[:, :cut], ref[:, :cut])
            assert not row[:, cut:12].any()


def test_rollback_never_writes_prefix_shared_pages(params):
    """Two slots share two full prefix pages; spec steps with total
    rejection (a rollback every step) leave those pages bitwise intact —
    rollback positions are >= pos + keep > the prompt length — and the
    streams equal plain decode's."""
    shared = list(range(1, 17))  # two full pages at page 8
    prompts = (shared + [21, 22], shared + [31, 32])

    def prefilled():
        eng = _paged(params, slots=2)
        first = [eng.prefill(slot, p, max_new_tokens=12)
                 for slot, p in enumerate(prompts)]
        return eng, np.array(first, np.int32)

    ref, toks = prefilled()
    pos = np.full(2, 18, np.int32)
    want = []
    for _ in range(6):
        toks = ref.decode(toks, pos)
        pos = pos + 1
        want.append(toks)
    eng, toks = prefilled()
    pages = eng._slot_pages[0][:2]
    assert pages == eng._slot_pages[1][:2]
    assert all(eng.allocator.is_shared(p) for p in pages)
    before = {k: v[pages].clone() for k, v in eng.cache.items()}
    garbage = _absent_token({"s": [int(t) for w in want for t in w]})
    sd = SpeculativeDecoder(eng, drafter=_CacheScribblingGarbageDrafter(garbage, 2),
                            draft_tokens=3)
    pos = np.full(2, 18, np.int32)
    for step in range(6):
        res = sd.step(toks, pos, np.full(2, 3, np.int32))
        assert (res.accepted == 0).all()
        sd.rollback(pos, res.accepted + 1)
        toks = res.tokens[:, 0].copy()
        np.testing.assert_array_equal(toks, want[step])
        pos = pos + 1
    for key, ref_pages in before.items():
        assert torch.equal(eng.cache[key][pages], ref_pages), key


def test_spec_step_never_writes_mid_prefill_pages(params):
    """The spec-mode case of ``tests/test_torch_paged.py``'s mid-prefill
    pin: drafter, verify and rollback read the engine's DECODE tables, so
    a slot whose prompt is still being chunked keeps its pages untouched
    while the other slot speculates."""
    rng = np.random.default_rng(7)
    long = rng.integers(1, CFG["vocab_size"], 20).tolist()
    short = rng.integers(1, CFG["vocab_size"], 5).tolist()
    eng = _paged(params, slots=2)
    sd = SpeculativeDecoder(eng, drafter=_CacheScribblingGarbageDrafter(0, 2),
                            draft_tokens=3)
    first = eng.prefill(0, short, 12)
    task = eng.prefill_begin(1, long, 4)
    assert eng.prefill_step(task) is None  # chunk 1 of 3
    assert (eng.block_tables[1] == 0).all()
    before = {k: v[task.pages].clone() for k, v in eng.cache.items()}
    tokens = np.array([first, 0], np.int32)
    pos = np.array([len(short), 0], np.int32)
    res = sd.step(tokens, pos, np.array([3, 0], np.int32))
    keep = np.array([int(res.accepted[0]) + 1, 4], np.int32)
    sd.rollback(pos, keep)
    for key, ref in before.items():
        assert torch.equal(eng.cache[key][task.pages], ref), key
    while (tok := eng.prefill_step(task)) is None:
        pass
    want = tpt.forward(params, torch.tensor([long]), num_heads=HEADS)[0, -1]
    assert tok == int(torch.argmax(want))


# -- guards, cuts and quarantine ---------------------------------------------

def test_spec_guards(params):
    with pytest.raises(ValueError, match="greedy-only"):
        SpeculativeDecoder(_paged(params, temperature=0.7), drafter="truncated",
                           draft_layers=1)
    with pytest.raises(ValueError, match="f32 KV cache"):
        SpeculativeDecoder(_paged(params, cache_dtype="int8"), drafter="truncated",
                           draft_layers=1)
    with pytest.raises(ValueError, match="draft_tokens"):
        SpeculativeDecoder(_paged(params), draft_tokens=0)
    with pytest.raises(ValueError, match="exceeds"):
        SpeculativeDecoder(_paged(params), drafter="truncated", draft_layers=5)
    eng_a, eng_b = _paged(params), _paged(params)
    sd = SpeculativeDecoder(eng_a, drafter="truncated", draft_layers=1)
    assert sd.draft_layers == 1
    with pytest.raises(ValueError, match="different engine"):
        ContinuousBatchingScheduler(eng_b, spec_decoder=sd)
    assert SpeculativeDecoder(eng_a).draft_layers == CFG["num_layers"] // 2


def test_build_drafter_validation():
    with pytest.raises(ValueError, match="draft_layers"):
        build_drafter("truncated")
    with pytest.raises(ValueError, match="unknown drafter"):
        build_drafter("telepathy")
    with pytest.raises(ValueError, match=">= 1"):
        build_drafter("truncated", draft_layers=0)
    assert build_drafter("int8").name == "int8"
    with pytest.raises(NotImplementedError):
        Drafter().propose(None, None, None)


def test_spec_eos_cut_matches_baseline(params):
    """An EOS landing inside a committed run cuts the stream exactly where
    the non-speculative run stops.  The EOS id is a token the free-running
    streams emit mid-stream, so the cut really happens."""
    reqs = _requests(n=6, seed=4)
    free, _ = _run(_paged(params), max_new_tokens=12,
                   reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    eos = free["req0"][5]
    base, _ = _run(_paged(params), eos_id=eos, max_new_tokens=12,
                   reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    eng = _paged(params)
    sd = SpeculativeDecoder(eng, drafter="truncated", draft_layers=4, draft_tokens=4)
    tokens, rep = _run(eng, spec_decoder=sd, eos_id=eos, max_new_tokens=12,
                       reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    assert tokens == base
    assert rep.finish_reasons.get("eos", 0) >= 1


def test_spec_budget_one_is_a_plain_decode(params):
    base, _ = _run(_paged(params), max_new_tokens=1)
    eng = _paged(params)
    sd = SpeculativeDecoder(eng, drafter="truncated", draft_layers=1, draft_tokens=3)
    tokens, rep = _run(eng, spec_decoder=sd, max_new_tokens=1)
    assert tokens == base
    assert rep.acceptance_rate is None  # no draft was ever proposed


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_poisoned_slot_fails_alone(params, layout):
    """A NaN in one slot's decode-written history fails that request
    alone; the survivor's stream equals the clean run's."""
    build = _dense if layout == "dense" else _paged
    reqs = _requests(n=2, seed=6)
    clean, _ = _run(build(params, slots=2), max_new_tokens=8,
                    reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    eng = build(params, slots=2)
    sd = SpeculativeDecoder(eng, drafter="truncated", draft_layers=1, draft_tokens=2)
    calls = []

    def step(tokens, pos, draft_len, _step=sd.step):
        calls.append(1)
        if len(calls) == 2:  # a decode-written position of slot 0
            eng.poison_slot(0, int(pos[0]) - 1)
        return _step(tokens, pos, draft_len)

    sd.step = step
    tokens, rep = _run(eng, spec_decoder=sd, max_new_tokens=8,
                       reqs=[Request(r.uid, list(r.prompt)) for r in reqs])
    assert rep.quarantined == 1 and rep.errors == 1
    survivors = [uid for uid, t in tokens.items() if len(t) == 8]
    assert len(survivors) == 1
    assert tokens[survivors[0]] == clean[survivors[0]]
    if layout == "paged":
        eng.allocator.check()
        assert eng.allocator.pages_in_use == 0


def test_spec_step_reads_back_once_and_reports_its_walls(params):
    eng = _dense(params, slots=2)
    sd = SpeculativeDecoder(eng, drafter="truncated", draft_layers=2, draft_tokens=2)
    first = eng.prefill(0, [3, 4, 5])
    res = sd.step(np.array([first, 0], np.int32), np.array([3, 0], np.int32),
                  np.array([2, 0], np.int32))
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == np.int32
    assert res.accepted.shape == (2,) and res.finite.dtype == bool
    assert 0 <= res.accepted[0] <= 2 and res.accepted[1] == 0
    assert res.draft_s >= 0 and res.verify_s >= 0
    assert eng.last_finite is res.finite

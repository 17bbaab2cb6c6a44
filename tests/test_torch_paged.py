"""The port's paged serving path on the CPU: the page allocator, the paged
model functions, :class:`PagedInferenceEngine` and the scheduler's
chunked-prefill interleave, against the JAX package and against the
reference's own pins (``tests/test_paged_cache.py``).

Tolerances.  Model logits: ``atol 5e-5, rtol 1e-5`` with equal argmax, the
JAX package's own bound between its kernel and its gather read over a
decode walk (``tests/test_flash_decode.py:147``); the port and JAX differ
by ~3e-9 here (f32 rounding of two libraries).  Inside the port, paged and
dense decode run the same plain version on the same history, so they are
held BITWISE.  Greedy streams are held to exact equality, on the raw
random init (whose streams depend on attention; see
``tests/test_torch_serve.py``).  The allocator is pure bookkeeping: the
same calls hand out the same page ids.
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
    OutOfPages as JaxOutOfPages,
    PageAllocator as JaxAllocator,
    PagedInferenceEngine as JaxPagedEngine,
    Request as JaxRequest,
    init_paged_cache as jax_init_paged_cache,
    synthetic_requests as jax_synthetic_requests,
)
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    OutOfPages,
    PageAllocator,
    PagedInferenceEngine,
    Request,
    cache_bytes,
    init_cache,
    init_paged_cache,
    insert_pages,
    page_bytes,
    pages_for,
    synthetic_requests,
)

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=3, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=64)
HEADS = CFG["num_heads"]
HD = CFG["d_model"] // HEADS
L = CFG["num_layers"]
ATOL, RTOL = 5e-5, 1e-5
DTYPES = {"f32": (None, None), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def jparams():
    return jpt.init_params(jax.random.key(0), **CFG)


@pytest.fixture(scope="module")
def params(jparams):
    return tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _paged(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("prefill_chunk", 8)
    return PagedInferenceEngine(params, num_heads=HEADS, device="cpu", **kw)


def _naive_greedy(params, prompt, n):
    """Oracle: greedy generation by a full dense forward every step."""
    toks = list(prompt)
    for _ in range(n):
        logits = tpt.forward(params, torch.tensor([toks]), num_heads=HEADS)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _run(engine, prompts, n, **kw):
    res, rep = ContinuousBatchingScheduler(engine, max_new_tokens=n, **kw).run(
        [Request(uid=u, prompt=p) for u, p in prompts.items()])
    return {r.uid: r.tokens for r in res}, rep, res


# -- allocator ---------------------------------------------------------------

def _allocator_ops(seed):
    """A random but valid op sequence over a 7-page pool."""
    rng = np.random.default_rng(seed)
    ops, live, keys = [], [], 0
    for _ in range(60):
        r = rng.random()
        if r < 0.3:
            ops.append(("alloc", int(rng.integers(0, 4))))
        elif r < 0.55 and live:
            ops.append(("decref", None))
        elif r < 0.7:
            ops.append(("register", keys))
            keys += 1
        elif r < 0.85:
            ops.append(("lookup_incref", int(rng.integers(0, keys + 1))))
        elif r < 0.9:
            ops.append(("clear", None))
        else:
            ops.append(("incref_live", None))
        live.append(0)
    return ops


def _drive(alloc, ops, out_of_pages):
    """Apply ``ops``; every decision that depends on the allocator's state
    reads it back, so two allocators diverge only if their answers do."""
    log, live = [], []
    for op, arg in ops:
        if op == "alloc":
            try:
                pages = alloc.alloc(arg)
            except out_of_pages:
                log.append(("oop", arg))
                continue
            live += pages
            log.append(("alloc", pages))
        elif op == "decref" and live:
            page = live.pop(len(live) // 2)
            alloc.decref(page)
            log.append(("decref", page))
        elif op == "register" and live:
            alloc.register_prefix((arg,), live[-1])
        elif op == "lookup_incref":
            page = alloc.lookup_prefix((arg,))
            if page is not None:
                alloc.incref(page)
                live.append(page)
            log.append(("lookup", page))
        elif op == "clear":
            alloc.clear_prefix()
        elif op == "incref_live" and live:
            alloc.incref(live[0])
            live.append(live[0])
        log.append((alloc.available, alloc.pages_in_use, alloc.prefix_entries))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_hands_out_the_reference_ids(seed):
    ops = _allocator_ops(seed)
    ours, ref = PageAllocator(7), JaxAllocator(7)
    got = _drive(ours, ops, OutOfPages)
    want = _drive(ref, ops, JaxOutOfPages)
    assert got == want
    ours.check()


def test_allocator_alloc_free_refcount_invariants():
    a = PageAllocator(6)
    pages = a.alloc(4)
    a.check()
    assert len(set(pages)) == 4 and all(1 <= p <= 6 for p in pages)
    a.incref(pages[0])
    a.decref(pages[0])
    assert a.refcount(pages[0]) == 1
    for p in pages:
        a.decref(p)
    a.check()
    assert a.available == 6
    with pytest.raises(ValueError, match="non-live"):
        a.decref(pages[0])
    with pytest.raises(OutOfPages):
        a.alloc(7)
    a.check()  # a failed alloc leaks no partial allocation
    assert a.available == 6


def test_allocator_prefix_reclaim_lru_and_clear():
    a = PageAllocator(3)
    pages = a.alloc(3)
    a.register_prefix(("k0",), pages[0])
    a.register_prefix(("k1",), pages[1])
    for p in pages:
        a.decref(p)
    a.check()
    assert a.available == 3 and a.lookup_prefix(("k0",)) == pages[0]
    a.incref(a.lookup_prefix(("k1",)))
    fresh = a.alloc(2)  # one free page, then k0 is the LRU victim
    a.check()
    assert a.lookup_prefix(("k0",)) is None and pages[0] in fresh
    assert a.lookup_prefix(("k1",)) == pages[1] and a.is_shared(pages[1])
    a.decref(pages[1])
    for p in fresh:
        a.decref(p)
    a.clear_prefix()
    a.check()
    assert a.available == 3 and a.prefix_entries == 0


# -- model functions against JAX ---------------------------------------------

PS, S, B = 8, 32, 2
NB = S // PS


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.permutation(B * NB + 2)[: B * NB] + 1).reshape(B, NB).astype(np.int32)


def _jax_pool(dtype):
    return jax_init_paged_cache(num_pages=B * NB + 2, num_layers=L, page_size=PS,
                                num_heads=HEADS, head_dim=HD,
                                dtype=dtype or jnp.float32)


def _pool(dtype, page_size=PS, num_pages=B * NB + 2):
    return init_paged_cache(num_pages=num_pages, num_layers=L,
                            page_size=page_size, num_heads=HEADS, head_dim=HD,
                            dtype=dtype or torch.float32, device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_paged_decode_walk_matches_jax(jparams, params, dtype):
    """Teacher-forced decode from an empty pool through scrambled tables,
    positions 0..15, against JAX ``forward_decode_paged`` (gather read)."""
    jdt, tdt = DTYPES[dtype]
    tables = _tables()
    toks = np.random.default_rng(5).integers(0, CFG["vocab_size"], (16, B)).astype(np.int32)
    jcache, cache = _jax_pool(jdt), _pool(tdt)
    for i in range(16):
        pos = np.full(B, i, np.int32)
        want, jcache = jpt.forward_decode_paged(
            jparams, jnp.asarray(toks[i]), jcache, jnp.asarray(pos),
            jnp.asarray(tables), num_heads=HEADS, page_size=PS, kernel="gather")
        got, _ = tpt.forward_decode_paged(
            params, torch.from_numpy(toks[i]), cache, torch.from_numpy(pos),
            torch.from_numpy(tables), num_heads=HEADS)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"position {i}")
        np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("offset", [0, 12])
def test_prefill_chunk_matches_jax(jparams, params, dtype, offset):
    """One 24-token chunk at offset 0 and at 12 (mid-page, the prefix-hit
    shape): logits against JAX; the written pages hold the reference's
    int8 codes where their inputs agree (a code on a rounding edge may
    sit one step apart, ~1e-9 of f32 difference in K/V)."""
    jdt, tdt = DTYPES[dtype]
    table = _tables()[0]
    prompt = np.arange(1, 25, dtype=np.int32)
    want, jcache = jpt.forward_prefill_chunk(
        jparams, jnp.asarray(prompt[offset:][None]), _jax_pool(jdt),
        jnp.asarray(table), jnp.int32(offset), num_heads=HEADS, page_size=PS,
        kernel="gather")
    got, cache = tpt.forward_prefill_chunk(
        params, torch.from_numpy(prompt[offset:][None]), _pool(tdt),
        torch.from_numpy(table), offset, num_heads=HEADS)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    for key, leaf in cache.items():
        ref = np.asarray(jcache[key])
        if leaf.dtype == torch.int8:
            assert np.abs(leaf.numpy().astype(int) - ref).max() <= 1
            assert (leaf.numpy() == ref).mean() > 0.99
        else:
            np.testing.assert_allclose(leaf.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_paged_decode_equals_dense_decode_bitwise(params, dtype):
    """Same cache contents, S a multiple of the page: the paged walk's
    logits and the dense walk's are the same bits at every position."""
    _, tdt = DTYPES[dtype]
    tables = _tables(1)
    pool = _pool(tdt)
    dense = init_cache(batch_slots=B, num_layers=L, max_seq=S, num_heads=HEADS,
                       head_dim=HD, dtype=tdt or torch.float32, device="cpu")
    toks = np.random.default_rng(6).integers(0, CFG["vocab_size"], (S, B)).astype(np.int32)
    for i in range(S):
        tok, pos = torch.from_numpy(toks[i]), torch.full((B,), i, dtype=torch.int32)
        a, _ = tpt.forward_decode_paged(params, tok, pool, pos,
                                        torch.from_numpy(tables), num_heads=HEADS)
        b, _ = tpt.forward_decode(params, tok, dense, pos, num_heads=HEADS)
        assert torch.equal(a, b), f"position {i}"


def test_chunked_prefill_matches_forward_and_insert_pages(params):
    """4-token chunks == the monolithic forward at every real position;
    the written pages equal ``insert_pages`` of forward_prefill's K/V."""
    prompt = np.random.default_rng(1).integers(1, CFG["vocab_size"], 12).tolist()
    full = tpt.forward(params, torch.tensor([prompt]), num_heads=HEADS)
    _, k, v = tpt.forward_prefill(params, torch.tensor([prompt]), num_heads=HEADS)
    cache = _pool(None, page_size=4, num_pages=4)
    table = torch.arange(1, 5, dtype=torch.int32)
    for off in range(0, 12, 4):
        logits, _ = tpt.forward_prefill_chunk(
            params, torch.tensor([prompt[off:off + 4]]), cache, table, off,
            num_heads=HEADS)
        np.testing.assert_allclose(logits[0].numpy(), full[0, off:off + 4].numpy(),
                                   atol=1e-5)
    ref = insert_pages(_pool(None, page_size=4, num_pages=4), k, v,
                       torch.tensor([1, 2, 3]), page_size=4)
    np.testing.assert_allclose(cache["k"][1:4].numpy(), ref["k"][1:4].numpy(),
                               atol=1e-6)
    assert page_bytes(ref) == cache_bytes(ref) // 5  # 4 pages + scratch


# -- engine and scheduler ----------------------------------------------------

@pytest.fixture(scope="module")
def shared_prefix_requests():
    """The reference's prefix pin: page 4, chunk 16, a 12-token shared
    prefix (not a chunk multiple, so hits start mid-chunk)."""
    return synthetic_requests(6, vocab_size=CFG["vocab_size"], max_prompt=12,
                              min_prompt=4, shared_prefix_len=12,
                              rng=np.random.default_rng(3))


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_paged_scheduler_matches_jax_paged_engine(jparams, params,
                                                  shared_prefix_requests, dtype):
    """The same shared-prefix traffic through the JAX paged engine and the
    port's: identical greedy streams, prefix hits, steps and page ids."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(num_heads=HEADS, batch_slots=2, max_seq=48, page_size=4,
              prefill_chunk=16)
    jeng = JaxPagedEngine(jparams, cache_dtype=jdt, **kw)
    jres, jrep = JaxScheduler(jeng, max_new_tokens=6).run(
        [JaxRequest(uid=r.uid, prompt=r.prompt) for r in shared_prefix_requests])
    eng = PagedInferenceEngine(params, cache_dtype=tdt, device="cpu", **kw)
    res, rep = ContinuousBatchingScheduler(eng, max_new_tokens=6).run(
        list(shared_prefix_requests))
    assert {r.uid: (r.tokens, r.finish_reason) for r in res} == {
        r.uid: (r.tokens, r.finish_reason) for r in jres}
    assert rep.prefix_hit_rate == jrep.prefix_hit_rate > 0
    assert rep.decode_steps == jrep.decode_steps
    assert rep.kv_bytes == jrep.kv_bytes and rep.kv_bytes_peak == jrep.kv_bytes_peak
    assert (rep.kv_layout, rep.kv_dtype) == ("paged", dtype.replace("f32", "float32"))
    assert eng.allocator._free == jeng.allocator._free
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_prefix_hit_at_non_chunk_multiple_equals_cold(params,
                                                      shared_prefix_requests, dtype):
    """``tests/test_flash_decode.py:238`` / ``tests/test_quant.py:308``:
    a hit whose shared length (12) is not a multiple of the chunk (16)
    decodes the same tokens as a run without the prefix cache."""
    _, tdt = DTYPES[dtype]
    kw = dict(batch_slots=2, max_seq=48, page_size=4, prefill_chunk=16,
              cache_dtype=tdt)
    prompts = {r.uid: r.prompt for r in shared_prefix_requests}
    hit_eng = _paged(params, **kw)
    hit, hrep, _ = _run(hit_eng, prompts, 6)
    cold, crep, _ = _run(_paged(params, prefix_cache=False, **kw), prompts, 6)
    assert hrep.prefix_hit_rate > 0 and crep.prefix_hit_rate == 0
    assert hit == cold
    hit_eng.allocator.check()


def test_paged_engine_matches_dense_engine_and_oracle(params):
    rng = np.random.default_rng(2)
    prompts = {f"r{i}": rng.integers(1, CFG["vocab_size"], rng.integers(2, 21)).tolist()
               for i in range(8)}
    dense = InferenceEngine(params, num_heads=HEADS, batch_slots=2, max_seq=32,
                            prefill_attention="dense", device="cpu")
    d, _, _ = _run(dense, prompts, 4)
    eng = _paged(params)
    p, rep, _ = _run(eng, prompts, 4)
    assert p == d
    for uid, toks in p.items():
        assert toks == _naive_greedy(params, prompts[uid], 4), uid
    assert rep.kv_layout == "paged" and rep.kv_bytes_peak < rep.kv_bytes
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


def test_prefix_cache_never_shares_decode_written_pages(params):
    base = [7, 3, 11, 9, 2, 5]  # 6 tokens, page 4: one full page
    eng = _paged(params, batch_slots=1)
    got, _, _ = _run(eng, {"a": base, "b": list(base)}, 4)
    want = _naive_greedy(params, base, 4)
    assert got == {"a": want, "b": want}
    assert eng.prefix_hit_tokens == 4  # only the FULL prompt page is shared


def test_out_of_pages_backpressure_and_oversized_request(params):
    """A pool smaller than the load queues requests (all complete,
    oracle-exact); a request larger than the POOL fails as an error."""
    rng = np.random.default_rng(4)
    prompts = {f"r{i}": rng.integers(1, CFG["vocab_size"], 8).tolist() for i in range(5)}
    eng = _paged(params, batch_slots=4, num_pages=6)
    got, rep, _ = _run(eng, prompts, 4)
    assert rep.finish_reasons == {"length": 5}
    for uid, toks in got.items():
        assert toks == _naive_greedy(params, prompts[uid], 4), uid
    assert rep.queue_wait_s["max"] > 0
    eng.allocator.check()
    assert eng.allocator.available == 6
    _, rep2, res2 = _run(eng, {"big": list(range(1, 28))}, 4)
    assert res2[0].finish_reason == "error" and "pool holds" in res2[0].error
    eng.allocator.check()


def test_engine_prefill_begin_validation_release_and_out_of_pages(params):
    eng = _paged(params, max_seq=16)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill_begin(0, [], 4)
    with pytest.raises(ValueError, match="no room"):
        eng.prefill_begin(0, list(range(1, 17)), 4)
    with pytest.raises(ValueError, match="slot"):
        eng.prefill_begin(5, [1, 2], 4)
    eng.prefill_begin(0, [1, 2, 3], 4)
    with pytest.raises(ValueError, match="still holds pages"):
        eng.prefill_begin(0, [4, 5], 4)
    assert eng.allocator.pages_in_use == pages_for(3 + 4, 4)
    eng.release(0)
    assert eng.allocator.pages_in_use == 0 and (eng.block_tables[0] == 0).all()
    tiny = _paged(params, max_seq=16, num_pages=2)
    tiny.prefill_begin(0, [1, 2, 3, 4, 5], 3)  # both pages
    with pytest.raises(OutOfPages):
        tiny.prefill_begin(1, [1, 2, 3, 4, 5], 3)
    tiny.allocator.check()
    assert eng.chunk_shapes(20) == {8} and _paged(
        params, max_seq=64, prefill_chunk=16).chunk_shapes(40) == {16, 8}


def test_decode_never_writes_mid_prefill_pages(params):
    """``tests/test_paged_cache.py:396``: a slot mid-chunked-prefill keeps
    its decode row at SCRATCH, so an interleaved decode step (whose stale
    lane writes at pos 0) leaves the prompt's pages untouched."""
    rng = np.random.default_rng(7)
    long = rng.integers(1, CFG["vocab_size"], 16).tolist()
    short = rng.integers(1, CFG["vocab_size"], 3).tolist()
    eng = _paged(params)
    first = eng.prefill(0, short, 4)
    task = eng.prefill_begin(1, long, 4)
    assert eng.prefill_step(task) is None  # chunk 1 of 2
    assert (eng.block_tables[1] == 0).all()
    before = eng.cache["k"][task.pages].clone()
    eng.decode(np.array([first, 0], np.int32), np.array([3, 0], np.int32))
    assert torch.equal(eng.cache["k"][task.pages], before)
    tok = eng.prefill_step(task)
    assert list(eng.block_tables[1][: len(task.pages)]) == task.pages
    assert tok == _naive_greedy(params, long, 1)[0]


def test_scrub_slot_refuses_shared_pages_and_keeps_positions_below(params):
    prefix = list(range(1, 9))  # two full pages
    eng = _paged(params)
    eng.prefill(0, prefix + [20, 21], 4)
    eng.prefill(1, prefix + [30, 31, 32], 4)  # maps the two shared pages
    assert eng.prefix_hit_tokens == 8
    with pytest.raises(ValueError, match="shared"):
        eng.scrub_slot(1, 2)
    pages = eng._slot_pages[1]
    keep = eng.cache["k"][pages[2], :, :1].clone()
    eng.scrub_slot(1, 9)  # position 9 is row 1 of the slot's third page
    assert torch.equal(eng.cache["k"][pages[2], :, :1], keep)
    assert not eng.cache["k"][pages[2], :, 1:].any()


def test_chunked_prefill_interleaves_and_mid_prefill_cancel(params):
    """A long prompt is prefilled one chunk per iteration while the short
    one decodes (short finishes first, both exact); a request cancelled
    mid-prefill releases its pages; step_cap cancels what is prefilling."""
    rng = np.random.default_rng(5)
    short = rng.integers(1, CFG["vocab_size"], 3).tolist()
    long = rng.integers(1, CFG["vocab_size"], 24).tolist()
    eng = _paged(params, max_seq=40)
    got, rep, res = _run(eng, {"short": short, "long": long}, 6)
    assert res[0].uid == "short" and rep.decode_steps >= 6
    assert got == {"short": _naive_greedy(params, short, 6),
                   "long": _naive_greedy(params, long, 6)}

    eng.clear_prefix_cache()  # so "long" runs all three chunks again
    sched = ContinuousBatchingScheduler(eng, max_new_tokens=6)
    eng.prefill_step = _cancel_after_first_chunk(eng, sched, "long")
    res, _ = sched.run([Request(uid="short", prompt=short),
                        Request(uid="long", prompt=long)])
    assert {r.uid: r.finish_reason for r in res} == {"short": "length",
                                                    "long": "cancelled"}
    assert eng.allocator.pages_in_use == 0
    del eng.prefill_step

    eng.clear_prefix_cache()
    _, rep, res = _run(eng, {"a": long, "b": long}, 6, step_cap=1)
    assert {r.uid: r.finish_reason for r in res} == {"a": "step_cap",
                                                    "b": "cancelled"}
    eng.allocator.check()
    assert eng.allocator.pages_in_use == 0


def _cancel_after_first_chunk(eng, sched, uid):
    step = eng.prefill_step

    def wrapped(task):
        out = step(task)
        if out is None:
            sched.request_cancel(uid)
        return out

    return wrapped


def test_synthetic_requests_shared_prefix_match_the_reference():
    kw = dict(vocab_size=61, max_prompt=6, min_prompt=2, shared_prefix_len=8)
    got = synthetic_requests(4, rng=np.random.default_rng(0), **kw)
    want = jax_synthetic_requests(4, rng=np.random.default_rng(0), **kw)
    assert [r.prompt for r in got] == [r.prompt for r in want]
    assert all(r.prompt[:8] == got[0].prompt[:8] for r in got)

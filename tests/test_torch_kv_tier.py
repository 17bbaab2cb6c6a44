"""The port's host page tier (``serve/kv_tier.py``, the allocator's tier
states, the paged engine's spill / restore verbs) held against the JAX
package — the cases of ``tests/test_kv_tier.py`` that need no fleet or
``bench.py`` — plus the ``capture_logits`` probe.

The load-bearing guarantee: a greedy stream over spilled-then-restored
pages equals the never-spilled run EXACTLY, on the f32 and int8 layouts,
and equals the reference's stream on the same requests; a spill moves raw
bytes, scales included, so a restored page equals the spilled one bit for
bit.  Scheduler runs are held to the reference's decisions
(``_torch_robust.assert_same_decisions``), spill and restore counts
included.  On the CPU the tier's copies are synchronous: a restore lands
when it returns and retires at the next ``poll`` (the card's asynchronous
copy is held in ``tests/test_torch_cuda_serve.py``).  Logits from
``capture_logits``: within 1e-5 of the largest |logit| of the reference's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_robust import (
    HEADS,
    assert_same_decisions,
    by_uid,
    engine_pair,
    make_params,
    run_pair,
)
from distributeddeeplearning_tpu.obs.ledger import HBMLedger as JaxLedger
from distributeddeeplearning_tpu.serve import (
    HostPageTier as JaxTier,
    PageAllocator as JaxAllocator,
    init_paged_cache as jax_init_paged_cache,
)
from distributeddeeplearning_tpu.serve import engine as jax_engine_mod
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.obs.ledger import HBMLedger
from distributeddeeplearning_tpu_torch.obs.registry import MetricsRegistry
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    HostPageTier,
    PageAllocator,
    Request,
    init_paged_cache,
)
from distributeddeeplearning_tpu_torch.serve import engine as engine_mod

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CFG = dict(num_layers=3, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=64)
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return make_params(0, cfg=CFG)


def _pair(params, *, host_pages=0, int8=False, num_pages=24, batch_slots=2,
          **kw):
    return engine_pair(params, "paged", int8=int8, batch_slots=batch_slots,
                       max_seq=48, page_size=4, num_pages=num_pages,
                       prefill_chunk=8, host_pages=host_pages, **kw)


def _tokens(results):
    return {r.uid: list(r.tokens) for r in results}


def _naive_greedy(tp, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits = tpt.forward(tp, torch.tensor([toks]), num_heads=HEADS)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _prefill_release(engine, prompt, slot=0, budget=4):
    task = engine.prefill_begin(slot, prompt, budget)
    while not task.done:
        engine.prefill_step(task)
    engine.release(slot)


# -- bit-identical spill/restore round trips -----------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_spill_restore_bit_identical(params, int8):
    """Greedy decode over spilled-then-restored prefix pages equals the
    never-spilled run, f32 and int8, with prompts ending mid-page and
    mid-chunk; each run equals the reference's, spill and restore counts
    included."""
    rng = np.random.default_rng(0)
    base = rng.integers(1, CFG["vocab_size"], 8).tolist()
    reqs = [Request(uid=f"r{n}", prompt=base + rng.integers(
        1, CFG["vocab_size"], n - 8).tolist()) for n in (9, 13, 17)]
    never_ref, never = run_pair(_pair(params, int8=int8), reqs, max_new_tokens=6)
    assert_same_decisions(never_ref, never)

    engines = _pair(params, int8=int8, host_pages=16)
    seeded_ref, seeded = run_pair(engines, reqs, max_new_tokens=6)
    assert_same_decisions(seeded_ref, seeded)
    assert _tokens(seeded[0]) == _tokens(never[0])
    jeng, teng = engines
    spilled = teng.spill_cold_pages(10**6)
    assert spilled == jeng.spill_cold_pages(10**6) > 0
    assert teng.allocator.host_entries == spilled
    ref, got = run_pair(engines, reqs, max_new_tokens=6)
    assert_same_decisions(ref, got)
    assert _tokens(got[0]) == _tokens(never[0]), \
        "decode over restored pages diverged from the never-spilled run"
    rep = got[1]
    assert teng.tier.restored_pages > 0
    assert rep.tier_enabled and rep.tier_restored_pages > 0
    assert teng.prefix_hit_tokens_host == jeng.prefix_hit_tokens_host > 0
    teng.allocator.check()
    teng.tier.check()
    if not int8:
        for r in reqs:
            assert _tokens(got[0])[r.uid] == _naive_greedy(params[1], r.prompt, 6)


def test_spill_restore_bit_identical_dense_cross_check(params):
    """The dense engine's tokens equal the paged engine's after a
    spill-restore round trip, on both packages."""
    rng = np.random.default_rng(3)
    reqs = [Request(uid=f"d{i}", prompt=rng.integers(1, CFG["vocab_size"],
                                                     11).tolist())
            for i in range(3)]
    dense_ref, dense = run_pair(
        engine_pair(params, "dense", batch_slots=2, max_seq=48), reqs,
        max_new_tokens=6)
    assert_same_decisions(dense_ref, dense)
    engines = _pair(params, host_pages=16)
    run_pair(engines, reqs, max_new_tokens=6)
    assert engines[1].spill_cold_pages(10**6) == engines[0].spill_cold_pages(10**6) > 0
    ref, got = run_pair(engines, reqs, max_new_tokens=6)
    assert_same_decisions(ref, got)
    assert _tokens(got[0]) == _tokens(dense[0])


# -- lifecycle rules -------------------------------------------------------------

def test_never_spill_a_decode_active_page(params):
    """A page a live sequence references never spills; released, it does."""
    _, eng = _pair(params, host_pages=8)
    task = eng.prefill_begin(0, list(range(1, 10)), 4)
    while not task.done:
        eng.prefill_step(task)
    assert eng.spill_cold_pages(10**6) == 0
    live_keys = list(eng.allocator._prefix)
    assert live_keys, "prefill registered no prefix pages"
    with pytest.raises(ValueError, match="live"):
        eng.allocator.spill_prefix(live_keys[0])
    eng.release(0)
    assert eng.spill_cold_pages(10**6) > 0
    eng.allocator.check()
    eng.tier.check()


def test_out_of_pages_spill_admit_recovery(params):
    """Exhaustion -> spill cold pages -> the same admission succeeds and
    restores the prefix from the host, as the reference's does."""
    engines = _pair(params, host_pages=16, num_pages=7)
    spilled, hits = [], []
    for eng in engines:
        _prefill_release(eng, list(range(1, 14)))
        reclaim = eng.allocator.reclaimable_pages
        assert reclaim > 0
        spilled.append(eng.spill_cold_pages(10**6))
        assert spilled[-1] == reclaim
        assert eng.allocator.free_pages >= spilled[-1]
        task = eng.prefill_begin(1, list(range(1, 14)), 4)
        hits.append(eng.prefix_hit_tokens_host)
        while not task.done:
            eng.prefill_step(task)
        eng.release(1)
        eng.allocator.check()
        eng.tier.check()
    assert spilled[0] == spilled[1]
    assert hits[0] == hits[1] > 0


def test_prefetch_inflight_pins_slot_and_drains(params):
    """A dispatched restore holds its host slot in the in-flight ledger
    until ``poll`` retires it; the engine's accessors mirror the state."""
    _, eng = _pair(params, host_pages=4)
    _prefill_release(eng, list(range(1, 10)))
    assert eng.spill_cold_pages(10**6) > 0
    tier = eng.tier
    key = next(iter(eng.allocator._host))
    used_before = tier.used_pages
    dev = tier.dispatch_restore(key)
    assert tier.inflight == 1
    assert tier.used_pages == used_before  # the slot is still pinned
    tier.check()
    # the restored leaves are the host slot's bytes exactly
    assert set(dev) == set(eng.cache)
    assert tier.poll() == 0
    assert tier.inflight == 0
    assert tier.used_pages == used_before - 1
    tier.check()
    assert eng.tier_inflight() == 0
    eng.drain_tier()


def test_host_pool_lru_eviction_and_policy():
    """A full host pool evicts its least recently used slot; fifo keeps
    spill order.  The same evictions as the reference's."""
    kw = dict(num_pages=8, num_layers=1, page_size=2, num_heads=1, head_dim=4)
    cache, jcache = init_paged_cache(device="cpu", **kw), jax_init_paged_cache(**kw)
    for policy, want in (("lru", ["b"]), ("fifo", ["a"])):
        tier, jtier = HostPageTier(cache, 2, policy=policy), JaxTier(jcache, 2, policy=policy)
        for t, c in ((tier, cache), (jtier, jcache)):
            assert t.spill_in(c, "a", 1) == []
            assert t.spill_in(c, "b", 2) == []
            t.touch("a")
            assert t.spill_in(c, "c", 3) == want
            assert t.dropped_pages == 1
            t.check()
        assert tier.has("c") and not tier.has(want[0])
    with pytest.raises(ValueError, match="policy"):
        HostPageTier(cache, 2, policy="mru")
    with pytest.raises(ValueError, match="host_pages"):
        HostPageTier(cache, 0)


# -- allocator invariants ----------------------------------------------------------

def test_check_catches_prefix_entry_naming_a_freed_page():
    """check() detects a prefix entry naming a page on the free list and
    a key resident in both tiers."""
    alloc = PageAllocator(8)
    (page,) = alloc.alloc(1)
    alloc.register_prefix(("k",), page)
    alloc.check()
    alloc.decref(page)
    alloc.check()
    del alloc._reclaim[page]
    alloc._free.append(page)
    with pytest.raises(AssertionError, match="freed page"):
        alloc.check()
    alloc._free.remove(page)
    alloc._reclaim[page] = None
    alloc.check()
    alloc._host[("k",)] = None
    with pytest.raises(AssertionError, match="resident and host"):
        alloc.check()


def test_tier_state_transitions_and_strictness():
    """The same transitions and refusals as the reference's allocator,
    page for page."""
    out = []
    for cls in (PageAllocator, JaxAllocator):
        alloc = cls(4)
        (page,) = alloc.alloc(1)
        alloc.register_prefix(("p",), page)
        assert alloc.tier_state(("p",)) == "resident"
        with pytest.raises(ValueError):
            alloc.spill_prefix(("p",))  # a live page never spills
        alloc.decref(page)
        freed = alloc.spill_prefix(("p",))
        assert alloc.tier_state(("p",)) == "host"
        assert alloc.lookup_prefix(("p",)) is None
        alloc.check()
        (fresh,) = alloc.alloc(1)
        alloc.restore_prefix(("p",), fresh)
        assert alloc.tier_state(("p",)) == "resident"
        alloc.check()
        with pytest.raises(KeyError):
            alloc.drop_host(("p",))
        out.append((page, freed, fresh, alloc.free_pages, alloc.host_entries))
    assert out[0] == out[1]


# -- scheduler: preemption spills, admission drains ---------------------------------

def test_preempted_stream_resumes_from_host_tier(params):
    """A preempted best_effort stream's private full pages spill to the
    host; the resume restores them, and its tokens equal the unpressured
    run — the reference's decisions and counts throughout."""
    rng = np.random.default_rng(1)
    be = Request(uid="be", prompt=rng.integers(1, CFG["vocab_size"], 8).tolist(),
                 priority="best_effort")
    prem = Request(uid="prem", prompt=rng.integers(1, CFG["vocab_size"], 5).tolist(),
                   priority="premium")
    clean_ref, clean = run_pair(_pair(params, host_pages=16, batch_slots=2),
                                [be, prem], max_new_tokens=16)
    assert_same_decisions(clean_ref, clean)
    engines = _pair(params, host_pages=16, batch_slots=1)
    ref, got = run_pair(engines, stages=((1, [be]), (14, [prem])),
                        max_new_tokens=16, preempt_budget=2)
    assert_same_decisions(ref, got)
    results, rep = got
    out = by_uid(results)
    assert out["be"].preemptions >= 1, "the cut never happened"
    assert rep.tier_preempt_spilled_pages >= 1
    assert engines[1].prefix_hit_tokens_host > 0
    assert _tokens(results) == _tokens(clean[0])
    engines[1].allocator.check()
    engines[1].tier.check()


def test_admission_drains_inflight_prefetch_before_preempting(params):
    """A restore left in flight when a request arrives under tight pages:
    admission fences it and admits normally."""
    outs = []
    for eng in _pair(params, host_pages=8, num_pages=7, batch_slots=1):
        _prefill_release(eng, list(range(1, 14)))
        assert eng.spill_cold_pages(10**6) > 0
        assert eng._prefetch_page(next(iter(eng.allocator._host))) is not None
        outs.append(eng)
    jeng, teng = outs
    ref, got = run_pair((jeng, teng), [Request(uid="x", prompt=list(range(1, 14)))],
                        max_new_tokens=4)
    assert_same_decisions(ref, got)
    assert got[0][0].finish_reason == "length"
    assert teng.tier_inflight() == 0
    teng.allocator.check()
    teng.tier.check()


def test_tier_disabled_is_inert(params):
    """host_pages=0: no tier, no report field moving."""
    _, eng = _pair(params)
    assert eng.tier is None
    results, rep = ContinuousBatchingScheduler(eng, max_new_tokens=6).run(
        [Request(uid="a", prompt=[1, 2, 3, 4, 5])])
    assert results[0].finish_reason == "length"
    assert not rep.tier_enabled
    assert rep.tier_spilled_pages == rep.tier_preempt_spilled_pages == 0
    assert eng.spill_cold_pages(10) == 0
    assert eng.tier_inflight() == 0
    eng.drain_tier()


# -- the ledger's host owner ---------------------------------------------------------

def test_ledger_attributes_host_bytes_outside_forecast(params):
    """``kv_host_pages`` attributes host bytes in snapshots and gauges but
    stays OUT of committed bytes and the forecast; the same bytes as the
    reference's owner."""
    jeng, teng = _pair(params, host_pages=8)
    jled, tled = JaxLedger(capacity_bytes=10**9), HBMLedger(capacity_bytes=10**9)
    jax_engine_mod._register_engine_owners(jeng, ledger=jled)
    engine_mod._register_engine_owners(teng, ledger=tled)
    assert tled.host_owners() == jled.host_owners() == ["kv_host_pages"]
    committed_before = tled.committed_bytes()
    assert committed_before == jled.committed_bytes()
    run_pair((jeng, teng), [Request(uid="a", prompt=list(range(1, 10)))],
             max_new_tokens=6)
    spilled = teng.spill_cold_pages(10**6)
    assert spilled == jeng.spill_cold_pages(10**6) > 0
    snap, jsnap = tled.snapshot(), jled.snapshot(reconcile=False)
    host_bytes = snap["host_owners"]["kv_host_pages"]["bytes"]
    assert host_bytes == spilled * teng.tier.page_host_bytes
    assert host_bytes == jsnap["host_owners"]["kv_host_pages"]["bytes"]
    assert snap["host_total_bytes"] == host_bytes
    assert tled.committed_bytes() <= committed_before
    assert tled.committed_bytes() == jled.committed_bytes()
    assert tled.forecast(0)["headroom_bytes"] >= 10**9 - committed_before
    reg = MetricsRegistry()
    tled.export_gauges(reg)
    gauges = reg.state()["gauges"]
    assert gauges["hbm.kv_host_pages.bytes"]["value"] == host_bytes
    assert gauges["hbm.host_total_bytes"]["value"] == host_bytes


def test_int8_spill_moves_scale_leaves():
    """An int8 host pool mirrors k/v AND k_scale/v_scale, a page's host
    bytes equal the reference's, and a spill copies the page's bytes
    exactly."""
    kw = dict(num_pages=8, num_layers=1, page_size=4, num_heads=2, head_dim=8)
    f32 = init_paged_cache(device="cpu", **kw)
    int8 = init_paged_cache(dtype=torch.int8, device="cpu", **kw)
    g = torch.Generator().manual_seed(0)
    int8["k"].copy_(torch.randint(-127, 128, int8["k"].shape, generator=g))
    int8["k_scale"].copy_(torch.rand(int8["k_scale"].shape, generator=g))
    t_f32, t_int8 = HostPageTier(f32, 2), HostPageTier(int8, 2)
    assert set(t_int8._pool) == set(int8) >= {"k_scale", "v_scale"}
    assert t_int8.page_host_bytes < t_f32.page_host_bytes / 2
    assert t_int8.page_host_bytes == JaxTier(
        jax_init_paged_cache(dtype=jnp.int8, **kw), 2).page_host_bytes
    assert t_f32.page_host_bytes == JaxTier(jax_init_paged_cache(**kw), 2).page_host_bytes
    t_int8.spill_in(int8, "k0", 1)
    for name in int8:
        assert torch.equal(t_int8._pool[name][t_int8._slots["k0"]], int8[name][1])
    back = t_int8.dispatch_restore("k0")
    for name in int8:
        assert torch.equal(back[name], int8[name][1])


# -- the fidelity probe ------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_capture_logits_matches_reference(params, int8):
    """``capture_logits`` keeps the last prefill's logits row and the last
    decode step's logits on the host, within 1e-5 of the largest |logit|
    of the reference engine's on the same teacher-forced walk."""
    jeng, teng = _pair(params, int8=int8, capture_logits=True)
    prompt = list(range(3, 14))
    jeng.prefill(0, prompt, max_new_tokens=6)
    teng.prefill(0, prompt, max_new_tokens=6)
    pairs = [(np.asarray(jeng.last_prefill_logits), teng.last_prefill_logits)]
    toks, pos = np.zeros(2, np.int32), np.zeros(2, np.int32)
    for i in range(5):
        toks[0], pos[0] = int(np.argmax(pairs[-1][0])), len(prompt) + i
        jeng.decode(toks, pos)
        teng.decode(toks, pos)
        pairs.append((np.asarray(jeng.last_logits)[0], teng.last_logits[0]))
    for ref, got in pairs:
        assert isinstance(got, np.ndarray) and got.shape == ref.shape
        assert np.abs(got - ref).max() <= LOGIT_RTOL * np.abs(ref).max()
        assert int(np.argmax(got)) == int(np.argmax(ref))

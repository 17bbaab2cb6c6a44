"""Live weight reload in the port (``reload_params`` on both engines, the
scheduler's ``request_reload`` idle barrier) held against the JAX package
— the cases of ``tests/test_reload.py`` that need no fleet.

Post-reload greedy tokens are held EXACTLY to a fresh engine built from
the new weights, and each run to the reference engine's on the same
requests (``_torch_robust.assert_same_decisions``).
"""

from __future__ import annotations

import pytest
import torch

from _torch_robust import (
    assert_same_decisions,
    engine_pair,
    make_params,
    run_pair,
)
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    Request,
)

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CFG = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=32)


@pytest.fixture(scope="module")
def params_old():
    return make_params(1, cfg=CFG)


@pytest.fixture(scope="module")
def params_new():
    return make_params(2, cfg=CFG)


def _dense(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 24)
    return engine_pair(params, "dense", **kw)


def _paged(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 24)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    return engine_pair(params, "paged", **kw)


REQS = [
    Request(uid="a", prompt=[5, 9, 2, 17]),
    Request(uid="b", prompt=[3, 3, 8]),
    Request(uid="c", prompt=[11, 4, 4, 4, 7]),
]


def _run(engine, reqs, **kw):
    res, rep = ContinuousBatchingScheduler(engine, max_new_tokens=6, **kw).run(
        [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs])
    return {r.uid: list(r.tokens) for r in res}, rep


def _reload_both(engines, params):
    """reload_params on the JAX engine and the port's."""
    engines[0].reload_params(params[0])
    engines[1].reload_params(params[1])


# -- engine-level swap ----------------------------------------------------------

@pytest.mark.parametrize("build", [_dense, _paged], ids=["dense", "paged"])
def test_reload_then_serve_matches_fresh_engine(build, params_old, params_new):
    """After reload_params the tokens equal a fresh engine's from the new
    weights, and the reference engine's after its own reload."""
    _, fresh = build(params_new)
    fresh_tokens, _ = _run(fresh, REQS)
    engines = build(params_old)
    run_pair(engines, REQS, max_new_tokens=6)  # a batch on the OLD weights
    _reload_both(engines, params_new)
    ref, got = run_pair(engines, REQS, max_new_tokens=6)
    assert_same_decisions(ref, got)
    reloaded = {r.uid: list(r.tokens) for r in got[0]}
    assert reloaded == fresh_tokens
    old_tokens, _ = _run(build(params_old)[1], REQS)
    assert reloaded != old_tokens, "the swap changed nothing"


@pytest.mark.parametrize("build", [_dense, _paged], ids=["dense", "paged"])
def test_reload_rejects_mismatched_tree(build, params_old):
    _, engine = build(params_old)
    bad = tpt.init_params(torch.Generator().manual_seed(3), device="cpu",
                          **{**CFG, "d_model": 64})
    with pytest.raises(ValueError, match="reload_params"):
        engine.reload_params(bad)
    cast = {k: ({kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict)
                else v.bfloat16()) for k, v in params_old[1].items()}
    with pytest.raises(ValueError, match="reload_params"):
        engine.reload_params(cast)
    missing = dict(params_old[1])
    del missing["pos"]
    with pytest.raises(ValueError, match="structure"):
        engine.reload_params(missing)


def test_reload_int8_weight_tree(params_old, params_new):
    """An engine serving int8 weights (QTensor leaves) reloads another
    int8 tree and equals a fresh engine of it; an f32 tree is refused."""
    from distributeddeeplearning_tpu_torch.quant.calibrate import quantize_params

    old, new = quantize_params(params_old[1]), quantize_params(params_new[1])
    engine = engine_pair((params_old[0], old), "paged", batch_slots=2, max_seq=24,
                         page_size=8, prefill_chunk=8)[1]
    engine.reload_params(new)
    fresh = engine_pair((params_new[0], new), "paged", batch_slots=2, max_seq=24,
                        page_size=8, prefill_chunk=8)[1]
    assert _run(engine, REQS)[0] == _run(fresh, REQS)[0]
    with pytest.raises(ValueError, match="reload_params"):
        engine.reload_params(params_new[1])


def test_paged_reload_refuses_live_slots(params_old, params_new):
    _, engine = _paged(params_old)
    engine.prefill_begin(0, [5, 9, 2], 4)
    with pytest.raises(ValueError, match="live slots"):
        engine.reload_params(params_new[1])


def test_paged_reload_drops_prefix_cache(params_old, params_new):
    """Prefix pages hold the OLD weights' K/V: the reload drops the table
    (and the host tier), and the post-reload run equals a fresh engine's
    and the reference's."""
    shared = [7, 7, 7, 7, 1, 2, 3, 4]  # one full page + remainder
    reqs = [Request(uid="p1", prompt=shared + [9]),
            Request(uid="p2", prompt=shared + [13])]
    engines = _paged(params_old, batch_slots=1, host_pages=4)
    run_pair(engines, reqs, max_new_tokens=6)
    teng = engines[1]
    assert teng.prefix_hit_tokens > 0
    assert teng.spill_cold_pages(1) == engines[0].spill_cold_pages(1) == 1
    assert teng.tier.used_pages == 1
    _reload_both(engines, params_new)
    assert teng.allocator.lookup_prefix(tuple(shared)) is None
    assert teng.allocator.host_entries == 0 and teng.tier.used_pages == 0
    ref, got = run_pair(engines, reqs, max_new_tokens=6)
    assert_same_decisions(ref, got)
    fresh, _ = _run(_paged(params_new, batch_slots=1)[1], reqs)
    assert {r.uid: list(r.tokens) for r in got[0]} == fresh


# -- the scheduler's idle barrier --------------------------------------------------

def test_request_reload_is_a_barrier_between_requests(params_old, params_new):
    """The in-flight request finishes on the OLD weights, the queued one is
    admitted after the barrier and decodes on the NEW weights, each equal
    to a single-weight-set run; the reference makes the same cut."""
    r1 = Request(uid="inflight", prompt=[5, 9, 2, 17])
    r2 = Request(uid="queued", prompt=[3, 3, 8])
    engines = _paged(params_old, batch_slots=1)
    applied = []
    scheds = {}

    def hook(side):
        def on_step(step):
            if not applied.count(side):
                applied.append(side)
                engine, new = engines[side], params_new[side]
                scheds[side].request_reload(lambda: engine.reload_params(new))
        return on_step

    from distributeddeeplearning_tpu.serve import ContinuousBatchingScheduler as J
    from _torch_robust import jax_request

    scheds[0] = J(engines[0], max_new_tokens=6)
    scheds[1] = ContinuousBatchingScheduler(engines[1], max_new_tokens=6)
    ref = scheds[0].run([jax_request(r) for r in (r1, r2)], on_step=hook(0))
    got = scheds[1].run([r1, r2], on_step=hook(1))
    assert_same_decisions(ref, got)
    tokens = {r.uid: list(r.tokens) for r in got[0]}
    old, _ = _run(_paged(params_old, batch_slots=1)[1], [r1])
    new, _ = _run(_paged(params_new, batch_slots=1)[1], [r2])
    assert tokens["inflight"] == old["inflight"]
    assert tokens["queued"] == new["queued"]
    assert not scheds[1].has_pending_reload


def test_request_reload_applies_before_first_admission(params_old, params_new):
    """A reload requested before run() applies at the first barrier."""
    _, engine = _paged(params_old)
    sched = ContinuousBatchingScheduler(engine, max_new_tokens=6)
    sched.request_reload(lambda: engine.reload_params(params_new[1]))
    assert sched.has_pending_reload
    res, _ = sched.run([Request(uid=r.uid, prompt=list(r.prompt)) for r in REQS])
    fresh, _ = _run(_paged(params_new)[1], REQS)
    assert {r.uid: list(r.tokens) for r in res} == fresh
    assert not sched.has_pending_reload


def test_failed_reload_keeps_serving_old_weights(params_old):
    """A raising reload is isolated: serving continues on the old set."""
    _, engine = _paged(params_old)
    sched = ContinuousBatchingScheduler(engine, max_new_tokens=6)

    def bad_reload():
        raise IOError("checkpoint store unreachable")

    sched.request_reload(bad_reload)
    res, rep = sched.run([Request(uid=r.uid, prompt=list(r.prompt)) for r in REQS])
    old, _ = _run(_paged(params_old)[1], REQS)
    assert {r.uid: list(r.tokens) for r in res} == old
    assert rep.errors == 0

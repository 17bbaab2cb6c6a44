"""The port's device-memory ledger (``obs/ledger.py``) and its owners held
against the JAX package's: the engines' ``params`` / ``kv_pages`` /
``kv_scales`` / ``kv_host_pages``, the speculative drafter's
``drafter_weights`` and the Trainer's ``params`` / ``opt_state`` /
``batch_stats`` — owner names, bytes and committed bytes — plus the weak
references, storage identity, the forecast and the host owners.

Bytes are exact: the same shapes in the same dtypes.  Where the port
differs by design it is pinned as such: a truncated drafter's blocks are
VIEWS of the engine's weights, so its owner adds no byte (the reference
slices copies); on the CPU there is no allocated-bytes counter, so a
reconciled snapshot reports nulls (the reference reconciles against
``jax.live_arrays()``).
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from _torch_robust import engine_pair, make_params, run_pair
from distributeddeeplearning_tpu.obs import ledger as jax_ledger_mod
from distributeddeeplearning_tpu.spec import SpeculativeDecoder as JaxSpec
from distributeddeeplearning_tpu_torch.obs.ledger import (
    HBMLedger,
    array_device_bytes,
    get_ledger,
    live_device_bytes,
    set_ledger,
)
from distributeddeeplearning_tpu_torch.obs.registry import MetricsRegistry
from distributeddeeplearning_tpu_torch.serve import Request
from distributeddeeplearning_tpu_torch.spec import SpeculativeDecoder

torch.set_num_threads(2)  # the suite runs six workers on eight cores


@pytest.fixture(scope="module")
def params():
    return make_params(0)


@pytest.fixture
def ledgers():
    """A fresh process ledger in each package, the old ones restored."""
    old, jold = get_ledger(), jax_ledger_mod.get_ledger()
    ours, ref = set_ledger(HBMLedger()), jax_ledger_mod.set_ledger(
        jax_ledger_mod.HBMLedger())
    yield ours, ref
    set_ledger(old)
    jax_ledger_mod.set_ledger(jold)


def _owners(snap):
    return {k: (v["bytes"], v["committed_bytes"]) for k, v in snap["owners"].items()}


def _snaps(ledgers):
    ours, ref = ledgers
    return ours.snapshot(reconcile=False), ref.snapshot(reconcile=False)


@pytest.mark.parametrize("layout,int8", [("dense", False), ("dense", True),
                                         ("paged", False), ("paged", True)])
def test_engine_owners_and_bytes_match_reference(params, ledgers, layout, int8):
    """An engine registers the reference's owners with the same bytes;
    a paged engine's committed bytes follow its pages in use, as the
    reference's do, through a run."""
    kw = dict(batch_slots=2, max_seq=32)
    if layout == "paged":
        kw.update(page_size=4, prefill_chunk=8, num_pages=12)
    engines = engine_pair(params, layout, int8=int8, **kw)
    ours, ref = _snaps(ledgers)
    want = {"params", "kv_pages"} | ({"kv_scales"} if int8 else set())
    assert set(ours["owners"]) == set(ref["owners"]) == want
    assert _owners(ours) == _owners(ref)
    assert ours["total_bytes"] == ref["total_bytes"]
    if layout == "paged":
        assert ours["committed_total_bytes"] == params_bytes(params)
        jeng, teng = engines
        for eng in engines:
            eng.prefill_begin(0, list(range(1, 11)), 6)
        ours, ref = _snaps(ledgers)
        assert _owners(ours) == _owners(ref)
        assert ours["owners"]["kv_pages"]["committed_bytes"] > 0
        assert ours["committed_total_bytes"] == ledgers[0].committed_bytes()


def params_bytes(params):
    return sum(np.asarray(x).nbytes for x in jax.tree.leaves(params[0]))


def test_weak_reference_drops_a_dead_engine(params, ledgers):
    """The ledger holds an engine weakly: dropped, its owners leave."""
    ours, _ = ledgers
    _, eng = engine_pair(params, "paged", batch_slots=1, max_seq=16, page_size=4,
                         prefill_chunk=8)
    assert set(ours.owners()) == {"params", "kv_pages"}
    del eng
    gc.collect()
    snap = ours.snapshot(reconcile=False)
    assert snap["owners"] == {} and snap["total_bytes"] == 0
    assert ours.owners() == []


def test_storage_counted_once_across_views_and_owners():
    """Two views of one storage, under two owners, are charged once (to
    the first registration); a plain dict target is held strongly and
    unregisters by handle."""
    led = HBMLedger()
    pool = torch.zeros(4, 8, 16)
    a = {"pool": pool, "view": pool[1]}
    b = {"again": pool[2:]}
    h = led.register("first", a, lambda t: t)
    led.register("second", b, lambda t: t)
    assert array_device_bytes(pool[1]) == pool.numel() * 4
    snap = led.snapshot(reconcile=False)
    assert snap["owners"]["first"]["bytes"] == pool.numel() * 4
    assert snap["owners"]["second"]["bytes"] == 0
    led.unregister(h)
    assert led.snapshot(reconcile=False)["owners"]["second"]["bytes"] == pool.numel() * 4


def test_reconciled_snapshot_on_the_cpu_reports_nulls(params, ledgers):
    """Without a card there is no allocated-bytes counter: the reconciled
    snapshot says so with nulls, and the capacity is None (the forecast
    admits) — the reference's CPU capacity is None too."""
    ours, ref = ledgers
    engine_pair(params, "dense", batch_slots=1, max_seq=16)
    assert live_device_bytes() is None
    snap = ours.snapshot()
    for key in ("live_bytes", "unaccounted_bytes", "unaccounted_pct",
                "residual_under_limit"):
        assert key in snap and snap[key] is None
    assert ours.capacity_bytes is None is ref.capacity_bytes
    assert ours.forecast(10**12) == {"capacity_bytes": None, "predicted_bytes": None,
                                     "headroom_bytes": None, "admit": True}
    assert ours.admit_ok(10**12)


def test_forecast_matches_reference(params, ledgers):
    """With an explicit capacity the forecast's numbers equal the
    reference's for the same engine and request; the watermark follows."""
    ours, ref = ledgers
    jeng, teng = engine_pair(params, "paged", batch_slots=2, max_seq=32,
                             page_size=4, prefill_chunk=8, num_pages=12)
    extra = teng.admit_bytes(10, 6)
    assert extra == jeng.admit_bytes(10, 6)
    cap = ours.committed_bytes() + extra
    ours.set_capacity(cap)
    ref.set_capacity(cap)
    assert ours.forecast(extra) == ref.forecast(extra)
    assert ours.admit_ok(extra) and not ours.admit_ok(extra + 1)
    assert ref.admit_ok(extra) and not ref.admit_ok(extra + 1)
    assert ours.peak_committed_bytes == ref.peak_committed_bytes > 0


def test_host_owner_stays_out_of_the_forecast(params, ledgers):
    """``kv_host_pages`` is attributed (snapshot, gauges, watermark) but
    never counted in committed bytes, as the reference's."""
    ours, ref = ledgers
    engines = engine_pair(params, "paged", batch_slots=2, max_seq=32, page_size=4,
                          prefill_chunk=8, host_pages=6)
    assert ours.host_owners() == ref.host_owners() == ["kv_host_pages"]
    before = ours.committed_bytes()
    run_pair(engines, [Request(uid="a", prompt=list(range(1, 14)))],
             max_new_tokens=4)
    n = engines[1].spill_cold_pages(10)
    assert n == engines[0].spill_cold_pages(10) > 0
    snap, jsnap = _snaps(ledgers)
    assert snap["host_owners"] == jsnap["host_owners"]
    assert snap["host_owners"]["kv_host_pages"]["peak_bytes"] == \
        n * engines[1].tier.page_host_bytes
    assert ours.committed_bytes() == ref.committed_bytes() <= before
    reg = MetricsRegistry()
    ours.export_gauges(reg)
    gauges = reg.state()["gauges"]
    assert gauges["hbm.kv_host_pages.bytes"]["value"] == \
        snap["host_total_bytes"]
    assert gauges["hbm.params.bytes"]["value"] == snap["owners"]["params"]["bytes"]


@pytest.mark.parametrize("drafter", ["truncated", "int8"])
def test_drafter_owner(params, ledgers, drafter):
    """The drafter registers ``drafter_weights``.  int8: the reference's
    bytes exactly (quantized copies).  Truncated: the port's blocks are
    views of the engine's weights, so the owner adds no byte, where the
    reference's sliced copies cost their bytes."""
    jeng, teng = engine_pair(params, "paged", batch_slots=2, max_seq=32,
                             page_size=4, prefill_chunk=8)
    kw = dict(drafter=drafter, draft_tokens=2)
    if drafter == "truncated":
        kw["draft_layers"] = 1
    decoders = SpeculativeDecoder(teng, **kw), JaxSpec(jeng, **kw)  # noqa: F841
    ours, ref = _snaps(ledgers)
    assert set(ours["owners"]) == set(ref["owners"]) >= {"drafter_weights"}
    got = ours["owners"]["drafter_weights"]["bytes"]
    want = ref["owners"]["drafter_weights"]["bytes"]
    if drafter == "int8":
        assert got == want > 0
    else:
        assert got == 0 < want
    assert ours["owners"]["params"] == ref["owners"]["params"]


def test_trainer_owners(ledgers):
    """The Trainer registers ``params`` / ``opt_state`` / ``batch_stats``
    once, read through the live state: after a fit the owners hold the
    final state's bytes, the reference's for params and batch stats."""
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
    from distributeddeeplearning_tpu_torch.train import loop as tloop
    from distributeddeeplearning_tpu_torch.train import schedule as tsched
    from distributeddeeplearning_tpu_torch.train import state as tstate

    ours, ref = ledgers
    cfg = dict(num_layers=1, d_model=16, num_heads=2, d_ff=32, vocab_size=31,
               max_len=8)
    params = tpt.init_params(torch.Generator().manual_seed(0), device="cpu", **cfg)
    st = tstate.TrainState.create(params=params, apply_fn=lambda *a, **k: None,
                                  tx=tstate.sgd_momentum(tsched.constant_schedule(0.1)))

    def step(state, batch):
        return state, {"loss": torch.tensor(1.0)}

    trainer = tloop.Trainer(step, config=tloop.TrainerConfig(
        epochs=1, steps_per_epoch=2, global_batch_size=2))
    trainer.fit(st, lambda start: iter([{}] * (2 - start)))
    trainer._register_hbm_owners()  # idempotent: no second registration
    snap = ours.snapshot(reconcile=False)
    assert set(snap["owners"]) == {"params", "opt_state", "batch_stats"}
    p_bytes = sum(t.numel() * t.element_size() for t in tstate.tree_leaves(params))
    jparams = make_params(0, cfg=cfg)[0]
    assert snap["owners"]["params"]["bytes"] == p_bytes == sum(
        np.asarray(x).nbytes for x in jax.tree.leaves(jparams))
    opt = [t for t in tstate.tree_leaves(st.opt_state) if isinstance(t, torch.Tensor)]
    assert snap["owners"]["opt_state"]["bytes"] == sum(
        t.numel() * t.element_size() for t in opt) > 0
    assert snap["owners"]["batch_stats"]["bytes"] == 0
    assert len(ours._providers) == 3
    del trainer
    gc.collect()
    assert ours.snapshot(reconcile=False)["owners"] == {}
    assert ours.owners() == []  # the walk pruned the dead providers
    # the reference's owners for the same state, for the names
    from distributeddeeplearning_tpu.train import loop as jloop

    jtrainer = object.__new__(jloop.Trainer)
    jtrainer._register_hbm_owners()
    assert ref.owners() == ["batch_stats", "opt_state", "params"]

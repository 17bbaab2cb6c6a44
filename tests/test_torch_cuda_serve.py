"""The host page tier on the card (run with ``python -m pytest --noconftest
tests/test_torch_cuda_serve.py``; skips without a card).

- a spill and restore is bitwise, on f32 pages and on int8 pages with their
  scale pages: the restore's asynchronous copy lands before the pool page
  is read;
- a restore in flight pins its host slot until its event completes: with
  the tier's copy stream held busy, ``poll`` keeps it in flight, a spill
  into the full pool finds no slot, and ``drain`` retires it;
- a tiered paged run (spill, then restore on a prefix hit) launches K4 and
  never the plain version, and its tokens equal the untiered run's;
- a two-replica paged fleet (``serve/fleet.py``: worker processes sharing
  the card, kernels built by the router before it spawns) serves tokens
  equal to the one-process engine's, each worker launching K4 and never
  loading jax.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CFG = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=97,
           max_len=64)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool(card, dtype):
    from distributeddeeplearning_tpu_torch.serve import init_paged_cache

    cache = init_paged_cache(num_pages=6, num_layers=2, page_size=16, num_heads=4,
                             head_dim=16, dtype=dtype, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    for name, leaf in cache.items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g,
                                     device=card, dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=card))
    return cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=["f32", "int8"])
def test_spill_restore_is_bitwise(card, dtype):
    from distributeddeeplearning_tpu_torch.serve import HostPageTier

    cache = _pool(card, dtype)
    want = {name: leaf[3].clone() for name, leaf in cache.items()}
    tier = HostPageTier(cache, 2)
    assert all(t.is_pinned() for t in tier._pool.values())
    assert tier.spill_in(cache, "k", 3) == []
    for leaf in cache.values():
        leaf[3].zero_()
        leaf[5].fill_(7)
    dev = tier.dispatch_restore("k")
    for name, t in dev.items():
        cache[name][5].copy_(t)  # on the compute stream, after the copy's event
    for name in cache:
        assert torch.equal(cache[name][5], want[name]), name
    tier.drain()
    assert tier.inflight == 0
    tier.check()


def test_restore_in_flight_pins_its_host_slot(card):
    from distributeddeeplearning_tpu_torch.serve import HostPageTier

    cache = _pool(card, torch.float32)
    tier = HostPageTier(cache, 1)
    tier.spill_in(cache, "k", 1)
    tier._stream = torch.cuda.Stream(card)
    with torch.cuda.stream(tier._stream):
        torch.cuda._sleep(2_000_000_000)  # ~1 s of the copy stream's time
    tier.dispatch_restore("k")
    assert tier.poll() == 1, "the restore retired before its copy ran"
    assert tier._free == [] and tier.used_pages == 1
    assert tier.spill_in(cache, "other", 2) is None, \
        "a spill took the host slot a restore is still reading"
    tier.check()
    tier.drain()
    assert tier.poll() == 0 and tier._free == [0]
    tier.check()


def test_tiered_paged_run_launches_k4_and_never_the_plain_version(card, monkeypatch):
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
    from distributeddeeplearning_tpu_torch.ops import flash_decode as fd
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, PagedInferenceEngine, Request,
    )

    params = tpt.init_params(torch.Generator().manual_seed(0), device=card, **CFG)
    prefix = list(range(1, 33))
    reqs = [Request(uid=f"r{i}", prompt=prefix + [40 + i, 50 + i]) for i in range(3)]

    def run(engine):
        res, rep = ContinuousBatchingScheduler(engine, max_new_tokens=6).run(
            [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs])
        return {r.uid: r.tokens for r in res}, rep

    plain = [0]
    orig = fd._paged_attention_plain

    def counted(*a, **k):
        plain[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(fd, "_paged_attention_plain", counted)
    kw = dict(num_heads=CFG["num_heads"], batch_slots=2, max_seq=48, page_size=8,
              prefill_chunk=8, device=card)
    untiered, _ = run(PagedInferenceEngine(params, **kw))
    engine = PagedInferenceEngine(params, host_pages=16, **kw)
    run(engine)
    assert engine.spill_cold_pages(10**6) > 0
    chunks, before = engine.chunks_run, fd.launches
    tiered, rep = run(engine)
    torch.cuda.synchronize()
    assert rep.tier_restored_pages > 0 and engine.prefix_hit_tokens_host > 0
    # K4 a layer for every chunk and every decode step of the run
    assert fd.launches - before == CFG["num_layers"] * (
        engine.chunks_run - chunks + rep.decode_steps) > 0
    assert plain[0] == 0
    assert tiered == untiered
    engine.allocator.check()
    engine.tier.check()


@pytest.mark.timeout(280)
def test_two_replica_paged_fleet_equals_the_one_process_engine(card):
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
    from distributeddeeplearning_tpu_torch.serve import (
        ContinuousBatchingScheduler, FleetRouter, PagedInferenceEngine, ReplicaSpec,
        Request, synthetic_requests,
    )

    kw = dict(num_heads=CFG["num_heads"], batch_slots=2, max_seq=64, page_size=16,
              prefill_chunk=16)
    reqs = synthetic_requests(6, vocab_size=CFG["vocab_size"], max_prompt=24,
                              rng=np.random.default_rng(0))
    router = FleetRouter(ReplicaSpec(model=dict(CFG), seed=0, kv_layout="paged",
                                     max_new_tokens=8, device="cuda", **kw),
                         replicas=2, faults="")
    try:
        results, report = router.serve(reqs)
    finally:
        router.terminate()
    params = tpt.init_params(torch.Generator().manual_seed(0), device=card, **CFG)
    want, _ = ContinuousBatchingScheduler(
        PagedInferenceEngine(params, device=card, **kw), max_new_tokens=8).run(
        [Request(uid=r.uid, prompt=list(r.prompt)) for r in reqs])
    assert {r.uid: r.tokens for r in results} == {r.uid: r.tokens for r in want}
    assert report.completed_ok == len(reqs) and report.lost_requests == 0
    for info in report.worker_info.values():
        assert info["device"].startswith("cuda") and info["jax_loaded"] is False
    counters = report.fleet_metrics["counters"]
    assert counters["kernels.flash_decode.launches"] > 0
    assert counters["kernels.flash_attention.launches"] == 0

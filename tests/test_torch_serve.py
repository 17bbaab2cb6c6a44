"""The port's serving stack (``distributeddeeplearning_tpu_torch.serve``) on
the CPU: the engine against a naive oracle, the scheduler against the JAX
scheduler, sampling, the NaN quarantine and the scheduler's terminal
states.

Greedy streams are held to EXACT equality.  Against the JAX scheduler
this runs on two weight sets: margin-profiled (tied 4x embedding head, the
reference's ``tests/test_tp_serve.py`` recipe), whose top-2 logit gaps
dwarf f32 reassociation noise — but under which greedy decoding at this
size merely repeats the last prompt token, so it cannot see attention —
and the raw random init, whose streams do depend on attention (the two
sides differ by ~3e-9 in logits of magnitude ~1e-2).  Temperature sampling
is held only to determinism within the port (``jax.random`` streams
cannot be reproduced).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.serve import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    Request as JaxRequest,
)
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
    prompt_bucket,
    sample_logits,
    synthetic_requests,
)

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=3, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=32)
HEADS = CFG["num_heads"]


def _jax_params(profile):
    p = jpt.init_params(jax.random.key(0), **CFG)
    if profile == "margin":
        p["embed"] = p["embed"] * 4.0
        p["head"] = p["embed"].T
    return p


@pytest.fixture(scope="module")
def params():
    return tpt.params_from_numpy(
        jax.tree.map(np.asarray, _jax_params("raw")), device="cpu")


def _engine(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_seq", 24)
    return InferenceEngine(params, num_heads=HEADS, device="cpu", **kw)


def _naive_greedy(params, prompt, n):
    """Oracle: greedy generation by a full dense forward every step."""
    toks = list(prompt)
    for _ in range(n):
        logits = tpt.forward(params, torch.tensor([toks]), num_heads=HEADS)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _prompts(n, seed=1, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, CFG["vocab_size"], rng.integers(lo, hi)).tolist()
            for i in range(n)}


def test_engine_greedy_matches_oracle(params):
    """Prefill (flash, padded bucket; T2: the first token comes from the
    last REAL position) then decode == full-forward greedy."""
    prompt = [5, 17, 3, 42, 8]
    engine = _engine(params)
    got = [engine.prefill(0, prompt)]
    pos = np.array([len(prompt), 0], np.int32)
    toks = np.array([got[0], 0], np.int32)
    for _ in range(4):
        out = engine.decode(toks, pos)
        got.append(int(out[0]))
        toks[0] = out[0]
        pos[0] += 1
        assert engine.last_finite.tolist() == [True, True]
    assert got == _naive_greedy(params, prompt, 5)
    assert prompt_bucket(len(prompt), 24) == 8  # the prompt really was padded


@pytest.mark.parametrize("profile", ["margin", "raw"])
@pytest.mark.parametrize("eos", [False, True])
def test_scheduler_matches_jax_scheduler(profile, eos):
    """One request set (more requests than slots, mixed lengths) through
    both schedulers: identical greedy streams and finish reasons."""
    jparams = _jax_params(profile)
    params = tpt.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    prompts = _prompts(7)
    jengine = JaxEngine(jparams, num_heads=HEADS, batch_slots=2, max_seq=24)
    eos_id = None
    if eos:
        probe, _ = JaxScheduler(jengine, max_new_tokens=6).run(
            [JaxRequest(uid="probe", prompt=prompts["r0"])])
        eos_id = probe[0].tokens[2]
    jres, jrep = JaxScheduler(jengine, eos_id=eos_id, max_new_tokens=6).run(
        [JaxRequest(uid=u, prompt=p) for u, p in prompts.items()])
    tres, trep = ContinuousBatchingScheduler(
        _engine(params), eos_id=eos_id, max_new_tokens=6
    ).run([Request(uid=u, prompt=p) for u, p in prompts.items()])
    want = {r.uid: (r.tokens, r.finish_reason) for r in jres}
    got = {r.uid: (r.tokens, r.finish_reason) for r in tres}
    assert got == want
    assert trep.finish_reasons == jrep.finish_reasons
    assert trep.generated_tokens == jrep.generated_tokens
    assert trep.requests == jrep.requests == 7
    if eos:
        assert trep.finish_reasons.get("eos", 0) >= 1


def test_continuous_batching_report(params):
    prompts = _prompts(5, seed=2)
    engine = _engine(params)
    results, report = ContinuousBatchingScheduler(engine, max_new_tokens=4).run(
        [Request(uid=u, prompt=p) for u, p in prompts.items()])
    for r in results:
        assert r.finish_reason == "length"
        assert r.tokens == _naive_greedy(params, prompts[r.uid], 4), r.uid
        assert 0 <= r.queue_wait_s <= r.ttft_s <= r.total_s
    assert report.generated_tokens == 20 and report.decode_steps >= 4
    assert 0 < report.slot_occupancy_mean <= 1
    assert report.ttft_s["p99"] >= report.ttft_s["p50"] > 0
    assert {"p50", "p90", "p99", "mean", "max"} <= set(report.tpot_s)
    assert report.kv_layout == "dense" and report.decode_kernel == "flash"
    assert report.kv_bytes == report.kv_bytes_peak == engine.kv_bytes() > 0
    assert report.prefill_compiles >= 1 and report.tokens_per_sec > 0


def test_top_k_keeps_exactly_k_lowest_index_first():
    """Ties at the k-th value go to the lowest indices (``lax.top_k``'s
    order): with index 7 the clear winner and 31 logits tied at 0, top-4
    may only ever emit {7, 0, 1, 2}."""
    vocab, k = 32, 4
    logits = torch.zeros((1, vocab))
    logits[0, 7] = 1.0
    seen = set()
    for step in range(200):
        g = torch.Generator().manual_seed(step)
        seen.add(int(sample_logits(logits, g, temperature=1.0, top_k=k)[0]))
    assert seen <= {7, 0, 1, 2} and len(seen) > 1
    two = torch.stack([logits[0], torch.roll(logits[0], 16)])
    assert sample_logits(two, torch.Generator().manual_seed(0), temperature=1.0,
                         top_k=1).tolist() == [7, 23]
    tied = torch.tensor([[0.5, 2.0, 2.0, 1.0]])
    assert sample_logits(tied, None).tolist() == [1]  # greedy: first max
    with pytest.raises(ValueError, match="top_k"):
        sample_logits(tied, None, temperature=1.0, top_k=0)


def test_temperature_sampling_reproducible(params):
    def run(seed):
        engine = _engine(params, batch_slots=1, max_seq=16, temperature=1.5,
                         seed=seed)
        res, _ = ContinuousBatchingScheduler(engine, max_new_tokens=6).run(
            [Request(uid="x", prompt=[3, 1, 4])])
        return res[0].tokens

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_nan_quarantine_fails_only_the_poisoned_slot(params):
    """A NaN key in one slot's decode-written history makes that slot's
    logits non-finite: it is scrubbed and fails alone, the other request
    completes correctly, and a later occupant of the scrubbed slot decodes
    exactly."""
    prompts = {"victim": [4, 9, 2], "other": [7, 7, 1, 3], "later": [5, 6]}
    engine = _engine(params)
    decode = engine.decode
    state = {"steps": 0}

    def poisoned_decode(tokens, pos):
        state["steps"] += 1
        if state["steps"] == 3:
            slot = 1  # the victim's slot (free.pop() admits into slot 1 first)
            engine.poison_slot(slot, int(pos[slot]) - 1)
        return decode(tokens, pos)

    engine.decode = poisoned_decode
    results, report = ContinuousBatchingScheduler(engine, max_new_tokens=5).run(
        [Request(uid=u, prompt=p) for u, p in prompts.items()])
    by = {r.uid: r for r in results}
    assert by["victim"].finish_reason == "error"
    assert "non-finite" in by["victim"].error
    assert report.quarantined == 1 and report.errors == 1
    for uid in ("other", "later"):
        assert by[uid].finish_reason == "length"
        assert by[uid].tokens == _naive_greedy(params, prompts[uid], 5), uid
    assert torch.isfinite(engine.cache["k"]).all()  # scrubbed


def test_eos_step_cap_budget_cancel_deadline(params):
    prompt = [7, 3, 11]
    dry = _naive_greedy(params, prompt, 8)
    # EOS id: the first generated token not seen before it
    cut = next(i for i in range(1, 8) if dry[i] not in dry[:i])
    engine = _engine(params, batch_slots=1, max_seq=16)
    res, rep = ContinuousBatchingScheduler(engine, eos_id=dry[cut],
                                           max_new_tokens=8).run(
        [Request(uid="a", prompt=prompt), Request(uid="b", prompt=prompt)])
    assert [r.tokens for r in res] == [dry[:cut + 1]] * 2
    assert rep.finish_reasons == {"eos": 2}

    res, rep = ContinuousBatchingScheduler(engine, max_new_tokens=8,
                                           step_cap=3).run(
        [Request(uid="a", prompt=prompt), Request(uid="q", prompt=prompt)])
    assert {r.uid: r.finish_reason for r in res} == {"a": "step_cap", "q": "cancelled"}
    assert len(next(r for r in res if r.uid == "a").tokens) == 4

    res, _ = ContinuousBatchingScheduler(engine, max_new_tokens=6).run([
        Request(uid="short", prompt=prompt, max_new_tokens=2),
        Request(uid="zero", prompt=prompt, max_new_tokens=0),
        Request(uid="empty", prompt=[]),
        Request(uid="long", prompt=list(range(1, 17))),
        Request(uid="late", prompt=prompt, deadline_s=1e-9),
    ])
    by = {r.uid: r for r in res}
    assert len(by["short"].tokens) == 2
    for uid, words in (("zero", "max_new_tokens"), ("empty", "empty prompt"),
                       ("long", "no room")):
        assert by[uid].finish_reason == "error" and words in by[uid].error
    assert by["late"].finish_reason == "deadline" and by["late"].tokens == []

    sched = ContinuousBatchingScheduler(engine, max_new_tokens=6)
    sched.request_cancel("c")
    res, _ = sched.run([Request(uid="c", prompt=prompt),
                        Request(uid="d", prompt=prompt)])
    assert {r.uid: r.finish_reason for r in res} == {"c": "cancelled", "d": "length"}


def test_engine_validates_inputs(params):
    engine = _engine(params, max_seq=16)
    with pytest.raises(ValueError, match="empty prompt"):
        engine.prefill(0, [])
    with pytest.raises(ValueError, match="no room"):
        engine.prefill(0, list(range(1, 17)))
    with pytest.raises(ValueError, match="slot"):
        engine.prefill(5, [1, 2])
    with pytest.raises(ValueError, match="max_seq"):
        _engine(params, max_seq=CFG["max_len"] + 1)
    with pytest.raises(ValueError, match="top_k"):
        _engine(params, temperature=1.0, top_k=0)
    with pytest.raises(NotImplementedError, match="f32 or bf16 weights"):
        _engine({**params, "embed": params["embed"].double()})
    with pytest.raises(NotImplementedError, match="f32 or bf16 weights"):
        _engine({**params, "embed": params["embed"].half()})
    # bf16 weights serve, on a bf16 cache by default (the reference's rule)
    bf16 = _engine({k: ({n: w.bfloat16() for n, w in v.items()}
                        if isinstance(v, dict) else v.bfloat16())
                    for k, v in params.items()})
    assert (bf16.kv_dtype, bf16.weights_dtype) == ("bfloat16", "bfloat16")
    assert _engine(params, cache_dtype="bfloat16").kv_dtype == "bfloat16"
    with pytest.raises(ValueError, match="cache_dtype"):
        _engine(params, cache_dtype="float16")


def test_synthetic_requests_match_the_reference():
    from distributeddeeplearning_tpu.serve import synthetic_requests as jsyn

    want = jsyn(6, vocab_size=97, max_prompt=20, min_prompt=4,
                rng=np.random.default_rng(3))
    got = synthetic_requests(6, vocab_size=97, max_prompt=20, min_prompt=4,
                             rng=np.random.default_rng(3))
    assert [(r.uid, list(r.prompt)) for r in got] == [
        (r.uid, list(r.prompt)) for r in want]

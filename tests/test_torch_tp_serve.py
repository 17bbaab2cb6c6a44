"""Tensor-parallel serving of the port against the JAX package's.

Two gloo ranks (``tests/_torch_dp.run_ranks``, one module-scoped spawn)
serve every case through ``tensor_parallel_engine(tp=2)``; the port's
``tp=1`` engine runs the same cases in this process, and the JAX package's
``tensor_parallel_engine`` serves them at ``tp=1`` and ``tp=2`` on the
suite's virtual CPU devices (``tests/conftest.py``), as its own
``tests/test_tp_serve.py`` does.  The geometry and the margin profile are
that test's (2 layers, d 32, 4 heads, ff 64, vocabulary 64; a tied 4x
embedding head, so top-2 logit gaps dwarf the all-reduce's reassociation
and token equality measures the layout).  The ranks import no jax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp
from distributeddeeplearning_tpu.models.pipelined_transformer import (
    forward as jforward,
)
from distributeddeeplearning_tpu.models.pipelined_transformer import (
    init_params as jinit,
)
from distributeddeeplearning_tpu.parallel.sharding import layout_rules_provenance
from distributeddeeplearning_tpu.quant.calibrate import quantize_params as jquantize
from distributeddeeplearning_tpu.serve import ContinuousBatchingScheduler as JSched
from distributeddeeplearning_tpu.serve import Request as JRequest
from distributeddeeplearning_tpu.serve.engine import (
    tensor_parallel_engine as jtp_engine,
)

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=64,
           max_len=48)
HEADS, L = CFG["num_heads"], CFG["num_layers"]
NEW = 4
# bf16 logits, TP=2 against TP=1, of the largest |logit|: the row-parallel
# partials are summed in f32 and rounded once, as TP=1's product is, but
# the two sums run in another order: a bf16 ulp (2^-8 relative) at a few
# places, carried through 2 layers
BF16_LOGIT_RTOL = 2 ** -6
F32_LOGIT_ATOL = 1e-5


def _requests(seed=7, n=4):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(1, CFG["vocab_size"], 4 + 2 * (i % 3)).tolist())
            for i in range(n)]


def _prefix_requests():
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, CFG["vocab_size"], 12).tolist()
    return [(f"s{i}", prefix + rng.integers(1, CFG["vocab_size"], 4).tolist())
            for i in range(4)]


def _case(name, layout="dense", cache_dtype=None, weights="f32", **kw):
    return dict(name=name, layout=layout, cache_dtype=cache_dtype, weights=weights,
                num_heads=HEADS, requests=_requests(), max_new=NEW, **kw)


# the reference's four ids, then bf16 and int8 weights
STREAM_CASES = [
    _case("dense_f32"),
    _case("dense_int8", cache_dtype="int8"),
    _case("paged_f32", layout="paged"),
    _case("paged_int8", layout="paged", cache_dtype="int8"),
    _case("dense_bf16_weights", weights="bf16"),
    _case("dense_int8_weights", weights="int8"),
]
CASES = STREAM_CASES + [
    dict(_case("prefix", layout="paged"), requests=_prefix_requests(), max_new=3),
    _case("sampled", temperature=0.8),
]
TOKENS = np.random.default_rng(5).integers(1, CFG["vocab_size"], (2, 12))


@pytest.fixture(scope="module")
def jparams():
    p = jinit(jax.random.key(0), **CFG)
    p["embed"] = p["embed"] * 4.0
    p["head"] = p["embed"].T
    return p


@pytest.fixture(scope="module")
def params_np(jparams):
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def ranks(params_np):
    return _torch_dp.run_ranks(_torch_dp.tp_serve, 2, params_np, CASES, TOKENS,
                               timeout=180)


@pytest.fixture(scope="module")
def single(params_np):
    return _torch_dp.tp_serve(0, 1, params_np, CASES, TOKENS)


def _jax_tree(jparams, weights):
    if weights == "bf16":
        return jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    if weights == "int8":
        return jquantize(jparams)
    return jparams


def _jax_streams(jparams, case, tp):
    kw = dict(tp=tp, num_heads=HEADS, batch_slots=2, max_seq=32, temperature=0.0)
    if case["cache_dtype"]:
        kw["cache_dtype"] = jnp.int8
    if case["layout"] == "paged":
        kw.update(kv_layout="paged", page_size=4, prefill_chunk=8)
    engine, _ = jtp_engine(_jax_tree(jparams, case["weights"]), **kw)
    res, rep = JSched(engine, max_new_tokens=case["max_new"]).run(
        [JRequest(uid=u, prompt=p) for u, p in case["requests"]])
    return {r.uid: r.tokens for r in res}, rep


def _naive_greedy(jparams, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits = jforward(jparams, jnp.asarray([toks], jnp.int32), num_heads=HEADS)
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_ranks_load_no_jax_and_hold_their_heads(ranks):
    for out in ranks:
        assert out["jax_loaded"] is False
        for case in STREAM_CASES:
            assert out[case["name"]]["mesh"]["tensor"] == 2
            assert out[case["name"]]["kv_heads"] == HEADS // 2


@pytest.mark.parametrize("case", STREAM_CASES, ids=[c["name"] for c in STREAM_CASES])
def test_tp2_greedy_streams_equal_the_reference(jparams, ranks, single, case):
    """Port TP=2 (both ranks) == port TP=1 == JAX TP=2 == JAX TP=1, token
    for token; the f32 cases also match the reference's full-forward
    greedy on one request."""
    name = case["name"]
    port2 = [out[name]["tokens"] for out in ranks]
    assert port2[0] == port2[1], f"{name}: the ranks' streams diverged"
    assert port2[0] == single[name]["tokens"], f"{name}: TP=2 != TP=1"
    for tp in (1, 2):
        want, rep = _jax_streams(jparams, case, tp)
        assert rep.tp == tp
        assert port2[0] == want, f"{name}: port TP=2 != JAX TP={tp}"
    if case["weights"] == "f32" and case["cache_dtype"] is None:
        uid, prompt = case["requests"][0]
        assert port2[0][uid] == _naive_greedy(jparams, prompt, NEW)


@pytest.mark.parametrize("case", STREAM_CASES, ids=[c["name"] for c in STREAM_CASES])
def test_tp2_collectives_a_forward_pass(ranks, single, case):
    """2 L + 1 all-reduces and one all-gather a forward pass (2 L
    all-reduces with MAX more under int8 weights), on both ranks; none at
    TP=1."""
    name = case["name"]
    for out in ranks:
        run = out[name]
        forwards = run["prefills"] + run["decode_steps"]
        want = {"all_reduce": (2 * L + 1) * forwards, "all_gather": forwards}
        if case["weights"] == "int8":
            want["all_reduce_max"] = 2 * L * forwards
        assert run["counts"] == want
    assert single[name]["counts"] == {}


def test_tp2_logits_match_tp1(ranks, single):
    """Prefill logits (and the rank's K heads) of the TP=2 path against
    TP=1: f32 within 1e-5; bf16 within BF16_LOGIT_RTOL of the largest
    |logit|."""
    one = single["logits"]
    for rank, out in enumerate(ranks):
        got = out["logits"]
        np.testing.assert_allclose(got["f32"][0], one["f32"][0], rtol=0,
                                   atol=F32_LOGIT_ATOL)
        heads = slice(rank * HEADS // 2, (rank + 1) * HEADS // 2)
        np.testing.assert_allclose(got["f32"][1], one["f32"][1][:, :, :, heads],
                                   rtol=0, atol=F32_LOGIT_ATOL)
        scale = np.abs(one["bf16"][0]).max()
        assert np.abs(got["bf16"][0] - one["bf16"][0]).max() <= BF16_LOGIT_RTOL * scale
    np.testing.assert_array_equal(ranks[0]["logits"]["f32"][0],
                                  ranks[1]["logits"]["f32"][0])


def test_tp2_chunked_prefill_prefix_hits_preserved(jparams, ranks, single):
    """Shared system-prompt traffic: the TP=2 pool still maps the shared
    full pages, at TP=1's hit rate, with TP=1's streams (the allocator's
    invariants held in every run: ``tp_serve_case`` checks them)."""
    case = CASES[len(STREAM_CASES)]
    hits = {out["prefix"]["hit_rate"] for out in ranks}
    assert hits == {single["prefix"]["hit_rate"]}
    assert hits.pop() > 0
    assert ranks[0]["prefix"]["tokens"] == ranks[1]["prefix"]["tokens"] \
        == single["prefix"]["tokens"]
    want, rep = _jax_streams(jparams, case, 2)
    assert ranks[0]["prefix"]["tokens"] == want
    assert ranks[0]["prefix"]["hit_rate"] == rep.prefix_hit_rate


def test_serve_report_carries_tp_and_layout_provenance(ranks, single):
    assert layout_rules_provenance() == ranks[0]["dense_f32"]["layout_rules"]
    for out in ranks:
        assert out["dense_f32"]["tp"] == 2
        assert out["dense_f32"]["layout_rules"] == layout_rules_provenance()
    assert single["dense_f32"]["tp"] == 1
    assert single["dense_f32"]["layout_rules"] == layout_rules_provenance()


def test_sampled_streams_agree_across_ranks(ranks):
    """Temperature 0.8: every rank samples from the same gathered logits
    with the same generator, so the streams stay equal."""
    assert ranks[0]["sampled"]["tokens"] == ranks[1]["sampled"]["tokens"]
    assert all(len(t) == NEW for t in ranks[0]["sampled"]["tokens"].values())

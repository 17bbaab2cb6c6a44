"""Shared scaffolding of the robust-serving parity tests: one tiny model
given to both packages, engine pairs (the JAX package's and the port's on
the same weights and arguments), request pairs and the decision
comparison a port scheduler run is held to against the JAX scheduler.

The model is the raw random init by default: at these widths its greedy
streams vary token to token, and they hold EXACTLY between the two
packages (as in ``tests/test_torch_paged.py``).  ``margin=True`` gives
the margin profile of ``tests/test_tp_serve.py`` (4x embedding, head =
embedding^T: top-2 logit gaps dwarf the f32 rounding of the two
libraries); at d_model 32 its greedy streams repeat the last prompt
token, so it is the second case, not the default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.serve import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxDense,
    PagedInferenceEngine as JaxPaged,
    Request as JaxRequest,
)
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagedInferenceEngine,
    Request,
)

CFG = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=64)
HEADS = CFG["num_heads"]

#: ServeReport fields that are decisions (not timings): held equal
REPORT_FIELDS = (
    "requests", "generated_tokens", "prompt_tokens", "decode_steps",
    "finish_reasons", "errors", "decode_retries", "quarantined", "drained",
    "preemptions", "prefix_hit_rate", "kv_layout", "kv_dtype",
    "tier_enabled", "tier_host_pages", "tier_spilled_pages",
    "tier_restored_pages", "tier_dropped_pages", "tier_host_pages_peak",
    "tier_host_bytes_peak", "tier_prefix_hit_tokens_host",
    "tier_preempt_spilled_pages",
)
CLASS_FIELDS = ("requests", "finish_reasons", "shed", "preempted", "preemptions")


def make_params(seed: int = 0, *, margin: bool = False, cfg=CFG):
    """``(jax params, port params)`` of one model from ``seed``."""
    jp = jpt.init_params(jax.random.key(seed), **cfg)
    if margin:
        jp["embed"] = jp["embed"] * 4.0
        jp["head"] = jp["embed"].T
    return jp, tpt.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def engine_pair(params, layout: str = "paged", *, int8: bool = False, **kw):
    """The JAX package's engine and the port's on the same weights and
    arguments (``kw`` shared; the dense engines prefill through dense
    attention, the path the reference's own tests take on the CPU)."""
    jp, tp = params
    kw.setdefault("num_heads", HEADS)
    if int8:
        jkw, tkw = dict(kw, cache_dtype=jnp.int8), dict(kw, cache_dtype="int8")
    else:
        jkw, tkw = dict(kw), dict(kw)
    if layout == "paged":
        return JaxPaged(jp, **jkw), PagedInferenceEngine(tp, device="cpu", **tkw)
    jkw.setdefault("prefill_attention", "dense")
    tkw.setdefault("prefill_attention", "dense")
    return JaxDense(jp, **jkw), InferenceEngine(tp, device="cpu", **tkw)


def jax_request(r: Request) -> JaxRequest:
    return JaxRequest(uid=r.uid, prompt=list(r.prompt),
                      max_new_tokens=r.max_new_tokens, deadline_s=r.deadline_s,
                      trace_id=r.trace_id, tenant=r.tenant, priority=r.priority)


def staged_poll(*stages, idle: int = 400, jax_side: bool = False):
    """poll() releasing each stage's requests at its loop pass (``stages``:
    ``(pass, [port Request])``); None (source closed) after ``idle``
    passes.  ``jax_side`` hands out the JAX package's requests."""
    state = {"n": 0}
    by_pass = {n: [jax_request(r) if jax_side else r for r in reqs]
               for n, reqs in stages}

    def poll():
        state["n"] += 1
        if state["n"] > idle:
            return None
        return by_pass.get(state["n"], [])

    return poll


def run_pair(engines, requests=(), *, stages=None, idle: int = 400,
             run_kw=None, jax_sched_kw=None, **sched_kw):
    """Run the JAX scheduler over the JAX engine and the port's over the
    port's, on the same requests (and the same staged arrivals);
    returns ``((jax results, report), (port results, report))``."""
    jeng, teng = engines
    run_kw = run_kw or {}
    out = []
    for side, eng, sched_cls in ((True, jeng, JaxScheduler),
                                 (False, teng, ContinuousBatchingScheduler)):
        kw = dict(sched_kw, **(jax_sched_kw or {})) if side else dict(sched_kw)
        reqs = [jax_request(r) if side else r for r in requests]
        extra = dict(run_kw)
        if stages is not None:
            extra["poll"] = staged_poll(*stages, idle=idle, jax_side=side)
        out.append(sched_cls(eng, **kw).run(reqs, **extra))
    return out[0], out[1]


def assert_same_decisions(ref, got, *, tokens: bool = True):
    """The port's run made the reference's decisions: completion order,
    finish reasons, preemptions, whether a retry hint came, errors,
    token streams (when ``tokens``), and the report's decision fields
    and per-class counts."""
    (jres, jrep), (tres, trep) = ref, got
    assert [r.uid for r in tres] == [r.uid for r in jres]
    for a, b in zip(jres, tres):
        assert b.finish_reason == a.finish_reason, b.uid
        assert b.prompt_len == a.prompt_len, b.uid
        assert b.preemptions == a.preemptions, b.uid
        assert (b.retry_after_s is None) == (a.retry_after_s is None), b.uid
        assert (b.error is None) == (a.error is None), b.uid
        assert (b.tenant, b.priority) == (a.tenant, a.priority), b.uid
        if tokens:
            assert list(b.tokens) == list(a.tokens), b.uid
    for field in REPORT_FIELDS:
        assert getattr(trep, field) == getattr(jrep, field), field
    assert sorted(trep.per_class) == sorted(jrep.per_class)
    for cls, row in jrep.per_class.items():
        for field in CLASS_FIELDS:
            assert trep.per_class[cls][field] == row[field], (cls, field)


def by_uid(results):
    return {r.uid: r for r in results}


def prompt(rng, n: int = 6):
    return rng.integers(1, CFG["vocab_size"], n).tolist()

"""The port's ``comm_overlap`` train step on N gloo ranks against the
reference's ``comm_overlap`` step on an N-device mesh, on the CPU (and
the implicit step against the reference's implicit one).

The ranks are spawned processes that import torch and the port only
(``tests/_torch_dp.py``); the JAX side runs here on the conftest's
virtual CPU devices.  Models: the tiny BERT of ``tests/test_comms.py``
(SGD momentum, 32 rows of 8 tokens) and a tiny causal LM (AdamW without a
clip, 16 rows of 8 tokens), the same weights on both sides, two steps.
The cases, at N = 2 and 4: the f32 wire with weight-update sharding off
and on at ``bucket_mb`` 0.004 (buckets smaller than the embedding) and 64
(one bucket), ``accum_steps=2``, the bf16 wire with error feedback
(replicated optimizer at accum 1, sharded at accum 2), and
``skip_nonfinite`` with a NaN loss; and the implicit path of both models.
The port is held to the reference's
outputs, not to ``test_comm_overlap_bitexact_vs_implicit`` (red on the
reference side).

Tolerances:
- metrics: losses 1e-5 relative; top-1 / top-5 at most one row of the
  global batch apart (a near-tie may round either way);
- params after two steps, f32 wire: 2e-6 absolute + 1e-5 relative for
  BERT (SGD moves a leaf by lr x gradient, and the gradients agree to
  ~1e-6 relative); the LM's AdamW divides by sqrt(v), so an ulp in a
  gradient near 0 can move its update by up to a learning rate: 1e-3 of
  the summed learning rates (``tests/test_torch_train.py``'s rule);
- the bf16 wire: a bf16 rounding of a payload element may go the other
  way on the two sides (their f32 gradients differ in the last bits),
  which moves that element's gradient by one bf16 step: BERT's params are
  held to 1e-5 absolute (observed 3.1e-6), the LM's as above; the ranks'
  residual blocks, concatenated, equal the
  reference's global residual within one bf16 step of the bucket's
  largest payload element (twice its largest residual), and 97% of the
  elements within 1e-7 (observed: at least 98.7%; a flipped rounding
  carries into the next microbatch's payload);
- the skipped step: params bitwise unchanged on every rank.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import _torch_dp
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.parallel import MeshSpec, create_mesh, shard_batch
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep

torch.set_num_threads(2)  # the suite runs six workers on eight cores

STEPS = 2
SEQ = 8
BERT_CASES = {
    "f32-wus0-b0.004": dict(bucket_mb=0.004),
    "f32-wus0-b64": dict(bucket_mb=64.0),
    "f32-wus1-b0.004": dict(bucket_mb=0.004, weight_update_sharding=True),
    "f32-wus1-b64": dict(bucket_mb=64.0, weight_update_sharding=True),
    "accum2": dict(bucket_mb=0.004, weight_update_sharding=True, accum_steps=2),
    "bf16": dict(bucket_mb=0.004, comm_dtype="bf16"),
    "bf16-wus-accum2": dict(bucket_mb=0.004, comm_dtype="bf16",
                            weight_update_sharding=True, accum_steps=2),
    "skip-nonfinite": dict(bucket_mb=0.004, weight_update_sharding=True,
                           skip_nonfinite=True, poison=True),
    "implicit": dict(implicit=True),
}
LM_CASES = {
    "lm-implicit": dict(implicit=True),
    "lm-f32-wus": dict(bucket_mb=0.002, weight_update_sharding=True),
    "lm-bf16-wus-accum2": dict(bucket_mb=0.002, comm_dtype="bf16",
                               weight_update_sharding=True, accum_steps=2),
}
ALL = {**{("bert", k): v for k, v in BERT_CASES.items()},
       **{("lm", k): v for k, v in LM_CASES.items()}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    model = jget_model("bert-base", dtype=jnp.float32, **_torch_dp.BERT)
    bert = model.init(jax.random.key(0), jnp.zeros((2, SEQ), jnp.int32), train=False)
    rng = np.random.default_rng(7)
    return {
        "bert": (_np(nn.meta.unbox(bert)["params"]), {
            "input": rng.integers(0, 50, (32, SEQ)).astype(np.int32),
            "label": rng.integers(0, 3, (32,)).astype(np.int32)}),
        "lm": (_np(jpt.init_params(jax.random.key(0), max_len=SEQ, **_torch_dp.LM)),
               {"input": (t := rng.integers(0, _torch_dp.LM["vocab_size"], (16, SEQ))
                          .astype(np.int32)), "label": t}),
    }


@pytest.fixture(scope="module")
def port(inputs):
    """{(world, model, case): per-rank results}, one spawn per world and
    model."""
    out = {}
    for world in (2, 4):
        for model, cases in (("bert", BERT_CASES), ("lm", LM_CASES)):
            params, batch = inputs[model]
            ranks = _torch_dp.run_ranks(_torch_dp.comm_overlap_cases, world, model,
                                        params, batch, cases, STEPS, timeout=300)
            for name in cases:
                out[(world, model, name)] = [r[name] for r in ranks]
    return out


def _jax_run(model, params, batch, world, kw):
    kw = dict(kw)
    poison = kw.pop("poison", False)
    comm = not kw.pop("implicit", False)
    mesh = create_mesh(MeshSpec(), devices=jax.devices()[:world])
    if model == "bert":
        net = jget_model("bert-base", dtype=jnp.float32, **_torch_dp.BERT)
        tx = jstate.sgd_momentum(optax.constant_schedule(_torch_dp.BERT_LR))
        apply_fn = net.apply
        loss_fn, metrics_fn = jstep.cross_entropy_loss, jstep.classification_metrics
    else:
        tx = jstate.adamw(optax.constant_schedule(_torch_dp.LM_LR), weight_decay=0.01,
                          grad_clip_norm=0.0)

        def apply_fn(variables, toks, train=True, mutable=None, rngs=None):
            out = jpt.forward(variables["params"], toks,
                              num_heads=_torch_dp.LM["num_heads"])
            return (out, {}) if mutable is not None else out

        def loss_fn(logits, labels, *, label_smoothing=0.0):
            return jpt.next_token_loss(logits, labels)

        def metrics_fn(logits, toks, loss):
            return {"loss": loss.astype(jnp.float32)}
    if poison:
        base = loss_fn

        def loss_fn(logits, labels, *, label_smoothing=0.0):
            return base(logits, labels) * jnp.nan
    jparams = jax.tree.map(jnp.asarray, params)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                              opt_state=tx.init(jparams), batch_stats={},
                              apply_fn=apply_fn, tx=tx)
    step = jstep.build_train_step(mesh, state, compute_dtype=jnp.float32,
                                  comm_overlap=comm, loss_fn=loss_fn,
                                  metrics_fn=metrics_fn, **kw)
    if comm:
        state = step.prepare_state(state)
    placed = shard_batch(mesh, batch)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        metrics.append({k: float(v) for k, v in m.items()})
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    return {"metrics": metrics, "step": int(state.step),
            "wire": step.wire_bytes() if comm else None,
            "params": {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat},
            "residual": ([np.asarray(r) for r in state.opt_state["residual"]]
                         if comm else [])}


def _param_tolerance(model, kw):
    if model == "lm":
        return dict(atol=1e-3 * _torch_dp.LM_LR * STEPS, rtol=0)
    if kw.get("comm_dtype") == "bf16":
        return dict(atol=1e-5, rtol=1e-5)
    return dict(atol=2e-6, rtol=1e-5)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model,case", list(ALL), ids=lambda x: x)
def test_comm_overlap_step_matches_the_reference(inputs, port, world, model, case):
    kw = ALL[(model, case)]
    params, batch = inputs[model]
    want = _jax_run(model, params, batch, world, kw)
    ranks = port[(world, model, case)]
    rows = batch["input"].shape[0]
    for r, got in enumerate(ranks):
        assert got["step"] == want["step"] == STEPS
        assert got["wire"] == want["wire"]
        # replicated params: every rank holds the same bits
        for key, leaf in got["params"].items():
            assert leaf.tobytes() == ranks[0]["params"][key].tobytes(), (r, key)
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == set(w)
            for k, v in w.items():
                if k in ("top1", "top5"):
                    assert abs(g[k] - v) <= 1.0 / rows + 1e-7, (k, g[k], v)
                elif k == "anomalous":
                    assert g[k] == v
                elif np.isfinite(v):
                    np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)
                else:
                    assert not np.isfinite(g[k]), k
    got = ranks[0]
    assert set(got["params"]) == set(want["params"])
    if kw.get("poison"):
        assert all(m["anomalous"] == 1.0 for m in want["metrics"])
        for rank in ranks:
            for key, leaf in rank["params"].items():
                assert leaf.tobytes() == rank["before"][key].tobytes(), key
        return
    for key, leaf in want["params"].items():
        np.testing.assert_allclose(got["params"][key], leaf, err_msg=key,
                                   **_param_tolerance(model, kw))
    if kw.get("comm_dtype") == "bf16":
        assert len(want["residual"]) == got["num_buckets"]
        for b, whole in enumerate(want["residual"]):
            mine = np.concatenate([rank["residual"][b] for rank in ranks])
            assert mine.shape == whole.shape
            # a residual is at most half a bf16 step of its payload element
            assert np.abs(mine - whole).max() <= 2 * np.abs(whole).max(), b
            close = np.abs(mine - whole) <= 1e-7
            assert close.mean() >= 0.97, (b, close.mean())
        assert sum(np.abs(r).sum() for r in got["residual"]) > 0
    else:
        assert got["residual"] == [] and want["residual"] == []

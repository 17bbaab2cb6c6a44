"""Data-parallel training in the port against the JAX package, on the CPU.

The ranks are spawned gloo processes that import torch and the port only
(``tests/_torch_dp.py``); the JAX side runs here on the conftest's
virtual CPU devices, on a mesh of the same size.

- The implicit path: ResNet-18 in float64 (the BatchNorm parity rule of
  ``tests/test_torch_benchmark.py``) on N ranks against the reference's
  implicit step on an N-device mesh, at accum 1 and 2 (the strided split
  of each rank's rows is the reference's global one, microbatch by
  microbatch).  The reference's GSPMD step computes
  train-mode BatchNorm moments over the GLOBAL batch; the port's must too.
  Params, momentum and statistics within ``F64_RTOL`` (5e-4, the single-
  device rule); and the statistics a per-rank BatchNorm would give are
  shown to miss the reference by far more than that.
- ``Trainer.evaluate`` over ranks holding 3 and 2 eval batches: the two
  common batches, size-weighted, equal the reference's ``evaluate`` over
  those global batches (1e-6 relative); a rank that buffers more than
  ``eval_buffer_batches`` raises the reference's error.
- ``make_flash_attention(mesh)`` per rank (the plain path) against the
  reference's ``shard_map``ped kernels in interpret mode: outputs and
  gradients 2e-6 absolute + 1e-5 relative.
- A 2-rank prepared state (weight-update sharding + the bf16 wire)
  checkpointed by ``Trainer.fit``, restored in a fresh state and trained
  on is bitwise the fit that never stopped, on every rank; restoring it
  on one rank raises.
- The workloads run with ``distributed=True`` inside a 2-rank group, and
  their argument errors are the reference's.
"""

from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import _torch_dp
from _torch_image import randomized, tree_errors
from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.parallel import MeshSpec, create_mesh, shard_batch
from distributeddeeplearning_tpu.train import loop as jloop
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.models import _convnet
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import transformer as tw

jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")
jwork = importlib.import_module("distributeddeeplearning_tpu.workloads.transformer")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CLASSES, SIZE, BATCH, STEPS, LR = 10, 32, 8, 2, 0.1
F64_RTOL = 5e-4


def _mesh(world):
    return create_mesh(MeshSpec(), devices=jax.devices()[:world])


@pytest.fixture(scope="module")
def resnet_variables():
    model = jget_model("resnet18", num_classes=CLASSES, dtype=jnp.float32)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    nv = randomized(init(jax.random.key(1)), seed=1, head_scale=1.0)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), nv)


def _image_batches():
    return list(jsynth.synthetic_batches(BATCH, STEPS, (SIZE, SIZE, 3), CLASSES,
                                         seed=4))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("world,accum", [(2, 1), (4, 1), (2, 2)])
def test_implicit_path_takes_global_batch_moments_like_the_reference(
        resnet_variables, world, accum):
    batches = _image_batches()
    ranks = _torch_dp.run_ranks(_torch_dp.implicit_resnet, world, resnet_variables,
                                batches, CLASSES, LR, "float64", accum, timeout=400)
    with jax.enable_x64(True):
        mesh = _mesh(world)
        tx = jstate.sgd_momentum(optax.constant_schedule(LR))
        params = jax.tree.map(jnp.asarray, resnet_variables["params"])
        state = jstate.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
            batch_stats=jax.tree.map(jnp.asarray, resnet_variables["batch_stats"]),
            apply_fn=jget_model("resnet18", num_classes=CLASSES,
                                dtype=jnp.float64).apply, tx=tx)
        step = jstep.build_train_step(mesh, state, compute_dtype=jnp.float64,
                                      accum_steps=accum)
        want = []
        for batch in batches:
            state, m = step(state, shard_batch(mesh, batch))
            want.append({k: float(v) for k, v in m.items()})
        state = jax.device_get(state)
    for r, got in enumerate(ranks):
        for g, w in zip(got["metrics"], want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6)
            assert abs(g["top1"] - w["top1"]) <= 1e-9
        port = _convnet.variables_from_numpy(got["variables"], device="cpu")
        errors = tree_errors({"params": port["params"]}, {"params": state.params})
        errors.update(tree_errors({"batch_stats": port["batch_stats"]},
                                  {"batch_stats": state.batch_stats}))
        trace = _convnet.variables_from_numpy(got["trace"], device="cpu")
        errors.update({"trace" + k: v for k, v in tree_errors(
            {"params": trace["params"]},
            {"params": state.opt_state[1][0].trace}).items()})
        worst = max(errors, key=errors.get)
        assert errors[worst] < F64_RTOL, (r, worst, errors[worst])
        for key, leaf in got["variables"]["batch_stats"].items():
            assert ranks[0]["variables"]["batch_stats"][key].keys() == leaf.keys()

    if accum > 1:
        return
    # per-rank moments (what plain DDP gives) miss the reference's
    # statistics by far more than the tolerance
    tv = _convnet.variables_from_numpy(resnet_variables, device="cpu")
    alone = tstate.TrainState.create(
        params=tv["params"], batch_stats=tv["batch_stats"],
        tx=tstate.sgd_momentum(tsched.constant_schedule(LR)),
        apply_fn=tmodels.get_model("resnet18", num_classes=CLASSES,
                                   dtype=torch.float64))
    step1 = tstep.build_train_step(alone, compute_dtype=torch.float64)
    rows = BATCH // world
    alone, _ = step1(alone, {k: v[:rows] for k, v in batches[0].items()})
    with jax.enable_x64(True):
        mesh = _mesh(world)
        params = jax.tree.map(jnp.asarray, resnet_variables["params"])
        first = jstate.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
            batch_stats=jax.tree.map(jnp.asarray, resnet_variables["batch_stats"]),
            apply_fn=state.apply_fn, tx=tx)
        first, _ = jstep.build_train_step(mesh, first, compute_dtype=jnp.float64)(
            first, shard_batch(mesh, batches[0]))
        first = jax.device_get(first)
    per_rank = tree_errors({"batch_stats": alone.batch_stats},
                           {"batch_stats": first.batch_stats})
    assert max(per_rank.values()) > 100 * F64_RTOL


@pytest.fixture(scope="module")
def bert_params():
    model = jget_model("bert-base", dtype=jnp.float32, **_torch_dp.BERT)
    v = model.init(jax.random.key(0), jnp.zeros((2, 8), jnp.int32), train=False)
    return jax.tree.map(np.asarray, nn.meta.unbox(v)["params"])


def test_evaluate_agrees_on_a_common_count_and_weights_by_rows(bert_params):
    rng = np.random.default_rng(3)
    batches = [{"input": rng.integers(0, 50, (8, 8)).astype(np.int32),
                "label": rng.integers(0, 3, (8,)).astype(np.int32)} for _ in range(3)]
    ranks = _torch_dp.run_ranks(_torch_dp.uneven_evaluate, 2, bert_params, batches,
                                [3, 2], True, timeout=200)
    mesh = _mesh(2)
    net = jget_model("bert-base", dtype=jnp.float32, **_torch_dp.BERT)
    tx = jstate.sgd_momentum(optax.constant_schedule(_torch_dp.BERT_LR))
    params = jax.tree.map(jnp.asarray, bert_params)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={},
                              apply_fn=net.apply, tx=tx)
    trainer = jloop.Trainer(mesh, None, config=jloop.TrainerConfig(
        epochs=1, steps_per_epoch=1),
        eval_step=jstep.build_eval_step(mesh, state, compute_dtype=jnp.float32))
    want = trainer.evaluate(state, iter(batches[:2]))
    for got in ranks:
        assert set(got["metrics"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, err_msg=k)
        assert "eval_buffer_batches=1" in got["cap_error"]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_runs_per_rank_like_the_sharded_reference(causal):
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.normal(size=(4, 32, 2, 16)).astype(np.float32)
                  for _ in range(4))
    ranks = _torch_dp.run_ranks(_torch_dp.flash_rows, 2, q, k, v, w, causal,
                                timeout=200)
    fn = jfa.make_flash_attention(mesh=_mesh(2), causal=causal)

    def loss(q, k, v):
        return (fn(q, k, v, None, dtype=jnp.float32) * w).sum()

    want_o = np.asarray(fn(*(jnp.asarray(x) for x in (q, k, v)), None,
                           dtype=jnp.float32))
    want_g = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]
    got_o = np.concatenate([r["o"] for r in ranks])
    np.testing.assert_allclose(got_o, want_o, atol=2e-6, rtol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(np.concatenate([r["grads"][i] for r in ranks]),
                                   want_g[i], atol=2e-6, rtol=1e-5)


def test_a_two_rank_comm_state_resumes_bitwise(tmp_path):
    from distributeddeeplearning_tpu.models import pipelined_transformer as jpt

    params = jax.tree.map(np.asarray, jpt.init_params(jax.random.key(0), max_len=8,
                                                      **_torch_dp.LM))
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(4):
        t = rng.integers(0, _torch_dp.LM["vocab_size"], (8, 8)).astype(np.int32)
        batches.append({"input": t, "label": t})
    ranks = _torch_dp.run_ranks(_torch_dp.resume_is_bitwise, 2, params, batches,
                                str(tmp_path / "ck"), 2, timeout=300)
    for r, out in enumerate(ranks):
        whole, resumed = out["whole"], out["resumed"]
        assert whole["step"] == resumed["step"] == 4
        for part in ("params", "opt"):
            assert whole[part].keys() == resumed[part].keys()
            for key, leaf in whole[part].items():
                assert leaf.tobytes() == resumed[part][key].tobytes(), (r, part, key)
        assert [x.tobytes() for x in whole["residual"]] == [
            x.tobytes() for x in resumed["residual"]]
    # the ranks' blocks differ (they are shards), the params do not
    assert any(a.tobytes() != b.tobytes() for a, b in zip(
        ranks[0]["whole"]["residual"], ranks[1]["whole"]["residual"]))
    # restoring the 2-rank layout into a 1-rank one raises, naming the worlds
    state = _torch_dp.lm_state(params)
    loss_fn, metrics_fn = _torch_dp.lm_hooks()
    step = tstep.build_train_step(state, compute_dtype=torch.float32,
                                  comm_overlap=True, comm_dtype="bf16",
                                  weight_update_sharding=True, bucket_mb=0.002,
                                  loss_fn=loss_fn, metrics_fn=metrics_fn)
    template = step.prepare_state(state)
    ck = tckpt.Checkpointer(str(tmp_path / "ck"))
    steps = ck.all_steps()
    with pytest.raises(ValueError, match="world of 2 ranks and this state that of 1"):
        ck.restore(template)
    assert ck.all_steps() == steps  # nothing evicted


@pytest.mark.timeout(600)
def test_workloads_train_data_parallel_on_two_ranks(tmp_path):
    ranks = _torch_dp.run_ranks(_torch_dp.workloads_dp, 2, str(tmp_path),
                                timeout=500)
    for r, out in enumerate(ranks):
        lm = out["lm_implicit"]
        assert lm["step"] == 2 and np.isfinite(lm["loss"]) and np.isfinite(lm["eval"])
        assert lm["images"] == 2 * 2 * 2  # 2 steps of a global batch of 2 x 2
        assert lm["rows"] == (r == 0)  # metrics rows on the primary only
        comm = out["lm_comm"]
        assert (comm["step"], comm["resumed_step"]) == (2, 4)
        assert out["bert"]["step"] == 2 and np.isfinite(out["bert"]["loss"])
        bench = out["benchmark"]
        assert bench["num_devices"] == 2 and bench["total"] > 0
        assert bench["rows"] == ([{"model": "resnet18",
                                   "img_sec_per_chip": bench["per_chip"],
                                   "img_sec_total": bench["total"],
                                   "num_devices": 2}] if r == 0 else None)
    for part in ("lm_comm", "bert"):
        for key, leaf in ranks[0][part]["params"].items():
            assert leaf.tobytes() == ranks[1][part]["params"][key].tobytes(), key
    assert json.loads((tmp_path / "lm0.jsonl").read_text().splitlines()[0])["epoch"] == 1


TINY = dict(epochs=1, batch_size=2, seq_len=8, vocab_size=37, num_layers=1,
            d_model=16, num_heads=2, d_ff=32, steps_per_epoch=1)
ARG_ERRORS = {
    "wus-with-clip": (dict(comm_overlap=True, weight_update_sharding=True),
                      "SHARD norm"),
    "comm-overlap-with-fsdp": (dict(comm_overlap=True, fsdp=2, vocab_size=38),
                               "does not compose"),
    "wus-without-comm-overlap": (dict(weight_update_sharding=True),
                                 "require comm_overlap"),
    "bad-comm-dtype": (dict(comm_overlap=True, comm_dtype="fp8"), "comm_dtype"),
}


@pytest.mark.parametrize("case", list(ARG_ERRORS))
def test_workload_argument_errors_are_the_reference(case):
    kw, match = ARG_ERRORS[case]
    with pytest.raises(ValueError, match=match) as want:
        jwork.main(**{**TINY, **kw})
    with pytest.raises(ValueError, match=match) as got:
        tw.main(device="cpu", **{**TINY, **kw})
    assert str(got.value) == str(want.value)


def test_comm_skip_times_the_step_without_its_collectives(monkeypatch):
    """``comm_skip`` (timing only, as in the reference) runs the comm
    step's compute with no collective: with the collectives made to raise,
    a prepared state still steps, its shard sums standing in for the
    reduced ones."""
    from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
    from distributeddeeplearning_tpu_torch.parallel import collectives

    params = jax.tree.map(np.asarray, jpt.init_params(jax.random.key(0), max_len=8,
                                                      **_torch_dp.LM))
    state = _torch_dp.lm_state(params)
    loss_fn, metrics_fn = _torch_dp.lm_hooks()
    step = tstep.build_train_step(state, compute_dtype=torch.float32,
                                  comm_overlap=True, comm_skip=True,
                                  weight_update_sharding=True, bucket_mb=0.002,
                                  loss_fn=loss_fn, metrics_fn=metrics_fn)
    state = step.prepare_state(state)

    def refuse(*args, **kwargs):
        raise AssertionError("comm_skip ran a collective")

    for name in ("all_reduce", "reduce_scatter", "all_to_all", "all_gather", "psum"):
        monkeypatch.setattr(collectives, name, refuse)
    t = np.random.default_rng(2).integers(0, _torch_dp.LM["vocab_size"], (4, 8))
    state, m = step(state, {"input": t.astype(np.int32), "label": t.astype(np.int32)})
    assert state.step == 1 and np.isfinite(float(m["loss"]))

"""The port's ``Trainer`` under faults against the JAX package's, on the CPU.

A tiny ViT (32 px, patch 8, hidden 64, 2 blocks, 4 heads; the reference's
weights carried across by ``models._convnet.variables_from_numpy``), SGD
momentum, ``skip_nonfinite=True``, the same numpy batches through a
step-indexed factory, runs on both trainers under the same
``DDLT_FAULTS``: both give the same anomalous steps, rollbacks,
preemption step, restarts and generations left, and per-step f32 losses
within 1e-5 relative (``tests/test_torch_train.py``'s train-step rule;
the poisoned steps' NaN on both sides).  Within the port, with no
tolerance: the rolled-back fit and the preempted, supervised and resumed
fit are bitwise equal to a clean fit (params and momentum); an isolated
``nan_loss`` leaves the state of the step before; the goodput ledger
counts the replayed steps as redone and closes within its residual gate;
the tracer records the ``train/*`` spans and the resilience events; the
registry rows and TensorBoard's scalars land where they are asked to.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.obs import goodput as jgood
from distributeddeeplearning_tpu.obs import recorder as jrec
from distributeddeeplearning_tpu.obs import trace as jtrace
from distributeddeeplearning_tpu.parallel import create_mesh
from distributeddeeplearning_tpu.train import loop as jloop
from distributeddeeplearning_tpu.train import resilience as jres
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu.train.checkpoint import Checkpointer as JCheckpointer
from distributeddeeplearning_tpu.utils import faults as jfaults
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.models import _convnet
from distributeddeeplearning_tpu_torch.obs import goodput as tgood
from distributeddeeplearning_tpu_torch.obs import recorder as trec
from distributeddeeplearning_tpu_torch.obs import trace as ttrace
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import resilience as tres
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.utils import faults as tfaults

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))  # first MKL calls in a worker (ROADMAP C, traps)

SIZE, BATCH, CLASSES, SPE = 32, 4, 10, 6
SMALL = dict(image_size=SIZE, patch_size=8, hidden_size=64, num_layers=2,
             num_heads=4, intermediate_size=128, num_classes=CLASSES)
LR = 0.05
LOSS_RTOL = 1e-5  # tests/test_torch_train.py's per-step f32 loss rule
DATA = list(jsynth.synthetic_batches(BATCH, SPE, (SIZE, SIZE, 3), CLASSES, seed=5))


@pytest.fixture(autouse=True)
def _clean_plans(monkeypatch):
    monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    tfaults.install_plan("")
    jfaults.install_plan("")
    yield
    tfaults.install_plan("")
    jfaults.install_plan("")


@pytest.fixture(scope="module")
def variables():
    net = jget_model("vit-b16", dtype=jnp.float32, **SMALL)
    v = net.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    return jax.tree.map(np.asarray, nn.meta.unbox(v))


def factory(start):
    for i in range(start, SPE):
        yield DATA[i]


# ---- the two trainers ----------------------------------------------------------

def _port_fit(variables, directory=None, *, every=3, supervise=0,
              restart_on=(tres.RestartableError,), **cfg):
    """A port fit (fresh state, trainer and checkpointer an attempt);
    returns (state, result, [(step, loss)], trainers)."""
    losses, trainers = [], []

    def attempt(_):
        params = _convnet.variables_from_numpy(variables, device="cpu")["params"]
        st = tstate.TrainState.create(
            params=params, apply_fn=tmodels.get_model("vit-b16", dtype=torch.float32,
                                                      **SMALL),
            tx=tstate.sgd_momentum(tsched.constant_schedule(LR)))
        step = tstep.build_train_step(st, compute_dtype=torch.float32,
                                      skip_nonfinite=True)

        def recording(state, batch):
            state, m = step(state, batch)
            losses.append((state.step, float(m["loss"])))
            return state, m

        trainer = tloop.Trainer(recording, config=tloop.TrainerConfig(
            epochs=1, steps_per_epoch=SPE, global_batch_size=BATCH,
            checkpoint_dir=directory,
            checkpoint_every_steps=every if directory else None, **cfg))
        trainers.append(trainer)
        return trainer.fit(st, factory)

    (state, result), restarts = tres.supervise(attempt, max_restarts=supervise,
                                               restart_on=restart_on)
    return state, result, losses, trainers, restarts


def _jax_fit(variables, directory=None, *, every=3, supervise=0,
             restart_on=(jres.RestartableError,), **cfg):
    losses, trainers = [], []
    mesh = create_mesh(devices=jax.devices()[:1])

    def attempt(_):
        params = jax.tree.map(jnp.asarray, variables["params"])
        tx = jstate.sgd_momentum(jsched.constant_schedule(LR))
        st = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=tx.init(params), batch_stats={}, tx=tx,
                               apply_fn=jget_model("vit-b16", dtype=jnp.float32,
                                                   **SMALL).apply)
        step = jstep.build_train_step(mesh, st, compute_dtype=jnp.float32,
                                      skip_nonfinite=True)

        def recording(state, batch):
            state, m = step(state, batch)
            losses.append((int(state.step), float(m["loss"])))
            return state, m

        trainer = jloop.Trainer(mesh, recording, config=jloop.TrainerConfig(
            epochs=1, steps_per_epoch=SPE, global_batch_size=BATCH, prefetch=0,
            checkpoint_dir=directory,
            checkpoint_every_steps=every if directory else None, **cfg))
        trainers.append(trainer)
        return trainer.fit(st, factory)

    (state, result), restarts = jres.supervise(attempt, max_restarts=supervise,
                                               restart_on=restart_on)
    return state, result, losses, trainers, restarts


def _assert_losses_close(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    g, w = np.array([v for _, v in got]), np.array([v for _, v in want])
    assert np.array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    np.testing.assert_allclose(g[ok], w[ok], rtol=LOSS_RTOL)


def _port_leaves(state):
    return tckpt.flatten({"params": state.params, "trace": state.opt_state["trace"]})


def _assert_bitwise(a, b):
    la, lb = _port_leaves(a), _port_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), k


def _generations(directory):
    return tckpt.Checkpointer(str(directory)).all_steps()


# ---- both trainers under the same faults ---------------------------------------

CASES = {
    "rollback": dict(spec="nan_loss@4,nan_loss@5", checkpoint=True,
                     cfg=dict(anomaly_max_consecutive=2, anomaly_rollback=True)),
    "isolated_nan": dict(spec="nan_loss@4", checkpoint=False,
                         cfg=dict(anomaly_max_consecutive=2)),
    "preempt": dict(spec="preempt@4", checkpoint=True, cfg={}, supervise=1),
    "data_death": dict(spec="data_death@5", checkpoint=True, cfg={}, supervise=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_trainers_react_alike(variables, tmp_path, case):
    c = CASES[case]
    out = {}
    for name, fit, faults, res, rec in (("port", _port_fit, tfaults, tres, trec),
                                        ("ref", _jax_fit, jfaults, jres, jrec)):
        prev = rec.get_recorder()
        prev_tracers = ttrace.get_tracer(), jtrace.get_tracer()
        faults.install_plan(c["spec"])
        recorder = rec.set_recorder(rec.FlightRecorder(capacity=4096))
        # the events reach the recorder through the process tracer: bind a
        # fresh one on both packages (a disabled tracer another test left
        # installed may have no recorder at all)
        ttrace.configure(enabled=False)
        jtrace.configure(enabled=False)
        directory = str(tmp_path / name) if c["checkpoint"] else None
        try:
            # a dead data stream is restartable by the supervisor's choice,
            # as `ddlt train --max-restarts` treats it
            state, result, losses, trainers, restarts = fit(
                variables, directory, supervise=c.get("supervise", 0),
                restart_on=(res.RestartableError, faults.DataStreamDeath),
                **c["cfg"])
        finally:
            faults.install_plan("")
            rec.set_recorder(prev)
            ttrace.set_tracer(prev_tracers[0])
            jtrace.set_tracer(prev_tracers[1])
        flagged = [e["args"]["step"] for e in recorder.entries()
                   if e["name"] == "resilience/anomalous_step"]
        if name == "port":
            # every anomalous step of the fit (the reference's FitResult
            # keeps the last attempt's only)
            assert result.anomalous_steps == len(flagged)
        gens = (_generations(directory) if name == "port" else
                (JCheckpointer(directory).all_steps() if directory else []))
        out[name] = dict(anomalous=flagged, rollbacks=result.rollbacks,
                         restarts=restarts, gens=gens, losses=losses,
                         step=int(state.step))
    got, want = out["port"], out["ref"]
    _assert_losses_close(got.pop("losses"), want.pop("losses"))
    assert got == want
    expect = {"rollback": ([4, 5], 1, 0), "isolated_nan": ([4], 0, 0),
              "preempt": ([], 0, 1), "data_death": ([], 0, 1)}[case]
    assert (got["anomalous"], got["rollbacks"], got["restarts"]) == expect
    assert got["step"] == SPE


# ---- within the port: bitwise ------------------------------------------------------

@pytest.fixture(scope="module")
def clean(variables):
    state, result, losses, _, _ = _port_fit(variables)
    return state, dict(losses)


def test_a_rolled_back_fit_is_bitwise_the_clean_fit(variables, clean, tmp_path):
    tfaults.install_plan("nan_loss@4,nan_loss@5")
    prev_tracer = ttrace.get_tracer()
    tracer = ttrace.configure(enabled=True)
    try:
        state, result, losses, (trainer,), _ = _port_fit(
            variables, str(tmp_path / "ck"), anomaly_max_consecutive=2,
            anomaly_rollback=True, goodput_path=str(tmp_path / "g.jsonl"))
    finally:
        ttrace.set_tracer(prev_tracer)
    assert result.anomalous_steps == 2 and result.rollbacks == 1
    assert [s for s, _ in losses] == [1, 2, 3, 4, 5, 4, 5, 6]
    assert all(np.isnan(v) for _, v in losses[3:5])
    assert dict(losses[5:]) == {k: clean[1][k] for k in (4, 5, 6)}
    _assert_bitwise(state, clean[0])
    merged = tgood.stitch(str(tmp_path / "g.jsonl"))
    summary = tgood.summarize_ledger(merged)
    assert merged["segments"] == 2 and summary["counts"]["steps_redone"] == 2
    assert summary["residual_under_limit"]
    names = {e["name"] for e in tracer.events}
    assert {"train/data_wait", "train/step", "train/checkpoint",
            "resilience/rollback", "resilience/anomaly_abort"} <= names


def test_an_isolated_nan_step_leaves_the_state_of_the_step_before(variables):
    """Without the detector: the poisoned step's update is skipped on the
    device, so the state after step 4 is the state after step 3 (the
    momentum too); the epoch's metrics carry the NaN."""
    snaps = {}

    def snap(state, step):
        snaps[step] = [t.clone() for _, t in _port_leaves(state)]

    params = _convnet.variables_from_numpy(variables, device="cpu")["params"]
    st = tstate.TrainState.create(
        params=params, apply_fn=tmodels.get_model("vit-b16", dtype=torch.float32,
                                                  **SMALL),
        tx=tstate.sgd_momentum(tsched.constant_schedule(LR)))
    step = tstep.build_train_step(st, compute_dtype=torch.float32, skip_nonfinite=True)

    def recording(state, batch):
        state, m = step(state, batch)
        snap(state, state.step)
        return state, m

    tfaults.install_plan("nan_loss@4")
    state, result = tloop.Trainer(recording, config=tloop.TrainerConfig(
        epochs=1, steps_per_epoch=SPE, global_batch_size=BATCH)).fit(st, factory)
    assert state.step == SPE and result.anomalous_steps == 0
    assert np.isnan(result.final_train_metrics["loss"])
    for a, b in zip(snaps[3], snaps[4]):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(snaps[4], snaps[5]))


def test_a_preempted_supervised_fit_is_bitwise_the_clean_fit(variables, clean, tmp_path):
    tfaults.install_plan("preempt@4")
    ledger = tgood.get_ledger()
    state, result, losses, _, restarts = _port_fit(
        variables, str(tmp_path / "ck"), supervise=1,
        goodput_path=str(tmp_path / "g.jsonl"), obs_metrics_path=str(tmp_path / "o.jsonl"),
        tensorboard_dir=str(tmp_path / "tb"))
    assert restarts == 1 and [s for s, _ in losses] == [1, 2, 3, 4, 5, 6]
    assert tgood.get_ledger() is ledger  # each fit restores the process ledger
    assert result.total_images == 2 * BATCH  # only steps 5 and 6 re-ran
    _assert_bitwise(state, clean[0])
    assert dict(losses) == clean[1]
    summary = tgood.summarize_ledger(tgood.stitch(str(tmp_path / "g.jsonl")))
    assert summary["counts"]["steps_redone"] == 0 and summary["counts"]["segments"] == 2
    assert summary["residual_under_limit"] and summary["seconds"]["recovery"] > 0
    rows = [json.loads(x) for x in open(tmp_path / "o.jsonl")]
    assert rows[-1]["epoch"] == 1 and rows[-1]["counters"]["train.steps"] >= 2
    tags = {json.loads(x)["tag"] for x in open(tmp_path / "tb" / tloop.SCALARS_NAME)}
    assert "train/loss" in tags


def test_the_goodput_ledgers_of_both_trainers_count_alike(variables, tmp_path):
    """Rollback run: the port's and the reference's stitched ledgers agree
    on every count (seconds are each machine's own)."""
    counts = {}
    for name, fit, faults, goodput in (("port", _port_fit, tfaults, tgood),
                                       ("ref", _jax_fit, jfaults, jgood)):
        faults.install_plan("nan_loss@4,nan_loss@5")
        path = str(tmp_path / f"{name}.jsonl")
        fit(variables, str(tmp_path / name), anomaly_max_consecutive=2,
            anomaly_rollback=True, goodput_path=path)
        faults.install_plan("")
        merged = goodput.stitch(path)
        counts[name] = (merged["counts"], merged["segments"], merged["last_step"],
                        [r["reason"] for r in merged["segment_rows"]])
    port, ref = counts["port"], counts["ref"]
    # one departure: the port charges the step the detector aborts on as a
    # step (the reference leaves its wall to "other"), so its replay
    # counts as redone too
    assert port[0] == {"steps": ref[0]["steps"] + 1,
                       "steps_redone": ref[0]["steps_redone"] + 1}
    assert port[1:] == ref[1:] and port[3] == ["AnomalyError", "completed"]


def test_the_profile_window_writes_a_chrome_trace(variables, tmp_path):
    _port_fit(variables, profile_dir=str(tmp_path / "p"), profile_start=2,
              profile_steps=2)
    assert [p.name for p in (tmp_path / "p").iterdir()] == ["trace_steps_3_4.json"]
    events = json.load(open(tmp_path / "p" / "trace_steps_3_4.json"))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)

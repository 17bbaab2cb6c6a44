"""The port's training slice against the JAX package, on the CPU.

Losses, schedules, the AdamW chain and the whole train step are held to
the reference on the same inputs: weights initialised by JAX and carried
over with ``params_from_numpy``, tokens and gradients made with numpy.
The JAX train step is the reference's own ``build_train_step`` on a
one-device mesh, with the flash attention's Pallas kernels in interpret
mode; the port runs the plain versions of its kernels (CPU tensors).

Tolerances, all f32:
- losses and learning rates: 1e-6 relative (the same arithmetic in
  another summation order; the losses are ~4.6);
- Adam moments and params after a few updates: Adam divides by sqrt(v), so
  an ulp-level difference in a gradient near 0 can move its update by up
  to a whole learning rate.  Params are held to 1e-3 of the summed
  learning rates of the run (observed: ~2e-5 of it); the losses, which see
  every parameter, to 1e-5 relative (observed: ~1e-7).
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

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.parallel import create_mesh, shard_batch
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import transformer as tw

jwork = importlib.import_module("distributeddeeplearning_tpu.workloads.transformer")

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=97)
SEQ, BATCH, STEPS = 32, 4, 4
PEAK_LR = 1e-2
RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, atol):
    for name, leaf in want.items():
        if isinstance(leaf, dict):
            _close_tree(got[name], leaf, atol)
        else:
            np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(leaf),
                                       atol=atol, rtol=0, err_msg=name)


# ---- losses ------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 6).astype(np.int32)
    want = jstep.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    label_smoothing=smoothing)
    got = tstep.cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_topk_correct_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(32, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 32).astype(np.int32)
    for k in (1, 5, 9):
        want = float(jstep.topk_correct(jnp.asarray(logits), jnp.asarray(labels), k))
        got = tstep.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), k)
        assert got.item() == want


@pytest.fixture(scope="module")
def jparams():
    return jpt.init_params(jax.random.key(0), max_len=SEQ, **CFG)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _tparams(jparams):
    return tpt.params_from_numpy(_np_tree(jparams), device="cpu")


def test_next_token_loss_matches_jax(jparams, tokens):
    logits = jpt.forward(jparams, jnp.asarray(tokens), num_heads=CFG["num_heads"])
    want = jpt.next_token_loss(logits, jnp.asarray(tokens))
    got = tpt.next_token_loss(torch.from_numpy(np.array(logits)),
                              torch.from_numpy(tokens))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("loss_chunk", [None, 31])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_per_token_loss_matches_jax(jparams, tokens, loss_chunk, attention):
    """Per-position losses, one-shot and chunked (31 | s-1), and their
    gradient through the port's remat (checkpointed layers and chunks)."""
    want = jpt.per_token_loss(jparams, jnp.asarray(tokens),
                              num_heads=CFG["num_heads"], attention=attention,
                              loss_chunk=loss_chunk)
    tp = _tparams(jparams)
    got = tpt.per_token_loss(tp, torch.from_numpy(tokens),
                             num_heads=CFG["num_heads"], attention=attention,
                             loss_chunk=loss_chunk)
    assert tuple(got.shape) == (BATCH, SEQ - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    def jloss(p):
        return jpt.per_token_loss(p, jnp.asarray(tokens), num_heads=CFG["num_heads"],
                                  attention="dense", remat=True,
                                  loss_chunk=loss_chunk).mean()

    jgrad = jax.grad(jloss)(jparams)
    leaf = tp["blocks"]["qkv"].requires_grad_(True)
    tloss = tpt.per_token_loss(tp, torch.from_numpy(tokens),
                               num_heads=CFG["num_heads"], attention=attention,
                               remat=True, loss_chunk=loss_chunk).mean()
    (g,) = torch.autograd.grad(tloss, leaf)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad["blocks"]["qkv"]),
                               atol=1e-6)


# ---- schedules and optimizer ---------------------------------------------

SCHEDULES = {
    "warmup_linear_decay": (
        lambda m: m.warmup_linear_decay_schedule(3e-4, 20, warmup_fraction=0.2)),
    "constant": lambda m: m.constant_schedule(0.05),
    "goyal": lambda m: m.goyal_lr_schedule(0.0125, 8, 3, warmup_epochs=2,
                                           decay_epochs=(3, 5)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax_at_every_step(name):
    want = SCHEDULES[name](jsched)
    got = SCHEDULES[name](tsched)
    for step in range(25):
        w = float(want(step))
        assert got(step) == pytest.approx(w, rel=RTOL, abs=1e-12), step
        on_device = got(torch.tensor(step, dtype=torch.int32))
        assert float(on_device) == pytest.approx(w, rel=RTOL, abs=1e-12), step


@pytest.mark.parametrize("grad_scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_adamw_matches_optax(grad_scale):
    """Four updates of the clipped AdamW chain, with a gradient norm above
    the clip (10x) and below it (0.01x)."""
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "blocks": {"b": rng.normal(size=(4,)).astype(np.float32)}}
    sched_args = (1e-1, 8)
    jtx = jstate.adamw(jsched.warmup_linear_decay_schedule(*sched_args),
                       weight_decay=0.01, grad_clip_norm=1.0)
    ttx = tstate.adamw(tsched.warmup_linear_decay_schedule(*sched_args),
                       weight_decay=0.01, grad_clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jtx.init(jp)
    tp = tpt.params_from_numpy(params, device="cpu")
    topt = ttx.init(tp)
    for _ in range(4):
        g = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * grad_scale).astype(np.float32),
            params)
        updates, jopt = jtx.update(jax.tree.map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.apply(tp, tpt.params_from_numpy(g, device="cpu"), topt)
    _close_tree(tp, jp, atol=1e-6)
    _close_tree(topt["mu"], jopt[1][0].mu, atol=1e-6)
    _close_tree(topt["nu"], jopt[1][0].nu, atol=1e-6)
    assert int(topt["count"]) == int(jopt[1][0].count) == 4


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_matches_optax(nesterov):
    """Four updates of the reference's SGD (coupled weight decay, momentum,
    Goyal schedule)."""
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(6,)).astype(np.float32)}
    jtx = jstate.sgd_momentum(jsched.goyal_lr_schedule(0.1, 2, 2),
                              nesterov=nesterov, weight_decay=0.01)
    ttx = tstate.sgd_momentum(tsched.goyal_lr_schedule(0.1, 2, 2),
                              nesterov=nesterov, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jtx.init(jp)
    tp = tpt.params_from_numpy(params, device="cpu")
    topt = ttx.init(tp)
    for _ in range(4):
        g = {"w": rng.normal(size=(6,)).astype(np.float32)}
        updates, jopt = jtx.update(jax.tree.map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.apply(tp, tpt.params_from_numpy(g, device="cpu"), topt)
    _close_tree(tp, jp, atol=1e-6)


# ---- the slice as a whole: train step against the JAX train step ---------

def _lm_hooks(F, next_token_loss, topk_correct):
    def lm_loss(logits, labels, *, label_smoothing=0.0):
        return next_token_loss(logits, labels)

    def lm_metrics(logits, toks, loss):
        b, s = toks.shape
        flat = logits[:, :-1].reshape(b * (s - 1), -1)
        return {"loss": F(loss), "top1": topk_correct(
            flat, toks[:, 1:].reshape(b * (s - 1)), 1)}

    return lm_loss, lm_metrics


def _poisoned(logits, toks, vocab, where, nan):
    # tokens >= vocab mark a poisoned row: its logits become NaN
    return logits + where((toks >= vocab)[..., None], nan, 0.0)


def _jax_step(jparams, attention, **kw):
    V = CFG["vocab_size"]

    def apply_fn(variables, toks, train=True, mutable=None, rngs=None):
        logits = jpt.forward(variables["params"], toks % V,
                             num_heads=CFG["num_heads"], attention=attention)
        out = _poisoned(logits, toks, V, jnp.where, jnp.nan)
        return (out, {}) if mutable is not None else out

    sched = jsched.warmup_linear_decay_schedule(PEAK_LR, 2 * STEPS,
                                                warmup_fraction=0.25)
    tx = jstate.adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)
    params = jax.tree.map(jnp.array, jparams)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={},
                              apply_fn=apply_fn, tx=tx)
    loss, metrics = _lm_hooks(lambda x: x.astype(jnp.float32),
                              jpt.next_token_loss, jstep.topk_correct)
    mesh = create_mesh(devices=jax.devices()[:1])
    step = jstep.build_train_step(mesh, state, compute_dtype=jnp.float32,
                                  schedule=sched, loss_fn=loss,
                                  metrics_fn=metrics, **kw)
    return mesh, state, step


def _port_step(jparams, attention, **kw):
    V = CFG["vocab_size"]

    def apply_fn(p, toks, **_):
        logits = tpt.forward(p, toks % V, num_heads=CFG["num_heads"],
                             attention=attention)
        return _poisoned(logits, toks, V, torch.where, float("nan"))

    sched = tsched.warmup_linear_decay_schedule(PEAK_LR, 2 * STEPS,
                                                warmup_fraction=0.25)
    tx = tstate.adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)
    state = tstate.TrainState.create(params=_tparams(jparams),
                                     apply_fn=apply_fn, tx=tx)
    loss, metrics = _lm_hooks(lambda x: x.float(), tpt.next_token_loss,
                              tstep.topk_correct)
    step = tstep.build_train_step(state, compute_dtype=torch.float32,
                                  schedule=sched, loss_fn=loss,
                                  metrics_fn=metrics, **kw)
    return state, step, sum(float(sched(i)) for i in range(STEPS))


CASES = {
    "dense": ("dense", {}, None),
    "flash": ("flash", {}, None),
    "flash-accum2": ("flash", {"accum_steps": 2}, None),
    "flash-skip-nonfinite": ("flash", {"skip_nonfinite": True}, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax_build_train_step(jparams, case):
    """Four steps of the port's build_train_step == the JAX
    build_train_step (1-device mesh): per-step loss, lr and top1, and the
    final params.  In the skip_nonfinite case step 1 is fed a NaN batch:
    the update is discarded on both sides, step still advances, and the
    metrics flag it."""
    attention, kw, nan_step = CASES[case]
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    mesh, jst, jstep_fn = _jax_step(jparams, attention, **kw)
    tst, tstep_fn, lr_sum = _port_step(jparams, attention, **kw)
    for i, toks in enumerate(batches):
        inp = toks + CFG["vocab_size"] if i == nan_step else toks
        batch = {"input": inp, "label": toks}
        jst, jm = jstep_fn(jst, shard_batch(mesh, batch))
        tst, tm = tstep_fn(tst, batch)
        assert tst.step == int(jst.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=RTOL)
        if i == nan_step:
            assert not np.isfinite(float(tm["loss"])) and float(tm["anomalous"]) == 1.0
            assert float(jm["anomalous"]) == 1.0
            continue
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["top1"]), float(jm["top1"]), atol=1e-6)
        if nan_step is not None:
            assert float(tm["anomalous"]) == float(jm["anomalous"]) == 0.0
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-4)
    _close_tree(tst.params, _np_tree(jst.params), atol=1e-3 * lr_sum)
    assert int(tst.opt_state["count"]) == int(jst.opt_state[1][0].count) == (
        STEPS - (nan_step is not None))


def test_skipped_update_leaves_params_unchanged(jparams):
    tst, step, _ = _port_step(jparams, "dense", skip_nonfinite=True)
    before = {k: v.detach().clone() for k, v in tst.params["blocks"].items()}
    toks = np.ones((BATCH, SEQ), np.int32)
    tst, m = step(tst, {"input": toks + CFG["vocab_size"], "label": toks})
    assert tst.step == 1 and int(tst.opt_state["count"]) == 0
    assert float(m["anomalous"]) == 1.0
    for k, v in tst.params["blocks"].items():
        assert torch.equal(v, before[k])


def test_comm_arguments_raise():
    """The reference's argument errors: the comm knobs need comm_overlap,
    comm_dtype is one of COMM_DTYPES, and the comm step needs the state
    whose params make its bucket layout."""
    for kw in ({"weight_update_sharding": True}, {"comm_dtype": "bf16"},
               {"comm_skip": True}):
        with pytest.raises(ValueError, match="require comm_overlap"):
            tstep.build_train_step(None, **kw)
    with pytest.raises(ValueError, match="comm_dtype"):
        tstep.build_train_step(None, comm_overlap=True, comm_dtype="fp8")
    with pytest.raises(ValueError, match="state_example"):
        tstep.build_train_step(None, comm_overlap=True)


# ---- loop and workload -----------------------------------------------------

def test_evaluate_weights_batches_by_size():
    def eval_step(state, batch):
        return {"m": torch.tensor(float(batch["input"][0]))}

    trainer = tloop.Trainer(lambda s, b: (s, {}), eval_step=eval_step,
                            config=tloop.TrainerConfig(epochs=1, steps_per_epoch=1))
    batches = [{"input": np.full(3, 1.0)}, {"input": np.full(1, 5.0)}]
    assert trainer.evaluate(None, iter(batches)) == {"m": pytest.approx(2.0)}


def test_token_batches_match_the_reference():
    args = (4, 9, 31, 7, 12, False)
    for j, t in zip(jwork._token_batches(*args), tw._token_batches(*args)):
        np.testing.assert_array_equal(j["input"], t["input"])


TINY = dict(batch_size=4, seq_len=16, vocab_size=37, num_layers=2, d_model=32,
            num_heads=4, d_ff=64, compute_dtype="float32", device="cpu")


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_workload_main_learns_the_repeated_batch(tmp_path, attention):
    path = tmp_path / "metrics.jsonl"
    before = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    state, result = tw.main(epochs=3, steps_per_epoch=3, train_examples=4,
                            base_lr=1e-2, metrics_path=str(path),
                            attention=attention, **TINY)
    assert (tfa.launches, tfa.launches_dq, tfa.launches_dkv) == before
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert rows[-1]["train_loss"] < rows[0]["train_loss"]
    for key in ("train_loss", "train_top1", "train_perplexity", "train_lr",
                "val_loss", "val_top1", "images_per_second"):
        assert key in rows[-1] and np.isfinite(rows[-1][key]), key
    assert rows[0]["includes_compile"] is True
    assert result.epochs_run == 3 and result.total_images == 36
    assert result.images_per_second > 0
    assert set(result.final_train_metrics) == {"loss", "top1", "perplexity", "lr"}
    assert state.step == 9


def test_workload_main_options_run(tmp_path):
    """remat, loss_chunk, accum_steps and skip_nonfinite through main."""
    _, result = tw.main(epochs=1, steps_per_epoch=2, train_examples=4,
                        attention="flash", remat=True, loss_chunk=5,
                        accum_steps=2, skip_nonfinite=True, **TINY)
    assert set(result.final_train_metrics) == {
        "loss", "perplexity", "grad_norm", "anomalous", "lr"}
    assert all(np.isfinite(v) for v in result.final_train_metrics.values())


# the port takes distributed, the comm knobs, fsdp, tensor and num_slices;
# what it still refuses of them are the reference's argument errors (a
# rendezvous for distributed=True, weight-update sharding with the
# global-norm clip, the comm knobs without comm_overlap, fsdp not dividing
# the vocabulary) and, at a world of one, a mesh of two ranks or a data
# axis of one over two slices
ARG_ERRORS = {"distributed": (ValueError, "MASTER_ADDR"),
              "fsdp": (ValueError, "fsdp=2 must divide vocab_size"),
              "tensor": (ValueError, "not divisible by fixed axes product 2"),
              "num_slices": (ValueError, "data axis 1 not divisible by num_slices 2"),
              "comm_overlap": (ValueError, "SHARD norm"),
              "weight_update_sharding": (ValueError, "require comm_overlap"),
              "comm_dtype": (ValueError, "require comm_overlap")}


@pytest.mark.parametrize("kw", [
    {"pipe": 2}, {"seq": 2}, {"fsdp": 2}, {"tensor": 2}, {"num_slices": 2},
    {"distributed": True}, {"comm_overlap": True, "weight_update_sharding": True},
    {"weight_update_sharding": True}, {"comm_dtype": "bf16"},
    {"sp_block_k": 8}, {"scan_unroll": 2}, {"attention": "ring"},
], ids=lambda kw: next(iter(kw)))
def test_workload_main_refuses_what_the_slice_does_not_take(kw):
    exc, match = ARG_ERRORS.get(next(iter(kw)), (NotImplementedError, None))
    with pytest.raises(exc, match=match):
        tw.main(epochs=1, steps_per_epoch=1, train_examples=4, **{**TINY, **kw})


@pytest.mark.parametrize("kw", [
    {"tensorboard_dir": "tb"}, {"profile_dir": "prof"},
    {"anomaly_max_consecutive": 2}, {"anomaly_rollback": True},
    {"step_deadline_s": 10.0},
], ids=lambda kw: next(iter(kw)))
def test_workload_main_takes_the_resilience_flags(tmp_path, kw):
    """The trainer flags the LM workload passes on: a run with each one
    trains to the end; the directory flags leave their files."""
    kw = {k: str(tmp_path / v) if isinstance(v, str) else v for k, v in kw.items()}
    state, result = tw.main(epochs=1, steps_per_epoch=2, train_examples=8,
                            skip_nonfinite=True, **{**TINY, **kw})
    assert state.step == 2 and result.anomalous_steps == 0
    assert np.isfinite(result.final_train_metrics["loss"])
    if "tensorboard_dir" in kw:
        rows = [json.loads(x) for x in open(tmp_path / "tb" / tloop.SCALARS_NAME)]
        assert {r["tag"] for r in rows} >= {"train/loss", "val/loss"}
    if "profile_dir" in kw:
        assert [p.name for p in (tmp_path / "prof").iterdir()] == [
            "trace_steps_1_2.json"]

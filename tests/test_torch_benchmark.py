"""The port's image training path and synthetic benchmark against the JAX
package, on the CPU.

- The synthetic image streams equal the reference's bit for bit.
- Three SGD-momentum train steps of resnet18 (32 px, batch 8, a Goyal
  schedule) through the port's ``build_train_step`` against the
  reference's ``build_train_step`` on a one-device mesh, from the same
  randomised weights and statistics: per-step loss, lr and top1, then the
  params, the momentum and the batch statistics; with ``accum_steps=2``
  (statistics threaded through the microbatches in order) and with
  ``skip_nonfinite`` (a NaN batch: update and statistics both kept).
- The benchmark harness's windows and summary lines, the flag runner and
  ``workloads.benchmark.main`` on the CPU, and what the workload refuses.
- One benchmark train step reads no device value on the host.

Tolerances (f32): per-step loss within 1e-4 relative (train-mode
BatchNorm over 8 values a channel in the last stage amplifies f32
rounding to ~1e-5 in the logits, see ``test_torch_resnet.py``), lr within
1e-6 relative (optax's schedule in f32 arithmetic, the port's in double
rounded once), top1 equal; params within 1e-3 of the run's summed learning rate;
momentum and batch statistics within 1e-3 of each leaf's largest value.
"""

from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_image import randomized, tree_errors
from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.parallel import create_mesh, shard_batch
from distributeddeeplearning_tpu.train import benchmark as jbench
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.data import synthetic as tsynth
from distributeddeeplearning_tpu_torch.models import _convnet
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.train import benchmark as tbench
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import _runner as trunner
from distributeddeeplearning_tpu_torch.workloads import benchmark as twork

jrunner = importlib.import_module("distributeddeeplearning_tpu.workloads._runner")
jwork = importlib.import_module("distributeddeeplearning_tpu.workloads.benchmark")

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.rsqrt):  # see test_torch_bert.py
    _fn(torch.ones(1 << 16))

CLASSES, SIZE, BATCH, STEPS = 10, 32, 8, 3
LOSS_RTOL = {"f32": 1e-5, "f64": 1e-6}  # from the same state
F32_APART_RTOL = 2e-2  # f32 steps after the first: the runs have parted
F64_RTOL = 5e-4
SCHED = (0.0125, 8, 2)  # base lr, replicas, steps an epoch: warmup over 5 epochs


# ---- synthetic images -------------------------------------------------------

@pytest.mark.parametrize("length,batch,drop", [(8, 4, True), (7, 3, False),
                                               (7, 3, True)])
def test_synthetic_image_dataset_equals_the_reference(length, batch, drop):
    kw = dict(length=length, image_shape=(5, 6, 3), num_classes=11, seed=3)
    want = list(jsynth.SyntheticDataset(**kw).batches(batch, drop_remainder=drop))
    got = list(tsynth.SyntheticDataset(**kw).batches(batch, drop_remainder=drop))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["image", "label"]
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes()


def test_synthetic_batch_and_stream_equal_the_reference():
    assert tsynth.DEFAULT_IMAGE_SHAPE == jsynth.DEFAULT_IMAGE_SHAPE == (224, 224, 3)
    pairs = [(jsynth.synthetic_batch(4, (7, 7, 3), 13, seed=5),
              tsynth.synthetic_batch(4, (7, 7, 3), 13, seed=5)),
             (jsynth.synthetic_batch(2, dtype=np.float16),
              tsynth.synthetic_batch(2, dtype=np.float16))]
    pairs += list(zip(jsynth.synthetic_batches(3, 4, (6, 5, 3), 9, seed=2),
                      tsynth.synthetic_batches(3, 4, (6, 5, 3), 9, seed=2)))
    assert len(pairs) == 6
    for w, g in pairs:
        for key in ("image", "label"):
            assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes()
    assert len(tsynth.SyntheticDataset(length=5)) == 5


# ---- the train step against the JAX train step --------------------------------

@pytest.fixture(scope="module")
def variables():
    model = jget_model("resnet18", num_classes=CLASSES, dtype=jnp.float32)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    return randomized(init(jax.random.key(1)), seed=1, head_scale=1.0)


def _batches(nan_step=None):
    out = []
    for i, b in enumerate(jsynth.synthetic_batches(BATCH, STEPS, (SIZE, SIZE, 3),
                                                   CLASSES, seed=4)):
        if i == nan_step:
            b["image"] = b["image"].copy()
            b["image"][0, 0, 0, 0] = np.nan
        out.append(b)
    return out


CASES = {"plain": ({}, None), "accum2": ({"accum_steps": 2}, None),
         "skip-nonfinite": ({"skip_nonfinite": True}, 1)}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _steps(variables, case, dtype):
    """Run the case's steps through both train steps at ``dtype`` (JAX in
    float64 under ``jax.enable_x64``); yields (step, port state, port
    metrics, JAX state, JAX metrics)."""
    kw, nan_step = CASES[case]
    f64 = dtype == "f64"
    nv = _f64(variables) if f64 else variables
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    tsch = tsched.goyal_lr_schedule(*SCHED)
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    tst = tstate.TrainState.create(
        params=tv["params"], batch_stats=tv["batch_stats"], tx=tstate.sgd_momentum(tsch),
        apply_fn=tmodels.get_model("resnet18", num_classes=CLASSES, dtype=tdt))
    tfn = tstep.build_train_step(tst, compute_dtype=tdt, schedule=tsch, **kw)
    with jax.enable_x64(f64):
        jsch = jsched.goyal_lr_schedule(*SCHED)
        jtx = jstate.sgd_momentum(jsch)
        params = jax.tree.map(jnp.asarray, nv["params"])
        jst = jstate.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=jtx.init(params),
            batch_stats=jax.tree.map(jnp.asarray, nv["batch_stats"]),
            apply_fn=jget_model("resnet18", num_classes=CLASSES, dtype=jdt).apply,
            tx=jtx)
        mesh = create_mesh(devices=jax.devices()[:1])
        jfn = jstep.build_train_step(mesh, jst, compute_dtype=jdt, schedule=jsch, **kw)
        for i, batch in enumerate(_batches(nan_step)):
            jst, jm = jfn(jst, shard_batch(mesh, batch))
            tst, tm = tfn(tst, batch)
            yield i, tst, tm, jst, jax.tree.map(float, jm)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_resnet_train_step_matches_jax_build_train_step(variables, case, dtype):
    """Float64 on both sides: per-step loss, lr, top1, the guard's flags
    and grad norm, then the params, momentum and statistics after every
    step.  f32: the same metrics, tight at the first step (same state),
    loose after it.  In f32 the runs part: train-mode BatchNorm over 4-8
    values a channel makes single gradient leaves ill-conditioned, and
    either side's f32 convolutions can land a leaf 1e-1 off a float64 run
    (JAX's stage-3 projection kernel at 64 px, the port's stage-4 3x3
    kernel at batch 16; every other leaf within 4e-5), so f32 params are
    not compared."""
    nan_step = CASES[case][1]
    stats = None
    for i, tst, tm, jst, jm in _steps(variables, case, dtype):
        assert tst.step == int(jst.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), jm["lr"], rtol=1e-6)
        if i == nan_step:
            assert float(tm["anomalous"]) == jm["anomalous"] == 1.0
            assert not np.isfinite(float(tm["loss"]))
            kept = _convnet.variables_to_numpy({"batch_stats": tst.batch_stats})
            for a, b in zip(jax.tree.leaves(kept), jax.tree.leaves(stats)):
                assert a.tobytes() == b.tobytes()
            continue
        rtol = LOSS_RTOL[dtype] if dtype == "f64" or i == 0 else F32_APART_RTOL
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"], rtol=rtol)
        if rtol < F32_APART_RTOL:
            np.testing.assert_allclose(float(tm["top1"]), jm["top1"], atol=1e-6)
        if nan_step is not None:
            assert float(tm["anomalous"]) == jm["anomalous"] == 0.0
            np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"],
                                       rtol=max(rtol, 1e-3))
        stats = _convnet.variables_to_numpy({"batch_stats": tst.batch_stats})
        if dtype == "f32":
            continue
        errors = tree_errors({"params": tst.params}, {"params": jst.params})
        errors.update({"trace" + k: v for k, v in tree_errors(
            {"params": tst.opt_state["trace"]},
            {"params": jst.opt_state[1][0].trace}).items()})
        errors.update(tree_errors({"batch_stats": tst.batch_stats},
                                  {"batch_stats": jst.batch_stats}))
        assert len(errors) == 2 * len(jax.tree.leaves(jst.params)) + len(
            jax.tree.leaves(jst.batch_stats))
        worst = max(errors, key=errors.get)
        assert errors[worst] < F64_RTOL, (i, worst, errors[worst])
    assert int(tst.opt_state["count"]) == STEPS - (nan_step is not None)


def test_eval_step_reads_the_running_statistics(variables):
    tv = _convnet.variables_from_numpy(variables, device="cpu")
    model = tmodels.get_model("resnet18", num_classes=CLASSES, dtype=torch.float32)
    tst = tstate.TrainState.create(params=tv["params"], batch_stats=tv["batch_stats"],
                                   apply_fn=model,
                                   tx=tstate.sgd_momentum(tsched.constant_schedule(0.1)))
    batch = _batches()[0]
    metrics = tstep.build_eval_step(tst, compute_dtype=torch.float32)(tst, batch)
    jmodel = jget_model("resnet18", num_classes=CLASSES, dtype=jnp.float32)
    want = jstep.cross_entropy_loss(
        jmodel.apply(variables, jnp.asarray(batch["image"]), train=False),
        jnp.asarray(batch["label"]))
    np.testing.assert_allclose(float(metrics["loss"]), float(want), rtol=1e-5)
    assert tst.step == 0


def test_aux_head_model_trains_on_both_heads_and_reports_the_main_one():
    """inceptionv3 with its aux head: ``loss_fn`` gets (main, aux) whole,
    top1 reads the main head."""
    from distributeddeeplearning_tpu_torch.models.inception import inception_aux_loss

    model = tmodels.get_model("inceptionv3", num_classes=CLASSES, aux_logits=True,
                              dtype=torch.float32)
    st = tstate.create_train_state(torch.Generator().manual_seed(0), model,
                                   (2, 75, 75, 3),
                                   tstate.sgd_momentum(tsched.constant_schedule(0.01)),
                                   device="cpu")
    seen = []

    def loss_fn(outputs, labels, **kw):
        seen.append(outputs)
        return inception_aux_loss(outputs, labels, **kw)

    def metrics_fn(logits, labels, loss):
        seen.append(logits)
        return tstep.classification_metrics(logits, labels, loss)

    step = tstep.build_train_step(st, compute_dtype=torch.float32, loss_fn=loss_fn,
                                  metrics_fn=metrics_fn)
    batch = tsynth.synthetic_batch(2, (75, 75, 3), CLASSES)
    before = st.batch_stats["InceptionAux_0"]["ConvBN_0"]["BatchNorm_0"]["var"].clone()
    st, m = step(st, batch)
    assert isinstance(seen[0], tuple) and len(seen[0]) == 2
    assert torch.equal(seen[1], seen[0][0].detach())
    assert np.isfinite(float(m["loss"]))
    after = st.batch_stats["InceptionAux_0"]["ConvBN_0"]["BatchNorm_0"]["var"]
    assert not torch.equal(before, after)


# ---- the LM and BERT steps are unchanged --------------------------------------

def test_stat_free_models_never_see_batch_stats():
    """A model without statistics is called exactly as before: no
    ``batch_stats`` keyword, and the state's statistics stay ``{}``."""
    cfg = dict(num_layers=1, d_model=16, num_heads=2, d_ff=32, vocab_size=13,
               max_len=8)
    params = tpt.init_params(device="cpu", **cfg)

    def apply_fn(p, toks, *, train, generator):
        return tpt.forward(p, toks, num_heads=2)

    def lm_loss(logits, labels, *, label_smoothing=0.0):
        return tpt.next_token_loss(logits, labels)

    st = tstate.TrainState.create(params=params, apply_fn=apply_fn,
                                  tx=tstate.adamw(tsched.constant_schedule(1e-3)))
    step = tstep.build_train_step(st, compute_dtype=torch.float32, loss_fn=lm_loss,
                                  metrics_fn=lambda l, t, loss: {"loss": loss})
    toks = np.random.default_rng(0).integers(0, 13, (2, 8)).astype(np.int32)
    for _ in range(2):
        st, m = step(st, {"input": toks, "label": toks})
    assert st.batch_stats == {} and st.step == 2 and np.isfinite(float(m["loss"]))
    metrics = tstep.build_eval_step(st, compute_dtype=torch.float32,
                                    loss_fn=lm_loss,
                                    metrics_fn=lambda l, t, loss: {"loss": loss})(
        st, {"input": toks, "label": toks})
    assert np.isfinite(float(metrics["loss"]))


def test_a_benchmark_train_step_reads_nothing_on_the_host(monkeypatch):
    """The CPU stand-in for the card's sync check: after one warm step,
    a train step of the benchmark model (resident batch, Goyal schedule,
    SGD momentum) calls none of the tensor methods that read a device
    value on the host."""
    model = tmodels.get_model("resnet18", num_classes=CLASSES)
    sched = tsched.goyal_lr_schedule(0.0125, 1, steps_per_epoch=5004)
    st = tstate.create_train_state(torch.Generator().manual_seed(0), model,
                                   (4, SIZE, SIZE, 3), tstate.sgd_momentum(sched),
                                   device="cpu")
    step = tstep.build_train_step(st, schedule=sched)
    batch = {k: torch.as_tensor(v) for k, v in
             tsynth.synthetic_batch(4, (SIZE, SIZE, 3), CLASSES).items()}
    st, _ = step(st, batch)
    calls = []

    def refuse(name):
        def method(self, *args, **kwargs):
            calls.append(name)
            raise AssertionError(f"host read: Tensor.{name}")
        return method

    for name in ("item", "tolist", "numpy", "cpu", "__float__", "__int__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    st, metrics = step(st, batch)
    monkeypatch.undo()
    assert calls == [] and st.step == 2
    assert set(metrics) == {"loss", "top1", "top5", "lr"}
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ---- the harness, the runner and the workload -----------------------------------

@pytest.mark.parametrize("warmup,iters,per_iter", [(10, 10, 10), (0, 1, 3), (2, 3, 1)])
def test_windowed_benchmark_counts_as_the_reference(warmup, iters, per_iter):
    """The reference's windows and summary lines, with one trailing window
    more (see ``train/benchmark.py``)."""
    def counting(results):
        calls = []

        def step(state, batch):
            calls.append(batch)
            return state, {"loss": np.float32(len(calls))}
        return calls, step

    kw = dict(model_name="m", batch_size_per_chip=4, num_devices=1,
              num_warmup_batches=warmup, num_iters=iters,
              num_batches_per_iter=per_iter)
    jcalls, jstep_fn = counting([])
    tcalls, tstep_fn = counting([])
    jres = jbench.run_benchmark(jstep_fn, None, "b", **kw)
    lines = []
    tres = tbench.run_benchmark(tstep_fn, None, "b", log=lines.append, **kw)
    # the port launches one trailing window more than the reference, so
    # that its last measured window is read after the next one's launches
    assert len(jcalls) == warmup + (iters + 1) * per_iter
    assert len(tcalls) == len(jcalls) + per_iter
    assert len(tres.iter_times_s) == len(jres.iter_times_s) == iters
    fields = dict(model="resnet50", batch_size_per_chip=64, num_devices=2,
                  img_sec_per_chip_mean=2500.25, img_sec_per_chip_ci95=12.5,
                  img_sec_total=5000.5, iter_times_s=[0.1])
    assert (tbench.BenchmarkResult(**fields).summary_lines()
            == jbench.BenchmarkResult(**fields).summary_lines())
    assert lines[-5:] == tres.summary_lines()
    data = tbench.run_data_benchmark(tstep_fn, None, iter(range(10 ** 4)), **kw)
    assert len(data.iter_times_s) == iters


def test_every_measured_window_covers_its_launches():
    """A step whose host work outlasts its device work (here all host):
    the last measured window is read after the trailing window's
    launches, so it is as long as the others, not ~0 s."""
    import time

    def step(state, batch):
        time.sleep(0.002)
        return state, {"loss": np.float32(1.0)}

    res = tbench.run_benchmark(step, None, "b", batch_size_per_chip=2,
                               num_warmup_batches=1, num_iters=3,
                               num_batches_per_iter=4)
    assert len(res.iter_times_s) == 3
    assert min(res.iter_times_s) >= 4 * 0.002


ARGVS = [
    ["--model", "resnet18", "--batch-size=8", "--base_lr", "0.1"],
    ["--num_iters=3", "--compute_dtype", "float32", "--distributed", "true"],
    ["--metrics_path", "runs/m.jsonl", "--tensorboard_dir=None",
     "--distributed=0"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_flags_parse_and_coerce_as_the_reference(argv):
    assert trunner.parse_flags(argv) == jrunner.parse_flags(argv)
    raw = trunner.parse_flags(argv)
    assert trunner.coerce_flags(twork.main, raw) == jrunner.coerce_flags(jwork.main, raw)
    for bad in (["model"], ["--model"], ["--no_such_flag", "1"],
                ["--batch_size", "x"]):
        with pytest.raises(SystemExit):
            trunner.coerce_flags(twork.main, trunner.parse_flags(bad))


def test_workload_signature_is_the_reference_plus_device():
    import inspect

    want = inspect.signature(jwork.main).parameters
    got = inspect.signature(twork.main).parameters
    assert list(got) == list(want) + ["device"]
    assert all(got[k].default == want[k].default for k in want)
    assert got["device"].default is None


def test_workload_main_runs_on_the_cpu(tmp_path):
    path = tmp_path / "bench.jsonl"
    result = trunner.run_from_argv(twork.main, [
        "--model", "resnet18", "--batch_size", "2", "--image_size", "32",
        "--num_classes", "7", "--num_iters", "2", "--num_batches_per_iter", "2",
        "--num_warmup_batches", "1", "--compute_dtype", "float32",
        "--metrics_path", str(path), "--device", "cpu"])
    assert result.model == "resnet18" and result.num_devices == 1
    assert len(result.iter_times_s) == 2 and result.batch_size_per_chip == 2
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == [{"model": "resnet18",
                     "img_sec_per_chip": result.img_sec_per_chip_mean,
                     "img_sec_total": result.img_sec_total, "num_devices": 1}]
    bf16 = twork.main(model="vgg11", batch_size=2, image_size=32, num_classes=7,
                      num_iters=1, num_batches_per_iter=1, num_warmup_batches=1,
                      device="cpu")
    assert bf16.img_sec_per_chip_mean > 0


@pytest.mark.parametrize("kw,exc,match", [
    # distributed=True takes a rendezvous (torchrun's environment or an
    # address), as the reference's jax.distributed.initialize does
    pytest.param({"distributed": True}, ValueError, "MASTER_ADDR",
                 id="kw0-ValueError"),
    pytest.param({"data_format": "tfrecords"}, ValueError, "ROADMAP A5",
                 id="kw1-ValueError")])
def test_workload_refuses_what_the_slice_does_not_take(kw, exc, match):
    with pytest.raises(exc, match=match):
        twork.main(device="cpu", **kw)

"""The port's ``utils/`` (hardware peaks and step FLOPs, timer, metrics,
logging, the roofline trace reader) against the JAX package's, on the CPU.

- ``hardware``: None off the card, the table's values for a faked H100,
  and ``mfu`` the reference's formula (over each package's own H100
  peak: the port's 989.4 TFLOP/s, the reference's 989).
- ``step_flops`` against the reference's ``step_flops(lowered)`` of the
  same small LM and ResNet: within ``FLOPS_RTOL`` = 15%.  The two count
  different things.  The port counts the model FLOPs of the matrix
  products and convolutions (three times the forward's), by their
  shapes; XLA's cost model also counts the elementwise work (norms,
  softmax, AdamW: +12% on the one-layer LM), leaves out the padded
  positions of a convolution's windows and the first convolution's input
  gradient (-3% on ResNet-50 at 224 px, -9% on ResNet-18), and counts a
  scanned layer stack's body once (so the LM is held at one layer; the
  port's count of the four-layer LM is the analytic 6NT + attention
  exactly).
- ``Timer``, ``AverageMeter``, ``topk_correct`` (ties broken as
  ``jax.lax.top_k`` breaks them), ``accuracy_topk``,
  ``confidence_interval_95`` and ``setup_logging`` give the reference's
  results on the same inputs (``pmean_metrics`` runs over two gloo ranks in
  ``tests/test_torch_parallel.py``'s spawn).
- ``roofline``: ``program_roofline`` and ``analyze_trace`` give the
  reference's output on the reference's own trace fixtures
  (``tests/test_roofline.py``), and on a hand-written torch.profiler
  trace the documented categories, one lane a device with its streams
  merged, and no guessed bytes or FLOPs.
- The reference's comm-layout restore on another world size (the rule the
  port follows, ``tests/test_torch_model_parallel_train.py``): orbax
  restores weight-update shards whose padded length both worlds share and
  fails, deleting the generation, where a padded length or the
  error-feedback residual's world differs.
"""

from __future__ import annotations

import gzip
import importlib
import json
import logging
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.parallel import MeshSpec as JMeshSpec
from distributeddeeplearning_tpu.parallel import create_mesh as jcreate_mesh
from distributeddeeplearning_tpu.parallel import shard_batch as jshard_batch
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu.utils import hardware as jhw
from distributeddeeplearning_tpu.utils import logging_utils as jlog
from distributeddeeplearning_tpu.utils import metrics as jmetrics
from distributeddeeplearning_tpu.utils import roofline as jroof
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch import utils as tutils
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.utils import hardware as thw
from distributeddeeplearning_tpu_torch.utils import logging_utils as tlog
from distributeddeeplearning_tpu_torch.utils import metrics as tmetrics
from distributeddeeplearning_tpu_torch.utils import roofline as troof

# the packages export the function ``timer`` under the module's name
jtimer = importlib.import_module("distributeddeeplearning_tpu.utils.timer")
ttimer = importlib.import_module("distributeddeeplearning_tpu_torch.utils.timer")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

H100 = "NVIDIA H100 80GB HBM3"
FLOPS_RTOL = 0.15


# -- hardware ---------------------------------------------------------------------

def test_off_the_card_every_peak_is_none():
    assert thw.device_name() is None and thw.peaks() is None
    for fn in (thw.peak_bf16_flops, thw.peak_hbm_gbps, thw.peaks):
        assert fn() is None and fn("cpu") is None and fn("NVIDIA A-Card") is None
    assert thw.mfu(1e12, 5, 1.0) is None


def test_a_faked_card_reads_the_table(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    assert thw.device_name() == H100 and thw.device_name(0) == H100
    assert thw.peak_bf16_flops() == 989.4e12 and thw.peak_hbm_gbps() == 3350.0
    assert thw.peaks()["tf32_flops"] == 494.7e12 and thw.peaks()["f32_flops"] == 67e12
    assert thw.peak_bf16_flops("cuda:0") == 989.4e12
    assert thw.peak_bf16_flops("cpu") is None  # a CPU device, not a card's name
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA X")
    assert thw.peak_bf16_flops() is None
    for name, entry in thw.PEAKS.items():
        assert thw.peak_bf16_flops(name) == entry["bf16_flops"]
        assert entry["bf16_flops"] > entry["tf32_flops"] > entry["f32_flops"] > 0
        assert "data sheet" in entry["source"]


@pytest.mark.parametrize("args,chips", [((275e12, 5, 10.0), 1), ((275e12, 5, 10.0), 2),
                                        ((1.2e15, 40, 3.5), 4)])
def test_mfu_is_the_references_formula(args, chips):
    ref = SimpleNamespace(device_kind=H100)
    want = jhw.mfu(*args, device=ref, n_chips=chips)
    got = thw.mfu(*args, device=H100, n_chips=chips)
    assert got * thw.peak_bf16_flops(H100) == pytest.approx(want * 989e12, rel=1e-12)
    for bad in ((0.0, 5, 1.0), (1e12, 0, 1.0), (1e12, 5, 0.0)):
        assert thw.mfu(*bad, device=H100, n_chips=1) is None
        assert jhw.mfu(*bad, device=ref, n_chips=1) is None


# -- step FLOPs ----------------------------------------------------------------------

LM = dict(d_model=32, num_heads=2, d_ff=64, vocab_size=64)
SEQ, ROWS = 16, 8


def _lm_params_np(layers):
    rng = np.random.default_rng(0)
    d, f, v = LM["d_model"], LM["d_ff"], LM["vocab_size"]

    def nrm(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    return {"embed": nrm(v, d), "pos": nrm(SEQ, d), "head": nrm(d, v),
            "blocks": {"qkv": nrm(layers, d, 3 * d), "proj": nrm(layers, d, d),
                       "w_in": nrm(layers, d, f), "w_out": nrm(layers, f, d),
                       "ln1": 1.0 + nrm(layers, d), "ln2": 1.0 + nrm(layers, d)}}


def _lm_port_flops(layers):
    params = tpt.params_from_numpy(_lm_params_np(layers), device="cpu")
    state = tstate.TrainState.create(
        params=params, tx=tstate.adamw(tsched.constant_schedule(1e-3)),
        apply_fn=lambda p, t, **_: tpt.forward(p, t, num_heads=LM["num_heads"],
                                               attention="flash"))
    toks = np.zeros((ROWS, SEQ), np.int32)
    return thw.step_flops(state, {"input": toks, "label": toks})


def _lm_ref_flops(layers):
    mesh = jcreate_mesh(JMeshSpec(), devices=jax.devices()[:1])
    params = jax.tree.map(jnp.asarray, _lm_params_np(layers))
    tx = jstate.adamw(optax.constant_schedule(1e-3))

    def apply_fn(variables, tokens, train=True, mutable=None, rngs=None):
        out = jpt.forward(variables["params"], tokens,
                          num_heads=LM["num_heads"]).astype(jnp.float32)
        return (out, {}) if mutable is not None else out

    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={},
                              apply_fn=apply_fn, tx=tx)
    step = jstep.build_train_step(
        mesh, state, compute_dtype=jnp.float32,
        loss_fn=lambda lg, lb, label_smoothing=0.0: jpt.next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss})
    toks = np.random.default_rng(1).integers(0, LM["vocab_size"], (ROWS, SEQ)).astype(np.int32)
    return jhw.step_flops(step.lower(state, jshard_batch(mesh, {"input": toks,
                                                                "label": toks})))


def test_lm_step_flops_are_6nt_plus_attention():
    layers, d, f, v = 4, LM["d_model"], LM["d_ff"], LM["vocab_size"]
    n = layers * (4 * d * d + 2 * d * f) + d * v  # the matrix products' weights
    tokens = ROWS * SEQ
    attention = 3 * layers * 4 * ROWS * SEQ * SEQ * d  # QK^T and PV, forward x 3
    assert _lm_port_flops(layers) == 6 * n * tokens + attention


def test_lm_step_flops_are_held_to_the_reference():
    got, want = _lm_port_flops(1), _lm_ref_flops(1)
    assert abs(got / want - 1) <= FLOPS_RTOL, (got, want)


def test_resnet_step_flops_are_held_to_the_reference():
    size, batch = 224, 2
    x = np.random.default_rng(0).standard_normal((batch, size, size, 3)).astype(np.float32)
    y = np.zeros((batch,), np.int32)
    mesh = jcreate_mesh(JMeshSpec(), devices=jax.devices()[:1])
    model = jget_model("resnet18", num_classes=10, dtype=jnp.float32)
    jst = jstate.create_train_state(jax.random.key(0), model, (1, size, size, 3),
                                    jstate.sgd_momentum(optax.constant_schedule(0.1)))
    step = jstep.build_train_step(mesh, jst, compute_dtype=jnp.float32)
    want = jhw.step_flops(step.lower(jst, jshard_batch(mesh, {"image": x, "label": y})))
    net = tmodels.get_model("resnet18", num_classes=10, dtype=torch.float32)
    tst = tstate.create_train_state(torch.Generator().manual_seed(0), net,
                                    (1, size, size, 3),
                                    tstate.sgd_momentum(tsched.constant_schedule(0.1)),
                                    device="cpu")
    got = thw.step_flops(tst, {"image": x, "label": y})
    assert got == 3 * 2 * batch * net.forward_macs(size)
    assert abs(got / want - 1) <= FLOPS_RTOL, (got, want)


@pytest.mark.parametrize("card", [H100, None], ids=["faked-h100", "no-card"])
def test_the_trainer_probes_the_flops_once_for_the_ledger(tmp_path, monkeypatch, card):
    """With the goodput ledger on and a card of known peak, the Trainer's
    first step records ``step_flops`` of that step in the ledger (ref
    ``train/loop.py::_maybe_measure_flops``), and the summary's MFU is
    computed from it; off the card no probe runs and MFU is omitted.  The
    fit's losses are the same either way."""
    from distributeddeeplearning_tpu_torch.obs import goodput as tgood
    from distributeddeeplearning_tpu_torch.train import loop as tloop
    from distributeddeeplearning_tpu_torch.train import step as tstep

    if card is not None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: card)
    params = tpt.params_from_numpy(_lm_params_np(2), device="cpu")
    state = tstate.TrainState.create(
        params=params, tx=tstate.adamw(tsched.constant_schedule(1e-3)),
        apply_fn=lambda p, t, **_: tpt.forward(p, t, num_heads=LM["num_heads"]))
    step = tstep.build_train_step(
        state, compute_dtype=torch.float32,
        loss_fn=lambda lg, lb, label_smoothing=0.0: tpt.next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss})
    toks = np.random.default_rng(3).integers(0, LM["vocab_size"], (ROWS, SEQ)).astype(np.int32)
    batches = [{"input": toks, "label": toks}] * 3
    want = thw.step_flops(state, batches[0])
    path = tmp_path / "goodput.jsonl"
    trainer = tloop.Trainer(step, config=tloop.TrainerConfig(
        epochs=1, steps_per_epoch=3, global_batch_size=ROWS, prefetch=0,
        goodput_path=str(path)))
    trainer.fit(state, lambda start: iter(batches[start:]))
    merged = tgood.stitch(str(path))
    summary = tgood.summarize_ledger(merged, n_chips=1)
    if card is None:
        assert merged["flops_per_step"] is None and summary["mfu"] is None
        assert summary["mfu_omitted_reason"] == "flops_per_step unknown"
        return
    assert merged["flops_per_step"] == want == 6 * (
        2 * (4 * 32 * 32 + 2 * 32 * 64) + 32 * 64) * ROWS * SEQ + 3 * 2 * 4 * ROWS * SEQ * SEQ * 32
    assert summary["mfu"] == pytest.approx(
        want * 3 / merged["total_wall_s"] / 989.4e12, rel=1e-12)


def test_step_flops_is_none_where_the_forward_cannot_run_on_meta():
    state = SimpleNamespace(apply_fn=lambda *a, **k: 1 / 0, params={"w": torch.ones(2)},
                            batch_stats={})
    assert thw.step_flops(state, {"input": np.zeros((2, 3), np.int32)}) is None


# -- timer, metrics, logging ---------------------------------------------------------

class _Clock:
    def __init__(self, times):
        self.times = iter(times)

    def monotonic(self):
        return next(self.times)


class _Hist:
    def __init__(self):
        self.seen = []

    def record(self, s):
        self.seen.append(s)


def test_timer_matches_the_reference(monkeypatch):
    times = [10.0, 10.25, 10.5, 11.0, 11.125, 12.0, 12.5, 13.0]
    got = {}
    for name, mod in (("ref", jtimer), ("port", ttimer)):
        monkeypatch.setattr(mod, "time", _Clock(times))
        lines, hist = [], _Hist()
        t = mod.Timer(report=lines.append, prefix="train", histogram=hist)
        assert not t.running and t.elapsed == 0.0
        t.start()
        running = (t.running, t.elapsed)
        t.stop()

        @mod.timer(report=lines.append, round_ndigits=2)
        def work(x):
            return x * 2

        with mod.Timer(report=lines.append) as inner:
            pass
        got[name] = (running, t.elapsed, lines, hist.seen, work(3), inner.elapsed)
        with pytest.raises(RuntimeError):
            mod.Timer().stop()
    assert got["port"] == got["ref"]


def test_average_meter_matches_the_reference():
    a, b = jmetrics.AverageMeter("x"), tmetrics.AverageMeter("x")
    assert a.avg == b.avg == 0.0
    for val, n in ((1.5, 2), (np.float32(3.25), 1), (torch.tensor(0.5), 4)):
        a.update(float(val), n)
        b.update(val, n)
        assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)
    b.reset()
    assert (b.val, b.sum, b.count) == (0.0, 0.0, 0)


@pytest.mark.parametrize("classes", [3, 10])
def test_topk_correct_and_accuracy_match_the_reference_with_ties(classes):
    """Logits drawn from a few integers tie often; ``jax.lax.top_k`` keeps
    the lower index of a tie, and so does the port."""
    rng = np.random.default_rng(classes)
    logits = rng.integers(0, 3, (64, classes)).astype(np.float32)
    labels = rng.integers(0, classes, (64,)).astype(np.int32)
    for k in (1, 2, 3, 5):
        want = float(jmetrics.topk_correct(jnp.asarray(logits), jnp.asarray(labels), k))
        got = tmetrics.topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), k)
        assert got.dtype == torch.float32 and float(got) == want, k
    want = jmetrics.accuracy_topk(jnp.asarray(logits), jnp.asarray(labels), (1, 5))
    got = tmetrics.accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels), (1, 5))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("samples", [[], [3.0], [1.0, 2.0, 4.0, 8.5], list(range(17))])
def test_confidence_interval_matches_the_reference(samples):
    assert tmetrics.confidence_interval_95(samples) == jmetrics.confidence_interval_95(samples)


def test_pmean_metrics_without_a_group_is_the_dict():
    got = tmetrics.pmean_metrics({"loss": torch.tensor(2.5)})
    assert float(got["loss"]) == 2.5


def test_the_package_exports_the_references_names():
    import distributeddeeplearning_tpu.utils as jutils

    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    for name in tutils.__all__:
        assert getattr(tutils, name) is not None


@pytest.fixture()
def bare_root(monkeypatch):
    """The root logger without handlers (pytest installs its own), put
    back afterwards."""
    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", [])
    level = root.level
    yield root
    root.setLevel(level)


def test_setup_logging_matches_the_reference(bare_root, monkeypatch):
    monkeypatch.delenv("LOG_CONFIG", raising=False)
    record = logging.LogRecord("ddlt.x", logging.WARNING, __file__, 1, "hello %s",
                               ("there",), None)
    record.created = 0.0
    lines = {}
    for name, mod in (("ref", jlog), ("port", tlog)):
        bare_root.handlers.clear()
        logger = mod.setup_logging()
        assert logger.name == "ddlt" and bare_root.level == logging.INFO
        (handler,) = bare_root.handlers
        rec = logging.makeLogRecord(record.__dict__)
        assert all(f.filter(rec) for f in handler.filters)
        lines[name] = handler.format(rec)
        mod.setup_logging()  # once: a second call adds nothing
        assert len(bare_root.handlers) == 1
    assert lines["port"] == lines["ref"] and "[p0] WARNING ddlt.x: hello there" in lines["port"]
    assert tlog.get_logger().name == "ddlt" and tlog.get_logger("a").name == "a"
    assert tlog.is_primary()


def test_setup_logging_honours_log_config(bare_root, monkeypatch, tmp_path):
    conf = tmp_path / "logging.conf"
    conf.write_text("[loggers]\nkeys=root\n[handlers]\nkeys=h\n[formatters]\nkeys=f\n"
                    "[logger_root]\nlevel=DEBUG\nhandlers=h\n"
                    "[handler_h]\nclass=StreamHandler\nformatter=f\nargs=(sys.stderr,)\n"
                    "[formatter_f]\nformat=CONF %(message)s\n")
    monkeypatch.setenv("LOG_CONFIG", str(conf))
    tlog.setup_logging()
    (handler,) = bare_root.handlers
    assert bare_root.level == logging.DEBUG
    assert handler.format(logging.makeLogRecord({"msg": "x"})) == "CONF x"


# -- roofline ---------------------------------------------------------------------------

def _write_trace(trace_dir, events, name="host.trace.json.gz"):
    d = os.path.join(trace_dir, "plugins", "profile", "run1")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _dev_event(name, dur_us, nbytes, flops, category, pid=1):
    return {"ph": "X", "name": name, "ts": 0, "dur": dur_us, "pid": pid, "tid": 1,
            "args": {"bytes accessed": str(nbytes), "model flops": str(flops),
                     "hlo_category": category}}


def _mini(tmp):
    events = []
    for _ in range(2):
        events.append(_dev_event("fusion.1", 100.0, 80_000_000, 5_000_000_000,
                                 "convolution fusion"))
        events.append(_dev_event("copy.1", 10.0, 1_000_000, 0, "copy"))
    events.append({"ph": "X", "name": "hostThing", "ts": 0, "dur": 50, "pid": 9,
                   "tid": 9, "args": {}})
    events.append({"ph": "M", "name": "meta", "pid": 1, "args": {}})
    return events, dict(steps=2, global_batch=256)


def _alternate(tmp):
    return ([{"ph": "X", "name": "f", "ts": 0, "dur": 10.0, "pid": 1, "tid": 1,
              "args": {"bytes_accessed": 50_000_000, "flops": 500,
                       "category": "fusion"}}], dict(steps=1))


def _even_lanes(tmp):
    return ([_dev_event("fusion.1", 100.0, 80_000_000, 0, "fusion", pid=p)
             for p in (1, 2)], dict(steps=1))


def _named_streams(tmp):
    events = [{"ph": "M", "name": "process_name", "pid": p,
               "args": {"name": f"/device:TPU:0 stream#{p}"}} for p in (1, 2)]
    events += [_dev_event("fusion.1", dur, 40_000_000, 0, "fusion", pid=p)
               for p, dur in ((1, 100.0), (2, 60.0))]
    return events, dict(steps=1)


@pytest.mark.parametrize("fixture", [_mini, _alternate, _even_lanes, _named_streams],
                         ids=lambda f: f.__name__.strip("_"))
def test_analyze_trace_gives_the_references_output_on_its_fixtures(tmp_path, fixture):
    events, kw = fixture(tmp_path)
    _write_trace(str(tmp_path), events)
    peaks = dict(peak_hbm_gbps=819.0, peak_tflops=394.0)
    want = jroof.analyze_trace(str(tmp_path), **kw, **peaks)
    got = troof.analyze_trace(str(tmp_path), **kw, **peaks)
    assert got == want
    trace = troof.find_trace_file(str(tmp_path))
    assert trace == jroof.find_trace_file(str(tmp_path))
    strip = ("tid",)
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in troof.device_op_events(trace)] == jroof.device_op_events(trace)


def test_analyze_trace_raises_as_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError):
        troof.find_trace_file(str(tmp_path))
    _write_trace(str(tmp_path), [])
    with pytest.raises(ValueError, match="no device HLO events"):
        troof.analyze_trace(str(tmp_path), steps=1, peak_hbm_gbps=1.0, peak_tflops=1.0)


@pytest.mark.parametrize("peaks", [{}, {"peak_tflops": 394.0, "peak_hbm_gbps": 819.0},
                                   {"peak_tflops": 989.4, "peak_hbm_gbps": 3350.0}])
@pytest.mark.parametrize("flops,nbytes,s", [(5e12, 8e10, 0.11), (1e9, 4e9, 0.5),
                                            (7e11, 0.0, 0.02)])
def test_program_roofline_matches_the_reference(flops, nbytes, s, peaks):
    assert troof.program_roofline(flops, nbytes, s, **peaks) == \
        jroof.program_roofline(flops, nbytes, s, **peaks)


def _torch_trace():
    """A torch.profiler chrome trace of two steps on device 0 (pid 0; the
    kernels on streams 7 and 13), a second device's NCCL kernel (pid 1),
    host events, and metadata, as ``export_chrome_trace`` writes them."""
    host = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242,
             "ts": 0, "dur": 30.0, "args": {}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242,
             "tid": 4242, "ts": 1, "dur": 4.0, "args": {}},
            {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
             "args": {"name": "stream 7"}}]
    kernels = [
        ("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 40.0, 7),
        ("kernel", "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", 20.0, 7),
        ("kernel", "void flash_fwd_bf16_kernel<64, false, 2>(FwdParams)", 15.0, 7),
        ("kernel", "void flash_bwd_dq_bf16_kernel<64, false, 2>(BwdParams)", 12.0, 13),
        ("kernel", "void flash_bwd_dkv_bf16_kernel<64, false, 2>(BwdParams)", 18.0, 13),
        ("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::"
                   "AddFunctor<float>>(int, ...)", 5.0, 7),
        ("kernel", "void at::native::reduce_kernel<512, 1>(...)", 3.0, 7),
        ("kernel", "void cudnn::engines_precompiled::nchwToNhwcKernel(...)", 2.0, 7),
        ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 6.0, 7),
        ("gpu_memset", "Memset (Device)", 1.0, 7),
    ]
    events = list(host)
    for step in range(2):
        for cat, name, dur, stream in kernels:
            args = {"device": 0, "stream": stream, "correlation": step}
            if cat in ("gpu_memcpy", "gpu_memset"):
                args["bytes"] = 1_000_000
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
                           "ts": 100 * step, "dur": dur, "args": args})
    events.append({"ph": "X", "cat": "kernel", "pid": 1, "tid": 7, "ts": 0, "dur": 9.0,
                   "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)",
                   "args": {"device": 1, "stream": 7}})
    return events


def test_analyze_trace_reads_a_torch_profiler_trace(tmp_path):
    path = _write_trace(str(tmp_path), _torch_trace(), name="rank0.pt.trace.json")
    assert troof.find_trace_file(str(tmp_path)) == path
    r = troof.analyze_trace(str(tmp_path), steps=2, global_batch=8,
                            peak_hbm_gbps=3350.0, peak_tflops=989.4)
    per_step = 40 + 20 + 15 + 12 + 18 + 5 + 3 + 2 + 6 + 1  # us: both streams of device 0
    assert r["device_lanes_in_trace"] == 2 and r["lane_warning"] is None
    assert r["busiest_lane_share"] == round(2 * per_step / (2 * per_step + 9), 4)
    assert r["device_ms_per_step"] == round(per_step / 1e3, 2)
    cats = r["categories"]
    assert set(cats) == {"gemm", "flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv", "elementwise", "reduction",
                         "copy", "convolution"}
    assert cats["gemm"]["time_ms_per_step"] == pytest.approx(0.06)
    assert cats["copy"]["time_ms_per_step"] == pytest.approx(0.007)
    assert cats["copy"]["gb_per_step"] == pytest.approx(0.002)
    assert cats["copy"]["sustained_gbps"] == pytest.approx(2e6 / 7 / 1e3, abs=0.1)
    assert cats["gemm"]["gb_per_step"] is None and cats["gemm"]["sustained_tflops"] is None
    for key in ("hbm_gb_per_step", "model_gflops_per_step", "sustained_hbm_gbps",
                "sustained_tflops", "bw_bound_time_fraction",
                "bandwidth_ceiling_ms_per_step", "pct_of_bandwidth_ceiling", "verdict",
                "implied_ceiling_img_sec"):
        assert r[key] is None, key  # no byte or FLOP counts on kernels: nothing guessed
    assert r["measured_img_sec_from_trace"] == round(8 / (per_step / 1e6), 1)
    assert r["top_fusions"][0]["name"].startswith("sm90_xmma_gemm")
    nccl = [e for e in troof.device_op_events(path) if e["pid"] == 1]
    assert [e["category"] for e in nccl] == ["nccl"]


def test_analyze_trace_defaults_to_the_cards_peaks(tmp_path, monkeypatch):
    _write_trace(str(tmp_path), _torch_trace(), name="t.trace.json")
    off = troof.analyze_trace(str(tmp_path), steps=2)
    assert off["peak_hbm_gbps"] is None and off["peak_tflops"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
    on = troof.analyze_trace(str(tmp_path), steps=2)
    assert on["peak_hbm_gbps"] == 3350.0 and on["peak_tflops"] == pytest.approx(989.4)


# -- the reference's comm-layout restore on another world ----------------------------

_REF_BERT = []


def _ref_bert_state():
    """TINY BERT's reference state; one model and optimizer pair for every
    state, as a compiled step's static fields want (ref
    ``tests/test_comms.py``)."""
    if not _REF_BERT:
        _REF_BERT.append((
            jget_model("bert-base", num_layers=1, hidden_size=32, num_heads=2,
                       intermediate_size=64, vocab_size=50, num_classes=3,
                       max_position_embeddings=16, dropout_rate=0.0, dtype=jnp.float32),
            jstate.sgd_momentum(optax.constant_schedule(0.05))))
    model, tx = _REF_BERT[0]
    return jstate.create_train_state(jax.random.key(0), model, (2, 8), tx,
                                     input_dtype=jnp.int32)


@pytest.mark.parametrize("case,kw,restores", [
    ("wus-same-length", dict(weight_update_sharding=True), True),
    ("wus-other-length", dict(weight_update_sharding=True), False),
    ("bf16-residual", dict(comm_dtype="bf16", weight_update_sharding=True), False),
])
def test_the_references_comm_layout_restore_on_another_world(tmp_path, case, kw,
                                                             restores):
    """Saved on 4 devices; restored on 2 (the 11876-element vector pads to
    the same length) or 8 (it pads to 11880): the reference restores
    exactly where every global vector keeps its length, which is the
    port's rule; where it fails it deletes the generation, which the port
    does not."""
    from distributeddeeplearning_tpu.train.checkpoint import Checkpointer

    rng = np.random.default_rng(7)
    batch = {"input": rng.integers(0, 50, (32, 8)).astype(np.int32),
             "label": rng.integers(0, 3, (32,)).astype(np.int32)}
    src = jcreate_mesh(JMeshSpec(), devices=jax.devices()[:4])
    step = jstep.build_train_step(src, _ref_bert_state(), compute_dtype=jnp.float32,
                                  comm_overlap=True, bucket_mb=0.004, **kw)
    state = step.prepare_state(_ref_bert_state())
    state, _ = step(state, jshard_batch(src, batch))
    ckpt = Checkpointer(str(tmp_path / "c"), async_save=False)
    ckpt.save(int(state.step), state)
    ckpt.wait()
    n = 2 if case == "wus-same-length" or case == "bf16-residual" else 8
    dst = jcreate_mesh(JMeshSpec(), devices=jax.devices()[:n])
    other = jstep.build_train_step(dst, _ref_bert_state(), compute_dtype=jnp.float32,
                                   comm_overlap=True, bucket_mb=0.004, **kw)
    same = other.layout.padded_total == step.layout.padded_total
    assert same == (case != "wus-other-length")
    template = other.prepare_state(_ref_bert_state())
    if restores:
        restored, at = Checkpointer(str(tmp_path / "c"), async_save=False).restore(template)
        assert at == 1
        for a, b in zip(jax.tree.leaves(state.opt_state), jax.tree.leaves(restored.opt_state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    with pytest.raises(Exception):
        Checkpointer(str(tmp_path / "c"), async_save=False).restore(template)
    assert not (tmp_path / "c" / "1").exists()  # the reference deleted it

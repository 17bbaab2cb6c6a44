"""The port's fault injection (``utils/faults.py``) against the JAX
package's, on the CPU.

The grammar is shared: the same spec strings parse to the same specs
(kinds, triggers, options, ``describe()``) and the same malformed strings
raise the same errors, serve and traffic kinds included.  The seeded
``io_error@p`` fires at the same opportunities, the ``@N`` storage kinds
at the same opportunity, ``nan_loss`` poisons the same positions of the
same numpy batch (and, in the port, of torch tensors), and the data
wrappers stall and die at the same true steps.  No tolerance: every
comparison is exact.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.utils import faults as jfaults
from distributeddeeplearning_tpu_torch.utils import faults as tfaults

torch.set_num_threads(2)  # the suite runs six workers on eight cores


@pytest.fixture(autouse=True)
def _clean_plans(monkeypatch):
    """Every test starts and ends with both process plans empty."""
    monkeypatch.delenv(tfaults.ENV_VAR, raising=False)
    tfaults.install_plan("")
    jfaults.install_plan("")
    yield
    tfaults.install_plan("")
    jfaults.install_plan("")


GOOD = [
    "nan_loss@12,data_stall@30:secs=2,preempt@50,io_error@p=0.05:seed=7",
    "data_death@3",
    "io_error@2",
    "ckpt_corrupt@3:mode=truncate,ckpt_torn@2",
    "ckpt_corrupt@1:mode=manifest",
    "replica_death@5:replica=1,decode_nan@2,decode_stall@4:secs=0.5",
    "reject_admit@p=0.25:seed=3",
    "burst@1:tenant=best_effort:rps=40:secs=4:at=0.5,slow_tenant@2:factor=3",
    " nan_loss@4 , ,preempt@4",
    "",
]

BAD = [
    "explode@3",            # unknown kind
    "nan_loss",             # missing trigger
    "nan_loss@0",           # steps are 1-based
    "io_error@p=1.5",       # probability outside [0, 1]
    "data_stall@5:secs",    # option without value
    "preempt@x",            # step not an integer
    "io_error@p=abc",       # probability not a number
    "nan_loss@-2",
]


def _spec_tuple(s):
    return (s.kind, s.step, s.prob, dict(s.options), s.fired, s.describe())


@pytest.mark.parametrize("text", GOOD)
def test_parse_spec_gives_the_reference_specs(text):
    got = [_spec_tuple(s) for s in tfaults.parse_spec(text)]
    want = [_spec_tuple(s) for s in jfaults.parse_spec(text)]
    assert got == want
    assert tfaults.KINDS == jfaults.KINDS


@pytest.mark.parametrize("text", BAD)
def test_parse_spec_refuses_what_the_reference_refuses(text):
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(text)
    with pytest.raises(ValueError) as got:
        tfaults.parse_spec(text)
    assert str(got.value) == str(want.value)


def _fires(plan, n, site="checkpoint.save"):
    out = []
    for _ in range(n):
        try:
            plan.maybe_io_error(site)
            out.append(False)
        except IOError as exc:
            assert "injected io_error" in str(exc)
            out.append(True)
    return out


@pytest.mark.parametrize("text", ["io_error@p=0.3:seed=7", "io_error@p=0.5",
                                  "io_error@p=0.05:seed=11", "io_error@7"])
def test_io_error_fires_at_the_reference_opportunities(text):
    got = _fires(tfaults.install_plan(text), 200)
    want = _fires(jfaults.install_plan(text), 200)
    assert got == want and any(got)
    if "@p" not in text:
        assert got.index(True) == 6 and sum(got) == 1  # one-shot at the 7th


def test_injected_io_errors_are_the_port_class():
    plan = tfaults.install_plan("io_error@1")
    with pytest.raises(tfaults.InjectedIOError):
        plan.maybe_io_error("metrics")
    assert issubclass(tfaults.InjectedIOError, IOError)
    assert plan.report() == [{"kind": "io_error", "step": 1, "site": "metrics"}]


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(4, 3, 3)).astype(np.float32),
            "weights": rng.normal(size=(4,)).astype(np.float16),
            "label": rng.integers(0, 5, (4,)).astype(np.int32),
            "mask": np.ones((4, 3), np.int8)}


def test_poison_batch_poisons_the_reference_positions():
    text = "nan_loss@2,nan_loss@5"
    tplan, jplan = tfaults.install_plan(text), jfaults.install_plan(text)
    for step in (1, 2, 2, 3, 5, 5):
        batch = _batch(step)
        got, want = tplan.poison_batch(step, batch), jplan.poison_batch(step, batch)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
    assert [e.kind for e in tplan.events] == [e.kind for e in jplan.events] == [
        "nan_loss", "nan_loss"]
    assert [e.step for e in tplan.events] == [2, 5]


def test_poison_batch_takes_torch_tensors():
    """After prefetch the loop holds tensors: float tensors become a NaN
    fill on their own device, integer ones pass through untouched, and
    the source tensor is not written."""
    plan = tfaults.install_plan("nan_loss@1")
    src = {k: torch.from_numpy(v) for k, v in _batch().items()}
    before = {k: v.clone() for k, v in src.items()}
    got = plan.poison_batch(1, src)
    assert torch.isnan(got["image"]).all() and got["image"].dtype == torch.float32
    assert torch.isnan(got["weights"]).all()
    assert got["label"] is src["label"] and got["mask"] is src["mask"]
    for k, v in src.items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("module", [tfaults, jfaults], ids=["port", "reference"])
def test_nan_loss_on_a_float_free_batch_is_loud(module):
    plan = module.install_plan("nan_loss@1")
    with pytest.raises(ValueError, match="no float array"):
        plan.poison_batch(1, {"input": np.zeros((2, 3), np.int32)})
    if module is tfaults:
        plan = module.install_plan("nan_loss@1")
        with pytest.raises(ValueError, match="no float array"):
            plan.poison_batch(1, {"input": torch.zeros(2, 3, dtype=torch.int64)})


def test_data_faults_wrap_the_stream_as_the_reference():
    text = "data_stall@2:secs=0.05,data_death@4"
    out = {}
    for name, module in (("port", tfaults), ("reference", jfaults)):
        plan = module.install_plan(text)
        stream = plan.wrap_data(iter([{"x": i} for i in range(6)]), start_step=1)
        seen, t0 = [], time.perf_counter()
        with pytest.raises(module.DataStreamDeath) as exc:
            for b in stream:
                seen.append(b["x"])
        out[name] = (seen, exc.value.step, [e.kind for e in plan.events])
        assert time.perf_counter() - t0 >= 0.05
    assert out["port"] == out["reference"] == ([0, 1], 4, ["data_stall", "data_death"])


def test_a_plan_without_data_faults_returns_the_stream_itself():
    it = iter([1, 2])
    assert tfaults.install_plan("nan_loss@1").wrap_data(it) is it


def test_checkpoint_kinds_fire_at_the_reference_opportunity():
    text = "ckpt_torn@2,ckpt_corrupt@3:mode=truncate"
    tplan, jplan = tfaults.install_plan(text), jfaults.install_plan(text)
    got = [(tplan.take_ckpt_torn(), tplan.take_ckpt_corrupt()) for _ in range(5)]
    want = [(jplan.take_ckpt_torn(), jplan.take_ckpt_corrupt()) for _ in range(5)]
    assert got == want
    assert got[1][0] is True and got[2][1] == {"mode": "truncate"}


def test_step_keyed_faults_fire_once_per_plan(monkeypatch):
    """One-shot per plan: preempt@3 does not fire again on the same plan
    (an in-process restart); a new plan (reset, install_plan) re-arms it,
    and install_plan('') disarms everything."""

    class Guard:
        def __init__(self):
            self.reasons = []

        def trigger(self, reason):
            self.reasons.append(reason)

    g = Guard()
    plan = tfaults.install_plan("preempt@3")
    assert [plan.maybe_preempt(s, g) for s in (1, 2, 3, 3)] == [False, False, True, False]
    assert g.reasons == ["injected preempt@3"]
    assert tfaults.get_plan() is plan
    monkeypatch.setenv(tfaults.ENV_VAR, "preempt@3")
    fresh = tfaults.reset()
    assert fresh is not plan and fresh.maybe_preempt(3, g)
    assert not tfaults.install_plan("")
    assert not tfaults.get_plan()

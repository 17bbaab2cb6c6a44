"""The port's int8 WEIGHT path on the CPU (``quant/qtensor.py``'s QTensor,
``quantize``, ``dequantize``, ``qdot``, ``qmatmul`` and
``quant/calibrate.py``) against the JAX package, on the same numpy inputs.

Tolerances.
- ``quantize`` with the absmax observer, ``dequantize`` and ``qdot``'s
  activation codes: BITWISE (the same op order, a true division, round
  half to even on both sides).
- ``qdot``'s int32 accumulator: EXACT, and equal to a float64 product of
  the same int8 values (|acc| < 2^53); its f32 output within 1e-6
  relative of a float64 rescale of the accumulator.
- The percentile observer: ``jnp.percentile`` under XLA folds
  ``percentile / 100 * (n - 1)`` into one constant, which lands a few ulps
  off the IEEE f32 order numpy's linear interpolation uses (at 100 it
  returns less than the max).  The port keeps the IEEE order: it is held
  to numpy's percentile within 1e-6 relative and to JAX's within 1e-4
  relative (measured: 1.2e-7 and 3.7e-5 on a [3, 768, 3072] leaf); the
  codes it gives differ from JAX's by at most one step, on 0.02% of
  entries there.
- Model outputs through int8 weights: the f32 logit tolerance of the
  other port tests (``atol 5e-5, rtol 1e-5``) with equal argmax; the
  port and JAX differ by ~3e-9 at this size.  Greedy streams: exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.quant import calibrate as jcal
from distributeddeeplearning_tpu.quant import qtensor as jqt
from distributeddeeplearning_tpu.serve import (
    ContinuousBatchingScheduler as JaxScheduler,
    InferenceEngine as JaxEngine,
    PagedInferenceEngine as JaxPagedEngine,
    Request as JaxRequest,
)
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.quant import calibrate as tcal
from distributeddeeplearning_tpu_torch.quant import qtensor as tqt
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagedInferenceEngine,
    Request,
)

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=3, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=64)
HEADS = CFG["num_heads"]
ATOL, RTOL = 5e-5, 1e-5


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jpt.init_params(jax.random.key(0), **CFG)


@pytest.fixture(scope="module")
def params(jparams):
    return tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


# -- quantize / dequantize ----------------------------------------------------

@pytest.mark.parametrize("shape,block", [
    ((96, 128), None), ((96, 128), 32), ((3, 64, 40), None), ((3, 64, 40), 16),
])
def test_quantize_absmax_and_dequantize_bitwise_equal_jax(shape, block):
    x = _weights(shape)
    jq = jqt.quantize(jnp.asarray(x), block=block)
    tq = tqt.quantize(torch.from_numpy(x), block=block)
    assert (tq.axis, tq.block) == (jq.axis, jq.block)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tqt.dequantize(tq).numpy(),
                                  np.asarray(jqt.dequantize(jq)))
    assert np.abs(tq.values.numpy().astype(int)).max() <= 127


def test_quantize_rejects_a_block_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        tqt.quantize(torch.zeros(10, 4), block=3)


@pytest.mark.parametrize("percentile", [50.0, 99.0, 99.9, 100.0])
def test_percentile_observer_against_numpy_and_jax(percentile):
    """A sort and numpy's linear interpolation: within 1e-6 of numpy, and
    of ``jnp.percentile`` within the constant-folding error (module
    docstring); at 100 it is exactly the max."""
    x = _weights((3, 768, 256), seed=1)
    got = tcal.PercentileObserver(percentile)(torch.from_numpy(x), -2).numpy()
    ref = np.percentile(np.abs(x), percentile, axis=-2, keepdims=True)
    jax_ref = np.asarray(
        jcal.PercentileObserver(percentile)(jnp.asarray(x), -2))
    assert got.shape == jax_ref.shape == (3, 1, 256)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, jax_ref, rtol=1e-4, atol=0)
    if percentile == 100.0:
        np.testing.assert_array_equal(got, np.abs(x).max(-2, keepdims=True))
    with pytest.raises(ValueError, match="percentile"):
        tcal.PercentileObserver(0.0)


@pytest.mark.parametrize("block", [None, 64])
def test_quantize_with_percentile_observer_against_jax(block):
    x = _weights((2, 768, 128), seed=2)
    jq = jqt.quantize(jnp.asarray(x), block=block,
                      observer=jcal.PercentileObserver(99.0))
    tq = tqt.quantize(torch.from_numpy(x), block=block,
                      observer=tcal.PercentileObserver(99.0))
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-4, atol=0)
    step = np.abs(tq.values.numpy().astype(int) - np.asarray(jq.values).astype(int))
    assert step.max() <= 1 and step.mean() < 1e-3
    # the outlier tail saturates at the grid's edge
    assert np.abs(tq.values.numpy().astype(int)).max() == 127


def test_qtensor_indexes_and_moves_values_and_scales_together():
    tq = tqt.quantize(torch.from_numpy(_weights((4, 16, 8))))
    layer = tq[2]
    assert layer.shape == (16, 8) and tuple(layer.scales.shape) == (1, 8)
    assert torch.equal(layer.values, tq.values[2])
    head = tq[:2]
    assert head.shape == (2, 16, 8) and tuple(head.scales.shape) == (2, 1, 8)
    assert (head.axis, head.block, head.ndim, head.dtype) == (-2, None, 3, torch.int8)
    assert tq.to("cpu").values.device.type == "cpu"


# -- qdot / qmatmul -----------------------------------------------------------

@pytest.mark.parametrize("rows,k,n", [(8, 96, 64), (40, 64, 61), (3, 128, 256)])
def test_qdot_accumulator_exact_and_output_matches_jax(rows, k, n):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = _weights((k, n), seed=rows)
    jq = jqt.quantize(jnp.asarray(w))
    tq = tqt.quantize(torch.from_numpy(w))
    # the activation codes, as both sides compute them
    amax = np.abs(x).max(-1, keepdims=True)
    a_scale = np.maximum(amax, np.float32(tqt.EPS)) / np.float32(tqt.QMAX)
    xq = np.clip(np.round(x / a_scale), -127, 127).astype(np.int8)
    acc = tqt.int8_matmul(torch.from_numpy(xq), tq.values)
    jacc = jax.lax.dot_general(
        jnp.asarray(xq), jq.values, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(
        acc.numpy().astype(np.float64),
        xq.astype(np.float64) @ tq.values.numpy().astype(np.float64))
    got = tqt.qdot(torch.from_numpy(x), tq).numpy()
    want = np.asarray(jqt.qdot(jnp.asarray(x), jq))
    np.testing.assert_array_equal(got, want)
    f64 = (acc.numpy().astype(np.float64) * a_scale.astype(np.float64)
           * tq.scales.numpy().astype(np.float64))
    assert np.all(np.abs(got - f64) <= 1e-6 * np.abs(f64))


def test_qdot_takes_the_dequantize_path_under_the_reference_condition():
    """Block-quantized, other-axis or stacked weights: ``x @ dequantize``
    on both sides; plain tensors go through ``@``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = _weights((64, 48), seed=5)
    for kw in (dict(block=16), dict(axis=-1)):
        jq = jqt.quantize(jnp.asarray(w), **kw)
        tq = tqt.quantize(torch.from_numpy(w), **kw)
        got = tqt.qdot(torch.from_numpy(x), tq)
        np.testing.assert_allclose(got.numpy(), np.asarray(jqt.qdot(jnp.asarray(x), jq)),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(
            got.numpy(), (torch.from_numpy(x) @ tqt.dequantize(tq)).numpy())
    stacked = tqt.quantize(torch.from_numpy(_weights((2, 64, 48))))
    np.testing.assert_array_equal(
        tqt.qdot(torch.from_numpy(x), stacked).numpy(),
        (torch.from_numpy(x) @ tqt.dequantize(stacked)).numpy())
    plain = torch.from_numpy(w)
    assert torch.equal(tqt.qmatmul(torch.from_numpy(x), plain),
                       torch.from_numpy(x) @ plain)


def test_int8_matmul_refuses_other_dtypes():
    with pytest.raises(TypeError, match="int8"):
        tqt.int8_matmul(torch.zeros(2, 8), torch.zeros(8, 8, dtype=torch.int8))


# -- quantize_params / params_dtype / calibrate_params ------------------------

@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_quantize_params_matches_jax(jparams, params, method):
    jq = jcal.quantize_params(jparams, method=method)
    tq = tcal.quantize_params(params, method=method)
    assert (tcal.params_dtype(params), tcal.params_dtype(tq)) == (
        jcal.params_dtype(jparams), jcal.params_dtype(jq)) == ("float32", "int8")
    for name in ("embed", "pos"):
        assert tq[name] is params[name]
    assert tq["blocks"]["ln1"] is params["blocks"]["ln1"]
    leaves = [(tq["head"], jq["head"])] + [
        (tq["blocks"][k], jq["blocks"][k]) for k in tcal.BLOCK_MATMUL_LEAVES]
    for t, j in leaves:
        assert isinstance(t, tqt.QTensor) and t.shape == j.shape
        if method == "absmax":
            np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
        else:
            np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales),
                                       rtol=1e-4, atol=0)
    with pytest.raises(ValueError, match="already quantized"):
        tcal.quantize_params(tq)
    with pytest.raises(ValueError, match="unknown observer"):
        tcal.quantize_params(params, method="median")


def test_params_from_numpy_carries_qtensor_leaves(jparams):
    jq = jcal.quantize_params(jparams, block=8)
    tq = tpt.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    for name in tcal.BLOCK_MATMUL_LEAVES:
        t, j = tq["blocks"][name], jq["blocks"][name]
        assert isinstance(t, tqt.QTensor) and (t.axis, t.block) == (j.axis, j.block)
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))


@pytest.mark.parametrize("method", ["absmax", "percentile"])
def test_calibrate_params_report_matches_jax(jparams, params, method):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, CFG["vocab_size"], n).tolist() for n in (5, 9, 16, 3)]
    _, jrep = jcal.calibrate_params(jparams, prompts, num_heads=HEADS, method=method)
    tq, trep = tcal.calibrate_params(params, prompts, num_heads=HEADS, method=method)
    assert tcal.params_dtype(tq) == "int8"
    assert (trep.num_prompts, trep.num_positions, trep.method, trep.percentile) == (
        jrep.num_prompts, jrep.num_positions, jrep.method, jrep.percentile)
    assert trep.greedy_agreement == jrep.greedy_agreement
    # rounded to 6 digits on both sides: one unit of the last digit
    assert abs(trep.logit_mae - jrep.logit_mae) <= 1e-6
    assert abs(trep.logit_mae_max - jrep.logit_mae_max) <= 1e-6
    assert set(trep.to_dict()) == set(jrep.to_dict())
    with pytest.raises(ValueError, match="at least one"):
        tcal.calibrate_params(params, [], num_heads=HEADS)


# -- the model and the engines on int8 weights --------------------------------

def test_int8_weight_forward_and_decode_match_jax(jparams, params):
    jq = jcal.quantize_params(jparams)
    tq = tcal.quantize_params(params)
    toks = np.random.default_rng(8).integers(1, CFG["vocab_size"], (2, 12))
    want = np.asarray(jpt.forward(jq, jnp.asarray(toks), num_heads=HEADS))
    got = tpt.forward(tq, torch.from_numpy(toks), num_heads=HEADS).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    f32 = tpt.forward(params, torch.from_numpy(toks), num_heads=HEADS).numpy()
    assert np.abs(got - f32).max() > 0  # the int8 path really ran


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_weight_engines_match_jax_engines(jparams, params, layout):
    rng = np.random.default_rng(9)
    prompts = {f"r{i}": rng.integers(1, CFG["vocab_size"], rng.integers(3, 14)).tolist()
               for i in range(5)}
    kw = dict(num_heads=HEADS, batch_slots=2, max_seq=32)
    if layout == "paged":
        kw.update(page_size=4, prefill_chunk=8)
    jq = jcal.quantize_params(jparams)
    jeng = (JaxEngine if layout == "dense" else JaxPagedEngine)(jq, **kw)
    jres, jrep = JaxScheduler(jeng, max_new_tokens=6).run(
        [JaxRequest(uid=u, prompt=p) for u, p in prompts.items()])
    eng = (InferenceEngine if layout == "dense" else PagedInferenceEngine)(
        tcal.quantize_params(params), device="cpu", **kw)
    res, rep = ContinuousBatchingScheduler(eng, max_new_tokens=6).run(
        [Request(uid=u, prompt=p) for u, p in prompts.items()])
    assert {r.uid: r.tokens for r in res} == {r.uid: r.tokens for r in jres}
    assert rep.weights_dtype == jrep.weights_dtype == "int8"
    assert rep.decode_steps == jrep.decode_steps

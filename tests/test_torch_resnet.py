"""The port's ResNet against the JAX package's, on the CPU.

Weights are the JAX model's ``init`` with random BatchNorm parameters and
statistics and a scaled-up head (``_torch_image.randomized``), carried
over with ``variables_from_numpy``; images are numpy normals from a seed.

Tolerances, of the largest |logit| (or, for a statistic, of the leaf's
largest value):
- eval-mode f32 logits: 1e-5 (observed ~1e-6: f32 sums in another order);
- train-mode f32 logits: 1e-3, and the port no further from a float64 run
  of the port than twice the JAX model is.  Train-mode BatchNorm divides
  by the batch's own deviation, and with 8 values a channel (ResNet-50's
  last stage at 32 px) f32 rounding is amplified: the JAX model itself is
  4e-4 off the float64 result there (flax's E[x^2] - E[x]^2 variance
  cancels), the port 2e-4;
- new batch statistics: 1e-3 of each leaf (observed <= 9e-5, the same
  amplification);
- bf16 logits: the port's error against the JAX f32 logits at most twice
  the JAX bf16 model's plus one bf16 ulp of the largest logit (both round
  convs, BatchNorm outputs and the head to bf16 at the same places, in
  other summation orders, and train-mode BatchNorm amplifies the
  difference).
"""

from __future__ import annotations

import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from _torch_image import as_f64, np_tree, randomized, rel_err, tree_errors
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.models import resnet as jresnet
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.models import _convnet
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.train.state import tree_leaves

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.rsqrt):  # see test_torch_bert.py
    _fn(torch.ones(1 << 16))

CLASSES, BATCH = 10, 8
SIZES = (32, 33)
EVAL_RTOL, TRAIN_RTOL, STATS_RTOL = 1e-5, 1e-3, 1e-3


@pytest.fixture(scope="module")
def variables():
    """Randomised f32 variables of resnet18 and resnet50 (10 classes)."""
    out = {}
    for depth in (18, 50):
        model = jget_model(f"resnet{depth}", num_classes=CLASSES, dtype=jnp.float32)
        init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False))
        out[depth] = randomized(init(jax.random.key(depth)), seed=depth)
    return out


def _images(size, seed=0, batch=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _jax_apply(depth, dtype, nv, x, train):
    model = jget_model(f"resnet{depth}", num_classes=CLASSES, dtype=dtype)
    if train:
        fn = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))
        logits, new = fn(nv, jnp.asarray(x))
        return np.asarray(logits), np_tree(new["batch_stats"])
    return np.asarray(model.apply(nv, jnp.asarray(x), train=False)), None


def _port_apply(depth, dtype, tv, x, train):
    model = tmodels.get_model(f"resnet{depth}", num_classes=CLASSES, dtype=dtype)
    out = model(tv["params"], torch.from_numpy(x).to(torch.float64
                                                       if dtype == torch.float64
                                                       else torch.float32),
                train=train, batch_stats=tv["batch_stats"])
    return out if train else (out, None)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", [18, 50])
def test_f32_logits_and_batch_stats_match_jax(variables, depth, size):
    nv = variables[depth]
    x = _images(size)
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    want_eval, _ = _jax_apply(depth, jnp.float32, nv, x, train=False)
    got_eval, _ = _port_apply(depth, torch.float32, tv, x, train=False)
    assert rel_err(got_eval, want_eval) < EVAL_RTOL

    want, want_stats = _jax_apply(depth, jnp.float32, nv, x, train=True)
    got, got_stats = _port_apply(depth, torch.float32, tv, x, train=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, CLASSES)
    assert rel_err(got, want) < TRAIN_RTOL
    truth, _ = _port_apply(depth, torch.float64, as_f64(tv), x, train=True)
    assert rel_err(got, truth) <= 2 * rel_err(want, truth.detach().numpy()) + 1e-6
    errors = tree_errors({"batch_stats": got_stats}, {"batch_stats": want_stats})
    assert len(errors) == len(jax.tree.leaves(want_stats))
    worst = max(errors, key=errors.get)
    assert errors[worst] < STATS_RTOL, (worst, errors[worst])


def test_bf16_logits_stay_as_close_to_f32_as_jax_bf16(variables):
    nv = variables[18]
    x = _images(32, seed=1)
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    for train in (False, True):
        ref, _ = _jax_apply(18, jnp.float32, nv, x, train)
        jbf, _ = _jax_apply(18, jnp.bfloat16, nv, x, train)
        got, _ = _port_apply(18, torch.bfloat16, tv, x, train)
        assert got.dtype == torch.float32  # the head's output comes back f32
        ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
        limit = 2 * rel_err(jbf, ref) + ulp / np.abs(ref).max()
        assert rel_err(got, ref) <= limit, (train, rel_err(got, ref), limit)


def test_new_batch_stats_take_the_biased_variance():
    """flax's running update at batch 2: 0.9 ra + 0.1 var with the biased
    batch variance; torch's own running_var would take the unbiased one,
    twice as large here (n / (n - 1) = 2)."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (2, 1, 1, 5)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    y, new = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    run = _convnet._Pass(train=True, dtype=torch.float32)
    params = {"scale": torch.ones(5), "bias": torch.zeros(5)}
    stats = {"mean": torch.zeros(5), "var": torch.ones(5)}
    s = _convnet.Scope(run, params, stats, {})
    got = _convnet.batch_norm(s, torch.from_numpy(x).permute(0, 3, 1, 2),
                              momentum=0.9, eps=1e-5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               atol=1e-5)
    want_var = np.asarray(new["batch_stats"]["var"])
    np.testing.assert_allclose(s.new_stats["var"].numpy(), want_var, rtol=1e-6)
    np.testing.assert_allclose(s.new_stats["mean"].numpy(),
                               np.asarray(new["batch_stats"]["mean"]), atol=1e-7)
    torch_bn = torch.nn.BatchNorm2d(5, momentum=0.1)
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    unbiased_step = torch_bn.running_var.detach().numpy() - 0.9
    assert np.allclose(unbiased_step, 2 * (want_var - 0.9), rtol=1e-5)


@pytest.mark.parametrize("depth", sorted(tresnet.RESNET_CONFIGS))
def test_param_shapes_equal_jax_at_every_depth(depth):
    """Every leaf's shape (conv kernels OIHW against flax's HWIO) and the
    parameter count, from shapes alone on both sides."""
    jmodel = jget_model(f"resnet{depth}")
    want = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                              jnp.zeros((1, 64, 64, 3)), train=False))
    got = tmodels.get_model(f"resnet{depth}").param_shapes((1, 64, 64, 3))
    for col in ("params", "batch_stats"):
        want_leaves = jax.tree_util.tree_flatten_with_path(want[col])[0]
        assert len(want_leaves) == len(tree_leaves(got[col]))
        for path, leaf in want_leaves:
            node = got[col]
            for key in path:
                node = node[key.key]
            shape = tuple(leaf.shape)
            if len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            assert tuple(node) == shape, path
    n_jax = sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(want["params"]))
    assert sum(s.numel() for s in tree_leaves(got["params"])) == n_jax


def test_variables_round_trip_bitwise(variables):
    nv = variables[18]
    back = _convnet.variables_to_numpy(_convnet.variables_from_numpy(nv, device="cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(nv)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    kernel = tv["params"]["stem_conv"]["Conv_0"]["kernel"]
    assert tuple(kernel.shape) == (64, 3, 7, 7)
    assert kernel.is_contiguous(memory_format=torch.channels_last)


def test_activations_stay_channels_last(variables, monkeypatch):
    """Every conv, in train and eval mode, sees a channels-last input."""
    seen = []
    conv2d = F.conv2d

    def checked(x, w, *args, **kwargs):
        seen.append(x.is_contiguous(memory_format=torch.channels_last)
                    and w.is_contiguous(memory_format=torch.channels_last))
        return conv2d(x, w, *args, **kwargs)

    monkeypatch.setattr(F, "conv2d", checked)
    tv = _convnet.variables_from_numpy(variables[50], device="cpu")
    for train in (True, False):
        _port_apply(50, torch.float32, tv, _images(32, batch=2), train)
    assert len(seen) == 2 * 53 and all(seen)


def _hand_macs(depth, size, classes):
    """Multiply-adds of a ResNet forward counted from RESNET_CONFIGS."""
    kind, stages = tresnet.RESNET_CONFIGS[depth]
    hw = (size + 1) // 2  # stem 7x7/2
    macs = hw * hw * 7 * 7 * 3 * 64
    hw = (hw + 1) // 2  # max-pool 3x3/2
    cin = 64
    for i, n in enumerate(stages):
        f = 64 * 2 ** i
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            out_hw = (hw + stride - 1) // stride
            cout = f if kind == "basic" else 4 * f
            if j == 0:
                macs += out_hw ** 2 * cin * cout  # projection
            if kind == "basic":
                macs += out_hw ** 2 * 9 * cin * f + out_hw ** 2 * 9 * f * f
            else:
                macs += (hw ** 2 * cin * f + out_hw ** 2 * 9 * f * f
                         + out_hw ** 2 * f * 4 * f)
            hw, cin = out_hw, cout
    return macs + cin * classes


def test_forward_macs_match_the_hand_count_and_flop_counter():
    r50 = tmodels.get_model("resnet50", num_classes=1001)
    assert r50.forward_macs(224) == _hand_macs(50, 224, 1001) == 4_089_186_304
    for depth, size in ((18, 32), (50, 33), (34, 40)):
        model = tmodels.get_model(f"resnet{depth}", num_classes=CLASSES,
                                  dtype=torch.float32)
        tv = model.init(torch.Generator().manual_seed(0), (1, size, size, 3),
                        device="cpu")
        x = torch.from_numpy(_images(size, batch=2))
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(tv["params"], x, train=False, batch_stats=tv["batch_stats"])
        assert counter.get_total_flops() == 2 * 2 * model.forward_macs(size)
        assert model.forward_macs(size) == _hand_macs(depth, size, CLASSES)


def test_registry_and_reference_constants():
    assert {f"resnet{d}" for d in jresnet.RESNET_CONFIGS} <= set(
        tmodels.available_models())
    assert tresnet.RESNET_CONFIGS == jresnet.RESNET_CONFIGS
    assert (tresnet.BN_MOMENTUM, tresnet.BN_EPSILON) == (jresnet.BN_MOMENTUM,
                                                         jresnet.BN_EPSILON)
    for k in (1, 3, 7):
        assert tresnet.fixed_padding(k) == jresnet.fixed_padding(k)
    model = tmodels.get_model("resnet50", dtype=torch.float32)
    assert (model.depth, model.num_classes, model.width_multiplier) == (50, 1001, 1)
    with pytest.raises(ValueError):
        tresnet.ResNet(depth=42)


def test_init_draws_flax_initialisers_and_zero_final_scales():
    model = tmodels.get_model("resnet50", num_classes=CLASSES)
    v = model.init(torch.Generator().manual_seed(0), (1, 32, 32, 3), device="cpu")
    block = v["params"]["stage2_block1"]
    assert torch.equal(block["BatchNormRelu_2"]["BatchNorm_0"]["scale"],
                       torch.zeros(512))
    assert torch.equal(block["BatchNormRelu_0"]["BatchNorm_0"]["scale"],
                       torch.ones(128))
    assert torch.equal(v["batch_stats"]["stem_bn"]["BatchNorm_0"]["var"],
                       torch.ones(64))
    w = v["params"]["stage3_block2"]["ConvFixedPadding_1"]["Conv_0"]["kernel"]
    std = math.sqrt(1 / (256 * 9))  # fan-in truncated normal, as flax's
    assert abs(w.std().item() - std) < 0.05 * std and w.abs().max() <= 2 * std / 0.8796
    head = v["params"]["head"]["kernel"]
    assert abs(head.std().item() - 0.01) < 1e-3
    assert all(t.dtype == torch.float32 for t in tree_leaves(v))

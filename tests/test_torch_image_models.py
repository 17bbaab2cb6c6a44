"""The port's InceptionV3, VGG and AlexNet against the JAX package's, on the
CPU.

Weights are the JAX models' ``init`` with random BatchNorm parameters and
statistics, random biases and scaled-up heads (``_torch_image.randomized``),
carried over with ``variables_from_numpy``; images are numpy normals from
a seed.  Dropout draws from ``jax.random`` in the reference, which torch
cannot reproduce, so it is compared only where it is off and otherwise
held to determinism within the port.

Tolerances, of the largest |logit| (or, for a statistic, of the leaf's
largest value), all f32:
- eval-mode logits: 1e-5 (observed ~1e-6: f32 sums in another order);
- train-mode logits (both heads): 5e-3, and the port's logits no further
  from a float64 run of the port than twice the JAX model's.  At 75 px
  Inception's last blocks and the aux head see 1 x 1 grids, so train-mode
  BatchNorm normalises 8 values a channel (batch 8) and amplifies f32
  rounding: the JAX model is 1.5e-3 off the float64 result there (3e-3 at
  batch 4), the port 2.6e-4; the two differ by 1.6e-3
  (``test_torch_resnet.py`` says why);
- new batch statistics: 1e-3 of each leaf (observed 3e-7).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.utils.flop_counter import FlopCounterMode

from _torch_image import as_f64, randomized, rel_err, tree_errors
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.models import inception as jinception
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.models import _convnet
from distributeddeeplearning_tpu_torch.models import inception as tinception
from distributeddeeplearning_tpu_torch.models import vgg as tvgg
from distributeddeeplearning_tpu_torch.train.state import tree_leaves

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.rsqrt):  # see test_torch_bert.py
    _fn(torch.ones(1 << 16))

CLASSES = 10
EVAL_RTOL, TRAIN_RTOL, STATS_RTOL = 1e-5, 5e-3, 1e-3


def _images(size, batch, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _init(name, size, seed=0, **kw):
    model = jget_model(name, num_classes=CLASSES, dtype=jnp.float32, **kw)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, size, size, 3)), train=False))
    return randomized(init(jax.random.key(seed)), seed=seed)


@pytest.fixture(scope="module")
def inception_vars():
    return _init("inceptionv3", 75, aux_logits=True)


def _port(name, dtype=torch.float32, **kw):
    return tmodels.get_model(name, num_classes=CLASSES, dtype=dtype, **kw)


@pytest.mark.parametrize("aux", [False, True], ids=["headless", "aux"])
def test_inceptionv3_matches_jax_at_75px(inception_vars, aux):
    nv = inception_vars
    if not aux:
        nv = {c: {k: v for k, v in t.items() if k != "InceptionAux_0"}
              for c, t in nv.items()}
    x = _images(75, batch=8)
    jmodel = jget_model("inceptionv3", num_classes=CLASSES, dtype=jnp.float32,
                        aux_logits=aux)
    tmodel = _port("inceptionv3", aux_logits=aux)
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    xt = torch.from_numpy(x)

    want = np.asarray(jmodel.apply(nv, jnp.asarray(x), train=False))
    got = tmodel(tv["params"], xt, train=False, batch_stats=tv["batch_stats"])
    assert rel_err(got, want) < EVAL_RTOL

    want, new = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(nv, jnp.asarray(x))
    got, got_stats = tmodel(tv["params"], xt, train=True,
                            batch_stats=tv["batch_stats"])
    v64 = as_f64(tv)
    truth, _ = _port("inceptionv3", torch.float64, aux_logits=aux)(
        v64["params"], xt.double(), train=True, batch_stats=v64["batch_stats"])
    pairs = list(zip(got, want, truth)) if aux else [(got, want, truth)]
    assert len(pairs) == (2 if aux else 1)
    for g, w, t in pairs:
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == (8, CLASSES)
        assert rel_err(g, w) < TRAIN_RTOL
        assert rel_err(g, t) <= 2 * rel_err(w, t.detach().numpy()) + 1e-6
    errors = tree_errors({"batch_stats": got_stats},
                         {"batch_stats": new["batch_stats"]})
    assert len(errors) == len(jax.tree.leaves(new["batch_stats"]))
    worst = max(errors, key=errors.get)
    assert errors[worst] < STATS_RTOL, (worst, errors[worst])


@pytest.mark.parametrize("grid", [2, 4, 5])
def test_aux_head_pads_as_tensorflow(grid):
    """The aux head alone: grid 5 takes the VALID branch; grids 2 and 4
    the SAME branch of its 5x5/3 average pool, whose total pad is 3 (odd:
    1 before, 2 after) at grid 2 and 4 at grid 4."""
    branch = tinception._grid_padding(torch.empty(1, 768, grid, grid))
    assert branch == ("VALID" if grid == 5 else "SAME")
    if branch == "SAME":
        assert _convnet.same_pads(grid, 5, 3) == {2: (1, 2), 4: (2, 2)}[grid]
    aux = jinception.InceptionAux(CLASSES, dtype=jnp.float32)
    x = np.random.default_rng(grid).standard_normal((3, grid, grid, 768)).astype(
        np.float32)
    nv = randomized(aux.init(jax.random.key(0), jnp.asarray(x), train=False))
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for train in (False, True):
        new = {} if train else None
        s = _convnet.Scope(_convnet._Pass(train=train, dtype=torch.float32),
                           tv["params"], tv["batch_stats"], new)
        got = tinception.inception_aux(s, xt, CLASSES)
        want = aux.apply(nv, jnp.asarray(x), train=train,
                         mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        assert rel_err(got, np.asarray(want)) < (TRAIN_RTOL if train else EVAL_RTOL)


def test_same_pads_match_xla_padding_rule():
    for size in range(1, 40):
        for kernel, stride in ((11, 4), (5, 3), (3, 2), (3, 1), (7, 2)):
            want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
            assert _convnet.same_pads(size, kernel, stride) == tuple(want)


def test_inception_aux_loss_matches_jax():
    rng = np.random.default_rng(4)
    main, aux = (rng.normal(size=(6, CLASSES)).astype(np.float32) * 3
                 for _ in range(2))
    labels = rng.integers(0, CLASSES, 6).astype(np.int32)
    for smoothing in (0.0, 0.1):
        want = jinception.inception_aux_loss(
            (jnp.asarray(main), jnp.asarray(aux)), jnp.asarray(labels),
            label_smoothing=smoothing)
        got = tinception.inception_aux_loss(
            (torch.from_numpy(main), torch.from_numpy(aux)), torch.from_numpy(labels),
            label_smoothing=smoothing)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


CNNS = {"vgg11": 32, "alexnet": 64}  # the size each is initialised at
ODD_SIZES = [("vgg11", 35), ("alexnet", 66), ("alexnet", 67)]


@pytest.fixture(scope="module")
def cnn_vars():
    return {name: _init(name, size) for name, size in CNNS.items()}


@pytest.mark.parametrize("name,size", ODD_SIZES)
def test_vgg_and_alexnet_match_jax_at_odd_sizes(cnn_vars, name, size):
    """Eval mode (dropout off).  AlexNet's 11x11/4 SAME conv pads 9 in all
    at 66 px (4 before, 5 after) and 8 at 67; vgg11's 2x2 pools floor 35."""
    nv = cnn_vars[name]
    x = _images(size, batch=3, seed=size)
    want = jget_model(name, num_classes=CLASSES, dtype=jnp.float32).apply(
        nv, jnp.asarray(x), train=False)
    tv = _convnet.variables_from_numpy(nv, device="cpu")
    assert set(tv) == {"params"}  # no BatchNorm, no batch_stats collection
    got = _port(name)(tv["params"], torch.from_numpy(x), train=False)
    assert rel_err(got, np.asarray(want)) < EVAL_RTOL


def test_dropout_is_deterministic_per_generator(cnn_vars):
    tv = _convnet.variables_from_numpy(cnn_vars["vgg11"], device="cpu")
    x = torch.from_numpy(_images(32, batch=4))
    model = _port("vgg11")

    def run(seed, train=True):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return model(tv["params"], x, train=train, generator=g)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, run(None, train=False))
    assert torch.equal(_port("vgg11", dropout_rate=0.0)(tv["params"], x, train=True),
                       run(None, train=False))
    with pytest.raises(ValueError, match="generator"):
        run(None)


SHAPES = [("inceptionv3", 299, {"aux_logits": True}), ("inceptionv3", 299, {}),
          ("vgg11", 224, {}), ("vgg16", 224, {}), ("vgg19", 224, {}),
          ("alexnet", 224, {})]


@pytest.mark.parametrize("name,size,kw", SHAPES,
                         ids=[f"{n}{'-aux' if kw else ''}" for n, _, kw in SHAPES])
def test_param_shapes_equal_jax(name, size, kw):
    jmodel = jget_model(name, **kw)
    want = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))
    got = tmodels.get_model(name, **kw).param_shapes((1, size, size, 3))
    assert set(got) == {"params", "batch_stats"}
    for col in got:
        want_leaves = jax.tree_util.tree_flatten_with_path(want.get(col, {}))[0]
        assert len(want_leaves) == len(tree_leaves(got[col])), col
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


@pytest.mark.parametrize("name,size", [("inceptionv3", 75), ("vgg11", 35),
                                       ("alexnet", 66)])
def test_forward_macs_match_the_flop_counter(name, size):
    model = _port(name)
    tv = model.init(torch.Generator().manual_seed(0), (1, size, size, 3),
                    device="cpu")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(tv["params"], torch.from_numpy(_images(size, batch=2)), train=False,
              batch_stats=tv["batch_stats"])
    assert counter.get_total_flops() == 2 * 2 * model.forward_macs(size)


def test_registry_names_the_reference_models():
    names = set(tmodels.available_models())
    assert {"inceptionv3", "inception_v3", "vgg11", "vgg16", "vgg19",
            "alexnet"} <= names
    assert tvgg.VGG_CONFIGS == __import__(
        "distributeddeeplearning_tpu.models.vgg", fromlist=["x"]).VGG_CONFIGS
    assert isinstance(tmodels.get_model("inception_v3"), tinception.InceptionV3)
    with pytest.raises(ValueError):
        tvgg.VGG(depth=13)

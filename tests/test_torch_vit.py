"""The port's Vision Transformer against the JAX package, on the CPU.

The same weights (the JAX model's initialised variables with every bias,
LayerNorm scale and the CLS token drawn at random, so no term starts at
zero) and the same numpy images go through the reference's
``VisionTransformer`` and the port's ``models.vit``, at a small size:
32 px images, patch 8 (16 patches, S = 17), hidden 64, 2 blocks, 4 heads.

Tolerances:
- f32 logits within 1e-5 of the largest |logit| (observed ~1e-7: sums in
  another order through two blocks);
- the flash ``attention_fn`` (its plain version on the CPU) within 1e-5
  of the default attention's logits;
- three SGD-momentum steps in float64 (``jax.enable_x64``) within 1e-6:
  losses relative, params and momentum of each leaf's largest |value| or,
  where larger, of 1e-2 of the tree's (observed ~5e-7: both sides take
  the attention softmax in f32, as the reference's default attention
  does).  The key projection's bias takes no gradient in exact
  arithmetic (the softmax does not see a constant added to every key's
  score), so its gradient is rounding noise of that f32 softmax on both
  sides, the floor keeps it from being read as an error;
- remat ``full`` and ``dots`` against ``none``: bitwise (the same ops,
  recomputed in the same order on the CPU).
"""

from __future__ import annotations

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import get_model as jget_model
from distributeddeeplearning_tpu.models import vit as jvit
from distributeddeeplearning_tpu.parallel import create_mesh, shard_batch
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.models import _convnet
from distributeddeeplearning_tpu_torch.models import vit as tvit
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import benchmark as twork

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))  # first MKL calls in a worker (ROADMAP C, traps)

SIZE, BATCH, CLASSES, STEPS = 32, 4, 10, 3
SMALL = dict(image_size=SIZE, patch_size=8, hidden_size=64, num_layers=2,
             num_heads=4, intermediate_size=128, num_classes=CLASSES)
NAMES = ("vit-b16", "vit-l16")
LOGIT_RTOL = 1e-5
F64_TOL = 1e-6
SCHED = (0.1, 1, 2)  # base lr, replicas, steps an epoch


def _images(n=BATCH, seed=0):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _randomized(variables, seed):
    """Every bias N(0, 0.1), LayerNorm scale U(0.5, 1.5) and the CLS token
    N(0, 0.1); kernels and position embeddings as initialised."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = walk(x)
                continue
            x = np.asarray(x)
            if k == "scale":
                x = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k in ("bias", "cls"):
                x = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
            out[k] = x
        return out

    return walk(jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def jvariables():
    """{name: numpy variables} of the reference at the small size."""
    out = {}
    for i, name in enumerate(NAMES):
        net = jget_model(name, dtype=jnp.float32, **SMALL)
        v = net.init(jax.random.key(i), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
        out[name] = _randomized(nn.meta.unbox(v), seed=i)
    return out


def _port(name, **kw):
    return tmodels.get_model(name, **{**SMALL, "dtype": torch.float32, **kw})


def _port_vars(jv):
    return _convnet.variables_from_numpy(jv, device="cpu")


def _rel(got, want, floor=1e-30):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def _tree_errors(got, want):
    """Each leaf's error against its largest |value| or, where larger, 1e-2
    of the tree's largest."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    return [_rel(g, w, 1e-2 * top) for g, w in zip(got, want)]


@pytest.mark.parametrize("name", NAMES)
def test_f32_logits_match_jax_vision_transformer(jvariables, name):
    images = _images(seed=1)
    want = jget_model(name, dtype=jnp.float32, **SMALL).apply(
        jvariables[name], jnp.asarray(images), train=False)
    assert want.dtype == jnp.float32
    got = _port(name)(_port_vars(jvariables[name])["params"],
                      torch.from_numpy(images), train=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, CLASSES)
    assert _rel(got, want) <= LOGIT_RTOL


def test_bf16_logits_stay_near_jax_bf16(jvariables):
    """bf16 compute: the head's logits come back f32 and stay within a few
    bf16 ulps of the reference's bf16 run (both round at the same places,
    in other orders)."""
    name = "vit-b16"
    images = _images(seed=2)
    want = jget_model(name, dtype=jnp.bfloat16, **SMALL).apply(
        jvariables[name], jnp.asarray(images), train=False)
    got = _port(name, dtype=torch.bfloat16)(_port_vars(jvariables[name])["params"],
                                            torch.from_numpy(images), train=False)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 5e-2


@pytest.mark.parametrize("name", NAMES)
def test_param_shapes_equal_jax_eval_shape(name):
    """Leaf by leaf against ``jax.eval_shape`` of the reference's init (the
    patch embedding's HWIO kernel is OIHW in the port)."""
    net = jget_model(name, dtype=jnp.float32, **SMALL)
    want = jax.eval_shape(lambda: nn.meta.unbox(net.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)))
    got = _port(name).param_shapes((1, SIZE, SIZE, 3))
    assert got["batch_stats"] == {} and "batch_stats" not in want

    def walk(g, w, path):
        assert sorted(g) == sorted(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}/{k}")
                continue
            shape = tuple(w[k].shape)
            if path.endswith("patch_embed") and k == "kernel":
                shape = (shape[3], shape[2], shape[0], shape[1])
            assert tuple(g[k]) == shape, (path, k)

    walk(got["params"], want["params"], "")


def test_registry_has_the_four_names_and_the_reference_configs():
    names = tmodels.available_models()
    assert {"vit-b16", "vit_b16", "vit-l16", "vit_l16"} <= set(names)
    for name, base in (("vit-b16", tvit.VIT_B16), ("vit_b16", tvit.VIT_B16),
                       ("vit-l16", tvit.VIT_L16), ("vit_l16", tvit.VIT_L16)):
        model = tmodels.get_model(name)
        assert isinstance(model, tvit.VisionTransformer)
        assert model.config == base and model.dtype == torch.bfloat16
    for f in dataclasses.fields(jvit.ViTConfig):
        assert getattr(tvit.VIT_B16, f.name) == getattr(jvit.VIT_B16, f.name)
        assert getattr(tvit.VIT_L16, f.name) == getattr(jvit.VIT_L16, f.name)
    small = tmodels.get_model("vit_b16", num_layers=2, num_classes=5,
                              dtype=torch.float32)
    assert small.config == dataclasses.replace(tvit.VIT_B16, num_layers=2,
                                               num_classes=5)
    with pytest.raises(ValueError, match="remat"):
        tmodels.get_model("vit-b16", remat="some")


def test_a_size_the_patch_does_not_divide_raises(jvariables):
    model = _port("vit-b16")
    with pytest.raises(ValueError, match="not divisible by patch size"):
        model.init(input_shape=(1, 36, 32, 3), device="cpu")
    params = _port_vars(jvariables["vit-b16"])["params"]
    with pytest.raises(ValueError, match="not divisible by patch size"):
        model(params, torch.zeros(1, 32, 30, 3), train=False)


def _loss_and_grads(params, remat, attention_fn=None, dropout=0.0, seed=0):
    kw = {"remat": remat, "dropout_rate": dropout}
    if attention_fn is not None:
        kw["attention_fn"] = attention_fn
    model = _port("vit-b16", **kw)
    leaves = [t.requires_grad_(True) for t in tstate.tree_leaves(params)]
    gen = torch.Generator().manual_seed(seed)
    logits = model(params, torch.from_numpy(_images(seed=3)), train=True,
                   generator=gen)
    loss = tstep.cross_entropy_loss(logits, torch.arange(BATCH) % CLASSES)
    return loss.detach(), [g.detach() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_loss_and_gradients_bitwise(jvariables, remat, dropout):
    """``full`` and ``dots`` against ``none``: equal bits on the CPU, with
    dropout too (the recomputed blocks draw the forward's masks again)."""
    params = _port_vars(jvariables["vit-b16"])["params"]
    loss0, g0 = _loss_and_grads(params, "none", dropout=dropout)
    loss1, g1 = _loss_and_grads(params, remat, dropout=dropout)
    assert torch.equal(loss0, loss1)
    assert len(g0) == len(g1) == 4 + 2 * 16 + 4
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_dots_saves_the_matrix_products_and_recomputes_the_rest(jvariables):
    """Under ``dots`` the backward replays the block's elementwise work but
    none of its matrix products; under ``full`` it replays both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    params = _port_vars(jvariables["vit-b16"])["params"]
    mm = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
          torch.ops.aten.addmm.default}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = self.gelu = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in mm
            self.gelu += func == torch.ops.aten.gelu.default
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        model = _port("vit-b16", remat=remat)
        leaves = [t.requires_grad_(True) for t in tstate.tree_leaves(params)]
        logits = model(params, torch.from_numpy(_images(seed=3)), train=True)
        with Count() as c:
            torch.autograd.grad(logits.sum(), leaves)
        counts[remat] = (c.mm, c.gelu)
    none, full, dots = counts["none"], counts["full"], counts["dots"]
    assert full[1] == dots[1] == none[1] + 2  # each block's GELU recomputed
    assert full[0] > none[0] and dots[0] == none[0]


def test_flash_attention_fn_matches_the_default(jvariables):
    params = _port_vars(jvariables["vit-b16"])["params"]
    images = torch.from_numpy(_images(seed=4))
    want = _port("vit-b16")(params, images, train=False)
    got = _port("vit-b16", attention_fn=tfa.make_flash_attention())(
        params, images, train=False)
    assert _rel(got, want.numpy()) <= LOGIT_RTOL
    # and the gradients through it (K2/K3's plain version on the CPU)
    loss_d, g_d = _loss_and_grads(params, "none")
    loss_f, g_f = _loss_and_grads(params, "none", tfa.make_flash_attention())
    assert abs(float(loss_f) - float(loss_d)) <= 1e-5 * abs(float(loss_d))
    assert max(_tree_errors(g_f, [b.double().numpy() for b in g_d])) <= 1e-4


def test_forward_macs_count_the_attention_products():
    """The FLOP reckoning: the hand count at ViT-B/16's 224 px, and
    ``torch.utils.flop_counter`` on a real forward at the small size."""
    from torch.utils.flop_counter import FlopCounterMode

    s, d, m = 197, 768, 3072
    block = s * (4 * d * d + 2 * d * m) + 2 * s * s * d
    assert tmodels.get_model("vit-b16").forward_macs(224) == (
        12 * block + 196 * 768 * 768 + 768 * 1001) == 17_563_828_992
    model = _port("vit-b16")
    variables = model.init(input_shape=(1, SIZE, SIZE, 3), device="cpu")
    with FlopCounterMode(display=False) as fc:
        model(variables["params"], torch.zeros(1, SIZE, SIZE, 3), train=False)
    assert fc.get_total_flops() == 2 * model.forward_macs(SIZE)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax_in_float64(jvariables, name):
    """Three SGD-momentum steps (Goyal schedule) of the port's
    ``build_train_step`` against the reference's, float64 on both sides:
    per-step loss and lr, then every param and momentum leaf."""
    nv = _f64(jvariables[name])
    batches = list(jsynth.synthetic_batches(BATCH, STEPS, (SIZE, SIZE, 3), CLASSES,
                                            seed=5))
    tsch = tsched.goyal_lr_schedule(*SCHED)
    tv = _port_vars(nv)
    tst = tstate.TrainState.create(params=tv["params"], tx=tstate.sgd_momentum(tsch),
                                   apply_fn=_port(name, dtype=torch.float64))
    tfn = tstep.build_train_step(tst, compute_dtype=torch.float64, schedule=tsch)
    with jax.enable_x64(True):
        jsch = jsched.goyal_lr_schedule(*SCHED)
        jtx = jstate.sgd_momentum(jsch)
        params = jax.tree.map(jnp.asarray, nv["params"])
        jst = jstate.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_state=jtx.init(params),
            batch_stats={}, tx=jtx,
            apply_fn=jget_model(name, dtype=jnp.float64, **SMALL).apply)
        mesh = create_mesh(devices=jax.devices()[:1])
        jfn = jstep.build_train_step(mesh, jst, compute_dtype=jnp.float64,
                                     schedule=jsch)
        for i, batch in enumerate(batches):
            jst, jm = jfn(jst, shard_batch(mesh, batch))
            tst, tm = tfn(tst, batch)
            assert tst.step == int(jst.step) == i + 1
            np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-12)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=F64_TOL)
        jparams = jax.tree.map(np.asarray, jst.params)
        jtrace = jax.tree.map(np.asarray, jst.opt_state[1][0].trace)
    got = _convnet.variables_to_numpy({"params": tst.params,
                                       "trace": tst.opt_state["trace"]})
    for name, want in (("params", jparams), ("trace", jtrace)):
        errors = _tree_errors(jax.tree.leaves(got[name]), jax.tree.leaves(want))
        assert len(errors) == 40 and max(errors) <= F64_TOL, (name, max(errors))


def test_benchmark_workload_runs_vit_on_the_cpu(tmp_path):
    """``workloads.benchmark.main(model="vit-b16")`` at a tiny size, through
    the flags: img/s finite and positive."""
    result = twork.main(model="vit_b16", batch_size=2, image_size=32, num_classes=3,
                        num_iters=1, num_batches_per_iter=1, num_warmup_batches=1,
                        compute_dtype="float32", device="cpu",
                        metrics_path=str(tmp_path / "m.jsonl"))
    assert result.model == "vit_b16"
    assert np.isfinite(result.img_sec_per_chip_mean)
    assert result.img_sec_per_chip_mean > 0

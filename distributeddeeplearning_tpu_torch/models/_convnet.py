"""Layers shared by the port's image models (ResNet, InceptionV3, VGG,
AlexNet), in the rounding and layout of the reference's flax modules.

An image model is written once, as a forward pass over a :class:`Scope`:
a node of its variables named as the flax tree names them (``stem_conv/
Conv_0/kernel``, ``stage1_block1/BatchNormRelu_0/BatchNorm_0/scale``,
``ConvBN_3``, ...), so ``train/state.tree_zip`` pairs a port tree with a
JAX one key by key and :func:`variables_from_numpy` carries weights over.
The same pass, run on ``meta`` tensors, creates the variables
(:meth:`ImageModel.init`, in forward order as flax does), gives their
shapes without computing anything (:meth:`ImageModel.param_shapes`) and
counts the forward's multiply-adds (:meth:`ImageModel.forward_macs`).

Layout: a batch comes in NHWC, as the reference's does, and is viewed once
as NCHW with channels-last strides (``permute``, no copy); every conv,
pool, BatchNorm and concatenation keeps channels-last, which cuDNN's
tensor-core convolutions want.  Conv kernels are OIHW with channels-last
strides (flax's are HWIO); Dense kernels keep flax's ``(in, out)``.
Params and BatchNorm statistics are f32; activations are in the compute
dtype.

Rounding follows flax at the compute dtype:
- a conv casts its input and kernel to the dtype; a bias is added in the
  dtype after the conv's output is rounded;
- BatchNorm keeps statistics, scale and bias in f32 and rounds its output
  once to the dtype.  In training it normalises with the batch's biased
  variance and its running statistics become ``m * running + (1 - m) *
  batch`` with the biased batch variance (flax's rule; torch's own
  ``running_var`` update would take the unbiased one), taken from the
  normalising op's own f32 statistics apart from the gradient (the
  variance as invstd^-2 - eps, within ~1e-7 of the batch's);
- the global mean pool sums in f32 and rounds once; a Dense casts input,
  kernel and bias to the dtype and adds the bias in it;
- ``"SAME"`` padding is TensorFlow's: at a stride above 1 the odd pad goes
  at the end, so such pads are applied explicitly; pools pad with -inf
  (max) or count the zero pad (average).

Dropout draws from an explicit ``torch.Generator``: keep ~ Bernoulli(1 -
rate), ``where(keep, x / (1 - rate), 0)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device

Tree = Dict[str, Any]
Init = Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]
Padding = Union[str, Sequence[Tuple[int, int]]]

DEFAULT_INPUT_SHAPE = (1, 224, 224, 3)


# ---- initialisers (flax's, drawn from a torch.Generator) -----------------

def _fan_in(shape) -> int:
    # OIHW conv kernel: in x kh x kw; (in, out) dense kernel: in
    return int(np.prod(shape[1:])) if len(shape) == 4 else int(shape[0])


def lecun_normal(shape, generator) -> torch.Tensor:
    """``variance_scaling(1.0, "fan_in", "truncated_normal")``: flax's Conv
    and Dense default, and the ResNet's conv init."""
    std = math.sqrt(1.0 / _fan_in(shape)) / 0.87962566103423978
    t = torch.empty(shape)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)


def normal(stddev: float) -> Init:
    return lambda shape, generator: torch.randn(shape, generator=generator) * stddev


def zeros(shape, generator) -> torch.Tensor:
    return torch.zeros(shape)


def ones(shape, generator) -> torch.Tensor:
    return torch.ones(shape)


# ---- the variables a forward pass walks -----------------------------------

@dataclasses.dataclass
class _Pass:
    train: bool
    dtype: torch.dtype
    generator: Optional[torch.Generator] = None
    make: Optional[Callable] = None  # set while creating variables
    macs: int = 0


class Scope:
    """One node of a model's ``params`` and ``batch_stats`` trees as a
    forward pass walks them.  In training, each BatchNorm writes its new
    running statistics at its own path into ``new_stats``.  While creating
    variables, :meth:`param` and :meth:`stat` make each leaf with the
    pass's ``make`` and hand the forward a meta tensor of its shape."""

    def __init__(self, run: _Pass, params: Tree, stats: Tree,
                 new_stats: Optional[Tree]):
        self.run, self.params, self.stats = run, params, stats
        self.new_stats = new_stats
        self._counts: Dict[str, int] = {}

    @property
    def initializing(self) -> bool:
        return self.run.make is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.run.dtype

    def child(self, name: str) -> "Scope":
        if self.initializing:
            self.params.setdefault(name, {})
            self.stats.setdefault(name, {})
        new = None if self.new_stats is None else self.new_stats.setdefault(name, {})
        return Scope(self.run, self.params.get(name, {}), self.stats.get(name, {}),
                     new)

    def auto(self, prefix: str) -> "Scope":
        """The next child flax would name ``{prefix}_{i}`` (explicitly named
        children do not count)."""
        i = self._counts.get(prefix, 0)
        self._counts[prefix] = i + 1
        return self.child(f"{prefix}_{i}")

    def _leaf(self, tree: Tree, name: str, shape, init: Init) -> torch.Tensor:
        if self.initializing:
            tree[name] = self.run.make(tuple(shape), init)
            return torch.empty(shape, device="meta")
        return tree[name]

    def param(self, name: str, shape, init: Init) -> torch.Tensor:
        return self._leaf(self.params, name, shape, init)

    def stat(self, name: str, shape, init: Init) -> torch.Tensor:
        return self._leaf(self.stats, name, shape, init)


def _prune(tree: Tree) -> Tree:
    """``tree`` without its empty sub-dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


class ImageModel:
    """Base of the port's image models.  A subclass sets ``dtype`` and
    writes ``_forward(scope, x)`` on an NCHW (channels-last) tensor.

    ``model(params, images, train=..., batch_stats=..., generator=...)``
    takes NHWC ``images``.  With ``batch_stats`` in training it returns
    ``(outputs, new_batch_stats)`` (flax's ``apply(..., mutable=
    ["batch_stats"])``); otherwise the outputs alone, the running
    statistics read in eval mode."""

    dtype: torch.dtype

    def _forward(self, s: Scope, x: torch.Tensor):
        raise NotImplementedError

    def _abstract(self, input_shape, make) -> Tuple[Tree, int]:
        """Runs the forward on a meta batch of ``input_shape`` (NHWC; the
        batch size is taken as 1) in eval mode, creating each variable
        with ``make``; returns the variables and the multiply-adds of one
        example's forward."""
        run = _Pass(train=False, dtype=self.dtype, make=make)
        params: Tree = {}
        stats: Tree = {}
        x = torch.empty((1, *input_shape[1:]), device="meta")
        self._forward(Scope(run, params, stats, None),
                      x.permute(0, 3, 1, 2).to(self.dtype))
        return {"params": _prune(params), "batch_stats": _prune(stats)}, run.macs

    def init(self, generator: Optional[torch.Generator] = None,
             input_shape=DEFAULT_INPUT_SHAPE, *, device: DeviceLike = None) -> Tree:
        """``{"params", "batch_stats"}`` for NHWC inputs of ``input_shape``,
        drawn in forward order from ``generator`` (a CPU generator; default
        seed 0) with flax's initialisers; the draws differ from
        ``jax.random``'s, so carry JAX weights over with
        :func:`variables_from_numpy`.  ``batch_stats`` is ``{}`` for a
        model without BatchNorm."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def make(shape, init):
            return _placed(init(shape, generator), dev)

        return self._abstract(input_shape, make)[0]

    def param_shapes(self, input_shape=DEFAULT_INPUT_SHAPE) -> Tree:
        """``{"params", "batch_stats"}`` with each leaf's ``torch.Size``
        (the port's layout), computing nothing."""
        return self._abstract(input_shape, lambda shape, init: torch.Size(shape))[0]

    def forward_macs(self, image_size: int) -> int:
        """Multiply-adds of one example's forward at ``image_size`` x
        ``image_size`` RGB, from the shapes of its convs and Dense layers
        (a Dense once a row of its input) and whatever products a model
        adds itself (a ViT's attention); the pools, BatchNorms and
        elementwise work are not counted."""
        return self._abstract((1, image_size, image_size, 3),
                              lambda shape, init: None)[1]

    def __call__(self, params: Tree, images: torch.Tensor, train: bool = True,
                 batch_stats: Optional[Tree] = None,
                 generator: Optional[torch.Generator] = None):
        stats = {} if batch_stats is None else batch_stats
        new = {} if train and batch_stats is not None else None
        run = _Pass(train=train, dtype=self.dtype, generator=generator)
        x = images.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW, channels-last
        out = self._forward(Scope(run, params, stats, new), x)
        return (out, _prune(new)) if new is not None else out


def _placed(t: torch.Tensor, device) -> torch.Tensor:
    t = t.to(device)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


# ---- the weight carrier -------------------------------------------------------

def variables_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """flax variables (``{"params": ..., "batch_stats": ...}`` of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, variables)``) as the port's
    trees on ``device``: HWIO conv kernels become OIHW with channels-last
    strides, every other leaf keeps its shape.  The inverse is
    :func:`variables_to_numpy`; the round trip is bitwise."""
    dev = resolve_device(device)

    def convert(node, name=""):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, copy=True))
        if name == "kernel" and t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        return _placed(t, dev)

    return convert(tree)


def variables_to_numpy(tree: Tree) -> Tree:
    """The port's variables as flax's numpy tree (OIHW kernels back to
    HWIO), bit for bit, as copies (the port's optimizers update params in
    place)."""

    def convert(node, name=""):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        t = node.detach().cpu()
        if name == "kernel" and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        return np.array(t.numpy(), copy=True, order="C")  # never a view of ``node``

    return convert(tree)


# ---- layers ------------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's ``"SAME"`` (lo, hi) pad of one spatial dim: the output
    is ceil(size / stride) and the odd cell of the pad goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x, padding: Padding, kernel, stride) -> Tuple[Tuple[int, int], ...]:
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        return tuple(same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(2))
    return tuple(tuple(p) for p in padding)


def _padded(x, pads, value: float = 0.0):
    """(x, symmetric pad for the op): a symmetric pad is left to the op,
    an asymmetric one applied here."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv(s: Scope, x, features: int, kernel, *, stride=1,
         padding: Padding = "SAME", bias: bool = False,
         init: Init = lecun_normal) -> torch.Tensor:
    """flax ``nn.Conv`` at the scope's dtype (params ``kernel``, ``bias``)."""
    kernel, stride = _pair(kernel), _pair(stride)
    w = s.param("kernel", (features, x.shape[1], *kernel), init)
    b = s.param("bias", (features,), zeros) if bias else None
    x, pad = _padded(x, _pads(x, padding, kernel, stride))
    y = F.conv2d(x, w.to(s.dtype), None, stride, pad)
    s.run.macs += y[0].numel() * x.shape[1] * kernel[0] * kernel[1]
    if b is not None:
        y = y + b.to(s.dtype).view(1, -1, 1, 1)
    return y


#: the process group train-mode BatchNorm takes its moments over (None:
#: this process's batch alone); set by :func:`global_batch_moments`
_MOMENTS_GROUP: list = [None]


@contextlib.contextmanager
def global_batch_moments(group):
    """Within the block, train-mode BatchNorm normalises with the moments
    of the GLOBAL batch: every rank's ``[sum x, sum x^2, count]`` summed
    over ``group`` by an all-reduce autograd flows through (the
    reference's implicit data-parallel path, where GSPMD sees one global
    array).  ``group=None`` leaves the per-process moments."""
    prev = _MOMENTS_GROUP[0]
    _MOMENTS_GROUP[0] = group
    try:
        yield
    finally:
        _MOMENTS_GROUP[0] = prev


def _global_batch_norm(x, scale, bias, eps: float, group):
    """(y, batch mean, biased batch variance) with the moments summed over
    ``group``: flax's formula, ``var = max(E[x^2] - E[x]^2, 0)``, in f32 or
    wider, the output rounded once to x's dtype."""
    from torch.distributed.nn import functional as dist_fn

    c = x.shape[1]
    xf = x.to(_at_least_f32(x.dtype))
    count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
    local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count])
    total = dist_fn.all_reduce(local, group=group)
    n = total[2 * c]
    b_mean = total[:c] / n
    b_var = (total[c:2 * c] / n - b_mean * b_mean).clamp_min(0)
    mul = torch.rsqrt(b_var + eps) * scale
    y = (xf - b_mean.view(1, c, 1, 1)) * mul.view(1, c, 1, 1) + bias.view(1, c, 1, 1)
    return y.to(x.dtype), b_mean, b_var


def batch_norm(s: Scope, x, *, momentum: float, eps: float,
               scale_init: Init = ones) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over N, H, W (params ``scale``, ``bias``;
    statistics ``mean``, ``var``).  In training the moments are this
    process's batch's, or the global batch's inside
    :func:`global_batch_moments`."""
    c = x.shape[1]
    scale = s.param("scale", (c,), scale_init)
    bias = s.param("bias", (c,), zeros)
    mean = s.stat("mean", (c,), zeros)
    var = s.stat("var", (c,), ones)
    if not s.run.train:
        return F.batch_norm(x, mean, var, scale, bias, False, 0.0, eps)
    if _MOMENTS_GROUP[0] is not None:
        y, b_mean, b_var = _global_batch_norm(x, scale, bias, eps, _MOMENTS_GROUP[0])
        with torch.no_grad():
            s.new_stats["mean"] = momentum * mean + (1 - momentum) * b_mean.to(mean.dtype)
            s.new_stats["var"] = momentum * var + (1 - momentum) * b_var.to(var.dtype)
        return y
    # the op that normalises also gives the batch mean and 1/sqrt(var + eps)
    # (biased variance), in f32 or wider: no second pass over x for them
    y, b_mean, b_invstd = torch.native_batch_norm(x, scale, bias, None, None, True,
                                                  0.0, eps)
    with torch.no_grad():
        b_var = b_invstd.double().pow(-2).sub(eps).clamp_min(0).to(b_mean.dtype)
        s.new_stats["mean"] = momentum * mean + (1 - momentum) * b_mean
        s.new_stats["var"] = momentum * var + (1 - momentum) * b_var
    return y


def dense(s: Scope, x, features: int, *, init: Init = lecun_normal) -> torch.Tensor:
    """flax ``nn.Dense`` at the scope's dtype."""
    w = s.param("kernel", (x.shape[-1], features), init)
    b = s.param("bias", (features,), zeros)
    s.run.macs += x.numel() // x.shape[0] // x.shape[-1] * x.shape[-1] * features
    return torch.matmul(x.to(s.dtype), w.to(s.dtype)) + b.to(s.dtype)


def max_pool(x, window: int, stride: int, padding: Padding = "VALID"):
    """flax ``nn.max_pool`` (pads with -inf)."""
    x, pad = _padded(x, _pads(x, padding, (window,) * 2, (stride,) * 2),
                     value=-math.inf)
    return F.max_pool2d(x, window, stride, pad)


def avg_pool(x, window: int, stride: int, padding: Padding = "VALID"):
    """flax ``nn.avg_pool``: the zero pad counts in every window's mean."""
    x, pad = _padded(x, _pads(x, padding, (window,) * 2, (stride,) * 2))
    return F.avg_pool2d(x, window, stride, pad, count_include_pad=True)


def mean_pool(x, dtype) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of NHWC: summed in f32 (or wider),
    rounded once."""
    return torch.mean(x, dim=(2, 3), dtype=_at_least_f32(x.dtype)).to(dtype)


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def flatten_nhwc(x) -> torch.Tensor:
    """``x.reshape(B, -1)`` of the NHWC array: H, W, C order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def dropout(s: Scope, x, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: identity unless training with ``rate`` > 0."""
    if not s.run.train or rate <= 0:
        return x
    if s.run.generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = torch.rand(x.shape, generator=s.run.generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))

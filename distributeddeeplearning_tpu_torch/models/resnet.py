"""The ResNet v1 family of ``models/resnet.py``, in PyTorch.

Depths 18/34/50/101/152/200 (:data:`RESNET_CONFIGS`): basic 3x3+3x3 blocks
for 18 and 34, bottleneck 1x1-3x3-1x1(x4) blocks from 50, ResNet v1's
conv-BN-ReLU order, a projection shortcut on each stage's first block, and
the last BatchNorm of every block initialised to scale 0 so a fresh block
is the identity.  The stem is a 7x7/2 conv, BN-ReLU and a 3x3/2 max-pool
with (1, 1) padding; strided convs take the reference's fixed padding
(:func:`fixed_padding`: symmetric for the odd kernels used here).  The
head is a Dense initialised ``normal(0.01)`` after the global mean pool,
its logits returned in f32.  BatchNorm momentum 0.9, epsilon 1e-5.

Variables, layout and rounding are those of :mod:`._convnet`: flax's tree
and names, channels-last activations in the compute dtype, f32 params and
statistics.  Carry JAX weights over with :func:`variables_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch.models import register
from distributeddeeplearning_tpu_torch.models._convnet import (  # noqa: F401
    ImageModel,
    Scope,
    batch_norm,
    conv,
    dense,
    lecun_normal,
    max_pool,
    mean_pool,
    normal,
    ones,
    variables_from_numpy,
    variables_to_numpy,
    zeros,
)

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5

# depth -> (block, stage sizes)
RESNET_CONFIGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def fixed_padding(kernel_size: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Input-size-independent (lo, hi) spatial padding of a strided conv:
    kernel_size - 1 in all, the floor half before."""
    pad_total = kernel_size - 1
    pad_beg = pad_total // 2
    return ((pad_beg, pad_total - pad_beg),) * 2


def conv_fixed_padding(s: Scope, x, features: int, kernel_size: int,
                       strides: int = 1):
    """``ConvFixedPadding``: a bias-free conv, "SAME" at stride 1."""
    padding = fixed_padding(kernel_size) if strides > 1 else "SAME"
    return conv(s.child("Conv_0"), x, features, kernel_size, stride=strides,
                padding=padding, init=lecun_normal)


def batch_norm_relu(s: Scope, x, *, relu: bool = True, init_zero: bool = False):
    """``BatchNormRelu``: BatchNorm, then ReLU unless ``relu`` is False."""
    x = batch_norm(s.child("BatchNorm_0"), x, momentum=BN_MOMENTUM, eps=BN_EPSILON,
                   scale_init=zeros if init_zero else ones)
    return F.relu(x) if relu else x


def _shortcut(s: Scope, x, features: int, strides: int, use_projection: bool):
    if not use_projection:
        return x
    x = conv_fixed_padding(s.child("proj_conv"), x, features, 1, strides)
    return batch_norm_relu(s.child("proj_bn"), x, relu=False)


def residual_block(s: Scope, x, features: int, strides: int,
                   use_projection: bool = False):
    """The basic 3x3 + 3x3 block (ResNet-18/34)."""
    shortcut = _shortcut(s, x, features, strides, use_projection)
    x = conv_fixed_padding(s.auto("ConvFixedPadding"), x, features, 3, strides)
    x = batch_norm_relu(s.auto("BatchNormRelu"), x)
    x = conv_fixed_padding(s.auto("ConvFixedPadding"), x, features, 3, 1)
    x = batch_norm_relu(s.auto("BatchNormRelu"), x, relu=False, init_zero=True)
    return F.relu(x + shortcut)


def bottleneck_block(s: Scope, x, features: int, strides: int,
                     use_projection: bool = False):
    """The 1x1 -> 3x3 -> 1x1 (x4) block (ResNet-50 and deeper)."""
    shortcut = _shortcut(s, x, 4 * features, strides, use_projection)
    x = conv_fixed_padding(s.auto("ConvFixedPadding"), x, features, 1, 1)
    x = batch_norm_relu(s.auto("BatchNormRelu"), x)
    x = conv_fixed_padding(s.auto("ConvFixedPadding"), x, features, 3, strides)
    x = batch_norm_relu(s.auto("BatchNormRelu"), x)
    x = conv_fixed_padding(s.auto("ConvFixedPadding"), x, 4 * features, 1, 1)
    x = batch_norm_relu(s.auto("BatchNormRelu"), x, relu=False, init_zero=True)
    return F.relu(x + shortcut)


@dataclasses.dataclass
class ResNet(ImageModel):
    """ResNet v1 at ``depth``; see :class:`._convnet.ImageModel` for
    ``init``, ``param_shapes``, ``forward_macs`` and the call."""

    depth: int = 50
    num_classes: int = 1001
    dtype: torch.dtype = torch.bfloat16
    width_multiplier: int = 1

    def __post_init__(self):
        if self.depth not in RESNET_CONFIGS:
            raise ValueError(f"ResNet depth {self.depth} not in "
                             f"{sorted(RESNET_CONFIGS)}")

    def _forward(self, s: Scope, x):
        block_kind, stages = RESNET_CONFIGS[self.depth]
        block = residual_block if block_kind == "basic" else bottleneck_block
        width = 64 * self.width_multiplier
        x = conv_fixed_padding(s.child("stem_conv"), x, width, 7, 2)
        x = batch_norm_relu(s.child("stem_bn"), x)
        x = max_pool(x, 3, 2, fixed_padding(3))
        for i, num_blocks in enumerate(stages):
            features = width * 2 ** i
            x = block(s.child(f"stage{i + 1}_block1"), x, features,
                      1 if i == 0 else 2, use_projection=True)
            for j in range(1, num_blocks):
                x = block(s.child(f"stage{i + 1}_block{j + 1}"), x, features, 1)
        x = mean_pool(x, self.dtype)
        x = dense(s.child("head"), x, self.num_classes, init=normal(0.01))
        return x.float()


for _depth in RESNET_CONFIGS:
    register(f"resnet{_depth}")(partial(ResNet, depth=_depth))

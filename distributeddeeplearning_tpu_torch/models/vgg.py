"""VGG and AlexNet of ``models/vgg.py``, in PyTorch.

VGG configs A, D and E (:data:`VGG_CONFIGS`: vgg11, vgg16, vgg19; 3x3
"SAME" convs with bias and ReLU, 2x2/2 max-pools) and the one-tower
AlexNet (11x11/4, 5x5, three 3x3 convs, 3x3/2 max-pools), each with two
4096-wide Dense + ReLU layers, dropout after each (rate 0.5) and a 1001-way
head whose logits come back in f32.  No BatchNorm, so ``batch_stats`` is
``{}``.  The feature map is flattened in the reference's NHWC order, so
the first Dense layer's kernel takes flax's rows as they are; its width
depends on the input size given to ``init``.

AlexNet's first conv is "SAME" at stride 4: TensorFlow's padding, the odd
cell at the end, applied explicitly.  Dropout draws from the step's
``torch.Generator``.  Variables, layout and rounding are those of
:mod:`._convnet`.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch.models import register
from distributeddeeplearning_tpu_torch.models._convnet import (
    ImageModel,
    Scope,
    conv,
    dense,
    dropout,
    flatten_nhwc,
    max_pool,
)

# config -> conv widths per block ("M" = maxpool); 1409.1556 Table 1
VGG_CONFIGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def _classifier(s: Scope, x, num_classes: int, dropout_rate: float):
    """Flatten, fc1 and fc2 (Dense 4096 + ReLU, then dropout), the head."""
    x = flatten_nhwc(x)
    for i in (1, 2):
        x = F.relu(dense(s.child(f"fc{i}"), x, 4096))
        x = dropout(s, x, dropout_rate)
    return dense(s.child("head"), x, num_classes).float()


@dataclasses.dataclass
class VGG(ImageModel):
    """VGG at ``depth``; see :class:`._convnet.ImageModel`."""

    depth: int = 16
    num_classes: int = 1001
    dtype: torch.dtype = torch.bfloat16
    dropout_rate: float = 0.5

    def __post_init__(self):
        if self.depth not in VGG_CONFIGS:
            raise ValueError(f"VGG depth {self.depth} not in {sorted(VGG_CONFIGS)}")

    def _forward(self, s: Scope, x):
        conv_i = 0
        for item in VGG_CONFIGS[self.depth]:
            if item == "M":
                x = max_pool(x, 2, 2)
                continue
            conv_i += 1
            x = F.relu(conv(s.child(f"conv{conv_i}"), x, item, 3, bias=True))
        return _classifier(s, x, self.num_classes, self.dropout_rate)


@dataclasses.dataclass
class AlexNet(ImageModel):
    """One-tower AlexNet (the tf_cnn_benchmarks variant)."""

    num_classes: int = 1001
    dtype: torch.dtype = torch.bfloat16
    dropout_rate: float = 0.5

    def _forward(self, s: Scope, x):
        x = F.relu(conv(s.child("conv1"), x, 64, 11, stride=4, bias=True))
        x = max_pool(x, 3, 2)
        x = F.relu(conv(s.child("conv2"), x, 192, 5, bias=True))
        x = max_pool(x, 3, 2)
        x = F.relu(conv(s.child("conv3"), x, 384, 3, bias=True))
        x = F.relu(conv(s.child("conv4"), x, 256, 3, bias=True))
        x = F.relu(conv(s.child("conv5"), x, 256, 3, bias=True))
        x = max_pool(x, 3, 2)
        return _classifier(s, x, self.num_classes, self.dropout_rate)


for _depth in VGG_CONFIGS:
    register(f"vgg{_depth}")(partial(VGG, depth=_depth))
register("alexnet")(AlexNet)

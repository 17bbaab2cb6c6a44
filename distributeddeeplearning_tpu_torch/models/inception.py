"""Inception v3 of ``models/inception.py``, in PyTorch.

The standard Inception v3 (Szegedy et al. 1512.00567): a 299x299 input,
the stem, 3 x InceptionA, InceptionB, 4 x InceptionC, InceptionD, 2 x
InceptionE, the global mean pool, optional dropout and a 1001-way head
whose logits come back in f32.  Every conv is bias-free and followed by
BatchNorm (momentum 0.9997, epsilon 1e-3) and ReLU.

With ``aux_logits`` the auxiliary classifier runs off the 17x17x768 grid in
training and the train-mode forward returns ``(logits, aux_logits)``;
:func:`inception_aux_loss` is the loss for it.  Its 5x5/3 average pool and
5x5 conv are VALID where the grid is at least 5 wide and TensorFlow-SAME
below that (an odd pad then goes at the end).  While creating variables
the aux head runs whatever the mode, so its params always exist.

Variables, layout and rounding are those of :mod:`._convnet`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch.models import register
from distributeddeeplearning_tpu_torch.models._convnet import (
    ImageModel,
    Scope,
    avg_pool,
    batch_norm,
    conv,
    dense,
    dropout,
    max_pool,
    mean_pool,
)


def conv_bn(s: Scope, x, features: int, kernel=1, strides: int = 1,
            padding: str = "SAME"):
    """``ConvBN``: a bias-free conv, BatchNorm and ReLU."""
    x = conv(s.child("Conv_0"), x, features, kernel, stride=strides, padding=padding)
    x = batch_norm(s.child("BatchNorm_0"), x, momentum=0.9997, eps=1e-3)
    return F.relu(x)


def inception_a(s: Scope, x, pool_features: int):
    b1 = conv_bn(s.auto("ConvBN"), x, 64, 1)
    b2 = conv_bn(s.auto("ConvBN"), x, 48, 1)
    b2 = conv_bn(s.auto("ConvBN"), b2, 64, 5)
    b3 = conv_bn(s.auto("ConvBN"), x, 64, 1)
    b3 = conv_bn(s.auto("ConvBN"), b3, 96, 3)
    b3 = conv_bn(s.auto("ConvBN"), b3, 96, 3)
    b4 = avg_pool(x, 3, 1, "SAME")
    b4 = conv_bn(s.auto("ConvBN"), b4, pool_features, 1)
    return torch.cat([b1, b2, b3, b4], dim=1)


def inception_b(s: Scope, x):
    """Grid reduction 35 -> 17."""
    b1 = conv_bn(s.auto("ConvBN"), x, 384, 3, strides=2, padding="VALID")
    b2 = conv_bn(s.auto("ConvBN"), x, 64, 1)
    b2 = conv_bn(s.auto("ConvBN"), b2, 96, 3)
    b2 = conv_bn(s.auto("ConvBN"), b2, 96, 3, strides=2, padding="VALID")
    b3 = max_pool(x, 3, 2)
    return torch.cat([b1, b2, b3], dim=1)


def inception_c(s: Scope, x, channels_7x7: int):
    """Factorised 7x7 branches."""
    c7 = channels_7x7
    b1 = conv_bn(s.auto("ConvBN"), x, 192, 1)
    b2 = conv_bn(s.auto("ConvBN"), x, c7, 1)
    b2 = conv_bn(s.auto("ConvBN"), b2, c7, (1, 7))
    b2 = conv_bn(s.auto("ConvBN"), b2, 192, (7, 1))
    b3 = conv_bn(s.auto("ConvBN"), x, c7, 1)
    b3 = conv_bn(s.auto("ConvBN"), b3, c7, (7, 1))
    b3 = conv_bn(s.auto("ConvBN"), b3, c7, (1, 7))
    b3 = conv_bn(s.auto("ConvBN"), b3, c7, (7, 1))
    b3 = conv_bn(s.auto("ConvBN"), b3, 192, (1, 7))
    b4 = avg_pool(x, 3, 1, "SAME")
    b4 = conv_bn(s.auto("ConvBN"), b4, 192, 1)
    return torch.cat([b1, b2, b3, b4], dim=1)


def inception_d(s: Scope, x):
    """Grid reduction 17 -> 8."""
    b1 = conv_bn(s.auto("ConvBN"), x, 192, 1)
    b1 = conv_bn(s.auto("ConvBN"), b1, 320, 3, strides=2, padding="VALID")
    b2 = conv_bn(s.auto("ConvBN"), x, 192, 1)
    b2 = conv_bn(s.auto("ConvBN"), b2, 192, (1, 7))
    b2 = conv_bn(s.auto("ConvBN"), b2, 192, (7, 1))
    b2 = conv_bn(s.auto("ConvBN"), b2, 192, 3, strides=2, padding="VALID")
    b3 = max_pool(x, 3, 2)
    return torch.cat([b1, b2, b3], dim=1)


def inception_e(s: Scope, x):
    """Expanded filter-bank output blocks."""
    b1 = conv_bn(s.auto("ConvBN"), x, 320, 1)
    b2 = conv_bn(s.auto("ConvBN"), x, 384, 1)
    b2 = torch.cat([conv_bn(s.auto("ConvBN"), b2, 384, (1, 3)),
                    conv_bn(s.auto("ConvBN"), b2, 384, (3, 1))], dim=1)
    b3 = conv_bn(s.auto("ConvBN"), x, 448, 1)
    b3 = conv_bn(s.auto("ConvBN"), b3, 384, 3)
    b3 = torch.cat([conv_bn(s.auto("ConvBN"), b3, 384, (1, 3)),
                    conv_bn(s.auto("ConvBN"), b3, 384, (3, 1))], dim=1)
    b4 = avg_pool(x, 3, 1, "SAME")
    b4 = conv_bn(s.auto("ConvBN"), b4, 192, 1)
    return torch.cat([b1, b2, b3, b4], dim=1)


def _grid_padding(x) -> str:
    return "VALID" if min(x.shape[2], x.shape[3]) >= 5 else "SAME"


def inception_aux(s: Scope, x, num_classes: int):
    """The auxiliary classifier: logits in f32."""
    x = avg_pool(x, 5, 3, _grid_padding(x))
    x = conv_bn(s.auto("ConvBN"), x, 128, 1)
    x = conv_bn(s.auto("ConvBN"), x, 768, 5, padding=_grid_padding(x))
    x = mean_pool(x, s.dtype)
    return dense(s.child("aux_head"), x, num_classes).float()


def inception_aux_loss(outputs, labels, *, label_smoothing: float = 0.0,
                       aux_weight: float = 0.4):
    """Main + 0.4 x aux cross-entropy of a train-mode ``(logits, aux)``:
    the ``loss_fn`` of ``build_train_step`` for ``aux_logits=True``."""
    from distributeddeeplearning_tpu_torch.train.step import cross_entropy_loss

    logits, aux = outputs
    return cross_entropy_loss(
        logits, labels, label_smoothing=label_smoothing
    ) + aux_weight * cross_entropy_loss(aux, labels, label_smoothing=label_smoothing)


@dataclasses.dataclass
class InceptionV3(ImageModel):
    """Inception v3 (inputs of 75 x 75 and up); see
    :class:`._convnet.ImageModel` for ``init``, ``param_shapes``,
    ``forward_macs`` and the call."""

    num_classes: int = 1001
    dtype: torch.dtype = torch.bfloat16
    dropout_rate: float = 0.0
    aux_logits: bool = False

    def _forward(self, s: Scope, x):
        x = conv_bn(s.auto("ConvBN"), x, 32, 3, strides=2, padding="VALID")
        x = conv_bn(s.auto("ConvBN"), x, 32, 3, padding="VALID")
        x = conv_bn(s.auto("ConvBN"), x, 64, 3)
        x = max_pool(x, 3, 2)
        x = conv_bn(s.auto("ConvBN"), x, 80, 1, padding="VALID")
        x = conv_bn(s.auto("ConvBN"), x, 192, 3, padding="VALID")
        x = max_pool(x, 3, 2)
        for pool_features in (32, 64, 64):
            x = inception_a(s.auto("InceptionA"), x, pool_features)
        x = inception_b(s.auto("InceptionB"), x)
        for c7 in (128, 160, 160, 192):
            x = inception_c(s.auto("InceptionC"), x, c7)
        aux = None
        if self.aux_logits and (s.run.train or s.initializing):
            aux = inception_aux(s.auto("InceptionAux"), x, self.num_classes)
        x = inception_d(s.auto("InceptionD"), x)
        x = inception_e(s.auto("InceptionE"), x)
        x = inception_e(s.auto("InceptionE"), x)
        x = mean_pool(x, self.dtype)
        x = dropout(s, x, self.dropout_rate)
        x = dense(s.child("head"), x, self.num_classes).float()
        if self.aux_logits and s.run.train and not s.initializing:
            return x, aux
        return x


register("inceptionv3")(InceptionV3)
register("inception_v3")(InceptionV3)

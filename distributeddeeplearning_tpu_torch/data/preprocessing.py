"""ImageNet preprocessing without TensorFlow — the port of
``data/preprocessing.py``.

The reference's recipe (``TensorFlow_imagenet/src/imagenet_preprocessing.py
:51-222``) as the reference runs it through tf.data, rebuilt on PIL, numpy
and torch so the port needs no TensorFlow:

- decode: PIL (libjpeg's accurate integer DCT with fancy upsampling, which
  is ``tf.io.decode_jpeg(dct_method="INTEGER_ACCURATE")`` bit for bit);
- train, ``augment="reference"``: a bilinear squash-resize of the whole
  image to ``image_size`` (``torch.nn.functional.interpolate``, bilinear,
  half-pixel centres, no antialias, in float32: ``tf.image.resize``'s
  ``"bilinear"``); no crop, no flip;
- train, ``augment="inception"`` (the reference's documented deviation): a
  crop sampled as ``tf.image.sample_distorted_bounding_box`` samples one
  (area 0.08-1.0 of the image and at least 0.1 of it covered, aspect
  3/4-4/3, 10 attempts, the whole image as the fallback) from an explicit
  ``np.random.Generator``, resized the same way, then a random horizontal
  flip;
- eval: the central square of ``int(min(h, w) * image_size / RESIZE_MIN)``
  pixels (224/256 of the short side), resized the same way;
- both: channel-mean subtraction (no std division), NHWC float32.

Two departures, both measured by the tests against the reference's TF
path: TF's ``decode_jpeg`` defaults to the fast integer DCT (up to 5 levels
from PIL's decode), and ``decode_and_crop_jpeg`` decodes only the crop
window, which moves its edge pixels; this module decodes the whole image
with the accurate DCT and crops the array.
"""

from __future__ import annotations

import io
import math
from typing import Optional, Tuple

import numpy as np

# Channel means, RGB order — imagenet_preprocessing.py:30-33.
CHANNEL_MEANS = (123.68, 116.78, 103.94)
DEFAULT_IMAGE_SIZE = 224
RESIZE_MIN = 256  # eval short-side target, _aspect_preserving_resize

# tf.image.sample_distorted_bounding_box as decode_and_random_crop calls it
MIN_OBJECT_COVERED = 0.1
ASPECT_RATIO_RANGE = (3 / 4, 4 / 3)
AREA_RANGE = (0.08, 1.0)
MAX_ATTEMPTS = 10


def decode_jpeg(image_bytes: bytes) -> np.ndarray:
    """JPEG (or any PIL format) bytes -> uint8 [h, w, 3] RGB."""
    from PIL import Image

    with Image.open(io.BytesIO(image_bytes)) as img:
        return np.asarray(img.convert("RGB"))


def resize_bilinear(image: np.ndarray, image_size: int) -> np.ndarray:
    """[h, w, 3] -> float32 [image_size, image_size, 3]: bilinear,
    half-pixel centres, no antialias (``tf.image.resize(..., "bilinear")``)."""
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    x = x.permute(2, 0, 1).unsqueeze(0)
    y = F.interpolate(x, size=(image_size, image_size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def central_crop_window(h: int, w: int, image_size: int) -> Tuple[int, int, int]:
    """(offset_y, offset_x, side) of the eval crop, in float32 arithmetic
    as ``decode_and_center_crop`` computes it."""
    side = int(np.float32(min(h, w)) * np.float32(image_size / RESIZE_MIN))
    return (h - side) // 2, (w - side) // 2, side


def sample_distorted_bounding_box(
    h: int, w: int, rng: np.random.Generator
) -> Tuple[int, int, int, int]:
    """(offset_y, offset_x, height, width) of a random crop, sampled as
    ``tf.image.sample_distorted_bounding_box`` samples it for the whole
    image as the one box (``GenerateRandomCrop`` in TF's
    ``sample_distorted_bounding_box_op.cc``): each attempt draws an aspect
    ratio, then a height from the area range's bounds, and keeps the crop
    if it fits, its area is in range and it covers ``MIN_OBJECT_COVERED``
    of the image; after ``MAX_ATTEMPTS`` failures the whole image.  The
    draws come from ``rng``, not TF's Philox stream."""
    min_area = AREA_RANGE[0] * h * w
    max_area = AREA_RANGE[1] * h * w
    for _ in range(MAX_ATTEMPTS):
        aspect = rng.uniform(*ASPECT_RATIO_RANGE)
        ch = round(math.sqrt(min_area / aspect))
        max_h = round(math.sqrt(max_area / aspect))
        if round(max_h * aspect) > w:
            max_h = int((w + 0.5 - 1e-7) / aspect)
            if round(max_h * aspect) > w:
                max_h -= 1
        max_h = min(max_h, h)
        ch = min(ch, max_h)
        if ch < max_h:
            ch += int(rng.integers(max_h - ch + 1))
        cw = round(ch * aspect)
        if cw * ch < min_area:
            ch += 1
            cw = round(ch * aspect)
        if not (0 < ch <= h and 0 < cw <= w and min_area <= cw * ch <= max_area):
            continue
        if cw * ch < MIN_OBJECT_COVERED * h * w:
            continue
        y = int(rng.integers(h - ch)) if ch < h else 0
        x = int(rng.integers(w - cw)) if cw < w else 0
        return y, x, ch, cw
    return 0, 0, h, w


def decode_and_resize(image_bytes: bytes, image_size: int) -> np.ndarray:
    """Reference train path: decode + bilinear squash-resize."""
    return resize_bilinear(decode_jpeg(image_bytes), image_size)


def decode_and_random_crop(image_bytes: bytes, image_size: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Inception train path: a sampled crop, resized."""
    image = decode_jpeg(image_bytes)
    y, x, ch, cw = sample_distorted_bounding_box(*image.shape[:2], rng)
    return resize_bilinear(image[y:y + ch, x:x + cw], image_size)


def decode_and_center_crop(image_bytes: bytes, image_size: int) -> np.ndarray:
    """Eval path: the central crop, resized."""
    image = decode_jpeg(image_bytes)
    y, x, side = central_crop_window(*image.shape[:2], image_size)
    return resize_bilinear(image[y:y + side, x:x + side], image_size)


def preprocess_image(
    image_bytes: bytes,
    is_training: bool,
    image_size: int = DEFAULT_IMAGE_SIZE,
    augment: str = "reference",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """JPEG bytes -> mean-subtracted float32 [image_size, image_size, 3].

    ``augment``: "reference" = the reference's train path (resize only);
    "inception" = sampled crop + random flip, drawn from ``rng`` (a fresh
    unseeded generator when None)."""
    if is_training:
        if augment == "inception":
            rng = np.random.default_rng() if rng is None else rng
            image = decode_and_random_crop(image_bytes, image_size, rng)
            if rng.random() < 0.5:
                image = image[:, ::-1]
        elif augment == "reference":
            image = decode_and_resize(image_bytes, image_size)
        else:
            raise ValueError(f"unknown augment mode {augment!r}")
    else:
        image = decode_and_center_crop(image_bytes, image_size)
    return normalize_np(image)


# --- numpy helpers kept from the reference ---


def normalize_np(image: np.ndarray) -> np.ndarray:
    return image.astype(np.float32) - np.asarray(CHANNEL_MEANS, np.float32)


def central_crop_np(image: np.ndarray, image_size: int) -> np.ndarray:
    h, w = image.shape[:2]
    crop = int(min(h, w) * image_size / RESIZE_MIN)
    y, x = (h - crop) // 2, (w - crop) // 2
    cropped = image[y : y + crop, x : x + crop]
    # nearest-neighbour resize (test fidelity only)
    ys = (np.arange(image_size) * crop / image_size).astype(int)
    xs = (np.arange(image_size) * crop / image_size).astype(int)
    return cropped[ys][:, xs]

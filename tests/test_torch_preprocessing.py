"""The port's TF-free preprocessing against the JAX package's tf.data
recipe, on the same JPEG bytes.

Parts are held tightly, the whole to a stated bound:

- PIL's decode equals ``tf.io.decode_jpeg(dct_method="INTEGER_ACCURATE")``
  bit for bit;
- ``resize_bilinear`` on one decoded array is within 1e-3 of
  ``tf.image.resize(..., "bilinear")`` (observed <= 4.4e-4: float32 sums in
  another order);
- the eval crop window is TF's float32 arithmetic exactly, and the recipe
  built from TF's own ops on the accurate decode (decode, crop the array,
  resize, subtract the means) is within 1e-3 of the port's whole recipe;
- against ref ``preprocess_image`` itself, which decodes with TF's default
  fast DCT (up to 5 levels from the accurate one) and decodes only the
  crop window on the eval path: on ILSVRC-size synthetic JPEGs (the bench
  generator's) max |diff| <= 5 on the train path and <= 10 on the eval
  path, mean |diff| <= 1.25 (observed 3.69 / 7.54 / 1.01 at 224, 64 and
  32 px); white-noise and grayscale images are held only to the tight
  check above, since the fast DCT's error grows with high frequencies;
- ``inception`` crops stay in the area (>= 0.1 covered, <= 1) and aspect
  (3/4..4/3, up to rounding) ranges, fall back to the whole image when no
  attempt fits, and repeat for a seed.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import preprocessing as rp
from distributeddeeplearning_tpu.data.bench_data import _synthetic_jpeg
from distributeddeeplearning_tpu_torch.data import preprocessing as tp

tf = pytest.importorskip("tensorflow")
torch.set_num_threads(2)  # the suite runs six workers on eight cores

MEANS = np.asarray(tp.CHANNEL_MEANS, np.float32)
N_ILSVRC = 5


@pytest.fixture(scope="module")
def jpegs():
    """ILSVRC-size smooth random JPEGs (the bench generator's), plus a
    grayscale one and a 4:4:4 one."""
    from PIL import Image

    rng = np.random.default_rng(0)
    out = [_synthetic_jpeg(rng) for _ in range(N_ILSVRC)]
    gray = rng.integers(0, 256, (61, 83), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(gray, "L").save(buf, "JPEG", quality=90)
    out.append(buf.getvalue())
    rgb = rng.integers(0, 256, (47, 90, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=95, subsampling=0)
    out.append(buf.getvalue())
    return out


def test_constants_equal_the_reference():
    assert tp.CHANNEL_MEANS == rp.CHANNEL_MEANS
    assert (tp.DEFAULT_IMAGE_SIZE, tp.RESIZE_MIN) == (rp.DEFAULT_IMAGE_SIZE,
                                                     rp.RESIZE_MIN)
    img = np.random.default_rng(1).integers(0, 256, (50, 70, 3), np.uint8)
    np.testing.assert_array_equal(tp.normalize_np(img), rp.normalize_np(img))
    np.testing.assert_array_equal(tp.central_crop_np(img, 32),
                                  rp.central_crop_np(img, 32))


def test_pil_decode_is_tf_accurate_dct(jpegs):
    for j in jpegs:
        np.testing.assert_array_equal(
            tp.decode_jpeg(j),
            tf.io.decode_jpeg(j, channels=3, dct_method="INTEGER_ACCURATE").numpy())


@pytest.mark.parametrize("size", [32, 64, 224, 600])
def test_resize_matches_tf_image_resize(jpegs, size):
    for j in jpegs:
        img = tp.decode_jpeg(j)
        want = tf.image.resize(img, [size, size], method="bilinear").numpy()
        np.testing.assert_allclose(tp.resize_bilinear(img, size), want,
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,w", [(375, 500), (333, 500), (500, 400), (61, 83),
                                 (47, 90), (257, 1000)])
@pytest.mark.parametrize("size", [32, 64, 224, 299])
def test_central_crop_window_is_tfs(h, w, size):
    side = int(tf.cast(tf.cast(tf.minimum(h, w), tf.float32) * (size / rp.RESIZE_MIN),
                       tf.int32))
    assert tp.central_crop_window(h, w, size) == ((h - side) // 2, (w - side) // 2,
                                                  side)


def _tf_recipe_on_accurate_decode(jpeg, is_training, size):
    image = tf.io.decode_jpeg(jpeg, channels=3, dct_method="INTEGER_ACCURATE")
    if not is_training:
        h, w = image.shape[:2]
        y, x, side = tp.central_crop_window(h, w, size)
        image = image[y:y + side, x:x + side]
    image = tf.image.resize(image, [size, size], method="bilinear")
    return rp.mean_image_subtraction(tf.cast(image, tf.float32)).numpy()


@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("size", [32, 64, 224])
def test_recipe_against_the_reference(jpegs, is_training, size):
    worst = mean = 0.0
    for i, j in enumerate(jpegs):
        ours = tp.preprocess_image(j, is_training, size)
        assert ours.shape == (size, size, 3) and ours.dtype == np.float32
        np.testing.assert_allclose(
            ours, _tf_recipe_on_accurate_decode(j, is_training, size),
            rtol=0, atol=1e-3)
        if i >= N_ILSVRC:
            continue  # the bound is stated for ILSVRC-like images
        ref = rp.preprocess_image(tf.constant(j), is_training, size).numpy()
        worst = max(worst, float(np.abs(ours - ref).max()))
        mean = max(mean, float(np.abs(ours - ref).mean()))
    assert worst <= (5.0 if is_training else 10.0), worst
    assert mean <= 1.25, mean


def test_unknown_augment_rejected(jpegs):
    with pytest.raises(ValueError, match="augment"):
        tp.preprocess_image(jpegs[0], True, 32, augment="mixup")


@pytest.mark.parametrize("h,w", [(375, 500), (500, 333), (64, 64), (60, 300)])
def test_inception_crops_in_range_and_seeded(h, w):
    crops = [tp.sample_distorted_bounding_box(h, w, np.random.default_rng(s))
             for s in range(200)]
    again = [tp.sample_distorted_bounding_box(h, w, np.random.default_rng(s))
             for s in range(200)]
    assert crops == again
    fallbacks = 0
    for y, x, ch, cw in crops:
        assert 0 <= y and y + ch <= h and 0 <= x and x + cw <= w
        if (y, x, ch, cw) == (0, 0, h, w):
            fallbacks += 1
            continue
        assert 0.1 * h * w <= ch * cw <= h * w
        # rounding the width to whole pixels moves the aspect by <= 0.5/ch
        assert 3 / 4 - 0.5 / ch <= cw / ch <= 4 / 3 + 0.5 / ch
    assert fallbacks < len(crops)  # most draws fit
    assert len(set(crops)) > 100
    # a strip no 3/4..4/3 box can cover 10% of always falls back
    assert tp.sample_distorted_bounding_box(4, 400, np.random.default_rng(0)) == (
        0, 0, 4, 400)


def test_inception_path_is_seeded_and_flips(jpegs):
    a = tp.preprocess_image(jpegs[0], True, 32, "inception",
                            np.random.default_rng(3))
    b = tp.preprocess_image(jpegs[0], True, 32, "inception",
                            np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    outs = [tp.preprocess_image(jpegs[0], True, 32, "inception",
                                np.random.default_rng(s)) for s in range(6)]
    assert len({o.tobytes() for o in outs}) == 6
    # the flip is the last step: un-flipping a flipped draw gives the
    # unflipped crop of the same draws
    rng = np.random.default_rng(11)
    image = tp.decode_jpeg(jpegs[0])
    y, x, ch, cw = tp.sample_distorted_bounding_box(*image.shape[:2], rng)
    flip = rng.random() < 0.5
    crop = tp.resize_bilinear(image[y:y + ch, x:x + cw], 32) - MEANS
    got = tp.preprocess_image(jpegs[0], True, 32, "inception",
                              np.random.default_rng(11))
    np.testing.assert_array_equal(got, crop[:, ::-1] if flip else crop)

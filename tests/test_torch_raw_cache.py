"""The port's decode-once raw cache and bench shards against the JAX
package's.

- ``bench_data.generate_bench_shards`` writes the reference's shards byte
  for byte (same seed), idempotently;
- ``build_raw_cache`` writes the reference's ``images.u8`` and
  ``labels.i32`` byte for byte and its manifest, decoding through the C
  decoder and through the PIL branch a host without libjpeg takes, and
  reuses a cache whose manifest matches;
- ``raw_cache_input_fn`` yields the reference's stream batch for batch
  over either decoder's caches: training over epochs for two seeds, eval
  with a short last batch, each host shard, and ``start_batch``
  fast-forward (index math only) equal to the stream's batch N onward;
- ``uint8_normalizer`` (torch) equals the reference's (jax) on the same
  uint8 batch, and a train step over the uint8 batch through it gives the
  float pipeline's loss (1e-4) and top-1;
- the cache's pixels are the native pipeline's up to uint8 rounding
  (<= 0.5 + 1e-3).
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import bench_data as r_bench
from distributeddeeplearning_tpu.data import raw_cache as r_raw
from distributeddeeplearning_tpu_torch.data import bench_data as t_bench
from distributeddeeplearning_tpu_torch.data import raw_cache as t_raw
from _torch_decoders import DECODERS, assert_decoded_by, jpeg_decoder

torch.set_num_threads(2)  # the suite runs six workers on eight cores

N_IMAGES = 24
IMAGE_SIZE = 32


def _digest(d, prefix="train-"):
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        if name.startswith(prefix):
            h.update(open(os.path.join(d, name), "rb").read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bench-shards"))
    t_bench.generate_bench_shards(d, num_images=N_IMAGES, num_shards=2, seed=7)
    t_bench.generate_bench_shards(d, num_images=12, num_shards=2, seed=8,
                                  split="validation")
    return d


@pytest.fixture(scope="module")
def decoded_caches(shard_dir, tmp_path_factory):
    """For each decoder: (port cache, reference cache) of the train split,
    and the same of validation, built from the same shards."""
    from distributeddeeplearning_tpu.data import _native_image as r_image
    from distributeddeeplearning_tpu_torch.data import _native_image as t_image

    t_image.native_available()  # built before the builders' pools ask
    r_image.native_available()
    out = {}
    root = tmp_path_factory.mktemp("caches")
    for decoder in DECODERS:
        out[decoder] = {}
        for train in (True, False):
            dirs = (str(root / f"port-{decoder}-{train}"),
                    str(root / f"ref-{decoder}-{train}"))
            with jpeg_decoder(decoder) as counts:
                t_raw.build_raw_cache(shard_dir, dirs[0], train,
                                      image_size=IMAGE_SIZE)
                r_raw.build_raw_cache(shard_dir, dirs[1], train,
                                      image_size=IMAGE_SIZE)
            assert_decoded_by(counts, decoder)
            out[decoder][train] = dirs
    return out


@pytest.fixture(scope="module")
def caches(decoded_caches):
    return decoded_caches["c"]


def test_bench_shards_equal_the_reference(shard_dir, tmp_path):
    ref = str(tmp_path / "ref")
    r_bench.generate_bench_shards(ref, num_images=N_IMAGES, num_shards=2, seed=7)
    assert _digest(shard_dir) == _digest(ref)
    before = _digest(shard_dir)
    manifest = t_bench.generate_bench_shards(shard_dir, num_images=N_IMAGES,
                                             num_shards=2, seed=7)
    assert _digest(shard_dir) == before and manifest["num_images"] == N_IMAGES
    with open(os.path.join(ref, t_bench.MANIFEST)) as f:
        assert json.load(f) == manifest
    other = str(tmp_path / "again")
    t_bench.ensure_bench_shards(other, num_images=N_IMAGES, num_shards=2)
    assert os.path.exists(os.path.join(other, t_bench.MANIFEST))


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("train", [True, False])
def test_cache_files_equal_the_reference(decoded_caches, train, decoder):
    ours, ref = decoded_caches[decoder][train]
    for name in (t_raw.IMAGES, t_raw.LABELS):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    m_ours, _, _ = t_raw.open_raw_cache(ours)
    m_ref, _, _ = r_raw.open_raw_cache(ref)
    assert m_ours == m_ref
    assert m_ours["count"] == (N_IMAGES if train else 12)
    assert (t_raw.cache_path_for("/d", train, 64, shard_count=4, shard_index=2)
            == r_raw.cache_path_for("/d", train, 64, shard_count=4, shard_index=2))


def _same_stream(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a["image"].dtype == np.uint8 and a["label"].dtype == np.int32
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("case", [
    dict(train=True, batch=8, seed=3, shard=(1, 0), n=7),
    dict(train=True, batch=5, seed=4, shard=(2, 1), n=6),
    dict(train=True, batch=8, seed=5, shard=(1, 0), n=4, start_batch=4),
    dict(train=False, batch=7, seed=0, shard=(1, 0), n=None, drop_remainder=False),
    dict(train=False, batch=4, seed=0, shard=(2, 0), n=None, drop_remainder=False),
])
@pytest.mark.parametrize("decoder", DECODERS)
def test_streams_equal_the_reference(decoded_caches, case, decoder):
    ours_dir, ref_dir = decoded_caches[decoder][case["train"]]
    kw = dict(shard_count=case["shard"][0], shard_index=case["shard"][1],
              seed=case["seed"], start_batch=case.get("start_batch", 0),
              drop_remainder=case.get("drop_remainder", True))

    def take(mod, d):
        it = mod.raw_cache_input_fn(d, case["train"], case["batch"], **kw)
        return list(it if case["n"] is None else itertools.islice(it, case["n"]))

    _same_stream(take(t_raw, ours_dir), take(r_raw, ref_dir))


def test_start_batch_continues_the_stream(caches):
    ours = caches[True][0]
    full = t_raw.raw_cache_input_fn(ours, True, 8, shard_count=1, shard_index=0,
                                    seed=5)
    want = list(itertools.islice(full, 7))[4:]  # epoch 1 starts at batch 3
    ff = t_raw.raw_cache_input_fn(ours, True, 8, shard_count=1, shard_index=0,
                                  seed=5, start_batch=4)
    _same_stream(list(itertools.islice(ff, 3)), want)
    with pytest.raises(ValueError, match="start_batch"):
        next(t_raw.raw_cache_input_fn(ours, False, 8, shard_count=1,
                                      shard_index=0, start_batch=2))


def test_uint8_normalizer_equals_the_reference(caches):
    batch = next(t_raw.raw_cache_input_fn(caches[True][0], True, 8,
                                          shard_count=1, shard_index=0))
    ours = t_raw.uint8_normalizer()(batch["image"])
    ref = np.asarray(r_raw.uint8_normalizer()(batch["image"]))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)
    moved = t_raw.uint8_normalizer(device="cpu")(torch.as_tensor(batch["image"]))
    np.testing.assert_array_equal(moved.numpy(), ref)


def test_cache_matches_native_pipeline_up_to_rounding(shard_dir, caches):
    from distributeddeeplearning_tpu_torch.data.native_pipeline import (
        native_input_fn,
    )
    from distributeddeeplearning_tpu_torch.data.preprocessing import CHANNEL_MEANS

    _, images, labels = t_raw.open_raw_cache(caches[True][0])
    batch = next(native_input_fn(shard_dir, True, N_IMAGES, image_size=IMAGE_SIZE,
                                 shard_count=1, shard_index=0, shuffle_buffer=0,
                                 repeat=False))
    cached = {int(l): images[i].astype(np.float32) for i, l in enumerate(labels)}
    means = np.asarray(CHANNEL_MEANS, np.float32)
    for img, label in zip(batch["image"], batch["label"]):
        assert np.abs(cached[int(label)] - (img + means)).max() <= 0.5 + 1e-3


def test_uint8_batch_trains_like_the_float_batch(caches):
    from distributeddeeplearning_tpu_torch.data.preprocessing import CHANNEL_MEANS
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.state import (
        create_train_state,
        sgd_momentum,
    )
    from distributeddeeplearning_tpu_torch.train.step import build_train_step

    batch = next(t_raw.raw_cache_input_fn(caches[True][0], True, 8,
                                          shard_count=1, shard_index=0))
    model = get_model("resnet18", num_classes=1001, dtype=torch.float32)

    def run(images, transform):
        state = create_train_state(torch.Generator().manual_seed(0), model,
                                   (8, IMAGE_SIZE, IMAGE_SIZE, 3),
                                   sgd_momentum(lambda s: 0.1), device="cpu")
        step = build_train_step(state, compute_dtype=torch.float32,
                                input_transform=transform)
        _, metrics = step(state, {"image": images, "label": batch["label"]})
        return float(metrics["loss"]), float(metrics["top1"])

    means = np.asarray(CHANNEL_MEANS, np.float32)
    loss_f, top1_f = run(batch["image"].astype(np.float32) - means, None)
    loss_u8, top1_u8 = run(batch["image"], t_raw.uint8_normalizer())
    assert np.isfinite(loss_u8) and abs(loss_u8 - loss_f) < 1e-4
    assert top1_u8 == top1_f


def test_refusals_and_corruption(shard_dir, tmp_path):
    with pytest.raises(ValueError, match="cannot be cached"):
        t_raw.build_raw_cache(shard_dir, str(tmp_path / "c"), True,
                              augment="inception")
    c = str(tmp_path / "corrupt")
    t_raw.build_raw_cache(shard_dir, c, False, image_size=16)
    mtime = os.path.getmtime(os.path.join(c, t_raw.IMAGES))
    t_raw.build_raw_cache(shard_dir, c, False, image_size=16)  # reused
    assert os.path.getmtime(os.path.join(c, t_raw.IMAGES)) == mtime
    with open(os.path.join(c, t_raw.MANIFEST)) as f:
        manifest = json.load(f)
    manifest["count"] += 1
    with open(os.path.join(c, t_raw.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="corrupt raw cache"):
        t_raw.open_raw_cache(c)
    with pytest.raises(FileNotFoundError, match="no raw cache"):
        t_raw.open_raw_cache(str(tmp_path / "absent"))

"""The port's input pipelines against the JAX package's, on records and
image trees the tests write themselves.

- ``native_pipeline.native_input_fn`` equals the reference's batch for
  batch and bit for bit, eval and train, on one host and on each of two
  host shards (the same ``random.Random(seed)`` calls), once through the C
  decoder and once through the PIL branch, which is what runs on a host
  without libjpeg.
- ``tfrecords.input_fn`` and ``images.input_fn`` (the tf.data recipe
  without TensorFlow) hold the reference's TF pipelines as multisets of
  (label, image): the eval order of tf.data depends on ``AUTOTUNE``, so no
  order can match it on every host.  On JPEGs at ILSVRC sizes each image
  is within the recipe's bound (max |diff| <= 10, mean <= 1.25: TF's fast
  DCT and its crop-window decode, ``test_torch_preprocessing.py``).  The
  port's eval order is file order, then record order.
- Both packages' C decoders are built before a pipeline's pool starts:
  the reference's ``_native_image._load`` marks the library tried before
  it is bound, so pool threads that ask during the first build take PIL
  (the port's waits on a lock).
- Training streams are seeded permutations of the records, reshuffled
  each epoch, batched across epochs under ``repeat``; the thread pool's
  width (``default_workers``) does not change a seeded stream.
- Host sharding partitions the files; mixed shard layouts pick the
  largest count (ref ``tests/test_native_pipeline.py:109``, ``:156``);
  ``gs://`` paths are refused.
"""

from __future__ import annotations

import itertools
import shutil

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import _native_image as r_native_image
from distributeddeeplearning_tpu.data import native_pipeline as r_native
from distributeddeeplearning_tpu_torch.data import convert_tfrecords
from distributeddeeplearning_tpu_torch.data import images as t_images
from distributeddeeplearning_tpu_torch.data import native_pipeline as t_native
from distributeddeeplearning_tpu_torch.data import tfrecords as t_tfrecords
from _torch_decoders import DECODERS, assert_decoded_by, jpeg_decoder

torch.set_num_threads(2)  # the suite runs six workers on eight cores

WNIDS = ["n01440764", "n01443537", "n02102040"]
PER_CLASS = 4
N = len(WNIDS) * PER_CLASS
SIZE = 32
MAX_DIFF, MEAN_DIFF = 10.0, 1.25


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A class-directory tree of JPEGs at ILSVRC sizes (the bench
    generator's smooth random fields): the recipe's bound is stated for
    such images."""
    from distributeddeeplearning_tpu_torch.data.bench_data import _synthetic_jpeg
    from distributeddeeplearning_tpu_torch.data import _native_image

    _native_image.native_available()  # build before any pool thread asks
    r_native_image.native_available()
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("pipe-imagenet")
    for split in ("train", "validation"):
        for wnid in WNIDS:
            d = root / split / wnid
            d.mkdir(parents=True)
            for i in range(PER_CLASS):
                (d / f"{wnid}_{i}.JPEG").write_bytes(_synthetic_jpeg(rng))
    return root


@pytest.fixture(scope="module")
def shards(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe-tfrecords")
    for split in ("train", "validation"):
        assert convert_tfrecords.convert_dataset(
            str(tree / split), str(out), split, 4) == N
    return str(out)


def _collect(it, n=None):
    return list(it if n is None else itertools.islice(it, n))


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("is_training,seed,shard", [
    (False, 0, (1, 0)), (True, 3, (1, 0)), (True, 5, (2, 1)), (False, 0, (2, 0)),
])
def test_native_pipeline_equals_the_reference(shards, is_training, seed, shard,
                                              decoder):
    kw = dict(image_size=SIZE, shard_count=shard[0], shard_index=shard[1],
              seed=seed, shuffle_buffer=5)
    n = 7 if is_training else None
    with jpeg_decoder(decoder) as counts:
        ours = _collect(t_native.native_input_fn(shards, is_training, 3, **kw), n)
        ref = _collect(r_native.native_input_fn(shards, is_training, 3, **kw), n)
    assert_decoded_by(counts, decoder)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["image"].dtype == np.float32 and a["label"].dtype == np.int32


def _match_multisets(ours, ref):
    """Pair each of ours with the closest reference image of its label;
    returns the worst max and mean |diff|."""
    assert sorted(int(l) for l, _ in ours) == sorted(int(l) for l, _ in ref)
    pool = list(ref)
    worst = mean = 0.0
    for label, img in ours:
        cands = [k for k, (l, _) in enumerate(pool) if l == label]
        errs = [np.abs(img - pool[k][1]).max() for k in cands]
        k = cands[int(np.argmin(errs))]
        worst = max(worst, float(np.abs(img - pool[k][1]).max()))
        mean = max(mean, float(np.abs(img - pool[k][1]).mean()))
        pool.pop(k)
    return worst, mean


def _pairs(batches):
    return [(int(l), img) for b in batches for l, img in zip(b["label"], b["image"])]


def test_tfrecords_eval_matches_tf_as_a_multiset(shards):
    from distributeddeeplearning_tpu.data import tfrecords as r_tfrecords

    kw = dict(image_size=SIZE, repeat=False, drop_remainder=False,
              shard_count=1, shard_index=0)
    ours = _collect(t_tfrecords.input_fn(shards, False, 5, **kw))
    assert [len(b["label"]) for b in ours] == [5, 5, 2]
    ref = _collect(r_tfrecords.input_fn(shards, False, 5, **kw))
    worst, mean = _match_multisets(_pairs(ours), _pairs(ref))
    assert worst <= MAX_DIFF and mean <= MEAN_DIFF, (worst, mean)
    # file order, then record order: the native reader's eval order
    native = _collect(t_native.native_input_fn(
        shards, False, N, image_size=SIZE, shard_count=1, shard_index=0))
    np.testing.assert_array_equal(np.concatenate([b["label"] for b in ours]),
                                  native[0]["label"])


def test_images_eval_matches_tf_as_a_multiset(tree):
    from distributeddeeplearning_tpu.data import images as r_images

    kw = dict(image_size=SIZE, repeat=False, drop_remainder=False,
              shard_count=1, shard_index=0)
    ours = _collect(t_images.input_fn(str(tree / "validation"), False, 5, **kw))
    ref = _collect(r_images.input_fn(str(tree / "validation"), False, 5, **kw))
    worst, mean = _match_multisets(_pairs(ours), _pairs(ref))
    assert worst <= MAX_DIFF and mean <= MEAN_DIFF, (worst, mean)
    paths, labels, mapping = t_images.list_images(str(tree / "validation"))
    assert (paths, labels, mapping) == r_images.list_images(str(tree / "validation"))
    np.testing.assert_array_equal(np.concatenate([b["label"] for b in ours]), labels)


@pytest.mark.parametrize("module", ["tfrecords", "images"])
def test_training_streams_are_seeded_epoch_permutations(shards, tree, module,
                                                        monkeypatch):
    def stream(seed, batch=4):
        if module == "tfrecords":
            return t_tfrecords.input_fn(shards, True, batch, image_size=SIZE,
                                        seed=seed, shuffle_buffer=6)
        return t_images.input_fn(str(tree / "train"), True, batch,
                                 image_size=SIZE, seed=seed)

    first = _collect(stream(7), 6)  # two epochs of 12 records
    with monkeypatch.context() as mp:
        mp.setattr(t_tfrecords if module == "tfrecords" else t_images,
                   "default_workers", lambda: 1)
        again = _collect(stream(7), 6)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
    labels = [b["label"].tolist() for b in first]
    epoch0, epoch1 = sum(labels[:3], []), sum(labels[3:], [])
    want = sorted([1, 2, 3] * PER_CLASS)
    assert sorted(epoch0) == sorted(epoch1) == want
    assert epoch0 != epoch1
    assert [b["label"].tolist() for b in _collect(stream(8), 3)] != labels[:3]
    # under repeat a batch crosses the epoch boundary: 12 records, batch 5
    crossing = sum((b["label"].tolist() for b in _collect(stream(7, 5), 5)), [])
    assert sorted(crossing[:12]) == want and sorted(crossing[12:24]) == want


def test_inception_stream_is_seeded_whatever_the_pool(shards, monkeypatch):
    kw = dict(image_size=SIZE, seed=2, augment="inception")

    def take(workers, **over):
        monkeypatch.setattr(t_tfrecords, "default_workers", lambda: workers)
        return _collect(t_tfrecords.input_fn(shards, True, 4, **{**kw, **over}), 3)

    a, b = take(1), take(6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["image"], y["image"])
    c = take(1, seed=3)
    assert any(not np.array_equal(x["image"], y["image"]) for x, y in zip(a, c))


@pytest.mark.parametrize("pipeline", ["tfrecords", "native", "images"])
def test_host_sharding_partitions_the_files(shards, tree, pipeline):
    halves = []
    for rank in range(2):
        kw = dict(image_size=SIZE, repeat=False, shard_count=2, shard_index=rank,
                  drop_remainder=False)
        if pipeline == "tfrecords":
            it = t_tfrecords.input_fn(shards, False, 2, **kw)
        elif pipeline == "native":
            it = t_native.native_input_fn(shards, False, 2, **kw)
        else:
            it = t_images.input_fn(str(tree / "validation"), False, 2, **kw)
        halves.append(np.concatenate([b["label"] for b in it]))
    assert len(halves[0]) == len(halves[1]) == N // 2
    assert sorted(np.concatenate(halves).tolist()) == sorted([1, 2, 3] * PER_CLASS)


def test_more_hosts_than_files(shards, tree):
    """A host with no files: a finite stream is empty, a repeating one
    raises instead of spinning on empty epochs (the native pipeline's
    contract)."""
    kw = dict(image_size=SIZE, shard_count=8, shard_index=5)
    assert list(t_tfrecords.input_fn(shards, False, 2, repeat=False, **kw)) == []
    assert list(t_native.native_input_fn(shards, False, 2, **kw)) == []
    with pytest.raises(ValueError, match="no files"):
        next(t_tfrecords.input_fn(shards, True, 2, **kw))
    with pytest.raises(ValueError, match="no files"):
        next(t_native.native_input_fn(shards, True, 2, **kw))
    kw = dict(image_size=SIZE, shard_count=2 * N, shard_index=N + 1)
    assert list(t_images.input_fn(str(tree / "train"), False, 2, repeat=False,
                                  **kw)) == []
    with pytest.raises(ValueError, match="no files"):
        next(t_images.input_fn(str(tree / "train"), True, 2, **kw))


def test_drop_remainder(shards):
    kw = dict(image_size=SIZE, repeat=False, shard_count=1, shard_index=0)
    assert [len(b["label"]) for b in t_tfrecords.input_fn(shards, False, 5, **kw)] == [5, 5]
    assert [len(b["label"]) for b in t_tfrecords.input_fn(
        shards, False, 5, drop_remainder=False, **kw)] == [5, 5, 2]


def test_mixed_shard_layouts_detect_largest(shards, tmp_path):
    from distributeddeeplearning_tpu.data.tfrecords import shard_filenames as ref

    import os

    d = tmp_path / "mixed"
    d.mkdir()
    for name in os.listdir(shards):
        shutil.copy(os.path.join(shards, name), d / name)
    for i in range(2):  # a stale 2-shard subsample beside the 4-shard set
        shutil.copy(d / f"validation-0000{i}-of-00004", d / f"validation-0000{i}-of-00002")
    names = t_tfrecords.shard_filenames(str(d), is_training=False)
    assert names == ref(str(d), is_training=False)
    assert len(names) == 4 and names[0].endswith("validation-00000-of-00004")
    (d / "validation-00003-of-00004").unlink()
    with pytest.raises(FileNotFoundError, match="1/4"):
        t_tfrecords.shard_filenames(str(d), is_training=False)


def test_remote_paths_refused():
    with pytest.raises(ValueError, match="local files only"):
        t_tfrecords.shard_filenames("gs://bucket/tfrecords", True)
    with pytest.raises(ValueError, match="local files only"):
        next(t_tfrecords.input_fn("gs://bucket/tfrecords", True, 2))
    with pytest.raises(ValueError, match="local files only"):
        next(t_native.native_input_fn("gs://bucket/tfrecords", False, 2,
                                      shard_count=1, shard_index=0))

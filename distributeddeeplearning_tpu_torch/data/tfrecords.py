"""Sharded TFRecord input pipeline without TensorFlow — the port of
``data/tfrecords.py``.

The reference's reader (``TensorFlow_imagenet/src/data/tfrecords.py:11-217``)
with the same shard geometry and arguments, on the port's own record
reader (``_native.RecordReader``, CRC-verified) and the TF-free recipe of
``preprocessing.py``:

- shard layout ``train-%05d-of-01014`` / ``validation-%05d-of-00128``, the
  count auto-detected from the files present (the largest wins), every
  expected shard existence-checked before training;
- per-host file sharding: ``files[shard_index::shard_count]`` (tf.data's
  ``shard``), the geometry defaulted from the process group
  (``parallel.distributed.process_count/process_index``);
- training shuffles the files, then the records through a
  ``SHUFFLE_BUFFER``-deep buffer (tf.data's ``shuffle``), both drawn from
  ``seed``, and reshuffles every epoch; eval reads file by file, record by
  record;
- ``repeat`` chains epochs before batching, as the reference's
  ``repeat()`` precedes ``batch``; ``drop_remainder`` drops a short last
  batch of a finite stream;
- decoding and preprocessing run on a host thread pool of
  ``default_workers()`` threads with at most ``PREFETCH_BATCHES`` batches
  in flight, results taken in order.

Departures: there is no ``tf.io.gfile``, so a ``gs://`` path raises
``ValueError``; and the reference's eval order interleaves shards with
``cycle_length=AUTOTUNE``, which depends on the host's core count, while
this reader's is file order.  The Example schema is the reference
converter's (``convert_imagenet_to_tf_records.py:111-146``):
``image/encoded`` (JPEG bytes), ``image/class/label`` (1-based, 1..1000,
background 0, so NUM_CLASSES 1001).
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from distributeddeeplearning_tpu_torch.data._native import (
    RecordReader,
    example_bytes,
    example_int64,
)
from distributeddeeplearning_tpu_torch.data.preprocessing import (
    DEFAULT_IMAGE_SIZE,
    preprocess_image,
)

DEFAULT_TRAIN_SHARDS = 1014  # convert_imagenet_to_tf_records.py:512
DEFAULT_VALIDATION_SHARDS = 128  # :513
SHUFFLE_BUFFER = 10000
PREFETCH_BATCHES = 4  # batches of decode work in flight on the pool
NUM_IMAGES = {"train": 1281167, "validation": 50000}  # defaults.py:13-15


def refuse_remote(data_dir: str) -> None:
    if data_dir.startswith("gs://"):
        raise ValueError(
            f"{data_dir}: the port reads local files only (it has no "
            "tf.io.gfile); copy the shards to a local disk first"
        )


def shard_filenames(
    data_dir: str,
    is_training: bool,
    num_shards: Optional[int] = None,
) -> list:
    """Expected shard paths; existence-checked like ``get_filenames``
    (``data/tfrecords.py:124-140``).

    ``num_shards=None`` first auto-detects the count from existing
    ``<prefix>-*-of-NNNNN`` files (non-standard layouts, e.g. subsampled
    datasets, keep working), falling back to the reference defaults
    (1014/128); the per-shard existence check still runs either way.  With
    mixed layouts in one directory the LARGEST count wins deterministically
    — a stale-but-larger set then fails the existence check loudly instead
    of silently training on a subsample.
    """
    refuse_remote(data_dir)
    prefix = "train" if is_training else "validation"
    if num_shards is None:
        num_shards = _max_shard_count(_glob_local(data_dir, prefix)) or (
            DEFAULT_TRAIN_SHARDS if is_training else DEFAULT_VALIDATION_SHARDS
        )
    names = [
        f"{data_dir.rstrip('/')}/{prefix}-{i:05d}-of-{num_shards:05d}"
        for i in range(num_shards)
    ]
    missing = [n for n in names if not os.path.exists(n)]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)}/{num_shards} expected TFRecord shards missing, "
            f"first: {missing[0]}"
        )
    return names


def _glob_local(data_dir: str, prefix: str) -> list:
    import glob as _glob

    return _glob.glob(f"{data_dir.rstrip('/')}/{prefix}-*")


def _max_shard_count(found) -> Optional[int]:
    """Largest ``-of-NNNNN`` suffix among the files — deterministic."""
    import re as _re

    counts = [
        int(m.group(1))
        for name in found
        if (m := _re.search(r"-of-(\d+)$", name))
    ]
    return max(counts) if counts else None


def host_shard(shard_count: Optional[int], shard_index: Optional[int]):
    """``(shard_count, shard_index)``, each defaulted from the process
    group: one host shard a process."""
    from distributeddeeplearning_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    return (process_count() if shard_count is None else shard_count,
            process_index() if shard_index is None else shard_index)


def shuffled(items: Iterable, size: int,
             rng: np.random.Generator) -> Iterator:
    """tf.data's ``shuffle(size)``: fill a buffer of ``size``, then emit a
    uniformly chosen element and put the next input in its place; drain
    the rest in random order."""
    buf = []
    for item in items:
        if len(buf) < size:
            buf.append(item)
            continue
        i = int(rng.integers(size))
        out, buf[i] = buf[i], item
        yield out
    while buf:
        i = int(rng.integers(len(buf)))
        buf[i], buf[-1] = buf[-1], buf[i]
        yield buf.pop()


def map_ordered(fn: Callable, items: Iterable, pool: ThreadPoolExecutor,
                window: int) -> Iterator:
    """``fn`` over ``items`` on ``pool``, at most ``window`` calls in
    flight, results in input order."""
    pending: deque = deque()
    it = iter(items)
    exhausted = False
    while True:
        while not exhausted and len(pending) < window:
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                break
            pending.append(pool.submit(fn, *item))
        if not pending:
            return
        yield pending.popleft().result()


def batched(examples: Iterable, batch_size: int,
            drop_remainder: bool) -> Iterator[Dict[str, np.ndarray]]:
    """``(image, label)`` pairs -> ``{"image", "label"}`` numpy batches."""
    images, labels = [], []
    for image, label in examples:
        images.append(image)
        labels.append(label)
        if len(images) == batch_size:
            yield {"image": np.stack(images),
                   "label": np.asarray(labels, np.int32)}
            images, labels = [], []
    if images and not drop_remainder:
        yield {"image": np.stack(images), "label": np.asarray(labels, np.int32)}


def default_workers() -> int:
    return min(32, os.cpu_count() or 4)


def parse_record(
    serialized: bytes, is_training: bool, image_size: int,
    augment: str = "reference", rng: Optional[np.random.Generator] = None,
):
    """Example bytes -> ``(image, label)``; schema parity with
    ``parse_record`` (``data/tfrecords.py:169-217``): a missing label
    reads as -1, as the reference's default."""
    jpeg = example_bytes(serialized, "image/encoded")
    if not jpeg:
        raise ValueError("record has no image/encoded bytes")
    label = example_int64(serialized, "image/class/label")
    image = preprocess_image(jpeg, is_training, image_size, augment=augment,
                             rng=rng)
    return image, np.int32(-1 if label is None else label)


def build_dataset(
    data_dir: str,
    is_training: bool,
    batch_size: int,
    *,
    image_size: int = DEFAULT_IMAGE_SIZE,
    num_shards: Optional[int] = None,
    shard_index: int = 0,
    shard_count: int = 1,
    shuffle_buffer: int = SHUFFLE_BUFFER,
    repeat: bool = True,
    seed: Optional[int] = None,
    drop_remainder: bool = True,
    augment: str = "reference",
) -> Iterator[Dict[str, np.ndarray]]:
    """The pipeline over the host's shard files: numpy batches
    ``{"image": float32 [b, s, s, 3], "label": int32 [b]}``.

    ``batch_size`` is the PER-HOST batch.  With ``augment="inception"``
    each record's crop and flip draw from a generator seeded, in stream
    order, from the pipeline's own, so a seeded stream does not depend on
    thread timing."""
    filenames = shard_filenames(data_dir, is_training, num_shards)
    files = filenames[shard_index::shard_count]
    if not files and repeat:  # an empty epoch repeated would never yield
        raise ValueError(
            f"host shard {shard_index}/{shard_count} has no files — only "
            f"{len(filenames)} shard file(s) exist in {data_dir}")
    rng = np.random.default_rng(seed)
    draws = is_training and augment == "inception"

    def records() -> Iterator:
        while True:
            order = ([files[i] for i in rng.permutation(len(files))]
                     if is_training else files)
            stream = (rec for path in order
                      for rec in RecordReader(path))
            if is_training and shuffle_buffer > 1:
                stream = shuffled(stream, shuffle_buffer, rng)
            for rec in stream:
                yield (rec, np.random.default_rng(int(rng.integers(2**63)))
                       if draws else None)
            if not repeat:
                return

    def one(rec: bytes, rec_rng):
        return parse_record(rec, is_training, image_size, augment, rec_rng)

    workers = default_workers()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        yield from batched(
            map_ordered(one, records(), pool,
                        max(batch_size * PREFETCH_BATCHES, workers)),
            batch_size, drop_remainder)


def input_fn(
    data_dir: str,
    is_training: bool,
    batch_size: int,
    **kwargs,
) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy-batch iterator for the training loop: ``{'image', 'label'}``
    dicts, this host's rows of the global batch.  The host shard geometry
    defaults from the process group, the port's
    ``dataset.shard(hvd.size(), hvd.rank())``."""
    kwargs["shard_count"], kwargs["shard_index"] = host_shard(
        kwargs.get("shard_count"), kwargs.get("shard_index"))
    yield from build_dataset(data_dir, is_training, batch_size, **kwargs)

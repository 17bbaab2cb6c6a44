"""Raw-image directory input pipeline (ImageFolder-style) without
TensorFlow — the port of ``data/images.py``.

``data_dir/<wnid>/*.{JPEG,jpg,png}`` with labels 1-based by sorted wnid
(background 0, NUM_CLASSES 1001), the same as the TFRecord converter's, so
raw-image and TFRecord training agree on classes.  Hosts shard by FILE
(``paths[shard_index::shard_count]``, the ``DistributedSampler``
contract); training shuffles through a buffer of ``min(len, shuffle_buffer)``
(tf.data's ``shuffle``, reshuffled each epoch, from ``seed``); ``repeat``
chains epochs before batching.  Reading, decoding and the recipe of
``preprocessing.py`` run on the host thread pool of ``tfrecords.py``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from distributeddeeplearning_tpu_torch.data.preprocessing import (
    DEFAULT_IMAGE_SIZE,
    preprocess_image,
)
from distributeddeeplearning_tpu_torch.data.tfrecords import (
    PREFETCH_BATCHES,
    batched,
    default_workers,
    host_shard,
    map_ordered,
    shuffled,
)


def list_images(data_dir: str) -> Tuple[List[str], List[int], Dict[str, int]]:
    """Walk ``data_dir/<wnid>/*`` → (paths, 1-based labels, wnid→label)."""
    wnids = sorted(d.name for d in Path(data_dir).iterdir() if d.is_dir())
    wnid_to_label = {w: i + 1 for i, w in enumerate(wnids)}
    paths: List[str] = []
    labels: List[int] = []
    for wnid in wnids:
        for img in sorted(Path(data_dir, wnid).glob("*")):
            if img.suffix.lower() in (".jpeg", ".jpg", ".png"):
                paths.append(str(img))
                labels.append(wnid_to_label[wnid])
    return paths, labels, wnid_to_label


def build_dataset(
    data_dir: str,
    is_training: bool,
    batch_size: int,
    *,
    image_size: int = DEFAULT_IMAGE_SIZE,
    shard_index: int = 0,
    shard_count: int = 1,
    shuffle_buffer: int = 10000,
    repeat: bool = True,
    seed: Optional[int] = None,
    drop_remainder: bool = True,
    augment: str = "reference",
) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy batches over this host's image files."""
    paths, labels, _ = list_images(data_dir)
    if not paths:
        raise FileNotFoundError(f"no class-dir images under {data_dir}")
    rows = list(zip(paths, labels))[shard_index::shard_count]
    if not rows and repeat:  # an empty epoch repeated would never yield
        raise ValueError(
            f"host shard {shard_index}/{shard_count} has no files — only "
            f"{len(paths)} image(s) under {data_dir}")
    rng = np.random.default_rng(seed)
    draws = is_training and augment == "inception"

    def items() -> Iterator:
        while True:
            stream = (shuffled(rows, min(len(rows), shuffle_buffer), rng)
                      if is_training else rows)
            for path, label in stream:
                yield (path, label,
                       np.random.default_rng(int(rng.integers(2**63)))
                       if draws else None)
            if not repeat:
                return

    def load(path: str, label: int, rec_rng):
        with open(path, "rb") as f:
            raw = f.read()
        return (preprocess_image(raw, is_training, image_size, augment=augment,
                                 rng=rec_rng), np.int32(label))

    workers = default_workers()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        yield from batched(
            map_ordered(load, items(), pool,
                        max(batch_size * PREFETCH_BATCHES, workers)),
            batch_size, drop_remainder)


def input_fn(
    data_dir: str,
    is_training: bool,
    batch_size: int,
    **kwargs,
) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy-batch iterator, host-shard geometry defaulted from the
    process group."""
    kwargs["shard_count"], kwargs["shard_index"] = host_shard(
        kwargs.get("shard_count"), kwargs.get("shard_index"))
    yield from build_dataset(data_dir, is_training, batch_size, **kwargs)

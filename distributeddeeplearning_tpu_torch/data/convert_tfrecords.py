"""ImageNet directory tree → sharded TFRecords, without TensorFlow — the
port of ``data/convert_tfrecords.py``.

Role parity with ``scripts/convert_imagenet_to_tf_records.py:84-533`` (14):
deterministic seed-42 shuffle, 1014 train / 128 validation shards, per-image
cleanup of non-JPEG/CMYK files, and the same Example schema — so records
written here feed the reference's reader and vice versa.

Implementation is re-designed, not translated: the reference runs 2 Python
threads each owning a TF session whose graph re-encodes images
(``ImageCoder``, ``:149-234``); here cleanup is PIL-based pure Python and
sharding fans out over a thread pool sized to the host.  Records are
encoded by ``proto.encode_example`` and framed by ``proto.RecordWriter``
(the JAX package's converter goes through ``tf.train.Example`` and
``tf.io.TFRecordWriter``; the records parse the same).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import random
from io import BytesIO
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from distributeddeeplearning_tpu_torch.data.proto import RecordWriter, encode_example

logger = logging.getLogger("ddlt.data.convert")

TRAIN_SHARDS = 1014
VALIDATION_SHARDS = 128
SHUFFLE_SEED = 42  # convert_imagenet_to_tf_records.py:479


def find_image_files(
    data_dir: str,
) -> Tuple[List[str], List[int], List[str], Dict[str, int]]:
    """Walk ``data_dir/<wnid>/*.JPEG``; labels are 1-based by sorted wnid
    (label 0 = background, the NUM_CLASSES=1001 convention).

    Deterministic shuffle with seed 42 — parity with ``_find_image_files``
    (``convert_imagenet_to_tf_records.py:461-505``).
    """
    wnids = sorted(
        d.name for d in Path(data_dir).iterdir() if d.is_dir()
    )
    wnid_to_label = {wnid: i + 1 for i, wnid in enumerate(wnids)}
    filenames: List[str] = []
    labels: List[int] = []
    synsets: List[str] = []
    for wnid in wnids:
        for img in sorted(Path(data_dir, wnid).glob("*")):
            if img.suffix.lower() in (".jpeg", ".jpg", ".png"):
                filenames.append(str(img))
                labels.append(wnid_to_label[wnid])
                synsets.append(wnid)
    order = list(range(len(filenames)))
    random.Random(SHUFFLE_SEED).shuffle(order)
    return (
        [filenames[i] for i in order],
        [labels[i] for i in order],
        [synsets[i] for i in order],
        wnid_to_label,
    )


def clean_image_bytes(raw: bytes) -> Tuple[bytes, int, int]:
    """Ensure RGB JPEG bytes; returns (jpeg_bytes, height, width).

    Covers the reference ``ImageCoder`` cases (``:149-234``): PNG→JPEG
    re-encode, CMYK→RGB conversion — via PIL instead of a TF session.
    """
    from PIL import Image

    img = Image.open(BytesIO(raw))
    if img.format == "JPEG" and img.mode == "RGB":
        return raw, img.height, img.width
    rgb = img.convert("RGB")
    out = BytesIO()
    rgb.save(out, format="JPEG", quality=95)
    return out.getvalue(), rgb.height, rgb.width


def make_example(
    jpeg_bytes: bytes, label: int, synset: str, filename: str, height: int, width: int
) -> bytes:
    """Serialized Example, schema parity with ``_convert_to_example``
    (``convert_imagenet_to_tf_records.py:111-146``)."""
    return encode_example(
        {
            "image/height": height,
            "image/width": width,
            "image/colorspace": "RGB",
            "image/channels": 3,
            "image/class/label": label,
            "image/class/synset": synset,
            "image/format": "JPEG",
            "image/filename": os.path.basename(filename),
            "image/encoded": jpeg_bytes,
        }
    )


def _write_shard(
    shard_path: str,
    files: Sequence[str],
    labels: Sequence[int],
    synsets: Sequence[str],
) -> int:
    written = 0
    with RecordWriter(shard_path) as writer:
        for fname, label, synset in zip(files, labels, synsets):
            with open(fname, "rb") as f:
                raw = f.read()
            try:
                jpeg, h, w = clean_image_bytes(raw)
            except Exception as exc:
                logger.warning("skipping unreadable image %s: %s", fname, exc)
                continue
            writer.write(make_example(jpeg, label, synset, fname, h, w))
            written += 1
    return written


def convert_dataset(
    data_dir: str,
    output_dir: str,
    name: str,
    num_shards: int,
    *,
    max_workers: Optional[int] = None,
) -> int:
    """Convert one split directory into ``{name}-%05d-of-%05d`` shards."""
    filenames, labels, synsets, _ = find_image_files(data_dir)
    if not filenames:
        raise FileNotFoundError(f"no images under {data_dir}")
    os.makedirs(output_dir, exist_ok=True)
    ranges = [
        (i * len(filenames) // num_shards, (i + 1) * len(filenames) // num_shards)
        for i in range(num_shards)
    ]
    total = 0
    with concurrent.futures.ThreadPoolExecutor(
        max_workers=max_workers or min(32, (os.cpu_count() or 4))
    ) as pool:
        futures = {
            pool.submit(
                _write_shard,
                os.path.join(output_dir, f"{name}-{i:05d}-of-{num_shards:05d}"),
                filenames[lo:hi],
                labels[lo:hi],
                synsets[lo:hi],
            ): i
            for i, (lo, hi) in enumerate(ranges)
        }
        for fut in concurrent.futures.as_completed(futures):
            total += fut.result()
    logger.info("%s: wrote %d records in %d shards", name, total, num_shards)
    return total


def convert_imagenet(
    image_dir: str,
    output_dir: str,
    *,
    train_shards: int = TRAIN_SHARDS,
    validation_shards: int = VALIDATION_SHARDS,
) -> Dict[str, int]:
    """Full conversion: ``{image_dir}/{train,validation}`` →
    ``{output_dir}/tfrecords`` (main parity, ``:507-529``)."""
    counts = {}
    counts["validation"] = convert_dataset(
        os.path.join(image_dir, "validation"), output_dir, "validation",
        validation_shards,
    )
    counts["train"] = convert_dataset(
        os.path.join(image_dir, "train"), output_dir, "train", train_shards
    )
    return counts

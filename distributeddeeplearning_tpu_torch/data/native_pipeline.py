"""TF-free TFRecord input pipeline on the native reader — the port of
``data/native_pipeline.py``, batch for batch and bit for bit the
reference's on the same shards (the same decoders, the same
``random.Random(seed)`` calls in the same order).

As in the reference, it needs no TensorFlow: the framework's own C record reader (``data/csrc/ddlt_records.c`` via
``data/_native.py``) streams and CRC-verifies the frames, the minimal
wire-format walker extracts ``image/encoded``/``image/class/label`` (same
schema as the reference converter, ``convert_imagenet_to_tf_records.py:111-146``),
the in-repo C decoder (``data/csrc/ddlt_image.c`` — libjpeg +
Pillow-equivalent bilinear resample) decodes JPEGs on a thread pool with
PIL covering what it declines (CMYK scans, corrupt streams, no compiler),
and numpy applies the reference preprocessing recipe
(``imagenet_preprocessing.py:180-222``):

- train: decode → plain bilinear resize (squash, no crop/flip);
- eval: aspect-preserving central crop (224/256 of the short side) →
  bilinear resize;
- both: channel-mean subtraction, NHWC float32.

Semantics mirror ``tfrecords.input_fn``: per-host file sharding defaulted
from the process group, deterministic eval order, drop_remainder on the
training path.  Where the C decoder cannot build (a host without
libjpeg's headers) every image goes through PIL, the reference's own
fallback.
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from distributeddeeplearning_tpu_torch.data._native import (
    RecordReader,
    example_bytes,
    example_int64,
)
from distributeddeeplearning_tpu_torch.data.preprocessing import (
    CHANNEL_MEANS,
    DEFAULT_IMAGE_SIZE,
    RESIZE_MIN,
)
from distributeddeeplearning_tpu_torch.data.tfrecords import (
    PREFETCH_BATCHES,
    batched,
    host_shard,
    map_ordered,
    refuse_remote,
    shard_filenames,
)


#: images decoded by the C decoder and by PIL since import (or reset)
decoded = {"c": 0, "pil": 0}
_count_lock = threading.Lock()


def _count(which: str) -> None:
    with _count_lock:
        decoded[which] += 1


def _decode_train(jpeg: bytes, image_size: int) -> np.ndarray:
    """Reference train path: decode + bilinear squash-resize.

    Hot path is the in-repo C decoder (libjpeg + Pillow-equivalent
    triangle-filter resample, ``csrc/ddlt_image.c``); PIL covers what it
    declines (CMYK scans, corrupt streams, no compiler)."""
    from distributeddeeplearning_tpu_torch.data._native_image import decode_resize

    out = decode_resize(jpeg, image_size)
    if out is not None:
        _count("c")
        return out
    _count("pil")
    from PIL import Image
    import io

    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32)


def _decode_eval(jpeg: bytes, image_size: int) -> np.ndarray:
    """Eval path: central crop of image_size/RESIZE_MIN of the short side,
    then bilinear resize — ``decode_and_center_crop`` parity."""
    from distributeddeeplearning_tpu_torch.data._native_image import decode_resize

    out = decode_resize(jpeg, image_size, crop_frac=image_size / RESIZE_MIN)
    if out is not None:
        _count("c")
        return out
    _count("pil")
    from PIL import Image
    import io

    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    w, h = img.size
    crop = int(min(h, w) * (image_size / RESIZE_MIN))
    x = (w - crop) // 2
    y = (h - crop) // 2
    img = img.crop((x, y, x + crop, y + crop))
    img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32)


def _records(files, *, verify: bool) -> Iterator[bytes]:
    for path in files:
        yield from RecordReader(path, verify=verify)


def _shuffled_records(
    files, rng: random.Random, buffer_size: int, *, verify: bool
) -> Iterator[bytes]:
    """Reservoir-style record shuffle: the tfrecords pipeline's
    ``ds.shuffle(SHUFFLE_BUFFER)`` role — file order alone repeats each
    shard's internal order every epoch."""
    buf = []
    for rec in _records(files, verify=verify):
        if len(buf) < buffer_size:
            buf.append(rec)
            continue
        idx = rng.randrange(buffer_size)
        out, buf[idx] = buf[idx], rec
        yield out
    rng.shuffle(buf)
    yield from buf


def native_input_fn(
    data_dir: str,
    is_training: bool,
    batch_size: int,
    *,
    image_size: int = DEFAULT_IMAGE_SIZE,
    num_shards: Optional[int] = None,
    shard_count: Optional[int] = None,
    shard_index: Optional[int] = None,
    repeat: Optional[bool] = None,
    drop_remainder: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    shuffle_buffer: int = 10000,
    verify_crc: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy-batch iterator ``{"image", "label"}`` — TF-free.

    Defaults the host shard geometry from the process group exactly like
    ``tfrecords.input_fn``; files round-robin to hosts by position
    (``files[shard_index::shard_count]``).  Training shuffles both file
    order and records (``shuffle_buffer``, the tf pipeline's 10k default).
    """
    refuse_remote(data_dir)
    shard_count, shard_index = host_shard(shard_count, shard_index)
    if repeat is None:
        repeat = is_training

    all_files = shard_filenames(data_dir, is_training, num_shards)
    files = all_files[shard_index::shard_count]
    if not files:
        # More hosts than shard files (e.g. 128 eval shards on a larger pod).
        if repeat:
            # With repeat=True this would busy-loop yielding nothing forever.
            # Fail loudly, matching shard_filenames' philosophy.
            raise ValueError(
                f"host shard {shard_index}/{shard_count} has no files — only "
                f"{len(all_files)} shard file(s) exist in {data_dir}; "
                "shard_count must not exceed the number of shard files"
            )
        # One-pass (eval) callers yield nothing: Trainer.evaluate's min-count
        # handshake resolves a zero-batch host gracefully, whereas raising
        # mid-drain would strand the other hosts at the allgather.
        return
    decode = _decode_train if is_training else _decode_eval
    means = np.asarray(CHANNEL_MEANS, np.float32)
    rng = random.Random(seed)

    def one(record: bytes):
        jpeg = example_bytes(record, "image/encoded")
        label = example_int64(record, "image/class/label")
        if jpeg is None or label is None:
            raise ValueError("record missing image/encoded or image/class/label")
        return decode(jpeg, image_size) - means, np.int32(label)

    window = max(batch_size * PREFETCH_BATCHES, num_workers)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        while True:
            order = list(files)
            if is_training:
                rng.shuffle(order)
            if is_training and shuffle_buffer > 1:
                record_iter = _shuffled_records(
                    order, rng, shuffle_buffer, verify=verify_crc
                )
            else:
                record_iter = _records(order, verify=verify_crc)
            yield from batched(
                map_ordered(one, ((rec,) for rec in record_iter), pool, window),
                batch_size,
                drop_remainder,
            )
            if not repeat:
                return

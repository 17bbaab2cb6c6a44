"""Decode-once raw-pixel cache: the input path for decode-bound hosts — the
port of ``data/raw_cache.py``; the files, the streams and the permutations
are the reference's byte for byte.

Keeping an accelerator fed from host-side JPEG decode is the hard part of
the input path: a host whose cores decode fewer images a second than the
device steps through cannot be rescued by prefetch depth.  The answer is
to stop re-decoding: ImageNet's reference preprocessing is
DETERMINISTIC per image on both paths (train: bilinear squash-resize; eval:
central crop + resize — ``imagenet_preprocessing.py:180-222``, no random
crop/flip), so the decoded tensor can be computed once and memory-mapped
forever after — the FFCV/DALI-cache idea, built on the framework's own C
reader + C JPEG decoder.

Format (one directory per split):
    manifest.json   count / image_size / split flavor / source geometry
    images.u8       [count, size, size, 3] uint8, C-order, raw pixels
                    (PRE mean-subtraction — normalization moves on-device,
                    ``uint8_normalizer`` below, so a batch crosses PCIe
                    at a quarter of the float32 bytes)
    labels.i32      [count] little-endian int32

uint8 quantization is the only deviation from the float pipelines (<=0.5/255
per channel, before mean subtraction); training impact is nil and the parity
test pins the bound.  Shuffling is a true per-epoch permutation — stronger
than the 10k-record reservoir the streaming pipelines can afford.

Scale note: 150KB/image means full ImageNet-train is ~193GB — fine for a
host's local SSD, and on multi-host runs each host passes its
``shard_count/shard_index`` to ``build_raw_cache`` so it only caches (and
serves) its own row slice.

Random augmentation (``augment='inception'``) cannot be cached by
construction; the builder refuses it — use the streaming pipelines there.
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from distributeddeeplearning_tpu_torch.data.preprocessing import (
    CHANNEL_MEANS,
    DEFAULT_IMAGE_SIZE,
)
from distributeddeeplearning_tpu_torch.data.tfrecords import host_shard

logger = logging.getLogger("ddlt.data.raw_cache")

MANIFEST = "manifest.json"
IMAGES = "images.u8"
LABELS = "labels.i32"
_VERSION = 1


def cache_path_for(
    data_dir: str,
    is_training: bool,
    image_size: int,
    *,
    shard_count: int = 1,
    shard_index: int = 0,
) -> str:
    """Default cache location next to the shard set.

    With ``shard_count > 1`` (multi-host: each host caches only its
    shard-file slice) the directory name carries the host's slice — on
    shared storage (NFS / GCS-fuse) all hosts would otherwise build
    DIFFERENT slices into the SAME images.u8/manifest path and clobber
    each other.
    """
    split = "train" if is_training else "validation"
    suffix = (
        f"-shard{shard_index}of{shard_count}" if shard_count > 1 else ""
    )
    return os.path.join(data_dir, f"raw-cache-{split}-{image_size}{suffix}")


def _load_manifest(cache_dir: str) -> Optional[dict]:
    path = os.path.join(cache_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def build_raw_cache(
    data_dir: str,
    cache_dir: str,
    is_training: bool,
    *,
    image_size: int = DEFAULT_IMAGE_SIZE,
    num_shards: Optional[int] = None,
    shard_count: int = 1,
    shard_index: int = 0,
    augment: str = "reference",
    num_workers: int = 8,
    verify_crc: bool = True,
) -> dict:
    """Decode TFRecord shards once into the raw cache; returns the manifest.

    Idempotent: an existing cache whose manifest matches (source geometry,
    image size, split flavor) is reused.  Decode identical to
    ``native_pipeline``'s deterministic paths (C decoder, PIL fallback):
    train = bilinear squash-resize, eval = 224/256 central crop + resize.
    """
    if augment != "reference":
        raise ValueError(
            "raw cache stores deterministically-preprocessed pixels; "
            f"augment={augment!r} is random per epoch and cannot be cached "
            "— use input_pipeline='tf' for inception augmentation"
        )
    from distributeddeeplearning_tpu_torch.data._native import (
        RecordReader,
        example_bytes,
        example_int64,
    )
    from distributeddeeplearning_tpu_torch.data.native_pipeline import (
        _decode_eval,
        _decode_train,
    )
    from distributeddeeplearning_tpu_torch.data.tfrecords import shard_filenames

    want = {
        "version": _VERSION,
        "image_size": image_size,
        "split": "train" if is_training else "validation",
        "source": os.path.abspath(data_dir),
        "shard_count": shard_count,
        "shard_index": shard_index,
    }
    have = _load_manifest(cache_dir)
    if have is not None and {k: have.get(k) for k in want} == want:
        logger.info("raw cache up to date: %s (%d images)", cache_dir, have["count"])
        return have

    files = shard_filenames(data_dir, is_training, num_shards)[
        shard_index::shard_count
    ]
    if not files:
        raise ValueError(
            f"host shard {shard_index}/{shard_count} has no shard files"
        )
    os.makedirs(cache_dir, exist_ok=True)
    decode = _decode_train if is_training else _decode_eval

    def one(record: bytes) -> tuple:
        jpeg = example_bytes(record, "image/encoded")
        label = example_int64(record, "image/class/label")
        if jpeg is None or label is None:
            raise ValueError("record missing image/encoded or image/class/label")
        # +0.5 round-to-nearest: the decoders return float32 in [0, 255].
        img = np.clip(decode(jpeg, image_size) + 0.5, 0, 255).astype(np.uint8)
        return img, np.int32(label)

    count = 0
    labels = []
    img_path = os.path.join(cache_dir, IMAGES)
    with open(img_path, "wb") as img_f, ThreadPoolExecutor(num_workers) as pool:
        for path in files:
            records = list(RecordReader(path, verify=verify_crc))
            for img, label in pool.map(one, records):
                img_f.write(img.tobytes())
                labels.append(label)
                count += 1
            logger.info("cached %s (%d images so far)", os.path.basename(path), count)
    np.asarray(labels, "<i4").tofile(os.path.join(cache_dir, LABELS))
    want["count"] = count
    want["bytes"] = count * image_size * image_size * 3
    with open(os.path.join(cache_dir, MANIFEST), "w") as f:
        json.dump(want, f, indent=1)
    logger.info("raw cache built: %s (%d images, %.1f GB)", cache_dir, count,
                want["bytes"] / 1e9)
    return want


def open_raw_cache(cache_dir: str):
    """(manifest, images memmap [N,S,S,3] u8, labels [N] i32)."""
    manifest = _load_manifest(cache_dir)
    if manifest is None:
        raise FileNotFoundError(
            f"no raw cache at {cache_dir} (missing {MANIFEST}) — build one "
            "with build_raw_cache()"
        )
    size = manifest["image_size"]
    img_path = os.path.join(cache_dir, IMAGES)
    lbl_path = os.path.join(cache_dir, LABELS)
    want_img = manifest["count"] * size * size * 3
    want_lbl = manifest["count"] * 4
    if os.path.getsize(img_path) != want_img or os.path.getsize(lbl_path) != want_lbl:
        raise ValueError(
            f"corrupt raw cache {cache_dir}: images/labels file sizes "
            f"({os.path.getsize(img_path)}, {os.path.getsize(lbl_path)}) do "
            f"not match manifest count {manifest['count']} — rebuild with "
            "build_raw_cache()"
        )
    images = np.memmap(
        img_path, dtype=np.uint8, mode="r",
        shape=(manifest["count"], size, size, 3),
    )
    labels = np.fromfile(lbl_path, dtype="<i4")
    return manifest, images, labels


def raw_cache_input_fn(
    cache_dir: str,
    is_training: bool,
    batch_size: int,
    *,
    shard_count: Optional[int] = None,
    shard_index: Optional[int] = None,
    repeat: Optional[bool] = None,
    drop_remainder: bool = True,
    seed: int = 0,
    start_batch: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy-batch iterator ``{"image": uint8, "label": int32}``.

    ``start_batch`` fast-forwards the (repeating) training stream to batch
    index N at pure index-math cost — no decode, no data read — which is
    what makes the Trainer's step-indexed resume factory replay-free on
    this pipeline: ``lambda s: raw_cache_input_fn(..., start_batch=s)``.

    Same interface family as ``tfrecords.input_fn`` / ``native_input_fn``,
    but yields RAW uint8 pixels — pair with ``uint8_normalizer()`` as the
    train/eval step's ``input_transform`` so normalization runs on the card.

    Host sharding: when the cache holds the full dataset
    (``manifest.shard_count == 1``) rows round-robin to hosts
    (``rows[shard_index::shard_count]``); when each host built its own
    slice the manifest geometry must match and rows are served as-is.
    """
    manifest, images, labels = open_raw_cache(cache_dir)
    shard_count, shard_index = host_shard(shard_count, shard_index)
    if repeat is None:
        repeat = is_training

    if manifest.get("shard_count", 1) > 1:
        if (manifest["shard_count"], manifest["shard_index"]) != (
            shard_count,
            shard_index,
        ):
            raise ValueError(
                f"cache {cache_dir} was built for host shard "
                f"{manifest['shard_index']}/{manifest['shard_count']}, "
                f"requested {shard_index}/{shard_count}"
            )
        rows = np.arange(manifest["count"])
    else:
        rows = np.arange(shard_index, manifest["count"], shard_count)
    if len(rows) == 0:
        if repeat:
            raise ValueError(
                f"host shard {shard_index}/{shard_count} has no rows — the "
                f"cache holds only {manifest['count']} image(s)"
            )
        return

    epoch = 0
    skip_batches = 0
    if start_batch:
        if not (is_training and repeat):
            raise ValueError(
                "start_batch fast-forward applies to the repeating training "
                "stream only"
            )
        per_epoch = len(rows) // batch_size if drop_remainder else -(
            -len(rows) // batch_size
        )
        if per_epoch == 0:
            raise ValueError(
                f"batch_size {batch_size} exceeds the host's {len(rows)} rows"
            )
        epoch = start_batch // per_epoch
        skip_batches = start_batch % per_epoch
    while True:
        if is_training:
            order = rows[np.random.default_rng((seed, epoch)).permutation(len(rows))]
        else:
            order = rows
        start_lo = skip_batches * batch_size
        skip_batches = 0
        for lo in range(start_lo, len(order), batch_size):
            idx = order[lo : lo + batch_size]
            if len(idx) < batch_size and drop_remainder:
                break
            # Sorted gather: memmap fancy-indexing reads row-by-row; monotone
            # offsets keep the reads sequential-ish on a cold page cache.
            sort = np.argsort(idx, kind="stable")
            unsort = np.empty_like(sort)
            unsort[sort] = np.arange(len(sort))
            yield {
                "image": images[idx[sort]][unsort],
                "label": labels[idx].astype(np.int32),
            }
        if not repeat:
            return
        epoch += 1


def uint8_normalizer(mean_rgb=CHANNEL_MEANS, device=None):
    """On-device normalization for raw uint8 batches: cast + channel-mean
    subtraction, the host-side step the cache deliberately skips
    (``preprocessing.py``'s mean subtraction).  Pass as ``input_transform``
    to ``build_train_step``/``build_eval_step``.  The transform takes a
    uint8 array or tensor and returns float32 ``x - mean_rgb``; with
    ``device`` it first moves the uint8 batch there (the Trainer's
    prefetch has already staged train batches; eval batches arrive as
    numpy), so the float32 batch is made on the card."""
    import torch

    means = torch.tensor(mean_rgb, dtype=torch.float32)
    cached = {}

    def transform(x):
        x = torch.as_tensor(x)
        if device is not None:
            x = x.to(device, non_blocking=True)
        m = cached.get(x.device)
        if m is None:
            m = cached[x.device] = means.to(x.device)
        return x.to(torch.float32) - m

    return transform

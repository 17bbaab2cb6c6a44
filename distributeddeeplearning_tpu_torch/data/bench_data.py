"""Deterministic synthetic-JPEG TFRecord shard sets for input-pipeline
benchmarks — the port of ``data/bench_data.py``; the same seed gives the
reference's shards byte for byte.

The reference benchmarks its input path on real ImageNet shards
(``TensorFlow_imagenet/src/data/tfrecords.py:100-166`` feeding
``resnet_main.py:282-291``); where no ImageNet is at hand the data-fed
runs measure the same pipelines over a generated stand-in: JPEGs at realistic ImageNet resolutions and file sizes,
written into shards with the reference converter's exact schema
(``convert_imagenet_to_tf_records.py:111-146``, via ``data/proto.py`` — no
TF needed to generate).

What makes the stand-in honest for *throughput*:
- resolutions sampled from typical ILSVRC dims (short side 333-500px), so
  per-image decode cost matches real data, not thumbnails;
- images are smooth random fields (low-res noise bilinearly upsampled +
  mild texture), because pure uniform noise defeats JPEG entropy coding and
  produces 3-4x oversized files that overstate decode cost; smooth fields
  land near real ImageNet's ~100-150KB at quality 90;
- generation is seeded: the same (seed, count) always produces byte-identical
  shards, so benchmark runs are comparable across rounds.
"""

from __future__ import annotations

import json
import logging
import os
from io import BytesIO
from typing import Optional

import numpy as np

logger = logging.getLogger("ddlt.data.bench_data")

# (height, width) pool — common ILSVRC-2012 camera dims.
_DIMS = [(375, 500), (333, 500), (500, 375), (480, 640), (400, 500), (500, 400)]
MANIFEST = "bench-manifest.json"


def _synthetic_jpeg(rng: np.random.Generator, quality: int = 90) -> bytes:
    """One realistic-size JPEG: smooth random field + mild noise."""
    from PIL import Image

    h, w = _DIMS[int(rng.integers(len(_DIMS)))]
    base = rng.integers(0, 256, size=(h // 20, w // 20, 3), dtype=np.uint8)
    img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
    arr = np.asarray(img, np.int16)
    arr += rng.integers(-12, 13, size=arr.shape, dtype=np.int16)
    img = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    out = BytesIO()
    img.save(out, format="JPEG", quality=quality)
    return out.getvalue()


def generate_bench_shards(
    out_dir: str,
    *,
    num_images: int = 4096,
    num_shards: int = 8,
    num_classes: int = 1000,
    seed: int = 0,
    split: str = "train",
) -> dict:
    """Write ``{split}-%05d-of-%05d`` shards of synthetic JPEGs.

    Idempotent: if a manifest with the same parameters already exists the
    generation is skipped (the shard set is deterministic), so a harness
    can call this unconditionally.  Returns the manifest dict.
    """
    os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, MANIFEST)
    want = {
        "num_images": num_images,
        "num_shards": num_shards,
        "num_classes": num_classes,
        "seed": seed,
        "split": split,
        "version": 1,
    }
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            have = json.load(f)
        if {k: have.get(k) for k in want} == want:
            logger.info("bench shards up to date in %s", out_dir)
            return have
    from distributeddeeplearning_tpu_torch.data.proto import RecordWriter, encode_example

    rng = np.random.default_rng(seed)
    per_shard = [
        (i * num_images // num_shards, (i + 1) * num_images // num_shards)
        for i in range(num_shards)
    ]
    total_bytes = 0
    for i, (lo, hi) in enumerate(per_shard):
        path = os.path.join(out_dir, f"{split}-{i:05d}-of-{num_shards:05d}")
        with RecordWriter(path) as w:
            for j in range(lo, hi):
                jpeg = _synthetic_jpeg(rng)
                total_bytes += len(jpeg)
                # 1-based labels, 0 = background (NUM_CLASSES=1001 convention).
                label = 1 + j % num_classes
                w.write(
                    encode_example(
                        {
                            "image/class/label": label,
                            "image/class/synset": f"n{label:08d}",
                            "image/format": "JPEG",
                            "image/filename": f"bench_{j:08d}.JPEG",
                            "image/colorspace": "RGB",
                            "image/channels": 3,
                            "image/encoded": jpeg,
                        }
                    )
                )
        logger.info("wrote %s (%d images)", path, hi - lo)
    want["mean_jpeg_bytes"] = int(total_bytes / max(num_images, 1))
    with open(manifest_path, "w") as f:
        json.dump(want, f, indent=1)
    return want


def ensure_bench_shards(
    data_dir: Optional[str], *, num_images: int = 4096, num_shards: int = 8
) -> str:
    """Default location (the port's git-ignored ``_build/bench-shards``) +
    generation for the data-fed benchmark.

    An operator-supplied ``data_dir`` that already holds TFRecord shards but
    NO bench manifest is a real dataset: use it as-is — generating synthetic
    shards into it would pollute (and partially overwrite) real data.
    """
    import glob as _glob

    if data_dir is None:
        from distributeddeeplearning_tpu_torch.data._native_build import BUILD_DIR

        data_dir = str(BUILD_DIR / "bench-shards")
    has_manifest = os.path.exists(os.path.join(data_dir, MANIFEST))
    has_shards = bool(_glob.glob(os.path.join(data_dir, "train-*")))
    if has_shards and not has_manifest:
        logger.info("using existing shard set in %s (no generation)", data_dir)
        return data_dir
    generate_bench_shards(
        data_dir, num_images=num_images, num_shards=num_shards
    )
    return data_dir

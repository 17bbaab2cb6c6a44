"""ILSVRC2012 tar preparation: checksum, extraction, validation re-org —
the port of ``data/prepare_imagenet.py``.

Parity with ``scripts/prepare_imagenet.py:18-88`` (13): SHA1-verify the two
official tars, extract the train tar's nested per-class tars into
``train/<wnid>/``, and reorganize the flat validation images into
``validation/<wnid>/`` class directories using a filename→wnid map.

The reference ships a 50k-row CSV (``scripts/imagenet_val_maps.csv``); we
accept the same CSV format (``filename,wnid`` per row, header optional) via
``val_map_path`` — the data file itself belongs to the dataset distribution,
not the framework.
"""

from __future__ import annotations

import csv
import hashlib
import logging
import os
import tarfile
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger("ddlt.data.prepare")

# Official ILSVRC2012 tar SHA1s — prepare_imagenet.py:12-15.
TRAIN_TAR_SHA1 = "43eda4fe35c1705d6606a6a7a633bc965d194284"
VAL_TAR_SHA1 = "5f3f73da3395154b60528b2b2a2caf2374f5f178"

_CHUNK = 1024 * 1024


def sha1_of(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def verify_checksum(path: str, expected: str) -> None:
    """Guardrail parity with ``_check_sha1`` (``prepare_imagenet.py:26-35``)."""
    actual = sha1_of(path)
    if actual != expected:
        raise ValueError(
            f"checksum mismatch for {path}: expected {expected}, got {actual}"
        )
    logger.info("checksum OK: %s", path)


def extract_train(train_tar: str, target_dir: str) -> int:
    """Nested-tar extraction (``_extract_train``, ``prepare_imagenet.py:38-55``):
    the train tar contains one tar per class; each unpacks into
    ``train/<wnid>/``. Returns the class count."""
    train_dir = Path(target_dir) / "train"
    train_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    with tarfile.open(train_tar) as outer:
        for member in outer:
            if not member.name.endswith(".tar"):
                continue
            wnid = Path(member.name).stem
            class_dir = train_dir / wnid
            class_dir.mkdir(exist_ok=True)
            inner_f = outer.extractfile(member)
            with tarfile.open(fileobj=inner_f) as inner:
                inner.extractall(class_dir, filter="data")
            count += 1
            if count % 100 == 0:
                logger.info("extracted %d classes", count)
    return count


def load_val_map(val_map_path: str) -> Dict[str, str]:
    """filename → wnid from the CSV map.

    Accepts BOTH column orders: the reference's ``class,filename``
    (``{{proj}}/scripts/imagenet_val_maps.csv`` — wnid first) and the
    transposed ``filename,wnid`` an operator may have produced.  The wnid
    column is recognized by its ``n<8 digits>`` shape, so either file works
    unchanged (the r03 loader silently rejected the reference's own format).
    """
    import re

    wnid_re = re.compile(r"^n\d{8}$")
    mapping: Dict[str, str] = {}
    with open(val_map_path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            a, b = row[0].strip(), row[1].strip()
            if wnid_re.match(a):
                wnid, filename = a, b
            elif wnid_re.match(b):
                wnid, filename = b, a
            else:
                continue  # header or malformed
            mapping[os.path.basename(filename)] = wnid
    if not mapping:
        raise ValueError(f"no filename,wnid rows found in {val_map_path}")
    return mapping


def extract_val(val_tar: str, target_dir: str, val_map_path: str) -> int:
    """Flat val tar → per-class dirs (``_extract_val``,
    ``prepare_imagenet.py:58-71``)."""
    mapping = load_val_map(val_map_path)
    val_dir = Path(target_dir) / "validation"
    val_dir.mkdir(parents=True, exist_ok=True)
    moved = 0
    with tarfile.open(val_tar) as tar:
        for member in tar:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            wnid = mapping.get(name)
            if wnid is None:
                logger.warning("no class mapping for %s; skipping", name)
                continue
            class_dir = val_dir / wnid
            class_dir.mkdir(exist_ok=True)
            src = tar.extractfile(member)
            (class_dir / name).write_bytes(src.read())
            moved += 1
    return moved


def prepare_imagenet(
    train_tar: str,
    val_tar: str,
    target_dir: str,
    val_map_path: Optional[str] = None,
    *,
    check_sha1: bool = True,
    expected_train_sha1: Optional[str] = TRAIN_TAR_SHA1,
    expected_val_sha1: Optional[str] = VAL_TAR_SHA1,
) -> None:
    """Full preparation flow (``main``, ``prepare_imagenet.py:74-84``).

    ``val_map_path=None`` derives the map from the devkit tarball sitting
    next to ``val_tar`` (``data/val_maps.py`` — checksummed against the
    reference's shipped CSV), which makes the setup step as turnkey as
    ``inv setup`` without carrying the 1.5MB blob in-repo.
    """
    if val_map_path is None:
        from distributeddeeplearning_tpu_torch.data.val_maps import ensure_val_maps

        val_map_path = ensure_val_maps(os.path.dirname(os.path.abspath(val_tar)))
        if val_map_path is None:
            raise FileNotFoundError(
                "no val map CSV given and no ILSVRC2012_devkit_t12.tar.gz "
                "found next to the val tar — download the devkit (it is "
                "distributed alongside the image tars) or pass val_map_path"
            )
    if check_sha1:
        verify_checksum(train_tar, expected_train_sha1)
        verify_checksum(val_tar, expected_val_sha1)
    n_classes = extract_train(train_tar, target_dir)
    logger.info("extracted %d training classes", n_classes)
    n_val = extract_val(val_tar, target_dir, val_map_path)
    logger.info("organized %d validation images", n_val)

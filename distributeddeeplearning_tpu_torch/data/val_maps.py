"""Derive ``imagenet_val_maps.csv`` from the ILSVRC2012 devkit, checksummed
— the port of ``data/val_maps.py``.

The reference ships the 50,001-row validation filename→wnid map in-repo
(``{{proj}}/scripts/imagenet_val_maps.csv``, consumed at
``scripts/prepare_imagenet.py:58-71``) so ``inv setup`` is turnkey.  That
file is not original data — it is a pure function of the devkit tarball
every ImageNet operator already downloads next to the image tars
(``ILSVRC2012_devkit_t12.tar.gz``):

    data/ILSVRC2012_validation_ground_truth.txt   50,000 1-based ILSVRC ids,
                                                  one per val image index
    data/meta.mat                                 ILSVRC id -> WNID synset

``derive_val_maps`` recomputes the map from those two members and writes a
CSV byte-identical to the reference's (header ``class,filename``, rows
``<wnid>,ILSVRC2012_val_%08d.JPEG``); ``EXPECTED_SHA256`` pins that
equivalence, so the derivation is verified rather than trusted.
``ensure_val_maps`` derives it automatically when the devkit sits in the
download dir — same turnkey behavior, no 1.5MB blob in the repo.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import tarfile
from typing import List, Optional, Tuple

logger = logging.getLogger("ddlt.data.val_maps")

# sha256 of the reference's imagenet_val_maps.csv — the derivation below
# reproduces it byte-for-byte from the devkit.
EXPECTED_SHA256 = (
    "2e0f97e6e6fb2ee4a59e62416936d84c02bdc035135dc394f62227b5921fbcf1"
)
DEVKIT_GROUND_TRUTH = (
    "ILSVRC2012_devkit_t12/data/ILSVRC2012_validation_ground_truth.txt"
)
DEVKIT_META = "ILSVRC2012_devkit_t12/data/meta.mat"
NUM_VAL_IMAGES = 50_000


def _read_member(tar: tarfile.TarFile, name: str) -> bytes:
    try:
        member = tar.extractfile(name)
    except KeyError:
        member = None
    if member is None:
        raise FileNotFoundError(f"devkit member {name!r} not found")
    return member.read()


def derive_val_maps(devkit_tar: str) -> List[Tuple[str, str]]:
    """[(wnid, filename)] in validation-image order, from the devkit tar."""
    from scipy.io import loadmat  # in the base image; imported lazily

    with tarfile.open(devkit_tar) as tar:
        gt_bytes = _read_member(tar, DEVKIT_GROUND_TRUTH)
        meta_bytes = _read_member(tar, DEVKIT_META)

    ids = [int(line) for line in gt_bytes.decode().split()]
    if len(ids) != NUM_VAL_IMAGES:
        raise ValueError(
            f"ground truth has {len(ids)} entries, expected {NUM_VAL_IMAGES}"
        )
    import numpy as np

    synsets = loadmat(io.BytesIO(meta_bytes))["synsets"].reshape(-1)
    # meta.mat rows: struct(ILSVRC2012_ID, WNID, words, ...); ids 1..1000
    # are the leaf classes.  loadmat nests each field in per-element arrays
    # whose exact depth varies with how the .mat was written — squeeze
    # flattens both the real devkit layout and scipy.savemat round-trips.
    id_to_wnid = {}
    for row in synsets:
        sid = int(np.squeeze(row["ILSVRC2012_ID"]))
        wnid = str(np.atleast_1d(np.squeeze(row["WNID"]))[0])
        id_to_wnid[sid] = wnid
    return [
        (id_to_wnid[ilsvrc_id], f"ILSVRC2012_val_{i + 1:08d}.JPEG")
        for i, ilsvrc_id in enumerate(ids)
    ]


def write_val_maps(
    rows: List[Tuple[str, str]], out_path: str, *, verify: bool = True
) -> str:
    """Write the reference-format CSV; returns its sha256 hex digest.

    ``verify`` checks the digest against :data:`EXPECTED_SHA256` and raises
    on mismatch — a changed devkit (or a parsing regression) must fail
    loudly, not silently reorganize 50k validation images wrong.
    """
    buf = io.StringIO()
    buf.write("class,filename\n")
    for wnid, filename in rows:
        buf.write(f"{wnid},{filename}\n")
    data = buf.getvalue().encode()
    digest = hashlib.sha256(data).hexdigest()
    if verify and digest != EXPECTED_SHA256:
        raise ValueError(
            f"derived val map sha256 {digest} != expected {EXPECTED_SHA256}; "
            "refusing to write — is the devkit tar the official "
            "ILSVRC2012_devkit_t12.tar.gz?"
        )
    with open(out_path, "wb") as f:
        f.write(data)
    logger.info("wrote %s (%d rows, sha256 %s)", out_path, len(rows), digest)
    return digest


def ensure_val_maps(
    download_dir: str, out_path: Optional[str] = None
) -> Optional[str]:
    """Turnkey hook for the setup step: if the devkit tar is in
    ``download_dir`` and no map exists yet, derive + verify it.  Returns the
    CSV path, or None when the devkit is absent (caller falls back to
    requiring an operator-supplied CSV, the r03 behavior)."""
    out_path = out_path or os.path.join(download_dir, "imagenet_val_maps.csv")
    if os.path.exists(out_path):
        return out_path
    devkit = os.path.join(download_dir, "ILSVRC2012_devkit_t12.tar.gz")
    if not os.path.exists(devkit):
        return None
    write_val_maps(derive_val_maps(devkit), out_path)
    return out_path

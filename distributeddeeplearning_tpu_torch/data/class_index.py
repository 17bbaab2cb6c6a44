"""ImageNet class-index contracts: derive, write, verify — the port of
``data/class_index.py``.

The reference ships two label-mapping data files with fixed formats:

- ``imagenet_nounid_to_class.json`` — one JSON object ``{"n01440764": 0, …}``
  consumed by the raw-image loader's label lookup
  (``TensorFlow_imagenet/src/data/images.py:12-24``);
- ``scripts/imagenet_class_index.json`` — ``{"0": ["n01440764", "tench"], …}``
  (the canonical keras-style human-readable index).

Both ship in-repo under ``data/files/`` (``shipped_class_index_path`` /
``shipped_nounid_to_class_path``) so ``--verify`` works out of the box: the
class index is the canonical public Keras/ImageNet metadata (1000 classes in
sorted-wnid order with human-readable names), and the nounid→class object is
derived from it (sorted wnid position, 0-based — the reference's format).
This module additionally:

- ``build_nounid_to_class(image_dir)`` derives the wnid→training-label
  mapping from the extracted train tree (1-based by default — what this
  framework's loaders actually assign; ``label_offset=0`` reproduces the
  reference's 0-based file) and ``write_nounid_to_class`` emits it in the
  reference's single-object format;
- ``load_class_index(path)`` parses a canonical keras-style index the user
  already has;
- ``verify_class_index(...)`` cross-checks the two — catching the classic
  off-by-one (TF's 1001-class background offset) and any wnid ordering
  mismatch before a multi-day training run bakes it in.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple


_FILES_DIR = Path(__file__).parent / "files"


def shipped_class_index_path() -> Path:
    """The in-repo canonical ``imagenet_class_index.json``."""
    return _FILES_DIR / "imagenet_class_index.json"


def shipped_nounid_to_class_path() -> Path:
    """The in-repo 0-based ``imagenet_nounid_to_class.json``."""
    return _FILES_DIR / "imagenet_nounid_to_class.json"


def list_wnids(image_dir: str | Path) -> List[str]:
    """Sorted wnid class-directory names under an extracted train tree."""
    root = Path(image_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"image dir not found: {root}")
    wnids = sorted(p.name for p in root.iterdir() if p.is_dir())
    if not wnids:
        raise ValueError(f"no class directories under {root}")
    return wnids


def build_nounid_to_class(
    image_dir: str | Path, *, label_offset: int = 1
) -> Dict[str, int]:
    """wnid → training label: sorted directory position + ``label_offset``.

    The default offset 1 matches what this framework's loaders actually
    train with — 1-based labels with background=0 (``data/images.py``
    ``{w: i + 1}``, ``data/tfrecords.py`` "1-based, 1..1000, background=0").
    Pass ``label_offset=0`` for the reference's 0-based
    ``imagenet_nounid_to_class.json`` file format.
    """
    return {
        wnid: idx + label_offset
        for idx, wnid in enumerate(list_wnids(image_dir))
    }


def write_nounid_to_class(mapping: Mapping[str, int], path: str | Path) -> None:
    """Write in the reference's single-object format
    (``imagenet_nounid_to_class.json``)."""
    Path(path).write_text(json.dumps(dict(mapping)))


def load_nounid_to_class(path: str | Path) -> Dict[str, int]:
    data = json.loads(Path(path).read_text())
    return {str(k): int(v) for k, v in data.items()}


def load_class_index(path: str | Path) -> Dict[int, Tuple[str, str]]:
    """Parse a canonical keras-style ``imagenet_class_index.json``:
    ``{"0": ["n01440764", "tench"], …}`` → {0: ("n01440764", "tench")}."""
    raw = json.loads(Path(path).read_text())
    out: Dict[int, Tuple[str, str]] = {}
    for key, value in raw.items():
        if not isinstance(value, Sequence) or len(value) != 2:
            raise ValueError(f"class index entry {key!r} is not [wnid, text]")
        out[int(key)] = (str(value[0]), str(value[1]))
    return out


def class_names(
    class_index: Mapping[int, Tuple[str, str]], num_classes: int = 1000
) -> List[str]:
    """Human-readable names ordered by label (for eval reports)."""
    return [class_index[i][1] for i in range(num_classes)]


def verify_class_index(
    class_index: Mapping[int, Tuple[str, str]],
    nounid_to_class: Mapping[str, int],
    *,
    label_offset: int = 1,
) -> List[str]:
    """Cross-check the canonical (0-based keras) index against the derived
    training-label mapping: for every wnid, ``derived == canonical + offset``.

    The default offset 1 is this framework's 1001-class convention (label 0
    is background, wnid classes start at 1 — the reference's
    ``defaults.NUM_CLASSES=1001``); use 0 when the mapping was built with
    ``label_offset=0``.  Returns a list of human-readable problems — empty
    means the contracts agree.
    """
    problems: List[str] = []
    if len(class_index) != len(nounid_to_class):
        problems.append(
            f"size mismatch: class index has {len(class_index)} entries, "
            f"derived mapping has {len(nounid_to_class)}"
        )
    for idx, (wnid, _text) in sorted(class_index.items()):
        derived = nounid_to_class.get(wnid)
        if derived is None:
            problems.append(f"wnid {wnid} (class {idx}) missing from data tree")
        elif derived != idx + label_offset:
            problems.append(
                f"wnid {wnid}: derived label {derived} != canonical class "
                f"{idx} + offset {label_offset}"
            )
    return problems

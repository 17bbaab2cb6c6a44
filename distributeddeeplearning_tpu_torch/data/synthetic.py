"""Synthetic inputs — the port of ``data/synthetic.py``.

Images: :class:`SyntheticDataset` (a sized fake classification set, one
epoch of batches), :func:`synthetic_batch` (the benchmark's one resident
batch) and :func:`synthetic_batches` (a stream of distinct batches) give
the reference's numpy arrays bit for bit: standard-normal NHWC f32 images
(:data:`DEFAULT_IMAGE_SHAPE`) and int32 labels in [0, num_classes), drawn
from ``numpy.random.default_rng(seed)`` in the reference's order.

Text: :class:`SyntheticTextDataset` yields the same batches as the reference's,
bit for bit: the same ``numpy.random.default_rng(seed)`` stream drawn in
the same order (ids in [1, vocab), one length in [1, seq_len] per example,
then the labels), the positions past each length set to the pad id, and
the matching 0/1 attention mask.  Host-side numpy only, so the BERT
workload builds every fine-tuning batch with a real key-padding mask.

:func:`fake_data_length` keeps the reference's ``FAKE_DATA_LENGTH``
environment override of an epoch's length.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]

DEFAULT_IMAGE_SHAPE = (224, 224, 3)  # NHWC, as the reference's batches


def fake_data_length(default: int = 1281167) -> int:
    """Epoch length: ``FAKE_DATA_LENGTH`` from the environment when set,
    else ``default``."""
    val = os.environ.get("FAKE_DATA_LENGTH", "")
    return int(val) if val else default


class SyntheticDataset:
    """Sized, deterministic fake image classification dataset."""

    def __init__(
        self,
        length: Optional[int] = None,
        image_shape: Tuple[int, ...] = DEFAULT_IMAGE_SHAPE,
        num_classes: int = 1001,
        seed: int = 42,
        dtype: np.dtype = np.float32,
    ):
        self.length = fake_data_length() if length is None else length
        self.image_shape = image_shape
        self.num_classes = num_classes
        self.seed = seed
        self.dtype = dtype

    def __len__(self) -> int:
        return self.length

    def batches(
        self, batch_size: int, *, drop_remainder: bool = True
    ) -> Iterator[Batch]:
        """One epoch of ``{"image", "label"}`` batches."""
        rng = np.random.default_rng(self.seed)
        n_batches = self.length // batch_size
        if not drop_remainder and self.length % batch_size:
            n_batches += 1
        for i in range(n_batches):
            size = min(batch_size, self.length - i * batch_size)
            yield {
                "image": rng.standard_normal(
                    (size, *self.image_shape), dtype=np.float32
                ).astype(self.dtype),
                "label": rng.integers(0, self.num_classes, size=(size,), dtype=np.int32),
            }


class SyntheticTextDataset:
    """Sized, deterministic fake tokenized-text classification dataset:
    random token ids with a random valid length per example (the rest
    padding), the matching attention mask, and an integer label."""

    def __init__(
        self,
        length: Optional[int] = None,
        seq_len: int = 128,
        vocab_size: int = 30522,
        num_classes: int = 2,
        seed: int = 42,
        pad_id: int = 0,
    ):
        self.length = fake_data_length(25000) if length is None else length
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.num_classes = num_classes
        self.seed = seed
        self.pad_id = pad_id

    def __len__(self) -> int:
        return self.length

    def batches(
        self, batch_size: int, *, drop_remainder: bool = True
    ) -> Iterator[Batch]:
        """One epoch of ``{"input", "attention_mask", "label"}`` batches
        (int32 [B, S], int32 [B, S], int32 [B])."""
        rng = np.random.default_rng(self.seed)
        n_batches = self.length // batch_size
        if not drop_remainder and self.length % batch_size:
            n_batches += 1
        for i in range(n_batches):
            size = min(batch_size, self.length - i * batch_size)
            ids = rng.integers(
                1, self.vocab_size, size=(size, self.seq_len), dtype=np.int32
            )
            lengths = rng.integers(1, self.seq_len + 1, size=(size,))
            mask = (np.arange(self.seq_len)[None, :] < lengths[:, None]).astype(
                np.int32
            )
            ids = np.where(mask.astype(bool), ids, self.pad_id)
            yield {
                "input": ids,
                "attention_mask": mask,
                "label": rng.integers(
                    0, self.num_classes, size=(size,), dtype=np.int32
                ),
            }


def synthetic_batch(
    batch_size: int,
    image_shape: Tuple[int, ...] = DEFAULT_IMAGE_SHAPE,
    num_classes: int = 1001,
    seed: int = 0,
    dtype: np.dtype = np.float32,
) -> Batch:
    """One fixed random batch: the benchmark's resident batch."""
    rng = np.random.default_rng(seed)
    return {
        "image": rng.standard_normal((batch_size, *image_shape), dtype=np.float32).astype(
            dtype
        ),
        "label": rng.integers(0, num_classes, size=(batch_size,), dtype=np.int32),
    }


def synthetic_batches(
    batch_size: int,
    steps: int,
    image_shape: Tuple[int, ...] = DEFAULT_IMAGE_SHAPE,
    num_classes: int = 1001,
    seed: int = 0,
) -> Iterator[Batch]:
    """A stream of ``steps`` distinct random batches."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield {
            "image": rng.standard_normal((batch_size, *image_shape), dtype=np.float32),
            "label": rng.integers(0, num_classes, size=(batch_size,), dtype=np.int32),
        }

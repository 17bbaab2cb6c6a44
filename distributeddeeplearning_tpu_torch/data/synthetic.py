"""Synthetic tokenized text — the port of ``data/synthetic.py``'s text half.

:class:`SyntheticTextDataset` yields the same batches as the reference's,
bit for bit: the same ``numpy.random.default_rng(seed)`` stream drawn in
the same order (ids in [1, vocab), one length in [1, seq_len] per example,
then the labels), the positions past each length set to the pad id, and
the matching 0/1 attention mask.  Host-side numpy only, so the BERT
workload builds every fine-tuning batch with a real key-padding mask.

:func:`fake_data_length` keeps the reference's ``FAKE_DATA_LENGTH``
environment override of an epoch's length.  The image half of the module
(``SyntheticDataset``, ``synthetic_batch``) belongs to the ResNet slice.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

Batch = Dict[str, np.ndarray]


def fake_data_length(default: int = 1281167) -> int:
    """Epoch length: ``FAKE_DATA_LENGTH`` from the environment when set,
    else ``default``."""
    val = os.environ.get("FAKE_DATA_LENGTH", "")
    return int(val) if val else default


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

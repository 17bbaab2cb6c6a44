"""The JPEG decoder both packages' native pipelines run, chosen for a test
(``test_torch_input_pipelines``, ``test_torch_raw_cache``,
``test_torch_imagenet``).

``"c"`` is ``ddlt_image.c``, built here with libjpeg.  ``"pil"`` is the
branch a host without libjpeg's headers takes: both packages'
``_native_image`` report no library, so ``native_pipeline._decode_train``
and ``_decode_eval`` (and the raw-cache builder through them) decode every
image with PIL.
"""

from __future__ import annotations

import contextlib

import pytest

from distributeddeeplearning_tpu.data import _native_image as r_image
from distributeddeeplearning_tpu_torch.data import _native_image as t_image
from distributeddeeplearning_tpu_torch.data import native_pipeline as t_native

DECODERS = ["c", "pil"]


@contextlib.contextmanager
def jpeg_decoder(name: str):
    """Both packages decode through ``name``; yields the port's counts of
    images decoded by each (``native_pipeline.decoded``), from 0."""
    with pytest.MonkeyPatch.context() as mp:
        if name == "pil":
            for mod in (t_image, r_image):
                mp.setattr(mod, "_LIB", None)
                mp.setattr(mod, "_TRIED", True)
        elif not (t_image.native_available() and r_image.native_available()):
            pytest.skip("no libjpeg here: ddlt_image.c did not build")
        counts = {"c": 0, "pil": 0}
        mp.setattr(t_native, "decoded", counts)
        yield counts


def assert_decoded_by(counts, name: str) -> None:
    """Every image the port decoded went through ``name``."""
    other = "pil" if name == "c" else "c"
    assert counts[name] > 0 and counts[other] == 0, counts

"""ctypes bindings for the native JPEG decoder (csrc/ddlt_image.c) — the
port of ``data/_native_image.py``.

Same compile-on-demand scheme as the TFRecord reader (``_native.py``): the
shared library builds once into the port's ``_build/`` with the host C
compiler, linked against the system libjpeg; when either is missing (a
host with no libjpeg headers cannot build it) every entry point reports
unavailable and callers keep the PIL path (identical semantics — the C
resampler implements Pillow's triangle-filter BILINEAR).

Public surface:
    decode_resize(jpeg, size, crop_frac=0.0) -> np.ndarray | None
        float32 [size, size, 3] RGB in 0..255, or None when the stream
        needs the fallback (CMYK, corrupt data, no native library).
    native_available() -> bool
"""

from __future__ import annotations

import ctypes
import logging
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from distributeddeeplearning_tpu_torch.data._native_build import compile_cached

logger = logging.getLogger("ddlt.data.native_image")

_SRC = Path(__file__).parent / "csrc" / "ddlt_image.c"
_LIB = None
_TRIED = False
# one build: a pool's first calls wait for it instead of taking the fallback
_LOCK = threading.Lock()


def _load():
    global _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _build_and_bind()
            _TRIED = True
    return _LIB


def _build_and_bind() -> None:
    global _LIB
    path = compile_cached(_SRC, "ddlt_image", ["-ljpeg"])
    if path is None:
        logger.info(
            "native JPEG decoder unavailable (no compiler or libjpeg); "
            "using the PIL path"
        )
        return
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:  # e.g. libjpeg runtime missing
        logger.info("native JPEG decoder failed to load (%s); using PIL", exc)
        return
    lib.ddlt_jpeg_decode_resize.restype = ctypes.c_int
    lib.ddlt_jpeg_decode_resize.argtypes = [
        ctypes.c_char_p,
        ctypes.c_ulong,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib


def native_available() -> bool:
    return _load() is not None


def decode_resize(
    jpeg: bytes, size: int, crop_frac: float = 0.0
) -> Optional[np.ndarray]:
    """Decode + (optional central crop) + Pillow-style bilinear resample.

    Returns float32 [size, size, 3] or None when the caller should fall
    back to PIL (unsupported colorspace, corrupt stream, no library)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.float32)
    rc = lib.ddlt_jpeg_decode_resize(
        jpeg,
        len(jpeg),
        float(crop_frac),
        size,
        size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None
    return out

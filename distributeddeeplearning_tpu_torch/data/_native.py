"""ctypes bindings for the native TFRecord reader (csrc/ddlt_records.c) —
the port of ``data/_native.py``.

The shared library is compiled on demand with the host C compiler into the
port's ``_build/`` (keyed by a digest of the source and flags, so edits
rebuild automatically; ``_native_build.py``) — no build-system dependency.
When no compiler is available every entry point falls back to a
pure-Python implementation with identical semantics (slower; fine for
tests and small jobs).

Public surface:
    crc32c(data) / masked_crc32c(data)
    RecordReader(path, verify=True)        — iterator of raw record bytes
    example_bytes(record, key)             — first BytesList value or None
    example_int64(record, key)             — first Int64List value or None
    native_available()                     — True when the C library loaded
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from pathlib import Path
from typing import Iterator, Optional

logger = logging.getLogger("ddlt.data.native")

_SRC = Path(__file__).parent / "csrc" / "ddlt_records.c"
_LIB = None
_TRIED = False
# one build: a pool's first calls wait for it instead of taking the fallback
_LOCK = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
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
    from distributeddeeplearning_tpu_torch.data._native_build import compile_cached

    path = compile_cached(_SRC, "ddlt_records")
    if path is None:
        logger.info("native record reader unavailable; using Python fallback")
        return
    lib = ctypes.CDLL(str(path))
    lib.ddlt_crc32c.restype = ctypes.c_uint32
    lib.ddlt_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.ddlt_masked_crc32c.restype = ctypes.c_uint32
    lib.ddlt_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.ddlt_reader_open.restype = ctypes.c_void_p
    lib.ddlt_reader_open.argtypes = [ctypes.c_char_p]
    lib.ddlt_reader_next.restype = ctypes.c_int
    lib.ddlt_reader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.ddlt_reader_close.restype = None
    lib.ddlt_reader_close.argtypes = [ctypes.c_void_p]
    lib.ddlt_example_bytes.restype = ctypes.c_int
    lib.ddlt_example_bytes.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.ddlt_example_int64.restype = ctypes.c_int
    lib.ddlt_example_int64.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _LIB = lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

_PY_TABLE = None


def _py_table():
    global _PY_TABLE
    if _PY_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        _PY_TABLE = table
    return _PY_TABLE


def crc32c(data: bytes) -> int:
    lib = _load()
    if lib is not None:
        return lib.ddlt_crc32c(data, len(data))
    table = _py_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    lib = _load()
    if lib is not None:
        return lib.ddlt_masked_crc32c(data, len(data))
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record reading
# ---------------------------------------------------------------------------


class RecordCorruptionError(IOError):
    pass


class RecordReader:
    """Iterate raw TFRecord payloads from one file.

    ``verify=True`` checks both masked CRCs per record (the reference's
    tf.data reader verifies the same way); corruption raises
    ``RecordCorruptionError`` rather than yielding garbage.
    """

    def __init__(self, path: str | os.PathLike, *, verify: bool = True):
        self.path = str(path)
        self.verify = verify

    def __iter__(self) -> Iterator[bytes]:
        lib = _load()
        if lib is not None:
            yield from self._iter_native(lib)
        else:
            yield from self._iter_python()

    def _iter_native(self, lib) -> Iterator[bytes]:
        handle = lib.ddlt_reader_open(self.path.encode())
        if not handle:
            raise FileNotFoundError(self.path)
        try:
            data = ctypes.POINTER(ctypes.c_uint8)()
            length = ctypes.c_uint64()
            while True:
                rc = lib.ddlt_reader_next(
                    handle,
                    ctypes.byref(data),
                    ctypes.byref(length),
                    1 if self.verify else 0,
                )
                if rc == 0:
                    return
                if rc < 0:
                    raise RecordCorruptionError(
                        f"corrupt TFRecord frame in {self.path}"
                    )
                yield ctypes.string_at(data, length.value)
        finally:
            lib.ddlt_reader_close(handle)

    def _iter_python(self) -> Iterator[bytes]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(12)
                if not header:
                    return
                if len(header) != 12:
                    raise RecordCorruptionError(
                        f"truncated TFRecord header in {self.path}"
                    )
                (n,) = struct.unpack("<Q", header[:8])
                (len_crc,) = struct.unpack("<I", header[8:])
                if self.verify and len_crc != masked_crc32c(header[:8]):
                    raise RecordCorruptionError(
                        f"length CRC mismatch in {self.path}"
                    )
                payload = f.read(n)
                footer = f.read(4)
                if len(payload) != n or len(footer) != 4:
                    raise RecordCorruptionError(
                        f"truncated TFRecord payload in {self.path}"
                    )
                if self.verify and struct.unpack("<I", footer)[0] != masked_crc32c(
                    payload
                ):
                    raise RecordCorruptionError(
                        f"payload CRC mismatch in {self.path}"
                    )
                yield payload


# ---------------------------------------------------------------------------
# Example feature extraction (minimal wire-format walk, no protobuf runtime)
# ---------------------------------------------------------------------------


def example_bytes(record: bytes, key: str) -> Optional[bytes]:
    lib = _load()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        ok = lib.ddlt_example_bytes(
            record, len(record), key.encode(), ctypes.byref(out),
            ctypes.byref(out_len),
        )
        return ctypes.string_at(out, out_len.value) if ok else None
    feat = _py_find_feature(record, key)
    if feat is None:
        return None
    blist = _py_find_len_field(feat, 1)
    if blist is None:
        return None
    return _py_find_len_field(blist, 1)


def example_int64(record: bytes, key: str) -> Optional[int]:
    lib = _load()
    if lib is not None:
        out = ctypes.c_int64()
        ok = lib.ddlt_example_int64(
            record, len(record), key.encode(), ctypes.byref(out)
        )
        return out.value if ok else None
    feat = _py_find_feature(record, key)
    if feat is None:
        return None
    ilist = _py_find_len_field(feat, 3)
    if ilist is None:
        return None
    pos = 0
    while pos < len(ilist):
        tag, pos = _py_varint(ilist, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            v, pos = _py_varint(ilist, pos)
            return _to_signed(v)
        if field == 1 and wire == 2:
            n, pos = _py_varint(ilist, pos)
            v, _ = _py_varint(ilist, pos)
            return _to_signed(v)
        pos = _py_skip(ilist, pos, wire)
    return None


def _to_signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _py_varint(buf: bytes, pos: int):
    v = shift = 0
    while pos < len(buf):
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
    raise RecordCorruptionError("truncated varint")


def _py_skip(buf: bytes, pos: int, wire: int) -> int:
    # Bounds-checked like the C walker: skipping past the end of the buffer
    # is corruption, not "field absent".
    if wire == 0:
        _, pos = _py_varint(buf, pos)
        return pos
    if wire == 1:
        if pos + 8 > len(buf):
            raise RecordCorruptionError("truncated fixed64 field")
        return pos + 8
    if wire == 2:
        n, pos = _py_varint(buf, pos)
        if n > len(buf) - pos:
            raise RecordCorruptionError("truncated length-delimited field")
        return pos + n
    if wire == 5:
        if pos + 4 > len(buf):
            raise RecordCorruptionError("truncated fixed32 field")
        return pos + 4
    raise RecordCorruptionError(f"unknown wire type {wire}")


def _py_find_len_field(buf: bytes, want: int, start: int = 0):
    pos = start
    while pos < len(buf):
        tag, pos = _py_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == want and wire == 2:
            n, pos = _py_varint(buf, pos)
            if n > len(buf) - pos:
                # Over-long field: the C path reports not-found rather than
                # returning a truncated slice — mirror that exactly.
                return None
            return buf[pos : pos + n]
        pos = _py_skip(buf, pos, wire)
    return None


def _py_find_feature(record: bytes, key: str):
    features = _py_find_len_field(record, 1)
    if features is None:
        return None
    kb = key.encode()
    pos = 0
    while pos < len(features):
        tag, pos = _py_varint(features, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _py_varint(features, pos)
            if n > len(features) - pos:
                # Over-long map entry: not-found, matching _py_find_len_field
                # and the C walker's contract.
                return None
            entry = features[pos : pos + n]
            pos += n
            if _py_find_len_field(entry, 1) == kb:
                return _py_find_len_field(entry, 2)
            continue
        pos = _py_skip(features, pos, wire)
    return None

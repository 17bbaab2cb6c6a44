"""TF-free ``tf.train.Example`` encoder + TFRecord frame writer — the port
of ``data/proto.py``, byte for byte the reference's output.

The write-side complement of the native reader (``data/_native.py`` /
``csrc/ddlt_records.c``): hand-rolled protobuf wire encoding for the three
Feature list types plus the length+masked-CRC32C record framing, so shards
with the reference converter's exact schema
(``scripts/convert_imagenet_to_tf_records.py:111-146``) can be produced on
hosts with no TensorFlow at all.  Records written here parse with
``tf.io.parse_single_example`` AND with the in-repo C walker
(``tests/test_torch_records.py``).  Int64 lists are written unpacked, as
the reference writes them; TensorFlow's own serializer packs them, so the
bytes equal its output only where no int64 feature appears, and the
parsed messages are equal always.

Wire shapes emitted (all accepted by both TF's parser and the C walker,
which handles packed and unpacked int64 — ``ddlt_records.c:121-129``):

    Example  { Features features = 1; }
    Features { map<string, Feature> feature = 1; }   # entry: key=1, value=2
    Feature  { BytesList=1 | FloatList=2 | Int64List=3 }
    BytesList{ repeated bytes value = 1; }
    FloatList{ repeated float value = 1; }           # packed, fixed32
    Int64List{ repeated int64 value = 1; }           # unpacked varints
"""

from __future__ import annotations

import struct
from typing import Dict, Sequence, Union

from distributeddeeplearning_tpu_torch.data._native import masked_crc32c

FeatureValue = Union[int, float, bytes, str, Sequence[int], Sequence[float], Sequence[bytes]]


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # protobuf int64: negatives are 10-byte varints
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _bytes_list(values: Sequence[bytes]) -> bytes:
    return b"".join(_len_delimited(1, v) for v in values)


def _int64_list(values: Sequence[int]) -> bytes:
    return b"".join(_tag(1, 0) + _varint(v) for v in values)


def _float_list(values: Sequence[float]) -> bytes:
    packed = b"".join(struct.pack("<f", v) for v in values)
    return _len_delimited(1, packed)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize a feature dict to ``tf.train.Example`` wire bytes.

    Type mapping mirrors the converter helpers (``convert_tfrecords.py``
    ``_int64``/``_bytes``): int → Int64List, float → FloatList,
    bytes/str → BytesList; a list/tuple of those encodes a multi-value
    list.  ``str`` values are UTF-8 encoded, matching
    ``tf.train.BytesList``'s convention for text features.
    """
    entries = []
    for key, value in features.items():
        if isinstance(value, (bytes, str, int, float)):
            value = [value]
        elif not isinstance(value, (list, tuple)):
            raise TypeError(f"unsupported feature type for {key!r}: {type(value)}")
        if not value:
            raise ValueError(f"empty feature list for {key!r}")
        first = value[0]
        if isinstance(first, int):  # bools ride Int64List too (a subclass)
            feature = _len_delimited(3, _int64_list([int(v) for v in value]))
        elif isinstance(first, float):
            feature = _len_delimited(2, _float_list([float(v) for v in value]))
        elif isinstance(first, (bytes, str)):
            feature = _len_delimited(
                1,
                _bytes_list(
                    [v.encode() if isinstance(v, str) else v for v in value]
                ),
            )
        else:
            raise TypeError(f"unsupported feature element for {key!r}: {type(first)}")
        # map<string, Feature> entry message: key = 1 (string), value = 2.
        entry = _len_delimited(1, key.encode()) + _len_delimited(2, feature)
        entries.append(_len_delimited(1, entry))
    features_msg = b"".join(entries)
    return _len_delimited(1, features_msg)


def write_record(fileobj, payload: bytes) -> None:
    """Append one TFRecord frame: u64le length, masked CRC32C of the length
    bytes, payload, masked CRC32C of the payload — the framing the reader
    verifies (``csrc/ddlt_records.c:86-118``)."""
    header = struct.pack("<Q", len(payload))
    fileobj.write(header)
    fileobj.write(struct.pack("<I", masked_crc32c(header)))
    fileobj.write(payload)
    fileobj.write(struct.pack("<I", masked_crc32c(payload)))


class RecordWriter:
    """Minimal ``tf.io.TFRecordWriter`` stand-in (local files, no TF)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        write_record(self._f, payload)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

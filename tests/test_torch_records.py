"""The port's record plane against the JAX package's, on the same bytes.

- ``proto.encode_example`` gives the reference's bytes for every feature
  kind; against TensorFlow's own serializer the bytes are equal where no
  int64 feature appears (TF packs int64 lists, both packages write them
  unpacked) and the parsed messages are equal always.
- CRC32C and its masked form, ``RecordReader`` and the Example walkers
  give the reference's results with the C library and with the
  pure-Python paths (the library hidden on both sides), on shards the
  port's ``RecordWriter`` and TF's ``TFRecordWriter`` wrote, and fail
  alike on a corrupted or truncated frame.
- ``_native_image.decode_resize`` equals the reference's bit for bit (both
  build ``ddlt_image.c`` against libjpeg here), and stays within the
  reference's stated bound of Pillow's fixed-point BILINEAR (1.5 levels).
- The C sources are the reference's, and ``_native_build`` names a
  library by a digest of the source and flags and builds it in ``_build/``.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import pytest
from PIL import Image

from distributeddeeplearning_tpu.data import _native as r_native
from distributeddeeplearning_tpu.data import _native_image as r_image
from distributeddeeplearning_tpu.data import proto as r_proto
from distributeddeeplearning_tpu_torch.data import _native as t_native
from distributeddeeplearning_tpu_torch.data import _native_build
from distributeddeeplearning_tpu_torch.data import _native_image as t_image
from distributeddeeplearning_tpu_torch.data import proto as t_proto

FEATURE_SETS = [
    {"image/encoded": b"\xff\xd8jpeg", "image/class/label": 417,
     "image/class/synset": "n02123045", "image/channels": 3},
    {"a": -5, "b": 2**62, "c": [1, 2, 3], "d": 0},
    {"f": 1.5, "g": [0.25, -3.0, 1e30], "s": ["x", "y"], "e": b""},
    {"z": b"1", "a": b"2", "m": [b"3", b"4"], "k": "text"},
]


def _rec_bytes(i: int) -> bytes:
    return t_proto.encode_example({"image/encoded": b"data%d" % i,
                                   "image/class/label": i - 2,
                                   "image/format": "JPEG"})


@pytest.fixture(params=["c", "python"])
def impl(request, monkeypatch):
    """Both packages on their C library, or both on their Python paths."""
    if request.param == "c":
        if not (t_native.native_available() and r_native.native_available()):
            pytest.skip("no C compiler here")
    else:
        for mod in (t_native, r_native):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
        assert not t_native.native_available()
    return request.param


@pytest.mark.parametrize("features", FEATURE_SETS)
def test_encode_example_equals_the_reference(features):
    assert t_proto.encode_example(features) == r_proto.encode_example(features)


@pytest.mark.parametrize("features", FEATURE_SETS)
def test_encode_example_against_tensorflow(features):
    tf = pytest.importorskip("tensorflow")

    def feature(v):
        v = v if isinstance(v, list) else [v]
        if isinstance(v[0], int):
            return tf.train.Feature(int64_list=tf.train.Int64List(value=v))
        if isinstance(v[0], float):
            return tf.train.Feature(float_list=tf.train.FloatList(value=v))
        v = [x.encode() if isinstance(x, str) else x for x in v]
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=v))

    ex = tf.train.Example(features=tf.train.Features(
        feature={k: feature(v) for k, v in features.items()}))
    ours = t_proto.encode_example(dict(sorted(features.items())))
    assert tf.train.Example.FromString(ours) == ex
    if not any(isinstance(v if not isinstance(v, list) else v[0], int)
               for v in features.values()):
        assert ours == ex.SerializeToString(deterministic=True)


def test_crc32c_equals_the_reference(impl):
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 1000, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t_native.crc32c(data) == r_native.crc32c(data)
        assert t_native.masked_crc32c(data) == r_native.masked_crc32c(data)
    assert t_native.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("writer", ["port", "tensorflow"])
def test_reader_and_walkers_equal_the_reference(tmp_path, impl, writer):
    payloads = [_rec_bytes(i) for i in range(6)]
    path = tmp_path / "shard"
    if writer == "port":
        with t_proto.RecordWriter(str(path)) as w:
            for p in payloads:
                w.write(p)
    else:
        tf = pytest.importorskip("tensorflow")
        with tf.io.TFRecordWriter(str(path)) as w:
            for p in payloads:
                w.write(p)
    ours = list(t_native.RecordReader(path))
    assert ours == list(r_native.RecordReader(path)) == payloads
    for i, rec in enumerate(ours):
        for key in ("image/encoded", "image/format", "missing"):
            assert t_native.example_bytes(rec, key) == r_native.example_bytes(rec, key)
        assert t_native.example_int64(rec, "image/class/label") == i - 2
        assert t_native.example_int64(rec, "missing") is None


@pytest.mark.parametrize("damage", ["payload", "length_crc", "truncated"])
def test_corrupted_frames_fail_alike(tmp_path, impl, damage):
    path = tmp_path / "shard"
    with t_proto.RecordWriter(str(path)) as w:
        for i in range(4):
            w.write(_rec_bytes(i))
    raw = bytearray(path.read_bytes())
    starts = np.cumsum([0] + [16 + len(_rec_bytes(i)) for i in range(4)])
    if damage == "payload":
        raw[starts[2] + 14] ^= 0x40  # a payload byte of the third record
    elif damage == "length_crc":
        raw[starts[2] + 9] ^= 0x01
    else:
        raw = raw[: starts[3] + 10]  # the fourth header cut short
    path.write_bytes(bytes(raw))

    def read(mod):
        got = []
        with pytest.raises(mod.RecordCorruptionError):
            for rec in mod.RecordReader(path):
                got.append(rec)
        return got

    ours, ref = read(t_native), read(r_native)
    assert ours == ref
    assert len(ours) == (3 if damage == "truncated" else 2)
    if damage != "truncated":  # unverified reads go on past a bad CRC
        assert (list(t_native.RecordReader(path, verify=False))
                == list(r_native.RecordReader(path, verify=False)))


def test_overlong_fields_read_as_absent(impl):
    for buf in (bytes([0x0A, 100]) + b"abcd",
                bytes([0x0A]) + bytes([0xFF] * 9 + [0x01]) + b"ab"):
        assert t_native.example_bytes(buf, "image/encoded") is None
        assert r_native.example_bytes(buf, "image/encoded") is None


def test_sources_are_the_reference_and_build_by_digest(tmp_path):
    from pathlib import Path

    ref = Path(r_native.__file__).parent / "csrc"
    ours = Path(t_native.__file__).parent / "csrc"
    for name in ("ddlt_records.c", "ddlt_image.c"):
        assert (ours / name).read_bytes() == (ref / name).read_bytes()
    lib = _native_build.library_path(ours / "ddlt_records.c", "ddlt_records")
    assert lib.parent == _native_build.BUILD_DIR
    edited = tmp_path / "ddlt_records.c"
    edited.write_bytes((ours / "ddlt_records.c").read_bytes() + b"\n")
    assert _native_build.library_path(edited, "ddlt_records").name != lib.name
    assert (_native_build.library_path(ours / "ddlt_records.c", "ddlt_records",
                                       ["-ljpeg"]).name != lib.name)
    if t_native.native_available():
        assert _native_build.compile_cached(ours / "ddlt_records.c",
                                            "ddlt_records") == lib
        assert lib.exists()
    assert _native_build.compile_cached(tmp_path / "absent.c", "x") is None


def _jpeg(h=371, w=523, quality=95, mode="RGB"):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 / w), (yy * 255 / h),
                    ((xx + yy) * 255 / (w + h))], -1).astype(np.uint8)
    pil = Image.fromarray(img[:, :, 0], "L") if mode == "L" else Image.fromarray(img)
    buf = io.BytesIO()
    pil.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _pil_reference(jpeg, size, crop_frac=0.0):
    img = Image.open(io.BytesIO(jpeg)).convert("RGB")
    if crop_frac:
        w, h = img.size
        crop = int(min(h, w) * crop_frac)
        x, y = (w - crop) // 2, (h - crop) // 2
        img = img.crop((x, y, x + crop, y + crop))
    return np.asarray(img.resize((size, size), Image.BILINEAR), np.float32)


@pytest.mark.parametrize("size,crop,mode", [(224, 0.0, "RGB"),
                                            (224, 224 / 256, "RGB"),
                                            (64, 0.0, "RGB"), (48, 0.5, "L")])
def test_decode_resize_equals_the_reference(size, crop, mode):
    if not (t_image.native_available() and r_image.native_available()):
        pytest.skip("no C compiler or libjpeg here")
    jpeg = _jpeg(mode=mode)
    ours = t_image.decode_resize(jpeg, size, crop)
    assert ours is not None and ours.shape == (size, size, 3)
    np.testing.assert_array_equal(ours, r_image.decode_resize(jpeg, size, crop))
    np.testing.assert_allclose(ours, _pil_reference(jpeg, size, crop), atol=1.5)
    for bad in (b"not a jpeg", jpeg[: len(jpeg) // 2]):
        assert t_image.decode_resize(bad, size, crop) is None
        assert r_image.decode_resize(bad, size, crop) is None


def test_frame_layout():
    buf = io.BytesIO()
    t_proto.write_record(buf, b"abc")
    raw = buf.getvalue()
    assert struct.unpack("<Q", raw[:8])[0] == 3
    assert struct.unpack("<I", raw[8:12])[0] == t_native.masked_crc32c(raw[:8])
    assert raw[12:15] == b"abc"
    assert struct.unpack("<I", raw[15:])[0] == r_native.masked_crc32c(b"abc")


def test_first_use_from_a_pool_waits_for_the_build(monkeypatch):
    """Threads that ask for the decoder while it is being bound wait for
    it (the reference's ``_load`` marks it tried first, so such threads
    take the PIL fallback)."""
    from concurrent.futures import ThreadPoolExecutor

    if not t_image.native_available():
        pytest.skip("no C compiler or libjpeg here")
    monkeypatch.setattr(t_image, "_LIB", None)
    monkeypatch.setattr(t_image, "_TRIED", False)
    jpeg = _jpeg(h=40, w=50)
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda _: t_image.decode_resize(jpeg, 16), range(32)))
    assert all(o is not None for o in outs)

"""The port's ImageNet preparation against the JAX package's.

- The shipped JSON files are the reference's (sha256), and ``class_index``
  derives, writes, loads and verifies the reference's results;
- ``val_maps`` derives the reference's rows and CSV bytes from a devkit
  tar the test writes (scipy-written ``meta.mat`` and 50,000 ground-truth
  ids), and both refuse a non-canonical map alike;
- ``prepare_imagenet`` extracts the reference's train and validation trees
  from tars the test writes;
- ``convert_tfrecords`` finds the reference's files in the reference's
  seed-42 order and writes shards whose records hold the reference's
  features (the bytes differ only in int64 packing and map order: the
  reference goes through ``tf.train.Example``), cleaning PNG and CMYK
  inputs as it does.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from distributeddeeplearning_tpu.data import class_index as r_ci
from distributeddeeplearning_tpu.data import convert_tfrecords as r_conv
from distributeddeeplearning_tpu.data import prepare_imagenet as r_prep
from distributeddeeplearning_tpu.data import val_maps as r_vm
from distributeddeeplearning_tpu_torch.data import _native as t_native
from distributeddeeplearning_tpu_torch.data import class_index as t_ci
from distributeddeeplearning_tpu_torch.data import convert_tfrecords as t_conv
from distributeddeeplearning_tpu_torch.data import prepare_imagenet as t_prep
from distributeddeeplearning_tpu_torch.data import val_maps as t_vm

WNIDS = ["n01440764", "n01443537", "n01484850"]


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_shipped_files_are_the_references():
    assert _sha(t_ci.shipped_class_index_path()) == _sha(r_ci.shipped_class_index_path())
    assert (_sha(t_ci.shipped_nounid_to_class_path())
            == _sha(r_ci.shipped_nounid_to_class_path()))
    idx = t_ci.load_class_index(t_ci.shipped_class_index_path())
    assert idx == r_ci.load_class_index(r_ci.shipped_class_index_path())
    mapping = t_ci.load_nounid_to_class(t_ci.shipped_nounid_to_class_path())
    assert t_ci.verify_class_index(idx, mapping, label_offset=0) == []
    assert t_ci.class_names(idx)[:2] == r_ci.class_names(idx)[:2] == [
        "tench", "goldfish"]


def test_class_index_equals_the_reference(tmp_path):
    train = tmp_path / "train"
    for w in WNIDS[::-1]:
        (train / w).mkdir(parents=True)
    (train / "README").write_text("x")
    for offset in (0, 1):
        ours = t_ci.build_nounid_to_class(train, label_offset=offset)
        assert ours == r_ci.build_nounid_to_class(train, label_offset=offset)
        t_ci.write_nounid_to_class(ours, tmp_path / "t.json")
        r_ci.write_nounid_to_class(ours, tmp_path / "r.json")
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "r.json").read_bytes()
    canon = {str(i): [w, f"class{i}"] for i, w in enumerate(WNIDS)}
    (tmp_path / "idx.json").write_text(json.dumps(canon))
    idx = t_ci.load_class_index(tmp_path / "idx.json")
    for mapping, offset in ((t_ci.build_nounid_to_class(train), 1),
                            (t_ci.build_nounid_to_class(train), 0),
                            ({WNIDS[0]: 1}, 1)):
        assert (t_ci.verify_class_index(idx, mapping, label_offset=offset)
                == r_ci.verify_class_index(idx, mapping, label_offset=offset))
    assert t_ci.verify_class_index(idx, t_ci.build_nounid_to_class(train), label_offset=0)
    with pytest.raises(FileNotFoundError):
        t_ci.list_wnids(tmp_path / "absent")


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    scipy_io = pytest.importorskip("scipy.io")
    path = str(tmp_path_factory.mktemp("devkit") / "ILSVRC2012_devkit_t12.tar.gz")
    wnids = [f"n{90000000 + i:08d}" for i in range(1, 6)]
    synsets = np.zeros((len(wnids), 1), dtype=[
        ("ILSVRC2012_ID", object), ("WNID", object), ("words", object)])
    for i, w in enumerate(wnids):
        synsets[i, 0] = (np.array([[i + 1]]), np.array([w]), np.array(["x"]))
    mat = io.BytesIO()
    scipy_io.savemat(mat, {"synsets": synsets})
    ids = [(i * 7) % 5 + 1 for i in range(t_vm.NUM_VAL_IMAGES)]
    gt = "\n".join(str(i) for i in ids).encode() + b"\n"
    with tarfile.open(path, "w:gz") as tar:
        for name, data in ((t_vm.DEVKIT_META, mat.getvalue()),
                           (t_vm.DEVKIT_GROUND_TRUTH, gt)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def test_val_maps_equal_the_reference(devkit, tmp_path):
    rows = t_vm.derive_val_maps(devkit)
    assert rows == r_vm.derive_val_maps(devkit)
    assert rows[0] == ("n90000001", "ILSVRC2012_val_00000001.JPEG")
    ours = t_vm.write_val_maps(rows, str(tmp_path / "t.csv"), verify=False)
    ref = r_vm.write_val_maps(rows, str(tmp_path / "r.csv"), verify=False)
    assert ours == ref
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()
    assert t_vm.EXPECTED_SHA256 == r_vm.EXPECTED_SHA256
    with pytest.raises(ValueError, match="sha256"):
        t_vm.write_val_maps(rows, str(tmp_path / "x.csv"))
    assert not (tmp_path / "x.csv").exists()
    assert t_prep.load_val_map(str(tmp_path / "t.csv")) == r_prep.load_val_map(
        str(tmp_path / "r.csv"))
    assert t_vm.ensure_val_maps(str(tmp_path / "nodevkit")) is None


def _tars(tmp_path):
    rng = np.random.default_rng(2)
    src = tmp_path / "src"
    inner = []
    for wnid in WNIDS[:2]:
        cdir = src / wnid
        cdir.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                cdir / f"{wnid}_{i}.JPEG")
        t = tmp_path / f"{wnid}.tar"
        with tarfile.open(t, "w") as tar:
            for f in sorted(cdir.iterdir()):
                tar.add(f, arcname=f.name)
        inner.append(t)
    train_tar = tmp_path / "train.tar"
    with tarfile.open(train_tar, "w") as tar:
        for t in inner:
            tar.add(t, arcname=t.name)
    vdir = tmp_path / "val_flat"
    vdir.mkdir()
    names = [f"ILSVRC2012_val_{i:08d}.JPEG" for i in range(1, 5)]
    for name in names:
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            vdir / name)
    val_tar = tmp_path / "val.tar"
    with tarfile.open(val_tar, "w") as tar:
        for name in names:
            tar.add(vdir / name, arcname=name)
    val_map = tmp_path / "val_map.csv"
    val_map.write_text("class,filename\n" + "".join(
        f"{WNIDS[i % 2]},{n}\n" for i, n in enumerate(names)))
    return train_tar, val_tar, val_map


def _tree(root):
    return sorted((str(p.relative_to(root)), hashlib.sha256(p.read_bytes()).hexdigest())
                  for p in root.rglob("*") if p.is_file())


def test_prepare_imagenet_equals_the_reference(tmp_path):
    train_tar, val_tar, val_map = _tars(tmp_path)
    for mod, out in ((t_prep, "t"), (r_prep, "r")):
        mod.prepare_imagenet(str(train_tar), str(val_tar), str(tmp_path / out),
                             str(val_map), check_sha1=False)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "r")
    assert len(_tree(tmp_path / "t")) == 8
    assert t_prep.sha1_of(str(train_tar)) == r_prep.sha1_of(str(train_tar))
    with pytest.raises(ValueError, match="checksum mismatch"):
        t_prep.verify_checksum(str(train_tar), "0" * 40)
    assert (t_prep.TRAIN_TAR_SHA1, t_prep.VAL_TAR_SHA1) == (r_prep.TRAIN_TAR_SHA1,
                                                            r_prep.VAL_TAR_SHA1)


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv")
    rng = np.random.default_rng(0)
    for wnid in WNIDS:
        d = root / wnid
        d.mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
                d / f"{wnid}_{i}.JPEG", quality=90)
    Image.fromarray(rng.integers(0, 255, (12, 14, 3), dtype=np.uint8)).save(
        root / WNIDS[0] / "extra.png")
    Image.fromarray(rng.integers(0, 255, (10, 10, 4), dtype=np.uint8),
                    "CMYK").save(root / WNIDS[1] / "cmyk.JPEG")
    return root


def _features(rec: bytes) -> dict:
    out = {}
    for key in ("image/encoded", "image/colorspace", "image/class/synset",
                "image/format", "image/filename"):
        out[key] = t_native.example_bytes(rec, key)
    for key in ("image/height", "image/width", "image/channels",
                "image/class/label"):
        out[key] = t_native.example_int64(rec, key)
    return out


def test_convert_tfrecords_equals_the_reference(image_tree, tmp_path):
    pytest.importorskip("tensorflow")
    found = t_conv.find_image_files(str(image_tree))
    assert found == r_conv.find_image_files(str(image_tree))
    assert len(found[0]) == 11
    for name, mod in (("t", t_conv), ("r", r_conv)):
        assert mod.convert_dataset(str(image_tree), str(tmp_path / name), "train",
                                   3, max_workers=2) == 11
    for i in range(3):
        shard = f"train-{i:05d}-of-00003"
        ours = list(t_native.RecordReader(tmp_path / "t" / shard))
        ref = list(t_native.RecordReader(tmp_path / "r" / shard))
        assert [_features(r) for r in ours] == [_features(r) for r in ref]
    rec = t_conv.make_example(b"\xff\xd8x", 3, "n1", "/a/b.JPEG", 5, 6)
    import tensorflow as tf

    assert tf.train.Example.FromString(rec) == r_conv.make_example(
        b"\xff\xd8x", 3, "n1", "/a/b.JPEG", 5, 6)
    for raw in ((image_tree / WNIDS[0] / "extra.png").read_bytes(),
                (image_tree / WNIDS[1] / "cmyk.JPEG").read_bytes(),
                (image_tree / WNIDS[2] / f"{WNIDS[2]}_0.JPEG").read_bytes()):
        assert t_conv.clean_image_bytes(raw) == r_conv.clean_image_bytes(raw)


def test_convert_imagenet_layout(image_tree, tmp_path):
    root = tmp_path / "imagenet"
    os.makedirs(root)
    for split in ("train", "validation"):
        os.symlink(image_tree, root / split)
    counts = t_conv.convert_imagenet(str(root), str(tmp_path / "out"),
                                     train_shards=2, validation_shards=1)
    assert counts == {"validation": 11, "train": 11}
    assert sorted(os.listdir(tmp_path / "out")) == [
        "train-00000-of-00002", "train-00001-of-00002", "validation-00000-of-00001"]

"""The port's ImageNet workload against the JAX package's, on the CPU.

- ``imagenet._batches`` yields the reference's batches bit for bit for
  synthetic data (train and eval), the native pipeline and the raw cache
  (each package building its own cache from its own copy of the shards),
  the last two through the C decoder and through the PIL branch a host
  without libjpeg takes;
- ``imagenet.main(device="cpu")`` trains resnet18 for 2 steps and
  evaluates over the raw cache, the native pipeline, the tf-recipe
  TFRecord pipeline and a class-directory tree; through ``python -m`` with
  the reference's flags it does so with neither jax nor tensorflow loaded;
- the port's counterpart of ref ``tests/test_convergence.py`` (the
  reference recipe on a 3-class solid-colour tree through the images
  pipeline, the same hyperparameters and global batch 16) clears the same
  band, top-1 >= 0.9;
- a raw-pipeline fit stopped at step 2 (its checkpoint) and resumed to
  step 4 ends with parameters and BatchNorm statistics bitwise equal to an
  unstopped 4-step fit: the cache's step-indexed factory replays nothing;
- unsupported combinations raise as the reference's do; ``num_slices=2``
  in one process raises the reference's mesh error (a data axis of one
  cannot span two slices).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.workloads import imagenet as r_imagenet
from distributeddeeplearning_tpu_torch.data import bench_data
from distributeddeeplearning_tpu_torch.train.state import tree_leaves
from distributeddeeplearning_tpu_torch.workloads import imagenet as t_imagenet
from _torch_decoders import assert_decoded_by, jpeg_decoder

torch.set_num_threads(2)  # the suite runs six workers on eight cores

REPO = Path(__file__).resolve().parent.parent
N_TRAIN, N_VAL, SIZE = 24, 12, 32
TINY = dict(model="resnet18", epochs=1, steps_per_epoch=2, batch_size=4,
            image_size=SIZE, num_classes=30, train_images=N_TRAIN,
            compute_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from distributeddeeplearning_tpu.data import _native_image as r_image
    from distributeddeeplearning_tpu_torch.data import _native_image as t_image

    t_image.native_available()  # built before any pool thread asks
    r_image.native_available()
    d = tmp_path_factory.mktemp("imagenet-shards")
    bench_data.generate_bench_shards(str(d), num_images=N_TRAIN, num_shards=2,
                                     seed=7)
    bench_data.generate_bench_shards(str(d), num_images=N_VAL, num_shards=2,
                                     seed=8, split="validation")
    return d


def _copy(shards, dest):
    shutil.copytree(shards, dest)
    return str(dest)


@pytest.mark.parametrize("data_format,pipeline,train,n,decoder", [
    ("synthetic", "tf", True, 5, None),
    ("synthetic", "tf", False, None, None),
    *((fmt, pipe, train, n, decoder) for decoder in ("c", "pil")
      for fmt, pipe, train, n in (("tfrecords", "native", True, 7),
                                  ("tfrecords", "native", False, None),
                                  ("tfrecords", "raw", True, 8),
                                  ("tfrecords", "raw", False, None))),
])
def test_batches_equal_the_reference(shards, tmp_path, data_format, pipeline,
                                     train, n, decoder):
    args = (True if train else False, 4, SIZE, 30, 3)
    kw = dict(synthetic_length=N_TRAIN, input_pipeline=pipeline)
    ours_dir = _copy(shards, tmp_path / "ours")
    ref_dir = _copy(shards, tmp_path / "ref")
    with jpeg_decoder(decoder) if decoder else contextlib.nullcontext() as counts:
        ours = t_imagenet._batches(data_format, ours_dir, *args, **kw)
        ref = r_imagenet._batches(data_format, ref_dir, *args, **kw)
        ours = list(ours if n is None else itertools.islice(ours, n))
        ref = list(ref if n is None else itertools.islice(ref, n))
    if decoder is not None:
        assert_decoded_by(counts, decoder)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_raw_batches_fast_forward(shards, tmp_path):
    d = _copy(shards, tmp_path / "ours")
    full = t_imagenet._batches("tfrecords", d, True, 4, SIZE, 30, 3,
                               input_pipeline="raw")
    want = list(itertools.islice(full, 9))[5:]
    ff = t_imagenet._batches("tfrecords", d, True, 4, SIZE, 30, 3,
                             input_pipeline="raw", start_batch=5)
    for a, b in zip(itertools.islice(ff, 4), want):
        np.testing.assert_array_equal(a["image"], b["image"])


@pytest.mark.parametrize("pipeline", ["raw", "native", "tf"])
def test_main_trains_and_evaluates_from_records(shards, tmp_path, pipeline):
    d = _copy(shards, tmp_path / "shards")
    state, result = t_imagenet.main(
        data_format="tfrecords", input_pipeline=pipeline, training_data_path=d,
        validation_data_path=d, tensorboard_dir=str(tmp_path / "tb"), **TINY)
    assert result.epochs_run == 1 and state.step == 2
    assert np.isfinite(result.final_train_metrics["loss"])
    assert result.final_eval_metrics and np.isfinite(
        result.final_eval_metrics["loss"])
    assert (tmp_path / "tb" / "scalars.jsonl").exists()


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """The 3-class solid-colour tree of ref ``tests/test_convergence.py``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    colors = ((220, 30, 30), (30, 220, 30), (30, 30, 220))
    for split in ("train", "validation"):
        for wnid, color in zip(("n01440764", "n01443537", "n01484850"), colors):
            d = root / split / wnid
            d.mkdir(parents=True)
            for i in range(8):
                base = np.tile(np.asarray(color, np.uint8), (96, 96, 1)).astype(np.int16)
                noise = rng.integers(-20, 20, base.shape, np.int16)
                Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8)).save(
                    d / f"img_{i}.JPEG", quality=95)
    return root


def test_main_trains_from_an_image_tree(image_tree):
    state, result = t_imagenet.main(
        data_format="images", training_data_path=str(image_tree / "train"),
        validation_data_path=str(image_tree / "validation"),
        **{**TINY, "num_classes": 4})
    assert state.step == 2 and np.isfinite(result.final_train_metrics["loss"])
    assert result.final_eval_metrics


def test_three_class_reference_recipe_converges(image_tree):
    """Ref ``tests/test_convergence.py`` on the port: the same tree,
    hyperparameters and global batch (2 a chip x 8 virtual chips there, 16
    on one device here)."""
    state, fit = t_imagenet.main(
        model="resnet18", data_format="images",
        training_data_path=str(image_tree / "train"),
        validation_data_path=str(image_tree / "validation"),
        epochs=6, batch_size=16, base_lr=0.004, warmup_epochs=1, image_size=64,
        num_classes=4, steps_per_epoch=3, train_images=24, seed=7,
        compute_dtype="float32", augment="reference", resume=False,
        distributed=False, device="cpu")
    assert fit.final_eval_metrics
    assert fit.final_eval_metrics["top1"] >= 0.9, fit.final_eval_metrics
    assert np.isfinite(fit.final_train_metrics["loss"])


def test_raw_fit_resumes_without_replay(shards, tmp_path):
    d = _copy(shards, tmp_path / "shards")
    kw = dict(TINY, data_format="tfrecords", input_pipeline="raw",
              training_data_path=d, validation_data_path=d)
    whole, _ = t_imagenet.main(**{**kw, "epochs": 2})
    ckpt = str(tmp_path / "ckpt")
    first, _ = t_imagenet.main(**kw, save_filepath=ckpt)
    assert first.step == 2
    resumed, result = t_imagenet.main(**{**kw, "epochs": 2}, save_filepath=ckpt)
    assert resumed.step == whole.step == 4 and result.epochs_run == 1
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.batch_stats), tree_leaves(whole.batch_stats)):
        assert torch.equal(a, b)


def test_python_m_runs_without_jax_or_tensorflow(shards, tmp_path):
    d = _copy(shards, tmp_path / "shards")
    flags = [f"--{k}={v}" for k, v in {**TINY, "data_format": "tfrecords",
                                       "training_data_path": d,
                                       "validation_data_path": d}.items()]
    code = (
        "import json, runpy, sys\n"
        "import torch; torch.set_num_threads(2)\n"
        f"sys.argv = ['imagenet'] + {flags!r}\n"
        "runpy.run_module('distributeddeeplearning_tpu_torch.workloads.imagenet',"
        " run_name='__main__')\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'tensorflow', 'distributeddeeplearning_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "epoch 1 validation" in out.stderr


def test_refusals(shards):
    # two slices of a data axis of one: the reference's mesh error
    with pytest.raises(ValueError, match="data axis 1 not divisible by num_slices 2"):
        t_imagenet.main(**TINY, num_slices=2)
    for bad in (dict(input_pipeline="native", data_format="images"),
                dict(input_pipeline="bogus", data_format="tfrecords")):
        with pytest.raises(ValueError):
            t_imagenet._batches(bad["data_format"], str(shards), True, 4, SIZE, 30,
                                0, input_pipeline=bad["input_pipeline"])
    with pytest.raises(ValueError, match="augment"):
        t_imagenet._batches("tfrecords", str(shards), True, 4, SIZE, 30, 0,
                            input_pipeline="raw", augment="inception")
    with pytest.raises(ValueError, match="unknown data_format"):
        t_imagenet._batches("lmdb", str(shards), True, 4, SIZE, 30, 0)
    with pytest.raises(ValueError, match="InceptionV3"):
        t_imagenet.main(**TINY, aux_logits=True)

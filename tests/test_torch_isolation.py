"""The port stands alone: it imports neither jax, nor tensorflow, nor
anything of the JAX package, runs on the card unless asked for the CPU,
and never counts a plain-version call as a kernel launch.

Import checks run in a fresh interpreter, because this test process has
jax loaded (``tests/conftest.py``).  Module names are compared by whole
dotted components: ``distributeddeeplearning_tpu_torch`` starts with the
string ``distributeddeeplearning_tpu`` but is not part of that package.
"""

from __future__ import annotations

import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import distributeddeeplearning_tpu_torch as port
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
from distributeddeeplearning_tpu_torch.ops import flash_decode as fd
from distributeddeeplearning_tpu_torch.serve import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    PagedInferenceEngine,
    Request,
)
from distributeddeeplearning_tpu_torch.spec import SpeculativeDecoder

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN_ROOTS = ("jax", "jaxlib", "tensorflow", "distributeddeeplearning_tpu")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_and_the_smoke_script_import_without_jax():
    modules = _port_modules()
    assert len(modules) >= 42, modules
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=240, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"the port pulled in {bad[:10]}"
    for name in ("serve.scheduler", "serve.kv_cache", "serve.kv_tier",
                 "serve.traffic", "serve.fleet", "obs.fleet", "obs.ledger",
                 "quant.qtensor",
                 "quant.calibrate", "spec", "spec.drafter", "spec.decode",
                 "train.schedule", "train.state",
                 "train.step", "train.loop", "workloads.transformer",
                 "data", "data.synthetic", "models.bert", "workloads.bert",
                 "models.resnet", "models.inception", "models.vgg",
                 "models._convnet", "train.benchmark", "workloads.benchmark",
                 "workloads._runner", "train.checkpoint", "train.resilience",
                 "utils.faults", "utils.prefetch", "utils.retry",
                 "utils.throughput", "obs.goodput", "obs.trace", "obs.recorder",
                 "data._native_build", "data._native", "data._native_image",
                 "data.proto", "data.preprocessing", "data.tfrecords",
                 "data.images", "data.native_pipeline", "data.raw_cache",
                 "data.class_index", "data.val_maps", "data.prepare_imagenet",
                 "data.convert_tfrecords", "data.bench_data",
                 "workloads.imagenet",
                 "obs.registry", "parallel", "parallel.mesh",
                 "parallel.distributed", "parallel.collectives",
                 "parallel.sharding", "parallel.comms", "utils",
                 "utils.hardware", "utils.timer", "utils.metrics",
                 "utils.logging_utils", "utils.roofline", "obs.attrib",
                 "obs.profile", "obs.schema", "obs.history"):
        assert f"distributeddeeplearning_tpu_torch.{name}" in loaded, name


def test_serve_and_obs_packages_load_no_jax():
    """``import distributeddeeplearning_tpu_torch.serve, .obs`` alone (the
    scheduler, the host tier, the traffic generator, the fleet and the
    ledger), ``obs.fleet`` and ``obs.attrib``, ``obs.profile``,
    ``obs.schema`` and ``obs.history`` load no jax and nothing of the JAX
    package."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import distributeddeeplearning_tpu_torch.serve\n"
        "import distributeddeeplearning_tpu_torch.obs\n"
        "from distributeddeeplearning_tpu_torch.serve import (HostPageTier,\n"
        "    TrafficGenerator, poll_source)\n"
        "from distributeddeeplearning_tpu_torch.obs import HBMLedger, get_ledger\n"
        "from distributeddeeplearning_tpu_torch.serve import FleetRouter, serve_fleet\n"
        "import distributeddeeplearning_tpu_torch.obs.fleet\n"
        "import distributeddeeplearning_tpu_torch.obs.attrib\n"
        "import distributeddeeplearning_tpu_torch.obs.profile\n"
        "import distributeddeeplearning_tpu_torch.obs.schema\n"
        "import distributeddeeplearning_tpu_torch.obs.history\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=240, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"serve/obs pulled in {bad[:10]}"
    for name in ("serve.kv_tier", "serve.traffic", "serve.fleet", "obs.fleet",
                 "obs.ledger", "obs.attrib", "obs.profile", "obs.schema",
                 "obs.history"):
        assert f"distributeddeeplearning_tpu_torch.{name}" in loaded, name


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = dict(num_layers=1, d_model=8, num_heads=2, d_ff=16, vocab_size=11,
               max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.init_params(**cfg)
    params = tpt.init_params(device="cpu", **cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(params, num_heads=2, batch_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.resolve_device()
    InferenceEngine(params, num_heads=2, batch_slots=1, max_seq=8, device="cpu")


def test_bert_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from distributeddeeplearning_tpu_torch.models import bert
    from distributeddeeplearning_tpu_torch.workloads import bert as bert_workload

    cfg = bert.BertConfig(num_layers=1, hidden_size=16, num_heads=2,
                          intermediate_size=32, vocab_size=11,
                          max_position_embeddings=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert_workload.main(epochs=1, train_examples=2, batch_size=2, seq_len=8,
                           num_layers=1, hidden_size=16, num_heads=2,
                           intermediate_size=32, vocab_size=11,
                           max_position_embeddings=8)
    assert bert.init_params(cfg, device="cpu")["head"]["kernel"].device.type == "cpu"


def test_image_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.state import (
        create_train_state,
        sgd_momentum,
    )
    from distributeddeeplearning_tpu_torch.workloads import benchmark

    model = get_model("resnet18", num_classes=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(input_shape=(1, 32, 32, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(None, model, (1, 32, 32, 3), sgd_momentum(lambda s: 0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        benchmark.main(model="resnet18", batch_size=2, image_size=32, num_classes=3,
                       num_iters=1, num_batches_per_iter=1, num_warmup_batches=0)
    from distributeddeeplearning_tpu_torch.workloads import imagenet

    with pytest.raises(RuntimeError, match="device='cpu'"):
        imagenet.main(model="resnet18", batch_size=2, image_size=32, num_classes=3,
                      epochs=1, steps_per_epoch=1)
    v = model.init(input_shape=(1, 32, 32, 3), device="cpu")
    assert v["params"]["head"]["kernel"].device.type == "cpu"


def test_data_parallel_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """``parallel.initialize`` resolves the entry point's device (cuda by
    default, raising without a card) and chooses the backend from it: gloo
    on the CPU; the switch on without a rendezvous raises instead of
    running alone."""
    from distributeddeeplearning_tpu_torch.parallel import distributed

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    for name in ("DISTRIBUTED", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize()
    ctx = distributed.initialize(device="cpu")
    assert (ctx.process_count, ctx.distributed, ctx.backend) == (1, False, None)
    assert ctx.device.type == "cpu" and ctx.is_primary
    monkeypatch.setenv("DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize(device="cpu")
    assert distributed.process_count() == 1 and distributed.is_primary()


def test_cpu_serving_leaves_the_launch_counters_at_zero():
    cfg = dict(num_layers=2, d_model=16, num_heads=2, d_ff=32, vocab_size=23,
               max_len=16)
    params = tpt.init_params(device="cpu", **cfg)
    engine = InferenceEngine(params, num_heads=2, batch_slots=2, max_seq=16,
                             device="cpu")
    paged = PagedInferenceEngine(params, num_heads=2, batch_slots=2,
                                 max_seq=16, page_size=4, prefill_chunk=4,
                                 cache_dtype="int8", device="cpu")
    spec_dense = InferenceEngine(params, num_heads=2, batch_slots=2,
                                 max_seq=16, device="cpu")
    spec_paged = PagedInferenceEngine(params, num_heads=2, batch_slots=2,
                                      max_seq=16, page_size=4, prefill_chunk=4,
                                      device="cpu")
    fa.launches = 0
    fd.launches = fd.launches_int8 = fd.launches_multi_query = 0
    fd.launches_verify = 0
    rng = np.random.default_rng(0)
    for eng, drafter in ((engine, None), (paged, None), (spec_dense, "truncated"),
                         (spec_paged, "int8")):
        sd = (SpeculativeDecoder(eng, drafter=drafter, draft_tokens=2,
                                 draft_layers=1) if drafter else None)
        results, rep = ContinuousBatchingScheduler(
            eng, max_new_tokens=3, spec_decoder=sd).run(
            [Request(uid=str(i), prompt=rng.integers(1, 23, 5).tolist())
             for i in range(3)])
        assert [len(r.tokens) for r in results] == [3, 3, 3]
        assert rep.speculative == (sd is not None)
    assert (fa.launches, fd.launches, fd.launches_int8,
            fd.launches_multi_query, fd.launches_verify) == (0, 0, 0, 0, 0)


def test_smoke_script_fails_without_a_card_or_without_the_repo(tmp_path):
    """Alone in a directory, or on a machine without a card, the smoke
    script exits nonzero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [tmp_path / "chip_smoke.py"]
    if not torch.cuda.is_available():
        runs.append(REPO / "chip_smoke.py")
    for script in runs:
        proc = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            cwd=script.parent, timeout=240,
        )
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout

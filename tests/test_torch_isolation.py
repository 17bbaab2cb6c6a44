"""The port stands alone: it imports neither jax nor anything of the JAX
package, runs on the card unless asked for the CPU, and never counts a
plain-version call as a kernel launch.

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
    Request,
)

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN_ROOTS = ("jax", "jaxlib", "distributeddeeplearning_tpu")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_and_the_smoke_script_import_without_jax():
    modules = _port_modules()
    assert len(modules) >= 19, modules
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
    for name in ("serve.scheduler", "train.schedule", "train.state",
                 "train.step", "train.loop", "workloads.transformer"):
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


def test_cpu_serving_leaves_the_launch_counters_at_zero():
    cfg = dict(num_layers=2, d_model=16, num_heads=2, d_ff=32, vocab_size=23,
               max_len=16)
    params = tpt.init_params(device="cpu", **cfg)
    engine = InferenceEngine(params, num_heads=2, batch_slots=2, max_seq=16,
                             device="cpu")
    fa.launches = 0
    fd.launches = 0
    rng = np.random.default_rng(0)
    results, _ = ContinuousBatchingScheduler(engine, max_new_tokens=3).run(
        [Request(uid=str(i), prompt=rng.integers(1, 23, 5).tolist())
         for i in range(3)])
    assert [len(r.tokens) for r in results] == [3, 3, 3]
    assert (fa.launches, fd.launches) == (0, 0)


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

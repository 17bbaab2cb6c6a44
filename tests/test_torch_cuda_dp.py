"""Data parallelism on the card: 2 gloo ranks sharing its device 0 against
the one-process implicit fit of the same global batches (run with
``python -m pytest --noconftest tests/test_torch_cuda_dp.py``; skips
without a card).

A tiny causal LM (1 layer, d 16, 2 heads of 8, vocabulary 37, 16 rows of 64
tokens) in bf16 with the flash kernels, AdamW without a clip, 3 steps:
through the implicit step, the ``comm_overlap`` step on the f32 wire, and
the bf16 wire with weight-update sharding.  Each rank launches K1-K3 at
its 8 rows; losses within 1e-2 relative of the one-process fit's (another
summation order of the gradient moves bf16-compute params by a fraction of
a step) and params within twice the summed learning rates (an AdamW
element moves at most ~lr a step), the median element within 1e-2 of it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_dp

pytestmark = pytest.mark.cuda

STEPS, ROWS, SEQ = 3, 16, 64
CASES = {"implicit": {}, "f32-wire": {"comm_overlap": True},
         "bf16-wire-wus": {"comm_overlap": True, "comm_dtype": "bf16",
                           "weight_update_sharding": True}}


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt

    params = tpt.init_params(torch.Generator().manual_seed(0), max_len=SEQ,
                             device="cpu", **_torch_dp.LM)
    params_np = {k: (v.numpy() if not isinstance(v, dict) else
                     {kk: vv.numpy() for kk, vv in v.items()})
                 for k, v in params.items()}
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        t = rng.integers(0, _torch_dp.LM["vocab_size"], (ROWS, SEQ)).astype(np.int32)
        batches.append({"input": t, "label": t})
    alone = _torch_dp.card_lm_fit(0, 0, params_np, batches, {})
    return params_np, batches, alone


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", list(CASES))
def test_two_gloo_ranks_on_the_card_match_the_one_process_fit(setup, case):
    params_np, batches, alone = setup
    ranks = _torch_dp.run_ranks(_torch_dp.card_lm_fit, 2, params_np, batches,
                                CASES[case], timeout=240)
    lr_sum = _torch_dp.LM_LR * STEPS
    for got in ranks:
        assert got["launches"] == [_torch_dp.LM["num_layers"] * STEPS] * 3
        np.testing.assert_allclose(got["losses"], alone["losses"], rtol=1e-2)
        gaps = np.concatenate([np.abs(got["params"][k] - v).reshape(-1)
                               for k, v in alone["params"].items()])
        assert gaps.max() <= 2 * lr_sum
        assert np.median(gaps) <= 1e-2 * lr_sum
    for key, leaf in ranks[0]["params"].items():
        assert leaf.tobytes() == ranks[1]["params"][key].tobytes(), key

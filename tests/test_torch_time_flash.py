"""``scripts/time_flash.py`` times bf16 K1 at the shapes that ``chip_smoke.py``
reports for it: the LM training step, the serving prompt pass, BERT at its
timed shape, the default geometries' head dims; and bf16 and f32 K2/K3 at
the same shapes but the prompt pass (which takes no gradient).  Both
scripts need a card to run; these checks read their shape tables only, on
the CPU."""

from __future__ import annotations

import importlib.util
import pathlib

import pytest
import torch

import chip_smoke as cs

_PATH = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "time_flash.py"
_spec = importlib.util.spec_from_file_location("time_flash", _PATH)
tf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tf)


@pytest.fixture(autouse=True)
def h100_peaks():
    """The bounds are the H100 SXM's: ``chip_smoke.py`` reads the card's
    peaks from ``utils/hardware.PEAKS`` at run time (``set_peaks``)."""
    cs.set_peaks(torch, "NVIDIA H100 80GB HBM3")
    yield
    cs.HBM_BYTES_PER_S = cs.F32_FLOPS_PER_S = cs.BF16_FLOPS_PER_S = None
    cs.TF32_FLOPS_PER_S = cs.TF32X3_FLOPS_PER_S = None


def test_training_row_is_the_training_cell():
    t = cs.TRAIN
    assert tf.K1_ROWS["train"] == (t["batch_size"], t["num_heads"], t["seq_len"],
                                   t["d_model"] // t["num_heads"], True, False)
    assert (tf.B, tf.H, tf.S, tf.D) == tf.K1_ROWS["train"][:4]


def test_serving_and_bert_rows_are_the_smoke_scripts_timed_shapes():
    # bf16 serving prefill: one request of the largest prompt bucket
    # (phase_k1_bf16's timed(1, 512)) at the serve model's heads
    heads = cs.SERVE["num_heads"]
    assert tf.K1_ROWS["prefill"] == (1, heads, 512, cs.SERVE["d_model"] // heads,
                                     True, False)
    bt = cs.BIAS_TIMED
    assert tf.K1_ROWS["bias512"] == (bt["b"], bt["h"], bt["s"], bt["d"], False, True)
    # BERT's default sequence, the same batch and heads
    assert tf.K1_ROWS["bias128"] == (cs.BERT_RUN["batch_size"], bt["h"], 128,
                                     bt["d"], False, True)


def test_head_dim_rows_follow_the_smoke_scripts_geometry():
    for d, (h, b, s) in cs.HEADDIM_GEOMETRY.items():
        assert tf.K1_ROWS[f"d{d}"] == (b, h, s, d, True, False)
    assert set(tf.K1_ROWS) == {"train", "prefill", "bias512", "bias128",
                               *(f"d{d}" for d in cs.HEADDIM_GEOMETRY)}


def test_backward_rows_are_the_forward_rows_that_take_a_gradient():
    # the training step, BERT fine-tuning at seq 512 and 128, and the LM
    # workload at head dims 16 and 32 run the backward; serving prefill
    # does not
    assert set(tf.BWD_ROWS) == set(tf.K1_ROWS) - {"prefill"}
    for name, row in tf.BWD_ROWS.items():
        assert row == tf.K1_ROWS[name]
    bt = cs.BIAS_TIMED
    assert tf.BWD_ROWS["bias512"][:4] == (bt["b"], bt["h"], bt["s"], bt["d"])
    t = cs.TRAIN
    assert tf.BWD_ROWS["train"][:4] == (t["batch_size"], t["num_heads"], t["seq_len"],
                                        t["d_model"] // t["num_heads"])


def test_backward_rows_cover_the_f32_cells_and_head_dim_8():
    # the backward rows, timed in bf16 and f32: the training cell (train),
    # BERT at seq 512 and 128 with the key-padding bias, and the head dims
    # 8 (bench.py --small), 16 and 32
    assert set(tf.BWD_ROWS) == {"train", "bias512", "bias128", "d8", "d16", "d32"}
    assert tf.BWD_ROWS["d8"] == (*(cs.HEADDIM_GEOMETRY[8][i] for i in (1, 0, 2)),
                                 8, True, False)
    assert [row[5] for row in tf.BWD_ROWS.values()].count(True) == 2
    # the bounds of the f32 rows are at the split-TF32 rate: a third of the
    # dense TF32 peak, 2.5x the f32 FMA rate of the CUDA cores
    assert cs.TF32X3_FLOPS_PER_S == cs.TF32_FLOPS_PER_S / 3
    assert 2.4 < cs.TF32X3_FLOPS_PER_S / cs.F32_FLOPS_PER_S < 2.5
    t = cs.TRAIN
    b, h, s, d = t["batch_size"], t["num_heads"], t["seq_len"], t["d_model"] // t["num_heads"]
    pairs = b * h * cs._causal_pairs(s)
    head = 4.0 * b * s * h * d
    rows_in = 4 * head + 2 * 4.0 * b * h * s
    dq, by = cs.bound_ms(rows_in + head, 6.0 * d * pairs, cs.TF32X3_FLOPS_PER_S)
    dkv, _ = cs.bound_ms(rows_in + 2 * head, 8.0 * d * pairs, cs.TF32X3_FLOPS_PER_S)
    assert by == "operations"
    assert abs(dq - 0.469) < 5e-4 and abs(dkv - 0.6253) < 5e-4


def test_f32_forward_bounds_at_the_training_shape():
    # the f32 K1 rows (``--only f32_k1``) take the forward rows; their bound
    # is at the split-TF32 rate of the kernel's route (4 D flops a visible
    # pair), with the f32 FMA rate of the CUDA cores beside it
    t = cs.TRAIN
    b, h, s, d = t["batch_size"], t["num_heads"], t["seq_len"], t["d_model"] // t["num_heads"]
    assert tf.K1_ROWS["train"][:4] == (b, h, s, d)
    flops = 4.0 * d * b * h * cs._causal_pairs(s)
    assert abs(flops - 5.157e10) < 1e7
    nbytes = 4.0 * 4 * b * s * h * d + 4.0 * b * h * s
    split, by = cs.bound_ms(nbytes, flops, cs.TF32X3_FLOPS_PER_S)
    fma, fma_by = cs.bound_ms(nbytes, flops)
    assert by == fma_by == "operations"
    assert abs(split - 0.3128) < 5e-4 and abs(fma - 0.7697) < 5e-4

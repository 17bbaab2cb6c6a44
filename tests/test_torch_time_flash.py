"""``scripts/time_flash.py`` times bf16 K1 at the shapes that ``chip_smoke.py``
reports for it: the LM training step, the serving prompt pass, BERT at its
timed shape, the default geometries' head dims; and bf16 K2/K3 at the same
shapes but the prompt pass (which takes no gradient).  Both scripts need a
card to run; these checks read their shape tables only, on the CPU."""

from __future__ import annotations

import importlib.util
import pathlib

import chip_smoke as cs

_PATH = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "time_flash.py"
_spec = importlib.util.spec_from_file_location("time_flash", _PATH)
tf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tf)


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

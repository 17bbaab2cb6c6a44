"""The port's checkpointer, retry policy and resumable trainer, on the CPU.

The format is the port's own (``train/checkpoint.py``); what is held to
the reference is its contract: bitwise round trips of whole train states
(AdamW BERT, SGD momentum + BatchNorm ResNet), ``max_to_keep``, atomic
manifests committed only after the data landed, a private snapshot taken
before ``save`` returns, fallback past each corruption mode to the newest
verified generation, an error when none verifies, a params-only read that
never evicts, mid-epoch resume through a step-indexed factory that is
bit-identical to an uninterrupted fit, and the ``params`` item's manifest
entries (keys, shapes, dtypes, CRC32s) equal to the reference's
``build_manifest`` on the same weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.train import checkpoint as jckpt
from distributeddeeplearning_tpu_torch.data import synthetic as tsynth
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.train import checkpoint as tckpt
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.utils import retry as tretry
from distributeddeeplearning_tpu_torch.workloads import transformer as ttw

torch.set_num_threads(2)  # the suite runs six workers on eight cores

SEQ, BATCH = 16, 4
CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position_embeddings=SEQ, num_classes=3,
           dropout_rate=0.1)


def _bert_apply(cfg):
    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return tbert.forward(p, ids, config=cfg, dtype=torch.float32, train=train,
                             attention_mask=attention_mask,
                             token_type_ids=token_type_ids, generator=generator)
    return apply_fn


def _bert_state(seed=0, **kw):
    cfg = dataclasses.replace(tbert.BERT_BASE, **{**CFG, **kw})
    params = tbert.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return tstate.TrainState.create(
        params=params, apply_fn=_bert_apply(cfg),
        tx=tstate.adamw(tsched.warmup_linear_decay_schedule(1e-3, 16)))


def _text_batches(n, seed=1, start=0):
    """Batch ``start`` onwards of a fixed synthetic text stream."""
    ds = tsynth.SyntheticTextDataset(length=BATCH * n, seq_len=SEQ,
                                     vocab_size=CFG["vocab_size"],
                                     num_classes=CFG["num_classes"], seed=seed)
    return iter(list(ds.batches(BATCH))[start:])


def _trained_bert(steps=2):
    st = _bert_state()
    step = tstep.build_train_step(st, compute_dtype=torch.float32, rng=7)
    for batch in _text_batches(steps):
        st, _ = step(st, batch)
    return st


def _resnet_state(seed=0):
    model = get_model("resnet18", num_classes=5, dtype=torch.float32)
    return tstate.create_train_state(
        torch.Generator().manual_seed(seed), model, (1, 32, 32, 3),
        tstate.sgd_momentum(tsched.constant_schedule(0.1)), device="cpu")


def _trained_resnet():
    st = _resnet_state()
    step = tstep.build_train_step(st, compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    for _ in range(2):
        st, _ = step(st, {"image": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                          "label": rng.integers(0, 5, 4)})
    return st


def _leaves(st):
    return tckpt.flatten(tckpt.Checkpointer._state_items(st))


def _assert_same_state(a, b):
    assert a.step == b.step
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


@pytest.mark.parametrize("kind", ["adamw_bert", "sgd_batchnorm_resnet"])
def test_round_trip_is_bitwise(tmp_path, kind):
    trained, fresh = ((_trained_bert(), _bert_state(seed=5)) if kind == "adamw_bert"
                      else (_trained_resnet(), _resnet_state(seed=5)))
    ckpt = tckpt.Checkpointer(str(tmp_path / "d"))
    assert ckpt.save(trained.step, trained)
    ckpt.wait()
    restored, step = tckpt.Checkpointer(str(tmp_path / "d")).restore(fresh)
    assert restored is fresh and step == trained.step == 2
    _assert_same_state(restored, trained)
    if kind == "sgd_batchnorm_resnet":
        assert tstate.tree_leaves(restored.batch_stats)
        kernel = restored.params["stem_conv"]["Conv_0"]["kernel"]
        assert kernel.is_contiguous(memory_format=torch.channels_last)
    assert all(t.requires_grad for t in tstate.tree_leaves(restored.params))


def test_restore_of_an_empty_dir_returns_the_template(tmp_path):
    st = _bert_state()
    got, step = tckpt.Checkpointer(str(tmp_path / "e")).restore(st)
    assert got is st and step is None
    assert tckpt.Checkpointer(str(tmp_path / "e")).restore_params() == (None, None)


def test_max_to_keep_and_the_save_policy(tmp_path):
    st = _bert_state()
    ckpt = tckpt.Checkpointer(str(tmp_path / "d"), max_to_keep=2)
    for i in range(1, 5):
        assert ckpt.save(i, st)
    assert not ckpt.save(4, st) and not ckpt.save(3, st)  # at or below the newest
    ckpt.wait()
    assert ckpt.latest_step() == 4 and ckpt.all_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "d").iterdir()) == [
        "3", "4", tckpt.DURABLE_MARKER]


def test_manifest_commits_only_after_wait_and_is_atomic(tmp_path):
    st = _bert_state()
    d = tmp_path / "d"
    ckpt = tckpt.Checkpointer(str(d))
    ckpt.save(1, st)
    assert tckpt.load_manifest(d / "1") is None
    assert tckpt.latest_verified_step_in_dir(d) is None
    assert ckpt.latest_verified_step() is None
    ckpt.wait()
    manifest = json.loads((d / "1" / tckpt.MANIFEST_NAME).read_text())
    assert manifest["step"] == 1 and manifest["items"] == ["params", "state"]
    assert manifest["leaves"]["state/['step']"]["dtype"] == "int32"
    assert "params/['layer0']['mlp_in']['kernel']" in manifest["leaves"]
    assert ckpt.latest_verified_step() == tckpt.latest_verified_step_in_dir(d) == 1
    leftovers = [p for p in d.rglob("*") if ".tmp" in p.name]
    assert not leftovers
    assert (d / tckpt.DURABLE_MARKER).exists()
    # a second save commits the first generation's manifest before it writes
    ckpt.save(2, st)
    assert tckpt.load_manifest(d / "2") is None
    ckpt.close()
    assert tckpt.load_manifest(d / "2") is not None


def test_a_save_followed_by_an_in_place_update_writes_the_saved_step(tmp_path):
    """The port's optimizers update params in place: ``save`` must hand the
    writer a private copy, or the generation would hold a later step."""
    st = _trained_bert(1)
    saved = _params(st.params)
    ckpt = tckpt.Checkpointer(str(tmp_path / "d"))
    ckpt.save(1, st)
    with torch.no_grad():
        for t in tstate.tree_leaves(st.params):
            t.add_(1.0)
    ckpt.wait()
    params, step = ckpt.restore_params()
    assert step == 1
    _assert_same_params(params, saved)


def _params(tree):
    """{keystr: a copy} of every leaf."""
    return {k: t.detach().clone() for k, t in tckpt.flatten(tree)}


def _assert_same_params(tree, want):
    got = _params(tree)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k


def _flip_params(step_dir):
    """One flipped byte in the middle of the ``params`` item's data."""
    path = step_dir / "params" / tckpt.DATA_NAME
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))


def _two_generations(tmp_path):
    ckpt = tckpt.Checkpointer(str(tmp_path / "d"))
    first = _trained_bert(1)
    ckpt.save(1, first)
    ckpt.wait()
    want = _params(first.params)
    second = _trained_bert(2)
    ckpt.save(2, second)
    ckpt.wait()
    return ckpt, want


@pytest.mark.parametrize("mode", tckpt.CORRUPT_MODES)
def test_a_corrupt_newest_generation_falls_back(tmp_path, mode):
    ckpt, want = _two_generations(tmp_path)
    what = tckpt.corrupt_generation(tmp_path / "d" / "2", mode)
    assert what
    st, step = ckpt.restore(_bert_state(seed=3))
    assert step == 1 and st.step == 1
    _assert_same_params(st.params, want)
    assert not (tmp_path / "d" / "2").exists()  # evicted ...
    assert ckpt.save(2, _trained_bert(2))  # ... so its step saves again
    ckpt.wait()
    assert ckpt.restore(_bert_state())[1] == 2


def test_restore_params_falls_back_and_never_evicts(tmp_path):
    ckpt, want = _two_generations(tmp_path)
    _flip_params(tmp_path / "d" / "2")
    params, step = ckpt.restore_params()
    assert step == 1 and (tmp_path / "d" / "2").exists()
    _assert_same_params(params, want)
    assert ckpt.latest_verified_step() == 2  # a manifest-level probe
    # the largest data file is the AdamW state's: restore_params reads the
    # params item alone and takes a generation whose state is corrupt
    tckpt.corrupt_generation(tmp_path / "d" / "1", "flip")
    _flip_params(tmp_path / "d" / "2")  # flipped back
    assert ckpt.restore_params()[1] == 2


def test_every_generation_corrupt_raises(tmp_path):
    ckpt, _ = _two_generations(tmp_path)
    for step in (1, 2):
        tckpt.corrupt_generation(tmp_path / "d" / str(step), "flip")
        _flip_params(tmp_path / "d" / str(step))
    with pytest.raises(tckpt.CheckpointCorruptionError):
        ckpt.restore_params()
    with pytest.raises(tckpt.CheckpointCorruptionError):
        ckpt.restore(_bert_state())
    with pytest.raises(ValueError, match="unknown corruption mode"):
        tckpt.corrupt_generation(tmp_path / "d", "melt")


def test_a_template_of_another_model_does_not_take_the_generation(tmp_path):
    ckpt = tckpt.Checkpointer(str(tmp_path / "d"))
    ckpt.save(1, _bert_state())
    ckpt.wait()
    with pytest.raises(tckpt.CheckpointCorruptionError):
        ckpt.restore(_bert_state(hidden_size=64), evict_failed=False)
    assert (tmp_path / "d" / "1").exists()


def test_params_manifest_equals_the_reference_build_manifest():
    """Keys (``params['layer0']...``), shapes, dtypes and CRC32s of the
    ``params`` item equal the reference's on the same BERT weights."""
    cfg = dataclasses.replace(jbert.BERT_BASE, **CFG)
    v = jbert.BertEncoder(config=cfg, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32), train=False)
    jparams = jax.tree.map(np.asarray, nn.meta.unbox(v)["params"])
    want = jckpt.build_manifest(3, {"params": jparams})["leaves"]
    got = tckpt.build_manifest(3, {"params": tbert.params_from_numpy(
        jparams, device="cpu")})["leaves"]
    assert len(got) == len(want) == 4 + 2 * 16 + 4
    assert got == want
    # bf16 leaves hash as their raw 2-byte words, as ml_dtypes' bf16 does
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jparams)
    want = jckpt.build_manifest(3, {"params": bf})["leaves"]
    got = tckpt.build_manifest(3, {"params": tbert.params_from_numpy(
        bf, device="cpu")})["leaves"]
    assert got == want


# ---- resume through the trainer ----------------------------------------------

SPE, EPOCHS = 4, 2


def _fit(tmp_path, *, crash_at=None, every=3, resume=True):
    """A BERT fit of EPOCHS x SPE steps through the step-indexed factory,
    recording each step's loss; ``crash_at`` makes the stream raise before
    that true step's batch."""
    st = _bert_state()
    step = tstep.build_train_step(st, compute_dtype=torch.float32, rng=11)
    losses = {}

    def recording(state, batch):
        state, m = step(state, batch)
        losses[state.step] = float(m["loss"])
        return state, m

    def factory(start):
        for i, batch in enumerate(_text_batches(SPE * EPOCHS, start=start)):
            if crash_at is not None and start + i + 1 == crash_at:
                raise RuntimeError("stream died")
            yield batch

    trainer = tloop.Trainer(recording, config=tloop.TrainerConfig(
        epochs=EPOCHS, steps_per_epoch=SPE, global_batch_size=BATCH,
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every_steps=every,
        resume=resume, max_to_keep=3))
    st, result = trainer.fit(st, factory)
    return st, result, losses


def test_mid_epoch_resume_is_bit_identical_to_an_uninterrupted_fit(tmp_path):
    """Dropout 0.1, AdamW: 8 steps straight, against 5 steps that die at the
    6th batch (generations at steps 3 and 4, the epoch end) and a fresh
    state, trainer and checkpointer that resume from step 4 and run 5..8."""
    straight, result, losses = _fit(tmp_path / "a")
    assert result.epochs_run == EPOCHS and sorted(losses) == list(range(1, 9))
    with pytest.raises(RuntimeError, match="stream died"):
        _fit(tmp_path / "b", crash_at=6)
    assert tckpt.Checkpointer(str(tmp_path / "b" / "ckpt")).all_steps() == [3, 4]
    assert tckpt.latest_verified_step_in_dir(tmp_path / "b" / "ckpt") == 4
    resumed, _, tail = _fit(tmp_path / "b")
    assert sorted(tail) == [5, 6, 7, 8]
    for k in tail:
        assert tail[k] == losses[k], k
    _assert_same_state(resumed, straight)


def test_resume_false_starts_over_and_the_fit_saves_each_epoch_end(tmp_path):
    _fit(tmp_path, every=None)
    assert tckpt.Checkpointer(str(tmp_path / "ckpt")).all_steps() == [4, 8]
    st, _, losses = _fit(tmp_path, every=None, resume=False)
    assert sorted(losses) == list(range(1, 9))


def test_a_finished_run_resumes_to_nothing_left(tmp_path):
    straight, _, _ = _fit(tmp_path)
    again, result, losses = _fit(tmp_path)
    assert losses == {} and result.total_images == 0
    _assert_same_state(again, straight)


@pytest.mark.parametrize("field,value", [
    ("tensorboard_dir", "tb"), ("profile_dir", "prof"), ("preemption_guard", True),
    ("anomaly_max_consecutive", 2), ("anomaly_rollback", True),
    ("step_deadline_s", 1.0), ("obs_metrics_path", "m"), ("goodput_path", "g")])
def test_the_trainer_refuses_a4s_remainder(tmp_path, field, value):
    """The fields the trainer held back until the resilience layer came
    are taken now: a one-step fit runs with each, and a path field leaves
    its file or directory."""
    if isinstance(value, str):
        value = str(tmp_path / value)
    st = _bert_state()
    step = tstep.build_train_step(st, compute_dtype=torch.float32,
                                  skip_nonfinite=True)
    trainer = tloop.Trainer(step, config=tloop.TrainerConfig(
        epochs=1, steps_per_epoch=1, global_batch_size=BATCH, **{field: value}))
    st, result = trainer.fit(st, _text_batches(1))
    assert st.step == 1 and result.total_images == BATCH
    if isinstance(value, str):
        assert os.path.exists(value), field


def test_the_lm_workload_checkpoints_and_resumes(tmp_path):
    """``save_filepath`` through the transformer workload: a second run
    with the same directory resumes at the end and trains nothing more."""
    tiny = dict(epochs=1, steps_per_epoch=2, train_examples=8, batch_size=2,
                seq_len=8, vocab_size=31, num_layers=1, d_model=16, num_heads=2,
                d_ff=32, compute_dtype="float32", device="cpu",
                save_filepath=str(tmp_path / "lm"), checkpoint_every_steps=1)
    state, result = ttw.main(**tiny)
    assert tckpt.Checkpointer(str(tmp_path / "lm")).all_steps() == [1, 2]
    state2, result2 = ttw.main(**tiny)
    assert state2.step == 2 and result2.total_images == 0
    for a, b in zip(tstate.tree_leaves(state.params), tstate.tree_leaves(state2.params)):
        assert torch.equal(a, b)


# ---- retry -----------------------------------------------------------------------

def test_backoff_delays_are_bounded_full_jitter():
    rng = random.Random(0)
    delays = list(tretry.backoff_delays(6, base_delay=0.1, max_delay=1.0, rng=rng))
    assert len(delays) == 6
    for i, d in enumerate(delays):
        assert 0.0 <= d <= min(1.0, 0.1 * 2 ** i)


def test_retry_call_retries_then_succeeds_or_gives_up():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert tretry.retry_call(flaky, retries=3, sleep=slept.append,
                             rng=random.Random(1), description="flaky io") == "ok"
    assert len(calls) == 3 and len(slept) == 2
    assert all(0.0 <= d <= 0.1 * 2 ** i for i, d in enumerate(slept))

    def broken():
        calls.append(1)
        raise OSError("hard")

    calls.clear()
    with pytest.raises(OSError, match="hard"):
        tretry.retry_call(broken, retries=2, sleep=lambda s: None)
    assert len(calls) == 3  # the first attempt and two retries
    with pytest.raises(ValueError):
        tretry.retry_call(broken, retries=-1)


def test_a_write_that_keeps_failing_surfaces_at_wait(tmp_path, monkeypatch):
    """The background write retries, then its error raises from ``wait``
    and the generation is not certified."""
    attempts = []

    def failing(item_dir, leaves):
        attempts.append(item_dir)
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_write_item", failing)
    ckpt = tckpt.Checkpointer(str(tmp_path / "d"))
    ckpt.save(1, _bert_state())
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert len(attempts) == 3
    assert ckpt.all_steps() == [] and ckpt.latest_verified_step() is None

"""The port's BERT fine-tune path against the JAX package, on the CPU.

The same weights (the JAX encoder's initialised parameters, unboxed and
carried over key for key) and the same synthetic text batches go through
the JAX ``BertEncoder`` / ``build_train_step`` and the port's
``models.bert`` / ``build_train_step``.  With ``attention="flash"`` the JAX
model runs its Pallas kernels in interpret mode (explicit 16 x 16 blocks
that divide S) and the port its kernels' plain versions, both with the
padding mask as the kernels' key-padding bias.  Dropout is 0 wherever the
two are compared: ``jax.random`` cannot be reproduced in torch, so dropout
is held to determinism within the port.

Tolerances:
- f32 logits within 1e-4 of the largest |logit| (observed ~1e-6: sums in
  another order through two layers);
- bf16 logits within 5e-2 of the largest |logit| (a bf16 ulp is 0.4-0.8%;
  Dense, GELU and the softmax round at the same places on both sides but
  in other orders, through two layers); argmax equal;
- the 4-step train step: per-step f32 loss within 1e-5 relative (f32) and
  2e-3 (bf16; AdamW then moves the bf16-rounded forward's gradients),
  lr exact to 1e-7, top1 equal; f32 params within 1e-3 of the run's summed
  learning rate; bf16 params as in ``tests/test_torch_bf16.py``: each
  leaf's median |difference| within 1e-2 of the summed learning rate, at
  most 1% of its elements beyond 0.1 of it, and none beyond twice the sum
  (a gradient element whose sign bf16 rounding flips moves its param by up
  to 2 lr in that step).
"""

from __future__ import annotations

import dataclasses
import json
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.ops.flash_attention import (
    make_flash_attention as jmake_flash,
)
from distributeddeeplearning_tpu.parallel import create_mesh, shard_batch
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch import models as tmodels
from distributeddeeplearning_tpu_torch.data import synthetic as tsynth
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import bert as tw

torch.set_num_threads(2)  # the suite runs six workers on eight cores
# With torch's MKL vector math on the CPU, the first call of a function in
# a pytest-xdist worker process can come back at low accuracy (exp was seen
# 1.5e-4 relative off on its first call, within an ulp from the second call
# on); one warm-up call of each function the comparisons use, at import,
# keeps that first call out of every comparison.
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))

SEQ, BATCH, STEPS = 32, 4, 4
PEAK_LR = 1e-3
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, intermediate_size=128,
           max_position_embeddings=SEQ, num_classes=3, dropout_rate=0.0)
# heads -> head dim 16 and 32
HEADS = (4, 2)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
LOGIT_RTOL = {"f32": 1e-4, "bf16": 5e-2}
LOSS_RTOL = {"f32": 1e-5, "bf16": 2e-3}
# the reference's workload test geometry (tests/test_bert_workload.py)
TINY = dict(epochs=1, batch_size=2, seq_len=16, num_classes=3, vocab_size=101,
            train_examples=32, num_layers=2, hidden_size=32, num_heads=4,
            intermediate_size=64, max_position_embeddings=16,
            compute_dtype="float32", dropout_rate=0.0)


def _jcfg(heads, **kw):
    return dataclasses.replace(jbert.BERT_BASE, num_heads=heads, **{**CFG, **kw})


def _tcfg(heads, **kw):
    return dataclasses.replace(tbert.BERT_BASE, num_heads=heads, **{**CFG, **kw})


@pytest.fixture(scope="module")
def jparams():
    """{heads: numpy params} of the JAX encoder, initialised and unboxed."""
    out = {}
    for heads in HEADS:
        variables = jbert.BertEncoder(config=_jcfg(heads), dtype=jnp.float32).init(
            jax.random.key(heads), jnp.zeros((1, SEQ), jnp.int32), train=False)
        out[heads] = jax.tree.map(np.asarray, nn.meta.unbox(variables)["params"])
    return out


def _batch(seed=0, n=BATCH):
    return next(tsynth.SyntheticTextDataset(
        length=n, seq_len=SEQ, vocab_size=CFG["vocab_size"],
        num_classes=CFG["num_classes"], seed=seed).batches(n))


def _jattention(attention):
    return (jmake_flash(block_q=16, block_k=16) if attention == "flash"
            else jbert.dot_product_attention)


def _tattention(attention):
    return (tfa.make_flash_attention() if attention == "flash"
            else tbert.dot_product_attention)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- synthetic text ---------------------------------------------------------

@pytest.mark.parametrize("length,batch,drop", [(16, 4, True), (10, 4, False),
                                               (9, 3, True)])
def test_synthetic_text_batches_equal_the_reference_bit_for_bit(length, batch, drop):
    kw = dict(length=length, seq_len=12, vocab_size=50, num_classes=3, seed=7)
    want = list(jsynth.SyntheticTextDataset(**kw).batches(batch, drop_remainder=drop))
    got = list(tsynth.SyntheticTextDataset(**kw).batches(batch, drop_remainder=drop))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["attention_mask", "input", "label"]
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])
        assert (g["input"][g["attention_mask"] == 0] == 0).all()
        assert g["attention_mask"][:, 0].all()  # lengths are at least 1


def test_fake_data_length_reads_the_environment(monkeypatch):
    monkeypatch.delenv("FAKE_DATA_LENGTH", raising=False)
    assert tsynth.fake_data_length(5) == jsynth.fake_data_length(5) == 5
    assert len(tsynth.SyntheticTextDataset()) == 25000
    monkeypatch.setenv("FAKE_DATA_LENGTH", "12")
    assert tsynth.fake_data_length() == jsynth.fake_data_length() == 12
    assert len(tsynth.SyntheticTextDataset()) == 12


# ---- the model --------------------------------------------------------------

@pytest.mark.parametrize("heads", HEADS, ids=["d16", "d32"])
@pytest.mark.parametrize("attention", ["default", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax_bert_encoder(jparams, dtype, attention, heads):
    """Classification logits of the port == the JAX BertEncoder (train=False)
    on the same weights and a padding mask from the synthetic set."""
    tdt, jdt = DTYPES[dtype]
    batch = _batch(seed=heads)
    net = jbert.BertEncoder(config=_jcfg(heads), dtype=jdt,
                            attention_fn=_jattention(attention))
    want = net.apply({"params": jparams[heads]}, jnp.asarray(batch["input"]),
                     train=False,
                     attention_mask=jnp.asarray(batch["attention_mask"]))
    assert want.dtype == jnp.float32
    params = tbert.params_from_numpy(jparams[heads], device="cpu")
    got = tbert.forward(params, torch.from_numpy(batch["input"]),
                        config=_tcfg(heads), dtype=tdt,
                        attention_fn=_tattention(attention), train=False,
                        attention_mask=torch.from_numpy(batch["attention_mask"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, 3)
    w = _f32(want)
    err = float(np.abs(_f32(got) - w).max())
    assert err <= LOGIT_RTOL[dtype] * float(np.abs(w).max()), err
    if dtype == "f32":
        np.testing.assert_array_equal(_f32(got).argmax(-1), w.argmax(-1))


def test_token_types_and_full_remat_match_jax(jparams):
    """With token_type_ids (the tree then has type_embed) and remat='full'."""
    heads = 4
    batch = _batch(seed=3)
    types = (np.arange(SEQ)[None, :] >= SEQ // 2).astype(np.int32).repeat(BATCH, 0)
    net = jbert.BertEncoder(config=_jcfg(heads, remat="full"), dtype=jnp.float32)
    variables = net.init(jax.random.key(1), jnp.zeros((1, SEQ), jnp.int32),
                         train=False, token_type_ids=jnp.zeros((1, SEQ), jnp.int32))
    jp = jax.tree.map(np.asarray, nn.meta.unbox(variables)["params"])
    assert "type_embed" in jp and "type_embed" not in jparams[heads]
    want = net.apply({"params": jp}, jnp.asarray(batch["input"]), train=False,
                     attention_mask=jnp.asarray(batch["attention_mask"]),
                     token_type_ids=jnp.asarray(types))
    got = tbert.forward(tbert.params_from_numpy(jp, device="cpu"),
                        torch.from_numpy(batch["input"]),
                        config=_tcfg(heads, remat="full"), dtype=torch.float32,
                        train=False,
                        attention_mask=torch.from_numpy(batch["attention_mask"]),
                        token_type_ids=torch.from_numpy(types))
    w = _f32(want)
    assert float(np.abs(_f32(got) - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_init_params_has_the_reference_tree(jparams):
    """Same keys and shapes as the flax tree (no type_embed unless asked)."""
    got = tbert.init_params(_tcfg(4), device="cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)  # noqa: E731
                        for k, v in t.items()}
    assert shapes(got) == shapes(jparams[4])
    assert "type_embed" in tbert.init_params(_tcfg(4), device="cpu", token_types=True)


def test_default_attention_rounds_as_the_reference():
    """bf16 at head dim 32: the reference divides the bf16 scores by
    sqrt(32) rounded to bf16 (5.65625) and fills with bf16's min; the
    port's dot_product_attention gives the same bits on the same inputs
    (f32 softmax on both sides, then bf16)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 8, 2, 32)).astype(np.float32) for _ in range(3))
    keep = np.ones((2, 8), bool)
    keep[1, 5:] = False
    want = jbert.dot_product_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(keep)[:, None, None, :], dtype=jnp.bfloat16)
    got = tbert.dot_product_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(keep)[:, None, None, :], dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    top = float(np.abs(_f32(want)).max())
    assert float(np.abs(_f32(got) - _f32(want)).max()) <= 2.0 ** (
        math.floor(math.log2(top)) - 7)


def test_layer_norm_matches_flax_at_bf16():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-12, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    want = ln.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x, jnp.bfloat16))
    got = tbert._layer_norm({"scale": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)},
                            torch.from_numpy(x).bfloat16(), 1e-12, torch.bfloat16)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    d = np.abs(_f32(got) - _f32(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(_f32(want)), 1e-30))) - 7)
    assert (d <= ulp).all()


def test_registry_builds_the_reference_configs():
    names = tmodels.available_models()
    assert names == sorted(names)
    assert {"bert-base", "bert-large", "bert_base"} <= set(names)
    base = tmodels.get_model("BERT-base", num_layers=2, dtype=torch.float32)
    assert base.config == dataclasses.replace(tbert.BERT_BASE, num_layers=2)
    assert base.dtype == torch.float32
    assert tmodels.get_model("bert-large").config == tbert.BERT_LARGE
    for f in dataclasses.fields(jbert.BertConfig):
        assert getattr(tbert.BERT_LARGE, f.name) == getattr(jbert.BERT_LARGE, f.name)
        assert getattr(tbert.BERT_BASE, f.name) == getattr(jbert.BERT_BASE, f.name)
    with pytest.raises(ValueError, match="Unknown model"):
        tmodels.get_model("vit_s16")  # a name the reference has not either


@pytest.mark.parametrize("kw,what", [({"remat": "partial"}, "remat"),
                                     ({"num_heads": 5}, "divisible")])
def test_what_the_model_does_not_take_raises(kw, what):
    with pytest.raises(ValueError, match=what):
        tbert.bert_base(**kw)


# ---- dropout ----------------------------------------------------------------

def _dropout_logits(params, cfg, gen_seed, batch, remat="none"):
    gen = torch.Generator().manual_seed(gen_seed)
    return tbert.forward(params, torch.from_numpy(batch["input"]),
                         config=dataclasses.replace(cfg, remat=remat),
                         dtype=torch.float32, train=True,
                         attention_mask=torch.from_numpy(batch["attention_mask"]),
                         generator=gen)


def test_dropout_is_deterministic_per_seed_and_step(jparams):
    """Same generator seed, same masks and logits; another seed (another
    step through ``step_generator``), others.  Under remat='full' the
    recomputed layers draw the forward's masks again, so the gradient
    equals the one without remat."""
    cfg = _tcfg(4, dropout_rate=0.1)
    batch = _batch(seed=4)
    params = tbert.params_from_numpy(jparams[4], device="cpu")
    a = _dropout_logits(params, cfg, 1, batch)
    assert torch.equal(a, _dropout_logits(params, cfg, 1, batch))
    assert not torch.equal(a, _dropout_logits(params, cfg, 2, batch))
    plain = tbert.forward(params, torch.from_numpy(batch["input"]), config=cfg,
                          dtype=torch.float32, train=False,
                          attention_mask=torch.from_numpy(batch["attention_mask"]))
    assert not torch.equal(a, plain)
    with pytest.raises(ValueError, match="generator"):
        tbert.forward(params, torch.from_numpy(batch["input"]), config=cfg,
                      dtype=torch.float32, train=True)
    s0, s1 = (tstep.step_generator(43, i, "cpu").initial_seed() for i in (0, 1))
    assert s0 != s1 and s0 == tstep.step_generator(43, 0, "cpu").initial_seed()
    # a train step reseeds one generator: the same draws as a fresh one
    reused = tstep.step_generator(43, 0, "cpu")
    assert tstep.step_generator(43, 1, "cpu", reused) is reused
    assert reused.initial_seed() == s1
    assert torch.equal(torch.rand(8, generator=reused),
                       torch.rand(8, generator=tstep.step_generator(43, 1, "cpu")))

    leaf = params["layer0"]["mlp_in"]["kernel"].requires_grad_(True)
    grads = []
    for remat in ("none", "full"):
        out = _dropout_logits(params, cfg, 5, batch, remat=remat)
        grads.append(torch.autograd.grad(out.sum(), leaf)[0])
    assert torch.equal(grads[0], grads[1])


def test_train_step_dropout_depends_on_the_step_only(jparams):
    """Two fresh states fed the same batch: equal metrics at the same step;
    a state resumed at step 1 draws step 1's masks, not step 0's."""
    cfg = _tcfg(4, dropout_rate=0.1)
    batch = _batch(seed=6)

    def fresh(step=0):
        params = tbert.params_from_numpy(jparams[4], device="cpu")
        st = tstate.TrainState.create(
            params=params, apply_fn=_apply(cfg, torch.float32, "default"),
            tx=tstate.adamw(tsched.constant_schedule(0.0)))
        st.step = step
        return st, tstep.build_train_step(st, compute_dtype=torch.float32, rng=43)

    (s1, f1), (s2, f2), (s3, f3) = fresh(), fresh(), fresh(1)
    l1 = float(f1(s1, batch)[1]["loss"])
    assert l1 == float(f2(s2, batch)[1]["loss"])
    l_next = float(f1(s1, batch)[1]["loss"])  # step 1, lr 0: same params
    assert l_next != l1
    assert float(f3(s3, batch)[1]["loss"]) == l_next


# ---- the train step against JAX build_train_step ----------------------------

def _apply(cfg, tdt, attention):
    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return tbert.forward(p, ids, config=cfg, dtype=tdt,
                             attention_fn=_tattention(attention), train=train,
                             attention_mask=attention_mask,
                             token_type_ids=token_type_ids, generator=generator)

    return apply_fn


@pytest.mark.parametrize("dtype,attention,accum", [
    ("f32", "default", 1), ("f32", "flash", 1), ("bf16", "default", 1),
    ("bf16", "flash", 1), ("f32", "flash", 2)])
def test_train_step_matches_jax_build_train_step(jparams, dtype, attention, accum):
    """Four steps (dropout 0, the padding mask riding as an extra input and,
    with accum_steps 2, split with the rows) of the port's build_train_step
    == the JAX build_train_step on a 1-device mesh: per-step loss, lr and
    top1, and every parameter after step 4, paired by key."""
    tdt, jdt = DTYPES[dtype]
    heads = 4
    sched_args = (PEAK_LR, 2 * STEPS)
    jsch = jsched.warmup_linear_decay_schedule(*sched_args, warmup_fraction=0.25)
    net = jbert.BertEncoder(config=_jcfg(heads), dtype=jdt,
                            attention_fn=_jattention(attention))
    jst = jstate.create_train_state(jax.random.key(heads), net, (1, SEQ),
                                    jstate.adamw(jsch), input_dtype=jnp.int32)
    jst = jst.replace(params=jax.tree.map(jnp.asarray, jparams[heads]))
    jst = jst.replace(opt_state=jst.tx.init(jst.params))
    mesh = create_mesh(devices=jax.devices()[:1])
    jfn = jstep.build_train_step(mesh, jst, compute_dtype=jdt, schedule=jsch,
                                 accum_steps=accum)

    tsch = tsched.warmup_linear_decay_schedule(*sched_args, warmup_fraction=0.25)
    tst = tstate.TrainState.create(
        params=tbert.params_from_numpy(jparams[heads], device="cpu"),
        apply_fn=_apply(_tcfg(heads), tdt, attention), tx=tstate.adamw(tsch))
    tfn = tstep.build_train_step(tst, compute_dtype=tdt, schedule=tsch,
                                 accum_steps=accum)
    lr_sum = sum(float(tsch(i)) for i in range(STEPS))
    batches = tsynth.SyntheticTextDataset(
        length=BATCH * STEPS, seq_len=SEQ, vocab_size=CFG["vocab_size"],
        num_classes=CFG["num_classes"], seed=9).batches(BATCH)
    for i, batch in enumerate(batches):
        jst, jm = jfn(jst, shard_batch(mesh, batch))
        tst, tm = tfn(tst, batch)
        assert tst.step == int(jst.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL[dtype])
        np.testing.assert_allclose(float(tm["top1"]), float(jm["top1"]),
                                   atol=1e-6)
    pairs = tstate.tree_zip(tst.params, jax.tree.map(np.asarray, jst.params))
    assert len(pairs) == 4 + 2 * 16 + 4
    for got, want in pairs:
        assert got.dtype == torch.float32
        share = np.abs(got.detach().numpy() - want) / lr_sum
        if dtype == "f32":
            assert share.max() <= 1e-3, share.max()
        else:
            assert np.median(share) <= 1e-2, np.median(share)
            assert (share > 0.1).mean() <= 1e-2, (share > 0.1).mean()
            # a gradient element whose sign bf16 rounding flips at every
            # step moves its param apart by up to 2 lr a step (observed
            # 1.13 on a few token-embedding elements, 0.05 elsewhere)
            assert share.max() <= 2.0, share.max()


# ---- the workload -----------------------------------------------------------

@pytest.mark.parametrize("attention", ["default", "flash"])
def test_workload_main_runs_the_tiny_config_on_the_cpu(tmp_path, attention):
    """``main`` at the reference's TINY test geometry, on ``device="cpu"``:
    flash and default give the same losses (dropout 0), metrics are finite,
    no kernel launches."""
    counters = [c for c in dir(tfa) if c.startswith("launches")]
    before = {c: getattr(tfa, c) for c in counters}
    rows = {}
    for att in ("default", attention):
        path = tmp_path / f"{att}.jsonl"
        state, result = tw.main(attention=att, metrics_path=str(path),
                                device="cpu", **TINY)
        rows[att] = [json.loads(line) for line in path.read_text().splitlines()]
        assert result.epochs_run == 1 and result.total_images == 32
    assert {c: getattr(tfa, c) for c in counters} == before
    got, want = rows[attention][-1], rows["default"][-1]
    for key in ("train_loss", "train_top1", "val_loss", "val_top1"):
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    assert all(p.dtype == torch.float32 for p in tstate.tree_leaves(state.params))


def test_workload_main_at_its_default_dtype_with_dropout(tmp_path):
    """bf16 (the default compute dtype), dropout 0.1, remat='full', flash:
    finite metrics, LayerNorm params untouched in f32."""
    kw = {**TINY, "dropout_rate": 0.1}
    del kw["compute_dtype"]
    state, result = tw.main(attention="flash", remat="full", device="cpu", **kw)
    assert np.isfinite(result.final_train_metrics["loss"])
    assert np.isfinite(result.final_eval_metrics["loss"])
    assert state.params["layer0"]["attention_ln"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("kw,what", [
    ({"data_format": "tfrecords"}, "A7"),
    ({"attention": "ring"}, "A7"),
    ({"attention": "ulysses"}, "A7"),
    ({"attention": "ulysses-flash"}, "A7"),
    ({"fsdp": 2}, "A5"),
    ({"tensor": 2}, "A6"),
    ({"seq": 2}, "A7"),
    ({"expert": 2}, "A5"),
    ({"num_slices": 2}, "A5"),
    ({"num_experts": 4, "expert": 2}, "A5"),
])
def test_workload_refuses_what_the_slice_does_not_take(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        tw.main(device="cpu", **{**TINY, **kw})


def test_workload_auto_attention_is_default(monkeypatch):
    seen = []
    real = tmodels.get_model

    def spy(name, **kwargs):
        seen.append(kwargs["attention_fn"])
        return real(name, **kwargs)

    monkeypatch.setattr(tmodels, "get_model", spy)
    tw.main(device="cpu", **{**TINY, "train_examples": 2, "epochs": 1})
    assert seen == [tbert.dot_product_attention]

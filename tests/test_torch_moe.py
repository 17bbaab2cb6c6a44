"""The port's mixture-of-experts MLP and MoE BERT against the JAX package,
on the CPU.

``MoeMlp`` (ref ``models/moe.py``) and ``BertEncoder`` with
``num_experts`` > 0 take the same weights (the reference's initialised
params, carried over key for key) and the same numpy inputs on both
sides.  Small: hidden 32, 4 experts of width 64, 8 x 16 tokens; MoE BERT
at 2 layers (layer 1 a mixture of experts), 4 heads, seq 16.

Tolerances:
- ``MoeMlp`` f32: output within 1e-6 of the largest |output|, the slot
  assignment (``combine > 0``) equal and its gates within 2e-6 (a few f32
  ulps of the softmax), the load-balance term within 1e-6 relative; bf16: within 2e-2 of the largest |output| (the expert
  products round to bf16 on both sides, in other orders), dispatch equal;
- MoE BERT f32: logits within 1e-5 of the largest |logit|; the loss with
  the aux term weighted 0.01 within 1e-6 relative, each gradient leaf
  within 1e-4 of the tree's largest |gradient|; three AdamW train steps'
  losses within 1e-5 relative.
"""

from __future__ import annotations

import dataclasses
import importlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu.data import synthetic as jsynth
from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.models import moe as jmoe
from distributeddeeplearning_tpu.parallel import create_mesh, shard_batch
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu.train.step import cross_entropy_loss as jce
from distributeddeeplearning_tpu_torch.data import synthetic as tsynth
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.models import moe as tmoe
from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    params_from_numpy,
)
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import bert as tw

# the JAX ops package re-exports a function over its flash_attention module
jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)  # the suite runs six workers on eight cores
for _fn in (torch.exp, torch.log, torch.tanh, torch.erf, torch.rsqrt):
    _fn(torch.ones(1 << 16))  # first MKL calls in a worker (ROADMAP C, traps)

B, S, H, M, E = 8, 16, 32, 64, 4
SEQ, BATCH = 16, 4
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position_embeddings=SEQ, num_classes=3,
           dropout_rate=0.0, num_experts=E)


def _x(seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, S, H)) * scale).astype(np.float32)


def _jmoe_params(cf, seed=0, router_scale=1.0):
    mod = jmoe.MoeMlp(num_experts=E, intermediate_size=M, capacity_factor=cf,
                      dtype=jnp.float32)
    v = mod.init(jax.random.key(seed), jnp.asarray(_x()), train=True)
    p = jax.tree.map(np.asarray, nn.meta.unbox(v)["params"])
    rng = np.random.default_rng(seed + 1)
    # biases drawn (zero at init) and a router sharp enough to spread tokens
    p["b_in"] = rng.normal(0, 0.1, p["b_in"].shape).astype(np.float32)
    p["b_out"] = rng.normal(0, 0.1, p["b_out"].shape).astype(np.float32)
    p["router"]["kernel"] = (p["router"]["kernel"] * router_scale).astype(np.float32)
    return p


def _jrun(p, x, cf, dtype=jnp.float32, train=True):
    mod = jmoe.MoeMlp(num_experts=E, intermediate_size=M, capacity_factor=cf,
                      dtype=dtype)
    if train:
        y, st = mod.apply({"params": p}, jnp.asarray(x), train=True,
                          mutable=[jmoe.MOE_LOSS_COLLECTION])
        return y, jax.tree.leaves(st)
    return mod.apply({"params": p}, jnp.asarray(x), train=False), []


def _jcombine(p, x, cf):
    """The reference's combine tensor, captured from its dispatch einsum."""
    seen = []
    real = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "nec,ech->nh":
            seen.append(np.asarray(ops[0], np.float32))
        return real(spec, *ops, **kw)

    jnp.einsum = spy
    try:
        _jrun(p, x, cf)
    finally:
        jnp.einsum = real
    return seen[0]


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("cf", [1.25, 0.5, 0.1])
def test_moe_mlp_matches_the_reference(cf):
    """Output, slot assignment and load-balance term at a capacity factor
    that keeps every token (1.25 with a spread router) and at two that
    drop tokens."""
    p = _jmoe_params(cf, router_scale=40.0)
    x = _x(1)
    want, aux_want = _jrun(p, x, cf)
    got, aux = tmoe.moe_mlp(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                            num_experts=E, capacity_factor=cf, dtype=torch.float32)
    w = _f32(want)
    assert float(np.abs(_f32(got) - w).max()) <= 1e-6 * float(np.abs(w).max())
    assert len(aux_want) == 1
    np.testing.assert_allclose(float(aux), float(aux_want[0]), rtol=1e-6)
    cap = tmoe.capacity(B * S, E, 2, cf)
    routing = tmoe.route(params_from_numpy(p["router"]["kernel"], "cpu"),
                         torch.from_numpy(x).reshape(-1, H), E, 2, cap)
    np.testing.assert_array_equal(routing.combine.numpy() > 0, _jcombine(p, x, cf) > 0)
    # the gates: softmax and renormalisation in f32, a few ulps apart
    np.testing.assert_allclose(routing.combine.numpy(), _jcombine(p, x, cf), rtol=0,
                               atol=2e-6)
    assert int(routing.kept.sum()) <= min(2 * B * S, E * cap)
    assert (routing.kept <= cap).all()


def test_moe_mlp_bf16_matches_the_reference():
    p = _jmoe_params(1.25, seed=2, router_scale=40.0)
    x = _x(3)
    want, _ = _jrun(p, x, 1.25, dtype=jnp.bfloat16)
    got, aux = tmoe.moe_mlp(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                            num_experts=E, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    w = _f32(want)
    assert float(np.abs(_f32(got) - w).max()) <= 2e-2 * float(np.abs(w).max())


def test_overflow_tokens_are_dropped_at_small_capacity():
    """Every token routed to expert 0 first: at capacity factor 0.1 each
    expert takes ``capacity`` tokens in token order and the rest of the
    first choices drop out; a dropped token's output row is 0 when its
    second choice overflowed too."""
    kernel = np.zeros((H, E), np.float32)
    kernel[:, 0] = 1.0
    x = np.abs(_x(4)) + 0.1  # every logit of expert 0 the largest
    cap = tmoe.capacity(B * S, E, 2, 0.1)
    r = tmoe.route(torch.from_numpy(kernel), torch.from_numpy(x).reshape(-1, H),
                   E, 2, cap)
    assert r.gate_idx[:, 0].eq(0).all()
    assert int(r.kept[0]) == cap
    # expert 0's slots go to the first `cap` tokens, in flattened (B, S) order
    took = (r.combine[:, 0, :] > 0).any(-1)
    assert took[:cap].all() and not took[cap:].any()
    p = params_from_numpy(_jmoe_params(0.1), "cpu")
    p["router"]["kernel"] = torch.from_numpy(kernel)
    y, _ = tmoe.moe_mlp(p, torch.from_numpy(x), num_experts=E, capacity_factor=0.1,
                        dtype=torch.float32)
    dropped = ~(r.combine > 0).flatten(1).any(-1)
    assert dropped.any()
    assert y.reshape(-1, H)[dropped].eq(0).all()


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    values, idx = tmoe.top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[0, 1], [1, 2]]


def test_one_expert_equals_the_dense_ffn():
    """E = 1: top-1, every token kept (capacity N * cf >= N), gate 1, so
    the layer is the dense FFN with the expert's weights."""
    rng = np.random.default_rng(5)
    p = {"router": {"kernel": torch.from_numpy(rng.normal(size=(H, 1)).astype(np.float32))},
         "w_in": torch.from_numpy(rng.normal(0, 0.1, (1, H, M)).astype(np.float32)),
         "b_in": torch.from_numpy(rng.normal(0, 0.1, (1, M)).astype(np.float32)),
         "w_out": torch.from_numpy(rng.normal(0, 0.1, (1, M, H)).astype(np.float32)),
         "b_out": torch.from_numpy(rng.normal(0, 0.1, (1, H)).astype(np.float32))}
    x = torch.from_numpy(_x(6))
    y, aux = tmoe.moe_mlp(p, x, num_experts=1, dtype=torch.float32)
    dense = F.gelu(x @ p["w_in"][0] + p["b_in"][0], approximate="none")
    dense = dense @ p["w_out"][0] + p["b_out"][0]
    assert float((y - dense).abs().max()) <= 1e-6 * float(dense.abs().max())
    assert float(aux) == 1.0  # E * f * p = 1 * 1 * 1


def test_eval_returns_no_aux_and_sow_collects_only_in_a_context():
    p = params_from_numpy(_jmoe_params(1.25), "cpu")
    x = torch.from_numpy(_x(7))
    y_eval, aux = tmoe.moe_mlp(p, x, num_experts=E, dtype=torch.float32, train=False)
    assert aux is None
    y_train, aux = tmoe.moe_mlp(p, x, num_experts=E, dtype=torch.float32)
    assert torch.equal(y_eval, y_train) and aux is not None
    tmoe.sow(aux)  # no context: dropped
    with tmoe.collect_losses() as outer:
        tmoe.sow(aux)
        with tmoe.collect_losses() as inner:
            tmoe.sow(aux * 2)
    assert len(outer) == 1 and len(inner) == 1 and float(inner[0]) == 2 * float(aux)


# ---- MoE BERT ---------------------------------------------------------------

def _jcfg(**kw):
    return dataclasses.replace(jbert.BERT_BASE, **{**CFG, **kw})


def _tcfg(**kw):
    return dataclasses.replace(tbert.BERT_BASE, **{**CFG, **kw})


@pytest.fixture(scope="module")
def jparams():
    net = jbert.BertEncoder(config=_jcfg(), dtype=jnp.float32)
    v = net.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32), train=False)
    p = jax.tree.map(np.asarray, nn.meta.unbox(v)["params"])
    # a router sharp enough that tokens spread over the experts
    router = p["layer1"]["moe_mlp"]["router"]
    router["kernel"] = (router["kernel"] * 50.0).astype(np.float32)
    return p


def _batch(seed=0, n=BATCH):
    return next(tsynth.SyntheticTextDataset(
        length=n, seq_len=SEQ, vocab_size=CFG["vocab_size"],
        num_classes=CFG["num_classes"], seed=seed).batches(n))


def test_moe_bert_tree_and_init_match_the_reference(jparams):
    got = tbert.init_params(_tcfg(), device="cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)  # noqa: E731
                        for k, v in t.items()}
    assert shapes(got) == shapes(jparams)
    assert "moe_mlp" in got["layer1"] and "mlp_in" not in got["layer1"]
    assert "mlp_in" in got["layer0"] and "moe_mlp" not in got["layer0"]
    assert [tbert.uses_moe(_tcfg(num_layers=12), i) for i in range(4)] == [
        False, True, False, True]
    assert tbert.uses_moe(_tcfg(moe_every_n=0), 0)  # max(n, 1), as the reference


@pytest.mark.parametrize("attention", ["default", "flash"])
def test_moe_bert_loss_and_gradients_match_the_reference(jparams, attention):
    """f32: logits, the training loss with the load-balance terms weighted
    0.01, and every gradient leaf, paired by key."""
    batch = _batch(seed=1)
    labels = batch["label"]
    jfn = (jbert.dot_product_attention if attention == "default"
           else jfa.make_flash_attention(block_q=16, block_k=16))
    net = jbert.BertEncoder(config=_jcfg(), dtype=jnp.float32, attention_fn=jfn)

    def jloss(p):
        logits, st = net.apply({"params": p}, jnp.asarray(batch["input"]),
                               train=True, mutable=[jmoe.MOE_LOSS_COLLECTION],
                               attention_mask=jnp.asarray(batch["attention_mask"]))
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(st))
        return jce(logits, jnp.asarray(labels)) + 0.01 * aux, (logits, aux)

    (want, (wlogits, waux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams))
    params = params_from_numpy(jparams, "cpu")
    leaves = [t.requires_grad_(True) for t in tstate.tree_leaves(params)]
    attn = (tbert.dot_product_attention if attention == "default"
            else tfa.make_flash_attention())
    with tmoe.collect_losses() as terms:
        logits = tbert.forward(params, torch.from_numpy(batch["input"]),
                               config=_tcfg(), dtype=torch.float32,
                               attention_fn=attn, train=True,
                               attention_mask=torch.from_numpy(batch["attention_mask"]))
    assert len(terms) == 1
    aux = sum(terms)
    loss = tstep.cross_entropy_loss(logits, torch.from_numpy(labels)) + 0.01 * aux
    grads = torch.autograd.grad(loss, leaves)
    w = np.asarray(wlogits)
    assert float(np.abs(_f32(logits) - w).max()) <= 1e-5 * float(np.abs(w).max())
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    pairs = tstate.tree_zip(_as_tree(params, grads), jax.tree.map(np.asarray, jgrads))
    top = max(float(np.abs(w).max()) for _, w in pairs)
    assert len(pairs) == len(leaves)
    for g, w in pairs:
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * top


def _as_tree(params, leaves):
    it = iter(leaves)

    def build(t):
        return {k: build(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return build(params)


def _apply(cfg, remat="none"):
    cfg = dataclasses.replace(cfg, remat=remat)

    def apply_fn(p, ids, *, train, generator=None, attention_mask=None,
                 token_type_ids=None):
        return tbert.forward(p, ids, config=cfg, dtype=torch.float32, train=train,
                             attention_mask=attention_mask,
                             token_type_ids=token_type_ids, generator=generator)

    return apply_fn


def test_moe_bert_train_steps_match_jax_build_train_step(jparams):
    """Three AdamW steps: the port's step adds 0.01 x the load-balance term
    as the reference's does (``moe_aux_weight``); per-step loss and lr."""
    jsch = jsched.warmup_linear_decay_schedule(1e-3, 6, warmup_fraction=0.25)
    net = jbert.BertEncoder(config=_jcfg(), dtype=jnp.float32)
    jst = jstate.create_train_state(jax.random.key(0), net, (1, SEQ),
                                    jstate.adamw(jsch), input_dtype=jnp.int32)
    jst = jst.replace(params=jax.tree.map(jnp.asarray, jparams))
    jst = jst.replace(opt_state=jst.tx.init(jst.params))
    mesh = create_mesh(devices=jax.devices()[:1])
    jfn = jstep.build_train_step(mesh, jst, compute_dtype=jnp.float32, schedule=jsch)
    tsch = tsched.warmup_linear_decay_schedule(1e-3, 6, warmup_fraction=0.25)
    tst = tstate.TrainState.create(params=params_from_numpy(jparams, "cpu"),
                                   apply_fn=_apply(_tcfg()), tx=tstate.adamw(tsch))
    tfn = tstep.build_train_step(tst, compute_dtype=torch.float32, schedule=tsch)
    no_aux = tstep.build_train_step(tst, compute_dtype=torch.float32, schedule=tsch,
                                    moe_aux_weight=0.0)
    batches = list(jsynth.SyntheticTextDataset(
        length=3 * BATCH, seq_len=SEQ, vocab_size=CFG["vocab_size"],
        num_classes=CFG["num_classes"], seed=2).batches(BATCH))
    for i, batch in enumerate(batches):
        jst, jm = jfn(jst, shard_batch(mesh, batch))
        tst, tm = tfn(tst, batch)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    # the weight is applied: without it the reported loss drops by ~0.01 x aux
    tst.tx = tstate.adamw(tsched.constant_schedule(0.0))
    tst.opt_state = tst.tx.init(tst.params)
    with_aux = float(tfn(tst, batches[0])[1]["loss"])
    without = float(no_aux(tst, batches[0])[1]["loss"])
    assert 0.005 < with_aux - without < 0.05


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_bert_remat_gives_the_same_gradients_bitwise(jparams, remat):
    """``remat="dots"`` and ``"full"`` no longer raise; with MoE layers and
    dropout their loss (aux term included) and gradients equal ``none``'s."""
    batch = _batch(seed=3)
    out = []
    for policy in ("none", remat):
        params = params_from_numpy(jparams, "cpu")
        leaves = [t.requires_grad_(True) for t in tstate.tree_leaves(params)]
        cfg = _tcfg(remat=policy, dropout_rate=0.1)
        with tmoe.collect_losses() as terms:
            logits = tbert.forward(params, torch.from_numpy(batch["input"]),
                                   config=cfg, dtype=torch.float32, train=True,
                                   attention_mask=torch.from_numpy(batch["attention_mask"]),
                                   generator=torch.Generator().manual_seed(9))
        loss = tstep.cross_entropy_loss(logits, torch.from_numpy(batch["label"]))
        loss = loss + 0.01 * sum(terms)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_workload_main_trains_moe_bert_on_the_cpu(tmp_path):
    state, result = tw.main(
        epochs=1, batch_size=2, seq_len=16, num_classes=3, vocab_size=101,
        train_examples=8, num_layers=2, hidden_size=32, num_heads=4,
        intermediate_size=64, max_position_embeddings=16, compute_dtype="float32",
        dropout_rate=0.0, num_experts=4, attention="flash", device="cpu",
        metrics_path=str(tmp_path / "m.jsonl"))
    assert "moe_mlp" in state.params["layer1"]
    assert np.isfinite(result.final_train_metrics["loss"])
    assert np.isfinite(result.final_eval_metrics["loss"])

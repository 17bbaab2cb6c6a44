"""The port's bf16 path against the JAX package, on the CPU.

bf16 is the reference's default compute dtype for training
(``workloads/transformer.py``: params cast to bf16 inside ``apply_fn``,
loss in f32).  Here the port runs the plain versions of its flash kernels
(CPU tensors) and the JAX side runs the Pallas kernels in interpret mode.
Inputs are made with numpy from a seed and handed to both.

Tolerances.  bf16 keeps 8 significant bits, so one bf16 ulp at a value x
is 2^(floor(log2 |x|) - 7), 0.4-0.8% of x.  Both sides round at the same
places (P and dS to bf16 as product operands, outputs once) and differ in
the order of their f32 sums, which moves a rounded value by an ulp now and
then:
- flash outputs and gradients: within 1 bf16 ulp of the largest |value|
  (observed: at most half of one); lse, f32 on both sides from unrounded
  f32 scores, within 1e-5 (observed ~1e-6);
- logits of the 2-layer model: within 2 bf16 ulps of the largest |logit|
  (observed 1.5: two ulp-level rounding differences can meet in one
  logit), argmax equal; per-position f32 losses within 1e-4 relative and
  a parameter gradient through ``remat`` within 4 ulps of its largest
  |value| (see the test);
- the 4-step train step: f32 losses within 2e-5 relative (observed
  2e-6).  Params: AdamW's first updates are about lr * sign(g), so a
  gradient element that bf16 rounding moves across 0 moves its param by up
  to 2 lr in that step.  Each leaf's median |difference| is held to 1e-2
  of the run's summed learning rate (observed <= 5e-3), at most 1% of its
  elements may exceed 0.1 of it (observed <= 0.12%), and none may exceed
  the whole sum (observed 0.38).
"""

from __future__ import annotations

import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.parallel import create_mesh, shard_batch
from distributeddeeplearning_tpu.train import schedule as jsched
from distributeddeeplearning_tpu.train import state as jstate
from distributeddeeplearning_tpu.train import step as jstep
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep
from distributeddeeplearning_tpu_torch.workloads import transformer as tw

jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

CFG = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=97)
SEQ, BATCH, STEPS = 32, 4, 4
PEAK_LR = 1e-2
ULPS = 1
LOGIT_ULPS = 2
LSE_ATOL = 1e-5
LOSS_RTOL = 2e-5


def _ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest |x|."""
    top = float(np.abs(x).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_ulps(got, want, what="", ulps=ULPS):
    g, w = _f32(got), _f32(want)
    err = float(np.abs(g - w).max())
    assert err <= ulps * _ulp(w), (what, err, _ulp(w))


def _bf16_inputs(b, s, h, d, seed=0, n=3):
    """numpy f32 arrays already on the bf16 grid, so both frameworks see
    the same bf16 values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
        out.append(x.bfloat16().float().numpy())
    return out


def _to3(x):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d), jnp.bfloat16)


def _from3(x3, b, h):
    bh, s, d = x3.shape
    return np.asarray(jnp.asarray(x3, jnp.float32)).reshape(b, h, s, d).transpose(
        0, 2, 1, 3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16()


# ---- the kernels' plain versions against the Pallas kernels (interpret) ----

@pytest.mark.parametrize("s", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_forward_matches_pallas_interpret(s, causal):
    """bf16 O and f32 lse of the port's plain forward == the Pallas
    forward on bf16 inputs with 32 x 32 tiles (several q and k tiles and
    the causal skips really run)."""
    b, h, d = 2, 3, 16
    q, k, v = _bf16_inputs(b, s, h, d, seed=s + causal)
    o3, lse3 = jfa._flash_fwd_pallas(
        _to3(q), _to3(k), _to3(v), jnp.zeros((b, s), jnp.float32), heads=h,
        block_q=32, block_k=32, out_dtype=jnp.bfloat16, causal=causal,
        has_bias=False,
    )
    assert o3.dtype == jnp.bfloat16
    o, lse = tfa._dense_attention(_t(q), _t(k), _t(v), None, causal=causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close_ulps(o, _from3(o3, b, h), "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse3).reshape(b, h, s),
                               atol=LSE_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_backward_matches_pallas_interpret(causal):
    """bf16 dQ, dK, dV of the port's plain backward == the Pallas dq and
    dk/dv kernels on bf16 inputs (32 x 32 tiles, S=128), from the Pallas
    forward's O and lse and the same bf16 dO."""
    b, s, h, d = 2, 128, 3, 16
    q, k, v, do = _bf16_inputs(b, s, h, d, seed=10 + causal, n=4)
    bias = jnp.zeros((b, s), jnp.float32)
    o3, lse3 = jfa._flash_fwd_pallas(
        _to3(q), _to3(k), _to3(v), bias, heads=h, block_q=32, block_k=32,
        out_dtype=jnp.bfloat16, causal=causal, has_bias=False,
    )
    want = jfa._flash_bwd_pallas(
        _to3(q), _to3(k), _to3(v), bias, o3, lse3, _to3(do), heads=h,
        block_q=32, block_k=32, causal=causal, has_bias=False,
    )
    o = _t(_from3(o3, b, h))
    lse = torch.from_numpy(np.array(lse3).reshape(b, h, s))
    tdo = _t(do)
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = tfa._dense_attention_bwd(_t(q), _t(k), _t(v), tdo, lse, delta,
                                   causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        _close_ulps(g, _from3(w, b, h), name)


def test_plain_forward_does_not_round_scores_to_bf16():
    """Repair: the plain forward's S = Q K^T is the f32 product of the
    bf16 operands (as the kernels' f32-accumulated dot), not a bf16
    product.  lse, a function of S alone, must then equal a float64
    log-sum-exp of the same bf16 values to f32 precision; a bf16-rounded S
    is off by ~1e-2."""
    b, s, h, d = 2, 64, 3, 16
    q, k, v = _bf16_inputs(b, s, h, d, seed=3)
    _, lse = tfa._dense_attention(_t(q), _t(k), _t(v), None, causal=True)
    s64 = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
    s64 = s64 / math.sqrt(d) + np.where(np.tri(s, dtype=bool), 0.0, -np.inf)
    top = s64.max(-1, keepdims=True)
    want = (top + np.log(np.exp(s64 - top).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=LSE_ATOL)


def test_dense_attention_scores_are_f32(monkeypatch):
    """Repair: with bf16 operands the dense path's softmax sees f32
    scores (the reference promotes the bf16 product through its f32
    scale) and casts back to the stream dtype."""
    seen = []
    softmax = torch.softmax

    def spy(x, *args, **kwargs):
        seen.append(x.dtype)
        return softmax(x, *args, **kwargs)

    monkeypatch.setattr(torch, "softmax", spy)
    params = tpt.init_params(torch.Generator().manual_seed(0), max_len=SEQ,
                             device="cpu", **CFG)
    layer = {k: v[0].bfloat16() for k, v in params["blocks"].items()}
    x = torch.randn((2, 8, CFG["d_model"]), generator=torch.Generator()
                    .manual_seed(1)).bfloat16()
    out = tpt.block_apply(layer, x, num_heads=CFG["num_heads"], attention="dense")
    assert seen == [torch.float32]
    assert out.dtype == torch.bfloat16


# ---- the model and the train step against the JAX package -----------------

@pytest.fixture(scope="module")
def jparams():
    return jpt.init_params(jax.random.key(0), max_len=SEQ, **CFG)


def _bf16_tree(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_logits_match_jax(jparams, attention):
    toks = np.random.default_rng(0).integers(0, CFG["vocab_size"], (BATCH, SEQ))
    jp = _bf16_tree(jparams)
    want = jpt.forward(jp, jnp.asarray(toks, jnp.int32),
                       num_heads=CFG["num_heads"], attention=attention)
    assert want.dtype == jnp.bfloat16
    tp = tpt.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                               device="cpu")
    tp = tstate.tree_map(lambda a: a.bfloat16(), tp)
    got = tpt.forward(tp, torch.from_numpy(toks), num_heads=CFG["num_heads"],
                      attention=attention)
    assert got.dtype == torch.bfloat16
    _close_ulps(got, want, "logits", ulps=LOGIT_ULPS)
    np.testing.assert_array_equal(_f32(got).argmax(-1), _f32(want).argmax(-1))


@pytest.mark.parametrize("loss_chunk", [None, 31])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_per_token_loss_and_remat_gradient_match_jax(jparams, attention,
                                                          loss_chunk):
    """bf16 per-position losses, one-shot and chunked (31 | s-1), with every
    layer rematerialized, and the f32 gradient of the qkv leaf through the
    in-loss bf16 cast: f32 losses within 1e-4 relative (observed 3e-5),
    the gradient within 4 bf16 ulps of its largest |value| (observed 1.5:
    each bf16 rounding of the backward can move it by one)."""
    toks = np.random.default_rng(0).integers(0, CFG["vocab_size"], (BATCH, SEQ))
    kw = dict(num_heads=CFG["num_heads"], attention=attention, remat=True,
              loss_chunk=loss_chunk)

    def jloss(p):
        return jpt.per_token_loss(_bf16_tree(p), jnp.asarray(toks, jnp.int32), **kw)

    want = jloss(jparams)
    jgrad = jax.grad(lambda p: jloss(p).mean())(jparams)["blocks"]["qkv"]
    tp = tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaf = tp["blocks"]["qkv"].requires_grad_(True)
    got = tpt.per_token_loss(tstate.tree_map(lambda a: a.bfloat16(), tp),
                             torch.from_numpy(toks), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, SEQ - 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4)
    (g,) = torch.autograd.grad(got.mean(), leaf)
    assert g.dtype == torch.float32
    _close_ulps(g, jgrad, "qkv gradient", ulps=4)


def _lm_loss(next_token_loss):
    def loss(logits, labels, *, label_smoothing=0.0):
        return next_token_loss(logits, labels)

    return loss


def _jax_step(jparams, attention):
    def apply_fn(variables, toks, train=True, mutable=None, rngs=None):
        p = _bf16_tree(variables["params"])
        out = jpt.forward(p, toks, num_heads=CFG["num_heads"],
                          attention=attention).astype(jnp.float32)
        return (out, {}) if mutable is not None else out

    sched = jsched.warmup_linear_decay_schedule(PEAK_LR, 2 * STEPS,
                                                warmup_fraction=0.25)
    tx = jstate.adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)
    params = jax.tree.map(jnp.array, jparams)
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), batch_stats={},
                              apply_fn=apply_fn, tx=tx)
    mesh = create_mesh(devices=jax.devices()[:1])
    step = jstep.build_train_step(
        mesh, state, compute_dtype=jnp.bfloat16, schedule=sched,
        loss_fn=_lm_loss(jpt.next_token_loss),
        metrics_fn=lambda logits, toks, loss: {"loss": loss.astype(jnp.float32)})
    return mesh, state, step


def _port_step(jparams, attention):
    def apply_fn(p, toks, **_):
        p = tstate.tree_map(lambda a: a.to(torch.bfloat16), p)
        return tpt.forward(p, toks, num_heads=CFG["num_heads"],
                           attention=attention).float()

    sched = tsched.warmup_linear_decay_schedule(PEAK_LR, 2 * STEPS,
                                                warmup_fraction=0.25)
    tx = tstate.adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)
    params = tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = tstate.TrainState.create(params=params, apply_fn=apply_fn, tx=tx)
    step = tstep.build_train_step(
        state, compute_dtype=torch.bfloat16, schedule=sched,
        loss_fn=_lm_loss(tpt.next_token_loss),
        metrics_fn=lambda logits, toks, loss: {"loss": loss.float()})
    return state, step, sum(float(sched(i)) for i in range(STEPS))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_train_step_matches_jax_build_train_step(jparams, attention):
    """Four bf16 steps of the port's build_train_step == the JAX
    build_train_step(compute_dtype=bf16) on a 1-device mesh: per-step f32
    losses, f32 params (paired by key) after the run; params, Adam state
    and the gradient sums stay f32 on both sides, token ids are not
    cast."""
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    mesh, jst, jstep_fn = _jax_step(jparams, attention)
    tst, tstep_fn, lr_sum = _port_step(jparams, attention)
    for toks in batches:
        batch = {"input": toks, "label": toks}
        jst, jm = jstep_fn(jst, shard_batch(mesh, batch))
        tst, tm = tstep_fn(tst, batch)
        assert tm["loss"].dtype == torch.float32
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    pairs = tstate.tree_zip(tst.params, jax.tree.map(np.asarray, jst.params))
    assert len(pairs) == 9  # embed, pos, head and six block leaves
    for got, want in pairs:
        assert got.dtype == torch.float32
        share = np.abs(got.detach().numpy() - want) / lr_sum
        assert np.median(share) <= 1e-2, np.median(share)
        assert (share > 0.1).mean() <= 1e-2, (share > 0.1).mean()
        assert share.max() <= 1.0, share.max()
    for got in tstate.tree_leaves(tst.opt_state["mu"]):
        assert got.dtype == torch.float32


def test_workload_main_learns_at_its_default_dtype(tmp_path):
    """``main`` with ``compute_dtype`` left at its default (bf16) and flash
    attention learns the repeated batch on the CPU; no kernel launches."""
    path = tmp_path / "metrics.jsonl"
    counters = ("launches", "launches_dq", "launches_dkv", "launches_bf16",
                "launches_dq_bf16", "launches_dkv_bf16")
    before = [getattr(tfa, c) for c in counters]
    state, result = tw.main(
        epochs=3, steps_per_epoch=3, train_examples=4, base_lr=1e-2,
        metrics_path=str(path), attention="flash", batch_size=4, seq_len=16,
        vocab_size=37, num_layers=2, d_model=32, num_heads=4, d_ff=64,
        device="cpu")
    assert [getattr(tfa, c) for c in counters] == before
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[-1]["train_loss"] < rows[0]["train_loss"]
    for key in ("train_loss", "train_top1", "train_perplexity", "val_loss"):
        assert np.isfinite(rows[-1][key]), key
    assert all(p.dtype == torch.float32 for p in tstate.tree_leaves(state.params))

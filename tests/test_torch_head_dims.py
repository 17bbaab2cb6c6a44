"""The port's kernels' plain versions at head dims 16 and 32, against the
JAX package, on the CPU; and the int8 product's padding.

The reference's own default geometries put its kernels at head dims other
than 64: ``ddlt serve`` runs d 64 over 4 heads (head dim 16) and the LM
trainer d 256 over 8 (head dim 32).  The port's CUDA kernels take 16, 32
and 64; here their plain versions (CPU tensors) are held to the Pallas
kernels in interpret mode at 16 and 32, and a 2-step f32 train step with
flash attention to the reference's ``build_train_step`` at both.

Tolerances, as the head-dim-64 tests of the same functions state them
(``tests/test_torch_flash_attention_bwd.py``, ``tests/test_torch_bf16.py``,
``tests/test_torch_flash_decode.py``, ``tests/test_torch_train.py``):
f32 flash outputs and gradients 1e-5 absolute; bf16 outputs one bf16 ulp
of the largest |value|, lse 1e-5; train-step losses 1e-5 relative and
params 1e-3 of the run's summed learning rate.  Decode attention: 1e-5
absolute plus 1e-5 relative (the same f32 arithmetic summed in another
order; int8 codes times scales up to 0.1 make K/V values up to 12.7 and
scores up to ~7, where the observed gap is ~5e-6).

The int8 product pads its operands on the card (``torch._int_mm`` there
takes K and N only in multiples of 8, and no K <= 96); the padded product
is held bitwise to the unpadded one on the CPU, where ``torch._int_mm``
takes any shape.
"""

from __future__ import annotations

import importlib
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
from distributeddeeplearning_tpu_torch.ops import flash_decode as tfd
from distributeddeeplearning_tpu_torch.quant import qtensor as tqt
from distributeddeeplearning_tpu_torch.train import schedule as tsched
from distributeddeeplearning_tpu_torch.train import state as tstate
from distributeddeeplearning_tpu_torch.train import step as tstep

jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")
jfd = importlib.import_module("distributeddeeplearning_tpu.ops.flash_decode")

torch.set_num_threads(2)  # the suite runs six workers on eight cores

HEAD_DIMS = (16, 32)
ATOL = 1e-5


def _ulp(x: np.ndarray) -> float:
    """One bf16 ulp at the largest |x|."""
    top = float(np.abs(x).max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _inputs(b, s, h, d, seed, n, bf16=False):
    """numpy f32 arrays (on the bf16 grid with ``bf16``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(b, s, h, d)).astype(np.float32)
        out.append(torch.from_numpy(x).bfloat16().float().numpy() if bf16 else x)
    return out


def _to3(x, dtype=jnp.float32):
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d), dtype)


def _from3(x3, b, h):
    bh, s, d = x3.shape
    return np.asarray(jnp.asarray(x3, jnp.float32)).reshape(b, h, s, d).transpose(
        0, 2, 1, 3)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# ---- K1, K2, K3: the flash forward and backward ---------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_forward_matches_pallas_at_head_dim(d, dtype, causal):
    """O and lse of the plain forward == the Pallas forward (16 x 16
    tiles, S=64: several tiles and the causal skip run)."""
    b, s, h = 2, 64, 2
    bf16 = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    q, k, v = _inputs(b, s, h, d, seed=d + causal, n=3, bf16=bf16)
    o3, lse3 = jfa._flash_fwd_pallas(
        _to3(q, jdt), _to3(k, jdt), _to3(v, jdt), jnp.zeros((b, s), jnp.float32),
        heads=h, block_q=16, block_k=16, out_dtype=jdt, causal=causal,
        has_bias=False)
    o, lse = tfa._dense_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), None,
                                  causal=causal)
    want = _from3(o3, b, h)
    atol = _ulp(want) if bf16 else ATOL
    np.testing.assert_allclose(o.float().numpy(), want, atol=atol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse3).reshape(b, h, s),
                               atol=ATOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_backward_matches_pallas_at_head_dim(d, causal):
    """dQ, dK, dV of the plain backward == the Pallas dq and dk/dv kernels
    (16 x 16 tiles, S=64) from the Pallas forward's lse and O."""
    b, s, h = 2, 64, 2
    q, k, v, do = _inputs(b, s, h, d, seed=20 + d + causal, n=4)
    bias = jnp.zeros((b, s), jnp.float32)
    o3, lse3 = jfa._flash_fwd_pallas(
        _to3(q), _to3(k), _to3(v), bias, heads=h, block_q=16, block_k=16,
        out_dtype=jnp.float32, causal=causal, has_bias=False)
    want = jfa._flash_bwd_pallas(
        _to3(q), _to3(k), _to3(v), bias, o3, lse3, _to3(do), heads=h,
        block_q=16, block_k=16, causal=causal, has_bias=False)
    o = _t(_from3(o3, b, h))
    lse = torch.from_numpy(np.array(lse3).reshape(b, h, s))
    delta = (_t(do) * o).sum(-1).transpose(1, 2).contiguous()
    got = tfa._dense_attention_bwd(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                   causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), _from3(w, b, h), atol=ATOL,
                                   err_msg=name)


# ---- K4: the paged decode kernel -------------------------------------------

@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("nq", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_plain_paged_attention_matches_pallas_at_head_dim(hd, nq, int8):
    """The kernel's plain version == ``_pallas_attention`` over a
    scrambled table (page 8, the reference's Pallas floor), per-query
    positions; int8 pools at nq = 1 carry the own-token overlay."""
    rng = np.random.default_rng(hd + nq + int8)
    b, h, ps, nb = 3, 2, 8, 4
    pool = b * nb + 2
    if int8:
        k, v = (rng.integers(-127, 128, size=(pool, ps, h, hd), dtype=np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.1, size=(pool, ps, h)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=(pool, ps, h, hd)).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    tables = (rng.permutation(pool - 1)[: b * nb] + 1).reshape(b, nb).astype(np.int32)
    q4 = rng.normal(size=(b, nq, h, hd)).astype(np.float32)
    posmat = np.sort(rng.integers(0, nb * ps, size=(b, nq)), axis=1).astype(np.int32)
    own = [None, None]
    if int8 and nq == 1:
        own = [rng.normal(size=(b, h, hd)).astype(np.float32) for _ in range(2)]
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want = np.asarray(jfd._pallas_attention(
        *map(j, (q4, k, v, ks, vs, tables, posmat)), block=ps,
        k_own=j(own[0]), v_own=j(own[1])))
    got = tfd.paged_attention(*map(t, (q4, k, v, tables, posmat, ks, vs,
                                       *own)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


# ---- the slice as a whole: a train step at each head dim ------------------

STEPS, BATCH, SEQ, PEAK_LR = 2, 2, 32, 1e-2


def _train_cfg(d):
    """2 layers of width 64 with head dim ``d`` (4 heads at 16, 2 at 32)."""
    return dict(num_layers=2, d_model=64, num_heads=64 // d, d_ff=128,
                vocab_size=97)


def _jax_train(cfg, jparams, batches):
    heads, vocab = cfg["num_heads"], cfg["vocab_size"]

    def apply_fn(variables, toks, train=True, mutable=None, rngs=None):
        out = jpt.forward(variables["params"], toks, num_heads=heads,
                          attention="flash")
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
        mesh, state, compute_dtype=jnp.float32, schedule=sched,
        loss_fn=lambda lg, lb, label_smoothing=0.0: jpt.next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss.astype(jnp.float32)})
    losses = []
    for toks in batches:
        state, m = step(state, shard_batch(mesh, {"input": toks, "label": toks}))
        losses.append(float(m["loss"]))
    assert vocab == cfg["vocab_size"]
    return losses, jax.tree.map(np.asarray, state.params)


def _port_train(cfg, jparams, batches):
    heads = cfg["num_heads"]
    sched = tsched.warmup_linear_decay_schedule(PEAK_LR, 2 * STEPS,
                                                warmup_fraction=0.25)
    tx = tstate.adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)
    state = tstate.TrainState.create(
        params=tpt.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu"),
        apply_fn=lambda p, toks, **_: tpt.forward(p, toks, num_heads=heads,
                                             attention="flash"),
        tx=tx)
    step = tstep.build_train_step(
        state, compute_dtype=torch.float32, schedule=sched,
        loss_fn=lambda lg, lb, label_smoothing=0.0: tpt.next_token_loss(lg, lb),
        metrics_fn=lambda lg, lb, loss: {"loss": loss.float()})
    losses = []
    for toks in batches:
        state, m = step(state, {"input": toks, "label": toks})
        losses.append(float(m["loss"]))
    return losses, state.params, sum(float(sched(i)) for i in range(STEPS))


def _close_tree(got, want, atol):
    for name, leaf in want.items():
        if isinstance(leaf, dict):
            _close_tree(got[name], leaf, atol)
        else:
            np.testing.assert_allclose(got[name].detach().numpy(), leaf,
                                       atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_train_step_matches_jax_at_head_dim(d):
    """Two f32 AdamW steps with flash attention (K1 forward, K2/K3
    backward: plain versions here, Pallas in interpret mode there) from
    the same weights and tokens: per-step losses and the final params."""
    cfg = _train_cfg(d)
    jparams = jpt.init_params(jax.random.key(d), max_len=SEQ, **cfg)
    rng = np.random.default_rng(d)
    batches = [rng.integers(0, cfg["vocab_size"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    want_losses, want_params = _jax_train(cfg, jparams, batches)
    losses, params, lr_sum = _port_train(cfg, jparams, batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close_tree(params, want_params, atol=1e-3 * lr_sum)


# ---- the int8 product's padding (the card's torch._int_mm limits) ---------

@pytest.mark.parametrize("m,k,n", [(8, 68, 257), (3, 64, 1031), (40, 13, 7),
                                   (17, 136, 264)])
def test_padded_int8_product_equals_the_unpadded_one(m, k, n):
    """Zero-padding M to 17, K to a multiple of 8 of at least 128 and N to
    a multiple of 8, then cutting the result back, gives the unpadded
    product's int32 values bitwise — at the vocabularies of ``ddlt
    serve`` (257) and the LM trainer (1031)."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = tqt._padded_int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, torch._int_mm(a, b))
    assert torch.equal(got, tqt.int8_matmul(a, b))

"""The port's causal LM (``distributeddeeplearning_tpu_torch.models.
pipelined_transformer``) against the JAX package, on the CPU.

Weights are initialised by JAX and carried over with ``params_from_numpy``
(T4: ``jax.random`` streams cannot be reproduced in torch); tokens come
from numpy.  Geometry is the serve suite's tiny one (3 layers, d 32, 4
heads).

Tolerance 1e-6 absolute everywhere: both sides are f32 through three
layers of matmuls, layer norms and exact GELU summed in different library
orders; at this init the logits are ~1e-2 in magnitude and the two sides
differ by ~3e-9, so 1e-6 leaves a wide margin yet still fails on any
change of math (the reference's own decode pin uses 1e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import pipelined_transformer as jpt
from distributeddeeplearning_tpu.serve import kv_cache as jkv
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as tpt
from distributeddeeplearning_tpu_torch.serve import kv_cache as tkv

torch.set_num_threads(2)  # T5: the suite runs six workers on eight cores

CFG = dict(num_layers=3, d_model=32, num_heads=4, d_ff=64, vocab_size=61,
           max_len=32)
HEADS = CFG["num_heads"]
HEAD_DIM = CFG["d_model"] // HEADS
ATOL = 1e-6


@pytest.fixture(scope="module")
def jparams():
    return jpt.init_params(jax.random.key(0), **CFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tpt.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(1, CFG["vocab_size"], (2, 12)).astype(np.int32)


def test_params_carry_over_with_identity_keys(jparams, tparams):
    assert set(tparams) == set(jparams)
    assert set(tparams["blocks"]) == set(jparams["blocks"])
    for name, leaf in tparams["blocks"].items():
        assert tuple(leaf.shape) == jparams["blocks"][name].shape
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jparams["blocks"][name]))


def test_init_params_layout_and_scale():
    p = tpt.init_params(torch.Generator().manual_seed(3), device="cpu", **CFG)
    j = jpt.init_params(jax.random.key(0), **CFG)
    for name in ("embed", "pos", "head"):
        assert tuple(p[name].shape) == j[name].shape
    for name, leaf in p["blocks"].items():
        assert tuple(leaf.shape) == j["blocks"][name].shape
    assert abs(p["blocks"]["w_in"].std().item() - 0.02) < 0.002
    assert torch.equal(p["blocks"]["ln1"], torch.ones_like(p["blocks"]["ln1"]))
    again = tpt.init_params(torch.Generator().manual_seed(3), device="cpu", **CFG)
    assert torch.equal(p["embed"], again["embed"])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_matches_jax(jparams, tparams, tokens, attention):
    want = np.asarray(jpt.forward(jparams, jnp.asarray(tokens), num_heads=HEADS))
    got = tpt.forward(tparams, torch.from_numpy(tokens), num_heads=HEADS,
                      attention=attention)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_prefill_matches_jax(jparams, tparams, tokens, attention):
    """Logits and the per-layer K/V in the cache layout [b, L, s, h, hd]."""
    jl, jk, jv = jpt.forward_prefill(jparams, jnp.asarray(tokens),
                                     num_heads=HEADS, attention=attention)
    tl, tk, tv = tpt.forward_prefill(tparams, torch.from_numpy(tokens),
                                     num_heads=HEADS, attention=attention)
    b, s = tokens.shape
    assert tuple(tk.shape) == (b, CFG["num_layers"], s, HEADS, HEAD_DIM)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def _cache(b, max_seq=16):
    return tkv.init_cache(batch_slots=b, num_layers=CFG["num_layers"],
                          max_seq=max_seq, num_heads=HEADS, head_dim=HEAD_DIM,
                          device="cpu")


@pytest.mark.parametrize("kernel", ["auto", "gather"])
def test_decode_matches_full_forward_at_every_position(tparams, tokens, kernel):
    """Inside the port: decode-step-t logits == full forward at position t,
    from an empty cache, for every t (the reference's acceptance pin)."""
    b, s = tokens.shape
    t = torch.from_numpy(tokens)
    full = tpt.forward(tparams, t, num_heads=HEADS)
    cache = _cache(b)
    for i in range(s):
        logits, out = tpt.forward_decode(
            tparams, t[:, i], cache, torch.full((b,), i, dtype=torch.int32),
            num_heads=HEADS, kernel=kernel,
        )
        assert out is cache  # updated in place
        torch.testing.assert_close(logits, full[:, i], atol=ATOL, rtol=0)


def test_decode_matches_jax_forward_decode(jparams, tparams, tokens):
    """Port decode steps == JAX decode steps, logits and cache, at unequal
    per-slot positions after a prefill of different lengths."""
    b, s = tokens.shape
    jcache = jkv.init_cache(batch_slots=b, num_layers=CFG["num_layers"],
                            max_seq=16, num_heads=HEADS, head_dim=HEAD_DIM)
    tcache = _cache(b)
    lengths = [5, 8]
    for slot, n in enumerate(lengths):
        _, jk, jv = jpt.forward_prefill(jparams, jnp.asarray(tokens[slot:slot + 1, :n]),
                                        num_heads=HEADS)
        jcache = jkv.insert_sequence(jcache, jk, jv, slot)
        _, tk, tv = tpt.forward_prefill(tparams, torch.from_numpy(tokens[slot:slot + 1, :n]),
                                        num_heads=HEADS, attention="flash")
        tkv.insert_sequence(tcache, tk, tv, slot)
    pos = np.array(lengths, np.int32)
    for _ in range(3):
        tok = tokens[np.arange(b), pos]
        jl, jcache = jpt.forward_decode(jparams, jnp.asarray(tok), jcache,
                                        jnp.asarray(pos), num_heads=HEADS,
                                        kernel="auto")
        tl, _ = tpt.forward_decode(tparams, torch.from_numpy(tok), tcache,
                                   torch.from_numpy(pos), num_heads=HEADS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        pos += 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   atol=ATOL)


def test_prefill_then_decode_matches_full_forward(tparams, tokens):
    """The serving dataflow inside the port: prefill a prefix into slots,
    decode the rest, every step == the full forward."""
    b, s = tokens.shape
    split = 6
    t = torch.from_numpy(tokens)
    full = tpt.forward(tparams, t, num_heads=HEADS)
    _, k, v = tpt.forward_prefill(tparams, t[:, :split], num_heads=HEADS,
                                  attention="flash")
    cache = _cache(b)
    for slot in range(b):
        tkv.insert_sequence(cache, k[slot], v[slot], slot)
    for i in range(split, s):
        logits, _ = tpt.forward_decode(tparams, t[:, i], cache,
                                       torch.full((b,), i, dtype=torch.int32),
                                       num_heads=HEADS)
        torch.testing.assert_close(logits, full[:, i], atol=ATOL, rtol=0)


def test_layer_norm_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 7, 16)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
    want = np.asarray(jpt._layer_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = tpt._layer_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_cache_helpers():
    cache = _cache(4, max_seq=8)
    assert tuple(cache["k"].shape) == (4, CFG["num_layers"], 8, HEADS, HEAD_DIM)
    assert tkv.cache_bytes(cache) == 2 * 4 * CFG["num_layers"] * 8 * HEADS * HEAD_DIM * 4

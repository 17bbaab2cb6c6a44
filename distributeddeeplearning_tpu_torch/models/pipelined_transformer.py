"""The causal LM of ``models/pipelined_transformer.py``, in PyTorch.

Parameters are a plain dict with the reference's names and its stacked
``[L, ...]`` block layout, so weights carry over with the identity key
mapping (:func:`params_from_numpy`).  Blocks are plain functions on
tensors; a Python loop over layers takes the place of ``lax.scan``.

Serving entry points: :func:`forward_prefill` (prompt pass; its attention
is the causal flash kernel with ``attention="flash"``) and
:func:`forward_decode` (one token per slot against the KV cache; its
attention is the decode kernel).  Where the reference donated the cache to
a jitted step, :func:`forward_decode` updates the cache IN PLACE.

Pipeline parallelism, the int8 paths, paged decode, chunked prefill,
speculative verify and the losses wait for later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device
from distributeddeeplearning_tpu_torch.ops import flash_attention as _fa
from distributeddeeplearning_tpu_torch.ops import flash_decode as _fd

Params = Dict[str, Any]

ATTENTIONS = ("dense", "flash")


def init_params(
    generator: Optional[torch.Generator] = None,
    *,
    num_layers: int,
    d_model: int,
    num_heads: int,
    d_ff: int,
    vocab_size: int,
    max_len: int = 512,
    device: DeviceLike = None,
) -> Params:
    """Stacked-parameter dict; block weights carry a leading [L] dim.
    Normal(0, 0.02) draws from ``generator`` (default: seed 0), in the
    reference's order, made on the generator's device and moved to
    ``device``.  The draws differ from ``jax.random``'s; carry JAX weights
    over with :func:`params_from_numpy` instead."""
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} not divisible by heads {num_heads}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    L = num_layers

    def nrm(*shape):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * 0.02).to(dev)

    embed = nrm(vocab_size, d_model)
    pos = nrm(max_len, d_model)
    blocks = {
        "qkv": nrm(L, d_model, 3 * d_model),
        "proj": nrm(L, d_model, d_model),
        "w_in": nrm(L, d_model, d_ff),
        "w_out": nrm(L, d_ff, d_model),
        "ln1": torch.ones((L, d_model), device=dev),
        "ln2": torch.ones((L, d_model), device=dev),
    }
    return {"embed": embed, "pos": pos, "blocks": blocks,
            "head": nrm(d_model, vocab_size)}


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """The JAX package's parameters (``jax.tree.map(np.asarray, params)``)
    as the port's, key for key.  Arrays are copied to ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _layer_norm(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _layer(blocks: Params, i: int) -> Params:
    return {k: v[i] for k, v in blocks.items()}


def _mlp(p, x):
    h = _layer_norm(x, p["ln2"])
    return x + F.gelu(h @ p["w_in"], approximate="none") @ p["w_out"]


def block_apply(p: Params, x: torch.Tensor, *, num_heads: int,
                attention: str = "dense", return_kv: bool = False):
    """One pre-LN transformer block; ``p`` leaves are per-layer (no L).

    ``attention``: ``"dense"`` materializes the [b,h,s,s] scores with a
    tril mask; ``"flash"`` runs the causal flash kernel (its plain version
    on the CPU).  ``return_kv=True`` also returns this layer's ``(k, v)``
    in [b, s, h, hd] — views into the qkv projection, no copy."""
    b, s, d = x.shape
    hd = d // num_heads
    h = _layer_norm(x, p["ln1"])
    q, k, v = (h @ p["qkv"]).split(d, dim=-1)  # strided [b, s, d] views
    split4 = lambda t: t.reshape(b, s, num_heads, hd)  # noqa: E731
    if attention == "flash":
        ctx = _fa.flash_attention(
            split4(q), split4(k), split4(v), None, causal=True
        ).reshape(b, s, d)
    elif attention == "dense":
        qh, kh, vh = (split4(t).transpose(1, 2) for t in (q, k, v))
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / torch.sqrt(
            torch.tensor(float(hd), device=x.device)
        )
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal, scores, -1e30)
        attn = torch.softmax(scores, dim=-1).to(vh.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        ctx = ctx.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    else:
        raise ValueError(f"unknown attention {attention!r} (choices: {ATTENTIONS})")
    x = _mlp(p, x + ctx @ p["proj"])
    if return_kv:
        return x, (split4(k), split4(v))
    return x


def _embed(params, tokens):
    max_len = params["pos"].shape[0]
    if tokens.shape[1] > max_len:
        raise ValueError(
            f"sequence length {tokens.shape[1]} exceeds max_len {max_len}"
        )
    return params["embed"][tokens.long()] + params["pos"][: tokens.shape[1]][None]


def forward(params, tokens, *, num_heads: int, attention: str = "dense"):
    """Next-token logits [b, s, vocab] for int tokens [b, s]."""
    x = _embed(params, tokens)
    for i in range(params["blocks"]["qkv"].shape[0]):
        x = block_apply(_layer(params["blocks"], i), x, num_heads=num_heads,
                        attention=attention)
    return x @ params["head"]


def forward_prefill(params, tokens, *, num_heads: int, attention: str = "dense"):
    """Prompt pass for the serving engine: ``(logits [b, s, vocab], k, v)``
    with k/v in the cache layout [b, L, s, h, hd] — :func:`forward` plus
    each layer's key/value projections."""
    x = _embed(params, tokens)
    ks, vs = [], []
    for i in range(params["blocks"]["qkv"].shape[0]):
        x, (k, v) = block_apply(_layer(params["blocks"], i), x,
                                num_heads=num_heads, attention=attention,
                                return_kv=True)
        ks.append(k)
        vs.append(v)
    return x @ params["head"], torch.stack(ks, dim=1), torch.stack(vs, dim=1)


def _block_decode(p, x, k_l, v_l, pos, *, num_heads: int, kernel: str = "auto"):
    """One block's single-token decode against its cache layer.

    ``x``: [B, d] residual stream; ``k_l``/``v_l``: [B, S, h, hd] views of
    this layer of the cache; ``pos``: [B] the position each slot's token
    occupies.  The new token's K/V are written into the cache at ``pos``
    IN PLACE (``index_put_``, the counterpart of the reference's donated
    scatter) before attention, which sees positions ``<= pos``."""
    b, d = x.shape
    hd = d // num_heads
    h = _layer_norm(x, p["ln1"])
    q, k_t, v_t = (h @ p["qkv"]).split(d, dim=-1)
    q = q.reshape(b, num_heads, hd)
    k_t = k_t.reshape(b, num_heads, hd)
    v_t = v_t.reshape(b, num_heads, hd)
    rows = torch.arange(b, device=x.device)
    idx = (rows, pos.long())
    k_l.index_put_(idx, k_t.to(k_l.dtype))
    v_l.index_put_(idx, v_t.to(v_l.dtype))
    ctx = _fd.decode_attention_dense(
        q, k_l, v_l, None, None, k_t, v_t, pos, kernel=kernel
    ).reshape(b, d).to(x.dtype)
    return _mlp(p, x + ctx @ p["proj"])


def forward_decode(params, token, cache, pos, *, num_heads: int,
                   kernel: str = "auto"):
    """Single-token decode step: next-token logits from the KV cache.

    ``token``/``pos``: [B] int — each slot's current token and the position
    it occupies; ``cache``: ``{"k", "v"}`` each [B, L, S, h, hd]
    (:mod:`..serve.kv_cache`).  The token's K/V are written into ``cache``
    at ``pos`` in every layer, in place; positions ``> pos`` are masked, so
    stale K/V of a previous occupant never reach attention.

    Returns ``(logits [B, vocab], cache)`` — the same, updated, cache."""
    if "k_scale" in cache:
        raise NotImplementedError("int8 KV cache is port slice 3")
    x = params["embed"][token.long()] + params["pos"][pos.long()]
    for i in range(params["blocks"]["qkv"].shape[0]):
        x = _block_decode(
            _layer(params["blocks"], i), x, cache["k"][:, i], cache["v"][:, i],
            pos, num_heads=num_heads, kernel=kernel,
        )
    return x @ params["head"], cache

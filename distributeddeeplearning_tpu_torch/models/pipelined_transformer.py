"""The causal LM of ``models/pipelined_transformer.py``, in PyTorch.

Parameters are a plain dict with the reference's names and its stacked
``[L, ...]`` block layout, so weights carry over with the identity key
mapping (:func:`params_from_numpy`).  Blocks are plain functions on
tensors; a Python loop over layers takes the place of ``lax.scan``.

Serving entry points: :func:`forward_prefill` (prompt pass; its attention
is the causal flash kernel with ``attention="flash"``),
:func:`forward_decode` (one token per slot against the dense KV cache),
:func:`forward_decode_paged` (the same against the page pool) and
:func:`forward_prefill_chunk` (one prompt chunk against the page pool);
the last three attend through the decode kernel, on f32, bf16 or int8
caches, and run in the weights' dtype (f32 or bf16): K/V are written in the
cache's dtype and attention comes back cast to the stream's.
Where the reference donated the cache to a jitted step, they update the
cache IN PLACE.

Training entry points: :func:`forward` with ``remat`` (each layer under
``torch.utils.checkpoint``), :func:`per_token_loss` (optionally chunked
over the sequence so the full logits never exist) and
:func:`next_token_loss`.  With ``attention="flash"`` the gradient runs the
flash backward kernels.  The reference's ``unroll`` (an XLA scan-unroll
compile hint) has no eager counterpart and is not taken.

Tensor parallelism (``mesh=`` with a ``tensor`` axis above 1; the serving
entry points): each rank holds its slice of the weights
(``parallel.sharding.shard_params``) and of the cache (its ``h / tp``
heads) and issues the collectives that GSPMD inserts for the reference,
Megatron's placement done by hand.  Per block: ln1 replicated; ``qkv``
column-parallel over the rank's heads; attention over the local heads
with no collective (the flash kernel through ``make_flash_attention(mesh
=...)``, the decode kernel under its ``mesh=``); ``proj`` row-parallel and
an all-reduce of the partial sums; ln2 replicated; ``w_in``
column-parallel, GELU; ``w_out`` row-parallel and an all-reduce.  The
embedding is vocab-parallel: a rank looks up the tokens of its
vocabulary slice, zero rows for the others, and the all-reduce of those
rows is exact.  The head is vocab-parallel: each rank's logit columns,
then an all-gather gives every rank the same full logits, so every rank
samples the same tokens.  That is ``2 L + 1`` all-reduces and one
all-gather a forward pass, plus ``2 L`` all-reduces with MAX under int8
weights (``quant.qtensor.qdot``'s row-parallel absmax).  Row-parallel
partial sums are taken in f32 (bf16 weights too) and rounded once to the
stream's dtype after the sum; int8 ones sum their int32 accumulators.

Tensor-parallel and FSDP training (``layout=`` on :func:`forward`,
:func:`_stack` and :func:`per_token_loss`: the
``parallel.sharding.ParamLayout`` the train state was laid out by, whose
``mesh`` is the mesh).  The model reads every split from that layout, so
the weights it gathers are the ones the step stored in shards.  The LM's
training layout is the reference workload's, not serving's:
:data:`LOGICAL_AXES` under :func:`train_rules` (``layers`` over pipe,
``vocab`` over fsdp, ``width`` over tensor when ``tensor`` > 1, else over
fsdp):

- a leaf split over ``fsdp`` (``embed`` [V, D] and ``head`` [D, V] along
  their vocabulary; under ``tensor`` = 1 the block matrices' width dims
  too) is a storage shard, gathered whole before use
  (``collectives.gather_from_group``, whose backward reduce-scatters the
  gradient: ZeRO-3), block leaves layer by layer, and again in backward
  inside a layer under ``remat`` (ZeRO-3's regather).  So the training
  forward never takes serving's vocab-parallel lookup and logits;
- a split over ``tensor`` is Megatron's and only Megatron's: ``qkv``
  (head-aligned per third) and ``w_in`` column-parallel, ``proj`` and
  ``w_out`` row-parallel, the four together or none.  Megatron's *f*
  (``collectives.copy_to_group``) sits at each column-parallel input and
  *g* (``collectives.reduce_from_group``, partial sums in f32, rounded
  once) after each row-parallel product, serving's path too; attention
  runs over the rank's ``h / tp`` heads (K1 forward, K2 and K3 backward,
  through ``make_flash_attention(mesh=...)``).

A layout that splits anything else, or over another axis, is refused.
Every rank of a data shard computes the same replicated stream, so the
gradients of the replicated leaves (``ln1``, ``ln2``, ``pos``) are the
same on every tensor rank.

Pipeline parallelism and sequence-parallel attention wait for later
slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device
from distributeddeeplearning_tpu_torch.ops import flash_attention as _fa
from distributeddeeplearning_tpu_torch.ops import flash_decode as _fd
from distributeddeeplearning_tpu_torch.parallel import collectives as _col
from distributeddeeplearning_tpu_torch.parallel.mesh import tensor_parallel_size
from distributeddeeplearning_tpu_torch.quant.qtensor import (
    QTensor,
    qdot,
    qmatmul as _mm,
    quantize_kv,
    quantized_cache,
)

Params = Dict[str, Any]

ATTENTIONS = ("dense", "flash")

#: the logical axes of the LM's parameters (ref ``workloads/transformer.py``)
LOGICAL_AXES = {
    "embed": ("vocab", None),           # [V, D]
    "pos": None,
    "head": (None, "vocab"),            # [D, V]
    "blocks": {
        "qkv": ("layers", None, "width"),    # [L, D, 3D]
        "proj": ("layers", "width", None),   # [L, D, D]
        "w_in": ("layers", None, "width"),   # [L, D, FF]
        "w_out": ("layers", "width", None),  # [L, FF, D]
        "ln1": ("layers", None),
        "ln2": ("layers", None),
    },
}


def train_rules(tensor: int):
    """The LM's training rules: ``width`` over ``tensor`` when it is above
    1 (Megatron), else over ``fsdp`` (ZeRO-3); ``vocab`` over ``fsdp``."""
    return [("layers", "pipe"), ("vocab", "fsdp"),
            ("width", "tensor" if tensor > 1 else "fsdp")]


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
    as the port's, key for key.  Arrays are copied to ``device``; an int8
    weight (the reference's ``QTensor`` with numpy leaves) becomes the
    port's :class:`QTensor` with the same values, scales, axis and
    block.  A bf16 leaf (numpy's view of a JAX bf16 array has the
    ``bfloat16`` extension dtype, which ``torch.from_numpy`` refuses)
    carries over bit for bit through its 16-bit pattern."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("values", "scales", "axis", "block")):
        return QTensor(params_from_numpy(tree.values, dev),
                       params_from_numpy(tree.scales, dev), tree.axis,
                       tree.block)
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _layer_norm(x, scale):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i`` of the stacked blocks (a QTensor indexes its values and
    scales together)."""
    return {k: v[i] for k, v in blocks.items()}


class _MeshAxis:
    """A mesh axis as the model-parallel paths use it (``tensor`` by
    default): its process ``group``, this rank's ``index`` along it and
    its ``size``."""

    __slots__ = ("group", "index", "size")

    def __init__(self, mesh, axis: str = "tensor"):
        self.size = int(mesh.shape.get(axis, 1))
        self.index = mesh.axis_index(axis)
        self.group = mesh.axis_group(axis)
        if self.group is None:
            raise ValueError(
                f"{axis}={self.size} needs the mesh's {axis} process group "
                "(parallel.create_mesh inside torch.distributed)")


def _tensor_axis(mesh) -> Optional[_MeshAxis]:
    """The tensor axis of ``mesh``; None without one above 1."""
    return _MeshAxis(mesh) if tensor_parallel_size(mesh) > 1 else None


def _column_input(h, tp: Optional[_MeshAxis]):
    """``h`` at the input of a column-parallel product: Megatron's *f*
    (itself forward, its gradient summed over the tensor group)."""
    return h if tp is None else _col.copy_to_group(h, tp.group)


def _row_parallel(x, w, tp: Optional[_MeshAxis]):
    """``x @ w`` where this rank holds rows of ``w`` and the matching
    columns of ``x``: the partial products summed over the tensor group,
    in f32 and rounded once to ``x``'s dtype (int8: the int32
    accumulators, :func:`~..quant.qtensor.qdot`), through Megatron's
    *g*."""
    if tp is None:
        return _mm(x, w)
    if isinstance(w, QTensor):
        return qdot(x, w, group=tp.group)
    return _col.reduce_from_group(x.float() @ w.float(), tp.group).to(x.dtype)


def _token_rows(embed, tokens, tp: Optional[_MeshAxis]):
    """``embed[tokens]``.  Vocab-parallel: this rank holds rows ``[i V/tp,
    (i+1) V/tp)``; it looks up the tokens that fall there, zero rows for
    the others, and the all-reduce (in f32) of those rows is exact."""
    if tp is None:
        return embed[tokens.long()]
    rows = embed.shape[0]
    local = tokens.long() - tp.index * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], embed[local.clamp(0, rows - 1)].float(), 0.0)
    return _col.all_reduce(x, tp.group).to(embed.dtype)


def _logits(x, head, tp: Optional[_MeshAxis]):
    """``x @ head``.  Vocab-parallel: this rank's logit columns, then an
    all-gather gives every rank the whole row, in vocabulary order."""
    out = _mm(x, head)
    if tp is None:
        return out
    parts = _col.all_gather(out, tp.group, tiled=False)  # [tp, ..., V/tp]
    return parts.movedim(0, -2).reshape(*out.shape[:-1], -1)


def _mlp(p, x, tp: Optional[_MeshAxis] = None):
    h = _column_input(_layer_norm(x, p["ln2"]), tp)
    return x + _row_parallel(F.gelu(_mm(h, p["w_in"]), approximate="none"),
                             p["w_out"], tp)


def block_apply(p: Params, x: torch.Tensor, *, num_heads: int,
                attention: str = "dense", return_kv: bool = False,
                attention_fn=None, tp: Optional[_MeshAxis] = None):
    """One pre-LN transformer block; ``p`` leaves are per-layer (no L).

    ``attention``: ``"dense"`` materializes the [b,h,s,s] scores with a
    tril mask; ``"flash"`` runs the causal flash kernel (its plain version
    on the CPU).  ``attention_fn`` overrides both: a causal ``(q, k, v,
    mask, *, dtype)`` (e.g. ``make_flash_attention(mesh=..., causal=
    True)``), called with ``mask=None``.  ``return_kv=True`` also returns
    this layer's ``(k, v)`` in [b, s, h, hd] — views into the qkv
    projection, no copy.  ``tp``: the tensor axis of a TP mesh (module
    docstring); ``p`` is then this rank's slice and h its local heads."""
    b, s, d = x.shape
    hd = d // num_heads
    width = p["qkv"].shape[-1] // 3  # the local heads' width under TP
    heads = width // hd
    h = _column_input(_layer_norm(x, p["ln1"]), tp)
    q, k, v = _mm(h, p["qkv"]).split(width, dim=-1)  # strided views
    split4 = lambda t: t.reshape(b, s, heads, hd)  # noqa: E731
    if attention_fn is not None:
        ctx = attention_fn(split4(q), split4(k), split4(v), None,
                           dtype=x.dtype).reshape(b, s, width).to(x.dtype)
    elif attention == "flash":
        ctx = _fa.flash_attention(
            split4(q), split4(k), split4(v), None, causal=True
        ).reshape(b, s, width)
    elif attention == "dense":
        qh, kh, vh = (split4(t).transpose(1, 2) for t in (q, k, v))
        # the product in the stream dtype, then promoted to f32 by the f32
        # scale as in the reference (a 0-d tensor would not promote a bf16
        # one); the softmax runs in f32 and casts back to the stream dtype
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float() / torch.sqrt(
            torch.tensor(float(hd), device=x.device)
        )
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal, scores, -1e30)
        attn = torch.softmax(scores, dim=-1).to(vh.dtype)
        ctx = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        ctx = ctx.transpose(1, 2).reshape(b, s, width).to(x.dtype)
    else:
        raise ValueError(f"unknown attention {attention!r} (choices: {ATTENTIONS})")
    x = _mlp(p, x + _row_parallel(ctx, p["proj"], tp), tp)
    if return_kv:
        return x, (split4(k), split4(v))
    return x


def _embed(params, tokens, tp: Optional[_MeshAxis] = None):
    max_len = params["pos"].shape[0]
    if tokens.shape[1] > max_len:
        raise ValueError(
            f"sequence length {tokens.shape[1]} exceeds max_len {max_len}"
        )
    return (_token_rows(params["embed"], tokens, tp)
            + params["pos"][: tokens.shape[1]][None])


#: the splits over ``tensor`` the training forward takes (Megatron's):
#: leaf -> its split dim ([L] first)
_MEGATRON = {"blocks/qkv": 2, "blocks/proj": 1, "blocks/w_in": 2,
             "blocks/w_out": 1}


class _TrainShards:
    """How the training forward reaches this rank's slices under a
    ``ParamLayout`` (module docstring): ``tp``, the tensor axis when the
    block matrices are split over it (Megatron's *f* and *g*), and the
    leaves stored in ``fsdp`` blocks with the dim each is gathered along
    (a block leaf's within one layer)."""

    def __init__(self, layout):
        self.fsdp = layout.mesh.axis_group("fsdp")
        self.dims: Dict[str, int] = {}
        tensor: Dict[str, int] = {}
        for name, spec in layout.specs.items():
            block = name.startswith("blocks/")
            for axis in layout.axes(name):
                dims = [i for i, e in enumerate(spec) if e in (axis, (axis,))]
                if axis == "fsdp" and dims and dims[0] >= block:
                    self.dims[name.rsplit("/", 1)[-1]] = dims[0] - block
                elif axis == "tensor" and dims:
                    tensor[name] = dims[0]
                else:
                    tensor[name] = -1  # refused below
        if tensor and tensor != _MEGATRON:
            raise ValueError(
                "the LM's training forward takes fsdp splits of any leaf but "
                "the layer dim, and over tensor only Megatron's "
                f"{_MEGATRON}; the layout splits {layout.specs}")
        self.tp = _MeshAxis(layout.mesh) if tensor else None

    def param(self, t, name: str):
        """Leaf (or one layer of) ``name`` whole: gathered over fsdp when
        stored in blocks (its gradient reduce-scattered back)."""
        dim = self.dims.get(name)
        return t if dim is None else _col.gather_from_group(t, dim, self.fsdp)

    def block(self, p, x, **kw):
        """One layer from this rank's slices of it: its fsdp leaves
        gathered (inside a checkpointed layer, again in backward)."""
        return block_apply({k: self.param(v, k) for k, v in p.items()}, x,
                           tp=self.tp, **kw)


def _train_shards(layout) -> Optional[_TrainShards]:
    """The training forward's view of ``layout``; None when it splits
    nothing (data parallelism: replicated weights)."""
    return None if layout is None or not layout.sharded else _TrainShards(layout)


def _stack(blocks: Params, x, *, num_heads: int, attention: str = "dense",
           remat: bool = False, attention_fn=None, layout=None):
    """The layer loop (the reference's ``_stack_scan``).

    ``remat=True`` runs each layer under ``torch.utils.checkpoint``, so
    backward recomputes the layer from its input instead of keeping its
    activations: activation memory O(1) in depth, at the price of a second
    forward per layer (the flash forward kernel then launches twice per
    layer and step).  ``layout``: the training layout (module docstring);
    ``blocks`` are this rank's slices."""
    shards = _train_shards(layout)
    fn = block_apply if shards is None else shards.block
    if shards is not None and attention == "flash" and attention_fn is None:
        attention_fn = _fa.make_flash_attention(mesh=layout.mesh, causal=True)
    for i in range(blocks["qkv"].shape[0]):
        p = _layer(blocks, i)
        if remat:
            x = checkpoint(fn, p, x, num_heads=num_heads, attention=attention,
                           attention_fn=attention_fn, use_reentrant=False)
        else:
            x = fn(p, x, num_heads=num_heads, attention=attention,
                   attention_fn=attention_fn)
    return x


def _train_embed(params, tokens, shards: Optional[_TrainShards]):
    """The input stream: the (gathered) embedding rows plus positions."""
    if shards is None:
        return _embed(params, tokens)
    return _embed({k: shards.param(params[k], k) for k in ("embed", "pos")},
                  tokens)


def _train_head(params, shards: Optional[_TrainShards]):
    return params["head"] if shards is None else shards.param(params["head"], "head")


def forward(params, tokens, *, num_heads: int, attention: str = "dense",
            remat: bool = False, attention_fn=None, layout=None):
    """Next-token logits [b, s, vocab] for int tokens [b, s].

    ``remat=True`` rematerializes each layer in backward (see
    :func:`_stack`); ``attention_fn`` as in :func:`block_apply`.
    ``layout``: tensor-parallel and FSDP training (module docstring), the
    train state's ``ParamLayout``: ``params`` are this rank's slices, the
    logits whole on every rank."""
    shards = _train_shards(layout)
    x = _stack(params["blocks"], _train_embed(params, tokens, shards),
               num_heads=num_heads, attention=attention, remat=remat,
               attention_fn=attention_fn, layout=layout)
    return _mm(x, _train_head(params, shards))


def forward_prefill(params, tokens, *, num_heads: int, attention: str = "dense",
                    mesh=None):
    """Prompt pass for the serving engine: ``(logits [b, s, vocab], k, v)``
    with k/v in the cache layout [b, L, s, h, hd] — :func:`forward` plus
    each layer's key/value projections.  ``mesh``: tensor-parallel (module
    docstring); k/v then hold the rank's heads, the logits are whole, and
    ``attention="flash"`` runs K1 through ``make_flash_attention(mesh)``."""
    tp = _tensor_axis(mesh)
    attention_fn = (_fa.make_flash_attention(mesh=mesh, causal=True)
                    if tp is not None and attention == "flash" else None)
    x = _embed(params, tokens, tp)
    ks, vs = [], []
    for i in range(params["blocks"]["qkv"].shape[0]):
        x, (k, v) = block_apply(_layer(params["blocks"], i), x,
                                num_heads=num_heads, attention=attention,
                                return_kv=True, attention_fn=attention_fn, tp=tp)
        ks.append(k)
        vs.append(v)
    return (_logits(x, params["head"], tp), torch.stack(ks, dim=1),
            torch.stack(vs, dim=1))


def _write_kv(k_l, v_l, k_s, v_s, idx, k_new, v_new) -> None:
    """Write new K/V rows into a cache layer at the advanced index ``idx``,
    IN PLACE (the counterpart of the reference's ``.at[idx].set``); an
    int8 cache (``k_s``/``v_s`` given) quantizes each row with its own
    scale.  Duplicate targets occur only at the paged pool's scratch page
    (inactive decode lanes, chunk padding past the table): there the last
    write wins and nothing ever reads it."""
    if k_s is not None:
        for vals, scales, new in ((k_l, k_s, k_new), (v_l, v_s, v_new)):
            q, s = quantize_kv(new)
            vals.index_put_(idx, q)
            scales.index_put_(idx, s)
    else:
        k_l.index_put_(idx, k_new.to(k_l.dtype))
        v_l.index_put_(idx, v_new.to(v_l.dtype))


def _layer_cache(cache, i: int):
    """Layer ``i``'s views ``(k, v, k_scale, v_scale)`` of a dense cache or
    a page pool (scales None on an f32 cache); nothing is copied."""
    if quantized_cache(cache):
        return (cache["k"][:, i], cache["v"][:, i], cache["k_scale"][:, i],
                cache["v_scale"][:, i])
    return cache["k"][:, i], cache["v"][:, i], None, None


def _qkv_rows(p, x, num_heads: int):
    """Pre-LN qkv projection of ``x`` [n, d]: q, k, v each [n, h, hd]
    (strided views of one projection; h the local heads of a TP slice)."""
    n, d = x.shape
    hd = d // num_heads
    width = p["qkv"].shape[-1] // 3
    h = _layer_norm(x, p["ln1"])
    q, k, v = _mm(h, p["qkv"]).split(width, dim=-1)
    return tuple(t.reshape(n, width // hd, hd) for t in (q, k, v))


def _block_decode(p, x, k_l, v_l, pos, *, num_heads: int, k_s=None, v_s=None,
                  kernel: str = "auto", mesh=None, tp=None):
    """One block's single-token decode against its cache layer.

    ``x``: [B, d] residual stream; ``k_l``/``v_l``: [B, S, h, hd] views of
    this layer of the cache (``k_s``/``v_s`` [B, S, h] f32 scales on an
    int8 cache); ``pos``: [B] the position each slot's token occupies.  The
    new token's K/V are written into the cache at ``pos`` IN PLACE
    (quantized on int8) before attention, which sees positions ``<= pos``
    — on int8 with the exact f32 current token overlaid."""
    b, d = x.shape
    q, k_t, v_t = _qkv_rows(p, x, num_heads)
    rows = torch.arange(b, device=x.device)
    _write_kv(k_l, v_l, k_s, v_s, (rows, pos.long()), k_t, v_t)
    ctx = _fd.decode_attention_dense(
        q, k_l, v_l, k_s, v_s, k_t, v_t, pos, kernel=kernel, mesh=mesh,
    ).reshape(b, -1).to(x.dtype)
    return _mlp(p, x + _row_parallel(ctx, p["proj"], tp), tp)


def forward_decode(params, token, cache, pos, *, num_heads: int,
                   kernel: str = "auto", mesh=None):
    """Single-token decode step: next-token logits from the KV cache.

    ``token``/``pos``: [B] int — each slot's current token and the position
    it occupies; ``cache``: ``{"k", "v"}`` each [B, L, S, h, hd], plus
    ``{"k_scale", "v_scale"}`` [B, L, S, h] under the int8 layout
    (:mod:`..serve.kv_cache`).  The token's K/V are written into ``cache``
    at ``pos`` in every layer, in place; positions ``> pos`` are masked, so
    stale K/V of a previous occupant never reach attention.  ``mesh``:
    tensor-parallel (module docstring): params and cache are the rank's
    slices, the logits whole.

    Returns ``(logits [B, vocab], cache)`` — the same, updated, cache."""
    tp = _tensor_axis(mesh)
    x = _token_rows(params["embed"], token, tp) + params["pos"][pos.long()]
    for i in range(params["blocks"]["qkv"].shape[0]):
        k_l, v_l, k_s, v_s = _layer_cache(cache, i)
        x = _block_decode(
            _layer(params["blocks"], i), x, k_l, v_l, pos,
            num_heads=num_heads, k_s=k_s, v_s=v_s, kernel=kernel, mesh=mesh, tp=tp,
        )
    return _logits(x, params["head"], tp), cache


def _block_decode_paged(p, x, k_l, v_l, pos, block_tables, *, num_heads: int,
                        k_s=None, v_s=None, kernel: str = "auto", mesh=None,
                        tp=None):
    """One block's single-token decode against a PAGED cache layer.

    ``k_l``/``v_l``: [pages, page_size, h, hd] — this layer's view of the
    pool (``k_s``/``v_s`` [pages, page_size, h] on int8); ``block_tables``:
    [B, nb] int32 mapping each slot's logical pages to physical ones.  Same
    write-then-attend order as :func:`_block_decode`: the token's K/V go to
    ``(table[pos // ps], pos % ps)``, then attention runs over the slot's
    pages with positions ``<= pos`` visible.  Released and mid-prefill
    slots point every table entry at the scratch page and sit at pos 0,
    so their writes land there and never touch a live page."""
    b, d = x.shape
    page_size = k_l.shape[1]
    q, k_t, v_t = _qkv_rows(p, x, num_heads)
    rows = torch.arange(b, device=x.device)
    pos_l = pos.long()
    page = block_tables.long()[rows, pos_l // page_size]  # [b] physical
    _write_kv(k_l, v_l, k_s, v_s, (page, pos_l % page_size), k_t, v_t)
    ctx = _fd.decode_attention_paged(
        q, k_l, v_l, k_s, v_s, k_t, v_t, pos, block_tables, kernel=kernel,
        mesh=mesh,
    ).reshape(b, -1).to(x.dtype)
    return _mlp(p, x + _row_parallel(ctx, p["proj"], tp), tp)


def forward_decode_paged(params, token, cache, pos, block_tables, *,
                         num_heads: int, kernel: str = "auto", mesh=None):
    """Single-token decode step over the PAGED cache layout.

    Same contract as :func:`forward_decode`, but ``cache`` is the page
    pool ``{"k", "v"}`` each [pages, L, page_size, h, hd] (plus int8 scale
    pools) and ``block_tables`` ([B, nb] int32) maps each slot's logical
    pages to physical ones.  The gathered page view is the dense key
    sequence, padded with masked positions up to ``nb * page_size``, so
    the math is the dense path's.  ``mesh``: as :func:`forward_decode`'s.
    Returns ``(logits [B, vocab], cache)``, the pool updated in place."""
    tp = _tensor_axis(mesh)
    x = _token_rows(params["embed"], token, tp) + params["pos"][pos.long()]
    for i in range(params["blocks"]["qkv"].shape[0]):
        k_l, v_l, k_s, v_s = _layer_cache(cache, i)
        x = _block_decode_paged(
            _layer(params["blocks"], i), x, k_l, v_l, pos, block_tables,
            num_heads=num_heads, k_s=k_s, v_s=v_s, kernel=kernel, mesh=mesh, tp=tp,
        )
    return _logits(x, params["head"], tp), cache


def forward_prefill_chunk(params, tokens, cache, block_table, offset: int, *,
                          num_heads: int, kernel: str = "auto", mesh=None):
    """One CHUNK of a prompt prefilled against the paged cache.

    ``tokens`` [1, C] occupy logical positions ``[offset, offset + C)`` of
    ONE sequence whose physical pages are ``block_table`` ([nb] int32).
    Each layer writes the chunk's K/V into the pages first (quantized on
    an int8 pool), then attends over the page view: chunk token ``i`` sees
    every cached position ``<= offset + i`` — the earlier chunks, shared
    prefix pages and the causal part of its own chunk.  On int8 the own
    chunk is read back quantized too (no overlay), so the logits do not
    depend on where the chunk boundaries fell: a prefix hit, which shifts
    the offset, computes what a cold run computes.

    Positions past the block table (final-chunk padding) go to the scratch
    page and the position index is clamped to the table; their outputs
    are garbage that the caller ignores.  ``mesh``: as
    :func:`forward_decode`'s.  Returns ``(logits [1, C, vocab], cache)``,
    the pool updated in place."""
    b, C = tokens.shape
    if b != 1:
        raise ValueError(f"chunked prefill is per-sequence, got batch {b}")
    nb = block_table.shape[0]
    page_size = cache["k"].shape[2]
    dev = tokens.device
    posns = offset + torch.arange(C, device=dev)  # [C] logical positions
    page_idx = posns // page_size
    pages = torch.where(
        page_idx < nb,
        block_table.long()[page_idx.clamp(max=nb - 1)],
        0,  # the pool's scratch page (serve.kv_cache.SCRATCH_PAGE)
    )
    idx = (pages, posns % page_size)
    max_len = params["pos"].shape[0]
    tp = _tensor_axis(mesh)
    x = (_token_rows(params["embed"], tokens[0], tp)
         + params["pos"][posns.clamp(max=max_len - 1)])  # [C, d]
    for i in range(params["blocks"]["qkv"].shape[0]):
        p = _layer(params["blocks"], i)
        k_l, v_l, k_s, v_s = _layer_cache(cache, i)
        q, k_c, v_c = _qkv_rows(p, x, num_heads)
        _write_kv(k_l, v_l, k_s, v_s, idx, k_c, v_c)
        ctx = _fd.chunk_attention(
            q, k_l, v_l, k_s, v_s, block_table, posns, kernel=kernel, mesh=mesh,
        ).reshape(C, -1).to(x.dtype)
        x = _mlp(p, x + _row_parallel(ctx, p["proj"], tp), tp)
    return _logits(x, params["head"], tp)[None], cache


_F32_ONLY = (
    "speculative verification supports the f32 cache layout only (the "
    "acceptance rule extends the decode==full-forward bit-exactness pin, "
    "which the int8 grid breaks)"
)


def _verify_inputs(params, tokens, pos, draft_len):
    """What both verify layouts share: ``posmat`` [B, K1] (long), the
    valid-column mask ``j <= draft_len`` and the embedded inputs, the
    position embedding clamped at ``max_len - 1``."""
    K1 = tokens.shape[1]
    cols = torch.arange(K1, device=tokens.device)
    posmat = pos.long()[:, None] + cols[None]
    valid = cols[None] <= draft_len.long()[:, None]
    max_len = params["pos"].shape[0]
    x = (params["embed"][tokens.long()]
         + params["pos"][posmat.clamp(max=max_len - 1)])  # [B, K1, d]
    return posmat, valid, x


def _block_verify(p, x, k_l, v_l, write, attend, num_heads: int):
    """One block of the verify pass: qkv, write the K/V (``write``), attend
    (``attend``), then the residual MLP — on [B, K1, d] rows."""
    b, K1, d = x.shape
    q, k_c, v_c = _qkv_rows(p, x.reshape(b * K1, d), num_heads)
    split = lambda t: t.reshape(b, K1, num_heads, d // num_heads)  # noqa: E731
    write(k_l, v_l, split(k_c), split(v_c))
    ctx = attend(split(q), k_l, v_l).reshape(b, K1, d).to(x.dtype)
    return _mlp(p, x + _mm(ctx, p["proj"]))


def forward_verify(params, tokens, cache, pos, draft_len, *, num_heads: int,
                   kernel: str = "auto"):
    """Batched K+1-token verification against the DENSE cache — the
    verifier half of speculative decoding (``spec/``).

    ``tokens`` [B, K1]: column 0 is each slot's pending token, columns
    1..K its drafts; ``pos`` [B]: the position column 0 occupies;
    ``draft_len`` [B] in [0, K1-1]: how many drafts are real (0 is exactly
    a decode step).  Write-then-attend, as a prefill chunk: each layer
    writes the K/V of every VALID column (``j <= draft_len``) at ``pos +
    j``, IN PLACE, then query ``j`` attends over positions ``<= pos + j``
    (the decode kernel at ``nq = K1``), so column ``j`` sees exactly the
    history a sequential decode walk would have.

    Invalid columns write nothing: their targets wrap to ``(pos + j) % S``
    (K1 consecutive positions are distinct modulo S, so no target repeats
    and none leaves the row) and they write back what is there — the
    reference drops them as out-of-bounds scatters.  Their logits are
    garbage the caller masks.  Returns ``(logits [B, K1, vocab], cache)``;
    the caller rolls back positions past the accepted prefix.  f32 cache
    only."""
    if quantized_cache(cache):
        raise ValueError(_F32_ONLY)
    b, K1 = tokens.shape
    S = cache["k"].shape[2]
    posmat, valid, x = _verify_inputs(params, tokens, pos, draft_len)
    rows = torch.arange(b, device=tokens.device)[:, None]
    idx = (rows, posmat % S)
    keep = valid[..., None, None]
    posmat32 = posmat.to(torch.int32)

    def write(k_l, v_l, k_c, v_c):
        for leaf, new in ((k_l, k_c), (v_l, v_c)):
            leaf.index_put_(idx, torch.where(keep, new.to(leaf.dtype), leaf[idx]))

    def attend(q, k_l, v_l):
        return _fd.verify_attention_dense(q, k_l, v_l, posmat32, kernel=kernel)

    for i in range(params["blocks"]["qkv"].shape[0]):
        k_l, v_l, _, _ = _layer_cache(cache, i)
        x = _block_verify(_layer(params["blocks"], i), x, k_l, v_l, write,
                          attend, num_heads)
    return _mm(x, params["head"]), cache


def forward_verify_paged(params, tokens, cache, pos, draft_len, block_tables,
                         *, num_heads: int, kernel: str = "auto"):
    """Batched K+1-token verification over the PAGED pool.

    :func:`forward_verify`'s contract with the key space routed through
    ``block_tables`` [B, nb] int32: valid columns write to
    ``(table[(pos+j) // page_size], (pos+j) % page_size)``; invalid or
    out-of-table columns go to scratch page 0, row 0 (decode's dustbin —
    the only target that may repeat); attention runs through the tables
    masked to ``<= pos + j`` per query.  Returns ``(logits [B, K1,
    vocab], cache)``, the pool updated in place.  f32 pool only."""
    if quantized_cache(cache):
        raise ValueError(_F32_ONLY)
    b, K1 = tokens.shape
    nb = block_tables.shape[1]
    page_size = cache["k"].shape[2]
    posmat, valid, x = _verify_inputs(params, tokens, pos, draft_len)
    rows = torch.arange(b, device=tokens.device)[:, None]
    page_idx = posmat // page_size
    in_range = valid & (page_idx < nb)
    pages = torch.where(
        in_range, block_tables.long()[rows, page_idx.clamp(max=nb - 1)], 0)
    offs = torch.where(in_range, posmat % page_size, 0)
    posmat32 = posmat.to(torch.int32)

    def write(k_l, v_l, k_c, v_c):
        _write_kv(k_l, v_l, None, None, (pages, offs), k_c, v_c)

    def attend(q, k_l, v_l):
        return _fd.verify_attention_paged(q, k_l, v_l, block_tables, posmat32,
                                          kernel=kernel)

    for i in range(params["blocks"]["qkv"].shape[0]):
        k_l, v_l, _, _ = _layer_cache(cache, i)
        x = _block_verify(_layer(params["blocks"], i), x, k_l, v_l, write,
                          attend, num_heads)
    return _mm(x, params["head"]), cache


def per_token_loss(params, tokens, *, num_heads: int, attention: str = "dense",
                   remat: bool = False, loss_chunk: Optional[int] = None,
                   attention_fn=None, layout=None):
    """Per-position next-token cross-entropy [b, s-1], f32.

    Same math as ``next_token_loss(forward(...), tokens)`` per position.
    ``loss_chunk`` fuses the head matmul into the loss over sequence chunks
    of that size (it must divide s-1): each chunk's logits, log-sum-exp and
    target gather run under ``torch.utils.checkpoint``, so backward
    recomputes the chunk's logits instead of keeping them and the full
    [b, s, vocab] logits never exist.  ``None`` (or a chunk >= s-1) is the
    one-shot head matmul.  ``layout`` as in :func:`forward`."""
    s = tokens.shape[1]
    if s < 2:
        raise ValueError(f"next-token loss needs sequence length >= 2, got {s}")
    shards = _train_shards(layout)
    x = _stack(params["blocks"], _train_embed(params, tokens, shards),
               num_heads=num_heads, attention=attention, remat=remat,
               attention_fn=attention_fn, layout=layout)
    h = x[:, :-1]  # position t predicts token t+1
    labels = tokens[:, 1:].long()
    n = s - 1
    head = _train_head(params, shards)

    def chunk_ce(hc, lc):
        logits = (hc @ head).float()
        tgt = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - tgt

    if loss_chunk is None or loss_chunk >= n:
        return chunk_ce(h, labels)
    if n % loss_chunk:
        raise ValueError(f"loss_chunk {loss_chunk} must divide seq_len-1 = {n}")
    return torch.cat([
        checkpoint(chunk_ce, h[:, i:i + loss_chunk], labels[:, i:i + loss_chunk],
                   use_reentrant=False)
        for i in range(0, n, loss_chunk)
    ], dim=1)


def next_token_loss(logits, tokens):
    """Causal LM loss: predict token t+1 from positions <= t, through the
    port's one cross-entropy (``train.step.cross_entropy_loss``) on the
    shifted (strided, uncopied) logits."""
    from distributeddeeplearning_tpu_torch.train.step import cross_entropy_loss

    s = tokens.shape[1]
    if s < 2:
        raise ValueError(f"next-token loss needs sequence length >= 2, got {s}")
    return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])

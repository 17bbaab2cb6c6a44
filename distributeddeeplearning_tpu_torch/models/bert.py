"""The BERT encoder of ``models/bert.py``, in PyTorch.

Parameters are a nested dict of tensors under the flax tree's own names
(``token_embed/embedding``, ``layer{i}/attention/query/kernel``, ...), with
the reference's DenseGeneral shapes: the query, key and value kernels are
[hidden, heads, head_dim] and the out kernel [heads, head_dim, hidden], so
``train/state.tree_zip`` pairs a port tree with a JAX one key by key and
:func:`params_from_numpy` carries weights over unchanged.  Blocks are
plain functions; :class:`BertEncoder` binds a config, a compute dtype and
an attention function as the flax module does.

Rounding follows flax at the compute dtype: a Dense casts its input,
kernel and bias to the dtype and adds the bias in it; an Embed casts its
table, then gathers; LayerNorm keeps its statistics, scale and bias in f32
(E[x^2] - E[x]^2 clipped at 0, eps 1e-12) and casts once at the end; the
pooler is tanh of a Dense on the CLS row and the head's logits come back in
f32.  Post-LN order, exact GELU, dropout after the embedding LayerNorm,
after the attention output and after the MLP.

Dropout draws from an explicit ``torch.Generator`` (the reference draws
from ``jax.random``, which torch cannot reproduce): keep ~ Bernoulli(1 -
rate), ``where(keep, x / (1 - rate), 0)``.  Under ``remat="full"`` each
layer runs under ``torch.utils.checkpoint``, and the generator is rewound
to the layer's start when backward recomputes it, so the recomputed masks
are the forward's.

``remat="dots"`` runs each layer under ``torch.utils.checkpoint`` with a
selective policy (:func:`remat`): the outputs of the matrix products
(``mm``, ``bmm``, ``addmm``, ``baddbmm``) are saved and everything else is
recomputed in the backward, as ``jax.checkpoint_policies.checkpoint_dots``
does; the flash ``autograd.Function`` is recomputed, as the Pallas call is
under that policy.  Dropout masks are rewound as under ``"full"``.

With ``num_experts`` > 0, layer i's FFN is the mixture of experts of
:mod:`.moe` (params ``layer{i}/moe_mlp``) where ``(i + 1) % moe_every_n ==
0``; in training each such layer hands its load-balance term to
:func:`.moe.sow`, which the train step collects.

``attention_fn`` is :func:`dot_product_attention` (the reference's default,
bf16 scores) or ``ops.flash_attention.make_flash_attention()``, whose
kernels take the padding mask as their key-padding bias.

Model axes (``layout=`` on :func:`forward`: the train state's
``parallel.sharding.ParamLayout``, whose ``mesh`` is the mesh).  Each
leaf carries the reference's logical axes (:func:`logical_axes`, ref
``models/bert.py`` and ``models/moe.py``), the reference workload's rules
map them to mesh axes, and the model reads every split from the layout
(never from rules of its own), refusing one it cannot run:

- a leaf split over ``fsdp`` (embeddings, kernels and biases over their
  ``embed``, ``mlp`` or ``heads`` dim, the pooler, the router) is a
  storage shard, gathered whole before use by
  ``collectives.gather_from_group`` (its backward reduce-scatters the
  gradient: ZeRO-3), a layer's leaves inside that layer (again in the
  backward under ``remat``);
- a split over ``tensor`` is Megatron's and only Megatron's: the query,
  key and value kernels and biases column-parallel by heads (*f*,
  ``collectives.copy_to_group``, once at their shared input; attention
  over the rank's heads), the out kernel row-parallel (*g*,
  ``collectives.reduce_from_group``, partial sums in f32, rounded once,
  the bias added after), ``mlp_in`` column- and ``mlp_out`` row-parallel
  likewise, and an expert FFN's ``w_in``/``b_in`` and ``w_out`` the same
  way (:mod:`.moe`);
- a split over ``expert`` is the expert FFN's own: ``w_in``, ``b_in``,
  ``w_out``, ``b_out`` by expert, the router kernel by its expert columns
  (gathered whole: every rank routes whole), :mod:`.moe`'s expert path.

LayerNorms and the head stay replicated.  Every rank of a data shard
computes the same replicated stream, so its dropout masks (drawn from
the shard's generator on activations every such rank holds whole: after
each *g*) and the gradients of its replicated leaves are the same on
every tensor and expert rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device
from distributeddeeplearning_tpu_torch.models import moe, register
from distributeddeeplearning_tpu_torch.models import pipelined_transformer as _pt
from distributeddeeplearning_tpu_torch.parallel import collectives as _col

Params = Dict[str, Any]
AttentionFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1
    num_classes: int = 2  # sequence-classification head (fine-tune target)
    num_experts: int = 0
    moe_every_n: int = 2
    moe_capacity_factor: float = 1.25
    remat: str = "none"


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
)


REMAT_POLICIES = ("none", "full", "dots")

#: the ops whose outputs ``remat="dots"`` keeps: the matrix products
#: (``jax.checkpoint_policies.checkpoint_dots`` keeps every dot_general)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def check_remat(policy: str) -> None:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {policy!r}")


def remat(policy: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the rematerialisation ``policy``:
    ``"none"`` runs it; ``"full"`` saves only its inputs and recomputes it
    in the backward; ``"dots"`` also saves the outputs of its matrix
    products (a selective ``torch.utils.checkpoint`` policy)."""
    if policy == "none":
        return fn(*args, **kwargs)
    extra = {}
    if policy == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                _save_dots)
    return checkpoint(fn, *args, use_reentrant=False, **extra, **kwargs)


def _check_config(cfg: BertConfig) -> None:
    check_remat(cfg.remat)
    if cfg.hidden_size % cfg.num_heads:
        raise ValueError(f"hidden_size {cfg.hidden_size} not divisible by "
                         f"num_heads {cfg.num_heads}")


def uses_moe(cfg: BertConfig, i: int) -> bool:
    """Whether layer ``i``'s FFN is a mixture of experts (ref
    ``models/bert.py:261-265``)."""
    return cfg.num_experts > 0 and (i + 1) % max(cfg.moe_every_n, 1) == 0


def dot_product_attention(q, k, v, mask, *, dtype):
    """The reference's default attention, [B, S, H, D] in and out: scores
    as a product in q's dtype divided by sqrt(D) rounded to that dtype (at
    bf16 and D 32 that is 5.65625), masked with the dtype's most negative
    finite value, softmax in f32 cast back to ``dtype``, then P V in the
    operands' dtype."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    scores = scores / torch.tensor(math.sqrt(depth), dtype=q.dtype).item()
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def init_params(
    config: BertConfig = BERT_BASE,
    generator: Optional[torch.Generator] = None,
    *,
    device: DeviceLike = None,
    token_types: bool = False,
) -> Params:
    """Random f32 parameters in the reference's tree: Normal(0, 0.02)
    embeddings and kernels, zero biases, unit LayerNorm scales; the head's
    kernel lecun-normal (std 1/sqrt(hidden)), as flax's Dense default.
    ``type_embed`` exists only with ``token_types=True``, as the flax tree
    has it only when init saw ``token_type_ids``.  Draws come from
    ``generator`` (default: seed 0) in tree order and differ from
    ``jax.random``'s; carry JAX weights over with :func:`params_from_numpy`."""
    _check_config(config)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c = config
    hd = c.hidden_size // c.num_heads

    def nrm(*shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ln():
        return {"scale": torch.ones(c.hidden_size, device=dev),
                "bias": zeros(c.hidden_size)}

    def dense(n_in, n_out):
        return {"kernel": nrm(n_in, n_out), "bias": zeros(n_out)}

    params: Params = {
        "token_embed": {"embedding": nrm(c.vocab_size, c.hidden_size)},
        "position_embed": {"embedding": nrm(c.max_position_embeddings,
                                            c.hidden_size)},
    }
    if token_types:
        params["type_embed"] = {"embedding": nrm(
            c.type_vocab_size, c.hidden_size, std=c.hidden_size ** -0.5)}
    params["embed_ln"] = ln()
    for i in range(c.num_layers):
        qkv = {name: {"kernel": nrm(c.hidden_size, c.num_heads, hd),
                      "bias": zeros(c.num_heads, hd)}
               for name in ("query", "key", "value")}
        qkv["out"] = {"kernel": nrm(c.num_heads, hd, c.hidden_size),
                      "bias": zeros(c.hidden_size)}
        layer = {"attention": qkv, "attention_ln": ln()}
        if uses_moe(c, i):
            layer["moe_mlp"] = moe.init_params(c.hidden_size, c.intermediate_size,
                                               c.num_experts, nrm)
        else:
            layer["mlp_in"] = dense(c.hidden_size, c.intermediate_size)
            layer["mlp_out"] = dense(c.intermediate_size, c.hidden_size)
        layer["mlp_ln"] = ln()
        params[f"layer{i}"] = layer
    params["pooler"] = dense(c.hidden_size, c.hidden_size)
    params["head"] = {"kernel": nrm(c.hidden_size, c.num_classes,
                                    std=c.hidden_size ** -0.5),
                      "bias": zeros(c.num_classes)}
    return params


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """The JAX package's BERT parameters (unboxed, ``jax.tree.map(np.asarray,
    ...)``) as the port's, key for key, on ``device``."""
    return _pt.params_from_numpy(tree, device)


def logical_axes(config: BertConfig = BERT_BASE, *, token_types: bool = False):
    """The logical axes of every leaf of :func:`init_params`' tree, as the
    reference's flax modules declare them (ref ``models/bert.py``: the
    embeddings ``("vocab", "embed")`` and ``(None, "embed")``, q/k/v
    ``("embed", "heads", "kv")`` and their biases ``("heads", "kv")``, the
    out kernel ``("heads", "kv", "embed")``, the MLP ``("embed", "mlp")``
    and ``("mlp", "embed")``, the pooler ``("embed", "embed_out")``;
    ``models/moe.py``: :data:`.moe.LOGICAL_AXES`); ``()`` for a leaf the
    reference leaves unannotated (LayerNorms, the head, ``type_embed``)."""
    ln = {"scale": (), "bias": ()}

    def dense(kernel):
        return {"kernel": kernel, "bias": kernel[-1:]}

    axes: Dict[str, Any] = {"token_embed": {"embedding": ("vocab", "embed")},
                            "position_embed": {"embedding": (None, "embed")}}
    if token_types:
        axes["type_embed"] = {"embedding": ()}
    axes["embed_ln"] = dict(ln)
    for i in range(config.num_layers):
        att = {name: {"kernel": ("embed", "heads", "kv"), "bias": ("heads", "kv")}
               for name in ("query", "key", "value")}
        att["out"] = {"kernel": ("heads", "kv", "embed"), "bias": ("embed",)}
        layer: Dict[str, Any] = {"attention": att, "attention_ln": dict(ln)}
        if uses_moe(config, i):
            layer["moe_mlp"] = {k: (dict(v) if isinstance(v, dict) else v)
                                for k, v in moe.LOGICAL_AXES.items()}
        else:
            layer["mlp_in"] = dense(("embed", "mlp"))
            layer["mlp_out"] = dense(("mlp", "embed"))
        layer["mlp_ln"] = dict(ln)
        axes[f"layer{i}"] = layer
    axes["pooler"] = dense(("embed", "embed_out"))
    axes["head"] = {"kernel": (), "bias": ()}
    return axes


#: the splits over ``tensor`` the model runs (Megatron's): leaf name within
#: a layer -> its split dim
_MEGATRON = {
    **{f"attention/{n}/kernel": 1 for n in ("query", "key", "value")},
    **{f"attention/{n}/bias": 0 for n in ("query", "key", "value")},
    "attention/out/kernel": 0, "mlp_in/kernel": 1, "mlp_in/bias": 0,
    "mlp_out/kernel": 0, "moe_mlp/w_in": 2, "moe_mlp/b_in": 1, "moe_mlp/w_out": 1,
}
#: the splits over ``expert``: the expert weights by expert, the router by
#: its expert columns (gathered whole)
_EXPERT = {"moe_mlp/w_in": 0, "moe_mlp/b_in": 0, "moe_mlp/w_out": 0,
           "moe_mlp/b_out": 0, "moe_mlp/router/kernel": 1}


class _Shards:
    """How the forward reaches this rank's slices under a ``ParamLayout``
    (module docstring): ``gathers`` maps a leaf to the ``(dim, group)``
    pairs it is gathered along (fsdp, and the router's expert columns),
    ``tp`` and ``ep`` the tensor and expert axes when the layout splits
    over them."""

    def __init__(self, layout):
        mesh = layout.mesh
        self.gathers: Dict[str, list] = {}
        split = {"tensor": {}, "expert": {}}
        refused = []
        for name, spec in layout.specs.items():
            within = name.split("/", 1)[1] if name.startswith("layer") else name
            for axis in layout.axes(name):
                dims = [i for i, e in enumerate(spec) if e in (axis, (axis,))]
                if axis == "fsdp" and dims:
                    self.gathers.setdefault(name, []).append(
                        (dims[0], mesh.axis_group("fsdp")))
                elif axis in split and dims and {"tensor": _MEGATRON,
                                                 "expert": _EXPERT}[axis].get(
                                                     within) == dims[0]:
                    split[axis][name] = within
                    if within == "moe_mlp/router/kernel":
                        self.gathers.setdefault(name, []).append(
                            (dims[0], mesh.axis_group("expert")))
                else:
                    refused.append((name, axis))
        for axis, table in (("tensor", _MEGATRON), ("expert", _EXPERT)):
            # all of the layers' splits over the axis, or none
            want = {n for n in layout.specs if n.startswith("layer")
                    and n.split("/", 1)[1] in table} if split[axis] else set()
            if set(split[axis]) != want:
                refused.append((sorted(want - set(split[axis])), axis))
        if refused:
            raise ValueError(
                "BERT's forward takes fsdp splits of any leaf, over tensor only "
                f"Megatron's {sorted(_MEGATRON)} and over expert only "
                f"{sorted(_EXPERT)}, each in every layer; the layout splits "
                f"{refused} otherwise")
        self.tp = _pt._MeshAxis(mesh, "tensor") if split["tensor"] else None
        self.ep = _pt._MeshAxis(mesh, "expert") if split["expert"] else None

    def gather(self, tree, prefix: str):
        """``tree`` (the leaves under ``prefix``) with every stored shard
        gathered whole (its gradient reduce-scattered back)."""
        if isinstance(tree, dict):
            return {k: self.gather(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        for dim, group in self.gathers.get(prefix, ()):
            tree = _col.gather_from_group(tree, dim, group)
        return tree


def _shards(layout) -> Optional[_Shards]:
    """The forward's view of ``layout``; None when it splits nothing."""
    return None if layout is None or not layout.sharded else _Shards(layout)


def _dense(p, x, dtype):
    """flax Dense at ``dtype``: input, [in, out] kernel and bias cast, the
    bias added in the dtype."""
    w, b = p["kernel"].to(dtype), p["bias"].to(dtype)
    return torch.matmul(x.to(dtype), w) + b


def _layer_norm(p, x, eps: float, dtype):
    """flax LayerNorm: f32 statistics (fast variance, clipped at 0), f32
    scale and bias, one cast to ``dtype`` at the end."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * p["scale"].float()) + p["bias"].float()
    return y.to(dtype)


def _dropout(x, rate: float, generator: Optional[torch.Generator]):
    if generator is None:
        raise ValueError("BERT: dropout in training needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def _row_parallel(p, x, dtype, tp):
    """flax Dense where this rank holds rows of the kernel and the
    matching columns of ``x`` (``tp``): the LM's row-parallel product
    (partial sums over the tensor group in f32, rounded once: Megatron's
    *g*), the bias added after the sum."""
    y = _pt._row_parallel(x.to(dtype), p["kernel"].to(dtype), tp)
    return y + p["bias"].to(dtype)


def _self_attention(p, x, mask, *, config: BertConfig, dtype, attention_fn,
                    tp=None):
    b, s, _ = x.shape
    hd = config.hidden_size // config.num_heads
    h = p["query"]["kernel"].shape[1]  # this rank's heads under tensor
    x = _pt._column_input(x, tp)

    def proj(name):
        w = p[name]["kernel"].reshape(config.hidden_size, h * hd)
        y = _dense({"kernel": w, "bias": p[name]["bias"].reshape(h * hd)}, x, dtype)
        return y.reshape(b, s, h, hd)

    attn = attention_fn(proj("query"), proj("key"), proj("value"), mask, dtype=dtype)
    out = p["out"]
    return _row_parallel({"kernel": out["kernel"].reshape(h * hd, config.hidden_size),
                          "bias": out["bias"]}, attn.reshape(b, s, h * hd), dtype, tp)


def encoder_layer(p, x, mask, *, config: BertConfig, dtype, attention_fn,
                  train: bool, generator=None, shards: Optional[_Shards] = None,
                  prefix: str = ""):
    """One post-LN encoder layer (the reference's ``EncoderLayer``):
    ``(x, aux)``, ``aux`` the MoE load-balance term of a mixture-of-experts
    layer in training, else None.  ``shards``: the layout's view (module
    docstring); ``p`` is then this rank's slices of layer ``prefix``."""
    tp = ep = None
    if shards is not None:
        p, tp, ep = shards.gather(p, prefix), shards.tp, shards.ep
    drop = train and config.dropout_rate > 0
    attn = _self_attention(p["attention"], x, mask, config=config, dtype=dtype,
                           attention_fn=attention_fn, tp=tp)
    if drop:
        attn = _dropout(attn, config.dropout_rate, generator)
    x = _layer_norm(p["attention_ln"], x + attn, config.layer_norm_eps, dtype)
    aux = None
    if "moe_mlp" in p:
        h, aux = moe.moe_mlp(p["moe_mlp"], x, num_experts=config.num_experts,
                             capacity_factor=config.moe_capacity_factor,
                             dtype=dtype, train=train, expert=ep, tensor=tp)
    else:
        h = F.gelu(_dense(p["mlp_in"], _pt._column_input(x, tp), dtype),
                   approximate="none")
        h = _row_parallel(p["mlp_out"], h, dtype, tp)
    if drop:
        h = _dropout(h, config.dropout_rate, generator)
    return _layer_norm(p["mlp_ln"], x + h, config.layer_norm_eps, dtype), aux


def _remat_layer(p, x, mask, state, *, generator, **kw):
    """A layer under checkpoint: the generator is set to ``state`` (its
    state at the layer's start) first, a no-op in the forward and a rewind
    when backward recomputes the layer."""
    if generator is not None:
        generator.set_state(state)
    return encoder_layer(p, x, mask, generator=generator, **kw)


def forward(
    params: Params,
    input_ids: torch.Tensor,
    *,
    config: BertConfig = BERT_BASE,
    dtype: torch.dtype = torch.bfloat16,
    attention_fn: AttentionFn = dot_product_attention,
    train: bool = True,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    layout=None,
) -> torch.Tensor:
    """Classification logits [B, num_classes] in f32 (the reference's
    ``BertEncoder.__call__``).  ``attention_mask`` [B, S] (1 = attend)
    becomes the [B, 1, 1, S] boolean mask every layer's attention takes;
    dropout runs when ``train`` and the rate is above 0, drawing from
    ``generator``.  Mixture-of-experts layers hand their load-balance
    terms to :func:`.moe.sow` in training.  ``layout``: the train state's
    ``ParamLayout`` under model axes (module docstring): ``params`` are
    this rank's slices, the logits whole on every rank."""
    _check_config(config)
    shards = _shards(layout)
    ids = input_ids.long()
    s = ids.shape[1]
    drop = train and config.dropout_rate > 0
    top = {k: v for k, v in params.items() if not k.startswith("layer")}
    if shards is not None:
        top = shards.gather(top, "")
    x = F.embedding(ids, top["token_embed"]["embedding"].to(dtype))
    pos = top["position_embed"]["embedding"].to(dtype)[:s][None]
    x = x + pos
    if token_type_ids is not None:
        x = x + F.embedding(token_type_ids.long(),
                            top["type_embed"]["embedding"].to(dtype))
    x = _layer_norm(top["embed_ln"], x, config.layer_norm_eps, dtype)
    if drop:
        x = _dropout(x, config.dropout_rate, generator)
    mask = None
    if attention_mask is not None:
        mask = attention_mask[:, None, None, :].bool()
    kw = dict(config=config, dtype=dtype, attention_fn=attention_fn, train=train,
              shards=shards)
    layer_gen = generator if drop else None
    for i in range(config.num_layers):
        p = params[f"layer{i}"]
        state = layer_gen.get_state() if layer_gen is not None else None
        x, aux = remat(config.remat, _remat_layer, p, x, mask, state,
                       generator=layer_gen, prefix=f"layer{i}", **kw)
        if aux is not None:
            moe.sow(aux)
    pooled = torch.tanh(_dense(top["pooler"], x[:, 0], dtype))
    return _dense(top["head"], pooled, dtype).float()


@dataclasses.dataclass
class BertEncoder:
    """A config, a compute dtype and an attention function bound together,
    as the flax module binds them: ``init_params`` makes parameters and a
    call runs :func:`forward`."""

    config: BertConfig = BERT_BASE
    dtype: torch.dtype = torch.bfloat16
    attention_fn: AttentionFn = dot_product_attention

    def __post_init__(self):
        _check_config(self.config)

    def init_params(self, generator=None, *, device: DeviceLike = None,
                    token_types: bool = False) -> Params:
        return init_params(self.config, generator, device=device,
                           token_types=token_types)

    def __call__(self, params, input_ids, train: bool = True,
                 attention_mask=None, token_type_ids=None, generator=None,
                 layout=None):
        return forward(params, input_ids, config=self.config, dtype=self.dtype,
                       attention_fn=self.attention_fn, train=train,
                       attention_mask=attention_mask,
                       token_type_ids=token_type_ids, generator=generator,
                       layout=layout)


def _build(base: BertConfig, kwargs) -> BertEncoder:
    cfg_kwargs = {f.name: kwargs.pop(f.name) for f in dataclasses.fields(BertConfig)
                  if f.name in kwargs}
    return BertEncoder(config=dataclasses.replace(base, **cfg_kwargs), **kwargs)


@register("bert-base")
@register("bert_base")
def bert_base(**kwargs) -> BertEncoder:
    """bert-base (12 layers, hidden 768, 12 heads); config fields and
    ``dtype`` / ``attention_fn`` as keywords."""
    return _build(BERT_BASE, kwargs)


@register("bert-large")
def bert_large(**kwargs) -> BertEncoder:
    """bert-large (24 layers, hidden 1024, 16 heads)."""
    return _build(BERT_LARGE, kwargs)

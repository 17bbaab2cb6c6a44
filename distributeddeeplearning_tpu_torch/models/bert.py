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
from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    params_from_numpy as _tree_from_numpy,
)

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
    return _tree_from_numpy(tree, device)


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


def _self_attention(p, x, mask, *, config: BertConfig, dtype, attention_fn):
    b, s, _ = x.shape
    h = config.num_heads
    hd = config.hidden_size // h

    def proj(name):
        w = p[name]["kernel"].reshape(config.hidden_size, h * hd)
        y = _dense({"kernel": w, "bias": p[name]["bias"].reshape(h * hd)}, x, dtype)
        return y.reshape(b, s, h, hd)

    attn = attention_fn(proj("query"), proj("key"), proj("value"), mask, dtype=dtype)
    out = p["out"]
    return _dense({"kernel": out["kernel"].reshape(h * hd, config.hidden_size),
                   "bias": out["bias"]}, attn.reshape(b, s, h * hd), dtype)


def encoder_layer(p, x, mask, *, config: BertConfig, dtype, attention_fn,
                  train: bool, generator=None):
    """One post-LN encoder layer (the reference's ``EncoderLayer``):
    ``(x, aux)``, ``aux`` the MoE load-balance term of a mixture-of-experts
    layer in training, else None."""
    drop = train and config.dropout_rate > 0
    attn = _self_attention(p["attention"], x, mask, config=config, dtype=dtype,
                           attention_fn=attention_fn)
    if drop:
        attn = _dropout(attn, config.dropout_rate, generator)
    x = _layer_norm(p["attention_ln"], x + attn, config.layer_norm_eps, dtype)
    aux = None
    if "moe_mlp" in p:
        h, aux = moe.moe_mlp(p["moe_mlp"], x, num_experts=config.num_experts,
                             capacity_factor=config.moe_capacity_factor,
                             dtype=dtype, train=train)
    else:
        h = F.gelu(_dense(p["mlp_in"], x, dtype), approximate="none")
        h = _dense(p["mlp_out"], h, dtype)
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
) -> torch.Tensor:
    """Classification logits [B, num_classes] in f32 (the reference's
    ``BertEncoder.__call__``).  ``attention_mask`` [B, S] (1 = attend)
    becomes the [B, 1, 1, S] boolean mask every layer's attention takes;
    dropout runs when ``train`` and the rate is above 0, drawing from
    ``generator``.  Mixture-of-experts layers hand their load-balance
    terms to :func:`.moe.sow` in training."""
    _check_config(config)
    ids = input_ids.long()
    s = ids.shape[1]
    drop = train and config.dropout_rate > 0
    x = F.embedding(ids, params["token_embed"]["embedding"].to(dtype))
    pos = params["position_embed"]["embedding"].to(dtype)[:s][None]
    x = x + pos
    if token_type_ids is not None:
        x = x + F.embedding(token_type_ids.long(),
                            params["type_embed"]["embedding"].to(dtype))
    x = _layer_norm(params["embed_ln"], x, config.layer_norm_eps, dtype)
    if drop:
        x = _dropout(x, config.dropout_rate, generator)
    mask = None
    if attention_mask is not None:
        mask = attention_mask[:, None, None, :].bool()
    kw = dict(config=config, dtype=dtype, attention_fn=attention_fn, train=train)
    layer_gen = generator if drop else None
    for i in range(config.num_layers):
        p = params[f"layer{i}"]
        state = layer_gen.get_state() if layer_gen is not None else None
        x, aux = remat(config.remat, _remat_layer, p, x, mask, state,
                       generator=layer_gen, **kw)
        if aux is not None:
            moe.sow(aux)
    pooled = torch.tanh(_dense(params["pooler"], x[:, 0], dtype))
    return _dense(params["head"], pooled, dtype).float()


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
                 attention_mask=None, token_type_ids=None, generator=None):
        return forward(params, input_ids, config=self.config, dtype=self.dtype,
                       attention_fn=self.attention_fn, train=train,
                       attention_mask=attention_mask,
                       token_type_ids=token_type_ids, generator=generator)


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

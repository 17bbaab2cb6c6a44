"""The Vision Transformer of ``models/vit.py``, in PyTorch.

Architecture as the reference's (Dosovitskiy et al., 2010.11929): a
VALID conv patch embedding with stride p, the patches flattened in (h, w)
order as flax's NHWC ``reshape(B, -1, D)`` gives them, a CLS token (zeros)
first, learned position embeddings (Normal(0, 0.02)), pre-LN encoder
blocks ``x + Attn(LN(x)); x + MLP(LN(x))`` (LayerNorm eps 1e-6, exact
GELU), a final LayerNorm and a Dense head on the CLS row whose logits come
back in f32.  ViT-B/16 and ViT-L/16 (:data:`VIT_B16`, :data:`VIT_L16`)
are registered as ``vit-b16``, ``vit_b16``, ``vit-l16`` and ``vit_l16``;
config fields pass as keywords.

A :class:`VisionTransformer` is an :class:`._convnet.ImageModel`: one
forward over a :class:`._convnet.Scope` of flax-named variables
(``patch_embed/kernel``, ``cls``, ``pos_embed``, ``block{i}/attention/
query/kernel`` [hidden, heads, head_dim], ``block{i}/mlp_in/kernel``,
``final_ln/scale``, ``head/kernel``, ...), so ``init``, ``param_shapes``,
``forward_macs``, ``create_train_state``, ``variables_from_numpy`` and
``workloads.benchmark`` take it unchanged.  Its input is NHWC, viewed as
NCHW with channels-last strides, so the patch embedding's output permutes
to [B, h, w, D] without a copy.  The self-attention is BERT's
(:func:`.bert._self_attention`, the reference's ``SelfAttention``):
``attention_fn`` defaults to :func:`.bert.dot_product_attention` and takes
``ops.flash_attention.make_flash_attention()`` (non-causal, no mask: the
unbiased kernels).  ``remat`` (``none``, ``full``, ``dots``) applies per
block through :func:`.bert.remat`.

``forward_macs`` counts the patch embedding, every Dense (qkv, out, MLP,
head) per token and the two attention products, 2 S^2 D a block: ViT-B/16
at 224 px does 17.56 G multiply-adds an image.
"""

from __future__ import annotations

import dataclasses

import torch

from distributeddeeplearning_tpu_torch.models import register
from distributeddeeplearning_tpu_torch.models._convnet import (  # noqa: F401
    ImageModel,
    Scope,
    conv,
    dense,
    dropout,
    lecun_normal,
    normal,
    ones,
    variables_from_numpy,
    variables_to_numpy,
    zeros,
)
from distributeddeeplearning_tpu_torch.models.bert import (
    AttentionFn,
    BertConfig,
    _layer_norm,
    _self_attention,
    check_remat,
    dot_product_attention,
    remat,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1001  # background class 0, like the CNN zoo
    dropout_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    remat: str = "none"  # none|full|dots, per block


VIT_B16 = ViTConfig()
VIT_L16 = ViTConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
)


def _layer_norm_scope(s: Scope, x, eps: float):
    """flax LayerNorm (params ``scale``, ``bias``) at the scope's dtype."""
    d = x.shape[-1]
    p = {"scale": s.param("scale", (d,), ones), "bias": s.param("bias", (d,), zeros)}
    return _layer_norm(p, x, eps, s.dtype)


def _attention_params(s: Scope, d: int, h: int):
    """BERT's ``SelfAttention`` variables, DenseGeneral shapes, in the
    reference's creation order."""
    hd = d // h
    p = {}
    for name in ("query", "key", "value"):
        c = s.child(name)
        p[name] = {"kernel": c.param("kernel", (d, h, hd), normal(0.02)),
                   "bias": c.param("bias", (h, hd), zeros)}
    c = s.child("out")
    p["out"] = {"kernel": c.param("kernel", (h, hd, d), normal(0.02)),
                "bias": c.param("bias", (d,), zeros)}
    return p


def vit_block(s: Scope, x, cfg: ViTConfig, attention_fn: AttentionFn):
    """The pre-LN block (the reference's ``ViTBlock``) on [B, S, D]."""
    _, n, d = x.shape
    h = _layer_norm_scope(s.child("attention_ln"), x, cfg.layer_norm_eps)
    acfg = BertConfig(hidden_size=d, num_heads=cfg.num_heads)
    h = _self_attention(_attention_params(s.child("attention"), d, cfg.num_heads),
                        h, None, config=acfg, dtype=s.dtype,
                        attention_fn=attention_fn)
    # the four projections and the two attention products, one example
    s.run.macs += n * 4 * d * d + 2 * n * n * d
    h = dropout(s, h, cfg.dropout_rate)
    x = x + h
    h = _layer_norm_scope(s.child("mlp_ln"), x, cfg.layer_norm_eps)
    h = dense(s.child("mlp_in"), h, cfg.intermediate_size, init=normal(0.02))
    h = torch.nn.functional.gelu(h, approximate="none")
    h = dense(s.child("mlp_out"), h, d, init=normal(0.02))
    h = dropout(s, h, cfg.dropout_rate)
    return x + h


def _remat_block(s: Scope, x, state, cfg, attention_fn):
    """A block under checkpoint: the dropout generator is set to ``state``
    (its state at the block's start) first, a no-op in the forward and a
    rewind when backward recomputes the block."""
    if state is not None:
        s.run.generator.set_state(state)
    return vit_block(s, x, cfg, attention_fn)


@dataclasses.dataclass
class VisionTransformer(ImageModel):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits; see
    :class:`._convnet.ImageModel` for ``init``, ``param_shapes``,
    ``forward_macs`` and the call."""

    config: ViTConfig = VIT_B16
    dtype: torch.dtype = torch.bfloat16
    attention_fn: AttentionFn = dot_product_attention

    def __post_init__(self):
        check_remat(self.config.remat)
        if self.config.hidden_size % self.config.num_heads:
            raise ValueError(f"hidden_size {self.config.hidden_size} not divisible "
                             f"by num_heads {self.config.num_heads}")

    def _forward(self, s: Scope, x):
        cfg = self.config
        b, _, hh, ww = x.shape
        p = cfg.patch_size
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} not divisible by patch size {p}")
        d = cfg.hidden_size
        x = conv(s.child("patch_embed"), x, d, p, stride=p, padding="VALID",
                 bias=True, init=lecun_normal)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, d)  # [B, N, D], (h, w) order
        n = x.shape[1]
        cls = s.param("cls", (1, 1, d), zeros)
        x = torch.cat([cls.to(self.dtype).expand(b, 1, d), x], dim=1)
        pos = s.param("pos_embed", (1, n + 1, d), normal(0.02))
        x = x + pos.to(self.dtype)
        x = dropout(s, x, cfg.dropout_rate)
        gen = s.run.generator if s.run.train and cfg.dropout_rate > 0 else None
        for i in range(cfg.num_layers):
            blk = s.child(f"block{i}")
            if s.initializing:
                x = vit_block(blk, x, cfg, self.attention_fn)
            else:
                state = gen.get_state() if gen is not None else None
                x = remat(cfg.remat, _remat_block, blk, x, state, cfg,
                          self.attention_fn)
        x = _layer_norm_scope(s.child("final_ln"), x, cfg.layer_norm_eps)
        logits = dense(s.child("head"), x[:, 0], cfg.num_classes)
        return logits.float()


def _make(base: ViTConfig, **kwargs) -> VisionTransformer:
    cfg_kwargs = {f.name: kwargs.pop(f.name) for f in dataclasses.fields(ViTConfig)
                  if f.name in kwargs}
    return VisionTransformer(config=dataclasses.replace(base, **cfg_kwargs), **kwargs)


@register("vit-b16")
@register("vit_b16")
def vit_b16(**kwargs) -> VisionTransformer:
    """ViT-B/16 (12 blocks, hidden 768, 12 heads); config fields and
    ``dtype`` / ``attention_fn`` as keywords."""
    return _make(VIT_B16, **kwargs)


@register("vit-l16")
@register("vit_l16")
def vit_l16(**kwargs) -> VisionTransformer:
    """ViT-L/16 (24 blocks, hidden 1024, 16 heads)."""
    return _make(VIT_L16, **kwargs)

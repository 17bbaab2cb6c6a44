"""Models of the port: the stacked causal LM (``pipelined_transformer``),
the BERT encoder (``bert``, with mixture-of-experts layers from ``moe``),
the image models (``resnet``, ``inception``, ``vgg``) and the Vision
Transformer (``vit``).

``get_model(name, **kwargs)`` is the by-name factory of the reference's
``models/__init__.py``; the port registers ``bert-base``, ``bert_base``,
``bert-large``, ``resnet18`` ... ``resnet200``, ``inceptionv3``,
``inception_v3``, ``vgg11``, ``vgg16``, ``vgg19``, ``alexnet``,
``vit-b16``, ``vit_b16``, ``vit-l16`` and ``vit_l16``.
"""

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _load() -> None:
    # import for registration side effects
    from distributeddeeplearning_tpu_torch.models import (  # noqa: F401
        bert,
        inception,
        resnet,
        vgg,
        vit,
    )


def get_model(name: str, **kwargs):
    """Instantiate a registered model by name."""
    _load()
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def available_models():
    _load()
    return sorted(_REGISTRY)

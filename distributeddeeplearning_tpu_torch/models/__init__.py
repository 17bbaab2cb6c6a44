"""Models of the port: the stacked causal LM (``pipelined_transformer``) and
the BERT encoder (``bert``).

``get_model(name, **kwargs)`` is the by-name factory of the reference's
``models/__init__.py``; the port registers ``bert-base``, ``bert_base`` and
``bert-large`` (the image models come with the ResNet slice).
"""

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, **kwargs):
    """Instantiate a registered model by name."""
    from distributeddeeplearning_tpu_torch.models import bert  # noqa: F401

    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def available_models():
    from distributeddeeplearning_tpu_torch.models import bert  # noqa: F401

    return sorted(_REGISTRY)

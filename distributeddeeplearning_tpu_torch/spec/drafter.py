"""Drafters: the cheap proposal half of speculative decoding
(``spec/drafter.py``).

A drafter extends every slot by one greedy token against the engine's
live KV cache: ``bind(engine)`` once, ``propose(cache, tokens, pos)`` per
draft token.  Tests plug adversarial drafters in beside the two built-in
ones:

- :class:`TruncatedDrafter` — the first ``draft_layers`` layers of the
  engine's own stack plus its head: no extra weights.  It decodes through
  the first M layers of the cache IN PLACE (views of the engine's storage,
  no copy), and its writes heal themselves: layer ``m``'s K/V depend only
  on layers ``< m``, so they equal what the verifier rewrites there.
- :class:`Int8Drafter` — the full-depth int8-weight model
  (``quant.calibrate.quantize_params`` of the engine's f32 parameters at
  bind time, or the engine's own tree when it already serves int8
  weights).  Its K/V writes differ from f32, which is safe: the verifier
  rewrites every position it accepts before attending, and the spec
  decoder rolls the rejected tail back.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    forward_decode,
    forward_decode_paged,
)

Params = Dict[str, Any]


class Drafter:
    """One greedy draft token per slot against the engine's live cache.

    ``bind(engine)`` is called once by the spec decoder; ``propose(cache,
    tokens, pos)`` returns ``(next_tokens [B] int32, cache)`` as DEVICE
    tensors (the draft chain never syncs: the decoder reads back once,
    after verify) and may write the drafted tokens' K/V into the cache at
    ``pos``."""

    name = "custom"

    def bind(self, engine) -> None:
        """Prepare for ``engine``'s layout."""

    def propose(self, cache, tokens, pos):
        raise NotImplementedError


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


class _ModelDrafter(Drafter):
    """A decode step over ``dparams``, possibly a truncated stack that
    reads and writes only the first M layers of the cache."""

    def __init__(self):
        self._engine = None
        self._dparams: Optional[Params] = None
        self._layers = 0

    def _make_params(self, engine) -> Params:
        raise NotImplementedError

    def bind(self, engine) -> None:
        self._engine = engine
        self._dparams = self._make_params(engine)
        self._layers = self._dparams["blocks"]["qkv"].shape[0]

    @torch.inference_mode()
    def propose(self, cache, tokens, pos):
        M, engine = self._layers, self._engine
        # views of the first M layers: the decode writes the engine's
        # storage in place
        sub = {key: cache[key][:, :M] for key in ("k", "v")}
        if engine.kv_layout == "paged":
            logits, _ = forward_decode_paged(
                self._dparams, tokens, sub, pos, engine.device_tables(),
                num_heads=engine.num_heads, kernel=engine.decode_kernel)
        else:
            logits, _ = forward_decode(
                self._dparams, tokens, sub, pos, num_heads=engine.num_heads,
                kernel=engine.decode_kernel)
        return _greedy(logits), cache


class TruncatedDrafter(_ModelDrafter):
    """Self-draft through the first ``draft_layers`` layers + the shared
    head.  ``draft_layers == num_layers`` is allowed (drafter ==
    verifier, acceptance 1.0); serving wants it small."""

    name = "truncated"

    def __init__(self, draft_layers: int):
        super().__init__()
        if draft_layers < 1:
            raise ValueError(f"draft_layers must be >= 1, got {draft_layers}")
        self.draft_layers = draft_layers

    def _make_params(self, engine) -> Params:
        L = engine.params["blocks"]["qkv"].shape[0]
        if self.draft_layers > L:
            raise ValueError(
                f"draft_layers {self.draft_layers} exceeds the model's {L} "
                "layers")
        M = self.draft_layers
        dparams = dict(engine.params)
        # views of the first M layers; a QTensor cuts values and scales
        dparams["blocks"] = {k: v[:M] for k, v in engine.params["blocks"].items()}
        return dparams


class Int8Drafter(_ModelDrafter):
    """Full-depth int8-weight drafter.  ``params`` overrides the weights;
    otherwise the engine's f32 parameters are quantized in memory at bind
    time, and an engine that already serves int8 weights drafts with its
    own tree (acceptance 1.0)."""

    name = "int8"

    def __init__(self, params: Optional[Params] = None):
        super().__init__()
        self._override = params

    def _make_params(self, engine) -> Params:
        if self._override is not None:
            return self._override
        from distributeddeeplearning_tpu_torch.quant.calibrate import (
            params_dtype,
            quantize_params,
        )

        if params_dtype(engine.params) == "int8":
            return engine.params
        return quantize_params(engine.params)


def build_drafter(kind: str, *, draft_layers: Optional[int] = None,
                  params: Optional[Params] = None) -> Drafter:
    """The drafter behind ``--draft-weights`` / ``--draft-layers``:
    ``"truncated"`` (needs ``draft_layers``) or ``"int8"``."""
    if kind == "truncated":
        if draft_layers is None:
            raise ValueError("the truncated drafter needs draft_layers")
        return TruncatedDrafter(draft_layers)
    if kind == "int8":
        return Int8Drafter(params)
    raise ValueError(f"unknown drafter kind {kind!r}")

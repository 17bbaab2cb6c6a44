"""Prefill/decode engine over the stacked-transformer LM (``serve/engine.py``).

Prompts run once through :func:`forward_prefill` (the causal flash-
attention kernel by default) on a power-of-two padded bucket, and their
K/V are copied into the slot's cache lines; every generated token then
runs one :func:`forward_decode` step for ALL slots at their own positions
(the decode-attention kernel), updating the cache in place.

PyTorch runs eagerly, so there are no compiled programs; ``prefill_compiles``
still counts the distinct prompt buckets a run meets, as the reference's
report does.

Sampling: greedy is argmax with ties to the lowest index (``jnp.argmax``'s
rule).  Temperature sampling draws from a ``torch.Generator`` seeded from
``(seed, step)``, so a run is reproducible from the seed and request order
within the port; ``jax.random``'s streams are not reproduced.

Not in this slice: meshes and tensor parallelism, the HBM ledger and
compile tracking, live weight reload, the paged engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device
from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    ATTENTIONS,
    forward_decode,
    forward_prefill,
)
from distributeddeeplearning_tpu_torch.ops.flash_decode import resolve_kernel
from distributeddeeplearning_tpu_torch.serve.kv_cache import (
    cache_bytes,
    init_cache,
    insert_sequence,
)

NEG_BIG = -1e30

# odd 64-bit multiplier that spreads (seed, step) over the generator's seed
_SEED_MIX = 0x9E3779B97F4A7C15


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Greedy / temperature / top-k sampling over [..., vocab] logits.

    ``temperature <= 0`` is greedy argmax, ties to the lowest index
    (``generator`` unused).  Otherwise logits outside the top ``top_k`` are
    masked before a temperature-scaled categorical draw; the mask keeps
    EXACTLY ``top_k`` logits, ties at the k-th value broken lowest-index
    first (a stable descending sort, the order ``lax.top_k`` gives)."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k is not None and top_k < logits.shape[-1]:
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            -1, idx[..., :top_k], True
        )
        logits = torch.where(keep, logits, NEG_BIG)
    probs = torch.softmax(logits / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def prompt_bucket(n: int, max_seq: int, floor: int = 8) -> int:
    """Smallest power of two >= n (>= floor), capped at max_seq — the
    padded prefill length of a prompt of ``n`` tokens."""
    b = floor
    while b < n:
        b *= 2
    return min(b, max_seq)


def _validate_model_dims(params, *, num_heads: int, max_seq: int, top_k):
    """Construction-time checks; returns ``(d_model, num_layers, head_dim)``."""
    pos_table = params["pos"].shape[0]
    if max_seq > pos_table:
        raise ValueError(
            f"max_seq {max_seq} exceeds the model's position table "
            f"{pos_table} — re-init the params with max_len >= max_seq"
        )
    d_model = params["embed"].shape[1]
    if d_model % num_heads:
        raise ValueError(f"d_model {d_model} not divisible by heads {num_heads}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    return d_model, params["blocks"]["qkv"].shape[0], d_model // num_heads


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class InferenceEngine:
    """KV-cached generation over a ``pipelined_transformer`` param dict.

    The engine owns the device state (params + dense cache) and exposes the
    verbs the continuous-batching scheduler needs: ``prefill(slot, prompt)
    -> first token`` and ``decode(tokens, pos) -> next tokens`` for all
    slots, plus ``release`` / ``can_admit`` / ``admit_bytes`` and the
    quarantine hooks ``scrub_slot`` / ``poison_slot``.

    ``device`` defaults to ``cuda`` (raising without a card); params are
    moved there.  ``prefill_attention="flash"`` (default) runs the prompt
    pass through the causal flash kernel; ``decode_kernel="auto"`` runs
    decode attention through the decode kernel.
    """

    def __init__(
        self,
        params,
        *,
        num_heads: int,
        batch_slots: int,
        max_seq: int,
        prefill_attention: str = "flash",
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        seed: int = 0,
        pad_id: int = 0,
        decode_kernel: str = "auto",
        device: DeviceLike = None,
    ):
        if prefill_attention not in ATTENTIONS:
            raise ValueError(
                f"unknown prefill attention {prefill_attention!r} "
                f"(choices: {ATTENTIONS})"
            )
        self.device = resolve_device(device)
        self.kv_layout = "dense"
        self.chunked_prefill = False
        self.decode_kernel = resolve_kernel(decode_kernel)
        self.prefill_attention = prefill_attention
        self.prefill_compiles = 0
        self._seen_buckets: set = set()
        _, num_layers, head_dim = _validate_model_dims(
            params, num_heads=num_heads, max_seq=max_seq, top_k=top_k
        )
        self.params = _to_device(params, self.device)
        self.num_heads = num_heads
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.vocab_size = params["head"].shape[1]
        self.temperature = float(temperature)
        self.top_k = top_k
        self.seed = seed
        if self.params["embed"].dtype != torch.float32:
            raise NotImplementedError(
                "this slice serves f32 weights and cache (int8 is port slice 3)"
            )
        self.kv_dtype = self.weights_dtype = "float32"
        self._sample_step = 0
        # per-slot logit-finiteness verdict of the LAST decode step; read
        # back in the same host copy as the tokens (the NaN quarantine
        # signal costs no extra sync)
        self.last_finite: Optional[np.ndarray] = None
        self._cache = init_cache(
            batch_slots=batch_slots, num_layers=num_layers, max_seq=max_seq,
            num_heads=num_heads, head_dim=head_dim, device=self.device,
        )

    @property
    def cache(self):
        return self._cache

    def kv_bytes(self) -> int:
        """Total KV bytes (what the dense layout reserves)."""
        return cache_bytes(self._cache)

    def kv_bytes_peak(self) -> int:
        """Dense slots commit their whole reservation up front."""
        return cache_bytes(self._cache)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Dense slots always fit a validated request."""
        return True

    def admit_bytes(self, prompt_len: int, max_new_tokens: int) -> int:
        """Incremental committed bytes of a request: zero for dense."""
        return 0

    def release(self, slot: int) -> None:
        """Nothing to reclaim: stale K/V stay masked behind the next
        occupant's positions."""

    def _next_step(self) -> int:
        step = self._sample_step
        self._sample_step += 1
        return step

    def _sample(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed((self.seed * _SEED_MIX + step) % (1 << 63))
        return sample_logits(logits, gen, temperature=self.temperature,
                             top_k=self.top_k)

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: Sequence[int]) -> int:
        """Run ``prompt`` through the model, seed ``slot``'s cache lines,
        and return the first sampled token (its K/V enter the cache on the
        first decode step, at position ``len(prompt)``)."""
        length = len(prompt)
        if not length:
            raise ValueError("empty prompt")
        if length >= self.max_seq:
            raise ValueError(
                f"prompt length {length} leaves no room to generate "
                f"(max_seq {self.max_seq})"
            )
        if not 0 <= slot < self.batch_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.batch_slots})")
        bucket = prompt_bucket(length, self.max_seq)
        if bucket not in self._seen_buckets:
            self._seen_buckets.add(bucket)
            self.prefill_compiles += 1
        tokens = np.full((1, bucket), self.pad_id, np.int64)
        tokens[0, :length] = np.asarray(prompt, np.int64)
        logits, k, v = forward_prefill(
            self.params, torch.from_numpy(tokens).to(self.device),
            num_heads=self.num_heads, attention=self.prefill_attention,
        )
        insert_sequence(self._cache, k, v, slot)
        # the last REAL position, not the padding
        tok = self._sample(logits[:, length - 1], self._next_step())
        return int(tok[0])

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step for every slot: ``tokens[i]`` at ``pos[i]`` ->
        the sampled next token per slot.  Inactive slots compute too (a
        fixed batch); their writes stay masked behind the slot's position.
        Tokens and the per-slot finiteness verdict come back to the host in
        ONE copy — the step's one sync."""
        tok = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        p = torch.from_numpy(np.asarray(pos, np.int32)).to(self.device)
        logits, _ = forward_decode(
            self.params, tok, self._cache, p, num_heads=self.num_heads,
            kernel=self.decode_kernel,
        )
        finite = torch.isfinite(logits).all(dim=-1)
        out = torch.stack(
            [self._sample(logits, self._next_step()), finite.to(torch.int32)]
        ).cpu().numpy()
        self.last_finite = out[1].astype(bool)
        return out[0]

    # -- fault injection / quarantine hooks --------------------------------
    def poison_slot(self, slot: int, pos: int) -> None:
        """Set ``slot``'s K history at ``pos`` to NaN, every layer (chaos
        tests).  K only: a NaN key makes the victim's own scores NaN while
        a future occupant masks the position; a NaN value would leak
        through masking (0 weight x NaN = NaN)."""
        self._cache["k"][slot, :, pos] = float("nan")

    def scrub_slot(self, slot: int, from_pos: int = 0) -> None:
        """Zero the slot's cache row from position ``from_pos`` on, in
        place; positions below it are untouched."""
        for leaf in self._cache.values():
            leaf[slot, :, from_pos:] = 0

"""Speculative decoding: a cheap drafter proposes K greedy tokens a slot,
the f32 model verifies all K+1 positions in one batched pass through the
decode kernel, and the longest agreeing prefix plus the verifier's bonus
token is committed — so a speculative greedy run emits exactly the tokens
of a non-speculative one (``spec/``)."""

from distributeddeeplearning_tpu_torch.spec.decode import (
    SpecStepResult,
    SpeculativeDecoder,
)
from distributeddeeplearning_tpu_torch.spec.drafter import (
    Drafter,
    Int8Drafter,
    TruncatedDrafter,
    build_drafter,
)

__all__ = [
    "Drafter",
    "TruncatedDrafter",
    "Int8Drafter",
    "build_drafter",
    "SpeculativeDecoder",
    "SpecStepResult",
]

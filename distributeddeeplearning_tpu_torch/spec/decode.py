"""The speculative decode step: draft K, verify K+1 in one pass
(``spec/decode.py``).

:class:`SpeculativeDecoder` drives a drafter and the verifier over a
serving engine's cache:

- the draft chain: K drafter steps, device to device, each slot's draft
  position clamped at ``pos + draft_len`` so a capped lane rewrites a
  position it owns instead of walking past its reservation;
- the verify pass (``forward_verify`` / ``forward_verify_paged``: the
  decode kernel at ``nq = K + 1``) and the acceptance rule on the device:
  the longest draft prefix equal to the verifier's argmax, the bonus
  token at the first mismatch, and the per-slot finiteness verdict over
  exactly the emitted positions; tokens, accepted counts and verdicts come
  back to the host in ONE copy, the step's one designed sync (as
  ``engine.decode``'s);
- the batched rollback: every slot's positions ``pos + m`` for ``m`` in
  ``[keep, K]`` zeroed in one scatter — the batched form of
  ``engine.scrub_slot(slot, pos + keep)``.  Rollback positions lie past
  each slot's committed history, so a prefix-shared page is never
  written.

Greedy only (the rule compares argmaxes) and f32 KV cache only (verify
extends the decode == full-forward pin, which the int8 grid breaks);
int8 WEIGHTS are fine — they are what :class:`~.drafter.Int8Drafter`
drafts with.  Single mesh only: an engine served tensor-parallel is
refused with the reference's message.

The drafter's weight tree is on the process ledger under
``drafter_weights`` (``obs/ledger.py``).  The truncated drafter's blocks
are views of the engine's weights, so its owner is charged no byte twice:
the ledger counts a storage once, and the engine's ``params`` claimed it
first.

Not in this slice: the reference's program-cost rows (``tracked_jit``)
for verify and rollback and the draft/verify trace spans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    forward_verify,
    forward_verify_paged,
)
from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger
from distributeddeeplearning_tpu_torch.serve.kv_cache import SCRATCH_PAGE
from distributeddeeplearning_tpu_torch.spec.drafter import Drafter, build_drafter


def _ledger_drafter_params(drafter):
    return getattr(drafter, "_dparams", None)


@dataclasses.dataclass
class SpecStepResult:
    """One spec step's readback: ``tokens[i, :accepted[i] + 1]`` are slot
    ``i``'s committed tokens (accepted drafts + the verifier's bonus);
    ``finite`` is the quarantine verdict over exactly those positions."""

    tokens: np.ndarray  # [B, K1] the verifier's greedy token per position
    accepted: np.ndarray  # [B] accepted draft count, 0..draft_len
    finite: np.ndarray  # [B] bool
    draft_s: float  # host wall of the draft chain
    verify_s: float  # host wall of verify + the readback


def _accept(logits: torch.Tensor, tokens: torch.Tensor, dlen: torch.Tensor):
    """The acceptance rule on the device: ``(greedy [B, K1], accepted [B],
    finite [B])``.  Columns past ``draft_len`` never match (their
    proposals are padding), and finiteness is judged over the emitted
    positions only, so a garbage lane cannot poison its slot."""
    lg = logits.float()
    K1 = lg.shape[1]
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)  # [B, K1]
    cols = torch.arange(K1, device=lg.device)
    match = (greedy[:, :-1] == tokens[:, 1:]) & (cols[None, :-1] < dlen[:, None])
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    emit = cols[None] <= accepted[:, None]
    finite = torch.where(emit, torch.isfinite(lg).all(dim=-1), True).all(dim=1)
    return greedy, accepted.to(torch.int32), finite


class SpeculativeDecoder:
    """Drafter + batched verifier over one engine's cache.

    ``drafter``: ``"truncated"`` / ``"int8"`` or a :class:`Drafter`
    instance; ``draft_tokens`` is K — a spec step commits 1..K+1 tokens a
    slot.  ``draft_layers`` defaults to half the model for the truncated
    drafter."""

    def __init__(self, engine, *, drafter: Union[str, Drafter] = "truncated",
                 draft_tokens: int = 4, draft_layers: Optional[int] = None):
        if draft_tokens < 1:
            raise ValueError(f"draft_tokens must be >= 1, got {draft_tokens}")
        if getattr(engine, "kv_dtype", "float32") != "float32":
            raise ValueError(
                "speculative decoding requires the f32 KV cache — the "
                "acceptance rule extends the decode==full-forward "
                "bit-exactness pin, which the int8 grid breaks (int8 "
                "WEIGHTS are supported: the int8 drafter drafts with them "
                "while the f32 model verifies)")
        if getattr(engine, "temperature", 0.0) > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only for now: the "
                "acceptance rule compares argmaxes, and sampled tokens "
                "would silently stop being equivalent to the non-"
                "speculative distribution")
        if getattr(engine, "tp", 1) > 1:
            raise ValueError(
                "speculative decoding is single-mesh for now (the "
                "verify/rollback programs carry no sharding annotations)")
        self.engine = engine
        self.draft_tokens = draft_tokens
        if isinstance(drafter, Drafter):
            self.drafter = drafter
        else:
            if drafter == "truncated" and draft_layers is None:
                draft_layers = max(1, engine.params["blocks"]["qkv"].shape[0] // 2)
            self.drafter = build_drafter(drafter, draft_layers=draft_layers)
        self.draft_layers = draft_layers
        self.drafter.bind(engine)
        self.drafter_name = self.drafter.name
        self._paged = engine.kv_layout == "paged"
        get_ledger().register("drafter_weights", self.drafter,
                              _ledger_drafter_params)

    def _upload(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.asarray(arr, np.int32)).to(self.engine.device)

    # -- the draft -> verify step -----------------------------------------
    @torch.inference_mode()
    def step(self, tokens: np.ndarray, pos: np.ndarray,
             draft_len: np.ndarray) -> SpecStepResult:
        """One speculative step for every slot: draft K tokens, verify all
        K+1 positions in one pass, read the acceptance back.
        ``draft_len[i]`` caps slot ``i``'s real drafts (0: a plain decode
        step through the verify pass); the caller guarantees ``pos[i] +
        draft_len[i] < max_seq``."""
        engine = self.engine
        # every host input goes up before the first launch of the step:
        # from here to the readback nothing waits on the card
        t_dev, pos_dev, dlen_dev = (self._upload(a) for a in (tokens, pos, draft_len))
        tables = engine.device_tables() if self._paged else None
        t0 = time.perf_counter()
        cols = [t_dev]
        cur = t_dev
        # observability slice: the draft-chain span opens here
        for j in range(self.draft_tokens):
            pos_j = pos_dev + torch.clamp(dlen_dev, max=j)
            cur, _ = self.drafter.propose(engine._cache, cur, pos_j)
            cols.append(cur)
        t1 = time.perf_counter()
        mat = torch.stack(cols, dim=1)  # [B, K1]
        # observability slice: the verify span opens here
        if self._paged:
            logits, _ = forward_verify_paged(
                engine.params, mat, engine._cache, pos_dev, dlen_dev, tables,
                num_heads=engine.num_heads, kernel=engine.decode_kernel)
        else:
            logits, _ = forward_verify(
                engine.params, mat, engine._cache, pos_dev, dlen_dev,
                num_heads=engine.num_heads, kernel=engine.decode_kernel)
        greedy, accepted, finite = _accept(logits, mat, dlen_dev)
        # THE one designed sync of the spec step: tokens, accepted counts
        # and verdicts in one copy
        out = torch.cat([greedy, accepted[:, None],
                         finite.to(torch.int32)[:, None]], dim=1).cpu().numpy()
        t2 = time.perf_counter()
        K1 = self.draft_tokens + 1
        fin = out[:, K1 + 1].astype(bool)
        engine.last_finite = fin
        return SpecStepResult(tokens=out[:, :K1], accepted=out[:, K1],
                              finite=fin, draft_s=t1 - t0, verify_s=t2 - t1)

    @torch.inference_mode()
    def rollback(self, pos: np.ndarray, keep: np.ndarray) -> None:
        """Zero every slot's cache positions ``pos + m`` for ``m`` in
        ``[keep, K]`` (the spec step's write horizon) in one scatter per
        leaf — the batched ``scrub_slot(slot, pos + keep)``.  ``keep ==
        K + 1`` leaves a slot alone.  Dense: lanes that are kept, or past
        the row, rewrite what they hold at a distinct wrapped position;
        paged: zeros go through the slot's block table, and kept or
        out-of-table lanes to scratch page 0 (the only repeated target,
        and a zero write)."""
        engine = self.engine
        pos_dev, keep_dev = self._upload(pos), self._upload(keep)
        m = torch.arange(1, self.draft_tokens + 1, device=pos_dev.device)
        wpos = pos_dev.long()[:, None] + m[None]  # [B, K]
        zero = m[None] >= keep_dev[:, None]
        rows = torch.arange(pos_dev.shape[0], device=pos_dev.device)[:, None]
        if self._paged:
            ps, nb = engine.page_size, engine.blocks_per_slot
            pidx = wpos // ps
            inb = zero & (pidx < nb)
            tables = engine.device_tables().long()
            pages = torch.where(inb, tables[rows, pidx.clamp(max=nb - 1)],
                                SCRATCH_PAGE)
            offs = torch.where(inb, wpos % ps, 0)
            for leaf in engine._cache.values():
                leaf[pages, :, offs] = 0
        else:
            S = engine.max_seq
            idx = (rows, slice(None), wpos % S)
            drop = ~(zero & (wpos < S))
            for leaf in engine._cache.values():
                # [B, K, L, ...]: the advanced indices' dims come first
                mask = drop.reshape(*drop.shape, *([1] * (leaf.dim() - 2)))
                leaf[idx] = torch.where(mask, leaf[idx], 0)

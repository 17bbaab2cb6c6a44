"""Prefill/decode engines over the stacked-transformer LM (``serve/engine.py``).

:class:`InferenceEngine` (dense cache): prompts run once through
:func:`forward_prefill` (the causal flash-attention kernel by default) on a
power-of-two padded bucket, and their K/V are copied into the slot's cache
lines; every generated token then runs one :func:`forward_decode` step for
ALL slots at their own positions (the decode-attention kernel), updating
the cache in place.

:class:`PagedInferenceEngine` (page pool): HBM by actual tokens, prefix
pages shared between requests, and chunked prefill — the scheduler runs
one :func:`forward_prefill_chunk` between decode steps, whose history
attention is the decode kernel's many-query variant.  Decode is
:func:`forward_decode_paged`.

Both serve f32, bf16 or int8-weight parameter trees (the matmul weights
as :class:`~..quant.qtensor.QTensor` leaves, from
``quant.calibrate.quantize_params``); ``weights_dtype`` says which.  The
model runs in the embedding's dtype.  Both take ``cache_dtype`` float32,
bfloat16 or int8, by default the embedding's dtype (the reference's
rule): K/V are cast to the cache's dtype on write, or quantize on write
to int8 with one scale per position and head, and the decode kernel
widens bf16 pages and dequantizes int8 ones in its tile.

PyTorch runs eagerly, so there are no compiled programs;
``prefill_compiles`` still counts the distinct prompt buckets (dense) or
chunk widths (paged) a run meets, as the reference's report does.  Each
program an engine dispatches (dense: ``prefill``, ``insert``, ``decode``,
``scrub``; paged: ``prefill_chunk``, ``decode``, ``scrub``) goes through
the attribution registry (``obs/attrib.py``) under the reference's name
``serve.{dense,paged}.{kv_dtype}.<program>``.

Sampling: greedy is argmax with ties to the lowest index (``jnp.argmax``'s
rule).  Temperature sampling draws from a ``torch.Generator`` seeded from
``(seed, step)``, so a run is reproducible from the seed and request order
within the port; ``jax.random``'s streams are not reproduced.

Tensor parallelism: with a ``mesh`` whose ``tensor`` axis is above 1
(:func:`tensor_parallel_engine`), every process of the group is one rank
of it and runs the same engine over the same requests: each keeps its
slice of the full parameter tree it is given
(``parallel.sharding.shard_params``: Megatron's column-parallel ``qkv``
and ``w_in``, row-parallel ``proj`` and ``w_out``, vocab-parallel
``embed`` and ``head``) and its ``h / tp`` heads of the cache
(``kv_cache.cache_sharding``), and the model issues the collectives
(``models.pipelined_transformer``).  Every rank gets the same full
logits and samples the same tokens, so the schedulers never diverge.
``tp`` and ``layout_rules`` (the rule table's tag) ride every report.

Both engines put their device state on the process ledger
(``obs/ledger.py``) by owner — ``params``, ``kv_pages``, ``kv_scales``
(int8) and, with a host tier, the host owner ``kv_host_pages`` — and
take a live weight reload (``reload_params``: same tree, shapes and
dtypes; the paged engine refuses live slots and drops its prefix table
and host tier, whose pages hold the old weights' K/V).  The paged engine
adds the host page tier (``host_pages``, ``tier_policy``;
``serve/kv_tier.py``): reclaimable prefix pages spill to pinned host
memory under pressure instead of being forgotten, and a prefix hit on a
host key restores the page by an asynchronous copy; and the fidelity
probe ``capture_logits``, which keeps the last decode step's logits and
the last prefill's logits row on the host.

:func:`data_parallel_engine` keeps the reference's mesh-gating rule over
the cards one process may use: one card (or slots that do not divide)
gives the single-device dense engine, the only case any machine so far
has; sharding slots over two or more cards in one process raises
(ROADMAP A6).  Data parallelism across processes is the fleet's
(``serve/fleet.py``: one engine a replica worker).  Compile tracking is
not ported: PyTorch runs eagerly.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device
from distributeddeeplearning_tpu_torch.obs.attrib import tracked_jit
from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger
from distributeddeeplearning_tpu_torch.obs.trace import get_tracer
from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
    ATTENTIONS,
    forward_decode,
    forward_decode_paged,
    forward_prefill,
    forward_prefill_chunk,
)
from distributeddeeplearning_tpu_torch.ops.flash_decode import resolve_kernel
from distributeddeeplearning_tpu_torch.parallel import sharding as layout
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    data_parallel_size,
    tensor_parallel_size,
)
from distributeddeeplearning_tpu_torch.quant.calibrate import params_dtype
from distributeddeeplearning_tpu_torch.serve.kv_cache import (
    CACHE_DTYPES,
    SCRATCH_PAGE,
    OutOfPages,
    PageAllocator,
    cache_bytes,
    init_cache,
    init_paged_cache,
    insert_sequence,
    page_bytes,
    pages_for,
)
from distributeddeeplearning_tpu_torch.serve.kv_tier import HostPageTier

NEG_BIG = -1e30

# odd 64-bit multiplier that spreads (seed, step) over the generator's seed
_SEED_MIX = 0x9E3779B97F4A7C15


# -- ledger providers (module-level: the ledger holds the ENGINE weakly and
# calls these with it, so no closure pins a dead engine's cache) ----------

def _ledger_params(engine):
    return engine.params


def _ledger_kv_values(engine):
    return {k: v for k, v in engine._cache.items() if not k.endswith("_scale")}


def _ledger_kv_scales(engine):
    return {k: v for k, v in engine._cache.items() if k.endswith("_scale")}


def _leaf_subset_page_bytes(cache, *, scales: bool) -> int:
    """Bytes a page of just the value (or just the scale) leaves — the
    committed-bytes granule of the paged pool's owners."""
    return sum(t.numel() // t.shape[0] * t.element_size()
               for key, t in cache.items() if key.endswith("_scale") == scales)


def _ledger_host_tier_bytes(engine):
    tier = getattr(engine, "tier", None)
    return 0 if tier is None else tier.used_bytes()


# -- the cache scrubs (module-level programs: obs.attrib tracks them) ------

def _scrub_rows(cache, *, slot: int, from_pos: int) -> None:
    """Zero dense ``slot``'s positions ``>= from_pos``, every leaf, in
    place."""
    for leaf in cache.values():
        leaf[slot, :, from_pos:] = 0


def _scrub_pages(cache, *, pages, offsets) -> None:
    """Zero each of ``pages`` from its offset on, every leaf, in place."""
    for page, off in zip(pages, offsets):
        for leaf in cache.values():
            leaf[page, :, off:] = 0


def _register_engine_owners(engine, ledger=None) -> None:
    """Put the engine's device state on the ledger (default: the
    process's) by owner: weights under ``params``, K/V under ``kv_pages``,
    the int8 layout's scales under ``kv_scales``.  A paged engine's owners
    report COMMITTED bytes (pages in use times bytes a page), so the
    admission forecast prices demand, not the reservation; a host tier
    registers its pool as the HOST owner ``kv_host_pages``."""
    if ledger is None:
        ledger = get_ledger()
    ledger.register("params", engine, _ledger_params)
    paged = engine.kv_layout == "paged"
    for owner, provider, scales in (("kv_pages", _ledger_kv_values, False),
                                    ("kv_scales", _ledger_kv_scales, True)):
        if scales and "k_scale" not in engine._cache:
            continue
        committed = None
        if paged:
            pb = _leaf_subset_page_bytes(engine._cache, scales=scales)
            committed = lambda e, pb=pb: e.allocator.pages_in_use * pb  # noqa: E731
        ledger.register(owner, engine, provider, committed=committed)
    if getattr(engine, "tier", None) is not None:
        ledger.register_host("kv_host_pages", engine, _ledger_host_tier_bytes)


def _check_reload_tree(old, new) -> None:
    """A live reload must be drop-in: the same leaves (a QTensor's values
    and scales among them) with the same shapes and dtypes — anything else
    would change the model mid-serve; refuse loudly instead."""
    old_items, new_items = layout.named_leaves(old), layout.named_leaves(new)
    if [n for n, _ in old_items] != [n for n, _ in new_items]:
        raise ValueError(
            "reload_params: new params tree structure differs from the "
            "engine's (different model family / quantization state?) — a "
            "live reload must be weight-value-only")
    for (name, a), (_, b) in zip(old_items, new_items):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(
                f"reload_params: leaf {name} changed aval ({tuple(a.shape)}/"
                f"{a.dtype} -> {tuple(b.shape)}/{b.dtype}) — same-shape weight "
                "sets only")


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


#: the Megatron leaves the TP path splits (their int8 scales aside)
_MEGATRON = re.compile(r"(^|/)(qkv|proj|w_in|w_out|embed|head)(/values)?$")


def _check_mesh(params, mesh, *, num_heads: int, kv_layout: str) -> int:
    """The reference's refusals of a serving mesh, and the port's own;
    returns the tensor-parallel degree (1: no mesh, or one rank)."""
    if mesh is None or mesh.size == 1:
        return 1
    tp = tensor_parallel_size(mesh)
    if data_parallel_size(mesh) != 1:
        if kv_layout == "paged" and tp > 1:
            raise ValueError(
                "paged engine meshes must be tensor-only (data×fsdp "
                f"== 1): the page pool never shards; got {dict(mesh.shape)}")
        raise NotImplementedError(
            f"a serving mesh with data axes {dict(mesh.shape)}: "
            "data_parallel_engine serves one card a process and slot "
            "sharding over a data mesh waits for ROADMAP A6 (serve.fleet "
            "runs one engine a process); tensor_parallel_engine serves a "
            "data=1 mesh")
    if num_heads % tp:
        raise ValueError(
            f"num_heads {num_heads} not divisible by the mesh's "
            f"tensor axis ({tp}) — TP shards attention heads")
    specs = layout.match_partition_rules(params, prefix="params", mesh=mesh)
    whole = [name for name, spec in specs.items()
             if _MEGATRON.search(name) and "tensor" not in spec]
    if whole:
        raise ValueError(
            f"{whole} do not split over tensor={tp} (a vocabulary or d_ff "
            "that does not divide): the port's TP path splits every Megatron "
            "leaf, where the reference would replicate these")
    return tp


def _to_device(tree, device: torch.device):
    """Every leaf on ``device``; a QTensor moves its values and scales."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


_KV_DTYPES = {str(d).replace("torch.", ""): d for d in CACHE_DTYPES}
#: the weight dtypes the engines serve (int8 weights ride as QTensor
#: leaves beside an embedding in one of these)
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def _kv_dtype(cache_dtype, weights: torch.dtype) -> torch.dtype:
    """The cache dtype an engine asks for, as a ``torch.dtype`` or its
    name: float32, bfloat16 or int8; None is the embedding's dtype
    ``weights``, as in the reference."""
    if cache_dtype is None:
        return weights
    dtype = _KV_DTYPES.get(cache_dtype, cache_dtype)
    if dtype not in _KV_DTYPES.values():
        raise ValueError(
            f"cache_dtype {cache_dtype!r}: one of {sorted(_KV_DTYPES)}"
        )
    return dtype


def data_parallel_engine(params, *, num_heads: int, batch_slots: int,
                         max_seq: int, **engine_kw):
    """The dense engine over the devices one process may use, by the
    reference's rule: slots shard over them when there are two or more and
    ``batch_slots`` divides by their count, else the single-device engine.
    Devices: ``torch.cuda.device_count()`` for an engine on ``"cuda"``,
    1 for one pinned to a card (``"cuda:N"``, as a fleet worker's is) or
    on the CPU.  Returns ``(engine, mesh)``; ``mesh`` is None in the single
    case, the only one the port serves: slot sharding over several cards
    in one process raises ``NotImplementedError`` (ROADMAP A6)."""
    device = resolve_device(engine_kw.get("device"))
    unpinned = device.type == "cuda" and device.index is None
    n_dev = torch.cuda.device_count() if unpinned else 1
    if n_dev > 1 and batch_slots % n_dev == 0:
        raise NotImplementedError(
            f"data_parallel_engine: {batch_slots} slots would shard over "
            f"{n_dev} cards in one process, which waits for a machine with "
            "two or more cards (ROADMAP A6); serve one engine a process "
            "through serve.fleet instead")
    engine = InferenceEngine(params, num_heads=num_heads,
                             batch_slots=batch_slots, max_seq=max_seq,
                             **engine_kw)
    return engine, None


def tensor_parallel_engine(params, *, tp: int, num_heads: int, batch_slots: int,
                           max_seq: int, kv_layout: str = "dense", **engine_kw):
    """An engine with its weights and cache tensor-parallel over ``tp``
    processes (the reference's ``tensor_parallel_engine``, with processes
    for its devices).

    Every process of the ``torch.distributed`` group calls it with the
    same FULL ``params`` and arguments; it builds a ``data=1 x
    tensor=tp`` mesh over the group (one process group for the tensor
    axis) and hands it to the layout's engine, which keeps the rank's
    slice.  ``kv_layout``: ``"dense"`` or ``"paged"``; ``engine_kw`` go to
    the engine (``device``: ranks that share one card pass
    ``"cuda:0"``).  ``tp=1`` returns the plain engine, in any process.
    Returns ``(engine, mesh)``; ``mesh`` is None for ``tp=1``."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    mesh = None
    if tp > 1:
        from distributeddeeplearning_tpu_torch.parallel import (
            MeshSpec,
            create_mesh,
            process_count,
        )

        world = process_count()
        if tp > world:
            raise ValueError(f"tp={tp} exceeds the {world} processes of the "
                             "torch.distributed group")
        mesh = create_mesh(MeshSpec(data=1, tensor=tp))
    cls = PagedInferenceEngine if kv_layout == "paged" else InferenceEngine
    engine = cls(params, num_heads=num_heads, batch_slots=batch_slots,
                 max_seq=max_seq, mesh=mesh, **engine_kw)
    return engine, mesh


class _EngineCore:
    """What both cache layouts share: device, weights, sampling and the
    decode step's one host readback."""

    def _setup(self, params, *, num_heads: int, batch_slots: int,
               max_seq: int, temperature: float, top_k, seed: int,
               pad_id: int, decode_kernel: str, cache_dtype, device, mesh,
               kv_layout: str):
        """Validate and store the common state (the rank's slice of the
        weights under a TP mesh); returns ``(num_layers, head_dim, cache
        dtype)``."""
        self.device = resolve_device(device)
        self.decode_kernel = resolve_kernel(decode_kernel)
        _, num_layers, head_dim = _validate_model_dims(
            params, num_heads=num_heads, max_seq=max_seq, top_k=top_k
        )
        if params["embed"].dtype not in WEIGHT_DTYPES:
            raise NotImplementedError(
                "the port serves f32 or bf16 weights, with int8 matmul "
                "weights as QTensor leaves (quant.calibrate.quantize_params),"
                f" not {params['embed'].dtype}"
            )
        dtype = _kv_dtype(cache_dtype, params["embed"].dtype)
        self.vocab_size = params["head"].shape[1]
        self.weights_dtype = params_dtype(params)
        self.tp = _check_mesh(params, mesh, num_heads=num_heads,
                              kv_layout=kv_layout)
        self.layout_rules = layout.layout_rules_provenance()
        # the mesh the model and the cache take: None unless tensor-parallel
        self.mesh = mesh if self.tp > 1 else None
        if self.mesh is not None:
            params = layout.shard_params(params, mesh)
        self.params = _to_device(params, self.device)
        self.num_heads = num_heads
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.temperature = float(temperature)
        self.top_k = top_k
        self.seed = seed
        self.kv_dtype = str(dtype).replace("torch.", "")
        self.prefill_compiles = 0
        self._sample_step = 0
        # per-slot logit-finiteness verdict of the LAST decode step; read
        # back in the same host copy as the tokens (the NaN quarantine
        # signal costs no extra sync)
        self.last_finite: Optional[np.ndarray] = None
        return num_layers, head_dim, dtype

    @property
    def cache(self):
        return self._cache

    def kv_bytes(self) -> int:
        """Total KV bytes the layout reserves, scale leaves included."""
        return cache_bytes(self._cache)

    def reload_params(self, params) -> None:
        """Swap the weight set IN PLACE — the live-reload verb: the same
        tree, shapes and dtypes only (:func:`_check_reload_tree`); the
        cache stays.  The scheduler applies a reload only at an idle
        barrier (``request_reload``), so no request sees two weight sets.
        Under a TP mesh every rank passes the same FULL tree and keeps its
        slice."""
        if self.mesh is not None:
            params = layout.shard_params(params, self.mesh)
        params = _to_device(params, self.device)
        _check_reload_tree(self.params, params)
        self.params = params

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

    def _sample_first(self, logits: torch.Tensor) -> int:
        """The first token of a prefilled prompt from its [1, vocab]
        logits."""
        return int(self._sample(logits, self._next_step())[0])

    def _readback(self, logits: torch.Tensor) -> np.ndarray:
        """Sample every slot and bring tokens and the per-slot finiteness
        verdict to the host in ONE copy — the decode step's one sync."""
        finite = torch.isfinite(logits).all(dim=-1)
        out = torch.stack(
            [self._sample(logits, self._next_step()), finite.to(torch.int32)]
        ).cpu().numpy()
        self.last_finite = out[1].astype(bool)
        return out[0]


class InferenceEngine(_EngineCore):
    """KV-cached generation over a ``pipelined_transformer`` param dict,
    dense cache layout.

    The engine owns the device state (params + cache) and exposes the verbs
    the continuous-batching scheduler needs: ``prefill(slot, prompt) ->
    first token`` and ``decode(tokens, pos) -> next tokens`` for all slots,
    plus ``release`` / ``can_admit`` / ``admit_bytes`` and the quarantine
    hooks ``scrub_slot`` / ``poison_slot``.

    ``device`` defaults to ``cuda`` (raising without a card); params are
    moved there.  ``prefill_attention="flash"`` (default) runs the prompt
    pass through the causal flash kernel; ``decode_kernel="auto"`` runs
    decode attention through the decode kernel; ``cache_dtype`` (a
    ``torch.dtype`` or its name) defaults to the embedding's dtype, and
    ``"int8"`` stores K/V quantized.  ``mesh``: a tensor-parallel mesh
    (module docstring; :func:`tensor_parallel_engine` builds one).
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
        cache_dtype=None,
        seed: int = 0,
        pad_id: int = 0,
        decode_kernel: str = "auto",
        device: DeviceLike = None,
        mesh=None,
    ):
        if prefill_attention not in ATTENTIONS:
            raise ValueError(
                f"unknown prefill attention {prefill_attention!r} "
                f"(choices: {ATTENTIONS})"
            )
        num_layers, head_dim, dtype = self._setup(
            params, num_heads=num_heads, batch_slots=batch_slots,
            max_seq=max_seq, temperature=temperature, top_k=top_k, seed=seed,
            pad_id=pad_id, decode_kernel=decode_kernel,
            cache_dtype=cache_dtype, device=device, mesh=mesh, kv_layout="dense",
        )
        self.kv_layout = "dense"
        self.chunked_prefill = False
        self.prefill_attention = prefill_attention
        self._seen_buckets: set = set()
        self._cache = init_cache(
            batch_slots=batch_slots, num_layers=num_layers, max_seq=max_seq,
            num_heads=num_heads, head_dim=head_dim, dtype=dtype,
            device=self.device, mesh=self.mesh,
        )
        # every program in the attribution registry (obs/attrib.py) under
        # the reference's name: layout + cache dtype, so f32 and int8
        # engines report distinguishable cost rows
        tag = f"serve.dense.{self.kv_dtype}"
        self._prefill_prog = tracked_jit(f"{tag}.prefill", forward_prefill)
        self._insert_prog = tracked_jit(f"{tag}.insert", insert_sequence,
                                        dynamic=("slot",))
        self._decode_prog = tracked_jit(f"{tag}.decode", forward_decode)
        self._scrub_prog = tracked_jit(f"{tag}.scrub", _scrub_rows,
                                       dynamic=("slot", "from_pos"))
        _register_engine_owners(self)

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
        with get_tracer().span("serve/engine.prefill_dispatch", bucket=bucket):
            logits, k, v = self._prefill_prog(
                self.params, torch.from_numpy(tokens).to(self.device),
                num_heads=self.num_heads, attention=self.prefill_attention,
                mesh=self.mesh,
            )
            self._insert_prog(self._cache, k, v, slot=slot)
        # the last REAL position, not the padding
        return self._sample_first(logits[:, length - 1])

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step for every slot: ``tokens[i]`` at ``pos[i]`` ->
        the sampled next token per slot.  Inactive slots compute too (a
        fixed batch); their writes stay masked behind the slot's position.
        Tokens and the per-slot finiteness verdict come back to the host in
        ONE copy — the step's one sync."""
        tok = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        p = torch.from_numpy(np.asarray(pos, np.int32)).to(self.device)
        # the dispatch span apart from the readback: on a timeline the gap
        # between them is the step's host-sync share
        with get_tracer().span("serve/engine.decode_dispatch"):
            logits, _ = self._decode_prog(
                self.params, tok, self._cache, p, num_heads=self.num_heads,
                kernel=self.decode_kernel, mesh=self.mesh,
            )
        return self._readback(logits)

    # -- fault injection / quarantine hooks --------------------------------
    def poison_slot(self, slot: int, pos: int) -> None:
        """Set ``slot``'s K history at ``pos`` to NaN, every layer (chaos
        tests) — on an int8 cache its K scales, since int8 holds no NaN.
        K only: a NaN key makes the victim's own scores NaN while a future
        occupant masks the position; a NaN value would leak through
        masking (0 weight x NaN = NaN)."""
        name = "k_scale" if "k_scale" in self._cache else "k"
        self._cache[name][slot, :, pos] = float("nan")

    def scrub_slot(self, slot: int, from_pos: int = 0) -> None:
        """Zero the slot's cache row (every leaf) from position
        ``from_pos`` on, in place; positions below it are untouched."""
        self._scrub_prog(self._cache, slot=slot, from_pos=from_pos)


class PrefillTask:
    """In-flight chunked prefill of one request: the scheduler advances it
    one chunk at a time (:meth:`PagedInferenceEngine.prefill_step`) between
    decode steps, so a long prompt never stalls running requests for its
    whole pass."""

    __slots__ = ("slot", "prompt", "pages", "offset", "shared_tokens")

    def __init__(self, slot, prompt, pages, offset, shared_tokens):
        self.slot = slot
        self.prompt = list(prompt)
        self.pages = pages  # this sequence's block table (physical ids)
        self.offset = offset  # tokens already in cache (shared + chunked)
        self.shared_tokens = shared_tokens  # prefix-cache hit length

    @property
    def done(self) -> bool:
        return self.offset >= len(self.prompt)


class PagedInferenceEngine(_EngineCore):
    """Paged-KV-cache generation: HBM by actual tokens, not ``max_seq``.

    The dense engine's scheduler verbs plus the paged ones:

    - ``fits`` / ``can_admit(prompt_len, budget)`` — could the pool ever
      hold the request / are enough pages free now (admission is bounded
      by the POOL, with the worst case reserved up front);
    - ``prefill_begin(slot, prompt, budget) -> PrefillTask`` — allocate
      the sequence's pages, mapping prefix-cache hits (leading full pages
      whose token ids match skip prefill), capped at ``len - 1`` tokens so
      the last prompt token always runs and seeds the first sample;
    - ``prefill_step(task) -> first token | None`` — run ONE prompt chunk
      (:func:`forward_prefill_chunk`); the first sampled token comes once
      the last chunk lands;
    - ``decode(tokens, pos)`` — one step for all slots
      (:func:`forward_decode_paged`);
    - ``release(slot)`` — decref the slot's pages; full prompt pages stay
      in the prefix table (reclaimable) for future hits.

    The page view is the dense key sequence, so decode is the dense
    engine's math; with the kernel the sums run in the same order too.
    ``device`` defaults to ``cuda``; ``cache_dtype`` defaults to the
    embedding's dtype, and ``"int8"`` (or ``torch.int8``) makes the pool
    int8 with f32 scale pools.  ``mesh``: as the dense engine's; the page
    axis never splits, so a paged mesh is tensor-only.
    """

    def __init__(
        self,
        params,
        *,
        num_heads: int,
        batch_slots: int,
        max_seq: int,
        page_size: int = 64,
        num_pages: Optional[int] = None,
        prefill_chunk: int = 64,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        cache_dtype=None,
        seed: int = 0,
        pad_id: int = 0,
        prefix_cache: bool = True,
        capture_logits: bool = False,
        decode_kernel: str = "auto",
        host_pages: int = 0,
        tier_policy: str = "lru",
        device: DeviceLike = None,
        mesh=None,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        num_layers, head_dim, dtype = self._setup(
            params, num_heads=num_heads, batch_slots=batch_slots,
            max_seq=max_seq, temperature=temperature, top_k=top_k, seed=seed,
            pad_id=pad_id, decode_kernel=decode_kernel,
            cache_dtype=cache_dtype, device=device, mesh=mesh, kv_layout="paged",
        )
        self.kv_layout = "paged"
        self.chunked_prefill = True
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        # pages each slot can address — the block-table width
        self.blocks_per_slot = pages_for(max_seq, page_size)
        if num_pages is None:
            # capacity parity with the dense layout; a deployment sets it
            # lower (the HBM win) and lets admission backpressure
            num_pages = batch_slots * self.blocks_per_slot
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages)
        self._prefix_enabled = prefix_cache
        self._cache = init_paged_cache(
            num_pages=num_pages, num_layers=num_layers, page_size=page_size,
            num_heads=num_heads, head_dim=head_dim, dtype=dtype,
            device=self.device, mesh=self.mesh,
        )
        self._page_bytes = page_bytes(self._cache)
        # host page tier: host_pages = 0 disables it; otherwise evictions
        # under alloc pressure demote to host, and the prefix walk restores
        # host hits by an asynchronous copy
        self.tier: Optional[HostPageTier] = None
        if host_pages:
            self.tier = HostPageTier(self._cache, host_pages, policy=tier_policy)
            self.allocator.set_evict_hook(self._tier_evict_hook)
        # host-side block tables, one row per slot; scratch-filled rows
        # make released, empty and mid-prefill slots write into page 0
        self._block_tables = np.full(
            (batch_slots, self.blocks_per_slot), SCRATCH_PAGE, np.int32
        )
        # their device copy, uploaded again only after a row changed
        self._tables_dev: Optional[torch.Tensor] = None
        self._slot_pages: dict = {}
        self._seen_chunk_shapes: set = set()
        self.prefix_hit_tokens = 0
        self.prompt_tokens_seen = 0
        self.pages_peak = 0
        self.chunks_run = 0
        # prompt tokens answered by a host-tier restore (a subset of
        # prefix_hit_tokens)
        self.prefix_hit_tokens_host = 0
        # the fidelity probe: with capture_logits the last decode step's
        # logits ([slots, vocab]) and the last prefill's logits row come
        # to the host (one extra copy a step); without it
        # last_prefill_logits is the row copied on the device (a view would
        # keep the chunk's whole [C, vocab] logits alive, bytes no ledger
        # owner claims)
        self.capture_logits = capture_logits
        self.last_logits: Optional[np.ndarray] = None
        self.last_prefill_logits = None
        # the attribution registry's programs (see the dense engine): one
        # row per chunk width under prefill_chunk
        tag = f"serve.paged.{self.kv_dtype}"
        self._chunk_prog = tracked_jit(f"{tag}.prefill_chunk",
                                       forward_prefill_chunk, dynamic=("offset",))
        self._decode_prog = tracked_jit(f"{tag}.decode", forward_decode_paged)
        self._scrub_prog = tracked_jit(f"{tag}.scrub", _scrub_pages,
                                       dynamic=("pages", "offsets"))
        _register_engine_owners(self)

    # -- accounting --------------------------------------------------------
    @property
    def block_tables(self) -> np.ndarray:
        return self._block_tables

    def device_tables(self) -> torch.Tensor:
        """The block tables on the engine's device.  Rows change only when
        a final prefill chunk lands or a slot is released, so the copy is
        made once per change, not once per decode or draft step."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._block_tables).to(self.device)
        return self._tables_dev

    def kv_bytes_peak(self) -> int:
        """Peak bytes of LIVE pages — HBM actually committed to sequences
        (the pay-per-token number the paged layout is for)."""
        return self.pages_peak * self._page_bytes

    @property
    def page_bytes_each(self) -> int:
        """Bytes of one pool page over every leaf — the granule
        ``admit_bytes`` multiplies and the spill pump prices headroom in."""
        return self._page_bytes

    def prefix_hit_rate(self) -> float:
        if not self.prompt_tokens_seen:
            return 0.0
        return self.prefix_hit_tokens / self.prompt_tokens_seen

    def reset_stats(self) -> None:
        """Zero the run counters (warm-up hygiene); the prefix TABLE
        survives — ``clear_prefix_cache`` drops that too."""
        self.prefill_compiles = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens_seen = 0
        self.pages_peak = 0
        self.chunks_run = 0
        self.prefix_hit_tokens_host = 0
        if self.tier is not None:
            self.tier.reset_stats()

    def clear_prefix_cache(self) -> None:
        self.allocator.clear_prefix()
        if self.tier is not None:
            self.tier.clear()

    def _chunk_width(self, rem: int) -> int:
        # full chunks, then a power-of-two bucket for the remainder
        if rem >= self.prefill_chunk:
            return self.prefill_chunk
        return prompt_bucket(rem, self.prefill_chunk)

    def chunk_shapes(self, prompt_len: int) -> set:
        """The chunk widths a prompt of ``prompt_len`` runs (as
        ``prefill_step`` chunks it, from offset 0)."""
        shapes = set()
        off = 0
        while off < prompt_len:
            C = self._chunk_width(prompt_len - off)
            shapes.add(C)
            off += min(prompt_len - off, C)
        return shapes

    def required_pages(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request needs end to end: prompt plus token budget,
        capped at the per-slot addressable window."""
        return pages_for(min(prompt_len + max_new_tokens, self.max_seq),
                         self.page_size)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Admission backpressure: pages are reserved for the WORST case
        (prompt + full budget) at admission, so decode never strands a
        sequence out of memory.  Conservative: a prefix hit needs fewer."""
        return (self.required_pages(prompt_len, max_new_tokens)
                <= self.allocator.available)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """False when the request exceeds the POOL itself — waiting can
        never admit it."""
        return self.required_pages(prompt_len, max_new_tokens) <= self.num_pages

    def admit_bytes(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case committed bytes of a request: its full page
        reservation times the page's bytes, scales included."""
        return self.required_pages(prompt_len, max_new_tokens) * self._page_bytes

    # -- prefill -----------------------------------------------------------
    def _prefix_key(self, prompt, n_pages: int):
        # the full token history through the end of page n: a hit holds
        # exactly prefill's K/V for those tokens
        return tuple(prompt[: n_pages * self.page_size])

    def prefill_begin(self, slot: int, prompt: Sequence[int],
                      max_new_tokens: int) -> PrefillTask:
        """Allocate the sequence's pages (prefix-cache hits first) and
        return the chunking task.  Raises :class:`OutOfPages`, holding no
        page, when the pool cannot take the request now."""
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
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} still holds pages — release first")
        ps = self.page_size
        n_total = self.required_pages(length, max_new_tokens)
        # prefix reuse: walk the chain of FULL prompt pages, capped at
        # length-1 tokens so the last prompt token always runs through
        # prefill — its logits seed the first sampled token.  The table
        # answers in either tier: a resident hit maps the page, a host hit
        # allocates a fresh page and restores it (the chunk pass that reads
        # it is ordered after the copy on the device, no host wait).  Each
        # page is held from the moment the walk finds it: a later host
        # hit's alloc may otherwise evict a page this walk already mapped
        # (ROADMAP C5)
        shared: list = []
        restored = 0
        if self._prefix_enabled:
            for i in range((length - 1) // ps):
                key = self._prefix_key(prompt, i + 1)
                page = self.allocator.lookup_prefix(key)
                if (page is None and self.tier is not None
                        and self.allocator.tier_state(key) == "host"):
                    page = self._prefetch_page(key)
                    restored += page is not None
                if page is None:
                    break
                self.allocator.incref(page)
                shared.append(page)
        try:
            fresh = self.allocator.alloc(n_total - len(shared))
        except OutOfPages:
            for p in shared:  # roll the hit refs back before backpressure
                self.allocator.decref(p)
            raise
        pages = shared + fresh
        self._slot_pages[slot] = pages
        # The slot's decode row stays SCRATCH until the final chunk lands
        # (prefill_step installs it): decode steps run WHILE this slot is
        # mid-prefill and every decode lane writes unconditionally, so with
        # the real row installed the stale lane's write (at pos 0) would
        # corrupt the prompt's K/V or a SHARED prefix page.  The chunks
        # read a task-local table instead.
        self.pages_peak = max(self.pages_peak, self.allocator.pages_in_use)
        offset = len(shared) * ps
        self.prompt_tokens_seen += length
        self.prefix_hit_tokens += offset
        self.prefix_hit_tokens_host += restored * ps
        return PrefillTask(slot, prompt, pages, offset, offset)

    @torch.inference_mode()
    def prefill_step(self, task: PrefillTask) -> Optional[int]:
        """Run ONE chunk of ``task``'s prompt; returns the first sampled
        token when the final chunk completes, else None."""
        if task.done:
            raise ValueError("prefill task already complete")
        length = len(task.prompt)
        rem = length - task.offset
        C = self._chunk_width(rem)
        real = min(rem, C)
        if C not in self._seen_chunk_shapes:
            self._seen_chunk_shapes.add(C)
            self.prefill_compiles += 1
        tokens = np.full((1, C), self.pad_id, np.int64)
        tokens[0, :real] = np.asarray(
            task.prompt[task.offset: task.offset + real], np.int64)
        # the task-local block table (see prefill_begin)
        table = np.full(self.blocks_per_slot, SCRATCH_PAGE, np.int32)
        table[: len(task.pages)] = task.pages
        with get_tracer().span("serve/engine.chunk_dispatch", chunk=C,
                               offset=task.offset):
            logits, _ = self._chunk_prog(
                self.params, torch.from_numpy(tokens).to(self.device),
                self._cache, torch.from_numpy(table).to(self.device),
                offset=task.offset, num_heads=self.num_heads,
                kernel=self.decode_kernel, mesh=self.mesh,
            )
        self.chunks_run += 1
        chunk_start = task.offset
        task.offset += real
        # publish the freshly completed FULL prompt pages at once, so
        # requests of the same wave that share the prefix hit too
        if self._prefix_enabled:
            for i in range(chunk_start // self.page_size,
                           min(task.offset, length) // self.page_size):
                key = self._prefix_key(task.prompt, i + 1)
                if (self.tier is not None
                        and self.allocator.tier_state(key) == "host"):
                    # this chunk just recomputed the page (the walk stops
                    # before the final prompt page): the fresh resident
                    # page supersedes the identical host copy
                    self.tier.drop(key)
                    self.allocator.drop_host(key)
                self.allocator.register_prefix(key, task.pages[i])
        if not task.done:
            return None
        # prompt fully written: NOW the slot's decode row may see the pages
        self._block_tables[task.slot] = SCRATCH_PAGE
        self._block_tables[task.slot, : len(task.pages)] = task.pages
        self._tables_dev = None
        # the last REAL position of the final chunk
        last = logits[0, real - 1]
        self.last_prefill_logits = (last.float().cpu().numpy()
                                    if self.capture_logits else last.clone())
        return self._sample_first(logits[:, real - 1])

    def prefill(self, slot: int, prompt: Sequence[int],
                max_new_tokens: Optional[int] = None) -> int:
        """Every chunk back to back (the dense engine's verb, for tests
        and direct use; the scheduler interleaves ``prefill_step`` with
        decode instead).  Without a budget the slot reserves through
        ``max_seq``."""
        if max_new_tokens is None:
            max_new_tokens = self.max_seq - len(prompt)
        task = self.prefill_begin(slot, prompt, max_new_tokens)
        while True:
            tok = self.prefill_step(task)
            if tok is not None:
                return tok

    # -- decode / release --------------------------------------------------
    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step for every slot through the block tables; the
        dense engine's contract.  Released and mid-prefill slots' rows
        point at the scratch page, so their (ignored) writes are
        harmless."""
        tok = torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device)
        p = torch.from_numpy(np.asarray(pos, np.int32)).to(self.device)
        with get_tracer().span("serve/engine.decode_dispatch"):
            logits, _ = self._decode_prog(
                self.params, tok, self._cache, p, self.device_tables(),
                num_heads=self.num_heads, kernel=self.decode_kernel,
                mesh=self.mesh,
            )
        # the probe's readback OUTSIDE the dispatch span, like the tokens'
        if self.capture_logits:
            self.last_logits = logits.float().cpu().numpy()
        return self._readback(logits)

    # -- fault injection / quarantine hooks --------------------------------
    def poison_slot(self, slot: int, pos: int) -> None:
        """Set ``slot``'s K history at logical position ``pos`` to NaN (on
        int8: its K scales), every layer.  K only — see the dense engine.
        ``pos`` must be decode-written (>= the prompt length): such pages
        are never in the prefix table, so the poison stays private."""
        pages = self._slot_pages.get(slot)
        if not pages:
            raise ValueError(f"slot {slot} holds no pages to poison")
        name = "k_scale" if "k_scale" in self._cache else "k"
        page = pages[pos // self.page_size]
        self._cache[name][page, :, pos % self.page_size] = float("nan")

    def scrub_slot(self, slot: int, from_pos: int = 0) -> None:
        """Zero the slot's cache from logical position ``from_pos`` on,
        position-granular (within the boundary page only offsets ``>=
        from_pos % page_size``), so positions below it survive bit-exact.

        Prefix-SHARED pages are never written: every touched page must be
        private to this slot; a call that would write a shared page raises
        instead of corrupting another slot's history."""
        pages = self._slot_pages.get(slot, [])
        ps = self.page_size
        start = from_pos // ps
        if start >= len(pages):
            return
        shared = [p for p in pages[start:] if self.allocator.is_shared(p)]
        if shared:
            raise ValueError(
                f"scrub_slot(slot={slot}, from_pos={from_pos}) would write "
                f"prefix-shared page(s) {shared} — shared pages are "
                "immutable; scrub only from the private region on"
            )
        self._scrub_prog(self._cache, pages=pages[start:],
                         offsets=[max(0, from_pos - idx * ps)
                                  for idx in range(start, len(pages))])

    def release(self, slot: int) -> None:
        """Return the slot's pages to the pool: prefix-registered pages
        drop to the reclaimable LRU (future hits resurrect them), private
        pages go back to the free list."""
        for page in self._slot_pages.pop(slot, []):
            self.allocator.decref(page)
        self._block_tables[slot] = SCRATCH_PAGE
        self._tables_dev = None

    # -- host page tier ----------------------------------------------------
    def _tier_evict_hook(self, key, page: int) -> bool:
        """Alloc-pressure demotion (installed on the allocator): copy the
        page about to be recycled to the host so its key keeps answering
        prefix hits.  False (the key is forgotten) only when the host pool
        can take nothing now."""
        evicted = self.tier.spill_in(self._cache, key, page)
        if evicted is None:
            return False
        for k in evicted:
            self.allocator.drop_host(k)
        return True

    def _prefetch_page(self, key):
        """Restore a host key into a fresh pool page: allocate, dispatch
        the copy, write the page on the compute stream (ordered after the
        copy by the tier's event) and hand the page to the prefix table
        (refcount 0, reclaimable; the caller's incref takes the slot's
        reference).  None when the pool has no page, or when that alloc's
        eviction dropped ``key`` itself from a full host pool (ROADMAP
        C6): the walk stops and the tail re-prefills."""
        try:
            (page,) = self.allocator.alloc(1)
        except OutOfPages:
            return None
        if self.allocator.tier_state(key) != "host":
            self.allocator.decref(page)
            return None
        for name, t in self.tier.dispatch_restore(key).items():
            self._cache[name][page].copy_(t)
        self.allocator.restore_prefix(key, page)
        self.allocator.decref(page)
        return page

    def spill_cold_pages(self, max_pages: int) -> int:
        """The spill pump's primitive: demote up to ``max_pages`` least
        recently used reclaimable prefix pages to the host tier, their
        pool pages back to the free list.  Returns the pages spilled.
        Only refcount-0 pages are candidates: a live page is never
        spilled."""
        if self.tier is None or max_pages <= 0:
            return 0
        spilled = 0
        for key, page in self.allocator.coldest_reclaimable(max_pages):
            evicted = self.tier.spill_in(self._cache, key, page)
            if evicted is None:
                break
            for k in evicted:
                self.allocator.drop_host(k)
            self.allocator.spill_prefix(key)
            spilled += 1
        return spilled

    def spill_slot_pages(self, slot: int, tokens: Sequence[int]) -> int:
        """The preemption path: demote the slot's PRIVATE full pages to
        the host tier keyed by their token history (``tokens`` = prompt +
        generated so far), so the resumed request's prefix walk restores
        them instead of re-prefilling.  Pages answering in either tier
        already (shared prefixes) are skipped.  Call BEFORE ``release``:
        the copies need the pages mapped and not yet recycled."""
        if self.tier is None:
            return 0
        pages = self._slot_pages.get(slot, [])
        n_full = min(len(tokens) // self.page_size, len(pages))
        spilled = 0
        for i in range(n_full):
            key = self._prefix_key(tokens, i + 1)
            if (self.allocator.tier_state(key) is not None
                    or self.allocator.is_shared(pages[i])):
                continue
            evicted = self.tier.spill_in(self._cache, key, pages[i])
            if evicted is None:
                break
            for k in evicted:
                self.allocator.drop_host(k)
            self.allocator.host_prefix(key)
            spilled += 1
        return spilled

    def tier_inflight(self) -> int:
        """Retire landed restores; how many are still in flight (the
        scheduler's admission gate polls this)."""
        return 0 if self.tier is None else self.tier.poll()

    def drain_tier(self) -> None:
        """Fence every in-flight restore (blocking) — the admission gate's
        last resort before it would preempt a victim."""
        if self.tier is not None:
            self.tier.drain()

    # -- live weight reload ------------------------------------------------
    def reload_params(self, params) -> None:
        """Swap the weight set IN PLACE (the dense engine's contract).
        Refuses while any slot holds pages (a slot spanning the swap would
        decode new-weight queries against old-weight K/V), and drops the
        prefix table and the host tier: their pages hold K/V of the OLD
        weights, and a hit on one would break the fresh-engine equality."""
        if self._slot_pages:
            raise ValueError(
                f"reload_params with live slots {sorted(self._slot_pages)} — "
                "reload is a barrier between requests; drain the slots first "
                "(the scheduler's request_reload does)")
        super().reload_params(params)
        self.allocator.clear_prefix()
        if self.tier is not None:
            self.tier.clear()

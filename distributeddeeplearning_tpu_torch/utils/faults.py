"""Deterministic, step-keyed fault injection — the port of
``utils/faults.py``: chaos you can unit-test.

A resilience layer that is never exercised is dead code.  This module
turns the failure modes of a long training run into injectable,
reproducible events, so every recovery path of the trainer runs on the
CPU in tests and on the card in ``chip_smoke.py``:

    DDLT_FAULTS="nan_loss@12,data_stall@30:secs=2,preempt@50,io_error@p=0.05:seed=7"

Grammar (comma-separated entries), the reference's, string for string::

    <kind>@<step>[:key=val]...      step-keyed, fires ONCE at true step N
    <kind>@p=<prob>[:key=val]...    probabilistic per opportunity, seeded

Train and storage kinds (consumed by the port's trainer, checkpointer,
metrics log, registry snapshots and goodput ledger):

- ``nan_loss``   poison the float arrays of the batch feeding step N with
                 NaN (numpy arrays or torch tensors, on the host or the
                 card) → the step's non-finite guard
                 (``build_train_step(skip_nonfinite=True)``) and the
                 :class:`~..train.resilience.AnomalyDetector` must react;
- ``data_stall`` the data iterator sleeps ``secs`` (default 1.0) before
                 yielding the batch for step N — watchdog fodder;
- ``data_death`` the data iterator raises :class:`DataStreamDeath` instead
                 of yielding step N's batch;
- ``preempt``    the :class:`~..train.resilience.PreemptionGuard` is
                 triggered during step N, exactly as if SIGTERM had
                 arrived — emergency checkpoint + resumable exit;
- ``io_error``   storage writes (checkpoint save/wait, metrics appends,
                 registry snapshots, goodput rows) raise
                 :class:`InjectedIOError` with probability ``p`` (seeded:
                 a seed gives one failure sequence).  The ``@N`` form
                 fires once at the **Nth storage opportunity**, not at
                 true step N;
- ``ckpt_corrupt`` corrupt the Nth FINALIZED checkpoint generation right
                 after its manifest lands — ``:mode=`` ``flip``,
                 ``truncate``, ``unlink`` or ``manifest`` (the port's
                 :func:`~..train.checkpoint.corrupt_generation`);
- ``ckpt_torn``  the Nth generation finalize truncates its data file and
                 never writes its manifest: never restore-eligible.

The ``ckpt_*`` ``@N`` is generation-opportunity keyed, like
``io_error@N``.

Serve kinds (consumed by ``serve/scheduler.py`` and the fleet worker in
``serve/fleet.py``; their ``@N`` is the scheduler's **decode step**,
1-based per worker process, matched at-or-after: the first decode step
``>= N``):

- ``replica_death`` the fleet worker hard-exits (``os._exit``) at the
                 first decode step >= N: no drain, no goodbye; the router
                 detects the death, restarts the replica and requeues its
                 in-flight requests onto survivors;
- ``decode_nan``   one active request's K history is poisoned with NaN at
                 the first decode step >= N with an eligible victim (a slot
                 that has decoded at least one token, so the poison lands
                 in a private page): the quarantine must fail ONLY it;
- ``decode_stall`` the decode dispatch sleeps ``secs`` (default 1.0) at
                 the first decode step >= N — scheduler-watchdog fodder;
- ``reject_admit`` admission rejects the request with probability ``p``
                 (or once at the Nth admission opportunity): it finishes
                 ``"shed"``.

Traffic kinds (consumed by ``serve/traffic.py`` at schedule build; their
``@N`` is the Nth matching build opportunity, one per tenant per
``schedule`` call; a ``tenant=`` option restricts matching to that
tenant):

- ``burst``       splice an extra poisson burst into the tenant's schedule
                  (``rps=``, default 4x its rate; ``secs=``, default 1.0;
                  ``at=``, default 0.0);
- ``slow_tenant`` multiply the tenant's prompt lengths (and its token
                  budget, when set) by ``factor=`` (default 4.0).

The fleet router deals the serve kinds across its replica workers
(:func:`deal_serve_faults`) and strips ``replica_death`` from a restarted
replica's slice (:func:`strip_kinds`).

Step numbering for the train/data kinds is the **true step**: the step
whose completion sets ``state.step == N`` (the numbering checkpoints
use), 1-based.  Faults are **one-shot per plan**: the plan is a process
singleton (:func:`get_plan`) that survives in-process supervisor
restarts, so ``preempt@50`` fires once and the resumed attempt runs past
step 50.  :func:`reset` re-parses the environment and :func:`install_plan`
installs an explicit spec (``install_plan("")`` disarms); the one-shot
flags and the opportunity counters belong to the plan, so a new plan
starts from nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import time
from typing import Any, Dict, Iterator, List, Optional

logger = logging.getLogger("ddlt.faults")

ENV_VAR = "DDLT_FAULTS"

KINDS = (
    "nan_loss", "data_stall", "data_death", "preempt", "io_error",
    "replica_death", "decode_nan", "decode_stall", "reject_admit",
    "ckpt_corrupt", "ckpt_torn", "burst", "slow_tenant",
)

#: kinds the serving stack consumes: the fleet router deals these across
#: its replica workers instead of letting every worker fire all of them
SERVE_KINDS = ("replica_death", "decode_nan", "decode_stall", "reject_admit")

class InjectedIOError(IOError):
    """A storage failure injected by an ``io_error`` fault."""


class DataStreamDeath(RuntimeError):
    """The input stream died mid-epoch (``data_death`` fault, or real)."""

    def __init__(self, msg: str, *, step: Optional[int] = None):
        super().__init__(msg)
        self.step = step


@dataclasses.dataclass
class FaultSpec:
    kind: str
    step: Optional[int] = None       # step-keyed trigger (1-based true step)
    prob: Optional[float] = None     # probabilistic trigger
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fired: bool = False              # one-shot bookkeeping (step-keyed only)

    def describe(self) -> str:
        trig = f"@{self.step}" if self.step is not None else f"@p={self.prob}"
        opts = "".join(f":{k}={v}" for k, v in self.options.items())
        return f"{self.kind}{trig}{opts}"


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse the ``DDLT_FAULTS`` grammar; raises ValueError on bad entries."""
    specs: List[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        head, *opt_parts = raw.split(":")
        if "@" not in head:
            raise ValueError(
                f"fault entry {raw!r} missing '@<step>' or '@p=<prob>'"
            )
        kind, trigger = head.split("@", 1)
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; known: {', '.join(KINDS)}"
            )
        options: Dict[str, Any] = {}
        for part in opt_parts:
            if "=" not in part:
                raise ValueError(f"fault option {part!r} is not key=val")
            k, v = part.split("=", 1)
            try:
                options[k] = int(v)
            except ValueError:
                try:
                    options[k] = float(v)
                except ValueError:
                    options[k] = v
        if trigger.startswith("p="):
            prob = float(trigger[2:])
            if not 0.0 <= prob <= 1.0:
                raise ValueError(f"fault probability {prob} outside [0, 1]")
            specs.append(FaultSpec(kind=kind, prob=prob, options=options))
        else:
            step = int(trigger)
            if step < 1:
                raise ValueError(
                    f"fault step {step} must be >= 1 (true-step numbering)"
                )
            specs.append(FaultSpec(kind=kind, step=step, options=options))
    return specs


@dataclasses.dataclass
class FaultEvent:
    kind: str
    step: Optional[int]
    site: str
    at: float


class FaultPlan:
    """A parsed fault schedule plus firing bookkeeping.

    Falsy when empty, so hot loops can gate on ``if plan:`` and pay nothing
    in the no-fault case.
    """

    def __init__(self, specs: Optional[List[FaultSpec]] = None):
        self.specs = specs or []
        self.events: List[FaultEvent] = []
        self._rngs: Dict[int, random.Random] = {}
        self._io_opportunities: Dict[int, int] = {}  # per-spec call counter

    def __bool__(self) -> bool:
        return bool(self.specs)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "FaultPlan":
        text = (env if env is not None else os.environ).get(ENV_VAR, "")
        return cls(parse_spec(text)) if text else cls()

    # -- firing ----------------------------------------------------------

    def _record(self, spec: FaultSpec, step: Optional[int], site: str) -> None:
        self.events.append(
            FaultEvent(kind=spec.kind, step=step, site=site, at=time.time())
        )
        logger.warning(
            "FAULT INJECTED: %s at step %s (%s)", spec.describe(), step, site
        )
        # every injected fault lands in the flight-recorder ring too, so
        # a dump triggered moments later shows the injection next to its
        # consequences (lazy import: faults is a leaf utility)
        try:
            from distributeddeeplearning_tpu_torch.obs.recorder import get_recorder

            get_recorder().record_event(
                f"fault/{spec.kind}", "fault", {"step": step, "site": site}
            )
        except Exception:  # pragma: no cover - recording must never fault
            pass

    def _take_step_keyed(self, kind: str, step: int) -> Optional[FaultSpec]:
        """Consume the one-shot step-keyed ``kind`` fault for ``step``."""
        for spec in self.specs:
            if spec.kind == kind and spec.step == step and not spec.fired:
                spec.fired = True
                self._record(spec, step, kind)
                return spec
        return None

    def _take_at_or_after(self, kind: str, step: int) -> Optional[FaultSpec]:
        """Consume the one-shot ``kind`` fault armed for any step <=
        ``step`` (the serve decode-step kinds' matching)."""
        for spec in self.specs:
            if (spec.kind == kind and spec.step is not None
                    and spec.step <= step and not spec.fired):
                spec.fired = True
                self._record(spec, step, kind)
                return spec
        return None

    def _prob_fires(self, spec: FaultSpec, site: str) -> bool:
        rng = self._rngs.setdefault(
            id(spec), random.Random(int(spec.options.get("seed", 0)))
        )
        if rng.random() < (spec.prob or 0.0):
            self._record(spec, None, site)
            return True
        return False

    # -- hook: train step ------------------------------------------------

    def poison_batch(self, step: int, batch):
        """``nan_loss``: NaN-fill the float arrays of step N's batch.

        Leaves may be numpy arrays or torch tensors (host or card: after
        the trainer's prefetch the loop holds device tensors); a tensor is
        replaced by a NaN fill on its own device, no host copy.  Integer
        leaves (token ids, labels, masks) pass through untouched; a batch
        with no float leaf raises loudly — the fault would otherwise be a
        silent no-op and the test asserting recovery would pass vacuously.
        """
        import numpy as np
        import torch

        if self._take_step_keyed("nan_loss", step) is None:
            return batch
        poisoned = dict(batch)
        hit = False
        for key, arr in poisoned.items():
            if isinstance(arr, torch.Tensor):
                if arr.is_floating_point():
                    poisoned[key] = torch.full_like(arr, float("nan"))
                    hit = True
                continue
            a = np.asarray(arr)
            if np.issubdtype(a.dtype, np.floating):
                poisoned[key] = np.full_like(a, np.nan)
                hit = True
        if not hit:
            raise ValueError(
                "nan_loss fault fired but the batch has no float array to "
                f"poison (keys: {sorted(batch)}); token-only workloads "
                "cannot express this fault"
            )
        return poisoned

    def maybe_preempt(self, step: int, guard) -> bool:
        """``preempt``: trigger ``guard`` as if SIGTERM arrived at step N."""
        spec = self._take_step_keyed("preempt", step)
        if spec is None:
            return False
        guard.trigger(reason=f"injected preempt@{step}")
        return True

    # -- hook: data iterator ---------------------------------------------

    def wrap_data(self, batches: Iterator, *, start_step: int = 0) -> Iterator:
        """Apply ``data_stall`` / ``data_death`` to a batch stream.

        The batch yielded ``i``-th feeds true step ``start_step + i + 1`` —
        the same numbering the step-keyed triggers use.
        """
        if not any(s.kind in ("data_stall", "data_death") for s in self.specs):
            return batches

        def wrapped():
            step = start_step
            for batch in batches:
                step += 1
                spec = self._take_step_keyed("data_death", step)
                if spec is not None:
                    raise DataStreamDeath(
                        f"injected data_death@{step}", step=step
                    )
                spec = self._take_step_keyed("data_stall", step)
                if spec is not None:
                    time.sleep(float(spec.options.get("secs", 1.0)))
                yield batch

        return wrapped()

    # -- hook: serve scheduler / fleet worker ----------------------------

    def take_replica_death(self, step: int) -> bool:
        """``replica_death``: True when the worker should hard-exit now
        (first decode step >= the armed step)."""
        return self._take_at_or_after("replica_death", step) is not None

    def take_decode_stall(self, step: int) -> Optional[float]:
        """``decode_stall``: seconds to sleep before this decode step's
        dispatch, or None."""
        spec = self._take_at_or_after("decode_stall", step)
        if spec is None:
            return None
        return float(spec.options.get("secs", 1.0))

    def has_decode_nan(self, step: int) -> bool:
        """Non-consuming peek: a ``decode_nan`` is armed for step <= N.
        The scheduler peeks first because the fault needs an eligible
        victim; with none active the fault stays armed for the next
        step instead of being burned on a no-op."""
        return any(s.kind == "decode_nan" and s.step is not None
                   and s.step <= step and not s.fired for s in self.specs)

    def take_decode_nan(self, step: int) -> bool:
        """Consume the armed ``decode_nan`` (call only with a victim)."""
        return self._take_at_or_after("decode_nan", step) is not None

    def maybe_reject_admit(self) -> bool:
        """``reject_admit``: True when THIS admission opportunity must be
        rejected (``@p=``, seeded, or once at the Nth opportunity)."""
        for spec in self.specs:
            if spec.kind != "reject_admit":
                continue
            if spec.prob is not None:
                if self._prob_fires(spec, "reject_admit"):
                    return True
            elif not spec.fired:
                n = self._io_opportunities.get(id(spec), 0) + 1
                self._io_opportunities[id(spec)] = n
                if n >= (spec.step or 1):
                    spec.fired = True
                    self._record(spec, spec.step, "reject_admit")
                    return True
        return False

    # -- hook: traffic generation (serve/traffic.py) ---------------------

    def _take_tenant_keyed(self, kind: str, tenant: str) -> Optional[Dict[str, Any]]:
        """Consume a one-shot ``kind`` fault at its Nth MATCHING
        schedule-build opportunity; a ``tenant=`` option restricts the
        matching (and the counting) to that tenant's builds."""
        for spec in self.specs:
            if spec.kind != kind or spec.fired:
                continue
            want = spec.options.get("tenant")
            if want is not None and str(want) != tenant:
                continue
            n = self._io_opportunities.get(id(spec), 0) + 1
            self._io_opportunities[id(spec)] = n
            if n >= (spec.step or 1):
                spec.fired = True
                self._record(spec, spec.step, f"{kind}:{tenant}")
                return dict(spec.options)
        return None

    def take_burst(self, tenant: str) -> Optional[Dict[str, Any]]:
        """``burst``: options (``rps`` / ``secs`` / ``at``) for THIS
        tenant's schedule build, else None."""
        return self._take_tenant_keyed("burst", tenant)

    def take_slow_tenant(self, tenant: str) -> Optional[Dict[str, Any]]:
        """``slow_tenant``: options (``factor``) for THIS tenant's
        schedule build, else None."""
        return self._take_tenant_keyed("slow_tenant", tenant)

    # -- hook: storage paths ---------------------------------------------

    def maybe_io_error(self, site: str) -> None:
        """``io_error``: raise :class:`InjectedIOError` at a storage call.

        The ``@N`` form is opportunity-keyed (fires once, at the Nth
        ``maybe_io_error`` call across all storage sites): the storage
        paths have no train-step context, so true-step keying is not
        expressible here — see the module docstring.
        """
        for spec in self.specs:
            if spec.kind != "io_error":
                continue
            if spec.prob is not None:
                if self._prob_fires(spec, site):
                    raise InjectedIOError(f"injected io_error ({site})")
            elif not spec.fired:
                n = self._io_opportunities.get(id(spec), 0) + 1
                self._io_opportunities[id(spec)] = n
                if n >= (spec.step or 1):
                    spec.fired = True
                    self._record(spec, spec.step, site)
                    raise InjectedIOError(f"injected io_error ({site})")

    # -- hook: checkpoint durability (train/checkpoint.py) ---------------

    def _take_nth_opportunity(
        self, kind: str, site: str
    ) -> Optional[FaultSpec]:
        """Consume a one-shot ``kind`` fault at its Nth opportunity (the
        per-spec call counter — the same keying ``io_error@N`` uses,
        because storage paths have no train-step context)."""
        for spec in self.specs:
            if spec.kind != kind or spec.fired:
                continue
            n = self._io_opportunities.get(id(spec), 0) + 1
            self._io_opportunities[id(spec)] = n
            if n >= (spec.step or 1):
                spec.fired = True
                self._record(spec, spec.step, site)
                return spec
        return None

    def take_ckpt_corrupt(self) -> Optional[Dict[str, Any]]:
        """``ckpt_corrupt``: options dict (``mode`` etc.) when THIS
        checkpoint-generation finalize must corrupt the generation it
        just committed, else None.  Opportunity-keyed: ``@N`` fires at
        the Nth finalized generation of the process."""
        spec = self._take_nth_opportunity("ckpt_corrupt", "ckpt_corrupt")
        return dict(spec.options) if spec is not None else None

    def take_ckpt_torn(self) -> bool:
        """``ckpt_torn``: True when THIS save finalize must tear the
        generation (truncate a data file, never write the manifest) —
        the writer-died-mid-generation failure mode."""
        return (
            self._take_nth_opportunity("ckpt_torn", "ckpt_torn") is not None
        )

    # -- reporting -------------------------------------------------------

    def report(self) -> List[Dict[str, Any]]:
        return [
            {"kind": e.kind, "step": e.step, "site": e.site}
            for e in self.events
        ]


# -- fleet helpers: dealing a spec across replica workers -----------------


def deal_serve_faults(text: str, n_replicas: int) -> List[str]:
    """Split a ``DDLT_FAULTS`` spec into one spec string per replica.

    Serve-side entries (:data:`SERVE_KINDS`) go to exactly one replica: an
    explicit ``:replica=k`` option wins, otherwise they are dealt
    round-robin in spec order, since without dealing ``replica_death@3``
    would kill every replica at its own step 3 and leave no survivor.
    Every other entry replicates to all workers.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    dealt: List[List[str]] = [[] for _ in range(n_replicas)]
    serve_i = 0
    for spec in parse_spec(text or ""):
        if spec.kind in SERVE_KINDS:
            if "replica" in spec.options:
                target = int(spec.options["replica"]) % n_replicas
            else:
                target = serve_i % n_replicas
                serve_i += 1
            dealt[target].append(spec.describe())
        else:
            for entries in dealt:
                entries.append(spec.describe())
    return [",".join(entries) for entries in dealt]


def strip_kinds(text: str, kinds) -> str:
    """Drop every entry of the given kinds from a spec string: the fleet
    router strips ``replica_death`` from a restarted replica's slice so an
    injected death is not replayed forever."""
    kept = [s.describe() for s in parse_spec(text or "") if s.kind not in kinds]
    return ",".join(kept)


# -- process-level plan (one-shot across in-process restarts) ------------

_PLAN: Optional[FaultPlan] = None


def get_plan() -> FaultPlan:
    """The process's active plan, parsed from ``DDLT_FAULTS`` on first use."""
    global _PLAN
    if _PLAN is None:
        _PLAN = FaultPlan.from_env()
        if _PLAN:
            logger.warning(
                "fault injection ACTIVE: %s",
                ", ".join(s.describe() for s in _PLAN.specs),
            )
    return _PLAN


def reset() -> FaultPlan:
    """Re-parse ``DDLT_FAULTS`` and re-arm every fault (tests, new runs)."""
    global _PLAN
    _PLAN = None
    return get_plan()


def install_plan(text: str) -> FaultPlan:
    """Install an explicit spec as THE process plan, ignoring the
    environment: a fresh plan, every fault armed and every opportunity
    counter at zero (``""`` disarms).  In-process runs that each arm their
    own faults use this, so nothing leaks from one run into the next."""
    global _PLAN
    _PLAN = FaultPlan(parse_spec(text or ""))
    if _PLAN:
        logger.warning(
            "fault injection ACTIVE (installed): %s",
            ", ".join(s.describe() for s in _PLAN.specs),
        )
    return _PLAN

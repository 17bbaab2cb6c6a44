"""Synthetic multi-tenant traffic: deterministic arrival schedules
(``serve/traffic.py``; numpy only).

A static prompt list is fine for throughput and useless for overload
work, where WHO arrives WHEN is the whole experiment.  This module is the
load harness of the multi-tenant serving stack: each :class:`TenantSpec` names a tenant, its
priority class, an arrival process and a prompt-length mix, and
:class:`TrafficGenerator` turns a tenant set into one deterministic
timed request schedule.

Determinism is the contract: the same ``(tenants, vocab_size, seed)``
produce the SAME schedule — same uids, same arrival times, same prompts —
so an overload run and its unpressured twin serve identical request
sets, and a preempted stream has a fault-free twin to be held against.
For the same tenants and seed a schedule equals the reference's.  Per-tenant randomness derives
from ``(seed, tenant index)`` seed sequences, so adding a tenant never
perturbs another tenant's schedule.

Arrival processes (``TenantSpec.arrival``):

- ``poisson``  exponential inter-arrival gaps at ``rate_rps`` — the
               classic open-loop load model;
- ``uniform``  evenly spaced arrivals at ``rate_rps`` (no variance —
               queueing effects isolated from arrival noise);
- ``bursty``   silent except for a ``burst_secs`` window at the top of
               every ``burst_period_s`` period, inside which arrivals are
               poisson at ``burst_rps`` (default 4x the base rate) — the
               misbehaving-client shape.

Chaos integration (:mod:`..utils.faults`): schedule build consumes two
fault kinds, so a ``DDLT_FAULTS`` spec can CREATE the overload —

- ``burst@N:tenant=<name>:rps=<r>[:secs=<s>][:at=<t>]`` splices an extra
  poisson arrival burst into the named tenant's schedule;
- ``slow_tenant@N:tenant=<name>[:factor=<f>]`` multiplies the named
  tenant's prompt lengths (and per-request token budget, when the tenant
  sets one) by ``factor`` — the straggler-tenant shape.

:func:`poll_source` adapts a schedule into the ``poll()`` callable the
scheduler speaks, replaying arrivals in real
(optionally scaled) time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from distributeddeeplearning_tpu_torch.serve.scheduler import Request
from distributeddeeplearning_tpu_torch.utils import faults as faults_mod

__all__ = ["ARRIVALS", "TenantSpec", "TimedRequest", "TrafficGenerator",
           "poll_source"]

ARRIVALS = ("poisson", "uniform", "bursty")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape: identity, SLO class, arrivals, prompts.

    ``rate_rps`` is the MEAN arrival rate for ``poisson``/``uniform``;
    for ``bursty`` it is the rate INSIDE a burst window when
    ``burst_rps`` is unset (outside the window the tenant is silent).
    """

    name: str
    priority: str = "standard"
    rate_rps: float = 4.0
    arrival: str = "poisson"
    burst_rps: Optional[float] = None    # bursty: in-window rate
    burst_secs: float = 1.0              # bursty: window length
    burst_period_s: float = 4.0          # bursty: one window per period
    prompt_min: int = 2
    prompt_max: int = 16
    max_new_tokens: Optional[int] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if not self.name or any(c.isspace() for c in self.name):
            raise ValueError(
                f"tenant name must be non-empty and whitespace-free, "
                f"got {self.name!r}"
            )
        if self.arrival not in ARRIVALS:
            raise ValueError(
                f"arrival must be one of {ARRIVALS}, got {self.arrival!r}"
            )
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if not 1 <= self.prompt_min <= self.prompt_max:
            raise ValueError(
                f"need 1 <= prompt_min <= prompt_max, got "
                f"[{self.prompt_min}, {self.prompt_max}]"
            )
        if self.arrival == "bursty":
            if self.burst_secs <= 0 or self.burst_period_s <= 0:
                raise ValueError(
                    "bursty arrivals need burst_secs > 0 and "
                    "burst_period_s > 0"
                )
            if self.burst_secs > self.burst_period_s:
                raise ValueError(
                    f"burst_secs {self.burst_secs} exceeds its period "
                    f"{self.burst_period_s} — that is just a higher "
                    "steady rate, say so with poisson"
                )


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """A request plus its schedule offset (seconds from schedule start)."""

    at_s: float
    request: Request


class TrafficGenerator:
    """Deterministic timed request schedules over a set of tenants."""

    def __init__(
        self,
        tenants: Sequence[TenantSpec],
        *,
        vocab_size: int,
        seed: int = 0,
    ):
        if not tenants:
            raise ValueError("need at least one TenantSpec")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        if vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
        self.tenants = tuple(tenants)
        self.vocab_size = vocab_size
        self.seed = seed

    def _rng(self, tenant_index: int, stream: int = 0) -> np.random.Generator:
        # (seed, tenant index, stream) seed sequence: adding/removing a
        # tenant never perturbs another tenant's arrivals or prompts, and
        # the chaos-burst stream is independent of the base schedule
        return np.random.default_rng((self.seed, tenant_index, stream))

    def _arrivals(
        self, t: TenantSpec, rng: np.random.Generator, duration_s: float
    ) -> List[float]:
        if t.arrival == "uniform":
            gap = 1.0 / t.rate_rps
            return [i * gap for i in range(int(duration_s * t.rate_rps))]
        if t.arrival == "poisson":
            return _poisson_times(rng, t.rate_rps, 0.0, duration_s)
        # bursty: poisson inside each period's leading window, silent out
        times: List[float] = []
        rate = t.burst_rps if t.burst_rps is not None else 4.0 * t.rate_rps
        start = 0.0
        while start < duration_s:
            end = min(start + t.burst_secs, duration_s)
            times.extend(_poisson_times(rng, rate, start, end))
            start += t.burst_period_s
        return times

    def schedule(self, duration_s: float) -> List[TimedRequest]:
        """The full timed request set for ``duration_s`` seconds of load.

        Consumes the process fault plan's ``burst``/``slow_tenant``
        entries (one schedule build = one injection opportunity per
        tenant), so ``DDLT_FAULTS`` chaos specs shape the traffic itself.
        """
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        plan = faults_mod.get_plan()
        out: List[TimedRequest] = []
        for idx, tenant in enumerate(self.tenants):
            rng = self._rng(idx)
            times = self._arrivals(tenant, rng, duration_s)
            prompt_scale = 1.0
            max_new = tenant.max_new_tokens
            if plan:
                slow = plan.take_slow_tenant(tenant.name)
                if slow is not None:
                    prompt_scale = float(slow.get("factor", 4.0))
                    if max_new is not None:
                        max_new = max(1, int(max_new * prompt_scale))
                burst = plan.take_burst(tenant.name)
                if burst is not None:
                    at = float(burst.get("at", 0.0))
                    secs = float(burst.get("secs", 1.0))
                    rps = float(burst.get("rps", 4.0 * tenant.rate_rps))
                    times = times + _poisson_times(
                        self._rng(idx, stream=1), rps, at,
                        min(at + secs, duration_s),
                    )
            times.sort()
            for i, at_s in enumerate(times):
                lo = max(1, int(tenant.prompt_min * prompt_scale))
                hi = max(lo, int(tenant.prompt_max * prompt_scale))
                length = int(rng.integers(lo, hi + 1))
                prompt = rng.integers(1, self.vocab_size, length).tolist()
                out.append(TimedRequest(
                    at_s=round(at_s, 6),
                    request=Request(
                        uid=f"{tenant.name}-{i:03d}",
                        prompt=prompt,
                        max_new_tokens=max_new,
                        deadline_s=tenant.deadline_s,
                        tenant=tenant.name,
                        priority=tenant.priority,
                    ),
                ))
        # stable merge across tenants: time first, uid breaks exact ties
        out.sort(key=lambda tr: (tr.at_s, tr.request.uid))
        return out

    def requests(self, duration_s: float) -> List[Request]:
        """The schedule's requests without timing — static-batch callers."""
        return [tr.request for tr in self.schedule(duration_s)]


def _poisson_times(
    rng: np.random.Generator, rate_rps: float, start_s: float, end_s: float
) -> List[float]:
    """Poisson-process arrival offsets in [start_s, end_s)."""
    if rate_rps <= 0 or end_s <= start_s:
        return []
    times: List[float] = []
    t = start_s + float(rng.exponential(1.0 / rate_rps))
    while t < end_s:
        times.append(t)
        t += float(rng.exponential(1.0 / rate_rps))
    return times


def poll_source(
    schedule: Sequence[TimedRequest],
    *,
    speedup: float = 1.0,
    clock: Callable[[], float] = time.perf_counter,
) -> Callable[[], Optional[List[Request]]]:
    """Adapt a schedule into the ``poll()`` callable the scheduler
    speaks: each call releases every request whose arrival
    time has passed (schedule clock starts at the FIRST call, so callers
    can build the source early and start the clock when serving actually
    begins); returns None once the schedule is exhausted — the
    source-closed signal the serve loops drain on.

    ``speedup > 1`` compresses the schedule (arrival ``at_s`` lands at
    wall offset ``at_s / speedup``) — CPU smoke runs replay a seconds-
    long schedule in a fraction of it without changing arrival ORDER.
    """
    if speedup <= 0:
        raise ValueError(f"speedup must be > 0, got {speedup}")
    ordered = sorted(schedule, key=lambda tr: (tr.at_s, tr.request.uid))
    state = {"start": None, "i": 0}

    def poll() -> Optional[List[Request]]:
        if state["start"] is None:
            state["start"] = clock()
        if state["i"] >= len(ordered):
            return None
        elapsed = (clock() - state["start"]) * speedup
        fresh: List[Request] = []
        while (
            state["i"] < len(ordered)
            and ordered[state["i"]].at_s <= elapsed
        ):
            fresh.append(ordered[state["i"]].request)
            state["i"] += 1
        return fresh

    return poll

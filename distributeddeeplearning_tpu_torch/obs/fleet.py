"""Fleet-scale observability, the port of ``obs/fleet.py``: merge the
per-worker shards of a serving fleet onto one timeline.

Every replica worker of :mod:`..serve.fleet` runs in its own process, where
its spans, histogram buckets and counters would die with it.  This module
is the router-side merge layer:

- **trace shards**: every worker exports a Chrome-trace shard with its own
  pid and process name (:meth:`~.trace.Tracer.to_chrome_trace`);
  :func:`merge_fleet_trace` shifts each shard onto the ROUTER's clock by a
  clock-offset estimate (the ready handshake's, else the difference of the
  two tracers' wall-clock epochs) and unions them into one
  ``fleet.trace.json`` where a failover reads left to right: admit,
  prefill, decode on the dying replica, ``fleet/replica_died``,
  ``fleet/request_requeued``, completion on the survivor, all under one
  trace id (:func:`failover_chains` / :func:`check_failover_chain`);
- **mergeable metrics**: workers ship full registry states (histogram
  BUCKETS, not percentile summaries); :func:`~.registry.merge_states`
  folds them bucket-wise, so fleet TTFT/TPOT percentiles are what one
  process recording every sample would report (:func:`fleet_latency`);
- **SLOs**: :class:`SLOSpec` is the declarative gate (TTFT p99, TPOT p99,
  error rate, zero lost requests) over the merged metrics and the fleet
  report, per priority class too (:func:`evaluate_class_slos`).

:func:`observe_fleet` is the one choreography that runs a traced fleet and
assembles that view.  Host-side only: nothing here touches the card.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from distributeddeeplearning_tpu_torch.obs.registry import MetricsRegistry

__all__ = [
    "SLOSpec",
    "merge_fleet_trace",
    "load_trace_shards",
    "failover_chains",
    "check_failover_chain",
    "fleet_latency",
    "fleet_latency_per_class",
    "parse_class_slos",
    "evaluate_class_slos",
    "observe_fleet",
    "summarize_timeline",
]

#: fleet histogram names the SLO layer reads — the scheduler's end-of-run
#: rollup feeds these in every worker (obs/registry names are a contract);
#: per-priority-class splits ride the same names with a ``.<class>``
#: suffix (``serve.ttft_s.premium`` ...), fed per completion by the
#: scheduler's finish path
TTFT_HISTOGRAM = "serve.ttft_s"
TPOT_HISTOGRAM = "serve.tpot_s"


# -- trace shard merge -----------------------------------------------------


def load_trace_shards(trace_dir: str) -> List[Dict[str, Any]]:
    """Every worker shard under ``trace_dir`` (``replica*.trace.json``),
    parse order stable by filename.  Unreadable shards are skipped — a
    worker killed mid-write must not sink the merge of the survivors."""
    shards: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "replica*.trace.json"))):
        try:
            with open(path) as f:
                shards.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return shards


def merge_fleet_trace(
    router_trace: Dict[str, Any],
    shards: Sequence[Dict[str, Any]],
    *,
    offsets_us: Optional[Dict[int, float]] = None,
) -> Dict[str, Any]:
    """One Chrome-trace container: router events + every worker shard,
    all on the ROUTER's clock.

    Per shard the clock offset is ``offsets_us[pid]`` when the caller
    measured one (the router's ready-handshake estimate), else the
    difference of the two tracers' wall-clock epochs
    (``metadata.tracer_epoch_unix_s`` — exact on one host, where every
    process shares the wall clock while ``perf_counter`` epochs differ).
    Shard pids keep their own process rows; a pid that collides with one
    already merged is remapped so two processes can never interleave
    into one track (the bug the derived-pid export fixed).
    """
    merged = {
        "traceEvents": list(router_trace.get("traceEvents", [])),
        "displayTimeUnit": "ms",
        "metadata": dict(router_trace.get("metadata", {})),
    }
    router_epoch = float(
        merged["metadata"].get("tracer_epoch_unix_s", 0.0)
    )
    host_pids = set(merged["metadata"].get("host_pids") or [])
    for ev in merged["traceEvents"]:
        if "pid" in ev:
            host_pids.add(ev["pid"])
    used_pids = set(host_pids)
    shard_meta: List[Dict[str, Any]] = []
    for shard in shards:
        meta = shard.get("metadata", {})
        shard_epoch = float(meta.get("tracer_epoch_unix_s", router_epoch))
        shard_pids = set(meta.get("host_pids") or [])
        for ev in shard.get("traceEvents", []):
            if "pid" in ev:
                shard_pids.add(ev["pid"])
        # handshake offset (keyed by the shard's primary pid) wins over
        # the epoch difference; both express "add this many µs to shard
        # timestamps to land them on the router clock"
        primary = (meta.get("host_pids") or sorted(shard_pids) or [None])[0]
        if offsets_us is not None and primary in offsets_us:
            offset = float(offsets_us[primary])
            offset_source = "handshake"
        else:
            offset = (shard_epoch - router_epoch) * 1e6
            offset_source = "epoch"
        # pid collision remap: keep every process on its own track
        remap: Dict[int, int] = {}
        for pid in sorted(shard_pids):
            if pid in used_pids:
                fresh = max(used_pids | set(remap.values())) + 1
                remap[pid] = fresh
            else:
                remap[pid] = pid
            used_pids.add(remap[pid])
        for ev in shard.get("traceEvents", []):
            ev = dict(ev)
            if "pid" in ev:
                ev["pid"] = remap.get(ev["pid"], ev["pid"])
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + offset
            merged["traceEvents"].append(ev)
        mapped = sorted(remap.values())
        host_pids.update(mapped)
        shard_meta.append(
            {
                "process_name": meta.get("process_name"),
                "pids": mapped,
                "offset_us": round(offset, 1),
                "offset_source": offset_source,
            }
        )
    merged["metadata"]["host_pids"] = sorted(host_pids)
    merged["metadata"]["clock"] = "router perf_counter us"
    merged["metadata"]["shards"] = shard_meta
    return merged


# -- failover chains -------------------------------------------------------


def failover_chains(
    merged: Dict[str, Any],
    trace_ids: Optional[Sequence[str]] = None,
) -> Dict[str, List[Dict[str, Any]]]:
    """Group the merged timeline's events by trace id.

    An event belongs to trace ``T`` when its args carry ``trace == T``
    (per-request scheduler spans/events, router requeue/lost events) or
    ``T in args.trace_ids`` (replica-level events like
    ``fleet/replica_died``, which orphan several traces at once).
    Chains come back in router-clock order — which is what makes
    "the failover is visible end-to-end" checkable rather than vibes.
    """
    chains: Dict[str, List[Dict[str, Any]]] = {}
    wanted = set(trace_ids) if trace_ids is not None else None
    for ev in merged.get("traceEvents", []):
        if ev.get("ph") not in ("X", "i"):
            continue
        args = ev.get("args") or {}
        tids = set()
        tid = args.get("trace")
        if tid:
            tids.add(tid)
        for t in args.get("trace_ids") or []:
            tids.add(t)
        for t in tids:
            if wanted is not None and t not in wanted:
                continue
            chains.setdefault(t, []).append(
                {
                    "ts_ms": round(float(ev.get("ts", 0.0)) / 1e3, 3),
                    "name": str(ev.get("name")),
                    "pid": ev.get("pid"),
                    "replica": args.get("replica"),
                }
            )
    for chain in chains.values():
        chain.sort(key=lambda e: e["ts_ms"])
    return chains


def check_failover_chain(chain: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Is this the full failover story?  True when the (time-ordered)
    chain shows serving activity on one process, then the death, then the
    requeue, then a completion on a DIFFERENT process — the acceptance
    shape: admit → ... → ``replica_died`` → ``request_requeued`` →
    completion on the survivor, one trace id throughout."""
    names = [e["name"] for e in chain]
    died_i = names.index("fleet/replica_died") if "fleet/replica_died" in names else -1
    requeued_i = next(
        (
            i
            for i, n in enumerate(names)
            if n == "fleet/request_requeued" and i > died_i
        ),
        -1,
    )
    completes = [
        i for i, n in enumerate(names) if n == "serve/request_complete"
    ]
    served_before_death = (
        [
            e for e in chain[:died_i]
            if e["name"].startswith("serve/")
        ]
        if died_i >= 0
        else []
    )
    dead_pids = {e["pid"] for e in served_before_death}
    complete_i = completes[-1] if completes else -1
    completed_on = chain[complete_i]["pid"] if complete_i >= 0 else None
    ok = (
        died_i >= 0
        and requeued_i > died_i
        and complete_i > requeued_i
        and bool(served_before_death)
        and completed_on is not None
        and completed_on not in dead_pids
    )
    return {
        "ok": ok,
        "events": len(chain),
        "served_on_pid_before_death": sorted(dead_pids),
        "completed_on_pid": completed_on,
        "chain": list(chain),
    }


# -- merged metrics + SLO --------------------------------------------------


def fleet_latency(merged_registry: MetricsRegistry) -> Dict[str, Any]:
    """The fleet-level TTFT/TPOT percentile blocks, read from the
    bucket-merged histograms (never from averaged per-replica
    percentiles — a replica with 10x the traffic must weigh 10x)."""
    ttft = merged_registry.histogram(TTFT_HISTOGRAM)
    tpot = merged_registry.histogram(TPOT_HISTOGRAM)
    return {
        "ttft_s": ttft.summary(),
        "tpot_s": tpot.summary(),
        "ttft_samples": ttft.count,
        "tpot_samples": tpot.count,
    }


def fleet_latency_per_class(
    merged_registry: MetricsRegistry,
) -> Dict[str, Dict[str, Any]]:
    """Per-priority-class TTFT/TPOT blocks from the bucket-merged
    ``serve.ttft_s.<class>`` / ``serve.tpot_s.<class>`` histograms —
    the same never-average-percentiles rule as :func:`fleet_latency`,
    split by SLO class.  Classes are discovered from the metric names
    (a class no worker ever served simply isn't here)."""
    out: Dict[str, Dict[str, Any]] = {}
    ttft_prefix = TTFT_HISTOGRAM + "."
    tpot_prefix = TPOT_HISTOGRAM + "."
    for name, hist in merged_registry._histograms.items():
        if name.startswith(ttft_prefix):
            blk = out.setdefault(name[len(ttft_prefix):], {})
            blk["ttft_s"] = hist.summary()
            blk["ttft_samples"] = hist.count
        elif name.startswith(tpot_prefix):
            blk = out.setdefault(name[len(tpot_prefix):], {})
            blk["tpot_s"] = hist.summary()
            blk["tpot_samples"] = hist.count
    for blk in out.values():
        blk.setdefault("ttft_s", {})
        blk.setdefault("ttft_samples", 0)
        blk.setdefault("tpot_s", {})
        blk.setdefault("tpot_samples", 0)
    return out


@dataclasses.dataclass
class SLOSpec:
    """Declarative service-level objectives over the merged fleet view.

    ``None`` disables a latency criterion; error-rate and lost-request
    bounds always evaluate (the fleet exists to keep them at zero).
    Text form::

        ttft_p99_s=2.0,tpot_p99_s=0.5,max_error_rate=0,max_lost_requests=0
    """

    ttft_p99_s: Optional[float] = None
    tpot_p99_s: Optional[float] = None
    max_error_rate: float = 0.0
    max_lost_requests: int = 0

    @classmethod
    def parse(cls, text: str) -> "SLOSpec":
        kwargs: Dict[str, Any] = {}
        fields = {f.name for f in dataclasses.fields(cls)}
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"SLO entry {part!r} is not key=value")
            key, value = part.split("=", 1)
            key = key.strip()
            if key not in fields:
                raise ValueError(
                    f"unknown SLO key {key!r}; known: {sorted(fields)}"
                )
            kwargs[key] = (
                int(value) if key == "max_lost_requests" else float(value)
            )
        return cls(**kwargs)

    def describe(self) -> str:
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                parts.append(f"{f.name}={v}")
        return ",".join(parts)

    def evaluate(
        self,
        *,
        fleet_report: Dict[str, Any],
        latency: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Per-criterion ``{limit, actual, ok}`` plus the overall
        ``pass`` boolean."""
        criteria: Dict[str, Dict[str, Any]] = {}

        def add(name: str, limit, actual, ok: bool) -> None:
            criteria[name] = {
                "limit": limit,
                "actual": actual,
                "ok": bool(ok),
            }

        if self.ttft_p99_s is not None:
            actual = latency.get("ttft_s", {}).get("p99")
            add(
                "ttft_p99_s", self.ttft_p99_s, actual,
                actual is not None
                and latency.get("ttft_samples", 0) > 0
                and actual <= self.ttft_p99_s,
            )
        if self.tpot_p99_s is not None:
            actual = latency.get("tpot_s", {}).get("p99")
            add(
                "tpot_p99_s", self.tpot_p99_s, actual,
                actual is not None
                and latency.get("tpot_samples", 0) > 0
                and actual <= self.tpot_p99_s,
            )
        requests = int(fleet_report.get("requests", 0)) or 0
        errors = int(fleet_report.get("errors", 0))
        rate = errors / requests if requests else 0.0
        add(
            "max_error_rate", self.max_error_rate, round(rate, 6),
            rate <= self.max_error_rate,
        )
        lost = int(fleet_report.get("lost_requests", 0))
        add(
            "max_lost_requests", self.max_lost_requests, lost,
            lost <= self.max_lost_requests,
        )
        return {
            "spec": self.describe(),
            "criteria": criteria,
            "pass": all(c["ok"] for c in criteria.values()),
        }


def parse_class_slos(entries: Sequence[str]) -> Dict[str, "SLOSpec"]:
    """Parse repeated ``<class>:<key=value,...>`` entries into a class ->
    :class:`SLOSpec` map.  Raises on a missing class prefix or a duplicate
    class, before any engine builds."""
    out: Dict[str, SLOSpec] = {}
    for entry in entries or []:
        cls, sep, spec_text = entry.partition(":")
        cls = cls.strip()
        if not sep or not cls or any(c.isspace() for c in cls):
            raise ValueError(
                f"per-tenant SLO {entry!r} is not <class>:<key=value,...>"
            )
        if cls in out:
            raise ValueError(f"duplicate per-tenant SLO for class {cls!r}")
        out[cls] = SLOSpec.parse(spec_text)
    return out


def evaluate_class_slos(
    class_slos: Dict[str, "SLOSpec"],
    *,
    fleet_report: Dict[str, Any],
    per_class_latency: Dict[str, Any],
) -> Dict[str, Any]:
    """Evaluate each class's spec against THAT class's bucket-merged
    latency and its slice of the fleet report's ``per_class`` block.
    ``lost_requests`` is fleet-global and charged to every evaluated
    class — a lost request is an SLO violation no matter whose it was.
    A class with an SLO but zero recorded samples FAILS its latency
    criteria (an SLO that cannot be demonstrated is not met)."""
    per: Dict[str, Any] = {}
    report_classes = fleet_report.get("per_class", {}) or {}
    empty = {
        "ttft_s": {}, "tpot_s": {}, "ttft_samples": 0, "tpot_samples": 0,
    }
    for cls, spec in sorted(class_slos.items()):
        blk = report_classes.get(cls, {})
        per[cls] = spec.evaluate(
            fleet_report={
                "requests": blk.get("requests", 0),
                "errors": blk.get("errors", 0),
                "lost_requests": fleet_report.get("lost_requests", 0),
            },
            latency=per_class_latency.get(cls, empty),
        )
    return {
        "per_class": per,
        "pass": all(r["pass"] for r in per.values()),
    }


def summarize_timeline(merged: Dict[str, Any], *, limit: int = 120) -> Dict[str, Any]:
    """Artifact-sized digest of a merged timeline: event counts, total
    duration per host span name, the instant events and the ``limit``
    longest events in time order (the reference's
    ``obs.profile.summarize_timeline``; the port has no device lanes in
    these traces, so every span is a host span)."""
    events = merged.get("traceEvents", [])
    host_pids = set(merged.get("metadata", {}).get("host_pids") or [1])
    host = [e for e in events if e.get("ph") == "X" and e.get("pid") in host_pids]
    device = [e for e in events
              if e.get("ph") == "X" and e.get("pid") not in host_pids]
    instants = [e for e in events if e.get("ph") == "i"]
    by_name_ms: Dict[str, float] = {}
    for e in host:
        name = str(e.get("name"))
        by_name_ms[name] = by_name_ms.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e3
    top = sorted(host + device, key=lambda e: -float(e.get("dur", 0.0)))[:limit]
    top.sort(key=lambda e: float(e.get("ts", 0.0)))
    return {
        "event_counts": {"host_spans": len(host), "device_events": len(device),
                         "instant_events": len(instants)},
        "host_span_total_ms": {
            name: round(ms, 3)
            for name, ms in sorted(by_name_ms.items(), key=lambda kv: -kv[1])
        },
        "instant_events": [
            {"name": str(e.get("name")),
             "ts_ms": round(float(e.get("ts", 0.0)) / 1e3, 3),
             "args": e.get("args", {})}
            for e in instants[:limit]
        ],
        "events": [
            {"name": str(e.get("name"))[:80],
             "source": "host" if e.get("pid") in host_pids else "device",
             "ts_ms": round(float(e.get("ts", 0.0)) / 1e3, 3),
             "dur_ms": round(float(e.get("dur", 0.0)) / 1e3, 3)}
            for e in top
        ],
    }


# -- the shared choreography ----------------------------------------------


def observe_fleet(
    spec,
    requests,
    *,
    replicas: int = 2,
    trace_dir: str,
    faults: Optional[str] = None,
    slo: Optional[SLOSpec] = None,
    class_slos: Optional[Dict[str, SLOSpec]] = None,
    **router_kw: Any,
) -> Dict[str, Any]:
    """Run a fleet with distributed tracing on and assemble the merged
    view: one implementation, so no two callers frame the run
    differently.  ``router_kw`` (``max_restarts``, ``max_redeliveries``,
    ``heartbeat_timeout_s``) go to the ``FleetRouter``, whose defaults are
    the fleet's one policy.

    Returns a dict with: ``results``/``fleet_report`` (router truth),
    ``merged_trace_path`` (``<trace_dir>/fleet.trace.json``),
    ``failover`` (per-trace-id chain checks for every requeued request),
    ``fleet_latency`` (bucket-merged TTFT/TPOT), ``per_replica_metrics``
    (the raw shipped states, for exact recomputation), ``slo`` (the
    evaluated spec) and ``flight_recorder_dumps``.
    """
    from distributeddeeplearning_tpu_torch.obs import trace as trace_mod
    from distributeddeeplearning_tpu_torch.serve.fleet import FleetRouter

    os.makedirs(trace_dir, exist_ok=True)
    # a REUSED trace dir still holds the previous run's shards — and trace ids restart at
    # tr0000 every run, so merging stale shards would stitch two
    # unrelated runs into the same chains.  This run's shards only.
    for stale in glob.glob(os.path.join(trace_dir, "replica*.trace.json")):
        os.remove(stale)
    spec = dataclasses.replace(spec, trace_dir=trace_dir)
    prior = trace_mod.get_tracer()
    tracer = trace_mod.set_tracer(
        trace_mod.Tracer(
            enabled=True, annotate=False, process_name="router",
            recorder=trace_mod.PROCESS_RECORDER,
        )
    )
    try:
        router = FleetRouter(spec, replicas=replicas, faults=faults,
                             **router_kw)
        try:
            results, report = router.serve(requests)
        finally:
            router.terminate()
    finally:
        trace_mod.set_tracer(prior)

    merged = merge_fleet_trace(
        tracer.to_chrome_trace(),
        load_trace_shards(trace_dir),
        offsets_us=router.clock_offsets_us,
    )
    merged_path = os.path.join(trace_dir, "fleet.trace.json")
    with open(merged_path, "w") as f:
        json.dump(merged, f)
        f.write("\n")

    # failover evidence: one chain per requeued request, checked for the
    # admit -> death -> requeue -> completion-on-survivor shape
    requeued_tids = sorted(
        {
            (ev.get("args") or {}).get("trace")
            for ev in tracer.events
            if ev.get("name") == "fleet/request_requeued"
            and (ev.get("args") or {}).get("trace")
        }
    )
    # no requeues -> no chains to check; skip the full-timeline walk
    chains = (
        failover_chains(merged, requeued_tids) if requeued_tids else {}
    )
    failover = {
        tid: check_failover_chain(chain) for tid, chain in chains.items()
    }

    # the router already merged the shipped states bucket-wise (through
    # fleet_latency above) — read its answer instead of re-merging, so
    # there is exactly ONE computation the artifact can quote
    latency = report.fleet_latency
    slo_result = (
        slo.evaluate(fleet_report=report.to_dict(), latency=latency)
        if slo is not None
        else None
    )
    # per-tenant SLOs: each class's spec against that class's
    # bucket-merged latency split — same single-computation rule, the
    # router's fleet_latency_per_class is the one source
    slo_per_tenant = (
        evaluate_class_slos(
            class_slos,
            fleet_report=report.to_dict(),
            per_class_latency=report.fleet_latency_per_class,
        )
        if class_slos
        else None
    )
    return {
        "results": results,
        "fleet_report": report,
        "merged_trace": merged,
        "merged_trace_path": merged_path,
        "timeline": summarize_timeline(merged),
        "failover": failover,
        "fleet_latency": latency,
        "fleet_latency_per_class": report.fleet_latency_per_class,
        "fleet_metrics": report.fleet_metrics,
        "per_replica_metrics": list(report.replica_metric_states),
        "slo": slo_result,
        "slo_per_tenant": slo_per_tenant,
        "flight_recorder_dumps": report.flight_recorder_dumps,
    }

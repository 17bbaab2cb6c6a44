"""Artifact schema validation: committed ``*_r*.json`` drift fails tier-1.

The port's copy of ``obs/schema.py``, kept letter for letter (every
validator and every message text), so that the two packages give the
same verdict, and the same message, on the same artifact.  It is pure
Python; the port holds its own copy so that it imports nothing of the
JAX package.

Benchmark artifacts are the repo's evidence trail, and they rot silently:
an emit-site refactor drops a key, the README keeps documenting it, and
nobody notices until a comparison script crashes months later.  This
module is the lightweight guard ``tests/test_obs.py`` runs over every
committed revision artifact:

- every ``*_r*.json`` must parse and be a non-empty JSON container;
- any artifact carrying the bench-line contract (a ``metric`` key) must
  carry ``value`` and ``unit`` too;
- any latency percentile block (``ttft_s`` / ``decode_step_s`` /
  ``queue_wait_s`` / ``tpot_s``) must contain numeric ``p50 <= p99`` —
  the keys every consumer of the serving artifacts indexes;
- ``OBS_*`` artifacts additionally validate against the full obs schema
  (merged timeline digest + decode phase breakdown + regression
  attribution), since the whole point of OBS_r11 is that downstream
  work (ROADMAP Open item 2) can script against it;
- ``OBS_FLEET_*`` artifacts (checked before the ``OBS_`` prefix, which
  they also match) validate against the fleet-observability schema:
  merged-timeline digest, a failover chain that is traceable under one
  trace id, bucket-merged fleet percentile blocks with sample counts,
  ATTRIBUTABLE per-replica metric rows (anonymous rows rejected), the
  SLO verdict and the four gate booleans;
- ``SERVE_RESILIENCE_*`` artifacts validate against the serving chaos
  schema (clean/faulted FleetReport pair, gate booleans, fleet timeline
  event digest) — the evidence the fleet's failover story rests on;
- ``SPEC_*`` artifacts validate against the speculative-decoding schema
  (per-drafter acceptance_rate in [0, 1], tokens_per_verify >= 1, the
  bit-identical and decode-speedup gate booleans);
- ``CKPT_DURABLE_*`` artifacts validate against the durable-state schema
  (corrupt-latest resume landing on the exact verified step, a per-
  corruption-mode recovery matrix, the live-reload bit-exactness verdict
  and the verify-overhead budget) — the evidence the checkpoint layer's
  "storage is not trusted" story rests on;
- ``GOODPUT_*`` artifacts validate against the goodput-ledger schema:
  every category present, the category sum covering total wall within
  the residual gate (a payload whose categories don't sum to wall is
  REJECTED — optimistic goodput from lost time is the failure mode),
  goodput fraction in [0, 1], MFU numeric or explicitly omitted with a
  reason, chaos accounting (recovery + redone steps) and the
  trajectory-digest block.

Prefix dispatch is an ORDERED most-specific-first table
(:data:`_PREFIX_VALIDATORS`): the first matching prefix wins, so a name
matching two prefixes (``OBS_FLEET_*`` also matches ``OBS_*``) binds to
its specific schema and every specific kind (``GOODPUT_*`` included) is
matched before the generic ``*_r*.json`` fallback checks are all that
guard it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

__all__ = [
    "SchemaError",
    "validate_artifact",
    "validate_obs_payload",
    "validate_obs_fleet_payload",
    "validate_serve_resilience_payload",
    "validate_spec_payload",
    "validate_ckpt_durable_payload",
    "validate_goodput_payload",
    "validate_attrib_payload",
    "validate_overload_payload",
    "validate_tp_payload",
    "validate_tier_payload",
]

#: latency blocks whose percentile keys are a cross-artifact contract
#: (an EMPTY dict under these names means "no samples" — e.g. the spec
#: blocks of a non-speculative run — and is skipped, not rejected)
PERCENTILE_BLOCKS = (
    "ttft_s", "decode_step_s", "queue_wait_s", "tpot_s",
    "draft_step_s", "verify_step_s",
)


class SchemaError(ValueError):
    """An artifact violates the documented schema."""


def _check_percentile_blocks(node: Any, path: str, errors: List[str]) -> None:
    if isinstance(node, dict):
        for key, value in node.items():
            where = f"{path}.{key}" if path else str(key)
            if key in PERCENTILE_BLOCKS and isinstance(value, dict) and value:
                for pk in ("p50", "p99"):
                    if not isinstance(value.get(pk), (int, float)):
                        errors.append(
                            f"{where}: missing/non-numeric {pk!r}"
                        )
                if (
                    isinstance(value.get("p50"), (int, float))
                    and isinstance(value.get("p99"), (int, float))
                    and value["p99"] < value["p50"] - 1e-9
                ):
                    errors.append(f"{where}: p99 < p50")
            _check_percentile_blocks(value, where, errors)
    elif isinstance(node, list):
        for i, item in enumerate(node):
            _check_percentile_blocks(item, f"{path}[{i}]", errors)


def validate_obs_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``OBS_r{NN}.json`` artifact body."""
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "timeline", "decode_breakdown",
                "regression_attribution"):
        require(key in payload, f"missing top-level key {key!r}")

    timeline = payload.get("timeline")
    if isinstance(timeline, dict):
        require(
            isinstance(timeline.get("events"), list)
            and len(timeline["events"]) > 0,
            "timeline.events must be a non-empty list",
        )
        counts = timeline.get("event_counts")
        require(
            isinstance(counts, dict)
            and isinstance(counts.get("host_spans"), int)
            and counts["host_spans"] > 0,
            "timeline.event_counts.host_spans must be a positive int "
            "(the merge lost the host half)",
        )
        for ev in (timeline.get("events") or [])[:5]:
            require(
                isinstance(ev, dict)
                and isinstance(ev.get("name"), str)
                and ev.get("source") in ("host", "device")
                and isinstance(ev.get("ts_ms"), (int, float))
                and isinstance(ev.get("dur_ms"), (int, float)),
                f"malformed timeline event {ev!r}",
            )
    else:
        require(False, "timeline must be a dict")

    breakdown = payload.get("decode_breakdown")
    if isinstance(breakdown, dict):
        require(
            len(breakdown) >= 2,
            "decode_breakdown needs at least two engine configs "
            "(the f32-vs-int8 comparison)",
        )
        for name, bd in breakdown.items():
            require(
                isinstance(bd, dict)
                and isinstance(bd.get("decode_step_ms"), (int, float))
                and isinstance(bd.get("phases_ms"), dict)
                and len(bd["phases_ms"]) >= 2,
                f"decode_breakdown[{name!r}] missing decode_step_ms/"
                "phases_ms",
            )
    else:
        require(False, "decode_breakdown must be a dict")

    attribution = payload.get("regression_attribution")
    if isinstance(attribution, dict):
        require(
            isinstance(attribution.get("hottest_phase"), str),
            "regression_attribution.hottest_phase must name a phase",
        )
        require(
            isinstance(
                attribution.get("hottest_phase_share_of_step_time"),
                (int, float),
            ),
            "regression_attribution.hottest_phase_share_of_step_time "
            "must be numeric",
        )
    else:
        require(False, "regression_attribution must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_obs_fleet_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``OBS_FLEET_r{NN}.json`` artifact body.

    The fleet-observability evidence trail: a chaos run where the
    injected failover is traceable under one trace id in the MERGED
    timeline, fleet percentiles are bucket-merged (with the exactness
    check recorded), every per-replica metrics row carries process
    identity (anonymous fleet rows rejected HERE), and the SLO layer's
    pass/fail booleans travel with the numbers they gate.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "faults_spec", "replicas", "timeline",
                "failover", "fleet_latency", "per_replica_metrics",
                "slo", "gates", "fleet_report"):
        require(key in payload, f"missing top-level key {key!r}")

    timeline = payload.get("timeline")
    if isinstance(timeline, dict):
        counts = timeline.get("event_counts")
        require(
            isinstance(counts, dict)
            and isinstance(counts.get("host_spans"), int)
            and counts["host_spans"] > 0,
            "timeline.event_counts.host_spans must be a positive int "
            "(the shard merge lost the worker spans)",
        )
    else:
        require(False, "timeline must be a dict")

    failover = payload.get("failover")
    if isinstance(failover, dict) and failover:
        for tid, chain in failover.items():
            require(
                isinstance(chain, dict)
                and isinstance(chain.get("ok"), bool)
                and isinstance(chain.get("chain"), list)
                and len(chain["chain"]) > 0,
                f"failover[{tid!r}] must carry ok + a non-empty chain",
            )
        require(
            any(
                isinstance(c, dict) and c.get("ok") is True
                for c in failover.values()
            ),
            "no failover chain shows the full admit -> death -> requeue "
            "-> survivor-completion shape",
        )
    else:
        require(False, "failover must be a non-empty dict (one entry per "
                       "requeued trace id)")

    latency = payload.get("fleet_latency")
    if isinstance(latency, dict):
        require(
            isinstance(latency.get("ttft_samples"), int)
            and latency["ttft_samples"] > 0,
            "fleet_latency.ttft_samples must be a positive int (no "
            "merged TTFT buckets means the metric shipping broke)",
        )
        for block in ("ttft_s", "tpot_s"):
            require(
                isinstance(latency.get(block), dict)
                and isinstance(latency[block].get("p99"), (int, float)),
                f"fleet_latency.{block} must be a percentile block",
            )
    else:
        require(False, "fleet_latency must be a dict")

    per_replica = payload.get("per_replica_metrics")
    if isinstance(per_replica, list) and per_replica:
        for i, row in enumerate(per_replica):
            require(
                isinstance(row, dict)
                and isinstance(row.get("pid"), int)
                and isinstance(row.get("replica_id"), int),
                f"per_replica_metrics[{i}] is ANONYMOUS — fleet metric "
                "rows must carry pid and replica_id",
            )
    else:
        require(False, "per_replica_metrics must be a non-empty list")

    slo = payload.get("slo")
    if isinstance(slo, dict):
        require(
            isinstance(slo.get("pass"), bool),
            "slo.pass must be a bool",
        )
        criteria = slo.get("criteria")
        if isinstance(criteria, dict) and criteria:
            for name, c in criteria.items():
                require(
                    isinstance(c, dict) and isinstance(c.get("ok"), bool),
                    f"slo.criteria[{name!r}].ok must be a bool",
                )
        else:
            require(False, "slo.criteria must be a non-empty dict")
    else:
        require(False, "slo must be a dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("failover_traceable", "percentiles_merge_exact",
                   "zero_lost_requests", "slo_pass"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    rep = payload.get("fleet_report")
    if isinstance(rep, dict):
        for key in ("replicas", "requests", "replica_deaths", "restarts",
                    "redeliveries", "lost_requests", "finish_reasons",
                    "trace_ids", "fleet_latency"):
            require(key in rep, f"fleet_report missing key {key!r}")
        require(
            isinstance(rep.get("replica_deaths"), int)
            and rep.get("replica_deaths", 0) > 0,
            "an OBS_FLEET artifact must come from a chaos run (no "
            "replica death means no failover to trace)",
        )
    else:
        require(False, "fleet_report must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_serve_resilience_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``SERVE_RESILIENCE_r{NN}.json`` artifact body.

    The chaos bench's evidence trail: a fleet-with-faults run compared
    against the fault-free baseline.  Downstream consumers (README
    tables, regression scripts) index the gate booleans and the
    clean/faulted report pair, so their shape is a contract.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "faults_spec", "replicas",
                "recovery_overhead_pct", "tokens_bit_identical",
                "fleet_events", "gates", "clean", "faulted"):
        require(key in payload, f"missing top-level key {key!r}")

    require(
        isinstance(payload.get("recovery_overhead_pct"), (int, float)),
        "recovery_overhead_pct must be numeric",
    )
    require(
        isinstance(payload.get("tokens_bit_identical"), bool),
        "tokens_bit_identical must be a bool",
    )
    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("zero_lost_requests", "tokens_bit_identical",
                   "only_poisoned_failed",
                   "recovery_overhead_under_limit"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")
    for side in ("clean", "faulted"):
        rep = payload.get(side)
        if not isinstance(rep, dict):
            require(False, f"{side} must be a FleetReport dict")
            continue
        for key in ("replicas", "requests", "wall_s",
                    "goodput_tokens_per_sec", "finish_reasons",
                    "ttft_s", "tpot_s", "restarts", "replica_deaths",
                    "redeliveries", "lost_requests", "drained"):
            require(key in rep, f"{side} missing key {key!r}")
        require(
            isinstance(rep.get("finish_reasons"), dict),
            f"{side}.finish_reasons must be a dict",
        )
        for key in ("lost_requests", "redeliveries", "restarts",
                    "replica_deaths"):
            require(
                isinstance(rep.get(key), int),
                f"{side}.{key} must be an int",
            )
    faulted = payload.get("faulted")
    if isinstance(faulted, dict):
        require(
            isinstance(payload.get("fleet_events"), dict)
            and (
                faulted.get("replica_deaths", 0) == 0
                or "fleet/replica_died" in payload["fleet_events"]
            ),
            "a faulted run with replica deaths must carry the "
            "fleet/replica_died timeline event",
        )

    if errors:
        raise SchemaError("; ".join(errors))


def validate_spec_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``SPEC_r{NN}.json`` artifact body.

    Speculative decoding's evidence trail: every drafter must report a
    sane acceptance rate (in [0, 1]), an amortization factor of at least
    one token per verify (each verify commits >= 1 token by
    construction — anything lower means the accounting broke), its
    bit-identical verdict, and the artifact must carry both gate
    booleans (bit-identical output AND the decode-phase tok/s win).
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "draft_tokens", "baseline", "drafters",
                "gates"):
        require(key in payload, f"missing top-level key {key!r}")

    baseline = payload.get("baseline")
    if isinstance(baseline, dict):
        require(
            isinstance(
                baseline.get("decode_tokens_per_sec"), (int, float)
            ),
            "baseline.decode_tokens_per_sec must be numeric",
        )
    else:
        require(False, "baseline must be a dict")

    drafters = payload.get("drafters")
    if isinstance(drafters, dict) and drafters:
        for name, d in drafters.items():
            if not isinstance(d, dict):
                require(False, f"drafters[{name!r}] must be a dict")
                continue
            acc = d.get("acceptance_rate")
            require(
                isinstance(acc, (int, float)) and 0.0 <= acc <= 1.0,
                f"drafters[{name!r}].acceptance_rate must be in [0, 1]",
            )
            tpv = d.get("tokens_per_verify")
            require(
                isinstance(tpv, (int, float)) and tpv >= 1.0,
                f"drafters[{name!r}].tokens_per_verify must be >= 1 "
                "(every verify step commits at least the bonus token)",
            )
            require(
                isinstance(d.get("bit_identical"), bool),
                f"drafters[{name!r}].bit_identical must be a bool",
            )
            require(
                isinstance(
                    d.get("decode_tokens_per_sec"), (int, float)
                ),
                f"drafters[{name!r}].decode_tokens_per_sec must be "
                "numeric",
            )
    else:
        require(False, "drafters must be a non-empty dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("bit_identical", "spec_decode_speedup"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_ckpt_durable_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``CKPT_DURABLE_r{NN}.json`` artifact body.

    Durable state's evidence trail: with a corrupt latest generation
    injected, training resumed from the newest VERIFIED generation at the
    exact step (no brick), every corruption mode recovered, post-reload
    fleet tokens are bit-identical to a fresh engine from the same
    checkpoint, and manifest verification stayed inside its overhead
    budget.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "faults_spec", "resume", "corrupt_modes",
                "reload", "verify_overhead", "gates"):
        require(key in payload, f"missing top-level key {key!r}")

    resume = payload.get("resume")
    if isinstance(resume, dict):
        require(
            isinstance(resume.get("exact"), bool),
            "resume.exact must be a bool",
        )
        for key in ("expected_step", "resumed_step"):
            require(
                isinstance(resume.get(key), int),
                f"resume.{key} must be an int",
            )
        require(
            isinstance(resume.get("verify_failures_observed"), int)
            and resume.get("verify_failures_observed", 0) > 0,
            "resume.verify_failures_observed must be a positive int (a "
            "CKPT_DURABLE artifact must come from a chaos run — no "
            "verification failure means no fallback was exercised)",
        )
    else:
        require(False, "resume must be a dict")

    modes = payload.get("corrupt_modes")
    if isinstance(modes, dict) and modes:
        for name, m in modes.items():
            require(
                isinstance(m, dict) and isinstance(m.get("recovered"), bool),
                f"corrupt_modes[{name!r}].recovered must be a bool",
            )
    else:
        require(False, "corrupt_modes must be a non-empty dict (one entry "
                       "per injected corruption mode)")

    reload_block = payload.get("reload")
    if isinstance(reload_block, dict):
        require(
            isinstance(reload_block.get("bit_identical"), bool),
            "reload.bit_identical must be a bool",
        )
        require(
            isinstance(reload_block.get("acks"), int)
            and isinstance(reload_block.get("replicas"), int),
            "reload.acks / reload.replicas must be ints",
        )
    else:
        require(False, "reload must be a dict")

    overhead = payload.get("verify_overhead")
    if isinstance(overhead, dict):
        for key in ("save_wall_s", "verify_wall_s", "pct", "limit_pct"):
            require(
                isinstance(overhead.get(key), (int, float)),
                f"verify_overhead.{key} must be numeric",
            )
    else:
        require(False, "verify_overhead must be a dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("resume_exact", "zero_bricked",
                   "corrupt_modes_recovered", "reload_bit_identical",
                   "verify_overhead_under_limit", "fallback_observable"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_goodput_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``GOODPUT_r{NN}.json`` artifact body.

    The goodput ledger's evidence trail: 100% of a chaos training run's
    wall classified into the named categories, the category sum covering
    total wall within the residual gate (THE rejection: a ledger that
    lost time would otherwise report optimistic goodput), goodput
    fraction and (on TPU) MFU, the supervisor-matched redone/recovery
    accounting, and the perf-trajectory digest over committed artifacts.
    """
    from distributeddeeplearning_tpu_torch.obs.goodput import CATEGORIES

    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "faults_spec", "supervisor", "ledger",
                "trajectory", "gates"):
        require(key in payload, f"missing top-level key {key!r}")

    ledger = payload.get("ledger")
    if isinstance(ledger, dict):
        total = ledger.get("total_wall_s")
        require(
            isinstance(total, (int, float)) and total > 0,
            "ledger.total_wall_s must be positive",
        )
        seconds = ledger.get("seconds")
        if isinstance(seconds, dict):
            for cat in CATEGORIES:
                require(
                    isinstance(seconds.get(cat), (int, float))
                    and seconds.get(cat, -1.0) >= 0.0,
                    f"ledger.seconds.{cat} must be a non-negative number "
                    "(every category is always present — absence means "
                    "the emit site dropped one)",
                )
            limit = ledger.get("residual_limit_pct")
            require(
                isinstance(limit, (int, float)) and limit > 0,
                "ledger.residual_limit_pct must be positive",
            )
            if (
                isinstance(total, (int, float)) and total > 0
                and isinstance(limit, (int, float))
                and all(
                    isinstance(seconds.get(c), (int, float))
                    for c in CATEGORIES
                )
            ):
                accounted = sum(float(seconds[c]) for c in CATEGORIES)
                residual_pct = abs(total - accounted) / total * 100.0
                require(
                    residual_pct <= float(limit) + 1e-6,
                    f"ledger categories sum to {round(accounted, 4)}s but "
                    f"total wall is {round(total, 4)}s — "
                    f"{round(residual_pct, 2)}% unaccounted exceeds the "
                    f"{limit}% residual gate (the ledger lost time)",
                )
        else:
            require(False, "ledger.seconds must be a dict")
        gf = ledger.get("goodput_fraction")
        require(
            isinstance(gf, (int, float)) and 0.0 <= gf <= 1.0,
            "ledger.goodput_fraction must be in [0, 1]",
        )
        mfu = ledger.get("mfu")
        require(
            isinstance(mfu, (int, float)) or (
                mfu is None
                and isinstance(ledger.get("mfu_omitted_reason"), str)
            ),
            "ledger.mfu must be numeric, or null WITH mfu_omitted_reason "
            "(off-TPU runs omit MFU explicitly, never silently)",
        )
        counts = ledger.get("counts")
        require(
            isinstance(counts, dict)
            and isinstance(counts.get("steps"), int)
            and isinstance(counts.get("steps_redone"), int)
            and isinstance(counts.get("segments"), int),
            "ledger.counts must carry steps / steps_redone / segments ints",
        )
    else:
        require(False, "ledger must be a dict")

    supervisor = payload.get("supervisor")
    if isinstance(supervisor, dict):
        for key in ("restarts", "redone_steps"):
            require(
                isinstance(supervisor.get(key), int),
                f"supervisor.{key} must be an int",
            )
    else:
        require(False, "supervisor must be a dict (the restart "
                       "supervisor's own accounting, matched by the gate)")

    trajectory = payload.get("trajectory")
    if isinstance(trajectory, dict):
        require(
            isinstance(trajectory.get("green"), bool)
            and isinstance(trajectory.get("tracked_series"), int),
            "trajectory must carry green (bool) + tracked_series (int)",
        )
    else:
        require(False, "trajectory must be a dict (the perf-history "
                       "digest over committed artifacts)")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("residual_under_limit", "redone_matches_supervisor",
                   "recovery_observed", "completed_exact",
                   "trajectory_green"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_attrib_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``ATTRIB_r{NN}.json`` artifact body.

    The attribution layer's evidence trail: every tracked compiled
    program resolves XLA cost-model flops/bytes on the artifact's
    backend, the HBM ledger's owner totals reconcile against the
    process's ACTUAL live device bytes (the residual past the limit is
    REJECTED here — unowned HBM reading as accounted-for is the failure
    mode), and the gate verdicts travel with the numbers they judge.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "programs", "programs_covered",
                "unaccounted_hbm_pct", "ledger", "straggler", "gates"):
        require(key in payload, f"missing top-level key {key!r}")

    programs = payload.get("programs")
    if isinstance(programs, dict) and programs:
        for name, row in programs.items():
            require(
                isinstance(row, dict)
                and isinstance(row.get("flops"), (int, float))
                and isinstance(row.get("bytes_accessed"), (int, float)),
                f"programs[{name!r}] must carry numeric flops + "
                "bytes_accessed (the cost_analysis contract)",
            )
    else:
        require(False, "programs must be a non-empty dict (one row per "
                       "tracked compiled program)")

    ledger = payload.get("ledger")
    if isinstance(ledger, dict):
        owners = ledger.get("owners")
        require(
            isinstance(owners, dict) and len(owners) >= 2,
            "ledger.owners must hold at least two semantic owners "
            "(params + a KV pool — one bucket is not attribution)",
        )
        if isinstance(owners, dict):
            for owner, row in owners.items():
                require(
                    isinstance(row, dict)
                    and isinstance(row.get("bytes"), int)
                    and isinstance(row.get("committed_bytes"), int)
                    and isinstance(row.get("peak_bytes"), int),
                    f"ledger.owners[{owner!r}] must carry bytes/"
                    "committed_bytes/peak_bytes ints",
                )
        live = ledger.get("live_bytes")
        require(
            isinstance(live, int) and live > 0,
            "ledger.live_bytes must be a positive int (the reconcile "
            "ran against a real process)",
        )
        limit = ledger.get("residual_limit_pct")
        require(
            isinstance(limit, (int, float)) and limit > 0,
            "ledger.residual_limit_pct must be positive",
        )
        pct = payload.get("unaccounted_hbm_pct")
        if isinstance(pct, (int, float)) and isinstance(
            limit, (int, float)
        ):
            require(
                pct <= float(limit) + 1e-9,
                f"unaccounted_hbm_pct {pct} exceeds the {limit}% "
                "residual gate — HBM nobody owns must fail the "
                "artifact, not ride in it",
            )
        else:
            require(False, "unaccounted_hbm_pct must be numeric")
    else:
        require(False, "ledger must be a dict")

    straggler = payload.get("straggler")
    if isinstance(straggler, dict):
        require(
            isinstance(straggler.get("phases"), dict),
            "straggler.phases must be a dict (per-phase per-host rows)",
        )
        require(
            straggler.get("negative_spans") == 0,
            "straggler.negative_spans must be 0 (clock skew may never "
            "manufacture negative durations)",
        )
    else:
        require(False, "straggler must be a dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("programs_covered", "owner_totals_match_live",
                   "residual_under_limit", "forecast_backpressure",
                   "trajectory_green"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_overload_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``OVERLOAD_r{NN}.json`` artifact body.

    The overload-survival evidence trail: a fleet driven past capacity by
    a best-effort burst while premium traffic rides through.  The four
    gate booleans are the contract — premium tail isolated, preempted
    streams bit-identical after resume, zero lost requests, shedding
    confined to the best-effort class — and the tracked tail latencies
    live as FLAT top-level leaves (``premium_ttft_p99_s`` etc.) because
    the history tracker extracts by leaf key through dicts only.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "faults_spec", "replicas",
                "premium_ttft_p99_s", "premium_tpot_p99_s",
                "best_effort_ttft_p99_s", "shed_count", "preemptions",
                "shed_by_class", "per_class", "gates", "fleet_report"):
        require(key in payload, f"missing top-level key {key!r}")

    # best_effort_ttft_p99_s may be null (a burst shed to extinction has
    # no completed best-effort sample) — the PREMIUM leaves never may,
    # they are the tracked isolation headline
    for key in ("premium_ttft_p99_s", "premium_tpot_p99_s"):
        require(
            isinstance(payload.get(key), (int, float)),
            f"{key} must be numeric (the tracked tail latencies are "
            "flat top-level leaves by contract)",
        )
    for key in ("shed_count", "preemptions"):
        require(
            isinstance(payload.get(key), int)
            and payload.get(key, -1) >= 0,
            f"{key} must be a non-negative int",
        )

    shed_by_class = payload.get("shed_by_class")
    if isinstance(shed_by_class, dict) and shed_by_class:
        non_be = {
            cls: n for cls, n in shed_by_class.items()
            if cls != "best_effort" and isinstance(n, int) and n > 0
        }
        require(
            not non_be,
            "shed_by_class shows sheds OUTSIDE best_effort "
            f"({sorted(non_be)}) — shedding must stay in the lowest "
            "class",
        )
    else:
        require(False, "shed_by_class must be a non-empty dict "
                       "(class -> shed count, zeros included)")

    per_class = payload.get("per_class")
    if isinstance(per_class, dict):
        for cls in ("premium", "best_effort"):
            blk = per_class.get(cls)
            require(
                isinstance(blk, dict)
                and isinstance(blk.get("requests"), int),
                f"per_class[{cls!r}] must carry a request count (an "
                "overload run without both classes proves nothing "
                "about isolation)",
            )
    else:
        require(False, "per_class must be a dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("premium_isolated", "preempted_resume_bit_identical",
                   "zero_lost_requests", "shed_only_best_effort"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    rep = payload.get("fleet_report")
    if isinstance(rep, dict):
        for key in ("replicas", "requests", "lost_requests",
                    "finish_reasons", "per_class",
                    "fleet_latency_per_class"):
            require(key in rep, f"fleet_report missing key {key!r}")
        require(
            isinstance(rep.get("lost_requests"), int),
            "fleet_report.lost_requests must be an int",
        )
    else:
        require(False, "fleet_report must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_tp_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``TP_r{NN}.json`` artifact body.

    Tensor-parallel serving's evidence trail: the artifact must carry
    the TP degree (>= 2 — a TP artifact at TP=1 measured nothing), the
    layout-rule provenance string that resolved every sharding in the
    run, all three gate booleans (bit-identical greedy tokens,
    per-chip param HBM ~ 1/TP, decode roofline strictly below TP=1),
    the ledger-attributed per-chip byte ratio, and per-config roofline
    latencies — the leaves ``ddlt obs history --gate`` tracks across
    revisions.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "tp", "layout_rules", "dims", "configs",
                "param_bytes_per_chip", "bit_identical", "gates"):
        require(key in payload, f"missing top-level key {key!r}")

    tp = payload.get("tp")
    require(
        isinstance(tp, int) and tp >= 2,
        "tp must be an int >= 2 (a TP artifact at TP=1 measured nothing)",
    )
    require(
        isinstance(payload.get("layout_rules"), str)
        and bool(payload.get("layout_rules")),
        "layout_rules must be the non-empty rule-table provenance string",
    )
    require(
        isinstance(payload.get("tp_param_bytes_per_chip_ratio"),
                   (int, float)),
        "tp_param_bytes_per_chip_ratio must be numeric (the "
        "ledger-attributed per-chip HBM ratio IS the memory evidence)",
    )
    for key in ("tp_decode_roofline_ms_dense_f32",
                "tp_decode_roofline_ms_paged_int8"):
        require(
            isinstance(payload.get(key), (int, float)),
            f"{key} must be numeric (the tracked decode-latency leaf)",
        )

    bit = payload.get("bit_identical")
    if isinstance(bit, dict) and bit:
        for name, verdict in bit.items():
            require(
                isinstance(verdict, bool),
                f"bit_identical[{name!r}] must be a bool",
            )
    else:
        require(False, "bit_identical must be a non-empty dict of "
                       "per-config verdicts")

    configs = payload.get("configs")
    if isinstance(configs, dict) and configs:
        for name, cfg in configs.items():
            if not isinstance(cfg, dict):
                require(False, f"configs[{name!r}] must be a dict")
                continue
            for variant, line in cfg.items():
                if not isinstance(line, dict):
                    require(
                        False,
                        f"configs[{name!r}][{variant!r}] must be a dict",
                    )
                    continue
                require(
                    isinstance(line.get("tp"), int),
                    f"configs[{name!r}][{variant!r}].tp must be an int "
                    "(every serve line carries its TP provenance)",
                )
                require(
                    isinstance(line.get("layout_rules"), str),
                    f"configs[{name!r}][{variant!r}].layout_rules must "
                    "be the rule-table provenance string",
                )
    else:
        require(False, "configs must be a non-empty dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("bit_identical", "param_bytes_per_chip",
                   "decode_roofline_latency"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


def validate_tier_payload(payload: Dict[str, Any]) -> None:
    """Strict schema for the ``TIER_r{NN}.json`` artifact body.

    The host-memory KV page tier's evidence trail (``bench.py --tier``):
    the artifact must carry the host-pool size, the per-config
    bit-identity verdicts (a spilled-then-restored greedy stream MUST
    equal the never-spilled run on both layouts and both cache dtypes —
    anything else means the tier corrupts decodes), the prefix-hit-rate
    pair (tier vs no-tier baseline at the same oversubscription), the
    admitted-tokens-per-computed-HBM-byte ratio, the fits-in-HBM decode
    throughput ratio, and all four gate booleans — the leaves
    ``ddlt obs history --gate`` tracks across revisions.
    """
    errors: List[str] = []

    def require(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    for key in ("metric", "value", "unit", "bench_revision", "platform",
                "virtual_pod", "host_pages", "tier_policy",
                "oversubscription", "dims", "configs", "bit_identical",
                "gates"):
        require(key in payload, f"missing top-level key {key!r}")

    require(
        isinstance(payload.get("host_pages"), int)
        and payload.get("host_pages", 0) >= 1,
        "host_pages must be an int >= 1 (a tier artifact without a host "
        "pool measured nothing)",
    )
    require(
        isinstance(payload.get("oversubscription"), (int, float))
        and payload.get("oversubscription", 0) >= 4,
        "oversubscription must be >= 4 (the spec's session-to-HBM "
        "pressure floor — below it the tier is never exercised)",
    )
    for key in ("tier_prefix_hit_rate", "tier_prefix_hit_rate_no_tier",
                "tier_tokens_per_hbm_byte_ratio",
                "tier_decode_tokens_per_sec_ratio"):
        require(
            isinstance(payload.get(key), (int, float)),
            f"{key} must be numeric (a tracked tier leaf)",
        )

    bit = payload.get("bit_identical")
    if isinstance(bit, dict) and bit:
        for name, verdict in bit.items():
            require(
                isinstance(verdict, bool),
                f"bit_identical[{name!r}] must be a bool",
            )
    else:
        require(False, "bit_identical must be a non-empty dict of "
                       "per-config spill/restore verdicts")

    configs = payload.get("configs")
    if isinstance(configs, dict) and configs:
        for name, cfg in configs.items():
            require(
                isinstance(cfg, dict),
                f"configs[{name!r}] must be a dict",
            )
    else:
        require(False, "configs must be a non-empty dict")

    gates = payload.get("gates")
    if isinstance(gates, dict):
        for gk in ("bit_identical", "prefix_hit_rate",
                   "tokens_per_hbm_byte", "decode_tokens_per_sec"):
            require(
                isinstance(gates.get(gk), bool),
                f"gates.{gk} must be a bool",
            )
    else:
        require(False, "gates must be a dict")

    if errors:
        raise SchemaError("; ".join(errors))


#: Ordered most-specific-first: the FIRST matching prefix wins, so a
#: name matching two prefixes (``OBS_FLEET_*`` also matches ``OBS_*``)
#: binds to its specific schema, and every specific kind — ``GOODPUT_*``
#: included — dispatches here before falling through to nothing but the
#: generic ``*_r*.json`` bench-line/percentile checks.
_PREFIX_VALIDATORS = (
    ("OBS_FLEET_", validate_obs_fleet_payload),
    ("OBS_", validate_obs_payload),
    ("SERVE_RESILIENCE_", validate_serve_resilience_payload),
    ("SPEC_", validate_spec_payload),
    ("CKPT_DURABLE_", validate_ckpt_durable_payload),
    ("GOODPUT_", validate_goodput_payload),
    ("ATTRIB_", validate_attrib_payload),
    ("OVERLOAD_", validate_overload_payload),
    ("TP_", validate_tp_payload),
    ("TIER_", validate_tier_payload),
)


def validate_artifact(path: str) -> Any:
    """Validate one committed artifact file; returns the parsed JSON.

    Raises :class:`SchemaError` with every violation found (not just the
    first) so a drifted artifact reads as one actionable failure.
    """
    try:
        with open(path) as f:
            data = json.load(f)
    except json.JSONDecodeError as exc:
        raise SchemaError(f"{path}: not valid JSON ({exc})") from exc

    if not isinstance(data, (dict, list)) or not data:
        raise SchemaError(f"{path}: empty or non-container artifact")

    errors: List[str] = []
    if isinstance(data, dict) and "metric" in data:
        for key in ("value", "unit"):
            if key not in data:
                errors.append(f"bench line missing {key!r} next to 'metric'")
    _check_percentile_blocks(data, "", errors)

    import os

    base = os.path.basename(path)
    if isinstance(data, dict):
        # ordered dispatch, first match wins (see _PREFIX_VALIDATORS:
        # OBS_FLEET_ before the OBS_ prefix it also matches, and every
        # specific kind before the generic fallback above is all that
        # would check it)
        for prefix, validator in _PREFIX_VALIDATORS:
            if base.startswith(prefix):
                try:
                    validator(data)
                except SchemaError as exc:
                    errors.append(str(exc))
                break

    if errors:
        raise SchemaError(f"{path}: " + "; ".join(errors))
    return data

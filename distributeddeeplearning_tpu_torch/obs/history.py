"""Perf-trajectory tracker: committed bench artifacts read as one timeline.

The port's copy of ``obs/history.py``, kept letter for letter (the
tolerances, the gate, the renderings), validating through the port's
:mod:`.schema`.  It is pure Python; the port holds its own copy so that
it imports nothing of the JAX package.

The repo accumulates ``<KIND>_r{NN}.json`` artifacts with a shared
``BENCH_REVISION`` lineage — 30+ of them by now — and until this module
no tool read them *as a trajectory*: a perf regression between revisions
was invisible unless a human diffed JSON by hand.  This module is the
reader:

- every committed ``*_r*.json`` parses through the
  :mod:`obs.schema` validators first (a drifted artifact fails loudly,
  it is never silently skipped), then numeric leaves are extracted into
  one timeline keyed by ``(artifact kind, metric path)`` with the
  revision number as the x-axis;
- only DICT paths become series: list indices are positional, not
  identities (``rows[5].mfu`` at r04 and r05 are different model
  configs), so gating on them would compare apples to oranges;
- the headline ``metric``/``value`` pair becomes its own series keyed by
  the metric name, so every artifact contributes at least one point;
- ``ddlt obs history`` prints per-series sparkline deltas;
  ``--gate`` fails (rc 1) when any TRACKED metric's newest point
  regresses past its per-metric tolerance (:data:`TOLERANCES`) relative
  to the previous revision — ``bench.py --lint``-style preflight with a
  perf dimension (``make perf-history``).

Adding a tracked metric = adding one :class:`Tolerance` row; the gate
compares adjacent revisions of the same (kind, path) series, so a new
metric starts gating as soon as its second artifact lands.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Tolerance",
    "TOLERANCES",
    "SeriesPoint",
    "Regression",
    "load_points",
    "build_timeline",
    "check_gates",
    "sparkline",
    "render_text",
    "timeline_digest",
    "run_history",
]

_ARTIFACT_RE = re.compile(r"^(?P<kind>.+)_r(?P<rev>\d+)\.json$")

#: sparkline glyph ramp (min → max)
_SPARK = "▁▂▃▄▅▆▇█"


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """Per-metric regression budget.

    ``rel`` is a fraction of the previous value (0.05 = 5%); ``abs`` is
    an absolute delta in the metric's own unit (percentage-point for
    ``*_pct`` metrics).  When both are set the LOOSER bound wins — a
    tiny absolute floor keeps near-zero baselines from gating on noise.
    """

    higher_is_better: bool
    rel: Optional[float] = None
    abs: Optional[float] = None

    def allowed_delta(self, prev: float) -> float:
        bounds = []
        if self.rel is not None:
            bounds.append(abs(prev) * self.rel)
        if self.abs is not None:
            bounds.append(self.abs)
        return max(bounds) if bounds else 0.0


#: The gate table: leaf metric name -> budget.  Keyed by the LEAF key
#: (``configs.kv_int8.decode_tokens_per_sec`` gates via its leaf), so
#: every artifact that carries one of these names is tracked wherever
#: the emit site nested it.
TOLERANCES: Dict[str, Tolerance] = {
    # serving throughput: decode-phase and whole-run tokens/sec may not
    # drop more than 5% between adjacent revisions
    "decode_tokens_per_sec": Tolerance(higher_is_better=True, rel=0.05),
    "tokens_per_sec": Tolerance(higher_is_better=True, rel=0.05),
    "goodput_tokens_per_sec": Tolerance(higher_is_better=True, rel=0.05),
    # chaos recovery cost: +5 percentage points is a regression
    "recovery_overhead_pct": Tolerance(higher_is_better=False, abs=5.0),
    # speculative decoding health
    "acceptance_rate": Tolerance(higher_is_better=True, abs=0.02),
    "tokens_per_verify": Tolerance(higher_is_better=True, rel=0.05),
    # paged-cache health
    "prefix_hit_rate": Tolerance(higher_is_better=True, abs=0.05),
    # utilization / goodput
    "mfu": Tolerance(higher_is_better=True, rel=0.05, abs=0.01),
    "goodput_fraction": Tolerance(higher_is_better=True, abs=0.05),
    "unaccounted_pct": Tolerance(higher_is_better=False, abs=1.0),
    # HBM attribution (obs/attrib.py): bytes nobody owns may not creep
    # past +1pp between revisions, and the set of compiled programs the
    # cost registry resolves may never shrink (a program falling out of
    # attribution is a lost instrumentation site, not noise)
    "unaccounted_hbm_pct": Tolerance(higher_is_better=False, abs=1.0),
    "programs_covered": Tolerance(higher_is_better=True, abs=0.0),
    # overload survival (OVERLOAD_*): premium tail latency under a
    # best-effort burst is the isolation headline — generous relative
    # budgets plus an absolute floor because CPU-bench tails are noisy,
    # but a premium p99 that doubles between revisions is a real leak
    # of best-effort pressure into the protected class
    "premium_ttft_p99_s": Tolerance(
        higher_is_better=False, rel=0.50, abs=0.25
    ),
    "premium_tpot_p99_s": Tolerance(
        higher_is_better=False, rel=0.50, abs=0.10
    ),
    # tensor-parallel serving (TP_*): the per-chip param-HBM ratio is
    # ledger-attributed metadata (deterministic, ~1/TP + replicated
    # residue), so only a tiny absolute drift is tolerated; the decode
    # rooflines come from compiled per-device cost analysis, equally
    # deterministic for fixed shapes — creep past 5% means the TP
    # partitioning itself regressed (an unsharded matmul, a lost rule)
    "tp_param_bytes_per_chip_ratio": Tolerance(
        higher_is_better=False, abs=0.02
    ),
    "tp_decode_roofline_ms_dense_f32": Tolerance(
        higher_is_better=False, rel=0.05
    ),
    "tp_decode_roofline_ms_paged_int8": Tolerance(
        higher_is_better=False, rel=0.05
    ),
    # host KV tier (TIER_*): tier_-prefixed so the leaves never collide
    # with the global prefix_hit_rate / decode_tokens_per_sec budgets
    # other artifacts carry.  The hit rate under oversubscription is the
    # tier's whole point — losing 5pp means cold prefixes stopped
    # surviving eviction; the tokens-per-HBM-byte ratio (tier over
    # no-tier baseline) must stay >= 2x per the bench gate, so a 10%
    # relative slide is flagged before the gate itself trips; the
    # fits-in-HBM decode ratio guards the no-pressure fast path — the
    # tier must be free when nothing spills
    "tier_prefix_hit_rate": Tolerance(higher_is_better=True, abs=0.05),
    "tier_tokens_per_hbm_byte_ratio": Tolerance(
        higher_is_better=True, rel=0.10
    ),
    "tier_decode_tokens_per_sec_ratio": Tolerance(
        higher_is_better=True, abs=0.02
    ),
}


@dataclasses.dataclass(frozen=True)
class SeriesPoint:
    kind: str
    path: str       # dotted dict path, or "metric:<name>" for headlines
    revision: int
    value: float
    file: str


@dataclasses.dataclass(frozen=True)
class Regression:
    kind: str
    path: str
    prev_revision: int
    revision: int
    prev: float
    value: float
    allowed_delta: float
    higher_is_better: bool

    def describe(self) -> str:
        direction = "dropped" if self.higher_is_better else "rose"
        return (
            f"{self.kind} {self.path}: {self.prev} (r{self.prev_revision:02d})"
            f" -> {self.value} (r{self.revision:02d}) — {direction} past the"
            f" ±{round(self.allowed_delta, 6)} tolerance"
        )


def _leaf(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def _extract(node: Any, path: str, out: List[Tuple[str, float]]) -> None:
    """Numeric leaves under DICT paths only (list indices are positional,
    not identities — see module docstring)."""
    if isinstance(node, dict):
        for key, value in node.items():
            where = f"{path}.{key}" if path else str(key)
            if isinstance(value, bool):
                continue
            if isinstance(value, (int, float)):
                out.append((where, float(value)))
            else:
                _extract(value, where, out)
    # lists deliberately not descended


def load_points(
    root: str = ".", *, paths: Optional[List[str]] = None,
    validate: bool = True,
    skipped: Optional[List[Tuple[str, str]]] = None,
) -> List[SeriesPoint]:
    """Parse every committed revision artifact into series points.

    Validation runs through :func:`obs.schema.validate_artifact` — the
    same sweep tier-1 runs — so the trajectory can never be built from
    an artifact the schema layer would reject.

    MALFORMED artifacts — unreadable, truncated/partially-written JSON,
    or an empty/non-container payload (a writer died mid-dump) — are a
    different failure class from schema drift: they are SKIPPED with a
    ``(file, reason)`` entry appended to ``skipped`` (when given)
    instead of raising, in gate mode too.  A partially-written artifact
    in the working tree must not brick the perf gate; only a genuine
    tracked-metric regression (or committed schema drift, which the
    tier-1 sweep also owns) may fail it.
    """
    from distributeddeeplearning_tpu_torch.obs.schema import validate_artifact

    files = (
        sorted(paths)
        if paths is not None
        else sorted(glob.glob(os.path.join(root, "*_r*.json")))
    )
    points: List[SeriesPoint] = []
    for file in files:
        m = _ARTIFACT_RE.match(os.path.basename(file))
        if not m:
            continue
        kind, rev = m.group("kind"), int(m.group("rev"))
        # malformed pre-check (both modes): a file json can't even parse
        # — or an empty container — is partially-written noise, not
        # evidence; warn-and-skip, never raise
        try:
            with open(file) as f:
                raw = json.load(f)
            if not isinstance(raw, (dict, list)) or not raw:
                raise json.JSONDecodeError("empty artifact", "", 0)
        except (OSError, json.JSONDecodeError) as exc:
            if skipped is not None:
                skipped.append((file, f"{type(exc).__name__}: {exc}"))
            continue
        if validate:
            data = validate_artifact(file)
        else:
            # non-validating (inspection fallback) read: an unparseable
            # artifact is skipped here — the gate path already reported it
            try:
                with open(file) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
        if not isinstance(data, dict):
            continue
        leaves: List[Tuple[str, float]] = []
        _extract(data, "", leaves)
        for path, value in leaves:
            points.append(SeriesPoint(kind, path, rev, value, file))
        metric = data.get("metric")
        value = data.get("value")
        if isinstance(metric, str) and isinstance(value, (int, float)) and (
            not isinstance(value, bool)
        ):
            points.append(
                SeriesPoint(kind, f"metric:{metric}", rev, float(value), file)
            )
    return points


def build_timeline(
    points: List[SeriesPoint],
) -> Dict[Tuple[str, str], List[SeriesPoint]]:
    """Group points into revision-ordered series keyed by (kind, path)."""
    timeline: Dict[Tuple[str, str], List[SeriesPoint]] = {}
    for pt in points:
        timeline.setdefault((pt.kind, pt.path), []).append(pt)
    for series in timeline.values():
        series.sort(key=lambda p: p.revision)
    return timeline


def _tracked(path: str) -> Optional[Tolerance]:
    return TOLERANCES.get(_leaf(path))


def check_gates(
    timeline: Dict[Tuple[str, str], List[SeriesPoint]],
    tolerances: Optional[Dict[str, Tolerance]] = None,
) -> List[Regression]:
    """Newest vs previous revision for every tracked series — a move
    past the tolerance in the bad direction is a regression."""
    table = tolerances if tolerances is not None else TOLERANCES
    regressions: List[Regression] = []
    for (kind, path), series in sorted(timeline.items()):
        tol = table.get(_leaf(path))
        if tol is None or len(series) < 2:
            continue
        prev, last = series[-2], series[-1]
        if prev.revision == last.revision:
            continue  # same revision twice (re-run) — nothing to gate
        delta = last.value - prev.value
        bad = -delta if tol.higher_is_better else delta
        allowed = tol.allowed_delta(prev.value)
        if bad > allowed:
            regressions.append(
                Regression(
                    kind=kind, path=path,
                    prev_revision=prev.revision, revision=last.revision,
                    prev=prev.value, value=last.value,
                    allowed_delta=allowed,
                    higher_is_better=tol.higher_is_better,
                )
            )
    return regressions


def sparkline(values: List[float]) -> str:
    """Unicode min-max sparkline (single points render mid-ramp)."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi - lo <= 0:
        return _SPARK[3] * len(values)
    return "".join(
        _SPARK[min(
            int((v - lo) / (hi - lo) * (len(_SPARK) - 1)), len(_SPARK) - 1
        )]
        for v in values
    )


def _fmt(v: float) -> str:
    return f"{v:g}"


def render_text(
    timeline: Dict[Tuple[str, str], List[SeriesPoint]],
    regressions: List[Regression],
    *, tracked_only: bool = False,
) -> str:
    """Human view: one line per series (tracked or headline), sparkline +
    first/last values + delta, regressions flagged inline."""
    red = {(r.kind, r.path) for r in regressions}
    lines: List[str] = []
    for (kind, path), series in sorted(timeline.items()):
        headline = path.startswith("metric:")
        tracked = _tracked(path) is not None
        if not tracked and not headline:
            continue
        if tracked_only and not tracked:
            continue
        values = [p.value for p in series]
        first, last = series[0], series[-1]
        delta = ""
        if len(series) > 1:
            change = last.value - first.value
            pct = (
                f" ({change / abs(first.value) * 100.0:+.1f}%)"
                if first.value else ""
            )
            delta = f"  Δ {change:+g}{pct}"
        flag = "  ** REGRESSION **" if (kind, path) in red else ""
        span = (
            f"r{first.revision:02d}..r{last.revision:02d}"
            if len(series) > 1 else f"r{last.revision:02d}"
        )
        lines.append(
            f"{kind:<18} {path:<58} {span:<10} {sparkline(values):<10} "
            f"{_fmt(first.value)} -> {_fmt(last.value)}{delta}{flag}"
        )
    if regressions:
        lines.append("")
        lines.append(f"{len(regressions)} regression(s) past tolerance:")
        for r in regressions:
            lines.append(f"  - {r.describe()}")
    return "\n".join(lines)


def timeline_digest(
    timeline: Dict[Tuple[str, str], List[SeriesPoint]],
    regressions: List[Regression],
) -> Dict[str, Any]:
    """Compact trajectory block for artifacts (GOODPUT carries one):
    tracked-series latest deltas + the gate verdict."""
    tracked = {}
    for (kind, path), series in sorted(timeline.items()):
        if _tracked(path) is None:
            continue
        last = series[-1]
        entry: Dict[str, Any] = {
            "revision": last.revision, "value": last.value,
        }
        if len(series) > 1:
            prev = series[-2]
            entry["prev_revision"] = prev.revision
            entry["prev"] = prev.value
            entry["delta"] = round(last.value - prev.value, 6)
        tracked[f"{kind}:{path}"] = entry
    return {
        "series": len(timeline),
        "tracked_series": len(tracked),
        "tracked": tracked,
        "regressions": [dataclasses.asdict(r) for r in regressions],
        "green": not regressions,
    }


def run_history(
    root: str = ".", *, gate: bool = False, as_json: bool = False,
    paths: Optional[List[str]] = None,
) -> Tuple[int, str]:
    """The ``ddlt obs history [--json] [--gate]`` body: returns
    ``(rc, output)`` — rc 1 only when ``gate`` is set AND a tracked
    metric regressed or an artifact failed schema validation.  Without
    ``gate`` the verb is inspection: a schema-invalid artifact is
    reported as a warning and the timeline still renders (from a
    non-validating reload), rc 0."""
    from distributeddeeplearning_tpu_torch.obs.schema import SchemaError

    warning = ""
    skipped: List[Tuple[str, str]] = []
    try:
        points = load_points(root, paths=paths, skipped=skipped)
    except SchemaError as exc:
        if gate:
            return 1, f"artifact failed schema validation: {exc}"
        # inspection mode: show what can be shown, loudly annotated —
        # the gate (and the tier-1 sweep) own the hard failure
        warning = f"WARNING: artifact failed schema validation: {exc}\n"
        skipped = []
        points = load_points(
            root, paths=paths, validate=False, skipped=skipped,
        )
    for file, reason in skipped:
        # malformed/partially-written artifacts: skipped with a warning
        # in BOTH modes — rc stays regression-only (see load_points)
        warning += (
            f"WARNING: skipped malformed artifact {file} ({reason})\n"
        )
    if not points:
        return (1 if gate else 0), f"{warning}no *_r*.json artifacts under {root}"
    timeline = build_timeline(points)
    regressions = check_gates(timeline)
    if as_json:
        out = json.dumps(timeline_digest(timeline, regressions), indent=2)
    else:
        out = render_text(timeline, regressions)
        verdict = (
            "perf history GREEN" if not regressions
            else f"perf history RED ({len(regressions)} regression(s))"
        )
        out = (
            f"{warning}{out}\n{verdict}: {len(timeline)} series over "
            "committed artifacts"
        )
    rc = 1 if (gate and regressions) else 0
    return rc, out

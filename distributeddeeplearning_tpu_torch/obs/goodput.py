"""Goodput ledger — the port of ``obs/goodput.py``: account for every
second of a training run.

- **mark-based wall attribution**: the trainer calls
  :meth:`GoodputLedger.mark` at every phase boundary; each call charges
  the wall since the previous mark to a named category, so 100% of the
  loop's wall is classified by construction.  ``mark`` is one
  ``perf_counter`` read plus a dict add — it reads no tensor — and a
  no-op when the ledger is disabled (the default);
- **categories** (:data:`CATEGORIES`): ``step_productive`` (steps that
  advanced the run), ``step_redone`` (steps re-executed after a rollback
  or restart), ``compile`` (the first step of each incarnation: in the
  port the kernels' build or load and the CUDA libraries' first-call
  warm-up), ``data_wait``, ``checkpoint_blocking`` (the synchronous
  halves of save/wait), ``eval``, ``recovery`` (restore and re-setup
  inside an incarnation plus the stitched gap between incarnations) and
  ``other`` (loop bookkeeping, epoch rollups);
- **restart durability**: each incarnation appends ONE JSONL segment row
  through ``retry_call`` + the ``DDLT_FAULTS`` ``io_error`` hook (site
  ``goodput``); :func:`stitch` merges the segments, charging the gap
  between incarnation ``i``'s end and ``i+1``'s start to ``recovery``.
  The restart supervisor (``train/resilience.supervise``) interleaves
  ``restart`` rows.  The rows are the reference's, key for key, so either
  package's :func:`stitch` reads the other's file;
- **the residual is a gate**: ``total_wall - sum(categories)`` must stay
  under :data:`RESIDUAL_LIMIT_PCT` (2%): an accounting bug surfaces as a
  red gate, never as silently optimistic goodput;
- **no MFU column**: see :func:`summarize_ledger`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "CATEGORIES",
    "RESIDUAL_LIMIT_PCT",
    "GoodputLedger",
    "append_row",
    "read_rows",
    "stitch",
    "summarize_ledger",
    "post_warmup_tokens_per_sec",
    "get_ledger",
    "set_ledger",
]

#: Every second of a run lands in exactly one of these.
CATEGORIES = (
    "step_productive",
    "step_redone",
    "compile",
    "data_wait",
    "checkpoint_blocking",
    "eval",
    "recovery",
    "other",
)

#: The unaccounted-time gate: |total_wall - sum(categories)| above this
#: percentage of total wall fails the artifact (and the GOODPUT schema).
RESIDUAL_LIMIT_PCT = 2.0


class GoodputLedger:
    """Zero-sync wall-clock ledger over one run incarnation.

    Lifecycle: :meth:`begin` stamps the incarnation's start (and, when a
    ``path`` is configured, reads prior segments so redone-step
    classification survives restarts), ``mark``/``mark_step`` charge
    wall to categories at phase boundaries, :meth:`end` closes the
    incarnation and appends its segment row.  A disabled ledger's mark
    path is one attribute check (the Trainer instruments
    unconditionally).
    """

    def __init__(self, path: Optional[str] = None, *, enabled: Optional[bool] = None):
        self.path = path
        self._on = bool(path) if enabled is None else bool(enabled)
        self._seconds: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._notes: Dict[str, float] = {}
        self._mark = 0.0
        self._begun = False
        self._compile_marked = False
        self._redone_until = 0
        self._last_step = 0
        self._resumed_step = 0
        self._incarnation = 0
        self._run = 0
        self._prior_segments: List[Dict[str, Any]] = []
        self._wall_start = 0.0
        self._flops_per_step: Optional[float] = None

    # -- control -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._on

    def begin(self, *, resumed_step: int = 0) -> "GoodputLedger":
        """Open a new incarnation segment.

        Reads any prior segments at ``path`` first: the incarnation index
        continues the file's numbering, and ``redone_until`` — the highest
        step any earlier incarnation of the SAME RUN completed — is what
        classifies a re-executed step as ``step_redone`` (exactly the
        steps the supervisor's ``redone_steps`` accounting counts).

        By default the new incarnation CONTINUES the file's newest run
        lineage.  Callers that know they resumed nothing — a fresh run
        pointed at a reused ledger file — must call :meth:`fresh_start`
        after ``begin()`` (the Trainer does, keyed off the checkpoint
        restore outcome), which starts a new run lineage instead of
        silently classifying the whole new run as redone work against a
        stale file.
        """
        self._seconds = {}
        self._counts = {"steps": 0, "steps_redone": 0}
        self._notes = {}
        self._compile_marked = False
        self._redone_until = 0
        self._incarnation = 0
        self._run = 0
        self._prior_segments = []
        self._resumed_step = int(resumed_step)
        self._last_step = int(resumed_step)
        if self.path and os.path.exists(self.path):
            try:
                prior = [
                    r for r in read_rows(self.path) if r.get("kind") == "segment"
                ]
            except Exception:
                prior = []
            self._prior_segments = prior
            self._incarnation = len(prior)
            if prior:
                self._run = int(prior[-1].get("run", 0))
            self._redone_until = max(
                (
                    int(r.get("last_step", 0)) for r in prior
                    if int(r.get("run", 0)) == self._run
                ),
                default=0,
            )
        self._wall_start = time.time()
        self._mark = time.perf_counter()
        self._begun = True
        return self

    def fresh_start(self) -> None:
        """This incarnation resumed NOTHING (no checkpoint found, or
        resume disabled): it begins a NEW run lineage.  Prior segments in
        the file belong to an earlier run — they must not classify this
        run's steps as redone, and the stitch layer must not charge the
        gap since that run ended to recovery (a reused ledger path would
        otherwise silently corrupt both)."""
        if not self._on:
            return
        self._redone_until = 0
        if self._prior_segments:
            self._run = int(self._prior_segments[-1].get("run", 0)) + 1

    def set_resumed_step(self, step: int) -> None:
        """Record where this incarnation's checkpoint restore landed (the
        supervisor's ``latest_verified_step`` — redone accounting counts
        from here).  A resumed incarnation continues the file's newest
        run lineage (the ``begin()`` default)."""
        if not self._on:
            return
        self._resumed_step = int(step)
        if self._last_step < step:
            self._last_step = int(step)

    # -- the hot path ------------------------------------------------------
    def mark(self, category: str, *, step: Optional[int] = None) -> None:
        """Charge the wall since the previous mark to ``category``.

        THE hot-path record call: one clock read + dict arithmetic on
        host floats, no tensor ever read.
        """
        if not self._on:
            return
        now = time.perf_counter()
        self._seconds[category] = (
            self._seconds.get(category, 0.0) + (now - self._mark)
        )
        self._mark = now
        if step is not None and step > self._last_step:
            self._last_step = step

    def mark_step(self, step: int) -> None:
        """Charge the wall of one completed train step.

        Classification: the FIRST step of each incarnation is ``compile``
        (it pays the kernels' build or load and the first-call warm-up);
        after that, a step at or below
        the highest step an earlier incarnation already completed is
        ``step_redone`` (re-executed work), everything else is
        ``step_productive``.  The redone COUNT includes a redone first
        step even though its seconds land in ``compile``, so
        ``counts["steps_redone"]`` equals the supervisor's
        ``redone_steps`` exactly.
        """
        if not self._on:
            return
        redone = step <= self._redone_until
        if not self._compile_marked:
            self._compile_marked = True
            category = "compile"
        elif redone:
            category = "step_redone"
        else:
            category = "step_productive"
        self._counts["steps"] = self._counts.get("steps", 0) + 1
        if redone:
            self._counts["steps_redone"] = (
                self._counts.get("steps_redone", 0) + 1
            )
        self.mark(category, step=step)

    def note(self, key: str, seconds: float) -> None:
        """Accumulate a side statistic (e.g. the checkpoint layer's
        save-join vs wait-drain split).  Notes are detail UNDER a
        category, never part of the wall sum — the categories already
        cover this time via the trainer's marks."""
        if not self._on:
            return
        self._notes[key] = self._notes.get(key, 0.0) + seconds

    # -- segment close -----------------------------------------------------
    def end(self, reason: str = "completed") -> Optional[Dict[str, Any]]:
        """Close the incarnation: charge the un-marked tail to ``other``
        (an exception path may abandon the loop between marks), stamp the
        segment, and append it to ``path`` through the retry layer."""
        if not self._on or not self._begun:
            return None
        self.mark("other")
        self._begun = False
        duration = sum(self._seconds.values())
        segment = {
            "kind": "segment",
            "incarnation": self._incarnation,
            "run": self._run,
            "pid": os.getpid(),
            "reason": reason,
            "wall_start": self._wall_start,
            "wall_end": self._wall_start + duration,
            "duration_s": duration,
            "seconds": {k: round(v, 6) for k, v in self._seconds.items()},
            "counts": dict(self._counts),
            "notes": {k: round(v, 6) for k, v in self._notes.items()},
            "resumed_step": self._resumed_step,
            "last_step": self._last_step,
            "flops_per_step": self._flops_per_step,
        }
        if self.path:
            append_row(self.path, segment)
        return segment


# -- durable JSONL rows ----------------------------------------------------


def append_row(path: str, row: Dict[str, Any]) -> bool:
    """Append one ledger row (segment / restart marker), best-effort:
    bounded-backoff retries + the ``DDLT_FAULTS io_error`` hook, exhausted
    retries drop the row rather than killing the run (same contract as
    registry snapshots — the stitch layer detects a dropped segment via
    the restart-row interleave)."""
    from distributeddeeplearning_tpu_torch.utils import faults as faults_mod
    from distributeddeeplearning_tpu_torch.utils.retry import retry_call

    line = json.dumps(row) + "\n"

    def _write() -> None:
        faults_mod.get_plan().maybe_io_error("goodput")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "a") as f:
            f.write(line)

    try:
        retry_call(
            _write, retries=3, base_delay=0.05, max_delay=2.0,
            description=f"goodput ledger append ({path})",
        )
    except Exception:
        return False
    return True


def read_rows(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


# -- stitching + summary ---------------------------------------------------


def stitch(rows_or_path) -> Dict[str, Any]:
    """Merge per-incarnation segments into one run-level ledger.

    Category seconds and step counts sum across segments; the wall-clock
    gap between incarnation ``i``'s end and ``i+1``'s start — the
    restart itself: process teardown, supervisor backoff, re-entry up to
    the next segment's ``begin`` — is charged to ``recovery``.  Total
    wall runs first ``wall_start`` to last ``wall_end``, so the residual
    (total wall minus every category) measures exactly the seconds the
    ledger failed to classify.

    A file holding several RUN lineages (a reused ``goodput_path`` —
    each fresh start bumps the segment ``run`` stamp) stitches only the
    NEWEST run: the hours between unrelated runs are not recovery, and
    an old run's steps must not dilute the new run's goodput.
    """
    rows = read_rows(rows_or_path) if isinstance(rows_or_path, str) else list(
        rows_or_path
    )
    segments = sorted(
        (r for r in rows if r.get("kind") == "segment"),
        key=lambda r: r.get("wall_start", 0.0),
    )
    restarts = [r for r in rows if r.get("kind") == "restart"]
    if not segments:
        raise ValueError("no ledger segments to stitch")
    runs_in_file = len({int(s.get("run", 0)) for s in segments})
    current_run = int(segments[-1].get("run", 0))
    segments = [
        s for s in segments if int(s.get("run", 0)) == current_run
    ]
    # restart markers belong to the run they interleave with: the
    # supervisor writes one between two same-run segments, so anything
    # stamped before the current run's first segment is an older run's
    run_t0 = float(segments[0].get("wall_start", 0.0))
    restarts = [r for r in restarts if float(r.get("ts", run_t0)) >= run_t0]
    seconds = {c: 0.0 for c in CATEGORIES}
    counts = {"steps": 0, "steps_redone": 0}
    flops = None
    for seg in segments:
        for cat, v in seg.get("seconds", {}).items():
            seconds[cat] = seconds.get(cat, 0.0) + float(v)
        for key, v in seg.get("counts", {}).items():
            counts[key] = counts.get(key, 0) + int(v)
        if seg.get("flops_per_step"):
            flops = float(seg["flops_per_step"])
    for prev, nxt in zip(segments, segments[1:]):
        seconds["recovery"] += max(
            float(nxt["wall_start"]) - float(prev["wall_end"]), 0.0
        )
    total_wall = float(segments[-1]["wall_end"]) - float(
        segments[0]["wall_start"]
    )
    return {
        "segments": len(segments),
        "restarts": len(restarts),
        "runs_in_file": runs_in_file,
        "total_wall_s": total_wall,
        "seconds": seconds,
        "counts": counts,
        "last_step": max(int(s.get("last_step", 0)) for s in segments),
        "flops_per_step": flops,
        "notes": _sum_notes(segments),
        "segment_rows": segments,
        "restart_rows": restarts,
    }


def _sum_notes(segments: Iterable[Dict[str, Any]]) -> Dict[str, float]:
    notes: Dict[str, float] = {}
    for seg in segments:
        for key, v in seg.get("notes", {}).items():
            notes[key] = notes.get(key, 0.0) + float(v)
    return notes


def summarize_ledger(
    merged: Dict[str, Any],
    *,
    residual_limit_pct: float = RESIDUAL_LIMIT_PCT,
) -> Dict[str, Any]:
    """Category seconds and shares, the goodput fraction and the residual
    gate verdict of a stitched ledger.  MFU is left out (``None`` and a
    reason), as the reference leaves it out wherever it knows no peak
    rate: the port has no peak-rate table (``utils/hardware.py``, ROADMAP
    A7), and its steps have no cost model to read FLOPs from."""
    total = float(merged["total_wall_s"])
    seconds = {c: round(float(merged["seconds"].get(c, 0.0)), 6)
               for c in CATEGORIES}
    accounted = sum(seconds.values())
    unaccounted = total - accounted
    unaccounted_pct = abs(unaccounted) / total * 100.0 if total > 0 else 0.0
    counts = dict(merged.get("counts", {}))
    counts["segments"] = int(merged.get("segments", 1))
    counts["restarts"] = int(merged.get("restarts", 0))
    mfu_reason = ("no peak-rate table in the port (utils/hardware.py, "
                  "ROADMAP A7) — MFU omitted" if merged.get("flops_per_step")
                  else "flops_per_step unknown")
    summary = {
        "total_wall_s": round(total, 4),
        "seconds": seconds,
        "shares": {
            c: round(v / total, 4) if total > 0 else 0.0
            for c, v in seconds.items()
        },
        "counts": counts,
        "goodput_fraction": (
            round(seconds["step_productive"] / total, 4) if total > 0 else 0.0
        ),
        "unaccounted_s": round(unaccounted, 4),
        "unaccounted_pct": round(unaccounted_pct, 4),
        "residual_limit_pct": residual_limit_pct,
        "residual_under_limit": unaccounted_pct <= residual_limit_pct,
        "mfu": None,
        "notes": merged.get("notes", {}),
        "mfu_omitted_reason": mfu_reason,
    }
    return summary


def post_warmup_tokens_per_sec(
    tokens: int, wall_s: float, warmup_s: float = 0.0
) -> float:
    """Tokens/sec over the post-warmup window: the fleet report's goodput,
    which would otherwise be dominated by replica spawn, torch import and
    engine build rather than serving.  ``warmup_s`` is clamped into
    ``[0, wall_s)``; a degenerate window falls back to the whole wall."""
    if wall_s <= 0:
        return 0.0
    window = wall_s - min(max(warmup_s, 0.0), wall_s)
    if window <= 0:
        window = wall_s
    return round(tokens / window, 2)


# -- process-global ledger (disabled by default) ---------------------------
# Mirrors the tracer/registry pattern: deep layers (Checkpointer's
# save/wait joins) feed the ledger of whatever run is active without
# plumbing it through every signature.

_LEDGER = GoodputLedger(enabled=False)


def get_ledger() -> GoodputLedger:
    return _LEDGER


def set_ledger(ledger: GoodputLedger) -> GoodputLedger:
    global _LEDGER
    _LEDGER = ledger
    return ledger

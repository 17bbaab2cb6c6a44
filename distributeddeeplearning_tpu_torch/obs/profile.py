"""Profiling harness — the port of ``obs/profile.py``: the card's trace and
the host spans on one timeline, and where a decode step's time goes.

- :func:`run_profiled` runs a host callable with the obs tracer enabled
  inside a ``torch.profiler.profile`` window (CPU activity, and CUDA where
  there is a card — the reference's ``jax.profiler.trace``) and exports
  the profile as a chrome trace under ``<trace_dir>/device/``;
- :func:`merge_host_device` aligns that export onto the host tracer's
  clock and emits one Chrome-trace JSON.  The tracer enters
  ``torch.profiler.record_function`` for every span (:mod:`.trace`), so
  each span's name is planted in both timelines: the earliest shared name
  gives the clock offset.  Two traps the port handles: the profile's
  host-side events (``cpu_op``, ``user_annotation``, ``cuda_runtime``)
  carry the real process pid, which is also the tracer's pid, so they
  move to a pid of their own (two processes must not interleave on one
  row); and the profile's Python frames (``python_function`` events, the
  counterpart of xprof's ``$file:line`` frames) are dropped unless
  ``keep_python_frames``;
- :func:`summarize_timeline` digests a merged timeline (the one
  definition: ``obs.fleet`` imports it from here, as the reference's
  does);
- :func:`device_analysis` layers ``utils.roofline.analyze_trace``'s
  per-category table on the export.  A kernel of a torch trace carries no
  byte or FLOP count, so those stay None there: not an error;
- :func:`decode_phase_breakdown` decomposes a paged engine's decode step
  into measured phases over its LIVE cache and block tables (page gather,
  the int8 dequant, the attention of every layer through the engine's own
  decode kernel — K4 on the card — and the rest), plus the speculative
  phases with a decoder; :func:`attribute_regression` names the phase a
  regression lands in (the reference's, exactly).

Every phase is timed with a device sync around its loop: CUDA events on
the card (the reference's ``jax.block_until_ready``), the host clock on
the CPU.  A profiler window slows the host-bound steps after it, so time
phases against each other, not against an earlier run's step time.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.obs.trace import Tracer, get_tracer

logger = logging.getLogger("ddlt.obs.profile")

__all__ = [
    "run_profiled",
    "profile_and_merge",
    "load_device_trace",
    "merge_host_device",
    "summarize_timeline",
    "device_analysis",
    "decode_phase_breakdown",
    "attribute_regression",
    "DEVICE_SUBDIR",
]

#: where :func:`run_profiled` exports the profile, under ``trace_dir`` (so
#: the merged file beside it is never read back as the device trace)
DEVICE_SUBDIR = "device"


def _device_dir(trace_dir: str) -> str:
    sub = os.path.join(trace_dir, DEVICE_SUBDIR)
    return sub if os.path.isdir(sub) else trace_dir


def run_profiled(
    fn: Callable[[], Any],
    *,
    trace_dir: str,
    tracer: Optional[Tracer] = None,
    keep: Optional[List[Any]] = None,
) -> Tuple[Any, Tracer]:
    """Run ``fn()`` with the tracer enabled inside a ``torch.profiler``
    window, exported to ``<trace_dir>/device/``.

    Returns ``(fn's result, the tracer)`` — feed both to
    :func:`merge_host_device` for the combined timeline.  The tracer is
    enabled for the duration and restored to its prior state after.
    ``keep``: a list the ``torch.profiler.profile`` object is appended to,
    for a caller that reads its ``key_averages()`` beside the export.
    """
    from torch.profiler import ProfilerActivity, profile

    tracer = tracer if tracer is not None else get_tracer()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, DEVICE_SUBDIR)
    os.makedirs(out_dir, exist_ok=True)
    was_enabled = tracer.enabled
    tracer.enable()
    try:
        with profile(activities=activities) as prof:
            with tracer.span("profile/window"):
                result = fn()
    finally:
        if not was_enabled:
            tracer.disable()
    prof.export_chrome_trace(
        os.path.join(out_dir, f"profile.{os.getpid()}.trace.json"))
    if keep is not None:
        keep.append(prof)
    return result, tracer


def profile_and_merge(
    fn: Callable[[], Any],
    *,
    trace_dir: str,
    tracer: Optional[Tracer] = None,
    keep: Optional[List[Any]] = None,
) -> Tuple[Any, Tracer, Dict[str, Any], str]:
    """The whole profile-run choreography every caller shares.

    :func:`run_profiled` (enable → profiler window → restore, exception-
    safe) followed by :func:`merge_host_device`, with the merged
    Chrome-trace written to ``<trace_dir>/merged.trace.json``.  Returns
    ``(fn's result, tracer, merged trace, merged path)``; ``keep`` as
    :func:`run_profiled`'s.
    """
    os.makedirs(trace_dir, exist_ok=True)
    result, tracer = run_profiled(fn, trace_dir=trace_dir, tracer=tracer, keep=keep)
    merged = merge_host_device(tracer, trace_dir)
    merged_path = os.path.join(trace_dir, "merged.trace.json")
    with open(merged_path, "w") as f:
        json.dump(merged, f)
        f.write("\n")
    return result, tracer, merged, merged_path


def load_device_trace(trace_dir: str) -> List[Dict[str, Any]]:
    """All events of the newest profiler export under ``trace_dir`` (its
    ``device/`` subdirectory when there is one; [] when no trace file was
    written)."""
    from distributeddeeplearning_tpu_torch.utils.roofline import (
        find_trace_file,
        load_trace_events,
    )

    try:
        trace_file = find_trace_file(_device_dir(trace_dir))
    except FileNotFoundError:
        return []
    return load_trace_events(trace_file)


def _alignment_offset_us(
    host_events: List[Dict[str, Any]], device_events: List[Dict[str, Any]]
) -> Optional[float]:
    """``host_ts - device_ts`` for the earliest span name present in both
    timelines (the tracer's ``record_function`` pass-through plants shared
    names whenever the profiler captured the window).  None = no shared
    name."""
    device_by_name: Dict[str, float] = {}
    for ev in device_events:
        if ev.get("ph") == "X" and ev.get("name"):
            name = str(ev["name"])
            ts = float(ev.get("ts", 0.0))
            if name not in device_by_name or ts < device_by_name[name]:
                device_by_name[name] = ts
    best: Optional[float] = None
    best_host_ts: Optional[float] = None
    for ev in host_events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name")
        if name in device_by_name:
            host_ts = float(ev["ts"])
            if best_host_ts is None or host_ts < best_host_ts:
                best_host_ts = host_ts
                best = host_ts - device_by_name[name]
    return best


def _python_frame(ev: Dict[str, Any]) -> bool:
    return ev.get("cat") == "python_function" or str(ev.get("name", "")).startswith("$")


def merge_host_device(
    tracer: Tracer,
    trace_dir: Optional[str],
    *,
    keep_python_frames: bool = False,
) -> Dict[str, Any]:
    """One Chrome-trace container: host spans + the profile, on the host
    clock.  The profile's events keep their own pids (the card is its own
    row), except those on a tracer pid, which move to a pid past every
    tracer pid (module docstring); host spans keep the tracer's pids.
    Opens directly in chrome://tracing / Perfetto.  Python frames are
    dropped unless ``keep_python_frames``.
    """
    merged = tracer.to_chrome_trace()
    device_events = load_device_trace(trace_dir) if trace_dir else []
    if device_events and not keep_python_frames:
        device_events = [e for e in device_events if not _python_frame(e)]
    if not device_events:
        merged["metadata"]["device_trace"] = "absent"
        return merged
    offset = _alignment_offset_us(merged["traceEvents"], device_events)
    merged["metadata"]["device_trace"] = "merged"
    merged["metadata"]["clock_offset_us"] = offset
    if offset is None:
        # no shared annotation (tracer ran outside the profiled window):
        # fall back to aligning the profile's origin to the host's first
        # span — coarse, but the rows still land side by side
        offset = min(
            (
                float(e["ts"])
                for e in merged["traceEvents"]
                if e.get("ph") == "X"
            ),
            default=0.0,
        ) - min(
            (
                float(e.get("ts", 0.0))
                for e in device_events
                if e.get("ph") == "X"
            ),
            default=0.0,
        )
        merged["metadata"]["clock_offset_us"] = offset
        merged["metadata"]["clock_alignment"] = "coarse (no shared span name)"
    host_pids = set(merged.get("metadata", {}).get("host_pids") or [1])
    # keep host pids exclusive to tracer spans in the merge: a profile
    # event landing on a host pid would interleave two processes into
    # one track (the same collision the fleet shard merge guards)
    remap = max(host_pids) + 1
    shifted = []
    for ev in device_events:
        ev = dict(ev)
        if ev.get("pid") in host_pids:
            ev["pid"] = remap
        if "ts" in ev:
            ev["ts"] = float(ev["ts"]) + offset
        shifted.append(ev)
    merged["traceEvents"] = merged["traceEvents"] + shifted
    return merged


def summarize_timeline(
    merged: Dict[str, Any], *, limit: int = 120
) -> Dict[str, Any]:
    """Artifact-sized digest of a merged timeline: per-source event
    counts, total duration per span name, and the ``limit`` longest
    events in chronological order (the full trace goes to disk, the
    digest goes in the JSON artifact)."""
    events = merged.get("traceEvents", [])
    # host lanes are whatever pids the tracer(s) stamped — recorded in
    # the container metadata (fleet merges union every shard's pid);
    # pid 1 is the fallback for traces without the metadata
    host_pids = set(merged.get("metadata", {}).get("host_pids") or [1])
    host = [
        e for e in events
        if e.get("ph") == "X" and e.get("pid") in host_pids
    ]
    device = [
        e for e in events
        if e.get("ph") == "X" and e.get("pid") not in host_pids
    ]
    instants = [e for e in events if e.get("ph") == "i"]
    by_name_ms: Dict[str, float] = {}
    for e in host:
        name = str(e.get("name"))
        by_name_ms[name] = by_name_ms.get(name, 0.0) + float(
            e.get("dur", 0.0)
        ) / 1e3
    top = sorted(
        host + device, key=lambda e: -float(e.get("dur", 0.0))
    )[:limit]
    top.sort(key=lambda e: float(e.get("ts", 0.0)))
    return {
        "event_counts": {
            "host_spans": len(host),
            "device_events": len(device),
            "instant_events": len(instants),
        },
        "host_span_total_ms": {
            name: round(ms, 3) for name, ms in sorted(
                by_name_ms.items(), key=lambda kv: -kv[1]
            )
        },
        "instant_events": [
            {
                "name": str(e.get("name")),
                "ts_ms": round(float(e.get("ts", 0.0)) / 1e3, 3),
                "args": e.get("args", {}),
            }
            for e in instants[:limit]
        ],
        "events": [
            {
                "name": str(e.get("name"))[:80],
                "source": (
                    "host" if e.get("pid") in host_pids else "device"
                ),
                "ts_ms": round(float(e.get("ts", 0.0)) / 1e3, 3),
                "dur_ms": round(float(e.get("dur", 0.0)) / 1e3, 3),
            }
            for e in top
        ],
    }


def device_analysis(trace_dir: str, *, steps: int) -> Dict[str, Any]:
    """The roofline per-category rollup of the profile (its ``device/``
    subdirectory when there is one): ``available: False`` with the reason
    where the trace holds no device event (a CPU profile), never an
    error.  Bytes and FLOPs stay None on a torch trace (module
    docstring)."""
    from distributeddeeplearning_tpu_torch.utils.roofline import analyze_trace

    try:
        result = analyze_trace(_device_dir(trace_dir), steps=steps)
    except (FileNotFoundError, ValueError) as exc:
        return {"available": False, "reason": str(exc)}
    return {"available": True, **result}


# -- decode phase breakdown ------------------------------------------------

def _time_loop(fn, args, *, iters: int, warmup: int, device) -> float:
    """Mean seconds a call of ``fn(*args)`` after ``warmup`` calls, with a
    device sync around the timed loop: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@torch.inference_mode()
def decode_phase_breakdown(
    engine, *, iters: int = 10, warmup: int = 2, spec_decoder=None
) -> Dict[str, Any]:
    """Measured per-phase decode cost of a paged serving engine.

    Four phases, each timed as its own loop over the engine's live cache
    and block tables (so the measured traffic is the decode step's real
    traffic):

    - ``page_gather``: gathering every slot's K/V history pages through
      the block tables — the cache-bandwidth sub-probe;
    - ``scale_dequant``: the int8 gather path's extra work — gather plus
      the per-(position, head) scale multiply materializing f32 history
      (``quant.qtensor.dequantize_kv``; measured as the increment over
      ``page_gather``; 0 on f32 engines);
    - ``attention_kernel``: the WHOLE per-step attention over the full
      cached history, all layers, through the engine's configured
      ``decode_kernel`` (``ops.flash_decode.decode_attention_paged``: K4
      on the card, ``layers x (warmup + iters)`` launches) — the phase a
      fused-kernel regression (or win) lands in;
    - ``mlp_other``: the decode step minus ``attention_kernel`` — qkv/
      proj/FF/head matmuls, sampling, dispatch.

    ``page_gather``/``scale_dequant`` are sub-probes OF the attention
    phase (the kernel's own cache reads), so the four phases are not
    additive; ``attention_kernel + mlp_other`` is the whole step.

    ``decode_step_ms`` is the real step (``engine.decode``, its token
    readback included) at positions at the END of the window, so
    attention spans the full cached history.

    With a ``spec_decoder`` (``spec.SpeculativeDecoder`` over this same
    engine) two more phases are measured from real spec steps over the
    live cache — ``draft`` and ``verify`` — plus ``spec_step_ms``,
    ``tokens_per_verify`` and ``ms_per_committed_token``, the number
    :func:`attribute_regression` needs to name an acceptance-rate
    collapse.
    """
    from distributeddeeplearning_tpu_torch.ops import flash_decode as fd
    from distributeddeeplearning_tpu_torch.quant.qtensor import dequantize_kv

    cache = engine.cache
    dev = engine.device
    tables = engine.device_tables()
    quantized = "k_scale" in cache

    def _gather(k, v, tbl):
        return k[tbl], v[tbl]

    t_gather = _time_loop(_gather, (cache["k"], cache["v"], tables),
                          iters=iters, warmup=warmup, device=dev)

    if quantized:
        def _gather_dequant(k, v, ks, vs, tbl):
            return dequantize_kv(k[tbl], ks[tbl]), dequantize_kv(v[tbl], vs[tbl])

        t_dequant_inc = _time_loop(
            _gather_dequant,
            (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"], tables),
            iters=iters, warmup=warmup, device=dev)
        t_dequant = max(t_dequant_inc - t_gather, 0.0)
    else:
        t_dequant = 0.0

    # the whole attention phase: per-layer decode attention over the LIVE
    # cache at full-history positions through the engine's real kernel
    # path (fixed pseudo-random queries — the traffic, masking and kernel
    # dispatch are the step's own; only the q values differ)
    num_heads = cache["k"].shape[-2]
    hd = cache["k"].shape[-1]
    L = cache["k"].shape[1]
    b = engine.batch_slots
    kernel = getattr(engine, "decode_kernel", "gather")
    q_dtype = engine.params["embed"].dtype
    gen = torch.Generator().manual_seed(7)
    q_all = torch.randn((L, b, num_heads, hd), generator=gen).to(dev, q_dtype)
    kt = torch.randn((b, num_heads, hd), generator=gen).to(dev, q_dtype)
    vt = torch.randn((b, num_heads, hd), generator=gen).to(dev, q_dtype)
    attn_pos = torch.full((b,), engine.max_seq - 2, dtype=torch.int32, device=dev)
    layers = [(cache["k"][:, i], cache["v"][:, i],
               cache["k_scale"][:, i] if quantized else None,
               cache["v_scale"][:, i] if quantized else None) for i in range(L)]

    def _attn_stack(tbl):
        return [fd.decode_attention_paged(
            q_all[i], k_l, v_l, k_s, v_s, kt, vt, attn_pos, tbl,
            kernel=kernel, mesh=engine.mesh)
            for i, (k_l, v_l, k_s, v_s) in enumerate(layers)]

    t_attention = _time_loop(_attn_stack, (tables,), iters=iters,
                             warmup=warmup, device=dev)

    # the real decode step, as the serving measurements take it: dispatch
    # + compute + the sampled-token readback, at the END of the window —
    # the steady-state regime where the int8 dequant cost lives
    tokens = np.ones(engine.batch_slots, np.int32)
    pos = np.full(engine.batch_slots, engine.max_seq - 2, np.int32)
    for _ in range(warmup):
        engine.decode(tokens, pos)
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.decode(tokens, pos)
    t_decode = (time.perf_counter() - t0) / iters

    residual = max(t_decode - t_attention, 0.0)
    phases_ms = {
        "page_gather": round(t_gather * 1e3, 3),
        "scale_dequant": round(t_dequant * 1e3, 3),
        "attention_kernel": round(t_attention * 1e3, 3),
        "mlp_other": round(residual * 1e3, 3),
    }
    total = max(t_decode, 1e-12)
    out = {
        "decode_step_ms": round(t_decode * 1e3, 3),
        "kv_dtype": engine.kv_dtype,
        "weights_dtype": engine.weights_dtype,
        "decode_kernel": kernel,
        "phases_ms": phases_ms,
        "phase_share_of_step": {
            name: round(ms / 1e3 / total, 4) for name, ms in phases_ms.items()
        },
        "iters": iters,
    }

    if spec_decoder is not None:
        # real spec steps over the live cache, same end positions as the
        # decode timing above — committed tokens measured, not assumed
        K = spec_decoder.draft_tokens
        s_pos = np.full(
            engine.batch_slots, max(0, engine.max_seq - 2 - K), np.int32
        )
        s_tokens = np.ones(engine.batch_slots, np.int32)
        dlen = np.minimum(
            np.full(engine.batch_slots, K, np.int32),
            engine.max_seq - 1 - s_pos,
        ).astype(np.int32)
        keep = np.ones(engine.batch_slots, np.int32)
        for _ in range(warmup):
            spec_decoder.step(s_tokens, s_pos, dlen)
            spec_decoder.rollback(s_pos, keep)
        draft_s = verify_s = 0.0
        committed = 0
        for _ in range(iters):
            res = spec_decoder.step(s_tokens, s_pos, dlen)
            draft_s += res.draft_s
            verify_s += res.verify_s
            committed += int(res.accepted.sum()) + engine.batch_slots
            spec_decoder.rollback(s_pos, keep)
        t_draft = draft_s / iters
        t_verify = verify_s / iters
        tokens_per_verify = committed / (iters * engine.batch_slots)
        spec_total = t_draft + t_verify
        phases_ms["draft"] = round(t_draft * 1e3, 3)
        phases_ms["verify"] = round(t_verify * 1e3, 3)
        out["spec_step_ms"] = round(spec_total * 1e3, 3)
        out["drafter"] = spec_decoder.drafter_name
        out["draft_tokens"] = K
        out["tokens_per_verify"] = round(tokens_per_verify, 4)
        out["ms_per_committed_token"] = round(
            spec_total * 1e3 / max(tokens_per_verify, 1e-9), 3
        )
    return out


def attribute_regression(
    baseline: Dict[str, Any], candidate: Dict[str, Any]
) -> Dict[str, Any]:
    """Name the phase that explains a decode regression.

    Compares two :func:`decode_phase_breakdown` results; the hottest
    phase is the one whose per-phase time GREW the most from baseline to
    candidate, reported with its absolute delta and its share of the
    candidate's step time.

    Deltas are computed over the phases BOTH breakdowns measured: a
    phase present on only one side (e.g. comparing a pre-split
    ``attention_mlp_other`` baseline against the ``attention_kernel`` /
    ``mlp_other`` split) has no meaningful delta — zero-defaulting it
    would report the candidate phase's WHOLE time as growth.  One-sided
    phases are surfaced in ``unmatched_phases`` instead of silently
    skewing the attribution.
    """
    common = [n for n in candidate["phases_ms"] if n in baseline["phases_ms"]]
    unmatched = sorted(
        set(candidate["phases_ms"]) ^ set(baseline["phases_ms"])
    )
    deltas = {
        name: round(
            candidate["phases_ms"][name] - baseline["phases_ms"][name], 3
        )
        for name in common
    }
    total = max(candidate["decode_step_ms"], 1e-9)
    out = {
        "decode_step_ms": {
            "baseline": baseline["decode_step_ms"],
            "candidate": candidate["decode_step_ms"],
        },
        "regression_ms": round(
            candidate["decode_step_ms"] - baseline["decode_step_ms"], 3
        ),
        "phase_delta_ms": deltas,
    }
    if unmatched:
        out["unmatched_phases"] = unmatched
    if deltas:
        hottest = max(deltas, key=lambda k: deltas[k])
        out["hottest_phase"] = hottest
        out["hottest_phase_delta_ms"] = deltas[hottest]
        out["hottest_phase_share_of_step_time"] = round(
            candidate["phases_ms"][hottest] / total, 4
        )
    else:
        out["hottest_phase"] = "decode_step"
        out["hottest_phase_delta_ms"] = out["regression_ms"]
        out["hottest_phase_share_of_step_time"] = 1.0
    return out

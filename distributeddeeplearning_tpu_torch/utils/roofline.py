"""Trace -> roofline analysis — the port of ``utils/roofline.py``.

:func:`program_roofline` is the reference's verdict for one program from
its counted FLOPs and bytes and a measured time.  :func:`analyze_trace`
aggregates a profiler trace over a known number of steps into device ms,
HBM bytes and FLOPs a step, a per-category rollup and the top ops.  It
reads two chrome-trace layouts:

- the reference's xprof export (``*.trace.json.gz``): device HLO events
  carry the XLA cost model's ``bytes accessed`` and flops and an
  ``hlo_category`` in their ``args``;
- a ``torch.profiler`` export (``prof.export_chrome_trace``): device
  events are ``cat`` ``"kernel"``, ``"gpu_memcpy"`` or ``"gpu_memset"``,
  ``pid`` the device and ``tid`` the stream.  A kernel carries no byte or
  FLOP count, so those stay None (a copy or a set carries its ``bytes``);
  its category comes from its name (:func:`torch_category`): GEMMs,
  convolutions, the port's attention kernels by their symbols,
  elementwise, reductions, copies, NCCL.

Events are grouped by device: an xprof pid by its ``process_name`` with
the stream suffix stripped, a torch event by its pid, so one device's
streams merge into one lane, and the busiest device is analysed (with the
reference's warning when it holds about an even share of several).
Where no event of the lane carries bytes (or FLOPs), every rate and
verdict that needs them is None: nothing is guessed.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import re
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ddlt.roofline")

# arg-key spellings seen across xprof versions
_BYTES_KEYS = ("bytes accessed", "bytes_accessed", "raw_bytes_accessed")
_FLOPS_KEYS = ("model flops", "model_flops", "flops")
_CATEGORY_KEYS = ("hlo_category", "category")
#: torch.profiler's device event categories
TORCH_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRACE_PATTERNS = ("*.trace.json.gz", "*.trace.json")

#: (category, name substrings), first match wins; names lowercased
_TORCH_CATEGORIES = (
    ("nccl", ("nccl",)),
    ("flash_attention_fwd", ("flash_fwd_",)),
    ("flash_attention_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_",)),
    ("flash_decode", ("flash_decode_",)),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet", "splitkreduce")),
    ("copy", ("copy", "memcpy", "memset")),
    ("reduction", ("reduce", "softmax", "norm", "argmax", "argmin", "sort", "scan")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill", "index")),
)


def program_roofline(
    flops: float,
    bytes_accessed: float,
    measured_s: float,
    *,
    peak_tflops: Optional[float] = None,
    peak_hbm_gbps: Optional[float] = None,
) -> Dict[str, Any]:
    """Achieved-vs-roofline verdict for ONE program (the reference's):
    achieved FLOP/s and GB/s always; with the card's peaks
    (``utils.hardware``) the shares of both ceilings, the roofline time
    ``max(flops / peak_flops, bytes / peak_bw)``, the ``efficiency`` it
    explains of the measured time and the bound; without them
    ``roofline_available: False``."""
    if measured_s <= 0:
        raise ValueError(f"measured_s must be > 0, got {measured_s}")
    out: Dict[str, Any] = {
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "measured_s": round(measured_s, 6),
        "achieved_tflops": round(flops / measured_s / 1e12, 4),
        "achieved_gbps": round(bytes_accessed / measured_s / 1e9, 3),
        "arithmetic_intensity": round(
            flops / bytes_accessed, 3
        ) if bytes_accessed else None,
        "roofline_available": bool(peak_tflops and peak_hbm_gbps),
    }
    if not out["roofline_available"]:
        return out
    compute_s = flops / (peak_tflops * 1e12)
    bandwidth_s = bytes_accessed / (peak_hbm_gbps * 1e9)
    roofline_s = max(compute_s, bandwidth_s)
    out.update({
        "peak_tflops": peak_tflops,
        "peak_hbm_gbps": peak_hbm_gbps,
        "pct_of_compute_roofline": round(
            flops / measured_s / (peak_tflops * 1e12), 4
        ),
        "pct_of_bandwidth_roofline": round(
            bytes_accessed / measured_s / (peak_hbm_gbps * 1e9), 4
        ),
        "roofline_s": round(roofline_s, 6),
        "efficiency": round(roofline_s / measured_s, 4),
        "bound": (
            "compute" if compute_s >= bandwidth_s else "hbm-bandwidth"
        ),
    })
    return out


def find_trace_file(trace_dir: str) -> str:
    """Newest ``*.trace.json.gz`` or ``*.trace.json`` under ``trace_dir``
    (xprof's layout, or a torch.profiler export), or ``trace_dir`` itself
    when it is a file."""
    if os.path.isfile(trace_dir):
        return trace_dir
    candidates = [p for pattern in _TRACE_PATTERNS for p in glob.glob(
        os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not candidates:
        raise FileNotFoundError(f"no *.trace.json.gz or *.trace.json under {trace_dir}")
    return max(candidates, key=os.path.getmtime)


def _arg(args: Dict[str, Any], keys) -> Optional[float]:
    for key in keys:
        if key in args:
            try:
                return float(args[key])
            except (TypeError, ValueError):
                continue
    return None


def load_trace_events(trace_file: str) -> List[Dict[str, Any]]:
    """Raw ``traceEvents`` of one chrome-trace file (.gz or plain)."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        trace = json.load(f)
    return list(trace.get("traceEvents", []))


def torch_category(name: str, cat: str = "kernel") -> str:
    """The category of a torch.profiler device event from its kernel
    name (module docstring); ``"other"`` where none matches."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    low = name.lower()
    for category, keys in _TORCH_CATEGORIES:
        if any(k in low for k in keys):
            return category
    return "other"


def device_op_events(trace_file: str) -> List[Dict[str, Any]]:
    """Complete ("X") device events with a duration: xprof HLO ops (those
    with an XLA byte count in their args; FLOPs 0 where none) and
    torch.profiler kernels, copies and sets (bytes and FLOPs None where
    the event carries none).  Each carries its ``pid`` and, where the
    trace's ``process_name`` metadata names it, ``pid_name``; a torch
    event its stream as ``tid``."""
    events = load_trace_events(trace_file)
    pid_names: Dict[Any, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = (ev.get("args") or {}).get("name")
            if name:
                pid_names[ev.get("pid", 0)] = str(name)
    out = []
    for ev in events:
        if ev.get("ph") != "X" or not ev.get("dur"):
            continue
        args = ev.get("args") or {}
        pid = ev.get("pid", 0)
        cat = ev.get("cat")
        if cat in TORCH_DEVICE_CATS:
            out.append({
                "name": ev.get("name", "?"),
                "dur_us": float(ev["dur"]),
                "bytes": _arg(args, ("bytes",)),
                "flops": None,
                "category": torch_category(ev.get("name", ""), cat),
                "pid": pid,
                "tid": ev.get("tid"),
                "pid_name": None,  # the device is the pid
            })
            continue
        nbytes = _arg(args, _BYTES_KEYS)
        if nbytes is None:
            continue
        category = None
        for key in _CATEGORY_KEYS:
            if args.get(key):
                category = str(args[key])
                break
        out.append({
            "name": ev.get("name", "?"),
            "dur_us": float(ev["dur"]),
            "bytes": nbytes,
            "flops": _arg(args, _FLOPS_KEYS) or 0.0,
            "category": category or "uncategorized",
            "pid": pid,
            "pid_name": pid_names.get(pid),
        })
    return out


# strip per-stream/lane suffixes so "/device:TPU:0 stream#1" and
# "... stream#2" group under one device key
_STREAM_SUFFIX = re.compile(r"[\s/]*(stream|lane|thread)[\s:#]*\d+\s*$", re.I)


def _lane_key(event: Dict[str, Any]):
    name = event.get("pid_name")
    if name:
        base = _STREAM_SUFFIX.sub("", name).strip()
        if base:
            return base
    return event["pid"]


def _sum(values) -> Optional[float]:
    """The sum, or None where any value is None (no partial counts)."""
    values = list(values)
    return None if any(v is None for v in values) else float(sum(values))


def _r(x: Optional[float], nd: int) -> Optional[float]:
    return None if x is None else round(x, nd)


def _rate(amount: Optional[float], us: float) -> Optional[float]:
    """Per microsecond, times 1e-3: bytes -> GB/s, FLOPs -> TFLOP/s x 1e3."""
    return None if amount is None else amount / max(us, 1e-9) / 1e3


def analyze_trace(
    trace_dir: str,
    *,
    steps: int,
    global_batch: Optional[int] = None,
    peak_hbm_gbps: Optional[float] = None,
    peak_tflops: Optional[float] = None,
    bw_bound_threshold: float = 0.6,
    top_n: int = 10,
) -> Dict[str, Any]:
    """Aggregate a ``steps``-step trace into the roofline verdict (the
    reference's keys): device ms a step, HBM GB and model GFLOP a step,
    the bandwidth-bound time fraction (ops above ``bw_bound_threshold``
    of the peak HBM rate), a per-category rollup, the top ops by time,
    the bandwidth ceiling a step and, with ``global_batch``, the implied
    images a second.  The peaks default to the card's
    (``utils.hardware``, bf16); what needs a count or a peak the trace
    and the card do not give is None."""
    if peak_hbm_gbps is None or peak_tflops is None:
        from distributeddeeplearning_tpu_torch.utils import hardware

        peak_hbm_gbps = peak_hbm_gbps if peak_hbm_gbps is not None else hardware.peak_hbm_gbps()
        if peak_tflops is None:
            flops = hardware.peak_bf16_flops()
            peak_tflops = None if flops is None else flops / 1e12
    events = device_op_events(find_trace_file(trace_dir))
    if not events:
        raise ValueError(f"no device HLO events with byte counts in {trace_dir}")

    # one lane a device: streams of one device merge (module docstring);
    # the busiest device is analysed
    n_pids = len({e["pid"] for e in events})
    lane_us: Dict[Any, float] = {}
    for e in events:
        key = _lane_key(e)
        lane_us[key] = lane_us.get(key, 0.0) + e["dur_us"]
    n_lanes = len(lane_us)
    if n_lanes < n_pids:
        logger.info("roofline: merged %d trace pids into %d device lanes via "
                    "process_name metadata", n_pids, n_lanes)
    busiest = max(lane_us, key=lane_us.get)
    all_lanes_us = sum(lane_us.values())
    busiest_share = lane_us[busiest] / max(all_lanes_us, 1e-9)
    lane_warning = None
    if n_lanes > 1 and busiest_share < 1.25 / n_lanes:
        lane_warning = (
            f"busiest lane holds {busiest_share:.1%} of device time across "
            f"{n_lanes} lanes (~an even split): if this trace is from ONE "
            "device whose events span multiple pids, per-step time/bytes "
            "are under-reported by ~n_lanes; for a multi-chip trace with "
            "even load this is expected"
        )
        logger.warning("roofline: %s", lane_warning)
    events = [e for e in events if _lane_key(e) == busiest]

    total_us = sum(e["dur_us"] for e in events)
    total_bytes = _sum(e["bytes"] for e in events)
    total_flops = _sum(e["flops"] for e in events)
    bw_bound_us: Optional[float] = None
    if total_bytes is not None and peak_hbm_gbps:
        bw_bound_us = sum(
            e["dur_us"] for e in events
            if e["bytes"] / max(e["dur_us"], 1e-9) / 1e3 >= bw_bound_threshold * peak_hbm_gbps)
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        groups.setdefault(e["category"], []).append(e)

    def _rollup(evs):
        return (sum(e["dur_us"] for e in evs), _sum(e["bytes"] for e in evs),
                _sum(e["flops"] for e in evs))

    def _tflops(flops, us):
        return None if flops is None else round(flops / max(us, 1e-9) / 1e6, 2)

    category_table = {}
    for name, evs in sorted(groups.items(), key=lambda kv: -_rollup(kv[1])[0]):
        us, nbytes, flops = _rollup(evs)
        category_table[name] = {
            "time_ms_per_step": round(us / steps / 1e3, 3),
            "time_fraction": round(us / total_us, 4),
            "gb_per_step": None if nbytes is None else round(nbytes / steps / 1e9, 3),
            "sustained_gbps": _r(_rate(nbytes, us), 1),
            "sustained_tflops": _tflops(flops, us),
        }

    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    top_fusions = []
    for name, evs in sorted(by_name.items(), key=lambda kv: -_rollup(kv[1])[0])[:top_n]:
        us, nbytes, flops = _rollup(evs)
        top_fusions.append({
            "name": name[:80],
            "time_ms_per_step": round(us / steps / 1e3, 3),
            "sustained_gbps": _r(_rate(nbytes, us), 1),
            "sustained_tflops": _tflops(flops, us),
        })

    measured_ms = total_us / steps / 1e3
    bytes_per_step = None if total_bytes is None else total_bytes / steps
    ceiling_ms = (None if bytes_per_step is None or not peak_hbm_gbps
                  else bytes_per_step / (peak_hbm_gbps * 1e9) * 1e3)
    bw_fraction = None if bw_bound_us is None else bw_bound_us / total_us
    result: Dict[str, Any] = {
        "steps_analyzed": steps,
        "device_lanes_in_trace": n_lanes,
        "busiest_lane_share": round(busiest_share, 4),
        "lane_warning": lane_warning,
        "device_ms_per_step": round(measured_ms, 2),
        "hbm_gb_per_step": None if bytes_per_step is None else round(bytes_per_step / 1e9, 2),
        "model_gflops_per_step": (None if total_flops is None
                                  else round(total_flops / steps / 1e9, 1)),
        "sustained_hbm_gbps": _r(_rate(total_bytes, total_us), 1),
        "sustained_tflops": _tflops(total_flops, total_us),
        "peak_hbm_gbps": peak_hbm_gbps,
        "peak_tflops": peak_tflops,
        "bw_bound_time_fraction": _r(bw_fraction, 4),
        "bandwidth_ceiling_ms_per_step": _r(ceiling_ms, 2),
        "pct_of_bandwidth_ceiling": (None if ceiling_ms is None
                                     else round(ceiling_ms / measured_ms, 4)),
        "verdict": (None if bw_fraction is None else
                    "hbm-bandwidth-bound" if bw_fraction > 0.5
                    else "compute-or-latency-bound"),
        "categories": category_table,
        "top_fusions": top_fusions,
    }
    if global_batch:
        result["implied_ceiling_img_sec"] = (
            None if ceiling_ms is None else round(global_batch / (ceiling_ms / 1e3), 1))
        result["measured_img_sec_from_trace"] = round(
            global_batch / (measured_ms / 1e3), 1)
    return result

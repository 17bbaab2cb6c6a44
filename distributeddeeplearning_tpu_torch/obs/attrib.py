"""Per-program cost attribution — the port of ``obs/attrib.py``: what each
serving and training program costs, in FLOPs and bytes, measured at the
source.

The reference wraps every jitted entry point (``tracked_jit``) and reads
XLA's cost model of the lowered program.  PyTorch runs eagerly, so the
port's counterpart of a jitted program is the callable an engine or a
step dispatches: ``forward_prefill`` and ``insert_sequence`` in the dense
engine's prefill, ``forward_decode`` in its decode, the paged engine's
``forward_prefill_chunk`` and ``forward_decode_paged``, the cache scrubs,
the speculative verify and rollback, and the train, comm-overlap and eval
steps.  Each is wrapped by :func:`tracked_jit` (the reference's name, kept
so a reader finds the call sites of both packages by one word) under the
reference's program name, letter for letter (``serve.dense.float32.decode``,
``serve.paged.int8.prefill_chunk``, ``spec.paged.verify``,
``train.step.implicit``, ...).

- **Recording** (:class:`TrackedProgram`): at the first call of each new
  signature the program keeps ``meta`` copies of its arguments (shapes,
  strides and dtypes; no memory, no data) — never a buffer read, never a
  sync.  The signature is the shapes, dtypes and devices of the arguments
  that vary plus the static arguments.  A call is keyed cheaply: a tensor
  by its shape, dtype and device, a flat dict of tensors (a batch, a KV
  cache) by those of its values, a scalar by its value (by its type for
  the ``dynamic`` arguments: positions and offsets the reference traces),
  and any other container (a weight tree, a train state) by its identity,
  so no call walks a weight tree.  At most :data:`MAX_SIGNATURES`
  signatures are kept per program.  On the card the first call of a
  signature also reads the caching allocator's host-side peak counter
  before and after itself; it never resets it (the statistic is the
  process's, and other callers read it over their own windows).
- **Collection** (:meth:`TrackedProgram.collect`, the counterpart of
  ``Lowered.cost_analysis()``): each recorded signature runs again on its
  ``meta`` copies under ``torch.utils.flop_counter.FlopCounterMode``.  On
  ``meta`` the attention wrappers take their plain path (the kernels are
  ``ctypes`` calls no counter sees), so the count is the plain version's:
  ``flops`` are the matrix products' (2 x M x N x K a product; attention
  over the whole cache window the program's shapes give, as XLA counts
  it: positions are data, and ``meta`` holds none), NOT the elementwise
  work XLA's cost model adds.  ``bytes_accessed`` is counted on the same
  run: every ATen operation's tensor inputs and outputs, view operations
  excepted; an in-place overwrite (``copy_``, ``fill_``) writes its
  target once and does not read it, and an in-place indexed write (a
  KV-cache update) reads its indices and source and writes the source's
  bytes, not the whole target.  It is an unfused count, as the reference's is (XLA's cost model
  of the LOWERED program, before fusion), at ATen's granularity: a layer
  norm or a softmax is one operation here and several HLO operations
  there, so the port's count is at most the reference's for the same
  program (held in the tests).  ``collect(memory=True)`` adds
  ``argument_bytes`` (the argument tensors' storages, each once),
  ``output_bytes`` (the returned tensors), ``alias_bytes`` (the argument
  storages the program writes in place — the KV cache, the train state:
  the counterpart of donation) and ``temp_bytes``: the allocator's peak
  during the signature's first real call on the card above what the call
  left allocated, read only where that call raised the process's peak.
  Where it did not (the process peaked higher before), and off the card,
  ``temp_bytes`` is None and ``error`` says why.  ``collect`` never runs a program on its live arguments (it never
  writes a live cache) and never launches a kernel.
- **Timing and the report**: :func:`step_phase_stats`,
  :func:`straggler_report` and :func:`compute_collective_split` are the
  reference's pure functions; :func:`build_report` puts the cost rows, the
  HBM ledger's reconciled frame (:mod:`.ledger`) and, per program with a
  measured step time, achieved-vs-roofline
  (``utils.roofline.program_roofline``) in one JSON frame.

Departures from the reference: :func:`reference_peaks` reads the card's
peaks from ``utils.hardware`` and off the card returns none (the
reference falls back to another accelerator's nominal rates; the port
states no rate it did not take from the card's data sheet), so every
roofline ratio is then absent.  Off the card the ledger has no live-bytes
counter: ``owner_totals_match_live`` and ``residual_under_limit`` are
then ``None`` — not measured, never passed — and :func:`self_check`
leaves them out of its verdict and lists them under ``not_measured``.

The registry holds programs through WEAK references: a garbage-collected
engine's programs drop out.  The cached cost table rides every flight-
recorder dump as ``program_costs`` (:func:`.recorder.register_dump_context`)
and is never computed mid-failure.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.obs import recorder as _recorder_mod

__all__ = [
    "ProgramCost",
    "TrackedProgram",
    "ProgramCostRegistry",
    "tracked_jit",
    "get_programs",
    "set_programs",
    "step_phase_stats",
    "straggler_report",
    "compute_collective_split",
    "reference_peaks",
    "build_report",
    "self_check",
    "PHASE_SPANS",
]

#: signatures retained per program (prefill buckets are the widest real
#: family: log2(max_seq) of them; 16 bounds a pathological caller)
MAX_SIGNATURES = 16

#: the step-phase span names straggler attribution aggregates — the spans
#: the trainer/scheduler hot loops already emit
PHASE_SPANS = (
    "train/data_wait",
    "train/step",
    "train/checkpoint",
    "serve/decode_step",
    "serve/spec_step",
    "serve/prefill_chunk",
)

_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device)
_ARRAYS = (torch.Tensor, np.ndarray)


# -- signatures ---------------------------------------------------------------

def _key(v):
    """The cheap key of one argument (module docstring): no function call
    a leaf, no generator — it runs on every call of a program."""
    if isinstance(v, torch.Tensor):
        return (v.shape, v.dtype, v.device)
    if isinstance(v, _SCALARS):
        return v
    if type(v) is dict:
        for x in v.values():
            if not isinstance(x, _ARRAYS):  # a tree (weights): its identity
                return ("id", id(v))
        return tuple([(x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor)
                      else (x.shape, x.dtype.str) for x in v.values()])
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str)
    return ("id", id(v))


def _call_key(args: Tuple, kwargs: Dict, dynamic) -> Tuple:
    if not kwargs:
        return tuple([_key(a) for a in args])
    return (tuple([_key(a) for a in args]),
            tuple([(k, type(v) if k in dynamic else _key(v))
                   for k, v in kwargs.items()]))


def _leaves(tree, out: List) -> List:
    """Every leaf of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    else:
        out.append(tree)
    return out


def _describe(leaf) -> str:
    if isinstance(leaf, _ARRAYS):
        dtype = str(leaf.dtype).replace("torch.", "")
        shape = ",".join(map(str, leaf.shape))
        dev = f"@{leaf.device}" if isinstance(leaf, torch.Tensor) else "@host"
        return f"{dtype}[{shape}]{dev}"
    if isinstance(leaf, _SCALARS):
        return repr(leaf)
    return getattr(leaf, "__qualname__", type(leaf).__name__)


def _signature(args: Tuple, kwargs: Dict, dynamic) -> str:
    parts = [_describe(x) for x in _leaves(list(args), [])]
    for k, v in kwargs.items():
        desc = (f"{type(v).__name__}" if k in dynamic
                else ";".join(_describe(x) for x in _leaves([v], [])))
        parts.append(f"{k}={desc}")
    return ";".join(parts)


def _to_meta(tree, memo: Dict[int, Any]):
    """A copy of ``tree`` with every tensor (and numpy array) a ``meta``
    tensor of the same shape, strides and dtype; one tensor seen twice maps
    to one copy.  Other leaves (functions, optimizers, scalars) are kept."""
    if isinstance(tree, torch.Tensor):
        got = memo.get(id(tree))
        if got is None:
            got = torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                      dtype=tree.dtype, device="meta")
            if tree.requires_grad:
                got.requires_grad_(True)
            memo[id(tree)] = got
        return got
    if isinstance(tree, np.ndarray):
        return torch.empty(tree.shape, device="meta",
                           dtype=torch.from_numpy(np.empty(0, tree.dtype)).dtype)
    if type(tree) is dict:
        return {k: _to_meta(v, memo) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v, memo) for v in tree]
    if isinstance(tree, tuple):
        items = [_to_meta(v, memo) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if (dataclasses.is_dataclass(tree) and not isinstance(tree, type)
            and any(isinstance(x, torch.Tensor) for x in _leaves(tree, []))):
        return dataclasses.replace(tree, **{
            f.name: _to_meta(getattr(tree, f.name), memo)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _tensor_storages(tree) -> Dict[int, int]:
    """Storage identity -> bytes of every tensor in ``tree`` (each storage
    once)."""
    out: Dict[int, int] = {}
    for leaf in _leaves(tree, []):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            out[st._cdata] = int(st.nbytes())
    return out


def _first_cuda(args: Tuple, kwargs: Dict) -> Optional[torch.device]:
    for leaf in _leaves([list(args), kwargs], []):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


@dataclasses.dataclass
class ProgramCost:
    """The cost of one (program, signature): matrix-product FLOPs and the
    unfused bytes of one run on ``meta`` (module docstring), plus the
    memory columns when asked for."""

    name: str
    signature: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    available: bool = False
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class _Recorded:
    """One recorded signature: the ``meta`` copies of its arguments, the
    autograd mode of its first call and, on the card, that call's
    transient allocation (or why it was not read)."""

    __slots__ = ("args", "kwargs", "grad", "inference", "temp_bytes", "temp_note")

    def __init__(self, args, kwargs, grad, inference, temp_bytes):
        self.args = args
        self.kwargs = kwargs
        self.grad = grad
        self.inference = inference
        self.temp_bytes = temp_bytes
        self.temp_note = ("temp_bytes not measured: the signature's first call "
                          "ran off the card (no allocator peak to read)")


#: in-place indexed writes: their bytes are the indices and the source read
#: and the source's bytes written, not the whole target (a KV-cache write)
_INDEXED_WRITES = frozenset({"index_put_", "_index_put_impl_", "index_copy_",
                             "index_add_", "scatter_", "scatter_add_",
                             "scatter_reduce_"})


#: in-place overwrites: the target written whole, never read
_OVERWRITES = frozenset({"copy_", "fill_", "zero_"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _cost_mode():
    """A dispatch mode summing the bytes every non-view operation reads
    and writes, and noting the storages it writes in place."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0
            self.written: set = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view:
                return out
            name = func.overloadpacket.__name__
            if name in _OVERWRITES:
                # the target is written whole and not read
                ins = [x for x in _leaves([list(args[1:]), kwargs], [])
                       if isinstance(x, torch.Tensor)]
                self.nbytes += sum(_nbytes(x) for x in ins) + _nbytes(args[0])
            elif name in _INDEXED_WRITES:
                # reads the indices and the source, writes the source's
                # bytes into the target: the target is not read or written
                # whole (the output aliases it)
                ins = [x for x in _leaves([list(args[1:]), kwargs], [])
                       if isinstance(x, torch.Tensor)]
                src = [x for x in args[1:] if isinstance(x, torch.Tensor)]
                self.nbytes += sum(_nbytes(x) for x in ins) + (
                    _nbytes(src[-1]) if src else 0)
            else:
                ins = [x for x in _leaves([list(args), kwargs], [])
                       if isinstance(x, torch.Tensor)]
                outs = [x for x in _leaves([out], []) if isinstance(x, torch.Tensor)]
                self.nbytes += (sum(_nbytes(x) for x in ins)
                                + sum(_nbytes(x) for x in outs))
            for i, arg in enumerate(func._schema.arguments):
                if arg.alias_info is not None and arg.alias_info.is_write:
                    val = args[i] if i < len(args) else kwargs.get(arg.name)
                    if isinstance(val, torch.Tensor):
                        self.written.add(val.untyped_storage()._cdata)
            return out

    return _Bytes()


class TrackedProgram:
    """A program callable plus its signature log.

    Transparent to callers: ``__call__`` forwards, every other attribute
    resolves on the wrapped callable.  A call whose cheap key (module
    docstring) was seen before costs the key and one set lookup; only a
    new key abstracts its arguments.  ``dynamic``: keyword arguments whose
    value is data (a position, an offset, a slot), keyed by type only."""

    __slots__ = ("name", "_fn", "_dynamic", "_seen", "_sigs", "_costs",
                 "__weakref__")

    def __init__(self, name: str, fn, dynamic: Sequence[str] = ()):
        self.name = name
        self._fn = fn
        self._dynamic = frozenset(dynamic)
        self._seen: set = set()
        # signature -> _Recorded; insertion-ordered
        self._sigs: Dict[str, _Recorded] = {}
        self._costs: Dict[str, ProgramCost] = {}

    # -- the hot path ------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if len(self._sigs) >= MAX_SIGNATURES:
            return self._fn(*args, **kwargs)
        key = _call_key(args, kwargs, self._dynamic)
        if key in self._seen:
            return self._fn(*args, **kwargs)
        self._seen.add(key)
        return self._record_call(args, kwargs)

    def _record_call(self, args: Tuple, kwargs: Dict):
        """The first call of a new key: keep ``meta`` copies of the
        arguments (before the call: the program may write them in place)
        and, on the card, the call's transient allocation."""
        sig = _signature(args, kwargs, self._dynamic)
        new = sig not in self._sigs
        if new:
            memo: Dict[int, Any] = {}
            rec = _Recorded(_to_meta(args, memo), _to_meta(kwargs, memo),
                            torch.is_grad_enabled(),
                            torch.is_inference_mode_enabled(), None)
            self._sigs[sig] = rec
        dev = _first_cuda(args, kwargs) if new else None
        if dev is None:
            return self._fn(*args, **kwargs)
        # host-side allocator counters only: no sync, and the process's
        # peak statistic is read, never reset
        before = torch.cuda.max_memory_allocated(dev)
        out = self._fn(*args, **kwargs)
        peak = torch.cuda.max_memory_allocated(dev)
        if peak > before:
            rec.temp_bytes = max(0, peak - torch.cuda.memory_allocated(dev))
        else:
            rec.temp_note = ("temp_bytes not measured: the signature's first "
                             "call stayed under the process's earlier allocator "
                             "peak (the peak statistic is never reset)")
        return out

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_fn"), item)

    # -- collection --------------------------------------------------------
    @property
    def signatures(self) -> List[str]:
        return list(self._sigs)

    def _run_meta(self, rec: _Recorded) -> ProgramCost:
        from torch.utils.flop_counter import FlopCounterMode

        counter = _cost_mode()
        with torch.inference_mode(rec.inference), torch.set_grad_enabled(rec.grad):
            with FlopCounterMode(display=False) as flops, counter:
                out = self._fn(*rec.args, **rec.kwargs)
        args = _tensor_storages([list(rec.args), rec.kwargs])
        return ProgramCost(
            name=self.name, signature="",
            flops=float(flops.get_total_flops()),
            bytes_accessed=float(counter.nbytes),
            argument_bytes=sum(args.values()),
            output_bytes=sum(_tensor_storages([out]).values()),
            alias_bytes=sum(b for k, b in args.items() if k in counter.written),
            available=True)

    def collect(self, *, memory: bool = False) -> List[ProgramCost]:
        """Resolve every recorded signature to a :class:`ProgramCost` (one
        run on ``meta`` each, cached: later collects are free).  A
        signature that fails to run records its error instead of raising
        — attribution must never take down the run it measures."""
        out: List[ProgramCost] = []
        for sig, rec in list(self._sigs.items()):
            cost = self._costs.get(sig)
            if cost is None:
                try:
                    cost = self._run_meta(rec)
                    cost.signature = sig
                except Exception as exc:  # noqa: BLE001 — recorded, not raised
                    cost = ProgramCost(name=self.name, signature=sig,
                                       error=f"{type(exc).__name__}: {exc}")
                self._costs[sig] = cost
            row = dataclasses.replace(cost)
            if not memory:
                row.argument_bytes = row.output_bytes = row.alias_bytes = None
            elif row.available:
                row.temp_bytes = rec.temp_bytes
                if rec.temp_bytes is None and row.error is None:
                    row.error = rec.temp_note
            out.append(row)
        return out


class ProgramCostRegistry:
    """Every tracked program in the process, weakly held.

    ``collect`` resolves costs; the most recent table is cached so the
    flight recorder's crash dumps can attach it WITHOUT running anything
    mid-failure."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: List["weakref.ref[TrackedProgram]"] = []
        self.last_table: List[Dict[str, Any]] = []

    def track(self, name: str, fn, dynamic: Sequence[str] = ()) -> TrackedProgram:
        prog = TrackedProgram(name, fn, dynamic)
        with self._lock:
            self._programs = [r for r in self._programs if r() is not None]
            self._programs.append(weakref.ref(prog))
        return prog

    def programs(self) -> List[TrackedProgram]:
        with self._lock:
            live = [r() for r in self._programs]
            return [p for p in live if p is not None]

    def names(self) -> List[str]:
        return sorted({p.name for p in self.programs()})

    def collect(
        self, *, memory: bool = False, registry=None,
    ) -> Dict[str, List[ProgramCost]]:
        """Costs for every live program, grouped by name.  With a
        metrics ``registry`` the representative (largest-flops)
        signature per name is published as ``attrib.<name>.flops`` /
        ``attrib.<name>.bytes_accessed`` gauges."""
        grouped: Dict[str, List[ProgramCost]] = {}
        for prog in self.programs():
            costs = prog.collect(memory=memory)
            if not costs:
                continue  # tracked but never called (e.g. scrub on a
                # healthy run) — nothing to attribute, nothing to gate
            grouped.setdefault(prog.name, []).extend(costs)
        self.last_table = [
            c.to_dict() for costs in grouped.values() for c in costs
        ]
        if registry is not None:
            for name, costs in grouped.items():
                best = max(
                    (c for c in costs if c.flops is not None),
                    key=lambda c: c.flops, default=None,
                )
                if best is None:
                    continue
                registry.gauge(f"attrib.{name}.flops").set(best.flops)
                if best.bytes_accessed is not None:
                    registry.gauge(f"attrib.{name}.bytes_accessed").set(
                        best.bytes_accessed
                    )
        return grouped

    def dump_table(self) -> List[Dict[str, Any]]:
        """The crash-dump attachment: the cached cost table when a
        collect has run, otherwise the bare signature inventory —
        NEVER a fresh run (this runs mid-failure)."""
        if self.last_table:
            return self.last_table
        return [
            {"name": p.name, "signature": s, "available": False}
            for p in self.programs()
            for s in p.signatures
        ]


# -- process-global program registry ----------------------------------------

_PROGRAMS = ProgramCostRegistry()


def get_programs() -> ProgramCostRegistry:
    return _PROGRAMS


def set_programs(registry: ProgramCostRegistry) -> ProgramCostRegistry:
    global _PROGRAMS
    _PROGRAMS = registry
    return registry


def tracked_jit(name: str, fn, *, dynamic: Sequence[str] = ()) -> TrackedProgram:
    """Wrap a program callable into the process cost registry — the one-
    line instrumentation every engine and step program goes through (the
    reference's name; nothing is compiled)."""
    return _PROGRAMS.track(name, fn, dynamic)


# the program-cost table rides every flight-recorder dump (cached table
# only — nothing runs mid-crash); see obs/recorder.register_dump_context
_recorder_mod.register_dump_context(
    "program_costs", lambda: get_programs().dump_table()
)


# -- straggler / step-phase timing ------------------------------------------

def _iter_shards(shards: Iterable[Any]):
    for shard in shards:
        if isinstance(shard, str):
            with open(shard) as f:
                yield json.load(f)
        else:
            yield shard


def step_phase_stats(
    events: Sequence[Dict[str, Any]],
    phases: Sequence[str] = PHASE_SPANS,
) -> Dict[str, Dict[Any, Dict[str, float]]]:
    """Per-(phase, pid) duration stats over one Chrome-trace event list.

    Durations come from each span's own ``dur`` field — a per-host
    monotonic measurement that no cross-host clock offset can touch —
    so skewed shards yield the same stats as aligned ones."""
    wanted = set(phases)
    acc: Dict[str, Dict[Any, Dict[str, float]]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") not in wanted:
            continue
        dur_ms = float(ev.get("dur", 0.0)) / 1e3
        row = acc.setdefault(ev["name"], {}).setdefault(
            ev.get("pid", 0),
            {"count": 0, "total_ms": 0.0, "max_ms": 0.0},
        )
        row["count"] += 1
        row["total_ms"] += dur_ms
        if dur_ms > row["max_ms"]:
            row["max_ms"] = dur_ms
    for per_pid in acc.values():
        for row in per_pid.values():
            row["mean_ms"] = round(row["total_ms"] / row["count"], 4)
            row["total_ms"] = round(row["total_ms"], 4)
            row["max_ms"] = round(row["max_ms"], 4)
    return acc


def straggler_report(
    shards: Iterable[Any],
    phases: Sequence[str] = PHASE_SPANS,
) -> Dict[str, Any]:
    """Slowest-host attribution over per-host tracer shards.

    ``shards``: Chrome-trace dicts or file paths (the per-process
    exports ``Tracer.export`` writes and ``obs.fleet`` merges).  Hosts
    are named by their shard's ``process_name`` metadata (pid fallback).
    Per phase: per-host mean/total/max span durations, the slowest and
    fastest host by mean, and ``skew_pct`` — how much longer the
    straggler runs the phase than the fastest host.  ``negative_spans``
    counts spans with negative duration and must be 0: durations are
    single-clock measurements, which is exactly why wall-clock offset
    between hosts cannot corrupt this table."""
    merged_events: List[Dict[str, Any]] = []
    host_names: Dict[Any, str] = {}
    negative = 0
    # pids are only unique WITHIN a shard, so each shard gets its own pid
    # namespace: first shard to use a pid keeps it, later shards colliding
    # on it are suffixed so two hosts never merge into one row
    pid_owner: Dict[Any, int] = {}
    for idx, shard in enumerate(_iter_shards(shards)):
        events = shard.get("traceEvents") if isinstance(shard, dict) else shard
        local: Dict[Any, Any] = {}

        def qualify(pid: Any) -> Any:
            if pid not in local:
                if pid_owner.setdefault(pid, idx) == idx:
                    local[pid] = pid
                else:
                    local[pid] = f"{pid}#{idx}"
            return local[pid]

        for ev in events or []:
            pid = qualify(ev.get("pid", 0))
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                name = (ev.get("args") or {}).get("name")
                if name:
                    host_names[pid] = str(name)
            elif ev.get("ph") == "X":
                if float(ev.get("dur", 0.0)) < 0.0:
                    negative += 1
                merged_events.append(
                    ev if ev.get("pid", 0) == pid else {**ev, "pid": pid}
                )
    stats = step_phase_stats(merged_events, phases)
    report: Dict[str, Any] = {
        "hosts": sorted(
            {host_names.get(pid, str(pid))
             for per in stats.values() for pid in per}
        ),
        "negative_spans": negative,
        "phases": {},
    }
    for phase, per_pid in sorted(stats.items()):
        rows = {
            host_names.get(pid, str(pid)): row
            for pid, row in per_pid.items()
        }
        slowest = max(rows, key=lambda h: rows[h]["mean_ms"])
        fastest = min(rows, key=lambda h: rows[h]["mean_ms"])
        fast_mean = rows[fastest]["mean_ms"]
        report["phases"][phase] = {
            "per_host": rows,
            "slowest_host": slowest,
            "fastest_host": fastest,
            "skew_pct": round(
                (rows[slowest]["mean_ms"] - fast_mean)
                / fast_mean * 100.0, 2,
            ) if fast_mean > 0 else 0.0,
        }
    return report


def compute_collective_split(
    flops: float,
    wire_bytes: float,
    *,
    peak_flops: float,
    interconnect_gbps: float,
    measured_step_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Analytic compute-vs-collective step decomposition.

    ``compute_s = flops / peak_flops``; ``collective_s = wire_bytes /
    interconnect``.  This is a MODEL (perfect overlap would hide the
    smaller term entirely; zero overlap serializes them) — the block is
    stamped ``estimated: True`` and, given a measured step time, reports
    how much wall the two ideals leave unexplained."""
    compute_s = flops / peak_flops if peak_flops > 0 else 0.0
    collective_s = (
        wire_bytes / (interconnect_gbps * 1e9)
        if interconnect_gbps > 0 else 0.0
    )
    total = compute_s + collective_s
    out: Dict[str, Any] = {
        "estimated": True,
        "compute_s": round(compute_s, 6),
        "collective_s": round(collective_s, 6),
        "compute_fraction": round(compute_s / total, 4) if total else 0.0,
        "collective_fraction": (
            round(collective_s / total, 4) if total else 0.0
        ),
        "bound": (
            "compute" if compute_s >= collective_s else "collective"
        ),
    }
    if measured_step_s is not None and measured_step_s > 0:
        out["measured_step_s"] = round(measured_step_s, 6)
        out["unexplained_s"] = round(
            max(0.0, measured_step_s - max(compute_s, collective_s)), 6
        )
    return out


# -- report choreography -----------------------------------------------------

def reference_peaks(device=None) -> Tuple[Optional[float], Optional[float], str]:
    """``(peak_tflops, peak_hbm_gbps, source)`` for the roofline columns:
    the card's data-sheet dense bf16 and HBM peaks (``utils.hardware``,
    the reference's MFU convention) when the table knows BOTH, else
    ``(None, None, reason)`` — every roofline ratio is then absent
    (module docstring: the port states no other device's rates)."""
    from distributeddeeplearning_tpu_torch.utils.hardware import (
        device_name,
        peak_bf16_flops,
        peak_hbm_gbps,
    )

    peak = peak_bf16_flops(device)
    bw = peak_hbm_gbps(device)
    if peak is not None and bw is not None:
        return peak / 1e12, bw, f"device: {device_name(device)}"
    name = device_name(device)
    why = ("no card: no peaks are stated off the card" if name is None
           else f"no data-sheet peaks for {name!r} in utils.hardware.PEAKS")
    return None, None, why


def _time_decode(engine, steps: int = 5) -> float:
    """Steady-state decode wall (min over ``steps`` single steps; each ends
    in the step's own token readback).  Assumes the engine already ran
    decode (a scheduler run just drove it)."""
    tokens = np.ones(engine.batch_slots, np.int32)
    pos = np.full(engine.batch_slots, 1, np.int32)
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.decode(tokens, pos)
        walls.append(time.perf_counter() - t0)
    return min(walls)


def build_report(
    *,
    programs: Optional[ProgramCostRegistry] = None,
    ledger=None,
    measured_step_s: Optional[Dict[str, float]] = None,
    memory: bool = True,
    peak_tflops: Optional[float] = None,
    peak_hbm_gbps: Optional[float] = None,
    match_tolerance_pct: float = 1.0,
) -> Dict[str, Any]:
    """The attribution frame: per-program cost rows (+ achieved-vs-
    roofline for programs with a measured step time), the HBM ledger's
    reconciled snapshot, and the gate verdicts.  ``owner_match_pct`` is
    ``|live - owners' card bytes| / live``; without a live-bytes counter
    (off the card) it and the two ledger gates are None (module
    docstring)."""
    from distributeddeeplearning_tpu_torch.obs.ledger import get_ledger
    from distributeddeeplearning_tpu_torch.obs.registry import get_registry
    from distributeddeeplearning_tpu_torch.utils.roofline import program_roofline

    programs = programs if programs is not None else get_programs()
    ledger = ledger if ledger is not None else get_ledger()
    measured_step_s = measured_step_s or {}

    grouped = programs.collect(memory=memory, registry=get_registry())
    prog_block: Dict[str, Any] = {}
    for name, costs in sorted(grouped.items()):
        best = max(
            (c for c in costs if c.flops is not None),
            key=lambda c: c.flops, default=None,
        )
        row: Dict[str, Any] = {
            "signatures": len(costs),
            "flops": best.flops if best else None,
            "bytes_accessed": best.bytes_accessed if best else None,
            "argument_bytes": best.argument_bytes if best else None,
            "output_bytes": best.output_bytes if best else None,
            "temp_bytes": best.temp_bytes if best else None,
            "alias_bytes": best.alias_bytes if best else None,
            "available": best is not None,
            "errors": [c.error for c in costs if c.error],
        }
        step_s = measured_step_s.get(name)
        if (
            best is not None and step_s
            and best.flops is not None and best.bytes_accessed is not None
        ):
            row["roofline"] = program_roofline(
                best.flops, best.bytes_accessed, step_s,
                peak_tflops=peak_tflops, peak_hbm_gbps=peak_hbm_gbps,
            )
        prog_block[name] = row

    ledger_block = ledger.snapshot(reconcile=True)
    live = ledger_block.get("live_bytes")
    on_card = sum(b for dev, b in ledger_block.get("per_device_bytes", {}).items()
                  if dev.startswith("cuda"))
    match_pct = (abs(live - on_card) / live * 100.0 if live else None)
    gates = {
        "programs_covered": bool(prog_block) and all(
            row["available"] for row in prog_block.values()
        ),
        "owner_totals_match_live": (
            None if match_pct is None else match_pct <= match_tolerance_pct),
        "residual_under_limit": ledger_block.get("residual_under_limit"),
    }
    return {
        "programs": prog_block,
        "programs_covered": sum(
            1 for row in prog_block.values() if row["available"]
        ),
        "ledger": ledger_block,
        "owner_match_pct": None if match_pct is None else round(match_pct, 4),
        "owner_match_tolerance_pct": match_tolerance_pct,
        "unaccounted_hbm_pct": ledger_block.get("unaccounted_pct"),
        "gates": gates,
    }


def self_check(*, spec: bool = True, device=None) -> Tuple[bool, Dict[str, Any]]:
    """Build tiny dense + paged engines (and a speculative decoder) on
    ``device`` (the card unless the caller asks for the CPU), serve a few
    synthetic requests through the real scheduler, then check the
    attribution layer's own gates: every tracked program resolves a cost,
    the expected programs are present, and — where the ledger can read
    the live device bytes — the owner totals reconcile within the match
    tolerance and the unaccounted residual stays under its limit.

    The verdict is the conjunction of the MEASURED gates: a gate that is
    None (the two ledger gates off the card) is left out and named in
    ``report["not_measured"]``; it is never counted as passed.  Returns
    ``(ok, report)``."""
    from distributeddeeplearning_tpu_torch.models.pipelined_transformer import (
        init_params,
    )
    from distributeddeeplearning_tpu_torch.serve.engine import (
        InferenceEngine,
        PagedInferenceEngine,
    )
    from distributeddeeplearning_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler,
        synthetic_requests,
    )

    dims = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64,
                vocab_size=211)
    max_seq = 48
    params = init_params(torch.Generator().manual_seed(0), max_len=max_seq,
                         device="cpu", **dims)
    dense = InferenceEngine(
        params, num_heads=dims["num_heads"], batch_slots=2,
        max_seq=max_seq, device=device,
    )
    paged = PagedInferenceEngine(
        params, num_heads=dims["num_heads"], batch_slots=2,
        max_seq=max_seq, page_size=8, prefill_chunk=8, device=device,
    )
    reqs = synthetic_requests(
        4, vocab_size=dims["vocab_size"], max_prompt=12,
        rng=np.random.default_rng(0),
    )
    ContinuousBatchingScheduler(dense, max_new_tokens=4).run(list(reqs))
    ContinuousBatchingScheduler(paged, max_new_tokens=4).run(list(reqs))
    measured = {
        f"serve.dense.{dense.kv_dtype}.decode": _time_decode(dense),
        f"serve.paged.{paged.kv_dtype}.decode": _time_decode(paged),
    }
    if spec:
        from distributeddeeplearning_tpu_torch.spec.decode import (
            SpeculativeDecoder,
        )

        decoder = SpeculativeDecoder(
            paged, drafter="truncated", draft_tokens=2, draft_layers=1,
        )
        ContinuousBatchingScheduler(
            paged, max_new_tokens=4, spec_decoder=decoder,
        ).run(list(reqs))
    peak_tflops, peak_gbps, peaks_source = reference_peaks(dense.device)
    report = build_report(
        memory=True, measured_step_s=measured,
        peak_tflops=peak_tflops, peak_hbm_gbps=peak_gbps,
    )
    report["peaks_source"] = peaks_source
    expected = {
        "serve.dense.float32.prefill",
        "serve.dense.float32.decode",
        "serve.paged.float32.prefill_chunk",
        "serve.paged.float32.decode",
    }
    if spec:
        expected.add("spec.paged.verify")
    missing = sorted(expected - set(report["programs"]))
    report["expected_programs_missing"] = missing
    report["gates"]["expected_programs_present"] = not missing
    report["not_measured"] = sorted(
        k for k, v in report["gates"].items() if v is None)
    ok = all(v for v in report["gates"].values() if v is not None)
    return ok, report

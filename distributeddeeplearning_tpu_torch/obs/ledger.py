"""Live device-memory ledger: who owns every byte of device memory, now
(``obs/ledger.py``).

- **Owners register providers**: an engine registers its weights under
  ``"params"``, its KV pool under ``"kv_pages"`` (the int8 layout's scale
  leaves under ``"kv_scales"``), the trainer its ``"params"`` /
  ``"opt_state"`` / ``"batch_stats"``, a speculative drafter its
  ``"drafter_weights"``.  Providers are held through WEAK references: a
  dead engine drops out of the ledger instead of being kept alive by its
  own accounting.
- **Snapshots walk the real tensors**: a tensor costs the bytes of its
  storage, and a storage is charged ONCE (first registration wins), so
  two views of one pool, or a leaf two owners share, are not counted
  twice.  Totals are kept per owner and per device, with high-watermarks.
- **The unaccounted residual**: a reconciled snapshot compares the owner
  totals with the bytes the process has actually allocated on the card
  (``torch.cuda.memory_allocated()``); bytes no owner claims are how an
  OOM arrives undiagnosed (limit :data:`DEFAULT_RESIDUAL_LIMIT_PCT`).
  Without a card there is no such counter, and the snapshot says so with
  nulls instead of inventing a number.
- **forecast() is the admission hook**: predicted usage is each owner's
  COMMITTED bytes (the paged pool reports the pages in use, not its
  preallocated reservation) plus the candidate request's worst case; the
  serve scheduler consults it before admission.

Capacity defaults to the card's total memory
(``torch.cuda.get_device_properties``) and is None without a card — a
None capacity admits everything, so the hook costs one attribute check
where there is no budget.  Tests and callers set an explicit
``capacity_bytes`` to exercise the backpressure anywhere.

HOST owners (``register_host``: the KV tier's pinned page pool under
``kv_host_pages``) are attributed in every snapshot and gauge export but
never counted in :meth:`~HBMLedger.committed_bytes` or the forecast: host
memory is not device memory, and spilling must create device headroom.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

__all__ = [
    "HBMLedger",
    "get_ledger",
    "set_ledger",
    "array_device_bytes",
    "live_device_bytes",
    "DEFAULT_RESIDUAL_LIMIT_PCT",
]

#: unaccounted-bytes limit: bytes no owner claims may not exceed this
#: share of the process's allocated device bytes
DEFAULT_RESIDUAL_LIMIT_PCT = 5.0


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    QTensor's values and scales); other leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _storage_key(t: torch.Tensor):
    storage = t.untyped_storage()
    return (str(t.device), storage.data_ptr(), storage.nbytes())


def array_device_bytes(t: torch.Tensor) -> int:
    """Bytes ``t`` occupies where it lives: its storage's, so a view is
    charged the whole storage it keeps alive (the walk charges each
    storage once)."""
    try:
        return int(t.untyped_storage().nbytes())
    except Exception:  # noqa: BLE001 — a tensor without storage (meta)
        return 0


def live_device_bytes() -> Optional[int]:
    """Bytes the process has allocated on its CUDA devices
    (``torch.cuda.memory_allocated``, summed over the initialised
    devices) — the ground truth the owner totals are reconciled against.
    None without a card: there is no such counter on the host."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return sum(torch.cuda.memory_allocated(d)
               for d in range(torch.cuda.device_count()))


class _Provider:
    """One registered byte source: a weakly held target plus callables
    reading its current tensor tree and (optionally) its committed bytes.
    A dead weakref marks the entry prunable."""

    __slots__ = ("owner", "ref", "fn", "committed_fn", "handle")

    def __init__(self, owner: str, ref, fn, committed_fn, handle: int):
        self.owner = owner
        self.ref = ref
        self.fn = fn
        self.committed_fn = committed_fn
        self.handle = handle

    @property
    def dead(self) -> bool:
        return self.ref() is None


def _weak(target):
    """A weakref to ``target``, or a strong closure for targets that
    cannot be weakly referenced (plain dicts in tests: the caller owns
    that lifetime and unregisters)."""
    try:
        return weakref.ref(target)
    except TypeError:
        return lambda _t=target: _t


class HBMLedger:
    """Semantic-owner accounting over the process's device tensors."""

    def __init__(self, *, capacity_bytes: Optional[int] = None,
                 residual_limit_pct: float = DEFAULT_RESIDUAL_LIMIT_PCT):
        self._lock = threading.Lock()
        self._providers: List[_Provider] = []
        self._host_providers: List[_Provider] = []
        self._next_handle = 0
        self._capacity = capacity_bytes
        self._capacity_probed = capacity_bytes is not None
        self.residual_limit_pct = float(residual_limit_pct)
        # high-watermarks, updated on every snapshot()/forecast()
        self.watermarks: Dict[str, int] = {}
        self.host_watermarks: Dict[str, int] = {}
        self.peak_total_bytes = 0
        self.peak_committed_bytes = 0

    # -- registration ------------------------------------------------------
    def _add(self, kind: str, owner, target, provider, committed) -> int:
        """Append a provider to the list named ``kind`` (read under the
        lock: a walk may have replaced the list since)."""
        ref = _weak(target)

        def fn():
            obj = ref()
            return None if obj is None else provider(obj)

        committed_fn = None
        if committed is not None:
            def committed_fn():  # noqa: E306
                obj = ref()
                return None if obj is None else committed(obj)

        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            getattr(self, kind).append(
                _Provider(owner, ref, fn, committed_fn, handle))
            return handle

    def register(self, owner: str, target: Any,
                 provider: Callable[[Any], Any], *,
                 committed: Optional[Callable[[Any], int]] = None) -> int:
        """Register ``target``'s tensors under ``owner``.  ``provider(
        target)`` returns the CURRENT tensor tree (called at snapshot time,
        so a live reload is seen); ``committed(target)`` optionally returns
        the bytes committed to work (the paged pool: pages in use times
        bytes a page).  ``target`` is held weakly.  Returns a handle for
        :meth:`unregister`."""
        return self._add("_providers", owner, target, provider, committed)

    def register_host(self, owner: str, target: Any,
                      bytes_fn: Callable[[Any], int]) -> int:
        """Register a HOST-memory byte source (``bytes_fn(target)`` is its
        committed host bytes): in snapshots and gauges, never in
        :meth:`committed_bytes` or :meth:`forecast`."""
        return self._add("_host_providers", owner, target, bytes_fn, None)

    def unregister(self, handle: int) -> None:
        with self._lock:
            self._providers = [p for p in self._providers if p.handle != handle]
            self._host_providers = [p for p in self._host_providers
                                    if p.handle != handle]

    def owners(self) -> List[str]:
        with self._lock:
            return sorted({p.owner for p in self._providers})

    def host_owners(self) -> List[str]:
        with self._lock:
            return sorted({p.owner for p in self._host_providers})

    def _walk_host(self) -> Dict[str, int]:
        with self._lock:
            self._host_providers = [p for p in self._host_providers if not p.dead]
            providers = list(self._host_providers)
        out: Dict[str, int] = {}
        for p in providers:
            b = p.fn()
            out[p.owner] = out.get(p.owner, 0) + (int(b) if b is not None else 0)
        return out

    # -- capacity ----------------------------------------------------------
    def set_capacity(self, capacity_bytes: Optional[int]) -> None:
        self._capacity = capacity_bytes
        self._capacity_probed = True

    @property
    def capacity_bytes(self) -> Optional[int]:
        """The card's total memory, or the configured value; None without
        a card (forecasts then always admit)."""
        if not self._capacity_probed:
            self._capacity_probed = True
            try:
                if torch.cuda.is_available():
                    self._capacity = int(
                        torch.cuda.get_device_properties(0).total_memory)
            except Exception:  # noqa: BLE001 — no budget rather than a crash
                self._capacity = None
        return self._capacity

    # -- accounting --------------------------------------------------------
    def _walk(self):
        """(owner_bytes, owner_committed, per_device) over every live
        provider; a storage claimed twice counts ONCE (first registration
        wins)."""
        with self._lock:
            self._providers = [p for p in self._providers if not p.dead]
            providers = list(self._providers)
        owner_bytes: Dict[str, int] = {}
        owner_committed: Dict[str, int] = {}
        per_device: Dict[str, int] = {}
        seen: set = set()
        for p in providers:
            tree = p.fn()
            if tree is None:
                continue
            total = 0
            for t in _tensors(tree):
                key = _storage_key(t)
                if key in seen:
                    continue
                seen.add(key)
                b = array_device_bytes(t)
                total += b
                per_device[key[0]] = per_device.get(key[0], 0) + b
            owner_bytes[p.owner] = owner_bytes.get(p.owner, 0) + total
            if p.committed_fn is not None:
                c = p.committed_fn()
                total = int(c) if c is not None else 0
            owner_committed[p.owner] = owner_committed.get(p.owner, 0) + total
        return owner_bytes, owner_committed, per_device

    def committed_bytes(self) -> int:
        """Sum of every owner's committed bytes — the demand side the
        forecast prices admission against."""
        _, owner_committed, _ = self._walk()
        return sum(owner_committed.values())

    def snapshot(self, *, reconcile: bool = True) -> Dict[str, Any]:
        """One JSON-ready frame: per-owner bytes, committed bytes and
        watermarks, per-device totals, the host owners, and (with
        ``reconcile``) the unaccounted residual against the allocated
        device bytes — nulls where there is no counter to read."""
        owner_bytes, owner_committed, per_device = self._walk()
        total = sum(owner_bytes.values())
        committed = sum(owner_committed.values())
        for owner, b in owner_bytes.items():
            if b > self.watermarks.get(owner, 0):
                self.watermarks[owner] = b
        self.peak_total_bytes = max(self.peak_total_bytes, total)
        self.peak_committed_bytes = max(self.peak_committed_bytes, committed)
        host_bytes = self._walk_host()
        for owner, b in host_bytes.items():
            if b > self.host_watermarks.get(owner, 0):
                self.host_watermarks[owner] = b
        out: Dict[str, Any] = {
            "owners": {
                owner: {
                    "bytes": owner_bytes[owner],
                    "committed_bytes": owner_committed.get(owner, 0),
                    "peak_bytes": self.watermarks.get(owner, 0),
                }
                for owner in sorted(owner_bytes)
            },
            "total_bytes": total,
            "committed_total_bytes": committed,
            "peak_total_bytes": self.peak_total_bytes,
            "per_device_bytes": dict(sorted(per_device.items())),
            "capacity_bytes": self.capacity_bytes,
            "residual_limit_pct": self.residual_limit_pct,
            "host_owners": {
                owner: {"bytes": host_bytes[owner],
                        "peak_bytes": self.host_watermarks.get(owner, 0)}
                for owner in sorted(host_bytes)
            },
            "host_total_bytes": sum(host_bytes.values()),
        }
        if reconcile:
            live = live_device_bytes()
            if live is None:
                out.update(live_bytes=None, unaccounted_bytes=None,
                           unaccounted_pct=None, residual_under_limit=None)
            else:
                # only the owners' card bytes reconcile against the card
                on_card = sum(b for dev, b in per_device.items()
                              if dev.startswith("cuda"))
                unaccounted = max(0, live - on_card)
                pct = round(unaccounted / live * 100.0, 4) if live else 0.0
                out.update(live_bytes=live, unaccounted_bytes=unaccounted,
                           unaccounted_pct=pct,
                           residual_under_limit=pct <= self.residual_limit_pct)
        return out

    # -- admission forecast ------------------------------------------------
    def forecast(self, extra_bytes: int, *,
                 committed: Optional[int] = None) -> Dict[str, Any]:
        """Predicted device position after admitting ``extra_bytes`` more
        committed demand: ``predicted = committed_now + extra``,
        ``headroom = capacity - predicted``; ``admit`` is the verdict.
        With no capacity the forecast admits.  ``committed`` lets the
        admission loop walk the providers once per scheduler iteration."""
        capacity = self.capacity_bytes
        if capacity is None:
            return {"capacity_bytes": None, "predicted_bytes": None,
                    "headroom_bytes": None, "admit": True}
        if committed is None:
            committed = self.committed_bytes()
        self.peak_committed_bytes = max(self.peak_committed_bytes, committed)
        predicted = committed + int(extra_bytes)
        headroom = capacity - predicted
        return {"capacity_bytes": capacity, "committed_bytes": committed,
                "predicted_bytes": predicted, "headroom_bytes": headroom,
                "admit": headroom >= 0}

    def admit_ok(self, extra_bytes: int, *,
                 committed: Optional[int] = None) -> bool:
        """Fast-path verdict for the admission loop: one attribute check
        when no capacity is configured."""
        if self._capacity_probed and self._capacity is None:
            return True
        return bool(self.forecast(extra_bytes, committed=committed)["admit"])

    # -- metrics export ----------------------------------------------------
    def export_gauges(self, registry) -> None:
        """Publish the current frame as ``hbm.*`` gauges on ``registry``
        (without the reconciliation)."""
        snap = self.snapshot(reconcile=False)
        for owner, row in snap["owners"].items():
            registry.gauge(f"hbm.{owner}.bytes").set(row["bytes"])
            registry.gauge(f"hbm.{owner}.committed_bytes").set(row["committed_bytes"])
            registry.gauge(f"hbm.{owner}.peak_bytes").set(row["peak_bytes"])
        registry.gauge("hbm.total_bytes").set(snap["total_bytes"])
        registry.gauge("hbm.peak_total_bytes").set(snap["peak_total_bytes"])
        registry.gauge("hbm.committed_total_bytes").set(snap["committed_total_bytes"])
        for owner, row in snap["host_owners"].items():
            registry.gauge(f"hbm.{owner}.bytes").set(row["bytes"])
            registry.gauge(f"hbm.{owner}.peak_bytes").set(row["peak_bytes"])
        registry.gauge("hbm.host_total_bytes").set(snap["host_total_bytes"])


# -- process-global ledger --------------------------------------------------

_LEDGER = HBMLedger()


def get_ledger() -> HBMLedger:
    """The process's ledger: engines, drafters and trainers register their
    owners into it at construction; the serve scheduler's admission
    forecast and the flight recorder's dumps read it."""
    return _LEDGER


def set_ledger(ledger: HBMLedger) -> HBMLedger:
    global _LEDGER
    _LEDGER = ledger
    return ledger


# every flight-recorder dump carries the latest ledger frame
from distributeddeeplearning_tpu_torch.obs import recorder as _recorder_mod  # noqa: E402


def _dump_context() -> Dict[str, Any]:
    return get_ledger().snapshot(reconcile=False)


_recorder_mod.register_dump_context("hbm_ledger", _dump_context)

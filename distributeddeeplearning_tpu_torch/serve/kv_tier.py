"""Host-memory page tier beneath the paged KV cache (``serve/kv_tier.py``).

A cold prefix page has three places to live: resident in the pool, gone
(the next session over that prefix re-prefills it), or here, in a
**pinned host pool sized in pages**:

- **spill** (:meth:`HostPageTier.spill_in`) copies a page's leaves to
  the host: ``k`` and ``v`` and, on the int8 layout, their f32 scale
  leaves — the raw pool bytes, so an int8 page moves about a quarter of
  an f32 page.  The copy is blocking: the tier's ONE designed sync, of a
  page whose bytes are stable (reclaimable, or a preempted slot's page
  after its last decode step);
- **restore** (:meth:`HostPageTier.dispatch_restore`) copies the page
  back with ``non_blocking=True`` on a CUDA stream of the tier's own into
  a fresh device staging buffer and records a ``torch.cuda.Event`` after
  it.  The engine makes its compute stream wait on that event before it
  writes the staging buffer into the pool page, so every later kernel
  that reads the page is ordered after the copy, while the host never
  waits; :meth:`poll` retires restores whose event has completed and
  :meth:`drain` synchronises on them;
- **restores are exact**: spill and restore move raw bytes (no
  requantization, no recompute), so a restored page equals the spilled
  one bit for bit, scale leaves included.

Host slot lifecycle: a spilled key holds its slot until it is restored —
and the slot is freed only once the restore's event has COMPLETED
(freeing it at dispatch would let a later spill overwrite host bytes the
copy engine may still be reading) — or until LRU pressure in the host
pool drops it (the caller un-registers the key so the next miss
re-prefills).

On the CPU the copies are synchronous and there are no streams or
events: a restore is landed the moment it returns, and retires at the
next :meth:`poll`.

The tier owns host memory and the key -> slot map; the
:class:`~.kv_cache.PageAllocator` owns which keys are resident, host or
gone, and the engine commits restored pages into the pool.  The engine
registers the pool's used bytes under the ``kv_host_pages`` HOST owner
of the ledger (``obs/ledger.py``): attributed, never in the forecast.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["HostPageTier", "TIER_POLICIES"]

#: host-pool replacement policies: ``lru`` touches a key on every hit so
#: long-lived prefixes survive churn; ``fifo`` drops in spill order
TIER_POLICIES = ("lru", "fifo")


class HostPageTier:
    """Pinned host pool of KV pages plus the in-flight restore ledger.

    ``cache`` supplies the leaf layout (names, page dims, dtypes); the pool
    is one block per leaf of ``host_pages`` page rows, allocated once and
    pinned when the cache lives on a card, so steady-state serving never
    allocates host memory.
    """

    def __init__(self, cache, host_pages: int, *, policy: str = "lru"):
        if host_pages < 1:
            raise ValueError(f"host_pages must be >= 1, got {host_pages}")
        if policy not in TIER_POLICIES:
            raise ValueError(
                f"unknown tier policy {policy!r}; pick from {TIER_POLICIES}")
        self.host_pages = host_pages
        self.policy = policy
        self.device = next(iter(cache.values())).device
        on_card = self.device.type == "cuda"
        # one host mirror per pool leaf, page dims preserved: values AND
        # the int8 layout's scales (values without scales decode garbage)
        self._pool: Dict[str, torch.Tensor] = {
            name: torch.empty((host_pages,) + tuple(leaf.shape[1:]),
                              dtype=leaf.dtype, pin_memory=on_card)
            for name, leaf in cache.items()
        }
        # the restores' copy stream, made on first use
        self._stream = None
        self._free: List[int] = list(range(host_pages - 1, -1, -1))
        # key -> host slot, least recently used first
        self._slots: "OrderedDict[Any, int]" = OrderedDict()
        # key -> (slot, completion event or None on the CPU): the slot
        # stays pinned until the restore's copy has landed
        self._inflight: Dict[Any, Tuple[int, Optional[Any]]] = {}
        self.spilled_pages = 0
        self.restored_pages = 0
        self.dropped_pages = 0
        self.host_pages_peak = 0

    # -- accounting --------------------------------------------------------
    @property
    def page_host_bytes(self) -> int:
        """Host bytes of ONE page over every leaf (the tier's granule)."""
        return sum(t.numel() // t.shape[0] * t.element_size()
                   for t in self._pool.values())

    @property
    def used_pages(self) -> int:
        """Host slots holding live bytes (resident + restore in flight)."""
        return len(self._slots) + len(self._inflight)

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def capacity_bytes(self) -> int:
        return self.host_pages * self.page_host_bytes

    def used_bytes(self) -> int:
        """Host bytes committed to spilled pages — what the
        ``kv_host_pages`` ledger owner attributes."""
        return self.used_pages * self.page_host_bytes

    def has(self, key) -> bool:
        return key in self._slots

    # -- spill (device -> host) -------------------------------------------
    def spill_in(self, cache, key, page: int) -> Optional[List[Any]]:
        """Copy ``page``'s leaves of the pool into a host slot under
        ``key`` (blocking: ordered after every kernel queued on the
        current stream, so the page's last writes are in).  Returns the
        keys the host LRU evicted to make room (the caller un-registers
        them), or None when every slot is pinned by an in-flight restore —
        nothing was copied or evicted.  The caller guarantees the page's
        bytes are stable: no decode lane writes it this iteration."""
        if key in self._slots:  # already host-resident: the same bytes
            return []
        evicted: List[Any] = []
        if not self._free:
            if not self._slots:
                return None
            old_key, old_slot = self._slots.popitem(last=False)
            self._free.append(old_slot)
            self.dropped_pages += 1
            evicted.append(old_key)
        slot = self._free.pop()
        for name, host in self._pool.items():
            host[slot].copy_(cache[name][page])  # the tier's one designed sync
        self._slots[key] = slot
        self.spilled_pages += 1
        self.host_pages_peak = max(self.host_pages_peak, self.used_pages)
        return evicted

    # -- restore (host -> device) -----------------------------------------
    def dispatch_restore(self, key) -> Dict[str, torch.Tensor]:
        """Start the copy of ``key``'s page to the device and return its
        per-leaf device tensors for the engine to commit into the pool.

        On a card the copy runs on the tier's stream into buffers made on
        that stream; the current (compute) stream is made to wait on the
        copy's event, and the buffers are recorded as used by it, so the
        engine's pool write and every later read order after the copy
        without a host wait.  The host slot stays pinned in the in-flight
        ledger until :meth:`poll` sees the event complete."""
        slot = self._slots.pop(key)
        if self.device.type != "cuda":
            dev = {name: host[slot].clone() for name, host in self._pool.items()}
            self._inflight[key] = (slot, None)
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                dev = {name: host[slot].to(self.device, non_blocking=True)
                       for name, host in self._pool.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
            compute.wait_event(event)
            for t in dev.values():
                t.record_stream(compute)
            self._inflight[key] = (slot, event)
        self.restored_pages += 1
        return dev

    def poll(self) -> int:
        """Retire restores whose copy has landed (freeing their host
        slots); returns how many are STILL in flight."""
        landed = [key for key, (_, ev) in self._inflight.items()
                  if ev is None or ev.query()]
        for key in landed:
            slot, _ = self._inflight.pop(key)
            self._free.append(slot)
        return len(self._inflight)

    def drain(self) -> None:
        """Block until every in-flight restore has landed, then retire
        them (the admission gate's fence)."""
        for _, ev in self._inflight.values():
            if ev is not None:
                ev.synchronize()
        self.poll()

    # -- lifecycle ---------------------------------------------------------
    def touch(self, key) -> None:
        """LRU-touch ``key``; the fifo policy keeps spill order."""
        if self.policy == "lru" and key in self._slots:
            self._slots.move_to_end(key)

    def drop(self, key) -> None:
        """Free ``key``'s host slot (caller-side eviction)."""
        slot = self._slots.pop(key)
        self._free.append(slot)
        self.dropped_pages += 1

    def clear(self) -> None:
        """Release every slot (paired with the allocator's
        ``clear_prefix``); drains in-flight restores first — freeing a
        slot under an active copy is the bug the in-flight ledger exists
        to prevent."""
        self.drain()
        for key in list(self._slots):
            self.drop(key)

    def reset_stats(self) -> None:
        """Zero the run counters; slots and in-flight restores stay."""
        self.spilled_pages = 0
        self.restored_pages = 0
        self.dropped_pages = 0
        self.host_pages_peak = 0

    def check(self) -> None:
        """Tier invariants (a test hook): slots partition exactly into
        free / resident / in flight."""
        resident = set(self._slots.values())
        free = set(self._free)
        pinned = {slot for slot, _ in self._inflight.values()}
        assert len(free) == len(self._free), "duplicate free host slot"
        assert not (resident & free), "host slot both resident and free"
        assert not (resident & pinned), "host slot both resident and pinned"
        assert not (free & pinned), "host slot both free and pinned"
        assert resident | free | pinned == set(range(self.host_pages)), \
            "host slot leaked"

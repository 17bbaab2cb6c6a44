"""KV caches of the serving engines (``serve/kv_cache.py``): the dense
slot-indexed cache, the paged pool and its host-side allocator.

Dense layout: ``k, v: [batch_slots, n_layers, max_seq, n_heads,
head_dim]``, slot-major, allocated once and updated IN PLACE — where the
reference donated the buffers to each jitted touch, the port writes into
them.  Sequence lengths are not device state: the scheduler owns per-slot
positions and passes them into every decode step.

Paged layout: one pool ``k, v: [num_pages + 1, n_layers, page_size,
n_heads, head_dim]`` with page 0 a scratch page (:data:`SCRATCH_PAGE`), and
per slot a host-side block table of page ids: logical position ``j`` of a
slot lives at ``(table[j // page_size], j % page_size)``.  HBM is paid per
token, not per ``max_seq``, and identical prompt prefixes share pages
(:class:`PageAllocator`).

Both layouts hold float32, bfloat16 (the engines' default under bf16
weights: half the bytes, no quantization error beyond the weights' own
dtype) or int8: values int8 plus f32 scale leaves ``{"k_scale",
"v_scale"}`` of the values' shape without the head dim — one scale per
stored K/V vector (:mod:`..quant.qtensor`), so every write quantizes on
its own and nothing is ever requantized.  Writes cast to the cache's
dtype.

Under tensor parallelism (``mesh=`` with a ``tensor`` axis above 1) each
rank allocates its slice of the layout :func:`cache_sharding` resolves
through the rule table: its ``h / tp`` heads of the dense ``[slots, L,
S, h, hd]`` or paged ``[pages + 1, L, page_size, h, hd]`` leaves, and of
the int8 scale leaves to match.  The page axis never splits: every rank
holds every page, and the host's block tables address all of them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch

from distributeddeeplearning_tpu_torch._device import DeviceLike, resolve_device
from distributeddeeplearning_tpu_torch.quant.qtensor import (
    quantize_kv,
    quantized_cache,
)

Cache = Dict[str, torch.Tensor]

#: Page id 0 is a reserved scratch page: released, inactive and mid-prefill
#: decode lanes and out-of-range block-table entries point at it, so their
#: (masked, ignored) K/V writes never touch a live sequence's pages.
SCRATCH_PAGE = 0


#: the KV cache dtypes both layouts take
CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def cache_sharding(mesh, *, quantized: bool = False, layout: str = "dense"):
    """``{leaf: spec}`` of a cache under ``mesh``, resolved through the
    partition-rule layout table (``parallel.sharding.LAYOUT_RULES``).
    Dense: slots over the data axes, heads over ``tensor``; paged: the
    page axis stays whole and only heads split.  The int8 layouts' scale
    leaves split alike (the same dims without the head dim)."""
    from distributeddeeplearning_tpu_torch.parallel import sharding

    if layout not in ("dense", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    names = dict.fromkeys(("k", "v", "k_scale", "v_scale") if quantized
                          else ("k", "v"))
    specs = sharding.match_partition_rules(names, prefix=f"kv_{layout}", mesh=mesh)
    return {name.split("/", 1)[1]: spec for name, spec in specs.items()}


def _zeros(shape, dtype: torch.dtype, dev: torch.device, mesh=None,
           layout: str = "dense") -> Cache:
    if dtype not in CACHE_DTYPES:
        raise ValueError(
            f"KV cache dtype {dtype}: float32, bfloat16 or int8")
    shapes = {"k": shape, "v": shape}
    if dtype == torch.int8:
        shapes.update(k_scale=shape[:-1], v_scale=shape[:-1])
    if mesh is not None:
        from distributeddeeplearning_tpu_torch.parallel import sharding

        specs = cache_sharding(mesh, quantized=dtype == torch.int8, layout=layout)
        shapes = {name: sharding.local_shape(full, specs[name], mesh)
                  for name, full in shapes.items()}
    return {name: torch.zeros(s, dtype=torch.float32 if name.endswith("_scale")
                              else dtype, device=dev)
            for name, s in shapes.items()}


def init_cache(
    *,
    batch_slots: int,
    num_layers: int,
    max_seq: int,
    num_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    mesh=None,
) -> Cache:
    """Zero-filled dense cache ``{"k", "v"}``, each [slots, L, S, h, hd]
    in ``dtype`` (plus ``{"k_scale", "v_scale"}`` [slots, L, S, h] f32 for
    int8); with a ``mesh``, this rank's slice of it (module docstring).
    Zeros are never read: the decode position mask hides every position
    above a slot's length, and admission overwrites from 0."""
    dev = resolve_device(device)
    return _zeros((batch_slots, num_layers, max_seq, num_heads, head_dim),
                  dtype, dev, mesh, "dense")


def insert_sequence(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                    slot: int) -> Cache:
    """Write one prefilled prompt's K/V into ``slot``, positions [0, P),
    in place.  ``k``/``v``: [1, L, P, h, hd] (or [L, P, h, hd]) from
    ``forward_prefill``; P may be the padded prompt bucket — the padding
    lands above the slot's length and stays masked.  An int8 cache
    quantizes here (the prefill pass itself runs in the weights' dtype);
    the others take the values cast to their dtype.  Returns ``cache``."""
    if k.dim() == 5:
        k, v = k[0], v[0]
    p = k.shape[1]
    if quantized_cache(cache):
        for name, x in (("k", k), ("v", v)):
            q, s = quantize_kv(x)
            cache[name][slot, :, :p].copy_(q)
            cache[f"{name}_scale"][slot, :, :p].copy_(s)
        return cache
    cache["k"][slot, :, :p].copy_(k)
    cache["v"][slot, :, :p].copy_(v)
    return cache


def cache_bytes(cache: Cache) -> int:
    """Total cache footprint in bytes, over every leaf (scales included)."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def init_paged_cache(
    *,
    num_pages: int,
    num_layers: int,
    page_size: int,
    num_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    mesh=None,
) -> Cache:
    """Zero-filled page pool ``{"k", "v"}``, each [pages, L, page_size, h,
    hd] in ``dtype`` (plus ``{"k_scale", "v_scale"}`` [pages, L, page_size,
    h] f32 for int8); with a ``mesh``, this rank's heads of it.
    ``num_pages`` counts USABLE pages; the scratch page (id 0) is
    prepended.  Page-major, so a page is one leading-dim slice."""
    if num_pages < 1:
        raise ValueError(f"num_pages must be >= 1, got {num_pages}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    dev = resolve_device(device)
    return _zeros((num_pages + 1, num_layers, page_size, num_heads, head_dim),
                  dtype, dev, mesh, "paged")


def page_bytes(cache: Cache) -> int:
    """Bytes of ONE page over every pool leaf and layer — the granule the
    allocator hands out (``cache_bytes == (num_pages + 1) * page_bytes``);
    an int8 page is charged its scales too."""
    return sum(t.numel() // t.shape[0] * t.element_size()
               for t in cache.values())


def pages_for(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` positions (ceil division)."""
    return -(-tokens // page_size)


class OutOfPages(RuntimeError):
    """Page pool exhausted — the admission-backpressure signal: the
    scheduler waits for completions to free pages, unless the request can
    never fit the pool."""


class PageAllocator:
    """Host-side bookkeeping of the page pool: free list, refcounts and a
    prefix table of reusable immutable pages.

    A page is **free** (on the free list, contents meaningless), **live**
    (refcount >= 1, in one or more block tables; a page shared through the
    prefix table is live in several) or **reclaimable** (refcount 0 but
    still named by the prefix table, kept in LRU order: a lookup
    resurrects it, allocation pressure evicts it).

    A prefix key names the FULL token history through the end of its page
    (the engine uses ``tuple(prompt[: (i + 1) * page_size])``), so a hit
    holds exactly the K/V prefill would compute for those tokens.

    With a host tier (``serve/kv_tier.py``) a key may also live in host
    memory only: ``tier_state(key)`` is ``"resident"`` (an HBM page, live
    or reclaimable), ``"host"`` or None.  The evict hook
    (:meth:`set_evict_hook`) demotes a page ``alloc`` recycles instead of
    forgetting it; ``spill_prefix`` / ``host_prefix`` / ``restore_prefix``
    / ``drop_host`` move keys between the tiers.

    The same sequence of calls hands out the same page ids as the
    reference's allocator.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        # page ids 1..num_pages (0 is the scratch page, never allocated)
        self._free: List[int] = list(range(num_pages, 0, -1))
        self._rc: Dict[int, int] = {}
        self._prefix: Dict[Any, int] = {}
        self._page_key: Dict[int, Any] = {}
        self._reclaim: "OrderedDict[int, None]" = OrderedDict()
        # keys answered from the host tier only (no HBM page)
        self._host: "OrderedDict[Any, None]" = OrderedDict()
        # alloc-pressure demotion hook: hook(key, page) is called BEFORE
        # an evicted reclaimable page is handed out (its bytes are still
        # valid); True keeps the key answerable from the host tier
        self._evict_hook = None

    @property
    def available(self) -> int:
        """Pages an ``alloc`` could hand out now (free + evictable)."""
        return len(self._free) + len(self._reclaim)

    @property
    def pages_in_use(self) -> int:
        """Live pages (refcount >= 1)."""
        return self.num_pages - self.available

    @property
    def free_pages(self) -> int:
        """Pages on the free list proper — the spill pump's cushion: when
        it runs low the next alloc evicts reclaimable prefix pages."""
        return len(self._free)

    @property
    def reclaimable_pages(self) -> int:
        """Refcount-0 pages still answering prefix hits — the spill pump's
        candidates."""
        return len(self._reclaim)

    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` pages at refcount 1, evicting LRU reclaimable
        prefix pages as needed.  Raises :class:`OutOfPages`, allocating
        nothing, when fewer than ``n`` are available."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if n > self.available:
            raise OutOfPages(
                f"need {n} pages, {self.available} available "
                f"({self.pages_in_use}/{self.num_pages} live)"
            )
        out: List[int] = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:  # evict the least recently used cached prefix page
                page, _ = self._reclaim.popitem(last=False)
                key = self._page_key.pop(page)
                del self._prefix[key]
                # demote instead of forget when a host tier is attached:
                # the page's bytes stay valid until its new owner writes
                if self._evict_hook is not None and self._evict_hook(key, page):
                    self._host[key] = None
            self._rc[page] = 1
            out.append(page)
        return out

    def set_evict_hook(self, hook) -> None:
        """Install the alloc-pressure demotion hook; None detaches it."""
        self._evict_hook = hook

    def incref(self, page: int) -> None:
        rc = self._rc.get(page, 0)
        if rc == 0:
            if page not in self._reclaim:
                raise ValueError(f"incref on non-live page {page}")
            del self._reclaim[page]  # resurrected from the prefix table
        self._rc[page] = rc + 1

    def decref(self, page: int) -> None:
        rc = self._rc.get(page, 0)
        if rc < 1:
            raise ValueError(f"decref on non-live page {page}")
        if rc > 1:
            self._rc[page] = rc - 1
            return
        del self._rc[page]
        if page in self._page_key:
            # still named by the prefix table: its contents stay for
            # future hits until allocation pressure evicts it
            self._reclaim[page] = None
        else:
            self._free.append(page)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def is_shared(self, page: int) -> bool:
        """True when writing this page could corrupt state beyond one slot:
        more than one block table maps it, or the prefix table publishes
        it.  Shared pages are immutable; scrub refuses them."""
        return self._rc.get(page, 0) > 1 or page in self._page_key

    def lookup_prefix(self, key) -> Optional[int]:
        """Page holding ``key``'s chunk, or None.  Does NOT incref (the
        caller takes the reference) but marks the page recently used."""
        page = self._prefix.get(key)
        if page is not None and page in self._reclaim:
            self._reclaim.move_to_end(page)
        return page

    def register_prefix(self, key, page: int) -> None:
        """Publish a live, fully written page for reuse.  The first writer
        of a key wins: both copies hold the same K/V, so dropping the
        second registration only forgoes a dedup."""
        if self._rc.get(page, 0) < 1:
            raise ValueError(f"cannot register non-live page {page}")
        if key in self._prefix or page in self._page_key:
            return
        self._prefix[key] = page
        self._page_key[page] = key

    def clear_prefix(self) -> None:
        """Drop every prefix entry; reclaimable pages return to the free
        list (a warm-up must not seed a timed run)."""
        for page in list(self._reclaim):
            del self._prefix[self._page_key.pop(page)]
            self._free.append(page)
        self._reclaim.clear()
        for page in list(self._page_key):  # live pages: unregister only
            del self._prefix[self._page_key.pop(page)]
        # host keys too: the caller releases their host slots
        # (HostPageTier.clear)
        self._host.clear()

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    # -- host tier ---------------------------------------------------------
    def tier_state(self, key) -> Optional[str]:
        """``"resident"`` (an HBM page, live or reclaimable), ``"host"``
        (host pool only) or None (prefill must recompute it)."""
        if key in self._prefix:
            return "resident"
        if key in self._host:
            return "host"
        return None

    def spill_prefix(self, key) -> int:
        """Demote a RECLAIMABLE prefix page to the host tier: the page
        returns to the free list and the key is answered from host.
        Returns the freed page id.  The caller has already copied the
        page's leaves to the host.  Only refcount-0 pages spill: a live
        page is mapped by a block table a decode step may read."""
        page = self._prefix.get(key)
        if page is None:
            raise ValueError(f"spill of unregistered prefix key {key!r}")
        if page not in self._reclaim:
            raise ValueError(
                f"page {page} is live (rc={self._rc.get(page, 0)}); "
                "only reclaimable pages may spill")
        del self._reclaim[page]
        del self._prefix[key]
        del self._page_key[page]
        self._free.append(page)
        self._host[key] = None
        return page

    def host_prefix(self, key) -> None:
        """Record ``key`` as host-resident without it ever having been in
        the prefix table (a preempted slot's private pages)."""
        if key in self._prefix:
            raise ValueError(f"key {key!r} already resident")
        self._host[key] = None

    def restore_prefix(self, key, page: int) -> None:
        """Promote a host key back to resident into ``page``, a live page
        the caller has filled with the key's host bytes."""
        if key not in self._host:
            raise ValueError(f"restore of non-host key {key!r}")
        if self._rc.get(page, 0) < 1:
            raise ValueError(f"cannot restore into non-live page {page}")
        del self._host[key]
        self.register_prefix(key, page)

    def drop_host(self, key) -> None:
        """Forget a host key (the host pool dropped its bytes)."""
        del self._host[key]

    def coldest_reclaimable(self, n: int) -> List[tuple]:
        """Up to ``n`` least-recently-used ``(key, page)`` spill
        candidates: refcount-0 pages still named by the prefix table, the
        set whose bytes are stable.  Live pages never appear."""
        out: List[tuple] = []
        for page in self._reclaim:
            if len(out) >= n:
                break
            out.append((self._page_key[page], page))
        return out

    @property
    def host_entries(self) -> int:
        return len(self._host)

    def check(self) -> None:
        """Assert the allocator's invariants (a test hook)."""
        live = set(self._rc)
        free = set(self._free)
        reclaim = set(self._reclaim)
        assert not (live & free), "page both live and free"
        assert not (live & reclaim), "page both live and reclaimable"
        assert not (free & reclaim), "page both free and reclaimable"
        assert len(free) == len(self._free), "duplicate free-list entry"
        assert live | free | reclaim == set(range(1, self.num_pages + 1)), \
            "page leaked (not live, free, or reclaimable)"
        assert all(rc >= 1 for rc in self._rc.values())
        assert reclaim <= set(self._page_key), "reclaimable page unnamed"
        for key, page in self._prefix.items():
            assert self._page_key.get(page) == key, "prefix maps diverged"
        # a prefix entry must name a page that still holds its bytes
        prefix_pages = set(self._page_key)
        assert not (prefix_pages & free), "prefix entry names a freed page"
        assert prefix_pages <= live | reclaim, \
            "prefix entry names an untracked page"
        # a key answered from both tiers would let restore and resident
        # reads race
        assert not (set(self._host) & set(self._prefix)), \
            "prefix key both resident and host"


def insert_pages(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                 page_ids: torch.Tensor, *, page_size: int) -> Cache:
    """Write a prefilled prompt's K/V ([L, P, h, hd], P a multiple of
    ``page_size``; or [1, L, P, h, hd]) into the pool pages ``page_ids``,
    in place — the paged counterpart of :func:`insert_sequence` for
    one-shot inserts (the engine's chunked prefill writes its pages inside
    the chunk pass instead).  An int8 pool quantizes on the way in."""
    if k.dim() == 5:
        k, v = k[0], v[0]
    L, P, h, hd = k.shape
    n = P // page_size
    idx = page_ids.to(device=cache["k"].device, dtype=torch.long)
    for name, x in (("k", k), ("v", v)):
        paged = x.reshape(L, n, page_size, h, hd).transpose(0, 1)
        if quantized_cache(cache):
            q, s = quantize_kv(paged)
            cache[name][idx] = q
            cache[f"{name}_scale"][idx] = s
        else:
            cache[name][idx] = paged.to(cache[name].dtype)
    return cache

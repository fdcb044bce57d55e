"""Device-resident feature-page pool (the compile layer's warm path).

The megabatch programs consume *feature pages*: one (N_pad, P_pad)
zero-padded copy of a request's X matrix per bucket shape.  Without a pool
the pages are stacked on the host and uploaded with every launch; for
steady serving (the same datasets estimated over and over) that round
trip is pure waste.

``PagePool`` keeps pages resident on the device across drains:

  * a page is a tensor of shape ``(1, N_pad, P_pad)`` on the pool's
    ``device``, keyed by ``(data fingerprint, N_pad, P_pad)`` — pure value
    identity, like the ``ProgramCache``, so repeat traffic (same dataset
    content, any request object) hits without a transfer;
  * a miss uploads the page once, through pinned staging and a
    ``non_blocking`` copy (``upload``): nothing here synchronises;
  * a multi-page launch gets its (D, N_pad, P_pad) stack assembled on the
    device with ``torch.cat`` (resident pages, zero pages up to the
    pow2-bucketed D), and the stack is cached by its lane composition, so
    a warm repeat of the composition gets **the same tensor object**
    back: a warm drain performs zero transfers and zero copies;
  * an LRU byte budget bounds device residency of pages *and* cached
    stacks: stacks evict first (rebuildable on the device), then
    least-recently-used pages; the launch being assembled never loses
    what it needs.  A later request for an evicted page pays one upload.

Pages are read-only to the programs: nothing writes into a pooled tensor.
Eviction only drops the pool's reference.  Every launch of the port runs
on one CUDA stream, and the caching allocator hands freed memory out
again only in that stream's order, so a launch queued before the
eviction never reads a reused page; a page read on another stream would
need ``Tensor.record_stream``.

Keeping D equal to the launch's own page count (pow2-bucketed), rather
than the pool's total, keeps program shapes independent of pool history.

``PageStats`` feeds the session telemetry (hit rate, bytes uploaded vs
saved, evictions, stack reuse).  ``PageDirectory`` is the cluster-wide
map of which pool holds which page: a pool that misses locally but whose
directory names a peer holder copies the page device to device (booked as
a cross-host fetch) instead of uploading it from the host.  The topology
backend, which places buckets by that map, is not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.analysis.registry import warm_cache
from repro_torch.core.crossfit import pow2_bucket
from repro_torch.runtime import DeviceLike, resolve_device

# page identity: (data fingerprint, n_pad, p_pad)
PageKey = Tuple[object, int, int]

DEFAULT_BYTE_BUDGET = 256 * 1024 * 1024
MAX_CACHED_STACKS = 128


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host-to-device copy of a numpy array that does not wait: staged
    through a pinned buffer that PyTorch allocated and copied
    ``non_blocking``.  PyTorch's host allocator keeps the staging buffer
    alive until the copy's event, which a pinned view of memory it did
    not allocate would not be.  On the CPU device the tensor aliases the
    array."""
    src = torch.as_tensor(arr)
    if device.type != "cuda":
        return src
    staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    staged.copy_(src)
    return staged.to(device, non_blocking=True)


@dataclass
class PageStats:
    """Hit/miss/transfer accounting across drains.

    A *cross-host fetch* is a local miss served device-to-device from a
    peer pool instead of the host round trip: it counts as a miss for
    this pool's hit rate and its bytes land in ``bytes_d2d`` (never
    ``bytes_h2d``).
    """
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    stack_builds: int = 0
    stack_hits: int = 0
    bytes_h2d: int = 0                  # host->device page transfers
    bytes_saved: int = 0                # transfers avoided by residency
    cross_host_fetches: int = 0         # misses served from a peer pool
    bytes_d2d: int = 0                  # device->device cross-host bytes

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def summary(self) -> Dict:
        return {"page_hits": self.hits, "page_misses": self.misses,
                "page_hit_rate": self.hit_rate,
                "page_evictions": self.evictions,
                "stack_builds": self.stack_builds,
                "stack_hits": self.stack_hits,
                "page_bytes_h2d": self.bytes_h2d,
                "page_bytes_saved": self.bytes_saved,
                "cross_host_fetches": self.cross_host_fetches,
                "page_bytes_d2d": self.bytes_d2d}

    # snapshot/delta/merge iterate the dataclass fields so a counter
    # added above is carried through all three
    def snapshot(self) -> "PageStats":
        return dataclasses.replace(self)

    def delta(self, since: "PageStats") -> "PageStats":
        return PageStats(*(getattr(self, f.name) - getattr(since, f.name)
                           for f in dataclasses.fields(self)))

    def merge(self, other: "PageStats") -> "PageStats":
        """Aggregate two pools' accounting."""
        return PageStats(*(getattr(self, f.name) + getattr(other, f.name)
                           for f in dataclasses.fields(self)))


class PageDirectory:
    """Cluster-wide fingerprint directory over per-host ``PagePool``s.

    Maps every page key to the set of hosts currently holding it and
    brokers device-to-device fetches between pools: a pool that misses
    locally asks the directory, which hands back a peer's resident page
    (the caller copies it to its own device).  Pure bookkeeping plus the
    fetch counters; placement policy is the caller's job.
    """

    def __init__(self):
        self._holders: Dict[PageKey, Set[int]] = {}
        self._pools: Dict[int, "PagePool"] = {}
        self.fetches = 0                # cross-host page fetches brokered
        self.bytes_fetched = 0

    def attach(self, pool: "PagePool") -> None:
        self._pools[pool.host_id] = pool

    def detach(self, pool: "PagePool") -> None:
        """Withdraw a dead host: drop it from the pool map and purge it
        from every holder set, so no fetch is ever brokered against
        unreachable device memory."""
        self._pools.pop(pool.host_id, None)
        for pkey in list(self._holders):
            self.unregister(pkey, pool.host_id)

    def register(self, pkey: PageKey, host_id: int) -> None:
        self._holders.setdefault(pkey, set()).add(host_id)

    def unregister(self, pkey: PageKey, host_id: int) -> None:
        holders = self._holders.get(pkey)
        if holders is not None:
            holders.discard(host_id)
            if not holders:
                del self._holders[pkey]

    def holders(self, pkey: PageKey) -> frozenset:
        return frozenset(self._holders.get(pkey, ()))

    def fetch(self, pkey: PageKey, requester: int):
        """A peer's resident page tensor, or None if no peer holds it.
        Deterministic source choice (lowest holder id); does not touch
        the source pool's LRU order."""
        for hid in sorted(self._holders.get(pkey, ())):
            if hid == requester:
                continue
            src = self._pools.get(hid)
            page = src._pages.get(pkey) if src is not None else None
            if page is not None:
                self.fetches += 1
                self.bytes_fetched += src._nbytes[pkey]
                return page
        return None


class PagePool:
    """LRU pool of device-resident padded feature pages.

    One instance per backend (beside its ``ProgramCache``), persisting
    across drains.  ``byte_budget`` bounds the pages and the assembled
    stacks together; stacks are also capped at ``MAX_CACHED_STACKS``
    entries.  ``device`` follows the port's device rule: the card by
    default (raises where there is none), ``"cpu"`` when asked.

    Several pools may share a ``PageDirectory``, each under its own
    ``host_id``: a local miss then tries a device-to-device copy from a
    peer holder before paying the upload.
    """

    def __init__(self, byte_budget: int = DEFAULT_BYTE_BUDGET, *,
                 host_id: int = 0, directory: Optional[PageDirectory] = None,
                 device: DeviceLike = "cuda"):
        self.byte_budget = int(byte_budget)
        self.host_id = host_id
        self.directory = directory
        self.device = resolve_device(device)
        if directory is not None:
            directory.attach(self)
        self.stats = PageStats()
        self._pages: "OrderedDict[PageKey, torch.Tensor]" = OrderedDict()
        self._nbytes: Dict[PageKey, int] = {}
        self._page_bytes = 0
        # (tuple of page keys, d_pad) -> stacked device tensor
        self._stacks: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
        self._stacks_of: Dict[PageKey, Set[Tuple]] = {}
        self._stack_bytes = 0

    # ------------------------------------------------------------------
    @staticmethod
    def page_key(req, n_pad: int, p_pad: int) -> PageKey:
        return (req.data_key, n_pad, p_pad)

    @property
    def n_pages(self) -> int:
        return len(self._pages)

    # ---- residency probes ---------------------------------------------
    def resident(self, pkey: PageKey) -> bool:
        """Membership test without touching LRU order or stats."""
        return pkey in self._pages

    def stack_cached(self, pkeys: Sequence[PageKey]) -> bool:
        """Whether the lane composition is launch-ready with zero
        copies: a singleton composition's launch tensor IS its resident
        page; multi-lane compositions need their assembled stack."""
        pkeys = tuple(pkeys)
        if len(pkeys) == 1:
            return pkeys[0] in self._pages
        return (pkeys, pow2_bucket(len(pkeys), 1)) in self._stacks

    @property
    def total_bytes(self) -> int:
        """Device bytes held: canonical pages + materialized stacks."""
        return self._page_bytes + self._stack_bytes

    # ------------------------------------------------------------------
    def _page(self, pkey: PageKey, req, n_pad: int, p_pad: int):
        """The request's device-resident padded page, shaped
        ``(1, n_pad, p_pad)`` so a singleton launch consumes it directly;
        a local miss tries a device-to-device copy from a peer pool
        (directory) before paying the upload."""
        page = self._pages.get(pkey)
        nbytes = n_pad * p_pad * 4
        if page is not None:
            self._pages.move_to_end(pkey)
            self.stats.hits += 1
            self.stats.bytes_saved += nbytes
            return page
        self.stats.misses += 1
        peer = self.directory.fetch(pkey, self.host_id) \
            if self.directory is not None else None
        if peer is not None:
            page = peer.to(self.device, copy=True)       # d2d copy
            self.stats.cross_host_fetches += 1
            self.stats.bytes_d2d += nbytes
        else:
            x = np.asarray(req.x, np.float32)
            host = np.zeros((1, n_pad, p_pad), np.float32)
            host[0, :x.shape[0], :x.shape[1]] = x
            page = upload(host, self.device)             # the one upload
            self.stats.bytes_h2d += nbytes
        self._pages[pkey] = page
        self._nbytes[pkey] = nbytes
        self._page_bytes += nbytes
        if self.directory is not None:
            self.directory.register(pkey, self.host_id)
        return page

    def _drop_stack(self, skey: Tuple):
        stack = self._stacks.pop(skey, None)
        if stack is not None:
            self._stack_bytes -= stack.numel() * 4
        for pk in skey[0]:
            self._stacks_of.get(pk, set()).discard(skey)

    def _evict_lru(self, keep: Set[PageKey], keep_stack: Tuple = None):
        """Shrink to the byte budget: drop LRU cached stacks first (they
        rebuild on the device), then evict LRU pages (never ones the
        launch being assembled needs), dropping their stacks."""
        while self._stack_bytes + self._page_bytes > self.byte_budget:
            victim = next((sk for sk in self._stacks if sk != keep_stack),
                          None)
            if victim is None:
                break
            self._drop_stack(victim)
        for pkey in list(self._pages):
            if self.total_bytes <= self.byte_budget:
                return
            if pkey in keep:
                continue
            self._pages.pop(pkey)
            self._page_bytes -= self._nbytes.pop(pkey)
            self.stats.evictions += 1
            if self.directory is not None:
                self.directory.unregister(pkey, self.host_id)
            for skey in list(self._stacks_of.pop(pkey, ())):
                self._drop_stack(skey)

    def invalidate(self) -> None:
        """Host loss: drop every resident page and stack and withdraw
        from the cluster directory.  A later request re-uploads (or
        fetches from a peer) whatever it needs."""
        if self.directory is not None:
            self.directory.detach(self)
        self._pages.clear()
        self._nbytes.clear()
        self._page_bytes = 0
        self._stacks.clear()
        self._stacks_of.clear()
        self._stack_bytes = 0

    # ------------------------------------------------------------------
    # page contents are pinned by the PageKeys inside ``needs`` (a
    # page_key embeds the request's data_key); the composition cache
    # and residency maps live on this pool instance (ambient)
    @warm_cache(name="page_pool_stacks", key=("needs", "n_pad", "p_pad"),
                ambient=("self",))
    def stack(self, needs: Sequence[Tuple[PageKey, object]],
              n_pad: int, p_pad: int) -> torch.Tensor:
        """Assemble the (D, N_pad, P_pad) stack for one launch.

        ``needs`` is ``[(page_key, request), ...]`` in lane order (lane i
        = needs[i]); D is pow2 of the lane count.

        A singleton launch consumes the resident ``(1, N_pad, P_pad)``
        page directly — no copy; a repeat is booked as a stack hit.  A
        multi-lane composition (a fused launch over several requests'
        pages) pays one ``torch.cat`` on the device cold, and every warm
        repeat of the same composition gets the identical tensor back.
        """
        if len(needs) == 1:
            pk, req = needs[0]
            was_resident = pk in self._pages
            page = self._page(pk, req, n_pad, p_pad)
            if was_resident:
                self.stats.stack_hits += 1
            else:
                self.stats.stack_builds += 1
                self._evict_lru(keep={pk})
            return page
        pkeys = tuple(pk for pk, _ in needs)
        d_pad = pow2_bucket(max(len(pkeys), 1), 1)
        skey = (pkeys, d_pad)
        cached = self._stacks.get(skey)
        if cached is not None and all(pk in self._pages for pk in pkeys):
            self._stacks.move_to_end(skey)
            self.stats.stack_hits += 1
            for pk, req in needs:                   # LRU touch + accounting
                self._pages.move_to_end(pk)
                self.stats.hits += 1
                self.stats.bytes_saved += n_pad * p_pad * 4
            return cached
        lanes = [self._page(pk, req, n_pad, p_pad) for pk, req in needs]
        if d_pad > len(lanes):
            zero = torch.zeros((1, n_pad, p_pad), dtype=torch.float32,
                               device=self.device)
            lanes = lanes + [zero] * (d_pad - len(lanes))
        stack = torch.cat(lanes)
        self.stats.stack_builds += 1
        self._stacks[skey] = stack
        self._stack_bytes += d_pad * n_pad * p_pad * 4
        for pk in pkeys:
            self._stacks_of.setdefault(pk, set()).add(skey)
        while len(self._stacks) > MAX_CACHED_STACKS:
            self._drop_stack(next(iter(self._stacks)))
        self._evict_lru(keep=set(pkeys), keep_stack=skey)
        return stack

"""Non-blocking dispatch queues (serverless layer).

``compile/program.py::dispatch_bucket`` launches a bucket slice and
returns a ``BucketDispatch`` whose launches are still in flight: each
launch's result is being copied into a pinned host buffer behind a CUDA
event.  This module is the layer the backends manage those handles
with: one ``DispatchQueue`` per drain stream, holding ``PendingBucket``s
until their ledgers must complete.

The queue is what turns the drain engine's event loop into real
host/device overlap: ``step()`` dispatches work and returns without
waiting, so admission, autoscaling and result assembly all run while
the device executes.  Booking happens at *harvest*: non-blocking for
buckets whose events have completed (``harvest_ready``), blocking only
when a drain has nothing left to dispatch (``harvest_next``).

Accounting (``DispatchStats``): ``wait_s`` is host time spent blocked
on the device, ``host_overlap_s`` is host work performed while launches
were in flight — their ratio is the measured overlap of host booking
with device execution.

Fault tolerance lives at this layer too.  An in-flight bucket carries
an optional **deadline** (roofline-derived, capped by
``PoolConfig.timeout_s``); once overdue, the backend dispatches a
**hedged duplicate** and the two legs race.  First to land wins and is
booked; ``HedgePair.settle`` (the sole cancel performer) cancels the
loser, whose dispatch is discarded without booking and whose wall-clock
span is charged to ``hedge_waste_s`` instead of the request bill, so the
GB-second ``Bill`` and the autoscaler EMA see exactly one span per
completed bucket.  ``abandon()`` drops a whole queue: the orphans
transition to LOST and their invocations resurface in the ledger-driven
pending view for re-dispatch.  Every transition is checked against
``analysis/protocol.py``'s ``BUCKET_TRANSITIONS`` table when
``REPRO_SANITIZE`` is armed (serverless/sanitize.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.serverless import sanitize

# (request index, invocation id) — compile/buckets.py::Entry, redeclared
# here because repro_torch.compile must load lazily (core <-> serverless
# cycle)
Entry = Tuple[int, int]


@dataclass
class DispatchStats:
    """In-flight accounting for one drain's dispatch queues."""
    dispatched: int = 0                 # buckets pushed
    harvested: int = 0                  # buckets booked
    ready_harvests: int = 0             # booked without blocking
    wait_s: float = 0.0                 # host blocked on the device
    host_overlap_s: float = 0.0         # host work while work in flight
    in_flight_peak: int = 0             # max concurrent pending buckets
    hedges: int = 0                     # duplicate dispatches launched
    hedge_wins: int = 0                 # races won by the duplicate
    cancelled: int = 0                  # losing legs discarded unbooked
    lost: int = 0                       # buckets abandoned to host loss
    hedge_waste_s: float = 0.0          # wall attributed to losing legs

    @property
    def overlap_ratio(self) -> float:
        """Fraction of device execution hidden behind host booking:
        overlapped host seconds vs total (overlapped + blocked) seconds
        spanning the in-flight windows."""
        total = self.host_overlap_s + self.wait_s
        return self.host_overlap_s / total if total > 0 else 0.0

    def merge(self, other: "DispatchStats") -> "DispatchStats":
        return DispatchStats(
            self.dispatched + other.dispatched,
            self.harvested + other.harvested,
            self.ready_harvests + other.ready_harvests,
            self.wait_s + other.wait_s,
            self.host_overlap_s + other.host_overlap_s,
            max(self.in_flight_peak, other.in_flight_peak),
            self.hedges + other.hedges,
            self.hedge_wins + other.hedge_wins,
            self.cancelled + other.cancelled,
            self.lost + other.lost,
            self.hedge_waste_s + other.hedge_waste_s)

    def summary(self) -> Dict:
        return {"buckets_dispatched": self.dispatched,
                "buckets_harvested": self.harvested,
                "ready_harvests": self.ready_harvests,
                "harvest_wait_s": self.wait_s,
                "host_overlap_s": self.host_overlap_s,
                "overlap_ratio": self.overlap_ratio,
                "in_flight_peak": self.in_flight_peak,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "cancelled": self.cancelled,
                "lost": self.lost,
                "hedge_waste_s": self.hedge_waste_s}


@dataclass(eq=False)
class PendingBucket:
    """One dispatched bucket slice awaiting harvest.

    Identity equality (``eq=False``) is load-bearing: the queue removes
    pending buckets with ``list.remove``, and a generated ``__eq__``
    would compare the wrapped in-flight tensors
    elementwise — raising whenever two in-flight buckets share a key.

    Wraps the compiler's ``BucketDispatch`` with the scheduling context
    the booking callback needs (which host stream launched it, when).
    An invocation's rows can straddle launches, so the *bucket* is the
    booking unit — ``ready()`` only when every launch has landed.

    ``book`` is the **booking continuation**, attached at push
    (book-at-push): under pipelined dispatch a bucket may land
    several waves after it was pushed, so its booking context must ride
    with the bucket instead of being supplied by whichever harvest call
    happens to drain it.

    Lifecycle (``state``): DISPATCHED -> HARVESTED on the happy path;
    an overdue bucket becomes HEDGED when its duplicate launches, the
    race's loser becomes CANCELLED (discarded, never booked), and a
    bucket orphaned by a host death becomes LOST.  ``deadline_s`` arms
    the hedge check; ``not_ready_before`` models a synthetic straggler's
    long tail (``ready()`` stays False until it matures, which is what
    an armed deadline cuts short).
    """
    dispatch: object                    # compile/program.py::BucketDispatch
    host: int = -1                      # host stream (-1: single-stream)
    t_dispatch: float = field(default_factory=time.perf_counter)
    book: Optional["BookFn"] = None     # attached by DispatchQueue.push
    state: str = "DISPATCHED"           # DISPATCHED/HARVESTED/HEDGED/...
    deadline_s: Optional[float] = None  # hedge when overdue (None: never)
    not_ready_before: float = 0.0       # straggler hold (perf_counter)
    is_hedge: bool = False              # this leg IS the duplicate
    pair: Optional["HedgePair"] = None  # set on both legs of a race

    @property
    def key(self):
        return self.dispatch.key

    @property
    def entries(self) -> List[Entry]:
        return self.dispatch.entries

    def ready(self) -> bool:
        if self.not_ready_before and time.perf_counter() < self.not_ready_before:
            return False
        return self.dispatch.ready()


# booking callback: (pending_bucket, results, elapsed_s_since_dispatch)
BookFn = Callable[[PendingBucket, Dict[Entry, object], float], None]


@dataclass(eq=False)
class HedgePair:
    """The two legs of a hedged re-dispatch race.

    Both legs run the SAME compiled program over the SAME entries with
    the SAME per-task keys, so whichever lands first books
    bitwise-identical results — the race only decides latency, never
    values.  ``settle`` is the **sole cancel performer**: the winning
    leg's
    harvest calls it exactly once, and it cancels every other live leg,
    guaranteeing single-performer booking — a cancelled leg's dispatch
    is discarded via the same harvest-once flag, so it can never also be
    booked.
    """
    legs: List[Tuple[PendingBucket, "DispatchQueue"]] = field(
        default_factory=list)
    winner: Optional[PendingBucket] = None

    def settle(self, winner: PendingBucket) -> None:
        """Declare ``winner`` booked; cancel the remaining live legs.
        Idempotent: a leg that lost to an already-settled race was
        cancelled before it could harvest, so only the first call acts."""
        if self.winner is not None:
            return
        self.winner = winner
        for pb, q in self.legs:
            if pb is winner or pb.state == "LOST":
                continue
            q.cancel(pb)


class DispatchQueue:
    """FIFO of in-flight buckets for one drain stream.

    ``push`` marks the start of an in-flight window; host work done
    between a push and the next harvest is credited to
    ``host_overlap_s`` (the device was executing meanwhile), while time
    spent inside a blocking ``harvest`` is ``wait_s``.  ``max_inflight``
    bounds device-side liveness: a push beyond it first force-harvests
    the oldest bucket.
    """

    def __init__(self, max_inflight: int = 8,
                 stats: Optional[DispatchStats] = None):
        self.max_inflight = max(1, int(max_inflight))
        self.stats = stats if stats is not None else DispatchStats()
        self._pending: List[PendingBucket] = []
        self._mark: Optional[float] = None   # start of host-overlap window
        self._t_attr = 0.0                   # duration-attribution frontier

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def empty(self) -> bool:
        return not self._pending

    def in_flight_entries(self) -> Set[Entry]:
        """Dispatched-but-unharvested (request, invocation) pairs — the
        set schedulers must exclude from their pending view, and the
        autoscalers must count as occupancy rather than queue depth."""
        out: Set[Entry] = set()
        for pb in self._pending:
            out.update(pb.entries)
        return out

    @property
    def in_flight(self) -> int:
        """Dispatched-but-unharvested invocation count."""
        return sum(len(pb.entries) for pb in self._pending)

    # ------------------------------------------------------------------
    def _note_overlap(self):
        """Credit host time since the last dispatch/harvest event as
        overlapped work (only meaningful while something is in flight)."""
        now = time.perf_counter()
        if self._mark is not None and self._pending:
            self.stats.host_overlap_s += now - self._mark
        self._mark = now

    def push(self, pb: PendingBucket, book: Optional[BookFn] = None) -> None:
        """Enqueue one dispatched bucket; force-harvests the oldest
        first when the in-flight bound is reached.  ``book`` becomes the
        bucket's booking continuation (book-at-push) unless the caller
        already attached one to ``pb``."""
        if book is not None:
            pb.book = book
        sanitize.check_book_at_push(pb)
        self._note_overlap()
        while len(self._pending) >= self.max_inflight:
            self.harvest_next()
        self._pending.append(pb)
        self.stats.dispatched += 1
        self.stats.in_flight_peak = max(self.stats.in_flight_peak,
                                        len(self._pending))
        self._mark = time.perf_counter()

    def _harvest(self, pb: PendingBucket, book: Optional[BookFn],
                 blocked: bool):
        if pb.state == "CANCELLED":
            # The losing leg of a hedge race: discard without booking.
            # Its wall-clock span (beyond the attribution frontier) is
            # charged to hedge_waste_s, NOT to the request bill — the
            # winner already carried the bucket's one billable span, so
            # billing the loser too would double-charge GB-seconds and
            # skew the autoscaler EMA.
            t0 = time.perf_counter()
            pb.dispatch.discard()
            t1 = time.perf_counter()
            if blocked:
                self.stats.wait_s += t1 - t0
            self._mark = t1
            sanitize.check_attribution(t1, self._t_attr)
            waste = t1 - max(pb.t_dispatch, self._t_attr)
            self._t_attr = t1
            self.stats.hedge_waste_s += max(waste, 0.0)
            self.stats.cancelled += 1
            return
        t0 = time.perf_counter()
        if blocked and pb.not_ready_before:
            # blocking harvest of a held (synthetic-straggler) bucket:
            # the long tail is part of the wall we are waiting out
            hold = pb.not_ready_before - t0
            if hold > 0:
                time.sleep(hold)
        results = pb.dispatch.harvest()
        t1 = time.perf_counter()
        if blocked:
            self.stats.wait_s += t1 - t0
        self.stats.harvested += 1
        self._mark = t1
        # NON-OVERLAPPING duration attribution: concurrent in-flight
        # buckets share one wall-clock span, so billing each of them
        # (dispatch -> harvest) would charge the span k times over —
        # inflating GB-seconds, the autoscaler EMA, and the timeout
        # check.  Each bucket is billed only the span beyond the
        # frontier already attributed to earlier harvests; summed
        # durations then equal the true elapsed wall, matching the old
        # synchronous per-bucket accounting.
        sanitize.check_attribution(t1, self._t_attr)
        elapsed = t1 - max(pb.t_dispatch, self._t_attr)
        self._t_attr = t1
        sanitize.check_bucket_bookable(pb)
        pb.state = "HARVESTED"
        fn = pb.book if pb.book is not None else book
        fn(pb, results, max(elapsed, 0.0))
        if pb.pair is not None:
            # this leg won the race: record the outcome and cancel the
            # loser (HedgePair.settle — the sole cancel performer)
            if pb.is_hedge:
                self.stats.hedge_wins += 1
            pb.pair.settle(pb)

    def harvest_ready(self, book: Optional[BookFn] = None) -> int:
        """Book every bucket whose launches all report ready — the
        non-blocking poll the event loop runs each step.  Harvests in
        FIFO order but stops at the first not-ready bucket only for
        ordering of *blocking* waits; ready buckets behind a slow one
        are still booked (out-of-order harvest)."""
        self._note_overlap()
        done = [pb for pb in self._pending if pb.ready()]
        for pb in done:
            if pb not in self._pending:
                # removed mid-loop: an earlier harvest settled a hedge
                # race and cancelled-and-discarded this leg already
                continue
            self._pending.remove(pb)
            self._harvest(pb, book, blocked=False)
            self.stats.ready_harvests += 1
        return len(done)

    # ---- fault-tolerance lifecycle -----------------------------------
    def overdue(self, now: Optional[float] = None) -> List[PendingBucket]:
        """In-flight buckets past their deadline and still not landed —
        the hedge candidates.  Already-hedged legs and hedge duplicates
        themselves are excluded (one duplicate per bucket, ever)."""
        now = time.perf_counter() if now is None else now
        return [pb for pb in self._pending
                if pb.state == "DISPATCHED" and not pb.is_hedge
                and pb.deadline_s is not None
                and now - pb.t_dispatch > pb.deadline_s
                and not pb.ready()]

    def cancel(self, pb: PendingBucket) -> None:
        """Transition a losing hedge leg to CANCELLED and discard it as
        soon as its launches land.  Only ``HedgePair.settle`` may call
        this (enforced statically by analysis/protocol.py)."""
        sanitize.check_cancel(pb)
        pb.state = "CANCELLED"
        pb.not_ready_before = 0.0    # no point holding a discard
        if pb in self._pending and pb.dispatch.ready():
            self._pending.remove(pb)
            self._harvest(pb, None, blocked=False)

    def discard_cancelled(self) -> int:
        """Wait out and discard every losing hedge leg still in flight —
        what a drain whose requests have all been booked can have left:
        on one CUDA stream a duplicate queues behind its original, so it
        lands after the winner settled the race.  Returns how many."""
        losers = [pb for pb in self._pending if pb.state == "CANCELLED"]
        for pb in losers:
            self._pending.remove(pb)
            self._harvest(pb, None, blocked=True)
        return len(losers)

    def abandon(self) -> List[PendingBucket]:
        """A host died: every in-flight bucket on its queue transitions
        to LOST and is returned for ledger-driven re-dispatch.  The
        dispatches are never harvested — their results lived on the dead
        host.  Only ``TopologyBackend.kill_host`` may call this."""
        pending, self._pending = self._pending, []
        orphans: List[PendingBucket] = []
        for pb in pending:
            if pb.state == "CANCELLED":
                # a hedge loser awaiting discard: its winner already
                # booked the entries, so the host taking it down loses
                # nothing — count the discard and drop the handles
                self.stats.cancelled += 1
                continue
            sanitize.check_abandon(pb)
            pb.state = "LOST"
            pb.not_ready_before = 0.0
            orphans.append(pb)
        self.stats.lost += len(orphans)
        self._mark = None
        return orphans

    def harvest_next(self, book: Optional[BookFn] = None) -> bool:
        """Block for the oldest in-flight bucket (the drain has nothing
        left to dispatch); False if the queue is empty."""
        if not self._pending:
            return False
        self._note_overlap()
        self._harvest(self._pending.pop(0), book, blocked=True)
        return True

    def harvest_all(self, book: Optional[BookFn] = None) -> None:
        while self.harvest_next(book):
            pass

"""The topology layer: per-host drain streams with locality-aware bucket
placement.

The single-stream backends run one drain over one mesh.  This module
models the *cluster*: a ``Topology`` of host meshes, each owning a
per-host device-resident ``PagePool`` on its mesh's lead device (all
pools sharing one ``PageDirectory``), one drain stream and — on the card
— one CUDA stream.  The hosts are simulated
(launch/mesh.py::make_sim_host_meshes): each owns a mesh of
``shards_per_host`` shards over the visible devices, reused round-robin
when there are fewer than hosts, as the JAX package reuses its devices;
on one card every host's mesh repeats that card, and what separates the
hosts is their page pools and their streams.  ``TopologyBackend`` is the
scheduler over them:

  * **placement** — every megabatch bucket is routed to a host by
    ``sharding/policy.py::place_bucket``, scored against each host's
    page residency (stack-cached > pages-resident > cold, ties to the
    least-loaded host).  Steady-state traffic therefore re-lands on the
    host already holding its pages: zero transfers of any kind.
  * **per-host streams** — one ``step()`` advances ONE host's stream by
    one wave (round-robin cursor), so the session's event loop
    interleaves all hosts exactly as it interleaves waves; ledgers
    complete out of order across hosts as they do within one.  Each host
    owns an in-flight dispatch queue (serverless/dispatch.py): a wave
    launches its buckets without blocking, and a later step's harvest
    books them.  Everything a host's wave enqueues on the card — page
    uploads and fetches, stacks, the kernels, the result copies and
    their events — goes on that host's CUDA stream, so one host's
    device work overlaps every other host's.
  * **work-stealing** — a host whose queue drained steals the
    least-local bucket from the most-loaded host
    (``policy.steal_choice``); the stolen bucket's pages arrive
    device-to-device from the holder (a *cross-host fetch*, counted by
    the directory; compile/pages.py orders the copy after the holder's
    write) and stay resident, so a re-stolen bucket is free.
  * **autoscaling** — a ``TopologyAutoscaler`` sizes each host's wave
    independently, pricing cold candidates with the roofline's
    per-bucket estimates until measured durations take over.
  * **axis planning** — every bucket's parallelization axis is
    roofline-priced on its host's mesh (``plan_bucket_axis``): a bucket
    priced task-parallel over a mesh of m > 1 shards dispatches through
    that host's own sharded program cache (sharded-fused launches on its
    mesh, B padded to m), every other task bucket through the shared
    cache, and a data or feature decision runs the in-mesh program on
    the host's mesh — a tall Gram bucket (``n_pad > DEVICE_PAGE_ROWS``)
    streams its rows through the blocked Gram kernel as the sharded
    backend does, and goes only to hosts whose data axis divides it.
  * **fault tolerance** — chaos pools draw identity-keyed verdicts at
    booking (serverless/chaos.py) exactly as the single-stream backends
    do; overdue buckets are hedged onto the least-loaded *other* live
    host's stream (armed by default as on one stream: on the card only
    with a straggler hold, see ``_StreamBackend._hedge_armed``); and
    ``kill_host`` simulates losing a host mid-drain —
    its page pool is invalidated, its in-flight buckets are abandoned
    (LOST), and their still-RUNNING ledger rows resurface through the
    pending view to be re-routed onto the survivors.

Determinism: placement and stealing only decide *where* a bucket's
program runs; per-task keys are fixed at compile time and every host
runs the programs of one shared ``ProgramCache`` (a program is a closure
over the kernel wrappers, which launch on the current stream; it holds
no device tensor), so the buckets the planner keeps on the task axis of
one device are bit for bit the inline backend's.  A bucket on a host's
sharded cache runs B/m lanes a shard: bit for bit for the families of
``MORPH_BITWISE_FAMILIES``, in the float tier for the others
(compile/program.py).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.compile.pages import PageDirectory, PagePool, PageStats
from repro_torch.runtime import DeviceLike
from repro_torch.serverless.autoscale import TopologyAutoscaler
from repro_torch.serverless.backends import (
    BackendRunInfo, DrainState, PoolConfig, _compile, _StreamBackend,
    make_sharded_compiler, roofline_pending_inv_s,
)
from repro_torch.serverless.chaos import chaos_plan
from repro_torch.serverless.dispatch import (
    DispatchQueue, DispatchStats, PendingBucket,
)
from repro_torch.sharding.policy import place_bucket, steal_choice


# ---------------------------------------------------------------------------
# the cluster model
# ---------------------------------------------------------------------------
@dataclass
class HostMesh:
    """One host: its device mesh, the device its page pool pins pages to,
    the pool itself (directory-shared) and, on the card, the CUDA stream
    all of its work runs on (None on the CPU)."""
    host_id: int
    mesh: object                        # launch/mesh.py::DeviceMesh
    device: torch.device
    pool: PagePool
    stream: Optional["torch.cuda.Stream"] = None

    @property
    def n_devices(self) -> int:
        return len(self.mesh.devices)

    def on_stream(self):
        """Context in which this host's stream is the current one (a
        null context on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


class Topology:
    """The set of host meshes one ``TopologyBackend`` schedules over.

    Pools (and therefore page residency) persist across drains — the
    topology is the warm state; drains come and go.
    """

    def __init__(self, hosts: List[HostMesh], directory: PageDirectory):
        self.hosts = hosts
        self.directory = directory
        self.dead: set = set()          # host_ids lost mid-flight

    def __len__(self) -> int:
        return len(self.hosts)

    def alive(self) -> List[HostMesh]:
        """The hosts still schedulable (host loss is permanent for the
        topology's lifetime — pools persist across drains, corpses
        don't come back)."""
        return [h for h in self.hosts if h.host_id not in self.dead]

    def kill(self, host_id: int) -> None:
        """Lose one host: invalidate its page pool (every resident page
        and stack dropped, directory withdrawn so no d2d fetch is ever
        brokered against its memory) and mark it dead for
        routing/stealing.  In-flight work recovery is the backend's job
        (``TopologyBackend.kill_host``)."""
        if host_id in self.dead:
            return
        self.dead.add(host_id)
        self.hosts[host_id].pool.invalidate()

    @classmethod
    def _from_meshes(cls, meshes, page_pool_bytes: int) -> "Topology":
        """One host per mesh, each with its pool on the mesh's device and,
        on a CUDA device, a stream of its own (creating it raises where
        the device cannot give one)."""
        directory = PageDirectory()
        hosts = []
        for i, mesh in enumerate(meshes):
            dev = mesh.device
            stream = torch.cuda.Stream(device=dev) \
                if dev.type == "cuda" else None
            pool = PagePool(page_pool_bytes, host_id=i,
                            directory=directory, device=dev)
            if mesh.collective == "nccl":
                pool.replicas = mesh.devices
            hosts.append(HostMesh(host_id=i, mesh=mesh, device=dev,
                                  pool=pool, stream=stream))
        return cls(hosts, directory)

    @classmethod
    def simulated(cls, n_hosts: int,
                  page_pool_bytes: int = 256 * 1024 * 1024,
                  device: DeviceLike = "cuda",
                  shards_per_host: int = 1) -> "Topology":
        """N simulated hosts of ``shards_per_host`` shards each
        (launch/mesh.py::make_sim_host_meshes)."""
        from repro_torch.launch.mesh import make_sim_host_meshes
        return cls._from_meshes(
            make_sim_host_meshes(n_hosts, device, shards_per_host),
            page_pool_bytes)

    @classmethod
    def from_mesh(cls, mesh,
                  page_pool_bytes: int = 256 * 1024 * 1024) -> "Topology":
        """One host per index of the mesh's "pod" axis; a pod-less mesh
        becomes a single-host topology."""
        from repro_torch.launch.mesh import split_pod_meshes
        return cls._from_meshes(split_pod_meshes(mesh), page_pool_bytes)

    def page_stats(self) -> PageStats:
        """Cluster-wide page accounting (sum of the per-host pools)."""
        out = PageStats()
        for h in self.hosts:
            out = out.merge(h.pool.stats)
        return out


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
@dataclass
class HostLaneInfo:
    """Per-host-stream accounting for one drain."""
    host_id: int
    n_devices: int
    waves: int = 0
    invocations: int = 0
    buckets_placed: int = 0             # routed here at admission
    steals: int = 0                     # buckets this host stole
    # this host's dispatch queue (BackendRunInfo.dispatch sums them)
    dispatch: DispatchStats = field(default_factory=DispatchStats)


@dataclass
class TopologyInfo:
    """Cross-host accounting for one topology drain (session telemetry:
    ``last_run_info.topology``)."""
    n_hosts: int
    hosts: List[HostLaneInfo]
    steals: int = 0
    placements: List[Tuple[object, int, float]] = field(
        default_factory=list)           # (bucket key, host, score)
    host_losses: int = 0                # hosts killed mid-drain
    lost_buckets: int = 0               # in-flight buckets abandoned


@dataclass
class TopologyDrainState(DrainState):
    """One continuous drain over all host streams: the shared bucket
    plan plus the live bucket→host assignment, the round-robin cursor
    the event loop steps with, and one in-flight dispatch queue per
    host (the per-host streams are the dispatch unit)."""
    assignment: Dict[object, int] = field(default_factory=dict)
    cursor: int = 0
    queues: Dict[int, DispatchQueue] = field(default_factory=dict)

    def in_flight_entries(self) -> set:
        out = set()
        for q in self.queues.values():
            out |= q.in_flight_entries()
        return out

    def refresh(self) -> None:
        """``info.dispatch``: the sum of the hosts' dispatch accounting
        (a dead host's queue is gone, its stats stay counted)."""
        out = DispatchStats()
        for lane in self.info.topology.hosts:
            out = out.merge(lane.dispatch)
        self.info.dispatch = out


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------
class TopologyBackend(_StreamBackend):
    """Per-host drain streams with page-locality routing.

    One ``step(state)`` advances one host stream by one wave: the
    session's event loop therefore steps all streams round-robin, and a
    host's wave is sized by its own autoscaler lane.  Chaos pools draw
    identity-keyed fault verdicts at booking (serverless/chaos.py);
    overdue buckets hedge cross-host; ``kill_host`` loses a host
    mid-drain and the survivors finish every admitted request.  The
    reference for its results is the inline backend, bit for bit.
    """
    name = "topology"

    def __init__(self, pool: Optional[PoolConfig] = None,
                 topology: Optional[Topology] = None,
                 n_hosts: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        self.pool = pool or PoolConfig()
        if topology is None:
            topology = Topology.simulated(
                n_hosts if n_hosts is not None else self.pool.n_hosts,
                self.pool.page_pool_bytes or 0, device)
        self.topology = topology
        self.device = topology.hosts[0].device
        # one program cache for every host's single-device launches, and
        # per host of m > 1 shards its own sharded cache, built on first
        # use on its mesh and booking into the shared stats
        self.compiler = _compile().ProgramCache()
        self._host_compilers: Dict[int, object] = {}
        self.autoscaler = TopologyAutoscaler(self.pool, len(topology)) \
            if self.pool.autoscale else None
        self.pages = None               # per-host pools live on the topology

    # ---- drain lifecycle ---------------------------------------------
    def begin_drain(self) -> TopologyDrainState:
        info = BackendRunInfo(backend=self.name)
        info.compile = self.compiler.stats
        info.pages = self.topology.page_stats()
        info.topology = TopologyInfo(
            n_hosts=len(self.topology),
            hosts=[HostLaneInfo(h.host_id, h.n_devices)
                   for h in self.topology.hosts])
        info.dispatch = DispatchStats()
        state = TopologyDrainState(plan=_compile().MegabatchPlan(),
                                   info=info)
        state.chaos = chaos_plan(self.pool)
        # one in-flight queue per host, each with its own stats block
        state.queues = {
            h.host_id: DispatchQueue(self.pool.max_inflight,
                                     stats=info.topology.hosts[i].dispatch)
            for i, h in enumerate(self.topology.hosts)}
        return state

    # admit() is inherited: routing happens lazily in step() (one pass
    # over all unassigned buckets), so batch admission stays linear

    # ---- placement ----------------------------------------------------
    def _bucket_pkeys(self, state, key, entries) -> Tuple:
        """The bucket's page keys, one per request with pending entries
        (canonical blocks launch one request per program, so each page's
        singleton stack is the unit the policy probes)."""
        order: Dict[int, None] = {}
        for ri, _ in entries:
            order.setdefault(ri)
        return tuple(
            PagePool.page_key(state.requests[ri], key.n_pad, key.p_pad)
            for ri in order)

    def _loads(self, state, groups) -> List[int]:
        """Pending invocations currently assigned to each host."""
        loads = [0] * len(self.topology)
        for key, entries in groups.items():
            h = state.assignment.get(key)
            if h is not None:
                loads[h] += len(entries)
        return loads

    def _eligible_hosts(self, key) -> List[int]:
        """The hosts a bucket may be routed to.  Tall Gram buckets
        (``n_pad > DEVICE_PAGE_ROWS``: no device page holds them, so the
        drain streams them on the data axis) go only to hosts whose mesh
        can stream them — the largest data-axis size that divides
        ``n_pad``; every other bucket runs anywhere.  Dead hosts are
        never eligible."""
        hosts = [h.host_id for h in self.topology.alive()]
        from repro_torch.compile.program import bucket_family
        from repro_torch.launch.roofline import (
            DEVICE_PAGE_ROWS, GRAM_FAMILIES,
        )
        if key.n_pad <= DEVICE_PAGE_ROWS \
                or bucket_family(key) not in GRAM_FAMILIES:
            return hosts

        def axis_m(h: int) -> int:
            mesh = self.topology.hosts[h].mesh
            return int(mesh.shape["data"]) \
                if "data" in mesh.axis_names else 1

        ok = [h for h in hosts if key.n_pad % axis_m(h) == 0]
        if not ok:                      # nothing divides: route anywhere,
            return hosts                # dispatch runs the task axis
        best = max(axis_m(h) for h in ok)
        return [h for h in ok if axis_m(h) == best]

    def _route(self, state: TopologyDrainState, groups) -> None:
        """Assign every not-yet-routed bucket to its best host among the
        bucket's eligible set (loads maintained incrementally)."""
        pools = [h.pool for h in self.topology.hosts]
        loads = self._loads(state, groups)
        for key, entries in groups.items():
            if key in state.assignment:
                continue
            elig = self._eligible_hosts(key)
            placed = place_bucket(self._bucket_pkeys(state, key, entries),
                                  [pools[h] for h in elig],
                                  [loads[h] for h in elig])
            host = elig[placed.host]
            state.assignment[key] = host
            loads[host] += len(entries)
            info = state.info.topology
            info.hosts[host].buckets_placed += 1
            info.placements.append((key, host, placed.score))

    def _try_steal(self, state: TopologyDrainState, groups,
                   thief: int) -> List:
        """An idle host takes the least-local bucket from the most
        loaded host; the migration is recorded and the assignment
        flipped so the thief finishes the bucket."""
        queues: Dict[int, List] = {}
        for key in groups:
            h = state.assignment[key]
            # a host can only steal buckets it is eligible to stream
            if h != thief and thief in self._eligible_hosts(key):
                queues.setdefault(h, []).append(key)
        pools = [h.pool for h in self.topology.hosts]
        pick = steal_choice(
            queues, pools,
            lambda k: self._bucket_pkeys(state, k, groups[k]))
        if pick is None:
            return []
        _, key = pick
        state.assignment[key] = thief
        info = state.info.topology
        info.steals += 1
        info.hosts[thief].steals += 1
        return [key]

    # ---- per-bucket axis planning -------------------------------------
    def _plan_host_axis(self, state, key, entries, host_id: int):
        """Price the bucket's axis candidates on the owning host's mesh
        (once per (bucket, mesh size) per drain) and log the decision."""
        host = self.topology.hosts[host_id]
        memo_key = (key, host.n_devices)
        if memo_key in state.axis_planned:
            return state.axis_planned[memo_key]
        from repro_torch.compile.buckets import plan_bucket_axis
        decision = plan_bucket_axis(key, n_tasks=len(entries),
                                    n_devices=host.n_devices)
        state.axis_planned[memo_key] = decision
        if decision is not None:
            state.info.axis_plans.append(decision)
        return decision

    def _host_compiler(self, host_id: int):
        """This host's sharded program cache, built on its mesh at first
        use; it books into the backend's one ``CompileStats``."""
        cache = self._host_compilers.get(host_id)
        if cache is None:
            cache = make_sharded_compiler(self.topology.hosts[host_id].mesh)
            cache.stats = self.compiler.stats
            self._host_compilers[host_id] = cache
        return cache

    def _bucket_compiler(self, host_id: int, decision):
        """(program cache, b_align, axis mesh) one bucket dispatches
        through on this host: the host's sharded cache, B padded to its
        shard count, when the planner picked an m-way task layout on a
        host of m > 1 shards; the shared cache *plus the host's mesh*
        when it picked a data/feature layout — ``dispatch_bucket`` lowers
        those through the in-mesh Gram executors (sharding/gram.py),
        chunk-streaming tall N; the shared cache alone otherwise."""
        if decision is not None and decision.axis == "task" \
                and decision.shards > 1 \
                and self.topology.hosts[host_id].n_devices > 1:
            return self._host_compiler(host_id), decision.shards, None
        if decision is not None and decision.axis in ("data", "feature"):
            return self.compiler, 1, self.topology.hosts[host_id].mesh
        return self.compiler, 1, None

    def _dispatch(self, state: TopologyDrainState, bkey, entries, *,
                  host: int, compiler=None, **kw):
        """Launch one bucket slice on ``host`` through ``compiler`` (the
        shared cache by default): its device, its page pool (none when
        the pool's budget is 0 — the pool-off contract stacks pages on
        the host per launch) and, for everything the launch enqueues,
        its stream."""
        h = self.topology.hosts[host]
        with h.on_stream():
            return _compile().dispatch_bucket(
                state.plan, compiler or self.compiler, bkey, entries,
                device=h.device,
                pages=h.pool if h.pool.byte_budget > 0 else None,
                **self._dispatch_opts(), **kw)

    # ---- the per-host wave --------------------------------------------
    def _wave_capacity(self, state, host_id: int, mine, groups) -> int:
        pool = self.pool
        if pool.worker_schedule is not None:   # static ramp, per host
            sched = pool.worker_schedule       # stream (wave parity)
            waves_done = state.info.topology.hosts[host_id].waves
            w = sched[min(waves_done, len(sched) - 1)]
            return max(1, w * pool.lanes_per_worker())
        if self.autoscaler is None:
            return max(1, pool.n_workers * pool.lanes_per_worker())
        depth = sum(len(groups[k]) for k in mine)
        tasks = sum(
            state.requests[ri].grid.tasks_per_invocation(
                state.requests[ri].scaling)
            for k in mine for ri, _ in groups[k])
        decision = self.autoscaler.decide(
            host_id, depth,
            tasks_per_invocation=max(1, tasks // max(depth, 1)),
            padding_waste=self.compiler.stats.padding.waste_frac,
            # dispatched-but-unharvested work on this host's stream is
            # occupancy, not queue depth — never provisioned for twice
            in_flight=state.queues[host_id].in_flight,
            roofline_inv_s=lambda: roofline_pending_inv_s(
                state.requests, {k: groups[k] for k in mine}))
        state.info.autoscale.append(decision)
        return max(1, decision.n_workers * pool.lanes_per_worker())

    def _book_harvest(self, state: TopologyDrainState, pb: PendingBucket,
                      results: Dict, elapsed: float):
        """Booking callback fired at harvest: ledgers, bills, autoscaler
        EMA for the launching host, wave close-out, checkpoint."""
        per_req = self._book_direct(state, pb.entries, results, elapsed)
        if self.autoscaler is not None and pb.entries:
            self.autoscaler.observe(pb.host, elapsed / len(pb.entries))
        if per_req:                     # a fully-failed slice books nothing
            self._note_wave(state, list(per_req), elapsed)
        state.info.pages = self.topology.page_stats()
        self._checkpoint(state)

    def _host_wave(self, state: TopologyDrainState, host_id: int,
                   mine: List, groups) -> None:
        """Dispatch one wave of this host's buckets WITHOUT waiting —
        the launches land on the host's stream and in its in-flight
        queue and are booked by a later step's harvest, so every other
        host's placement, stealing and booking overlaps this host's
        device work."""
        lane = state.info.topology.hosts[host_id]
        q = state.queues[host_id]
        book = lambda pb, res, el: self._book_harvest(state, pb, res, el)
        capacity = self._wave_capacity(state, host_id, mine, groups)
        # fill the wave bucket-by-bucket, truncating the last bucket to
        # the remaining capacity; each selection takes at least one
        # invocation, so a wave always makes progress
        selected: List[Tuple[object, List]] = []
        taken = 0
        for key in mine:
            if taken >= capacity and selected:
                break
            ents = groups[key][:max(capacity - taken, 1)]
            selected.append((key, ents))
            taken += len(ents)
        for key, ents in selected:
            running: Dict[int, List[int]] = {}
            for ri, inv in ents:
                running.setdefault(ri, []).append(inv)
            for ri, invs in running.items():
                state.requests[ri].ledger.mark_running(invs)
            decision = self._plan_host_axis(state, key, ents, host_id)
            compiler, b_align, axis_mesh = self._bucket_compiler(host_id,
                                                                 decision)
            bd = self._dispatch(state, key, ents, host=host_id,
                                compiler=compiler, b_align=b_align,
                                axis_decision=decision, mesh=axis_mesh)
            self._push_bucket(state, q, bd, book, host=host_id)
            state.seen_buckets.add(key)
        lane.waves += 1
        lane.invocations += taken
        state.info.waves += 1
        state.info.buckets = len(state.seen_buckets)
        state.info.pages = self.topology.page_stats()

    # ---- fault tolerance ----------------------------------------------
    def _hedge_dispatch_kwargs(self, state: DrainState, bkey, entries,
                               host: int) -> Dict:
        """A hedge leg runs on ``host`` through the shared cache, as the
        JAX package's does: the bucket's axis decision there and, for a
        data/feature one, the host's mesh with it.  A task bucket's hedge
        is the one-device task program, bit for bit its original for the
        families of ``MORPH_BITWISE_FAMILIES`` wherever that ran."""
        decision = self._plan_host_axis(state, bkey, entries, host)
        _, _, axis_mesh = self._bucket_compiler(host, decision)
        return {"host": host, "axis_decision": decision, "mesh": axis_mesh}

    def _maybe_hedge(self, state: TopologyDrainState) -> int:
        """Cross-host hedging: the duplicate leg of an overdue bucket
        lands on the least-loaded *other* live host's stream, so
        whichever leg lands first books bitwise-identical rows."""
        if not self._hedge_armed(state):
            return 0
        ids = [h.host_id for h in self.topology.alive()
               if h.host_id in state.queues]
        n = 0
        for hid in ids:
            q = state.queues[hid]
            for pb in q.overdue():
                others = [i for i in ids if i != hid] or [hid]
                target = min(
                    others, key=lambda i: state.queues[i].in_flight)
                self._hedge_bucket(state, pb, q, state.queues[target],
                                   host=target)
                n += 1
        return n

    def kill_host(self, state: TopologyDrainState, host_id: int) -> int:
        """Lose one host mid-drain (the chaos suite's host-loss fault):
        its pool is invalidated, its queue's in-flight buckets are
        abandoned (sole abandon performer — their ledger rows stay
        RUNNING, so once the dead queue stops shadowing them the
        pending view resurfaces exactly the orphaned invocations), and
        its bucket assignments are cleared so ``_route`` re-places them
        on the survivors, whose pools re-materialize any orphaned pages
        on first touch.  The abandoned launches still run out on the
        dead host's stream; nothing reads their results.  Returns the
        number of abandoned buckets."""
        topo = self.topology
        if host_id in topo.dead:
            return 0
        topo.kill(host_id)
        q = state.queues.pop(host_id, None)
        orphans = q.abandon() if q is not None else []
        for key in [k for k, h in state.assignment.items()
                    if h == host_id]:
            del state.assignment[key]
        info = state.info.topology
        info.host_losses += 1
        info.lost_buckets += len(orphans)
        state.info.pages = topo.page_stats()
        state.refresh()
        return len(orphans)

    # ---- the stream scheduler -----------------------------------------
    def step(self, state: TopologyDrainState) -> bool:
        """Advance ONE host stream by one wave (round-robin); False once
        no host has pending or in-flight work.  Every step first books
        any landed buckets on any host (non-blocking) and hedges any
        overdue ones, so harvest is interleaved with — and overlapped
        by — dispatch on other hosts."""
        try:
            return self._step(state)
        finally:
            state.refresh()

    def _step(self, state: TopologyDrainState) -> bool:
        book = lambda pb, res, el: self._book_harvest(state, pb, res, el)
        for q in state.queues.values():
            q.harvest_ready(book)
        self._maybe_hedge(state)
        groups = state.plan.pending_by_bucket(
            exclude=state.in_flight_entries())
        gate_wait = None
        if state.retry_at:              # failed rows awaiting backoff
            gated = {}
            for key in list(groups):
                ents, wait = self._backoff_filter(state, groups[key])
                if wait is not None:
                    gate_wait = wait if gate_wait is None \
                        else min(gate_wait, wait)
                if ents:
                    gated[key] = ents
            groups = gated
        ids = [h.host_id for h in self.topology.alive()
               if h.host_id in state.queues]
        n = len(ids)
        if not groups:
            if not n:
                return False
            # nothing dispatchable: drain in-flight work.  A blocking
            # harvest would sleep out a held straggler's hold and
            # defeat the hedge race, so with hedging armed poll instead
            if self._hedge_armed(state) \
                    and any(not state.queues[h].empty for h in ids):
                if not sum(state.queues[h].harvest_ready(book)
                           for h in ids):
                    time.sleep(0.001)
                return True
            for off in range(n):
                h = ids[(state.cursor + off) % n]
                if state.queues[h].harvest_next(book):
                    state.cursor = (state.cursor + off + 1) % n
                    return True
            if gate_wait is not None:   # only backoff gates remain
                time.sleep(min(gate_wait, 0.05))
                return True
            return False
        self._route(state, groups)      # retries may resurface buckets
        for off in range(n):
            h = ids[(state.cursor + off) % n]
            mine = [k for k in groups if state.assignment[k] == h]
            if not mine and self.pool.steal:
                mine = self._try_steal(state, groups, h)
            if not mine:
                continue
            self._host_wave(state, h, mine, groups)
            state.cursor = (state.cursor + off + 1) % n
            return True
        return False

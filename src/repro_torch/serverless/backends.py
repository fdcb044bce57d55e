"""The pluggable execution layer: one task grid, thin schedulers.

A ``WorkRequest`` is the compiled form of one estimation request: the task
grid, the fused arrays (targets, training weights), one or more
``Segment``s (contiguous learner groups — mixed-learner grids such as IRM
carry one segment per distinct learner), and a durable ``TaskLedger``.

Execution goes through the **megabatch compiler** (repro_torch/compile):
the union of every pending request's tasks is bucketed by (learner
family, padded N, padded P), stacked into ``(B, N_pad, P_pad)`` tensors
with validity masks, and run by one program per bucket (the CUDA
batched_gram / batched_predict kernels on the linear path).  Each backend
is a thin scheduler over those buckets — and every backend is a **stream
scheduler**: the unit of work is one ``step()`` over a live ``DrainState``
whose request set can grow between steps (continuous admission from the
session layer), with ``run_requests`` kept as the batch wrapper (admit
everything, step until idle).

  WaveBackend     the serverless-analogue wave scheduler (paper §4):
                  capacity-limited waves of invocations filled in whole
                  buckets, two waves in flight, identity-keyed fault
                  injection + backoff retries (serverless/chaos.py),
                  deadline-based hedged re-dispatch, elastic worker
                  schedules or the occupancy autoscaler
                  (serverless/autoscale.py), Lambda billing in
                  GB-seconds, measured or simulated.  Waves are SHARED
                  across requests.
  InlineBackend   one pending bucket slice dispatched per step — the
                  reference scheduler.
  ShardedBackend  the same drain over a device mesh (launch/mesh.py):
                  every bucket's parallelization axis is roofline-priced
                  (compile/buckets.py::plan_bucket_axis), logged on
                  ``BackendRunInfo.axis_plans`` and executed — a bucket
                  taller than one device page streams its rows through
                  the blocked Gram kernel (sharding/gram.py).  Only the
                  one-device mesh exists so far; there its task path is
                  the inline task path, bit for bit.

Dispatch is **non-blocking**: a step launches its buckets and returns
with the results still in flight (compile/program.py::dispatch_bucket);
each drain stream queues them (serverless/dispatch.py) and books a
bucket at a later step's harvest, so host booking overlaps device
execution.

``BACKEND_NAMES`` also lists ``topology`` so that plans and payloads
carry across; asking ``make_backend`` for it raises
``NotImplementedError`` until it is ported.

All backends emit the same ``RunReport``/``TaskLedger`` artifacts, and
each holds a persistent spec-keyed ``ProgramCache`` so repeat traffic
through a ``DMLSession`` never rebuilds a program, and (unless
``PoolConfig.page_pool_bytes`` is 0) a device-resident ``PagePool`` so
steady-state serving re-uploads no feature page.

Determinism contract: every task draws its PRNG stream as
fold_in(key(segment seed), flat task id) at *compile* time (the words of
JAX's Threefry keys, ``repro_torch/threefry.py``), so predictions are
independent of backend, bucket composition, schedule, admission order and
fault pattern.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING, Callable, Dict, List, Optional, Protocol, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.analysis.registry import warm_cache
from repro_torch.runtime import DeviceLike, bounded_put, resolve_device
from repro_torch.serverless.autoscale import (
    AutoscaleDecision, OccupancyAutoscaler,
)
from repro_torch.serverless.chaos import chaos_plan
from repro_torch.serverless.cost import Bill, BillingRecord, speedup_of
from repro_torch.serverless.dispatch import (
    BookFn, DispatchQueue, DispatchStats, HedgePair, PendingBucket,
)
from repro_torch.serverless.ledger import DONE, TaskLedger

if TYPE_CHECKING:       # avoid the core <-> serverless import cycle
    from repro_torch.compile import (
        CompileStats, MegabatchPlan, PagePool, PageStats, ProgramCache,
    )
    from repro_torch.core.crossfit import TaskGrid


def _compile():
    """Deferred import of the megabatch compiler.

    repro_torch.compile reaches into repro_torch.core.crossfit whose
    package __init__ imports this module (spec.py needs BACKEND_NAMES),
    so the compiler must load lazily — at which point the cycle is
    already resolved.
    """
    import repro_torch.compile as compile_mod
    return compile_mod


# Content-keyed cache of computed key tables: steady serving re-compiles
# the same (plan, data) into fresh WorkRequests every drain, and the
# fold_in table is a pure function of (segment seed, n_tasks).  Bounded
# FIFO: serving mixes cycle a small set of segment seeds.  Entries are
# shared between requests: nothing may write to them.
_KEY_TABLE_CACHE: Dict[Tuple, np.ndarray] = {}
_KEY_TABLE_CACHE_MAX = 512
# structural cache of WorkRequest index maps (see _index_maps)
_INDEX_MAP_CACHE: Dict[Tuple, Tuple] = {}


@warm_cache(name="fold_in_key_tables",
            key=("base_key", "n_tasks", "key_ref"))
def _segment_key_table(base_key: int, n_tasks: int,
                       key_ref: Optional[Tuple] = None) -> np.ndarray:
    """(n_tasks, 2) int64: the words of fold_in(key(base_key), t) for
    every flat task id t, computed on the CPU."""
    ck = (("ref", key_ref) if key_ref is not None
          else ("seed", int(base_key))) + (int(n_tasks),)
    table = _KEY_TABLE_CACHE.get(ck)
    if table is None:
        table = threefry.fold_in(threefry.key(base_key),
                                 torch.arange(int(n_tasks))).numpy()
        table.flags.writeable = False
        bounded_put(_KEY_TABLE_CACHE, ck, table, _KEY_TABLE_CACHE_MAX)
    return table


# ---------------------------------------------------------------------------
# substrate configuration (immutable — plans/sessions share PoolConfigs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PoolConfig:
    """The knobs the paper's user controls (§4.2, §5.2).

    Frozen: reusing one PoolConfig across estimators/sessions must never
    let one caller's settings leak into another's (use
    ``dataclasses.replace`` to derive variants).

    The fields and their defaults are the JAX package's, one for one.
    """
    n_workers: int = 8                  # concurrent lambda-analogue workers
    memory_mb: int = 1024               # Lambda memory knob
    scaling: str = "n_rep"              # paper's scaling parameter
    timeout_s: float = 900.0            # Lambda 15-min cap
    max_retries: int = 3
    failure_rate: float = 0.0           # fault injection (per invocation)
    straggler_rate: float = 0.0         # P(invocation is a straggler)
    straggler_slowdown: float = 4.0
    simulate: bool = False              # model durations via the speed curve
    base_work_s: float = 0.0            # simulated seconds per task @1 vCPU
    dispatch_overhead_s: float = 0.005  # per-wave dispatch latency
    seed: int = 0
    checkpoint_path: Optional[str] = None
    # elasticity: optional static schedule of worker counts per wave
    worker_schedule: Optional[Sequence[int]] = None
    # occupancy-driven autoscaling
    autoscale: bool = False
    min_workers: int = 1
    max_workers: int = 64
    autoscale_cost_weight: float = 1.0
    # device-resident feature-page pool budget (compile/pages.py); 0
    # turns the pool off and stacks pages on the host per launch
    page_pool_bytes: int = 256 * 1024 * 1024
    # topology backend: number of simulated host meshes, work stealing
    n_hosts: int = 2
    steal: bool = True
    # same-shape block fusion (compile/program.py): equal-B blocks of a
    # bucket slice go up in one launch, bit for bit the per-block ones
    fuse: bool = True
    # non-blocking dispatch: buckets a drain stream may hold in flight
    max_inflight: int = 8
    # cross-shape coalescing (compile/program.py): pack/morph tail
    # blocks of the MORPH_BITWISE_FAMILIES into combined launches;
    # tolerance-tier families also need morph_tolerance > 0, an explicit
    # opt-out of bitwise reproducibility
    coalesce: bool = True
    morph_tolerance: float = 0.0
    # double-buffered dispatch: waves a drain may hold unsettled
    pipeline_depth: int = 2
    # capped exponential backoff before a failed invocation is
    # re-dispatched
    retry_backoff_s: float = 0.0
    retry_backoff_cap_s: float = 0.25
    # synthetic straggler long tail
    straggler_hold_s: float = 0.0
    # hedged re-dispatch of overdue buckets
    hedge: Optional[bool] = None
    hedge_after_s: Optional[float] = None

    def lanes_per_worker(self) -> int:
        """Worker 'memory' buys lane width."""
        return max(1, self.memory_mb // 256)


@dataclass
class RunReport:
    fit_time_s: float = 0.0
    response_time_s: float = 0.0
    waves: int = 0
    bill: Bill = field(default_factory=Bill)
    wave_sizes: List[int] = field(default_factory=list)
    failures: int = 0
    stragglers: int = 0

    def summary(self) -> Dict:
        out = {"fit_time_s": self.fit_time_s,
               "response_time_s": self.response_time_s,
               "waves": self.waves, "failures": self.failures,
               "stragglers": self.stragglers}
        out.update(self.bill.summary())
        return out


# ---------------------------------------------------------------------------
# the unit of execution
# ---------------------------------------------------------------------------
@dataclass
class Segment:
    """A learner-uniform slice of a request's grid.

    ``l_ids`` are the nuisance indices this segment owns; its invocations
    are exactly those with ``inv % L in l_ids`` (both scaling levels place
    l in the low digit of the invocation id).

    ``learner``/``params`` name a registry learner with compile-time
    resolved hyperparameters — the megabatch compiler buckets on them and
    resolves the family's ``batched_fit_predict``.  ``learner_fn`` is the
    opaque-callable path (``compile_raw_request``): such segments run a
    shared-X callable through ``as_batched`` at exact shapes.
    ``cache_key`` is the hashable spec identity — requests built from
    equal specs share warm programs; when absent, buckets fall back to
    object identity.

    ``key`` is the segment's integer seed: task t draws
    fold_in(key(seed), t) (``repro_torch/threefry.py``), fixed at compile
    time so no schedule can perturb the estimate.  ``key_ref`` is a
    hashable identity of ``key``: when present, the key-table cache is
    keyed by it.
    """
    l_ids: Tuple[int, ...] = ()
    key: int = 0
    cache_key: Optional[Tuple] = None
    learner: Optional[str] = None
    params: Tuple = ()
    key_ref: Optional[Tuple] = None
    learner_fn: Optional[Callable] = None

    @property
    def bucket_id(self):
        """Value identity when the spec is known, object identity else."""
        if self.cache_key is not None:
            return self.cache_key
        return ("opaque", id(self.learner_fn))


def fingerprint_array(x) -> Tuple[str, Tuple[int, ...]]:
    """Content identity of a feature matrix, so two requests over equal
    data can share one page."""
    arr = np.ascontiguousarray(np.asarray(x, np.float32))
    return (hashlib.sha1(arr.tobytes()).hexdigest(), arr.shape)


@dataclass
class WorkRequest:
    """One estimation request, compiled to arrays + a durable ledger."""
    grid: TaskGrid
    scaling: str                        # invocation granularity (§4.2)
    x: np.ndarray                       # (N, P), on the host
    targets: np.ndarray                 # (L, N)
    train_w: np.ndarray                 # (M, K, L, N)
    segments: List[Segment]
    ledger: TaskLedger
    report: RunReport
    tag: object = None                  # caller's request id
    fold_masks: Optional[np.ndarray] = None   # (M,K,N), set by the compiler
    data_key: object = None             # content identity of x
    # content identity of (targets, train_w, segment keys): when set by
    # the front-end (compile_request), the compiler may cache this
    # request's stacked block tensors across drains — steady serving
    # re-lowers identical (plan, data) pairs every round.  None disables
    # the cache.
    work_key: object = None

    @classmethod
    def create(cls, grid: TaskGrid, scaling: str, x, targets, train_w,
               segments: List[Segment],
               ledger: Optional[TaskLedger] = None,
               report: Optional[RunReport] = None,
               tag: object = None, data_key: object = None,
               work_key: object = None) -> "WorkRequest":
        n_obs = int(np.asarray(targets).shape[-1])
        n_inv = grid.n_invocations(scaling)
        tpi = grid.tasks_per_invocation(scaling)
        if ledger is None:
            ledger = TaskLedger.create(n_inv, n_obs, tpi)
        elif (ledger.n_invocations, ledger.tasks_per_invocation,
              ledger.n_obs) != (n_inv, tpi, n_obs):
            raise ValueError(
                f"ledger shape ({ledger.n_invocations}, "
                f"{ledger.tasks_per_invocation}, {ledger.n_obs}) does not "
                f"match grid/scaling/data ({n_inv}, {tpi}, {n_obs}) — was it "
                "saved under a different plan?")
        if data_key is None:
            data_key = fingerprint_array(x)
        return cls(grid=grid, scaling=scaling, x=np.asarray(x),
                   targets=np.asarray(targets), train_w=np.asarray(train_w),
                   segments=segments, ledger=ledger,
                   report=report or RunReport(), tag=tag, data_key=data_key,
                   work_key=work_key)

    # ---- derived index maps (cached) ------------------------------------
    # the grid's coordinate methods are pure functions of its scalar
    # shape fields (all keyed) — hence covers under grid.n_rep; the
    # per-instance memo self._maps is ambient
    @warm_cache(name="work_request_index_maps",
                key=("self.grid.n_rep", "self.grid.n_folds",
                     "self.grid.n_nuisance", "self.scaling",
                     "self.segments"),
                reads=("self.grid.invocation_task_ids",
                       "self.grid.task_coords",
                       "self.grid.n_invocations"),
                covers={"self.grid.n_rep": (
                    "self.grid.invocation_task_ids",
                    "self.grid.task_coords",
                    "self.grid.n_invocations")},
                ambient=("self._maps",))
    def _index_maps(self):
        if not hasattr(self, "_maps"):
            g = self.grid
            # structural cache: the maps depend only on (grid, scaling,
            # segment l_ids) — steady serving re-creates equal-structure
            # requests every drain and shares one entry
            ck = (g.n_rep, g.n_folds, g.n_nuisance, self.scaling,
                  tuple(s.l_ids for s in self.segments))
            maps = _INDEX_MAP_CACHE.get(ck)
            if maps is None:
                task_mat = g.invocation_task_ids(
                    np.arange(g.n_invocations(self.scaling)), self.scaling)
                tm, tk, tl = g.task_coords()
                seg_of_l = np.zeros(g.n_nuisance, np.int64)
                for si, seg in enumerate(self.segments):
                    for l in seg.l_ids:
                        seg_of_l[l] = si
                maps = (task_mat, tm, tk, tl, seg_of_l)
                bounded_put(_INDEX_MAP_CACHE, ck, maps, 512)
            self._maps = maps
        return self._maps

    def segment_of_inv(self, inv: np.ndarray) -> np.ndarray:
        _, _, _, _, seg_of_l = self._index_maps()
        return seg_of_l[np.asarray(inv) % self.grid.n_nuisance]

    def invocation_tasks(self, inv: int) -> np.ndarray:
        """Flat task ids of one invocation (tpi,)."""
        return self._index_maps()[0][int(inv)]

    def task_key_data(self, seg_idx: int, flat_tasks: np.ndarray) -> np.ndarray:
        """Per-task PRNG key data: the (B, 2) uint32 words (in int64) of
        fold_in(key(segment seed), flat task id).

        Fixed at compile time and cached per segment, so a task's stream
        is identical however buckets, waves, retries or shards slice the
        grid — the determinism contract for key-consuming learners.  The
        linear families pass it through unused.
        """
        if not hasattr(self, "_key_tables"):
            self._key_tables: Dict[int, np.ndarray] = {}
        table = self._key_tables.get(seg_idx)
        if table is None:
            seg = self.segments[seg_idx]
            table = _segment_key_table(seg.key, self.grid.n_tasks,
                                       key_ref=seg.key_ref)
            self._key_tables[seg_idx] = table
        return table[np.asarray(flat_tasks, np.int64)]

    def wave_arrays(self, flat_tasks: np.ndarray):
        """Gather (targets, weights) rows for flat task ids."""
        _, tm, tk, tl = self._index_maps()[:4]
        y = self.targets[tl[flat_tasks]]
        w = self.train_w[tm[flat_tasks], tk[flat_tasks], tl[flat_tasks]]
        return y, w

    def gathered_preds(self) -> np.ndarray:
        """Scatter ledger rows back to the (M, K, L, N) tensor."""
        g = self.grid
        task_mat, tm, tk, tl, _ = self._index_maps()
        flat = task_mat.reshape(-1)
        n_obs = self.ledger.n_obs
        out = np.zeros((g.n_rep, g.n_folds, g.n_nuisance, n_obs), np.float32)
        out[tm[flat], tk[flat], tl[flat]] = \
            self.ledger.preds.reshape(-1, n_obs)
        return out


class ExecutionBackend(Protocol):
    """Anything that can drain a stream of WorkRequests.

    The streaming contract is three primitives: ``begin_drain()`` opens a
    ``DrainState``; ``admit(state, req)`` lowers one request into the live
    bucket plan (legal at any point, including mid-drain); ``step(state)``
    performs one scheduling quantum — a wave (WaveBackend) or one bucket
    slice (Inline/Sharded) — books
    ledgers/billing, and returns False once nothing is pending.
    ``run_requests`` is the batch wrapper: after it returns, every
    request's ledger is complete (or an exception was raised), its report
    reflects the work performed in this call (appending to any prior
    state), and ``req.gathered_preds()`` yields the (M, K, L, N)
    prediction tensor.  Pre-completed ledger rows (resume) must not be
    re-executed.
    """
    name: str

    def begin_drain(self) -> "DrainState":
        ...

    def admit(self, state: "DrainState", req: WorkRequest) -> int:
        ...

    def step(self, state: "DrainState") -> bool:
        ...

    def run_requests(self, requests: Sequence[WorkRequest]) -> "BackendRunInfo":
        ...


@dataclass
class BackendRunInfo:
    """Cross-request accounting for one backend drain (session telemetry)."""
    backend: str
    waves: int = 0
    wave_members: List[List[object]] = field(default_factory=list)
    buckets: int = 0                    # distinct megabatch buckets drained
    compile: Optional[CompileStats] = None   # backend's warm-cache stats
    pages: Optional[PageStats] = None        # device page-pool accounting
    autoscale: List[AutoscaleDecision] = field(default_factory=list)
    dispatch: Optional[DispatchStats] = None  # in-flight queue accounting
    # per-bucket parallelization-axis decisions: one
    # compile.buckets.AxisDecision per (bucket, mesh size) the drain priced
    axis_plans: List[object] = field(default_factory=list)

    @property
    def shared_waves(self) -> int:
        """Waves that carried invocations from 2+ requests.  (Members
        lists are deduplicated at construction.)"""
        return sum(1 for m in self.wave_members if len(m) > 1)


@dataclass
class DrainState:
    """Mutable state of one continuous drain.

    Owns the incremental ``MegabatchPlan`` (its request list is the
    admission order), the pool's fault plan (``chaos``,
    serverless/chaos.py — None for fault-free pools, whose hot path
    then pays nothing), the retry-backoff gates, the in-flight dispatch
    ``queue`` and the cross-request ``BackendRunInfo``.  The session
    layer holds one of these per live drain and interleaves ``admit``
    with ``step``.
    """
    plan: "MegabatchPlan"
    info: BackendRunInfo
    chaos: Optional[object] = None      # serverless/chaos.py::ChaosPlan
    # (req slot, invocation) -> perf_counter time before which a failed
    # row may not be re-dispatched (capped exponential backoff)
    retry_at: Dict[Tuple[int, int], float] = field(default_factory=dict)
    wave: int = 0
    seen_buckets: set = field(default_factory=set)
    finalized: set = field(default_factory=set)
    queue: Optional[DispatchQueue] = None    # in-flight buckets (one stream)
    # pipelined waves dispatched but not yet settled (WaveBackend): each
    # settles — books ledgers, bills, finalizes — when its last bucket
    # lands; a drain retires only with none left
    waves_inflight: List = field(default_factory=list)
    # (bucket key, n_devices) -> AxisDecision memo: each bucket's
    # parallelization axis is priced once per drain per mesh size; the
    # decisions are also appended to info.axis_plans
    axis_planned: Dict = field(default_factory=dict)

    @property
    def requests(self) -> List[WorkRequest]:
        return self.plan.requests


def retire_drain(state: DrainState, where: str) -> None:
    """Retire a drain whose requests have all completed: discard the
    losing hedge legs still in flight, then check that nothing else was
    left behind."""
    if state.queue is not None:
        state.queue.discard_cancelled()
    assert_drained(state, where)


def assert_drained(state: DrainState, where: str) -> None:
    """A drain may only retire with its dispatch queue empty and every
    pipelined wave settled: an in-flight bucket or unsettled wave left
    behind is work billed but never booked."""
    n = len(state.queue) if state.queue is not None else 0
    assert n == 0, f"{where}: drain retiring with {n} bucket(s) in flight"
    assert not state.waves_inflight, \
        f"{where}: drain retiring with {len(state.waves_inflight)} " \
        "pipelined wave(s) unsettled"


# ---------------------------------------------------------------------------
# helpers shared by backends
# ---------------------------------------------------------------------------
def _raise_exhausted(inv: Optional[int]) -> None:
    if inv is not None:
        raise RuntimeError(f"invocation {inv} exceeded retry budget")


def roofline_pending_inv_s(requests, groups) -> Optional[float]:
    """Mean roofline-modeled invocation duration over bucketed pending
    entries (launch/roofline.py) — the autoscaler's cold-start pricing
    signal, replacing the unit-work model before any duration has been
    observed.  Opaque-callable buckets carry no analytic model and are
    skipped; returns None when nothing could be priced."""
    from repro_torch.launch.roofline import invocation_roofline_s
    total, n = 0.0, 0
    for key, entries in groups.items():
        ident = key.learner
        if not (isinstance(ident, tuple) and len(ident) == 2
                and isinstance(ident[0], str)) or ident[0] == "opaque":
            continue
        learner, ptuple = ident
        for ri, _ in entries:
            req = requests[ri]
            total += invocation_roofline_s(
                learner, dict(ptuple),
                req.grid.tasks_per_invocation(req.scaling),
                key.n_pad, key.p_pad,
                # each invocation carries an amortized share of its
                # bucket's launch overhead
                amortized_launches=1.0 / len(entries))
            n += 1
    return total / n if n else None


def _fill_rows(req: WorkRequest, inv_ids: np.ndarray, wall: float,
               pool: PoolConfig):
    """Record successful rows with measured billing."""
    per = wall / max(len(inv_ids), 1)
    for inv in inv_ids:
        req.report.bill.add(BillingRecord(
            invocation=int(inv), duration_s=per, memory_mb=pool.memory_mb))


class _StreamBackend:
    """Shared streaming machinery: drain-state lifecycle, admission,
    completion finalization, checkpoints, fault-tolerant dispatch and
    the batch wrapper."""
    name: str
    pool: PoolConfig
    compiler: "ProgramCache"
    pages: Optional["PagePool"]
    device: torch.device

    def _init_pools(self) -> None:
        """The backend's warm state: its program cache and, unless the
        pool's budget is 0, its device-resident page pool on
        ``self.device``."""
        self.compiler = _compile().ProgramCache()
        self.pages = _compile().PagePool(self.pool.page_pool_bytes,
                                         device=self.device) \
            if self.pool.page_pool_bytes else None

    def begin_drain(self) -> DrainState:
        info = BackendRunInfo(backend=self.name)
        info.compile = self.compiler.stats
        if self.pages is not None:
            info.pages = self.pages.stats
        state = DrainState(plan=_compile().MegabatchPlan(), info=info)
        state.chaos = chaos_plan(self.pool)
        state.queue = DispatchQueue(self.pool.max_inflight)
        info.dispatch = state.queue.stats
        return state

    def admit(self, state: DrainState, req: WorkRequest) -> int:
        """Lower one request into the live plan.  The admission slot is
        the request's identity in the drain's fault plan
        (serverless/chaos.py): verdicts are drawn per (slot, invocation,
        attempt), so no schedule can perturb the fault pattern."""
        ri = state.plan.admit(req)
        self._finalize_request(state, ri)   # resumed-complete ledgers
        return ri

    def run_requests(self, requests: Sequence[WorkRequest]) -> BackendRunInfo:
        state = self.begin_drain()
        for req in requests:
            self.admit(state, req)
        while self.step(state):
            pass
        self._finish(state)
        return state.info

    # ------------------------------------------------------------------
    def _finish(self, state: DrainState):
        assert_drained(state, "backend finish")
        for ri in range(len(state.requests)):
            self._finalize_request(state, ri)

    def _finalize_request(self, state: DrainState, ri: int):
        """Close out one request's report the moment its ledger completes
        (the early-result hook the session's event loop polls)."""
        if ri in state.finalized:
            return
        req = state.requests[ri]
        if not req.ledger.complete:
            return
        state.finalized.add(ri)
        if self.pool.simulate:
            req.report.fit_time_s = (req.report.response_time_s
                                     + self.pool.dispatch_overhead_s)

    def _checkpoint(self, state: DrainState):
        for req in state.requests:
            req.ledger.checkpoint()      # no-op unless a path is bound
        if not self.pool.checkpoint_path:
            return
        for i, req in enumerate(state.requests):
            path = self.pool.checkpoint_path if len(state.requests) == 1 \
                else f"{self.pool.checkpoint_path}.r{i}"
            req.ledger.save(path)

    def _dispatch_opts(self) -> Dict:
        """The launch-scheduling knobs every dispatch_bucket call takes:
        fusion plus the cross-shape coalescing pair (coalesce gates the
        scheduler, morph_tolerance opts tolerance-tier families in)."""
        return {"fuse": self.pool.fuse, "coalesce": self.pool.coalesce,
                "morph_tolerance": self.pool.morph_tolerance}

    def _dispatch(self, state: DrainState, bkey, entries, **kw):
        """Launch one bucket slice on this backend's device, unwaited,
        with its page pool and scheduling knobs."""
        return _compile().dispatch_bucket(
            state.plan, self.compiler, bkey, entries, device=self.device,
            pages=self.pages, **self._dispatch_opts(), **kw)

    def _book_direct(self, state: DrainState, entries, results, wall: float):
        """Record one bucket launch: ledger bookings, billing, retries.

        Fault-free pools (``state.chaos is None``) batch-book everything
        with zero per-invocation work.  Chaos pools consult the fault
        plan per entry: a failed verdict books a failure (retry-budget
        checked) and arms a backoff gate in ``state.retry_at`` so the row
        re-enters the pending view only once its gate matures; survivors
        book normally.  Verdicts are identity-keyed, so this booking is
        legal in ANY order."""
        n_launch = max(len(entries), 1)
        plan = state.chaos
        exhausted: Optional[int] = None
        if plan is not None:
            now = time.perf_counter()
            ok: List[Tuple[int, int]] = []
            for ri, inv in entries:
                req = state.requests[ri]
                ledger = req.ledger
                if ledger.status[inv] == DONE:
                    continue             # lost a re-dispatch race (resume)
                v = plan.verdict(ri, inv, int(ledger.attempts[inv]))
                if v.straggler:
                    req.report.stragglers += 1
                if v.failed:
                    if not self._book_failure(state, ri, inv, now):
                        exhausted = inv
                    continue
                ok.append((ri, inv))
            entries = ok
        per_req: Dict[int, List[int]] = {}
        for ri, inv in entries:
            per_req.setdefault(ri, []).append(inv)
        for ri, invs in per_req.items():
            req = state.requests[ri]
            req.ledger.record_successes(
                invs, np.stack([results[(ri, inv)] for inv in invs]))
            _fill_rows(req, np.asarray(invs),
                       wall * len(invs) / n_launch, self.pool)
            req.report.waves += 1
            req.report.wave_sizes.append(len(invs))
        _raise_exhausted(exhausted)
        return per_req

    def _book_failure(self, state: DrainState, ri: int, inv: int,
                      now: float) -> bool:
        """Book one failed attempt and arm its retry gate (capped
        exponential backoff from ``now``).  False when the retry budget
        is spent: the caller defers the abort until the slice's sibling
        successes have booked (completed work is durable)."""
        req = state.requests[ri]
        ledger = req.ledger
        if ledger.attempts[inv] >= self.pool.max_retries:
            return False
        ledger.record_failure(inv)
        req.report.failures += 1
        if state.chaos is not None:
            state.retry_at[(ri, int(inv))] = \
                now + state.chaos.backoff_s(int(ledger.attempts[inv]))
        return True

    def _note_wave(self, state: DrainState, ris, step_wall: float):
        """Close out one direct-scheduler wave: the tag-deduped member
        list, per-request wall-time accounting, and early finalization
        (the wave backend has its own fault-aware variant)."""
        members = []
        for ri in ris:
            tag = state.requests[ri].tag
            tag = ri if tag is None else tag
            if tag not in members:
                members.append(tag)
        state.info.wave_members.append(members)
        for ri in ris:
            state.requests[ri].report.fit_time_s += step_wall
            state.requests[ri].report.response_time_s += step_wall
            self._finalize_request(state, ri)

    # ---- fault-tolerant dispatch --------------------------------------
    def _hedge_armed(self, state: DrainState) -> bool:
        """Hedged re-dispatch is on when the pool says so, else when a
        fault plan is active (chaos is what makes tails long) and a
        duplicate can win: on a CUDA device both legs run on the one
        stream in FIFO order, so the duplicate only beats an original
        that a synthetic straggler hold keeps not-ready."""
        if self.pool.hedge is not None:
            return self.pool.hedge
        if state.chaos is None:
            return False
        return self.device.type != "cuda" or self.pool.straggler_hold_s > 0

    def _deadline_for(self, state: DrainState, bkey,
                      entries) -> Optional[float]:
        """Overdue threshold for one dispatched bucket slice: the pool's
        fixed override, else the roofline-derived deadline capped by
        timeout_s.  None disarms hedging for this bucket."""
        if not self._hedge_armed(state) or not entries:
            return None
        pool = self.pool
        if pool.hedge_after_s is not None:
            return pool.hedge_after_s
        ident = bkey.learner
        if not (isinstance(ident, tuple) and len(ident) == 2
                and isinstance(ident[0], str)) or ident[0] == "opaque":
            # no analytic model: the Lambda cap is the only deadline
            return pool.timeout_s
        from repro_torch.launch.roofline import bucket_deadline_s
        learner, ptuple = ident
        req = state.requests[entries[0][0]]
        d = bucket_deadline_s(learner, dict(ptuple),
                              req.grid.tasks_per_invocation(req.scaling),
                              bkey.n_pad, bkey.p_pad, len(entries),
                              n_workers=len(entries))
        return min(d, pool.timeout_s)

    def _hold_for(self, state: DrainState, entries) -> float:
        """Synthetic straggler tail: when the pool opts in
        (straggler_hold_s > 0) and any entry of the slice draws a
        straggler verdict, the bucket reports not-ready for the hold —
        the long tail a hedged duplicate then beats."""
        plan = state.chaos
        hold = self.pool.straggler_hold_s
        if plan is None or hold <= 0:
            return 0.0
        for ri, inv in entries:
            att = int(state.requests[ri].ledger.attempts[inv])
            if plan.verdict(ri, inv, att).straggler:
                return hold
        return 0.0

    def _push_bucket(self, state: DrainState, q: DispatchQueue, bd,
                     book) -> PendingBucket:
        """Wrap one dispatched bucket with its fault-tolerance context
        (deadline, straggler hold) and enqueue it."""
        hold = self._hold_for(state, bd.entries)
        pb = PendingBucket(
            dispatch=bd,
            deadline_s=self._deadline_for(state, bd.key, bd.entries),
            not_ready_before=(time.perf_counter() + hold) if hold else 0.0)
        q.push(pb, book)
        return pb

    def _hedge_dispatch_kwargs(self, state: DrainState, bkey,
                               entries) -> Dict:
        """Extra dispatch kwargs a hedge must replicate so both legs run
        the identical program (bitwise race)."""
        return {}

    def _maybe_hedge(self, state: DrainState) -> int:
        """Duplicate-dispatch every overdue in-flight bucket (one stream:
        the duplicate lands on the same queue)."""
        q = state.queue
        if q is None or not self._hedge_armed(state):
            return 0
        n = 0
        for pb in q.overdue():
            self._hedge_bucket(state, pb, q)
            n += 1
        return n

    def _hedge_bucket(self, state: DrainState, pb: PendingBucket,
                      q: DispatchQueue) -> PendingBucket:
        """Launch the duplicate leg of an overdue bucket and wire the
        race: same key, same entries, same per-task keys — so whichever
        leg lands first books bitwise-identical results.  The winner's
        harvest settles the pair (``HedgePair.settle``, the sole cancel
        performer) and the loser is discarded unbooked."""
        running: Dict[int, List[int]] = {}
        for ri, inv in pb.entries:
            running.setdefault(ri, []).append(inv)
        for ri, invs in running.items():
            # RUNNING -> RUNNING (legal re-mark): a checkpoint taken
            # mid-race must still re-queue these rows on restart
            state.requests[ri].ledger.mark_running(invs)
        bd = self._dispatch(
            state, pb.key, list(pb.entries),
            **self._hedge_dispatch_kwargs(state, pb.key, pb.entries))
        pair = HedgePair()
        hpb = PendingBucket(dispatch=bd, book=pb.book, is_hedge=True,
                            pair=pair)
        pair.legs = [(pb, q), (hpb, q)]
        pb.state = "HEDGED"
        pb.pair = pair
        q.stats.hedges += 1
        q.push(hpb)
        return hpb

    def _drain_tail(self, state: DrainState, gate_wait: Optional[float],
                    book: Optional[BookFn] = None) -> bool:
        """A step with nothing to dispatch: book the in-flight tail, or
        wait out the earliest retry gate.  False once nothing is left."""
        q = state.queue
        if not q.empty and self._hedge_armed(state):
            # poll instead of blocking: a held straggler leg must not
            # stall the tail drain while its hedged duplicate can land
            # first and win the race
            self._maybe_hedge(state)
            if q.harvest_ready(book) == 0:
                time.sleep(0.001)
            return True
        if q.harvest_next(book):            # drain the in-flight tail
            return True
        if gate_wait is not None:
            # every pending row is backoff-gated: wait the earliest gate
            # out instead of spinning (or stalling the drain)
            time.sleep(min(gate_wait, 0.05))
            return True
        return False

    def _backoff_filter(self, state: DrainState,
                        entries) -> Tuple[List, Optional[float]]:
        """Drop entries whose retry gate has not matured; purge matured
        gates.  Returns (dispatchable entries, seconds until the
        earliest still-armed gate — None when nothing is gated)."""
        if not state.retry_at:
            return list(entries), None
        now = time.perf_counter()
        for e, t in list(state.retry_at.items()):
            if t <= now:
                del state.retry_at[e]
        if not state.retry_at:
            return list(entries), None
        out = [e for e in entries if (e[0], int(e[1])) not in state.retry_at]
        wait = min(state.retry_at.values()) - now
        return out, max(wait, 0.0)


class _BucketStreamBackend(_StreamBackend):
    """Inline/Sharded stepping: one pending bucket slice dispatched per
    step, harvested on a later step (non-blocking dispatch) — the step
    that dispatches bucket k+1 books bucket k's results while the device
    executes, so host booking overlaps device execution."""

    def _plan_axis(self, state: DrainState, bkey, entries):
        """Parallelization-axis planning hook: a single-device stream
        has nothing to shard, so the default plans nothing; a mesh-owning
        backend prices the candidates, logs the decision and returns it
        for ``dispatch_bucket`` to execute."""
        return None

    def _axis_mesh(self):
        """The mesh data/feature decisions lower onto; None keeps every
        bucket on the task axis."""
        return None

    def _book_harvest(self, state: DrainState, pb: PendingBucket,
                      results: Dict, elapsed: float):
        """Booking callback the queue fires at harvest: ledgers, bills,
        wave accounting, early finalization, checkpoint."""
        per_req = self._book_direct(state, pb.entries, results, elapsed)
        if per_req:     # chaos can fail a whole slice — nothing to book
            self._note_wave(state, list(per_req), elapsed)
        self._checkpoint(state)

    def _hedge_dispatch_kwargs(self, state: DrainState, bkey,
                               entries) -> Dict:
        return {"axis_decision": self._plan_axis(state, bkey, entries),
                "mesh": self._axis_mesh()}

    def step(self, state: DrainState) -> bool:
        q = state.queue
        book = lambda pb, res, el: self._book_harvest(state, pb, res, el)
        q.harvest_ready(book)               # opportunistic booking
        self._maybe_hedge(state)
        groups = state.plan.pending_by_bucket(
            exclude=q.in_flight_entries())
        gate_wait: Optional[float] = None
        if groups and state.retry_at:
            filtered = {}
            for bkey, entries in groups.items():
                ents, gate_wait = self._backoff_filter(state, entries)
                if ents:
                    filtered[bkey] = ents
            groups = filtered
        if not groups:
            return self._drain_tail(state, gate_wait, book)
        bkey, entries = next(iter(groups.items()))
        decision = self._plan_axis(state, bkey, entries)
        running: Dict[int, List[int]] = {}
        for ri, inv in entries:
            running.setdefault(ri, []).append(inv)
        for ri, invs in running.items():
            state.requests[ri].ledger.mark_running(invs)
        bd = self._dispatch(state, bkey, entries, axis_decision=decision,
                            mesh=self._axis_mesh())
        self._push_bucket(state, q, bd, book)
        state.seen_buckets.add(bkey)
        state.info.buckets = len(state.seen_buckets)
        state.info.waves += 1
        return True


# ---------------------------------------------------------------------------
# InlineBackend — direct bucket drain, the reference scheduler
# ---------------------------------------------------------------------------
class InlineBackend(_BucketStreamBackend):
    """Every pending bucket in one direct program call.  No capacity
    limit: the oracle the other schedulers must agree with."""
    name = "inline"

    def __init__(self, pool: Optional[PoolConfig] = None,
                 device: DeviceLike = "cuda"):
        self.pool = pool or PoolConfig()
        self.device = resolve_device(device)
        self._init_pools()


# ---------------------------------------------------------------------------
# ShardedBackend — the bucket drain over a device mesh
# ---------------------------------------------------------------------------
class ShardedBackend(_BucketStreamBackend):
    """The megabatch drain over ``mesh`` (default: the one-device mesh on
    ``device``).  Every bucket's parallelization axis is roofline-priced
    once per drain (compile/buckets.py::plan_bucket_axis), logged on
    ``BackendRunInfo.axis_plans`` and executed: on one device a bucket
    whose N_pad fits one device page runs the task program — the inline
    backend's, from the same kind of ``ProgramCache``, bit for bit, fused
    as the inline backend fuses (on a one-device mesh the fused program
    is the unpartitioned one) — and a taller Gram-family bucket runs the
    data@1 program, which streams its rows as N-chunks through
    ``batched_gram_blocked`` (pooled pages and tail packing, never
    fused)."""
    name = "sharded"

    def __init__(self, pool: Optional[PoolConfig] = None,
                 device: DeviceLike = "cuda", mesh=None):
        from repro_torch.launch.mesh import make_host_mesh
        self.pool = pool or PoolConfig()
        self.mesh = make_host_mesh(device) if mesh is None else mesh
        self.device = self.mesh.device
        self._init_pools()

    def _n_shards(self) -> int:
        return int(self.mesh.shape["data"])

    def _plan_axis(self, state: DrainState, bkey, entries):
        """Price the bucket's axis candidates on this mesh, log the
        decision (once per bucket per drain), and return it."""
        memo_key = (bkey, self._n_shards())
        if memo_key not in state.axis_planned:
            from repro_torch.compile.buckets import plan_bucket_axis
            decision = plan_bucket_axis(
                bkey, n_tasks=len(entries), n_devices=self._n_shards())
            state.axis_planned[memo_key] = decision
            if decision is not None:
                state.info.axis_plans.append(decision)
        return state.axis_planned[memo_key]

    def _axis_mesh(self):
        return self.mesh


# ---------------------------------------------------------------------------
# WaveBackend — the serverless-analogue scheduler, multi-request
# ---------------------------------------------------------------------------
@dataclass
class _Entry:
    """One dispatched lane: (request, invocation, speculative?)."""
    req_idx: int
    inv: int
    speculative: bool = False


@dataclass(eq=False)            # identity equality: removed by list.remove
class _WaveLatch:
    """One pipelined wave awaiting settlement (double-buffered dispatch).

    A wave does not barrier at the end of its step: its buckets stay in
    flight while the next wave is filled and stacked.  The latch
    accumulates the wave's results and frontier-attributed wall shares
    as each bucket's booking continuation fires, and the wave
    **settles** (ledgers booked, bills recorded, requests finalized,
    checkpoint written) the moment its last bucket lands.
    """
    dispatch: List[_Entry]
    outstanding: int                    # buckets still in flight
    results: Dict = field(default_factory=dict)
    wall_of_req: Dict = field(default_factory=dict)


class WaveBackend(_StreamBackend):
    """The paper's wave scheduler (§4) generalized to a request stream.

    One *invocation* = the paper's lambda call; each ``step`` dispatches
    one wave of up to ``n_workers * lanes_per_worker`` invocations drawn
    round-robin from every admitted request's pending set, so concurrent
    estimations share dispatch cycles (fused waves).  A wave's lanes are
    then grouped by megabatch bucket and executed as one bucket dispatch
    each — one warm program serves every task of a bucket regardless of
    which request it came from.  Per wave the scheduler:

      * books fault verdicts from the drain's identity-keyed fault plan
        (serverless/chaos.py) and re-queues failures with capped
        exponential backoff (Lambda retry, injected failures
        first-attempt-only so retries converge),
      * hedges overdue in-flight buckets with a duplicate dispatch
        (deadline from launch/roofline.py::bucket_deadline_s, capped by
        timeout_s) — first-landing wins, the losing leg is cancelled
        and never booked nor billed,
      * re-sizes the pool — static ``worker_schedule`` if given, else the
        occupancy autoscaler (queue depth x padding waste priced through
        the Lambda cost model) when ``pool.autoscale`` is set,
      * checkpoints every participating ledger.

    Billing: measured (a request's share of its buckets' wall time
    divided over its lanes) or modeled via the Lambda memory/vCPU curve
    (simulate=True).
    """
    name = "wave"

    def __init__(self, pool: Optional[PoolConfig] = None,
                 device: DeviceLike = "cuda"):
        self.pool = pool or PoolConfig()
        self.device = resolve_device(device)
        self._init_pools()
        self.autoscaler = OccupancyAutoscaler(self.pool) \
            if self.pool.autoscale else None

    # ------------------------------------------------------------------
    def _wave_workers(self, state: DrainState,
                      pendings: List[np.ndarray]) -> int:
        pool = self.pool
        if pool.worker_schedule is not None:           # static ramp
            return pool.worker_schedule[
                min(state.wave, len(pool.worker_schedule) - 1)]
        if self.autoscaler is not None:
            depth = sum(len(p) for p in pendings)
            tasks = sum(
                len(p) * req.grid.tasks_per_invocation(req.scaling)
                for p, req in zip(pendings, state.requests))
            # lazy thunk: the autoscaler invokes it only when no
            # higher-priority pricing signal (simulate model, EMA) exists
            decision = self.autoscaler.decide(
                depth,
                tasks_per_invocation=max(1, tasks // max(depth, 1)),
                padding_waste=self.compiler.stats.padding.waste_frac,
                in_flight=state.queue.in_flight,
                # pipelined waves can leave the queue non-empty here, so
                # the pricing view excludes in-flight entries — they are
                # occupancy, not dispatchable depth
                roofline_inv_s=lambda: roofline_pending_inv_s(
                    state.requests, state.plan.pending_by_bucket(
                        exclude=state.queue.in_flight_entries())))
            state.info.autoscale.append(decision)
            return decision.n_workers
        return pool.n_workers

    def _fill_bucket_coherent(self, state: DrainState,
                              pendings: List[np.ndarray],
                              capacity: int) -> List[_Entry]:
        """Fill a pipelined wave in whole-bucket units.

        Round-robin admission is fair but fragments a bucket's canonical
        tail blocks across waves: a 24-lane bucket cut 6/18 by the
        capacity limit pads to 8 + 24 lanes instead of one 24-lane
        launch.  So buckets small enough to ever travel whole are taken
        whole (in round-robin first-appearance order) or deferred to the
        next wave; only buckets larger than a full wave are split, and
        those split round-robin across each other so concurrent oversize
        requests still share dispatch cycles."""
        rr: List[_Entry] = []
        cursors = [0] * len(pendings)
        while True:
            progressed = False
            for ri, p in enumerate(pendings):
                if cursors[ri] < len(p):
                    rr.append(_Entry(ri, int(p[cursors[ri]])))
                    cursors[ri] += 1
                    progressed = True
            if not progressed:
                break
        groups = state.plan.group_entries([(e.req_idx, e.inv) for e in rr])
        batch: List[_Entry] = []
        oversized: List[List[Tuple[int, int]]] = []
        for ents in groups.values():           # first-appearance order
            if len(ents) > capacity:
                oversized.append(ents)         # can never travel whole
            elif len(ents) <= capacity - len(batch):
                batch.extend(_Entry(ri, inv) for ri, inv in ents)
            # else: whole-bucket sized but no room left — defer intact
        cur = [0] * len(oversized)
        while len(batch) < capacity:
            progressed = False
            for gi, ents in enumerate(oversized):
                if cur[gi] < len(ents) and len(batch) < capacity:
                    ri, inv = ents[cur[gi]]
                    batch.append(_Entry(ri, inv))
                    cur[gi] += 1
                    progressed = True
            if not progressed:
                break
        return batch

    def step(self, state: DrainState) -> bool:
        """Dispatch one wave and pipeline it: the wave's buckets stay in
        flight while the next step fills and stacks wave k+1, up to
        ``pool.pipeline_depth`` unsettled waves — under chaos too, since
        fault verdicts are identity-keyed (serverless/chaos.py) and so
        immune to dispatch order.  Books via per-wave latches
        (book-at-push); False once nothing is pending and the pipeline
        has drained."""
        pool = self.pool
        requests = state.requests
        q = state.queue
        # opportunistic booking: settle any wave whose buckets all
        # landed while the host was filling the previous wave; then
        # duplicate-dispatch anything overdue
        q.harvest_ready()
        self._maybe_hedge(state)
        # ledger.pending() includes RUNNING rows, so the wave fill must
        # exclude every entry still in flight: on the queue OR in an
        # unsettled wave latch — a harvested bucket leaves the queue
        # before its wave settles (and books), and re-dispatching its
        # rows would double-book them.  Failed rows under backoff stay
        # out until their retry gate matures.
        inflight = q.in_flight_entries()
        for latch in state.waves_inflight:
            inflight.update((e.req_idx, e.inv) for e in latch.dispatch)
        free = [(ri, int(i)) for ri, req in enumerate(requests)
                for i in req.ledger.pending() if (ri, int(i)) not in inflight]
        free, gate_wait = self._backoff_filter(state, free)
        by_req: List[List[int]] = [[] for _ in requests]
        for ri, inv in free:
            by_req[ri].append(inv)
        pendings = [np.asarray(p, np.int64) for p in by_req]
        if all(len(p) == 0 for p in pendings):
            return self._drain_tail(state, gate_wait)
        n_workers = self._wave_workers(state, pendings)
        capacity = max(1, n_workers * pool.lanes_per_worker())

        # ---- fill the wave (whole-bucket units) --------------------------
        dispatch = self._fill_bucket_coherent(state, pendings, capacity)

        # ---- execute: one bucket dispatch per bucket in the wave ---------
        members: List[object] = []
        for e in dispatch:
            tag = requests[e.req_idx].tag
            tag = e.req_idx if tag is None else tag
            if tag not in members:
                members.append(tag)
        state.info.wave_members.append(members)
        unique: Dict[Tuple[int, int], None] = {}
        for e in dispatch:
            unique.setdefault((e.req_idx, e.inv))
        running: Dict[int, List[int]] = {}
        for ri, inv in unique:
            running.setdefault(ri, []).append(inv)
        for ri, invs in running.items():
            requests[ri].ledger.mark_running(invs)
        # dispatch every bucket of the wave without waiting; the wave's
        # buckets carry a latch that settles (books + bills) when its last
        # bucket lands — possibly steps later, while wave k+1 is filling
        groups = state.plan.group_entries(list(unique))
        ctx = _WaveLatch(dispatch=dispatch, outstanding=len(groups))
        state.waves_inflight.append(ctx)

        def book(pb, res, elapsed):
            ctx.results.update(res)
            per = elapsed / max(len(pb.entries), 1)
            for ri, _ in pb.entries:
                ctx.wall_of_req[ri] = ctx.wall_of_req.get(ri, 0.0) + per
            ctx.outstanding -= 1
            if ctx.outstanding == 0:
                self._settle_wave(state, ctx)

        for bkey, ents in groups.items():
            state.seen_buckets.add(bkey)
            self._push_bucket(state, q, self._dispatch(state, bkey, ents),
                              book)
        state.wave += 1
        state.info.buckets = len(state.seen_buckets)
        state.info.waves = state.wave
        # bound the pipeline: harvest the oldest buckets until at most
        # pipeline_depth waves remain unsettled
        depth = max(1, pool.pipeline_depth)
        if self._hedge_armed(state):
            # poll, don't block: a blocked harvest picks the held
            # straggler and sleeps out the very hold the hedged
            # duplicate exists to beat
            while len(state.waves_inflight) > depth and not q.empty:
                self._maybe_hedge(state)
                if q.harvest_ready() == 0:
                    time.sleep(0.001)
        else:
            while len(state.waves_inflight) > depth and q.harvest_next():
                pass
        return True

    def _settle_wave(self, state: DrainState, ctx: _WaveLatch):
        """Book one pipelined wave the moment its last bucket lands:
        ledgers, bills, per-request wall attribution, finalization,
        checkpoint.  Wall time uses the queue's non-overlapping
        attribution frontier, so concurrent waves' billed spans sum to
        the true elapsed wall instead of double-charging overlap."""
        pool = self.pool
        requests = state.requests
        state.waves_inflight.remove(ctx)
        touched = []
        for ri, req in enumerate(requests):
            entries = [e for e in ctx.dispatch if e.req_idx == ri]
            if not entries:
                continue
            self._book_request_wave(state, req, ri, entries, ctx.results,
                                    pool, ctx.wall_of_req.get(ri, 0.0))
            touched.append(ri)
        if self.autoscaler is not None and ctx.dispatch:
            total = sum(ctx.wall_of_req.values())
            if total > 0:
                self.autoscaler.observe(total / len(ctx.dispatch))
        for ri in touched:
            wall = ctx.wall_of_req.get(ri, 0.0)
            requests[ri].report.response_time_s += wall
            requests[ri].report.fit_time_s += wall
            self._finalize_request(state, ri)
        self._checkpoint(state)

    # ------------------------------------------------------------------
    def _book_request_wave(self, state: DrainState, req: WorkRequest,
                           ri: int, entries: List[_Entry], results: Dict,
                           pool: PoolConfig, wall: float):
        """Book one request's share of a wave: billing, fault verdicts,
        retries.  Predictions were already computed by the wave's bucket
        launches (``results``) — chaos can only reorder or repeat work,
        never change an estimate.

        A fault-free pool consults nothing and batch-books (no draws, no
        per-invocation loop); a chaos pool sees the same fault schedule
        whatever order waves, hedges or retries book in."""
        tpi = req.grid.tasks_per_invocation(req.scaling)
        n_obs = req.ledger.n_obs
        ledger, report = req.ledger, req.report
        inv_arr = np.array([e.inv for e in entries], np.int64)

        preds_rows = np.empty((len(entries), tpi, n_obs), np.float32)
        for i, e in enumerate(entries):
            preds_rows[i] = results[(ri, e.inv)]

        plan = state.chaos
        if plan is None:
            # fault-free fast path: batch-book everything unless the
            # measured wall tripped the timeout cap — then fall through
            # to the general machinery
            per = wall / max(len(entries), 1)
            if per <= pool.timeout_s:
                ledger.record_successes(inv_arr, preds_rows)
                for e in entries:
                    report.bill.add(BillingRecord(
                        invocation=int(e.inv), duration_s=per,
                        memory_mb=pool.memory_mb))
                report.wave_sizes.append(len(entries))
                report.waves += 1
                return
            durs = np.full(len(entries), per)
            failed = durs > pool.timeout_s                # lambda cap
        else:
            # --- per-invocation verdicts and durations -------------------
            atts = ledger.attempts[inv_arr]
            verdicts = [plan.verdict(ri, int(e.inv), int(atts[i]))
                        for i, e in enumerate(entries)]
            if pool.simulate:
                base = pool.base_work_s * tpi / speedup_of(pool.memory_mb)
                durs = base * np.array([v.noise for v in verdicts])
            else:
                durs = np.full(len(entries), wall / max(len(entries), 1))
            is_strag = np.array([v.straggler for v in verdicts], bool)
            durs = np.where(is_strag, durs * pool.straggler_slowdown, durs)
            report.stragglers += int(is_strag.sum())
            # injected failures fire on attempt 0 only (retries converge)
            failed = np.array([v.failed for v in verdicts], bool)
            failed |= durs > pool.timeout_s               # lambda cap

        now = time.perf_counter()
        exhausted = None
        for i, e in enumerate(entries):
            if ledger.status[e.inv] == DONE:   # duplicate lost the race
                continue
            if failed[i]:
                if not self._book_failure(state, ri, e.inv, now):
                    exhausted = int(e.inv)
                continue
            ledger.record_success(int(e.inv), preds_rows[i])
            report.bill.add(BillingRecord(
                invocation=int(e.inv), duration_s=float(durs[i]),
                memory_mb=pool.memory_mb,
                retry=int(ledger.attempts[e.inv]),
                speculative=e.speculative))
        report.wave_sizes.append(len(entries))
        report.waves += 1
        if pool.simulate:
            # response time = slowest invocation in flight this wave
            report.response_time_s += float(np.max(durs)) \
                + pool.dispatch_overhead_s
        _raise_exhausted(exhausted)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
BACKENDS = {"wave": WaveBackend, "inline": InlineBackend,
            "sharded": ShardedBackend}
# every name a plan or payload may carry; only those in BACKENDS run
BACKEND_NAMES = tuple(BACKENDS) + ("topology",)


def make_backend(backend, pool: Optional[PoolConfig] = None,
                 device: DeviceLike = "cuda"):
    """Resolve a backend name (or pass through an instance)."""
    if isinstance(backend, str):
        if backend not in BACKEND_NAMES:
            raise KeyError(f"unknown backend {backend!r}; known: "
                           f"{BACKEND_NAMES}")
        if backend not in BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet; available: "
                f"{tuple(BACKENDS)}")
        return BACKENDS[backend](pool, device=device)
    return backend

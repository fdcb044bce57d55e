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

  InlineBackend   each pending bucket drained by one synchronous
                  ``run_bucket`` call per step — the reference scheduler.

``BACKEND_NAMES`` also lists ``wave``, ``sharded`` and ``topology`` so
that plans and payloads carry across; asking ``make_backend`` for one of
them raises ``NotImplementedError`` until it is ported.

All backends emit the same ``RunReport``/``TaskLedger`` artifacts, and
each holds a persistent spec-keyed ``ProgramCache`` so repeat traffic
through a ``DMLSession`` never rebuilds a program.

Determinism contract: a task's key — (segment seed, flat task id) — is
fixed at *compile* time, so predictions are independent of backend,
bucket composition, schedule and admission order.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch.runtime import DeviceLike, bounded_put, resolve_device
from repro_torch.serverless.cost import Bill, BillingRecord
from repro_torch.serverless.ledger import TaskLedger

if TYPE_CHECKING:       # avoid the core <-> serverless import cycle
    from repro_torch.compile import CompileStats, MegabatchPlan, ProgramCache
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


# structural cache of WorkRequest index maps (see _index_maps)
_INDEX_MAP_CACHE: Dict[Tuple, Tuple] = {}


# ---------------------------------------------------------------------------
# substrate configuration (immutable — plans/sessions share PoolConfigs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PoolConfig:
    """The knobs the paper's user controls (§4.2, §5.2).

    Frozen: reusing one PoolConfig across estimators/sessions must never
    let one caller's settings leak into another's (use
    ``dataclasses.replace`` to derive variants).

    The field list is the reference's.  Three defaults differ while the
    machinery behind them is not ported: ``fuse`` and ``coalesce`` are
    off and ``page_pool_bytes`` is 0, so every canonical block launches
    on its own with host-stacked pages.  A backend raises
    ``NotImplementedError`` for a pool that asks for more.
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
    # device-resident feature-page pool budget; 0 stacks pages on the
    # host per launch
    page_pool_bytes: int = 0
    # topology backend: number of simulated host meshes, work stealing
    n_hosts: int = 2
    steal: bool = True
    # same-shape block fusion: pack equal-canonical-B blocks of different
    # requests into one launch
    fuse: bool = False
    # non-blocking dispatch: buckets a drain stream may hold in flight
    max_inflight: int = 8
    # cross-shape coalescing: pack/morph tail blocks into combined
    # launches
    coalesce: bool = False
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


def _check_pool_supported(pool: PoolConfig) -> None:
    """Refuse pool settings whose machinery is not ported."""
    for name in ("fuse", "coalesce", "page_pool_bytes",
                 "failure_rate", "straggler_rate", "hedge"):
        if getattr(pool, name):
            raise NotImplementedError(
                f"PoolConfig.{name}={getattr(pool, name)!r} is not "
                "supported by this backend yet")


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
    resolves the family's ``batched_fit_predict``.  ``cache_key`` is the
    hashable spec identity — requests built from equal specs share warm
    programs.

    ``key`` is the segment's integer seed: task t's key is the pair
    (key, t), fixed at compile time so no schedule can perturb the
    estimate.  ``key_ref`` is a hashable identity of ``key``.
    """
    l_ids: Tuple[int, ...] = ()
    key: int = 0
    cache_key: Optional[Tuple] = None
    learner: Optional[str] = None
    params: Tuple = ()
    key_ref: Optional[Tuple] = None

    @property
    def bucket_id(self):
        return self.cache_key


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
        """Per-task key data: an int64 (B, 2) table of (segment seed,
        flat task id).

        Fixed at compile time, so a task's key is identical however
        buckets, launches or retries slice the grid.  The linear
        families pass it through unused.
        """
        tasks = np.asarray(flat_tasks, np.int64)
        seed = np.full_like(tasks, self.segments[seg_idx].key)
        return np.stack([seed, tasks], axis=1)

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
    performs one scheduling quantum — one bucket slice — books
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

    @property
    def shared_waves(self) -> int:
        """Waves that carried invocations from 2+ requests.  (Members
        lists are deduplicated at construction.)"""
        return sum(1 for m in self.wave_members if len(m) > 1)


@dataclass
class DrainState:
    """Mutable state of one continuous drain.

    Owns the incremental ``MegabatchPlan`` (its request list is the
    admission order) and the cross-request ``BackendRunInfo``.  The
    session layer holds one of these per live drain and interleaves
    ``admit`` with ``step``.
    """
    plan: "MegabatchPlan"
    info: BackendRunInfo
    seen_buckets: set = field(default_factory=set)
    finalized: set = field(default_factory=set)

    @property
    def requests(self) -> List[WorkRequest]:
        return self.plan.requests


# ---------------------------------------------------------------------------
# helpers shared by backends
# ---------------------------------------------------------------------------
def _fill_rows(req: WorkRequest, inv_ids: np.ndarray, wall: float,
               pool: PoolConfig):
    """Record successful rows with measured billing."""
    per = wall / max(len(inv_ids), 1)
    for inv in inv_ids:
        req.report.bill.add(BillingRecord(
            invocation=int(inv), duration_s=per, memory_mb=pool.memory_mb))


class _StreamBackend:
    """Shared streaming machinery: drain-state lifecycle, admission,
    completion finalization, checkpoints, and the batch wrapper."""
    name: str
    pool: PoolConfig
    compiler: "ProgramCache"
    device: torch.device

    def begin_drain(self) -> DrainState:
        info = BackendRunInfo(backend=self.name)
        info.compile = self.compiler.stats
        return DrainState(plan=_compile().MegabatchPlan(), info=info)

    def admit(self, state: DrainState, req: WorkRequest) -> int:
        """Lower one request into the live plan."""
        ri = state.plan.admit(req)
        self._finalize_request(state, ri)   # resumed-complete ledgers
        return ri

    def run_requests(self, requests: Sequence[WorkRequest]) -> BackendRunInfo:
        state = self.begin_drain()
        for req in requests:
            self.admit(state, req)
        while self.step(state):
            pass
        for ri in range(len(state.requests)):
            self._finalize_request(state, ri)
        return state.info

    # ------------------------------------------------------------------
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

    def _book_direct(self, state: DrainState, entries, results, wall: float):
        """Record one bucket launch: ledger bookings and billing,
        batch-booked per request (fault-free pools only)."""
        n_launch = max(len(entries), 1)
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
        return per_req

    def _note_wave(self, state: DrainState, ris, step_wall: float):
        """Close out one step: the tag-deduped member list, per-request
        wall-time accounting, and early finalization."""
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


class _BucketStreamBackend(_StreamBackend):
    """Synchronous stepping: each step takes the first pending bucket,
    marks its rows running, runs it to completion and books it."""

    def step(self, state: DrainState) -> bool:
        groups = state.plan.pending_by_bucket()
        if not groups:
            return False
        bkey, entries = next(iter(groups.items()))
        running: Dict[int, List[int]] = {}
        for ri, inv in entries:
            running.setdefault(ri, []).append(inv)
        for ri, invs in running.items():
            state.requests[ri].ledger.mark_running(invs)
        results, wall = _compile().run_bucket(
            state.plan, self.compiler, bkey, entries, device=self.device)
        per_req = self._book_direct(state, entries, results, wall)
        self._note_wave(state, list(per_req), wall)
        self._checkpoint(state)
        state.seen_buckets.add(bkey)
        state.info.buckets = len(state.seen_buckets)
        state.info.waves += 1
        return True


# ---------------------------------------------------------------------------
# InlineBackend — direct bucket drain, the reference scheduler
# ---------------------------------------------------------------------------
class InlineBackend(_BucketStreamBackend):
    """Every pending bucket in one direct program call.  No faults, no
    capacity limit: the oracle the other schedulers must agree with."""
    name = "inline"

    def __init__(self, pool: Optional[PoolConfig] = None,
                 device: DeviceLike = "cuda"):
        self.pool = pool or PoolConfig()
        _check_pool_supported(self.pool)
        self.device = resolve_device(device)
        self.compiler = _compile().ProgramCache()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
BACKENDS = {"inline": InlineBackend}
# every name a plan or payload may carry; only those in BACKENDS run
BACKEND_NAMES = ("wave", "inline", "sharded", "topology")


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

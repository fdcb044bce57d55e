"""The serving layer: plans + data in, per-request results out.

``DMLSession`` is the multi-request front door, built around a
**continuous-admission drain engine**: ``submit()`` enqueues a request
immediately; the engine admits queued requests into the backend's live
``DrainState`` (extending the megabatch bucket plan incrementally),
dispatches waves without a global barrier, and completes each request's
``TaskLedger`` the moment its buckets land — early requests deliver their
``DMLResult`` (and fire ``on_complete`` callbacks) while later ones are
still executing.  ``poll()`` advances the engine by one step (a wave on
the default wave backend, a bucket slice on inline/sharded); ``run()``
and ``estimate()`` are blocking wrappers over the same event loop.

Dispatch is **non-blocking**: a ``step()`` launches its buckets and
returns with the results still in flight on the device; the ledgers are
booked by a later step's harvest (each step first books any landed
buckets, blocking only when nothing is left to dispatch), so admission,
autoscaling, result assembly and callbacks overlap device execution.
``last_run_info.dispatch`` reports the measured overlap.  On the wave
backend the requests' task grids share dispatch waves.

``estimate(plan, data)`` is the one-shot convenience for a single request.

Every entry point takes an explicit ``device``.  The default is the card;
on a machine without one the default raises, and ``device="cpu"`` has to
be asked for.

Determinism: a request's result depends only on its own (plan, data) —
fold draws and score evaluation are keyed off ``plan.resampling.seed``,
and per-task keys are fixed at compile time — so a session-batched
request returns the predictions it would get running alone, regardless of
admission order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.core.aggregation import aggregate_thetas, confint
from repro_torch.core.bootstrap import boot_confint, multiplier_bootstrap
from repro_torch.core.crossfit import (
    TaskGrid, check_partition, draw_fold_masks, stitch_predictions,
    subset_mask,
)
from repro_torch.core.scores import evaluate_score, score_se, solve_theta
from repro_torch.core.spec import DMLData, DMLPlan, _hashable
from repro_torch.launch.roofline import measure_launch_overhead_s
from repro_torch.learners import resolve_params
from repro_torch.runtime import DeviceLike, resolve_device
from repro_torch.serverless.backends import (
    BackendRunInfo, DrainState, ExecutionBackend, PoolConfig, RunReport,
    Segment, WorkRequest, make_backend, retire_drain,
)
from repro_torch.serverless.ledger import TaskLedger


@dataclass
class DMLResult:
    theta: float
    se: float
    ci: tuple
    thetas: np.ndarray              # per-repetition estimates (M,)
    ses: np.ndarray
    report: RunReport
    boot_ci: Optional[tuple] = None
    request_id: Optional[int] = None

    def summary(self) -> Dict:
        out = {"theta": self.theta, "se": self.se, "ci": self.ci}
        out.update({f"exec_{k}": v for k, v in self.report.summary().items()})
        return out


# ---------------------------------------------------------------------------
# plan + data -> WorkRequest
# ---------------------------------------------------------------------------
def compile_request(plan: DMLPlan, data: DMLData,
                    ledger: Optional[TaskLedger] = None,
                    tag: object = None) -> WorkRequest:
    """Lower a declarative request to executable arrays.

    Builds the fold masks, per-nuisance targets and training weights, and
    groups nuisances that share a (learner, params) pair into one
    ``Segment`` so uniform grids run as a single fused batch while mixed
    grids get one fused batch per learner.  Pure numpy: nothing here
    touches a device.
    """
    data = DMLData.from_dict(data)
    rs = plan.resampling
    n = data.n_obs
    grid = TaskGrid(rs.n_rep, rs.n_folds, plan.n_nuisance)
    masks = draw_fold_masks(n, rs.n_folds, rs.n_rep, rs.seed)
    assert check_partition(masks)

    targets = np.stack([data.role(ns.target) for ns in plan.nuisances])
    train_w = np.empty((rs.n_rep, rs.n_folds, plan.n_nuisance, n), np.float32)
    for l, ns in enumerate(plan.nuisances):
        sub = subset_mask(ns.subset, data)
        w = (~masks).astype(np.float32)          # train on I^c_{m,k}
        if sub is not None:
            w = w * sub.astype(np.float32)[None, None, :]
        train_w[:, :, l, :] = w

    # one segment per distinct (learner, params): uniform grids fuse into a
    # single batch, mixed grids get one fused batch per learner.  Each
    # segment carries the spec the megabatch compiler buckets on —
    # hyperparameters resolved against the *data shape* here, so padded
    # bucket execution stays padding-invariant — and the integer seed its
    # tasks' keys derive from.
    groups: List[List[int]] = []
    seen: Dict = {}
    for l, ns in enumerate(plan.nuisances):
        gi = seen.get(ns.learner_key)
        if gi is None:
            seen[ns.learner_key] = len(groups)
            groups.append([l])
        else:
            groups[gi].append(l)
    segments = []
    for g in groups:
        ns = plan.nuisances[g[0]]
        params = resolve_params(ns.learner, ns.param_dict,
                                n_obs=n, dim_x=data.dim_x)
        ptuple = tuple(sorted((k, _hashable(v)) for k, v in params.items()))
        segments.append(Segment(l_ids=tuple(g),
                                key=rs.seed + g[0],
                                key_ref=("seed", rs.seed + g[0]),
                                cache_key=(ns.learner, ptuple),
                                learner=ns.learner, params=ptuple))

    # content identity of the request's task tensors: fold masks derive
    # from (seed, K, M), targets/train_w from (data CONTENT — all role
    # arrays, not just X — plus roles and subsets), per-task keys from
    # the segment seeds — so this tuple pins every stacked block tensor,
    # letting the compiler reuse them across drains.  ``content_key``
    # (not ``fingerprint``) is load-bearing: two datasets sharing one X
    # but different y/d/z must not share cached targets/weights.
    work_key = ("plan-v1", data.content_key(), rs.seed, rs.n_folds,
                rs.n_rep, plan.scaling,
                tuple((ns.target, ns.subset, ns.learner_key)
                      for ns in plan.nuisances))
    req = WorkRequest.create(grid, plan.scaling, data.x, targets, train_w,
                             segments, ledger=ledger, tag=tag,
                             data_key=data.fingerprint(), work_key=work_key)
    req.fold_masks = masks                      # needed for stitching
    return req


def compile_raw_request(grid: TaskGrid, scaling: str, x, targets, train_w,
                        learner_fn, key: int, *, ledger=None, report=None,
                        tag: object = None) -> WorkRequest:
    """Lower a raw-array request (an opaque user-supplied shared-X learner
    callable over explicit grid arrays) onto the same execution path as
    plan-built requests: one opaque-callable segment, run at exact shapes
    by the megabatch compiler through ``as_batched``.  ``key`` is the
    segment's integer seed: task t draws fold_in(key(seed), t), the
    stream of the reference's ``jax.random.key(seed)``.  Pure numpy, like
    ``compile_request``: the backend that drains the request picks the
    device."""
    seg = Segment(learner_fn=learner_fn,
                  l_ids=tuple(range(grid.n_nuisance)), key=int(key))
    return WorkRequest.create(grid, scaling, x, targets, train_w, [seg],
                              ledger=ledger, report=report, tag=tag)


def assemble_result(plan: DMLPlan, data: DMLData, req: WorkRequest,
                    request_id: Optional[int] = None,
                    device: DeviceLike = "cuda") -> DMLResult:
    """Stitch fold predictions, evaluate the score on ``device``, run
    local inference (the multiplier bootstrap's draws on ``device`` too)."""
    device = resolve_device(device)
    data = DMLData.from_dict(data)
    preds = req.gathered_preds()                 # (M, K, L, N)
    masks = req.fold_masks

    fitted = {ns.name: stitch_predictions(masks, preds[:, :, l])
              for l, ns in enumerate(plan.nuisances)}
    dml_data = {k: torch.as_tensor(v).to(device)[None] for k, v in
                data.score_arrays().items()}
    pred_tree = {k: torch.as_tensor(v).to(device) for k, v in fitted.items()}
    psi_a, psi_b = evaluate_score(plan.model, dml_data, pred_tree, plan.score)
    thetas = solve_theta(psi_a, psi_b)                  # (M,)
    ses = score_se(psi_a, psi_b, thetas)
    theta, se = aggregate_thetas(thetas, ses, plan.inference.aggregation)
    ci = confint(theta, se, plan.inference.level)

    boot_ci = None
    if plan.inference.n_boot:
        bt, se1 = multiplier_bootstrap(
            psi_a[0], psi_b[0], float(thetas[0]),
            threefry.key(plan.resampling.seed + 99, device=device),
            n_boot=plan.inference.n_boot)
        boot_ci = boot_confint(float(thetas[0]), se1, bt)

    res = DMLResult(theta=theta, se=se, ci=ci,
                    thetas=thetas.cpu().numpy(), ses=ses.cpu().numpy(),
                    report=req.report, boot_ci=boot_ci,
                    request_id=request_id)
    res.psi = (psi_a.cpu().numpy(), psi_b.cpu().numpy())
    return res


# ---------------------------------------------------------------------------
# the session: continuous-admission drain engine
# ---------------------------------------------------------------------------
@dataclass
class _Pending:
    request_id: int
    plan: DMLPlan
    data: DMLData
    ledger: Optional[TaskLedger]
    on_complete: Optional[Callable] = None
    req: Optional[WorkRequest] = None       # set at admission
    admitted: bool = False


class DMLSession:
    """Serves many estimation requests from one warm execution backend
    through a continuous-admission drain engine.

    >>> sess = DMLSession(pool=PoolConfig(n_workers=8))
    >>> a = sess.submit(plan_a, data_a)
    >>> b = sess.submit(plan_b, data_b)
    >>> results = sess.run()            # shared waves; [DMLResult, DMLResult]
    >>> sess.result(a).theta

    ``submit()`` only enqueues; admission into the backend's live
    ``DrainState`` happens lazily, so requests submitted while earlier
    ones are draining join the *same* drain (no barrier between batches).
    ``poll()`` advances the drain by one step and returns the ids of
    requests that completed in that step — the non-blocking interface;
    ``wait(rid)`` / ``run()`` / ``estimate()`` are blocking wrappers.
    Completion order is recorded in ``completion_order`` and surfaced
    through per-request ``on_complete`` callbacks the moment a request's
    ledger fills, while other requests are still executing.

    The backend persists across ``run()`` calls (warm program cache and
    device-resident page pool).  ``last_run_info`` exposes cross-request
    accounting: ``.shared_waves`` (waves that carried 2+ requests),
    ``.compile`` (launches, fused launches, coalesced blocks, padding),
    ``.pages`` (the page pool's ``PageStats``: hits, uploaded and saved
    bytes, evictions; None when ``PoolConfig.page_pool_bytes`` is 0),
    ``.dispatch`` (the in-flight queue's ``DispatchStats``) and
    ``.autoscale`` (the autoscaler's decisions).

    If the backend aborts mid-drain, the incomplete requests stay queued
    with their partially-completed ledgers; a later ``run()`` resumes
    exactly the missing invocations — including after swapping
    ``self.backend``.
    """

    def __init__(self, backend: Union[str, ExecutionBackend] = "wave",
                 pool: Optional[PoolConfig] = None,
                 device: DeviceLike = "cuda"):
        self.backend = make_backend(backend, pool, device=device)
        self.device = self.backend.device   # an instance keeps its own
        # price the axis planner's launch overhead on this device
        measure_launch_overhead_s(self.device)
        self._queue: List[_Pending] = []
        self._results: Dict[int, DMLResult] = {}
        self._requests: Dict[int, WorkRequest] = {}
        self._next_id = 0
        self.completion_order: List[int] = []
        self.last_run_info: Optional[BackendRunInfo] = None
        self._state: Optional[DrainState] = None
        self._state_backend: Optional[ExecutionBackend] = None

    # ---- admission ----------------------------------------------------
    def submit(self, plan: DMLPlan, data, *,
               ledger: Optional[TaskLedger] = None,
               on_complete: Optional[Callable] = None) -> int:
        """Queue one estimation request; returns its request id.

        ``on_complete(result)`` fires the moment the request's ledger
        completes — possibly steps before the whole drain finishes.
        """
        data = DMLData.from_dict(data)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, plan, data, ledger,
                                    on_complete=on_complete))
        return rid

    def _drain_state(self) -> DrainState:
        """The live drain, rebuilt if the backend was swapped (previously
        admitted-but-incomplete requests re-enter with their ledgers, so
        the new drain resumes instead of restarting)."""
        if self._state is None or self._state_backend is not self.backend:
            self._state = self.backend.begin_drain()
            self._state_backend = self.backend
            for p in self._queue:
                p.admitted = False
        return self._state

    def _admit_queued(self):
        if not self._queue and self._state is None:
            return                          # idle: keep last drain's info
        state = self._drain_state()
        for p in self._queue:
            if p.admitted:
                continue
            req = compile_request(p.plan, p.data, ledger=p.ledger,
                                  tag=p.request_id)
            p.ledger = req.ledger           # keep completed rows on failure
            p.req = req
            self.backend.admit(state, req)
            p.admitted = True
        self.last_run_info = state.info

    # ---- the event loop -----------------------------------------------
    def _harvest(self) -> List[int]:
        """Assemble results for every admitted request whose ledger just
        completed; fires callbacks; removes them from the queue."""
        finished: List[int] = []
        for p in list(self._queue):
            if not (p.admitted and p.req.ledger.complete):
                continue
            res = assemble_result(p.plan, p.data, p.req,
                                  request_id=p.request_id,
                                  device=self.device)
            self._results[p.request_id] = res
            self._requests[p.request_id] = p.req
            self.completion_order.append(p.request_id)
            self._queue.remove(p)
            finished.append(p.request_id)
            if p.on_complete is not None:
                p.on_complete(res)
        return finished

    def _retire_idle_state(self):
        """Drop the drain state once nothing is queued: the next submit
        starts a fresh drain (warm caches live on the *backend*; only the
        admission bookkeeping and its telemetry, already exposed via
        ``last_run_info``, retire)."""
        if not self._queue and self._state is not None:
            retire_drain(self._state, "session retire")
            self._state = None
            self._state_backend = None

    def poll(self) -> List[int]:
        """Admit anything queued, advance the drain by one step, and
        return the ids of requests that completed in that step."""
        if not self._queue and self._state is None:
            return []
        self._admit_queued()
        self.backend.step(self._drain_state())
        done = self._harvest()
        self._retire_idle_state()
        return done

    def wait(self, request_id: int) -> DMLResult:
        """Drive the drain until one request completes; requests admitted
        behind it keep executing meanwhile."""
        if request_id in self._results:
            return self._results[request_id]
        if all(p.request_id != request_id for p in self._queue):
            raise KeyError(f"unknown request id {request_id}")
        self._admit_queued()
        state = self._drain_state()
        self._harvest()                     # resumed-complete ledgers
        while request_id not in self._results:
            progressed = self.backend.step(state)
            self._harvest()
            if not progressed and request_id not in self._results:
                raise RuntimeError(
                    f"drain stalled with request {request_id} incomplete")
        self._retire_idle_state()
        return self._results[request_id]

    def run(self) -> List[DMLResult]:
        """Drain every currently-queued request; returns their results in
        submission order (also retrievable via ``result(id)``).  Requests
        submitted *during* the drain (e.g. from callbacks) are admitted
        into the same drain and may complete here too."""
        self._admit_queued()
        targets = [p.request_id for p in self._queue]
        if not targets:
            return []
        state = self._drain_state()
        self._harvest()                     # resumed-complete ledgers
        while any(rid not in self._results for rid in targets):
            progressed = self.backend.step(state)
            self._harvest()
            self._admit_queued()            # continuous admission
            if not progressed and \
                    any(rid not in self._results for rid in targets):
                raise RuntimeError("drain stalled with incomplete requests")
        self._retire_idle_state()
        return [self._results[rid] for rid in targets]

    # ---- results ------------------------------------------------------
    def result(self, request_id: int) -> DMLResult:
        return self._results[request_id]

    def request(self, request_id: int) -> WorkRequest:
        """The compiled WorkRequest of a completed request (its
        ``gathered_preds()`` is the full prediction tensor)."""
        return self._requests[request_id]

    def estimate(self, plan: DMLPlan, data, *,
                 ledger: Optional[TaskLedger] = None) -> DMLResult:
        """Submit + drain a single request on this session's backend."""
        rid = self.submit(plan, data, ledger=ledger)
        return self.wait(rid)


def estimate(plan: DMLPlan, data, *,
             ledger: Optional[TaskLedger] = None,
             backend: Union[str, ExecutionBackend, None] = None,
             device: DeviceLike = "cuda") -> DMLResult:
    """One-shot estimation: plan + data -> result, backend from the plan
    unless one is named here."""
    b = backend if backend is not None else plan.backend
    sess = DMLSession(backend=b, pool=plan.pool, device=device)
    return sess.estimate(plan, data, ledger=ledger)

"""Occupancy-driven, cost-aware worker autoscaling (backend layer;
topology-aware and roofline-priced).

A copy of the JAX package's ``serverless/autoscale.py`` (pure Python):
the decisions are the reference's for the same observations.

Replaces the static ``PoolConfig.worker_schedule`` with a policy that
sizes each wave from live signals the compiler already reports:

  * **queue depth** — pending invocations across every admitted request,
  * **bucket occupancy** — how full the next wave's B buckets would be
    (capacity beyond the queue burns padded lanes),
  * **padding waste** — the compiler's running B/N padding fraction,
    which inflates the effective per-lane work.

Each candidate worker count is priced through the paper's Lambda cost
model (serverless/cost.py): more workers drain the queue in fewer waves
(latency down) but bill more padded lane-seconds (cost up).  The policy
minimizes ``latency + cost_weight * GB-seconds`` — the same latency/cost
frontier as the paper's Figure 3 memory study, applied to pool width.
The decision is a pure function of the observed state, so a drain's
schedule is reproducible; and because per-task PRNG is fixed at compile
time, no schedule the autoscaler picks can move an estimate.

Candidate pricing resolves in order of signal quality: the simulate-mode
work model, then the EMA of *measured* invocation durations, then the
compiler's **roofline estimate** for the pending
buckets (``launch/roofline.py::invocation_roofline_s``, derived from
each bucket's per-task FLOP count), and only then the unit-work
fallback.  Every decision records which source priced it and the full
per-candidate cost table, so the first wave of a cold drain is already
cost-reasoned instead of unit-guessed.

``TopologyAutoscaler`` sizes each host mesh's wave independently — one
``OccupancyAutoscaler`` per host stream, each fed only its host's queue.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Tuple

from repro_torch.serverless.cost import speedup_of

if TYPE_CHECKING:                        # avoid backends <-> autoscale cycle
    from repro_torch.serverless.backends import PoolConfig


@dataclass(frozen=True)
class AutoscaleDecision:
    """One wave-sizing decision plus the signals it was derived from."""
    n_workers: int
    capacity: int                       # n_workers * lanes_per_worker
    queue_depth: int                    # pending invocations observed
    est_waves: int
    est_occupancy: float                # (depth + in_flight)/(waves * cap)
    est_time_s: float                   # modeled drain latency
    est_gb_s: float                     # modeled billed GB-seconds
    padding_waste: float                # compiler signal used for pricing
    priced_by: str = "unit"             # simulate | ema | roofline | unit
    host: int = -1                      # host stream (-1: single-stream)
    # the full candidate table this decision was picked from:
    # (n_workers, est_time_s, est_gb_s, score) per candidate
    candidate_costs: Tuple[Tuple[int, float, float, float], ...] = ()
    # dispatched-but-unharvested invocations at decision time: occupancy,
    # NOT queue depth — in-flight work is already placed on a device, so
    # sizing for it again would double-provision the pool
    in_flight: int = 0


class OccupancyAutoscaler:
    """Sizes the next wave of a continuous drain.

    Stateless apart from an EMA of measured invocation durations (used to
    price candidates when the pool is not in simulate mode).
    """

    def __init__(self, pool: "PoolConfig", *, cost_weight: float = None,
                 candidates: List[int] = None, host: int = -1):
        self.pool = pool
        self.host = host
        self.cost_weight = (pool.autoscale_cost_weight
                            if cost_weight is None else cost_weight)
        self._cands = candidates
        self._ema_inv_s = None          # measured per-invocation seconds
        self.decisions: List[AutoscaleDecision] = []

    # ------------------------------------------------------------------
    def observe(self, duration_s: float):
        """Feed a measured per-invocation duration (EMA, alpha=0.3)."""
        if duration_s <= 0:
            return
        if self._ema_inv_s is None:
            self._ema_inv_s = duration_s
        else:
            self._ema_inv_s = 0.7 * self._ema_inv_s + 0.3 * duration_s

    def _per_invocation_s(self, tasks_per_invocation: int,
                          roofline_inv_s) -> Tuple[float, str]:
        """Modeled duration of one invocation and the signal that priced
        it: simulate-mode work model > measured EMA > roofline > unit.
        ``roofline_inv_s`` may be a float or a zero-argument thunk — the
        thunk is only invoked when the higher-priority signals are
        absent, so callers can pass it unconditionally and the pricing
        priority lives in exactly one place."""
        pool = self.pool
        if pool.simulate and pool.base_work_s > 0:
            return (pool.base_work_s * tasks_per_invocation
                    / speedup_of(pool.memory_mb), "simulate")
        if self._ema_inv_s is not None:
            return self._ema_inv_s, "ema"
        if callable(roofline_inv_s):
            roofline_inv_s = roofline_inv_s()
        if roofline_inv_s is not None and roofline_inv_s > 0:
            return roofline_inv_s, "roofline"
        # no signal at all: a unit work model still ranks candidates
        return 1.0 / speedup_of(pool.memory_mb), "unit"

    def _candidates(self) -> List[int]:
        if self._cands is not None:
            return self._cands
        pool = self.pool
        out, w = [], max(1, pool.min_workers)
        while w < pool.max_workers:
            out.append(w)
            w *= 2
        out.append(pool.max_workers)
        return out

    # ------------------------------------------------------------------
    def decide(self, queue_depth: int, *, tasks_per_invocation: int = 1,
               padding_waste: float = 0.0, in_flight: int = 0,
               roofline_inv_s=None) -> AutoscaleDecision:
        """Pick the worker count for the next wave given the live queue.

        ``queue_depth`` must count only dispatchable work; ``in_flight``
        is the dispatched-but-unharvested invocation count of the
        caller's queue (non-blocking dispatch).  In-flight work raises
        the recorded occupancy but never the worker count — it already
        holds device capacity, and sizing for it again would
        double-provision the pool.  ``roofline_inv_s``: float or lazy
        thunk (see _per_invocation_s)."""
        pool = self.pool
        lanes = pool.lanes_per_worker()
        depth = max(int(queue_depth), 1)
        in_flight = max(int(in_flight), 0)
        per_inv, priced_by = self._per_invocation_s(tasks_per_invocation,
                                                    roofline_inv_s)
        # padded lanes do real work under wave-capacity-aligned B buckets
        per_lane = per_inv * (1.0 + max(0.0, min(padding_waste, 1.0)))

        best = None
        table: List[Tuple[int, float, float, float]] = []
        for w in self._candidates():
            cap = max(1, w * lanes)
            waves = -(-depth // cap)                    # ceil
            occupancy = (depth + in_flight) / (waves * cap)
            time_s = waves * (per_inv + pool.dispatch_overhead_s)
            # real invocations bill their (padding-inflated) lane-seconds;
            # idle lanes in the final partial wave still hold worker slots
            # for half a wave on average — the over-provisioning cost
            idle_lanes = waves * cap - depth
            gb_s = (depth * per_lane + idle_lanes * per_inv * 0.5) \
                * pool.memory_mb / 1024.0
            score = time_s + self.cost_weight * gb_s
            table.append((w, time_s, gb_s, score))
            cand = (w, cap, waves, occupancy, time_s, gb_s)
            if best is None or score < best[0] - 1e-12 or \
                    (abs(score - best[0]) <= 1e-12 and w < best[1][0]):
                best = (score, cand)
        w, cap, waves, occupancy, time_s, gb_s = best[1]
        decision = AutoscaleDecision(
            n_workers=w, capacity=cap, queue_depth=depth,
            est_waves=waves, est_occupancy=occupancy,
            est_time_s=time_s, est_gb_s=gb_s,
            padding_waste=padding_waste, priced_by=priced_by,
            host=self.host, candidate_costs=tuple(table),
            in_flight=in_flight)
        self.decisions.append(decision)
        return decision


class TopologyAutoscaler:
    """Per-mesh wave sizing: one ``OccupancyAutoscaler`` per host stream,
    each deciding from its own queue depth and feeding its own measured
    EMA — host meshes scale independently (a hot host widens its waves
    while an idle one stays narrow), exactly the elasticity-per-worker
    lever the paper's serverless pool has per lambda."""

    def __init__(self, pool: "PoolConfig", n_hosts: int):
        self.scalers: Dict[int, OccupancyAutoscaler] = {
            h: OccupancyAutoscaler(pool, host=h) for h in range(n_hosts)}

    def decide(self, host: int, queue_depth: int, *,
               tasks_per_invocation: int = 1, padding_waste: float = 0.0,
               in_flight: int = 0, roofline_inv_s=None) -> AutoscaleDecision:
        return self.scalers[host].decide(
            queue_depth, tasks_per_invocation=tasks_per_invocation,
            padding_waste=padding_waste, in_flight=in_flight,
            roofline_inv_s=roofline_inv_s)

    def observe(self, host: int, duration_s: float):
        self.scalers[host].observe(duration_s)

    @property
    def decisions(self) -> List[AutoscaleDecision]:
        out: List[AutoscaleDecision] = []
        for h in sorted(self.scalers):
            out.extend(self.scalers[h].decisions)
        return out

"""Megabatch bucket planning: the whole cross-fitting grid -> few shapes.

The planner takes the union of all pending ``WorkRequest``s — across
sessions, repetitions, folds, nuisances, and mixed learner families — and
groups every task into a **bucket** keyed by

    (learner identity, padded N bucket, padded P bucket)

Tasks inside a bucket are shape-compatible after padding, so one
program (see program.py) serves all of them regardless of which request
they came from: the serverless-ML lesson (pack many small homogeneous
work items into few large compiled invocations) applied to the paper's
M x K x L task grid.

Padding rules per learner family:

  * registry learners: N rounded up to the lane quantum
    (``aligned_bucket``, multiples of 8 — mirroring the B tail rule),
    so N-axis waste is bounded at < 8 rows per lane instead of pow2's
    <2x; P stays pow2-bucketed for the feature-pad-safe families (the
    long tail of widths collapses onto a handful of programs);
  * families outside ``FEATURE_PAD_SAFE`` (e.g. mlp, whose init scale
    depends on the true P): N aligned, P exact;
  * opaque callables (``compile_raw_request``): exact shapes — nothing
    proves that an arbitrary callable is padding-invariant.

The aligned N rule trades program variety for waste: distinct N values
8 apart no longer share a program, but steady serving re-presents the
same N values.

The planner is pure bookkeeping (numpy only); execution and the warm
program cache live in program.py.  ``plan_bucket_axis`` picks each
bucket's parallelization axis (task, data or feature) from the roofline
prices of launch/roofline.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.registry import warm_cache
from repro_torch.core.crossfit import aligned_bucket, pow2_bucket
from repro_torch.learners import FEATURE_PAD_SAFE

Entry = Tuple[int, int]                 # (request index, invocation id)


@dataclass(frozen=True)
class BucketKey:
    """Identity of one megabatch program family."""
    learner: object                     # Segment.bucket_id (spec or opaque)
    n_pad: int
    p_pad: int


@dataclass
class MegabatchPlan:
    """The lowered view of a stream of requests: every (request, segment)
    mapped to its bucket, plus lazily-built padded data pages.

    The plan is **incremental**: ``admit()`` lowers one request at a time,
    so the continuous-admission drain engine can extend a live plan while
    earlier requests are already executing.  ``plan_buckets`` stays as the
    batch convenience (admit everything up front).
    """
    requests: List = field(default_factory=list)
    bucket_of: Dict[Tuple[int, int], BucketKey] = field(default_factory=dict)
    seg_of: Dict[Tuple[int, BucketKey], int] = field(default_factory=dict)
    min_n: int = 8
    min_p: int = 8
    _pages: Dict[Tuple[int, int, int], np.ndarray] = field(
        default_factory=dict)

    # ---- continuous admission -------------------------------------------
    def admit(self, req) -> int:
        """Lower one request into the plan; returns its request index."""
        ri = len(self.requests)
        self.requests.append(req)
        n = int(req.ledger.n_obs)
        p = int(req.x.shape[1])
        for si, seg in enumerate(req.segments):
            if seg.learner is None:            # opaque callable: exact shapes
                n_pad, p_pad = n, p
            else:
                n_pad = aligned_bucket(n, self.min_n)
                p_pad = pow2_bucket(p, self.min_p) \
                    if seg.learner in FEATURE_PAD_SAFE else p
            key = BucketKey(seg.bucket_id, n_pad, p_pad)
            self.bucket_of[(ri, si)] = key
            # first-wins: if two segments of one request collapse onto one
            # bucket (their *resolved* params are equal), either resolves
            # the same batched fn — per-task PRNG streams are looked up
            # via segment_of_inv in dispatch_bucket, never through this map
            self.seg_of.setdefault((ri, key), si)
        return ri

    # ---- planning shapes -------------------------------------------------
    @property
    def buckets(self) -> List[BucketKey]:
        out: List[BucketKey] = []
        for key in self.bucket_of.values():
            if key not in out:
                out.append(key)
        return out

    # the plan owns its requests, so req_idx names one fixed request for
    # this plan's lifetime (the cache dict dies with the plan: ambient)
    @warm_cache(name="plan_pages", key=("req_idx", "key.n_pad",
                                        "key.p_pad"),
                ambient=("self",))
    def page(self, req_idx: int, key: BucketKey) -> np.ndarray:
        """The request's feature page padded to the bucket shape."""
        pkey = (req_idx, key.n_pad, key.p_pad)
        page = self._pages.get(pkey)
        if page is None:
            x = np.asarray(self.requests[req_idx].x, np.float32)
            page = np.zeros((key.n_pad, key.p_pad), np.float32)
            page[:x.shape[0], :x.shape[1]] = x
            self._pages[pkey] = page
        return page

    # ---- entry grouping --------------------------------------------------
    def group_entries(self, entries: Sequence[Entry]) \
            -> Dict[BucketKey, List[Entry]]:
        """Group (request, invocation) pairs by their bucket, preserving
        order (deterministic program launch order)."""
        groups: Dict[BucketKey, List[Entry]] = {}
        by_req: Dict[int, List[int]] = {}
        for ri, inv in entries:
            by_req.setdefault(ri, []).append(inv)
        for ri, invs in by_req.items():
            req = self.requests[ri]
            seg_idx = req.segment_of_inv(np.asarray(invs, np.int64))
            for inv, si in zip(invs, seg_idx):
                key = self.bucket_of[(ri, int(si))]
                groups.setdefault(key, []).append((ri, int(inv)))
        return groups

    def pending_by_bucket(self, exclude=None) -> Dict[BucketKey, List[Entry]]:
        """Every not-yet-DONE invocation of every request, bucketed.

        ``exclude`` is the dispatched-but-unharvested entry set of the
        caller's in-flight queue: those invocations are on the device
        already and must not be re-dispatched while their launch is
        pending."""
        exclude = exclude or ()
        entries: List[Entry] = []
        for ri, req in enumerate(self.requests):
            entries.extend(e for inv in req.ledger.pending()
                           if (e := (ri, int(inv))) not in exclude)
        return self.group_entries(entries)


def pack_tail_blocks(lane_counts: Sequence[int], b_block: int,
                     quantum: int = 8, b_align: int = 1,
                     ) -> Tuple[List[List[int]], int]:
    """Pack tail-block lane counts into combined launch blocks sharing
    ONE uniform lane count ``T`` (cross-shape coalescing).  Returns
    ``(groups, T)``: index groups plus the shared padded size.

    A uniform T is what lets every packed group fuse into a single
    launch without a second morph-up pass (morphing smaller groups up to
    the largest one is where naive packing bleeds padding).  T is chosen
    by sweeping every aligned candidate up to ``b_block`` and greedily
    first-fit packing against it, keeping the T that minimizes total
    padded lanes (ties: fewer groups, then smaller T).

    Deterministic: inputs are visited in order and placed into the
    first group with room, so a bucket's packing is a pure function of
    its tail sizes.  Pure bookkeeping (the JAX package's function, line
    for line); launching packed lanes at another B gives the same bits
    only for the families of ``program.MORPH_BITWISE_FAMILIES``.
    """
    counts = [int(k) for k in lane_counts]
    lo = max(aligned_bucket(k, quantum, b_align) for k in counts)
    cands = sorted({aligned_bucket(v, quantum, b_align)
                    for v in range(lo, max(b_block, lo) + 1)})

    def pack(cap: int) -> Tuple[List[List[int]], List[int]]:
        groups: List[List[int]] = []
        totals: List[int] = []
        for i, k in enumerate(counts):
            for gi, tot in enumerate(totals):
                if aligned_bucket(tot + k, quantum, b_align) <= cap:
                    groups[gi].append(i)
                    totals[gi] = tot + k
                    break
            else:
                groups.append([i])
                totals.append(k)
        return groups, totals

    best = None
    for cap in cands:
        groups, _ = pack(cap)
        score = (len(groups) * cap, len(groups), cap)
        if best is None or score < best[0]:
            best = (score, groups, cap)
    return best[1], best[2]


def plan_buckets(requests: Sequence, *, min_n: int = 8,
                 min_p: int = 8) -> MegabatchPlan:
    """Assign every (request, segment) to a megabatch bucket (batch form
    of ``MegabatchPlan.admit``)."""
    plan = MegabatchPlan(min_n=min_n, min_p=min_p)
    for req in requests:
        plan.admit(req)
    return plan


# ---------------------------------------------------------------------------
# Per-bucket parallelization-axis planning
# ---------------------------------------------------------------------------
@dataclass
class AxisDecision:
    """One bucket's parallelization-axis choice plus the roofline
    candidate table it was picked from, logged on
    ``BackendRunInfo.axis_plans``.  The planner fields are written once;
    ``executed`` is stamped by ``dispatch_bucket`` with the axis the
    drain actually ran."""
    bucket: BucketKey
    axis: str                           # task | data | feature
    shards: int                         # mesh devices the layout spans
    n_tasks: int                        # pending tasks priced
    n_pad: int
    p_pad: int
    mesh_devices: int                   # devices the planner could use
    priced_by: str = "roofline"
    # (axis, shards, est_s, executable) per candidate, planner input
    candidate_costs: Tuple[Tuple[str, int, float, bool], ...] = ()
    # None until the bucket's first dispatch; "task" when a data/feature
    # plan could not execute (no mesh, a non-Gram family, a shard count
    # that does not divide the sharded dimension)
    executed: Optional[str] = None

    @property
    def est_s(self) -> float:
        """The chosen candidate's priced wall-clock."""
        for axis, shards, est, _ in self.candidate_costs:
            if axis == self.axis and shards == self.shards:
                return est
        return float("nan")


def plan_bucket_axis(key: BucketKey, *, n_tasks: int, n_devices: int,
                     ) -> Optional[AxisDecision]:
    """Pick the parallelization axis for one bucket on an ``n_devices``
    mesh: the cheapest *executable* candidate of
    ``launch/roofline.py::axis_candidate_costs`` (ties: fewer shards,
    then the axis name).  None for a bucket without an analytic model
    (not a registry learner).  Deterministic in (bucket, n_tasks,
    n_devices); no device access."""
    ident = key.learner
    if not (isinstance(ident, tuple) and len(ident) == 2
            and isinstance(ident[0], str)) or ident[0] == "opaque":
        return None
    from repro_torch.launch.roofline import axis_candidate_costs
    learner, ptuple = ident
    cands = axis_candidate_costs(learner, dict(ptuple), n_tasks,
                                 key.n_pad, key.p_pad, n_devices)
    runnable = [c for c in cands if c[3]]
    if not runnable:                      # e.g. tall-N non-Gram family
        runnable = [c for c in cands if c[0] == "task"]
    axis, shards, _, _ = min(runnable, key=lambda c: (c[2], c[1], c[0]))
    return AxisDecision(bucket=key, axis=axis, shards=shards,
                        n_tasks=int(n_tasks), n_pad=key.n_pad,
                        p_pad=key.p_pad, mesh_devices=int(n_devices),
                        candidate_costs=tuple(cands))

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
    depends on the true P): N aligned, P exact.

The aligned N rule trades program variety for waste: distinct N values
8 apart no longer share a program, but steady serving re-presents the
same N values.

The planner is pure bookkeeping (numpy only); execution and the warm
program cache live in program.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.crossfit import aligned_bucket, pow2_bucket
from repro_torch.learners import FEATURE_PAD_SAFE

Entry = Tuple[int, int]                 # (request index, invocation id)


@dataclass(frozen=True)
class BucketKey:
    """Identity of one megabatch program family."""
    learner: object                     # Segment.bucket_id (learner spec)
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
            n_pad = aligned_bucket(n, self.min_n)
            p_pad = pow2_bucket(p, self.min_p) \
                if seg.learner in FEATURE_PAD_SAFE else p
            key = BucketKey(seg.bucket_id, n_pad, p_pad)
            self.bucket_of[(ri, si)] = key
            # first-wins: if two segments of one request collapse onto one
            # bucket (their *resolved* params are equal), either resolves
            # the same batched fn — per-task PRNG streams are looked up
            # via segment_of_inv in run_bucket, never through this map
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

    def pending_by_bucket(self) -> Dict[BucketKey, List[Entry]]:
        """Every not-yet-DONE invocation of every request, bucketed."""
        entries: List[Entry] = []
        for ri, req in enumerate(self.requests):
            entries.extend((ri, int(inv)) for inv in req.ledger.pending())
        return self.group_entries(entries)


def plan_buckets(requests: Sequence, *, min_n: int = 8,
                 min_p: int = 8) -> MegabatchPlan:
    """Assign every (request, segment) to a megabatch bucket (batch form
    of ``MegabatchPlan.admit``)."""
    plan = MegabatchPlan(min_n=min_n, min_p=min_p)
    for req in requests:
        plan.admit(req)
    return plan

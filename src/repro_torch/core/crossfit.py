"""Repeated K-fold cross-fitting (paper §3, step 1-2).

The *task grid* is the paper's unit of distribution: one task = fitting one
nuisance function on I^c_{m,k} and predicting on I_{m,k}.  Fold membership is
encoded as dense masks so the whole grid vectorizes: training a task means a
weighted fit with weights = (1 - fold_mask) (x subset mask for IRM/IIVM),
predicting means evaluating on all N rows and keeping the fold rows — exactly
the paper's "return predictions on the test indices" discipline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TaskKey:
    """Identifies one unit of work at per-fold granularity."""
    rep: int          # m in [M]
    fold: int         # k in [K]
    nuisance: int     # l in [L]

    def flat(self, n_folds: int, n_nuisance: int) -> int:
        return (self.rep * n_folds + self.fold) * n_nuisance + self.nuisance


def draw_fold_masks(n_obs: int, n_folds: int, n_rep: int,
                    seed: int = 42) -> np.ndarray:
    """(M, K, N) boolean; fold_masks[m, k, i] == i in I_{m,k}.

    Partitions are exact (sizes differ by <=1 when K does not divide N) and
    reproducible via numpy Philox streams keyed on (seed, m) — workers can
    re-derive their split without any data movement (paper §6
    "Reproducibility and seeds").
    """
    masks = np.zeros((n_rep, n_folds, n_obs), dtype=bool)
    for m in range(n_rep):
        rng = np.random.Generator(np.random.Philox(key=seed + 7919 * m))
        perm = rng.permutation(n_obs)
        for k, chunk in enumerate(np.array_split(perm, n_folds)):
            masks[m, k, chunk] = True
    return masks


def check_partition(masks: np.ndarray) -> bool:
    """Every rep's folds partition [N]."""
    return bool((masks.sum(axis=1) == 1).all())


def subset_mask(subset: str, data) -> Optional[np.ndarray]:
    """Row restriction for conditional nuisances (IRM/IIVM)."""
    if subset == "all":
        return None
    var, val = subset[0], int(subset[1])
    return np.asarray(data[{"d": "d", "z": "z"}[var]]) == val


@dataclass(frozen=True)
class TaskGrid:
    """The full M x K x L grid plus the two paper scaling levels (§4.2)."""
    n_rep: int
    n_folds: int
    n_nuisance: int

    @property
    def n_tasks(self) -> int:
        return self.n_rep * self.n_folds * self.n_nuisance

    def keys(self):
        for m in range(self.n_rep):
            for k in range(self.n_folds):
                for l in range(self.n_nuisance):
                    yield TaskKey(m, k, l)

    def n_invocations(self, scaling: str) -> int:
        if scaling == "n_rep":
            return self.n_rep * self.n_nuisance          # paper: M*L
        if scaling == "n_folds*n_rep":
            return self.n_rep * self.n_folds * self.n_nuisance
        raise ValueError(scaling)

    def invocation_of(self, key: TaskKey, scaling: str) -> int:
        """Which invocation (lambda analogue) a task belongs to."""
        if scaling == "n_rep":
            return key.rep * self.n_nuisance + key.nuisance
        return key.flat(self.n_folds, self.n_nuisance)

    def tasks_of_invocation(self, inv: int, scaling: str) -> Tuple[TaskKey, ...]:
        if scaling == "n_rep":
            m, l = divmod(inv, self.n_nuisance)
            return tuple(TaskKey(m, k, l) for k in range(self.n_folds))
        rest, l = divmod(inv, self.n_nuisance)
        m, k = divmod(rest, self.n_folds)
        return (TaskKey(m, k, l),)

    def tasks_per_invocation(self, scaling: str) -> int:
        return self.n_folds if scaling == "n_rep" else 1

    def invocation_task_ids(self, inv: np.ndarray, scaling: str) -> np.ndarray:
        """Vectorized ``tasks_of_invocation``: (B,) invocation ids ->
        (B, tasks_per_invocation) flat task ids ((m*K + k)*L + l)."""
        inv = np.asarray(inv, np.int64)
        if scaling == "n_rep":
            m, l = np.divmod(inv, self.n_nuisance)
            k = np.arange(self.n_folds)
            return ((m[:, None] * self.n_folds + k[None, :])
                    * self.n_nuisance + l[:, None])
        return inv[:, None]

    def segment_invocations(self, l_ids, scaling: str) -> np.ndarray:
        """Invocation ids owned by a learner segment (both scaling levels
        place the nuisance index in the low digit) — the unit the megabatch
        bucket planner groups."""
        inv = np.arange(self.n_invocations(scaling), dtype=np.int64)
        return inv[np.isin(inv % self.n_nuisance, np.asarray(l_ids))]

    def task_coords(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(m, k, l) arrays of length n_tasks indexed by flat task id."""
        t = np.arange(self.n_tasks, dtype=np.int64)
        l = t % self.n_nuisance
        k = (t // self.n_nuisance) % self.n_folds
        m = t // (self.n_nuisance * self.n_folds)
        return m, k, l


def pow2_bucket(n: int, min_size: int = 8) -> int:
    """Smallest power of two >= max(n, min_size) — the shape-bucketing rule
    the megabatch compiler uses for N, P, and page axes.  Pow2 growth
    bounds padding waste at <2x while collapsing the long tail of request
    shapes onto a handful of compiled programs."""
    n = max(int(n), int(min_size))
    return 1 << (n - 1).bit_length()


def aligned_bucket(n: int, quantum: int = 8, align: int = 1) -> int:
    """Smallest multiple of ``quantum`` (and of ``align``) >= n — the
    bucketing rule for the task-batch B axis.

    Aligning to a small quantum (8 lanes) bounds per-launch padding at
    < quantum lanes instead of pow2's < 2x.
    ``align`` further rounds to the shard count for sharded programs.
    """
    n = max(int(n), 1)
    b = ((n + quantum - 1) // quantum) * quantum
    if align > 1:
        b = ((b + align - 1) // align) * align
    return b


@dataclass(frozen=True)
class PaddingStats:
    """Padding accounting for one set of bucketed program launches.

    Waste decomposes per axis: B (padded lanes), N (padded rows inside
    real lanes), and P (padded feature columns inside real lanes) — so a
    regression on one axis is visible instead of hiding in the blended
    cell fraction.
    """
    true_cells: int = 0                 # sum over tasks of their true N
    padded_cells: int = 0               # sum over launches of B_pad * N_pad
    tasks: int = 0
    padded_tasks: int = 0
    padded_tasks_pow2: int = 0          # what pow2 B-bucketing would have cost
    # what the cross-shape coalescing scheduler costs on the B axis:
    # equals padded_tasks when coalescing is on, the packed
    # counterfactual when it is off — benches report both so the
    # coalescing win is visible per-axis
    padded_tasks_morphed: int = 0
    lane_cells: int = 0                 # sum over launches of tasks * N_pad
    lane_cells_pow2: int = 0            # what pow2 N-bucketing would have cost
    true_feats: int = 0                 # sum over tasks of their true P
    padded_feats: int = 0               # sum over tasks of P_pad

    def merge(self, other: "PaddingStats") -> "PaddingStats":
        return PaddingStats(
            true_cells=self.true_cells + other.true_cells,
            padded_cells=self.padded_cells + other.padded_cells,
            tasks=self.tasks + other.tasks,
            padded_tasks=self.padded_tasks + other.padded_tasks,
            padded_tasks_pow2=self.padded_tasks_pow2
            + other.padded_tasks_pow2,
            padded_tasks_morphed=self.padded_tasks_morphed
            + other.padded_tasks_morphed,
            lane_cells=self.lane_cells + other.lane_cells,
            lane_cells_pow2=self.lane_cells_pow2 + other.lane_cells_pow2,
            true_feats=self.true_feats + other.true_feats,
            padded_feats=self.padded_feats + other.padded_feats)

    @property
    def waste_frac(self) -> float:
        """Fraction of padded program cells that carry no real data."""
        if not self.padded_cells:
            return 0.0
        return 1.0 - self.true_cells / self.padded_cells

    @property
    def b_waste_frac(self) -> float:
        """Fraction of B-axis lanes that are padding (aligned bucketing)."""
        if not self.padded_tasks:
            return 0.0
        return 1.0 - self.tasks / self.padded_tasks

    @property
    def b_waste_frac_pow2(self) -> float:
        """The B-axis waste the old pow2 rule would have produced on the
        same launches — kept so benchmarks report before/after."""
        if not self.padded_tasks_pow2:
            return 0.0
        return 1.0 - self.tasks / self.padded_tasks_pow2

    @property
    def b_waste_frac_morphed(self) -> float:
        """The B-axis waste under the cross-shape coalescing scheduler
        (actual when coalescing is on, counterfactual when off)."""
        if not self.padded_tasks_morphed:
            return 0.0
        return 1.0 - self.tasks / self.padded_tasks_morphed

    @property
    def n_waste_frac(self) -> float:
        """Fraction of rows inside *real* lanes that are N padding."""
        if not self.lane_cells:
            return 0.0
        return 1.0 - self.true_cells / self.lane_cells

    @property
    def n_waste_frac_pow2(self) -> float:
        """The N-axis waste the old pow2 rule would have produced on the
        same launches — kept so benchmarks report before/after."""
        if not self.lane_cells_pow2:
            return 0.0
        return 1.0 - self.true_cells / self.lane_cells_pow2

    @property
    def p_waste_frac(self) -> float:
        """Fraction of feature columns inside real lanes that are P
        padding."""
        if not self.padded_feats:
            return 0.0
        return 1.0 - self.true_feats / self.padded_feats


def stitch_predictions(fold_masks: np.ndarray, fold_preds: np.ndarray):
    """Combine per-fold test predictions into full-N cross-fitted vectors.

    fold_masks: (M, K, N) bool; fold_preds: (M, K, N) where entry [m,k,:]
    is the prediction vector of task (m,k) (only fold rows are used).
    Returns (M, N).
    """
    return np.einsum("mkn,mkn->mn", fold_masks.astype(fold_preds.dtype),
                     fold_preds)

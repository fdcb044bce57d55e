"""Megabatch program build, cache, and execution.

A **program** is one cached callable per (bucket, padded batch shape):

    run(pages (D, N_pad, P_pad), data_idx (B,), y (B, N_pad),
        w (B, N_pad), valid (B, N_pad), key_data (B, 2)) -> (B, N_pad)

It gathers every task's feature page and calls the learner family's
``batched_fit_predict`` — on the linear path that bottoms out in the
hand-written CUDA kernels (``batched_gram`` / ``batched_predict`` in
kernels/ops.py) — or, for an opaque callable's exact-shape bucket, calls
the callable once per lane through ``learners.as_batched``.  The batch axis B is aligned to the lane quantum and the
page axis D is pow2-bucketed, so repeat traffic of *any* composition hits
a previously built program: the warm cache is keyed by spec, never by
object identity or request.  PyTorch runs eagerly, so "building" a
program binds the learner's hyperparameters and nothing is traced.

Every canonical block launches on its own, at its canonical shape: the
block's feature pages are stacked on the host and uploaded with the
launch.  A bucket the axis planner put on the data or feature axis
launches the in-mesh program of sharding/gram.py instead (the data form
streams the rows through the CUDA ``batched_gram_blocked``).
``dispatch_bucket`` enqueues a bucket slice's launches on the device
without waiting for them: operands are staged through pinned host
buffers and copied ``non_blocking``, and each launch's result is copied
back, also ``non_blocking``, into a pinned buffer with a CUDA event
recorded after the copy.  ``BucketDispatch.ready`` polls those events;
``harvest`` (book the results) and ``discard`` (drop a cancelled
dispatch) are the places that wait, and only one of them may run.  The
backends hold dispatches in queues (serverless/dispatch.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compile.buckets import BucketKey, Entry, MegabatchPlan
from repro_torch.core.crossfit import (
    PaddingStats, aligned_bucket, pow2_bucket,
)
from repro_torch.learners import as_batched, get_batched_learner
from repro_torch.runtime import bounded_put


@dataclass
class CompileStats:
    """Warm-cache and padding accounting across program launches.

    ``launches`` counts device dispatches; ``blocks`` counts the
    canonical blocks they carried (equal while every block launches on
    its own)."""
    hits: int = 0
    misses: int = 0
    launches: int = 0
    blocks: int = 0
    padding: PaddingStats = field(default_factory=PaddingStats)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def summary(self) -> Dict:
        return {"programs_compiled": self.misses,
                "cache_hits": self.hits,
                "cache_hit_rate": self.hit_rate,
                "launches": self.launches,
                "blocks": self.blocks,
                "padding_waste_frac": self.padding.waste_frac,
                "padding_waste_b_frac": self.padding.b_waste_frac,
                "padding_waste_n_frac": self.padding.n_waste_frac,
                "padding_waste_p_frac": self.padding.p_waste_frac,
                "tasks": self.padding.tasks,
                "padded_tasks": self.padding.padded_tasks}


def segment_batched_fn(seg) -> Callable:
    """Resolve a segment's megabatch implementation: registry learners get
    their native batched form, opaque callables the per-lane adapter."""
    if seg.learner is not None:
        return get_batched_learner(seg.learner, dict(seg.params))
    return as_batched(seg.learner_fn)


class ProgramCache:
    """Spec-keyed cache of megabatch programs.

    Keys are ``(BucketKey, B_pad, D_pad)`` — pure value identity, so two
    requests built from equal plans share programs, and a session's
    repeat traffic never rebuilds one.
    """

    def __init__(self):
        self._programs: Dict[Tuple, Callable] = {}
        self.stats = CompileStats()

    def program(self, key: BucketKey, b_pad: int, d_pad: int,
                fn_thunk: Callable[[], Callable]) -> Callable:
        # BucketKey pins the segment's (learner, params) and padded
        # shapes, which fully determine the batched fn the thunk builds
        pkey = (key, b_pad, d_pad)
        prog = self._programs.get(pkey)
        if prog is not None:
            self.stats.hits += 1
            return prog
        self.stats.misses += 1
        batched_fn = fn_thunk()

        def run(pages, data_idx, y, w, valid, key_data):
            xb = pages[data_idx]                       # (B, N_pad, P_pad)
            return batched_fn(xb, y, w, valid, key_data)

        self._programs[pkey] = run
        return run

    def shapes(self) -> List[Tuple[int, int, int]]:
        """(B_pad, N_pad, P_pad) of every program built so far."""
        return [(b_pad, key.n_pad, key.p_pad)
                for key, b_pad, _ in self._programs]


# A launch carries at most B_BLOCK task lanes.  Within each (request,
# segment), the segment's flat tasks in ascending order split into
# **canonical blocks** of B_BLOCK tasks, and a block's canonical size —
# full blocks at B_BLOCK, the tail at its aligned count — is what
# launches even when only part of it is pending (the missing lanes ride
# as padding; per-lane results do not depend on the other lanes'
# contents).  Flat task ids are scaling-level-invariant, so per-split and
# per-fold scaling launch identical shapes.
B_BLOCK = 32


@dataclass
class _Block:
    """One canonical launch block, stacked and ready to launch."""
    ri: int
    si: int
    members: List[Tuple[int, int, int]]   # (flat task, inv, row-in-inv)
    b_pad: int
    k: int                                # real task lanes
    n: int                                # true N of the request
    p: int                                # true P of the request
    tpi: int                              # rows per invocation buffer


@dataclass
class _LaunchBlock:
    """One launch-shaped unit: here always one canonical block at its
    canonical shape.  ``offsets[i]`` is the first lane of ``parts[i]``
    inside the (b_pad,) batch axis."""
    parts: List[_Block]
    offsets: List[int]
    b_pad: int
    k: int                                # total real lanes


@dataclass(eq=False)            # identity equality: comparing in-flight
class Launch:                   # tensors elementwise would be wrong
    """One device dispatch: ``out`` is the (B, N_pad) result tensor,
    possibly still being computed on the device.  On a CUDA device
    ``host`` is the pinned buffer ``out`` is copied into (queued right
    after the launch, ``non_blocking``) and ``done`` the event recorded
    after that copy; on the CPU both are None and ``out`` is final."""
    out: torch.Tensor
    blocks: List[_LaunchBlock]
    host: Optional[torch.Tensor] = None
    done: Optional["torch.cuda.Event"] = None

    @classmethod
    def queue(cls, out: torch.Tensor,
              blocks: List[_LaunchBlock]) -> "Launch":
        """Wrap a launch's output, queueing its copy to the host."""
        if out.device.type != "cuda":
            return cls(out=out, blocks=blocks)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return cls(out=out, blocks=blocks, host=host, done=done)

    def is_ready(self) -> bool:
        """Non-blocking poll: has the result reached the host?"""
        return self.done is None or self.done.query()

    def wait(self) -> np.ndarray:
        """Block until the result is on the host; return it."""
        if self.done is None:
            return self.out.numpy()
        self.done.synchronize()
        return self.host.numpy()


@dataclass(eq=False)            # identity equality (holds Launches)
class BucketDispatch:
    """One bucket slice in flight: every launch its entries need.

    An invocation's rows can straddle two canonical blocks (and so two
    launches with different tail shapes), so booking is only legal once
    ALL launches have landed — ``harvest`` is the bucket-level barrier,
    and the dispatch queue (serverless/dispatch.py) tracks these whole,
    never individual launches.  A dispatch is armed once: ``harvest``
    and ``discard`` each disarm it, and a second of either raises, so a
    discarded dispatch can never be booked.
    """
    key: BucketKey
    launches: List[Launch]
    entries: List[Entry]
    n_tasks: int
    armed: bool = True

    def ready(self) -> bool:
        """Non-blocking poll: have all launches landed on the host?"""
        return all(launch.is_ready() for launch in self.launches)

    def _disarm(self, what: str) -> None:
        if not self.armed:
            raise RuntimeError(
                f"{what} of a bucket dispatch that was already harvested "
                "or discarded")
        self.armed = False

    def harvest(self) -> Dict[Entry, np.ndarray]:
        """Wait for every launch; scatter predictions back per
        invocation.  Returns {(req_idx, inv): preds (tpi, n_obs)}."""
        self._disarm("harvest")
        results: Dict[Entry, np.ndarray] = {}
        for launch in self.launches:
            out = launch.wait()
            for lb in launch.blocks:
                for blk, ofs in zip(lb.parts, lb.offsets):
                    for lane, (_, inv, row) in enumerate(blk.members):
                        buf = results.get((blk.ri, inv))
                        if buf is None:
                            buf = results[(blk.ri, inv)] = \
                                np.empty((blk.tpi, blk.n), np.float32)
                        buf[row] = out[ofs + lane, :blk.n]
        return results

    def discard(self) -> None:
        """Retire a cancelled dispatch without building results: wait
        the launches out and drop them."""
        self._disarm("discard")
        for launch in self.launches:
            launch.wait()
        self.launches = []


# Structural cache of per-request block layouts: the canonical-block
# assignment is a pure function of (grid, scaling, segment l_ids,
# invocation subset, b_block, b_align) — steady serving re-lowers
# identical requests every round.  Value: a list of
# ((si, block, b_pad), members) group descriptors.
_BLOCK_LAYOUT_CACHE: Dict[Tuple, List] = {}
_BLOCK_LAYOUT_CACHE_MAX = 1024


def _request_block_layout(req, invs: List[int], b_block: int,
                          b_align: int) -> List:
    layout_key = (req.grid.n_rep, req.grid.n_folds, req.grid.n_nuisance,
                  req.scaling,
                  tuple(tuple(sorted(s.l_ids)) for s in req.segments),
                  tuple(invs), b_block, b_align)
    hit = _BLOCK_LAYOUT_CACHE.get(layout_key)
    if hit is not None:
        return hit
    invs_arr = np.asarray(invs, np.int64)
    # exact segment per invocation, one vectorized lookup (robust to two
    # segments of a request collapsing onto one bucket after param
    # resolution)
    sis = req.segment_of_inv(invs_arr)
    tasks_mat = req._index_maps()[0][invs_arr]         # (m, tpi)
    L = req.grid.n_nuisance
    groups: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
    for mi, (inv, si) in enumerate(zip(invs, sis)):
        si = int(si)
        l_ids = sorted(req.segments[si].l_ids)
        pos = {l: i for i, l in enumerate(l_ids)}
        for row, t in enumerate(tasks_mat[mi]):
            t = int(t)
            rank = (t // L) * len(l_ids) + pos[t % L]
            groups.setdefault((si, rank // b_block), []).append(
                (t, int(inv), row))
    out = []
    for (si, block), members in groups.items():
        n_l = len(req.segments[si].l_ids)
        seg_total = req.grid.n_rep * req.grid.n_folds * n_l
        canon = min(b_block, seg_total - block * b_block)
        out.append(((si, block, aligned_bucket(canon, 8, b_align)),
                    members))
    bounded_put(_BLOCK_LAYOUT_CACHE, layout_key, out,
                _BLOCK_LAYOUT_CACHE_MAX)
    return out


def _plan_blocks(plan: MegabatchPlan, key: BucketKey,
                 entries: Sequence[Entry], b_block: int,
                 b_align: int) -> List[_Block]:
    """Group a bucket slice's tasks into canonical launch blocks
    (order = first appearance); the per-request rank arithmetic is
    served from the structural layout cache on repeat traffic."""
    requests = plan.requests
    by_req: Dict[int, List[int]] = {}
    for ri, inv in entries:
        by_req.setdefault(ri, []).append(int(inv))

    blocks: List[_Block] = []
    for ri, invs in by_req.items():
        req = requests[ri]
        n = int(req.ledger.n_obs)
        p = int(req.x.shape[1])
        tpi = req.grid.tasks_per_invocation(req.scaling)
        for (si, block, b_pad), members in \
                _request_block_layout(req, invs, b_block, b_align):
            blocks.append(_Block(ri=ri, si=si, members=members,
                                 b_pad=b_pad, k=len(members),
                                 n=n, p=p, tpi=tpi))
    return blocks


# Content-keyed cache of stacked block tensors: a block's (y, w, valid,
# key_data) stack is a pure function of the request's ``work_key`` (set
# by the front-end when the tensors' provenance is fully pinned — the
# FULL data content, not just the feature page) and the block's lane
# content — steady serving re-lowers identical requests every round.
# Entries are shared between drains (and, on the CPU device, aliased by
# the tensors built from them): nothing may write to them.  The cache
# holds real arrays, so it is bounded by BYTES (FIFO eviction).
_BLOCK_TENSOR_CACHE: Dict[Tuple, Tuple] = {}
_BLOCK_TENSOR_CACHE_BYTES = 256 * 1024 * 1024
_block_tensor_bytes = 0


def _block_tensors(req, seg_idx: int, blk: _Block, n_pad: int):
    """Stack one block's task tensors at its canonical padded shape."""
    global _block_tensor_bytes
    tasks_t = tuple(t for t, _, _ in blk.members)
    ck = None
    if req.work_key is not None:
        ck = (req.work_key, seg_idx, tasks_t, blk.b_pad, n_pad)
        hit = _BLOCK_TENSOR_CACHE.get(ck)
        if hit is not None:
            return hit
    tasks = np.asarray(tasks_t, np.int64)
    ye, we = req.wave_arrays(tasks)
    kde = req.task_key_data(seg_idx, tasks)
    k, b_pad, n = blk.k, blk.b_pad, blk.n
    y = np.zeros((b_pad, n_pad), np.float32)
    w = np.zeros((b_pad, n_pad), np.float32)
    valid = np.zeros((b_pad, n_pad), np.float32)
    kd = np.zeros((b_pad,) + kde.shape[1:], kde.dtype)
    y[:k, :n] = ye
    w[:k, :n] = we
    valid[:k, :n] = 1.0
    kd[:k] = kde
    if ck is not None:
        nbytes = y.nbytes + w.nbytes + valid.nbytes + kd.nbytes
        if nbytes <= _BLOCK_TENSOR_CACHE_BYTES:
            while (_block_tensor_bytes + nbytes
                   > _BLOCK_TENSOR_CACHE_BYTES) and _BLOCK_TENSOR_CACHE:
                old = _BLOCK_TENSOR_CACHE.pop(
                    next(iter(_BLOCK_TENSOR_CACHE)))
                _block_tensor_bytes -= sum(a.nbytes for a in old)
            _BLOCK_TENSOR_CACHE[ck] = (y, w, valid, kd)
            _block_tensor_bytes += nbytes
    return y, w, valid, kd


class _PaddingAcc:
    """Plain-int padding accumulator: one ``PaddingStats`` merge per
    dispatch call instead of one dataclass round-trip per block."""
    __slots__ = ("true_cells", "padded_cells", "tasks", "padded_tasks",
                 "lane_cells", "lane_cells_pow2", "true_feats",
                 "padded_feats")

    def __init__(self):
        for f in self.__slots__:
            setattr(self, f, 0)

    def book_part(self, key: BucketKey, blk: _Block, exact_shapes: bool):
        """Per-canonical-block terms: true work and N/P-axis lanes."""
        # opaque exact-shape buckets never padded N under either rule
        n_pow2 = blk.n if exact_shapes else pow2_bucket(blk.n, 8)
        self.true_cells += blk.k * blk.n
        self.tasks += blk.k
        self.lane_cells += blk.k * key.n_pad
        self.lane_cells_pow2 += blk.k * n_pow2
        self.true_feats += blk.k * blk.p
        self.padded_feats += blk.k * key.p_pad

    def book_launch(self, key: BucketKey, lb: _LaunchBlock):
        """Per-launch-block terms: what the device actually burned."""
        self.padded_cells += lb.b_pad * key.n_pad
        self.padded_tasks += lb.b_pad

    def stats(self, padded_tasks_pow2: int) -> PaddingStats:
        # no coalescing scheduler here: the morphed comparator is what
        # launched
        return PaddingStats(
            true_cells=self.true_cells, padded_cells=self.padded_cells,
            tasks=self.tasks, padded_tasks=self.padded_tasks,
            padded_tasks_pow2=padded_tasks_pow2,
            padded_tasks_morphed=self.padded_tasks,
            lane_cells=self.lane_cells,
            lane_cells_pow2=self.lane_cells_pow2,
            true_feats=self.true_feats, padded_feats=self.padded_feats)


def _launch_pages(plan: MegabatchPlan, key: BucketKey,
                  lbs: List[_LaunchBlock], n_pad: int, p_pad: int):
    """Union page stack (stacked on the host) + page-key -> lane map
    across launch blocks.  A block's page is identified by its request
    index."""
    lane_of: Dict[object, int] = {}
    for lb in lbs:
        for blk in lb.parts:
            if blk.ri not in lane_of:
                lane_of[blk.ri] = len(lane_of)
    stack = [plan.page(ri, key) for ri in lane_of]
    d_pad = pow2_bucket(len(stack), 1)
    stack += [np.zeros((n_pad, p_pad), np.float32)] * (d_pad - len(stack))
    return np.stack(stack), lane_of


def _launch_tensors(plan: MegabatchPlan, lb: _LaunchBlock, n_pad: int):
    """One launch block's (y, w, valid, kd) at its launch shape: a single
    canonical block at its own shape comes straight from the
    content-keyed tensor cache (zero copy)."""
    (blk,) = lb.parts
    return _block_tensors(plan.requests[blk.ri], blk.si, blk, n_pad)


def _launch_didx(lb: _LaunchBlock, lane_of: Dict[object, int]) -> np.ndarray:
    """Per-lane page index for one launch block.  Padding lanes point at
    page 0 — their gather is masked by valid=0, and a fixed index keeps
    the launch deterministic."""
    didx = np.zeros((lb.b_pad,), np.int64)
    for blk, ofs in zip(lb.parts, lb.offsets):
        didx[ofs:ofs + blk.k] = lane_of[blk.ri]
    return didx


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
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


def bucket_family(key: BucketKey):
    """Learner family name of a spec-identified bucket, else None."""
    ident = key.learner
    if isinstance(ident, tuple) and len(ident) == 2 \
            and isinstance(ident[0], str) and ident[0] != "opaque":
        return ident[0]
    return None


def _axis_to_execute(key: BucketKey, axis_decision, mesh
                     ) -> Optional[Tuple[str, int]]:
    """(axis, shards) the drain can actually lower for this bucket, or
    None for the task path.  A data/feature ``AxisDecision`` executes
    only when the in-mesh executors apply: a Gram family, a mesh with a
    "data" device axis, and the sharded dimension divisible by the axis
    size; anything else runs the task path, which ``dispatch_bucket``
    stamps on the decision."""
    from repro_torch.launch.roofline import GRAM_FAMILIES
    if axis_decision is None or mesh is None:
        return None
    axis = axis_decision.axis
    if axis not in ("data", "feature"):
        return None
    if bucket_family(key) not in GRAM_FAMILIES:
        return None
    if "data" not in mesh.axis_names:
        return None
    m = int(mesh.shape["data"])
    if axis == "data" and key.n_pad % m != 0:
        return None
    if axis == "feature" and key.p_pad % m != 0:
        return None
    return axis, m


def dispatch_bucket(plan: MegabatchPlan, cache: ProgramCache,
                    key: BucketKey, entries: Sequence[Entry], *,
                    device: torch.device, b_align: int = 1,
                    b_block: int = B_BLOCK, axis_decision=None,
                    mesh=None) -> BucketDispatch:
    """Launch one bucket slice WITHOUT waiting for the device.

    Groups the entries' tasks into canonical launch blocks and launches
    every block on its own at its canonical shape.  Returns the
    in-flight ``BucketDispatch``; call ``.harvest()`` for the results.

    ``axis_decision``/``mesh``: a planner ``AxisDecision`` whose axis is
    data/feature lowers every block through the in-mesh program of
    sharding/gram.py on ``mesh``'s device when ``_axis_to_execute``
    allows it; the decision's ``executed`` field is stamped with the
    axis that ran either way.  Page stacking, task tensors, hit/miss
    and launch booking and the padding account are the task path's.
    """
    requests = plan.requests
    n_pad, p_pad = key.n_pad, key.p_pad
    blocks = _plan_blocks(plan, key, entries, b_block, b_align)
    axis_m = _axis_to_execute(key, axis_decision, mesh)
    if axis_decision is not None:
        axis_decision.executed = "task" if axis_m is None else axis_m[0]
    if axis_m is None:
        def program(blk: _Block, b_pad: int, d_pad: int) -> Callable:
            seg = requests[blk.ri].segments[blk.si]
            return cache.program(key, b_pad, d_pad,
                                 lambda: segment_batched_fn(seg))
    else:
        from repro_torch.sharding.gram import (
            axis_fit_program, axis_fit_program_cached,
        )
        axis, family = axis_m[0], bucket_family(key)
        params = tuple(key.learner[1])
        device = mesh.device

        def program(blk: _Block, b_pad: int, d_pad: int) -> Callable:
            if axis_fit_program_cached(mesh, axis, family, params):
                cache.stats.hits += 1
            else:
                cache.stats.misses += 1
            return axis_fit_program(mesh, axis, family, params)

    pad_acc = _PaddingAcc()
    launches: List[Launch] = []
    for blk in blocks:
        lb = _LaunchBlock([blk], [0], blk.b_pad, blk.k)
        pages_arr, lane_of = _launch_pages(plan, key, [lb], n_pad, p_pad)
        y, w, valid, kd = _launch_tensors(plan, lb, n_pad)
        didx = _launch_didx(lb, lane_of)
        prog = program(blk, lb.b_pad, int(pages_arr.shape[0]))
        out = prog(*(_upload(a, device)
                     for a in (pages_arr, didx, y, w, valid, kd)))
        launches.append(Launch.queue(out, [lb]))
        cache.stats.launches += 1
        cache.stats.blocks += len(lb.parts)
        pad_acc.book_part(key, blk,
                          requests[blk.ri].segments[blk.si].learner is None)
        pad_acc.book_launch(key, lb)

    total_tasks = sum(blk.k for blk in blocks)
    # one merge per dispatch; padded_tasks_pow2 records what one pow2
    # launch per bucket slice would have cost
    cache.stats.padding = cache.stats.padding.merge(
        pad_acc.stats(pow2_bucket(total_tasks, 8)))
    return BucketDispatch(key=key, launches=launches,
                          entries=list(entries), n_tasks=total_tasks)

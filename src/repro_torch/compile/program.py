"""Megabatch program build, cache, and execution.

A **program** is one cached callable per (bucket, padded batch shape):

    run(pages (D, N_pad, P_pad), data_idx (B,), y (B, N_pad),
        w (B, N_pad), valid (B, N_pad), key_data (B, 2)) -> (B, N_pad)

It gathers every task's feature page and calls the learner family's
``batched_fit_predict`` — on the linear path that bottoms out in the
hand-written CUDA kernels (``batched_gram`` / ``batched_predict`` in
kernels/ops.py) — or, for an opaque callable's exact-shape bucket, calls
the callable once per lane through ``learners.as_batched``.  The batch
axis B is aligned to the lane quantum and the page axis D is
pow2-bucketed, so repeat traffic of *any* composition hits a previously
built program: the warm cache is keyed by spec, never by object identity
or request.  PyTorch runs eagerly, so "building" a program binds the
learner's hyperparameters and nothing is traced.  Feature pages come from
the device-resident ``PagePool`` (pages.py) when the backend passes one —
warm drains then upload no page — else they are stacked on the host and
uploaded with the launch.

**Same-shape block fusion**: equal-B launch blocks of a bucket slice (of
one request or of several) go up in ONE program call over a union page
stack:

    run_fused(pages (D, N_pad, P_pad), data_idx (G, B), y (G, B, N_pad),
              ... ) -> (G, B, N_pad)

For the families of ``FUSED_CONCAT_FAMILIES`` that call lays the G
blocks' lanes end to end and calls the batched function once on G·B
lanes — one launch of each kernel for the group; these families give
every lane the same bits at any batch count.  Every other bucket's fused
program calls the batched function once per block inside the one
program, which is the JAX package's ``lax.map`` form.  Either way the
result is bit for bit the per-block launches'.  A group whose gathered
pages would pass ``FUSED_GATHER_BYTES`` runs as consecutive sub-calls of
whole blocks inside the same program.

**Cross-shape coalescing**: for the families of
``MORPH_BITWISE_FAMILIES`` the tail blocks of a slice pack into combined
launch blocks (buckets.pack_tail_blocks) and the remaining mixed shapes
morph up to the largest B, so a bucket slice fuses into one launch.

A bucket the axis planner put on the data or feature axis launches the
in-mesh program of sharding/gram.py instead (the data form streams the
rows through the CUDA ``batched_gram_blocked``); such launches take the
pooled pages and the tail packing but never fuse.
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

from repro_torch.analysis.registry import warm_cache
from repro_torch.compile.buckets import (
    BucketKey, Entry, MegabatchPlan, pack_tail_blocks,
)
from repro_torch.compile.pages import PagePool, upload
from repro_torch.core.crossfit import (
    PaddingStats, aligned_bucket, pow2_bucket,
)
from repro_torch.learners import as_batched, get_batched_learner
from repro_torch.runtime import bounded_put


@dataclass
class CompileStats:
    """Warm-cache and padding accounting across program launches.

    ``launches`` counts program calls; ``blocks`` counts the canonical
    blocks they carried — ``blocks > launches`` is fusion at work
    (``fused_launches`` of them carried 2+ canonical blocks).
    ``coalesced_blocks`` counts canonical tail blocks that rode a
    *combined* launch block (cross-shape coalescing).  A fused launch
    counts once here however many kernel calls it makes
    (``runtime.launch_counts`` counts those)."""
    hits: int = 0
    misses: int = 0
    launches: int = 0
    blocks: int = 0
    fused_launches: int = 0
    coalesced_blocks: int = 0
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
                "fused_launches": self.fused_launches,
                "coalesced_blocks": self.coalesced_blocks,
                "padding_waste_frac": self.padding.waste_frac,
                "padding_waste_b_frac": self.padding.b_waste_frac,
                "padding_waste_b_morphed_frac":
                    self.padding.b_waste_frac_morphed,
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


# A launch carries at most B_BLOCK task lanes.  Within each (request,
# segment), the segment's flat tasks in ascending order split into
# **canonical blocks** of B_BLOCK tasks, and a block's canonical size —
# full blocks at B_BLOCK, the tail at its aligned count — is what
# launches even when only part of it is pending (the missing lanes ride
# as padding; per-lane results do not depend on the other lanes'
# contents).  Flat task ids are scaling-level-invariant, so per-split and
# per-fold scaling launch identical shapes.  Whether a lane's bits also
# survive another launch B is a per-family property, measured, and the
# three sets below record it.
B_BLOCK = 32

# Families whose lanes give the same bits at any batch count — the same
# lane content in a call of 32 or of G·32 lanes — on the CPU and on the
# card (tests/test_torch_fusion.py, chip_smoke.py phase fusion): their
# fused launch is one call of the batched function on the G blocks' lanes
# laid end to end, one launch of each kernel for the group.  Every other
# bucket fuses as one call of the batched function per block inside the
# one program.  lasso's FISTA products and logistic's IRLS ``torch.bmm``
# change a lane's last bits at another batch count on the card, and
# logistic's on the CPU too; so does mlp's training on the card (Adam
# turns an ulp of a gradient into a step of lr), by up to 0.5 of a
# prediction after 300 steps (scripts/probe_batch_bits.py measures each
# family).  kernel_ridge keeps its bits in one call of 256 lanes on both,
# but stays per block: its features are m + 1 columns wide, up to 8 times
# the gathered page that FUSED_GATHER_BYTES budgets, so a call of
# concatenated blocks could pass the kernels' 2^31 elements.
FUSED_CONCAT_FAMILIES = frozenset({"ols", "ridge"})

# Families whose lanes may launch at another B than their block's
# canonical one (8, 16 or 24 lanes up to 32, at another lane offset) with
# the same bits, on the CPU and on the card: the coalescing scheduler
# packs and morphs their tail blocks.  mlp is in no set: a lane of a call
# of 8 differs from the same lane in a call of 32 on the card.
MORPH_BITWISE_FAMILIES = frozenset({"ols", "ridge", "lasso", "kernel_ridge"})

# Opt-in tolerance tier: families whose morphed launches are only
# float-tolerance-equal to canonical ones; they morph only under
# ``PoolConfig.morph_tolerance > 0``, an explicit opt-out of bitwise
# reproducibility.  Logistic: a lane of a call of 8 lanes and the same
# lane in a call of 32 differ in their last bits, on the CPU and on the
# card.
MORPH_TOLERANCE_FAMILIES = frozenset({"logistic"})

# The most bytes of gathered feature pages one call of a fused program
# holds: a larger group runs as consecutive sub-calls of whole blocks
# (at least one) inside the same program.  It also keeps a call's
# element count below 2^31, the kernels' 32-bit offsets.
FUSED_GATHER_BYTES = 2 << 30


def bucket_family(key: BucketKey) -> Optional[str]:
    """Learner family name of a spec-identified bucket, else None."""
    ident = key.learner
    if isinstance(ident, tuple) and len(ident) == 2 \
            and isinstance(ident[0], str) and ident[0] != "opaque":
        return ident[0]
    return None


def morph_allowed(key: BucketKey, morph_tolerance: float = 0.0) -> bool:
    """May this bucket's tail blocks be coalesced/morphed?  Bitwise
    families always; tolerance-tier families only under an explicit
    ``morph_tolerance`` opt-in; opaque callables never."""
    fam = bucket_family(key)
    if fam is None:
        return False
    if fam in MORPH_BITWISE_FAMILIES:
        return True
    return morph_tolerance > 0.0 and fam in MORPH_TOLERANCE_FAMILIES


def fused_spans(g: int, b_pad: int, n_pad: int, p_pad: int,
                concat: bool) -> List[Tuple[int, int]]:
    """The sub-calls of one fused launch of ``g`` blocks, as block index
    ranges: one call per block for the per-block form, else runs of
    whole blocks whose gathered pages stay within ``FUSED_GATHER_BYTES``
    (at least one block a run)."""
    if not concat:
        return [(i, i + 1) for i in range(g)]
    per_call = max(1, FUSED_GATHER_BYTES // (b_pad * n_pad * p_pad * 4))
    return [(lo, min(lo + per_call, g)) for lo in range(0, g, per_call)]


class ProgramCache:
    """Spec-keyed cache of megabatch programs.

    Keys are ``(BucketKey, B_pad, D_pad)`` (fused: ``+ (G,)``) — pure
    value identity, so two requests built from equal plans share
    programs, and a session's repeat traffic never rebuilds one.  No
    program writes into its operands: the page stack is the
    ``PagePool``'s, reused across launches.
    """

    def __init__(self):
        self._programs: Dict[Tuple, Callable] = {}
        self.stats = CompileStats()

    # BucketKey pins the segment's (learner, params) and padded shapes,
    # which fully determine the batched fn the thunk builds — hence
    # covers={"key": ("fn_thunk",)}; the cache dict lives on this
    # ProgramCache instance, so instance state is ambient.
    @warm_cache(name="program_cache", key=("key", "b_pad", "d_pad"),
                reads=("fn_thunk",), covers={"key": ("fn_thunk",)},
                ambient=("self",))
    def program(self, key: BucketKey, b_pad: int, d_pad: int,
                fn_thunk: Callable[[], Callable]) -> Callable:
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

    @warm_cache(name="fused_program_cache",
                key=("key", "b_pad", "d_pad", "g"),
                reads=("fn_thunk",), covers={"key": ("fn_thunk",)},
                ambient=("self",))
    def fused_program(self, key: BucketKey, b_pad: int, d_pad: int,
                      g: int, fn_thunk: Callable[[], Callable]) -> Callable:
        """One launch carrying ``g`` same-shape blocks over a shared
        union page stack.  A family of ``FUSED_CONCAT_FAMILIES`` calls
        its batched function on the blocks' lanes laid end to end (split
        by ``fused_spans``); any other calls it once per block.  Both
        give every lane the per-block launch's bits."""
        pkey = (key, b_pad, d_pad, g)
        prog = self._programs.get(pkey)
        if prog is not None:
            self.stats.hits += 1
            return prog
        self.stats.misses += 1
        batched_fn = fn_thunk()
        spans = fused_spans(g, b_pad, key.n_pad, key.p_pad,
                            bucket_family(key) in FUSED_CONCAT_FAMILIES)

        def run_fused(pages, data_idx, y, w, valid, key_data):
            outs = []
            for lo, hi in spans:
                lanes = (hi - lo) * b_pad
                xb = pages[data_idx[lo:hi].reshape(lanes)]
                out = batched_fn(
                    xb, y[lo:hi].reshape(lanes, -1),
                    w[lo:hi].reshape(lanes, -1),
                    valid[lo:hi].reshape(lanes, -1),
                    key_data[lo:hi].reshape((lanes,) + key_data.shape[2:]))
                outs.append(out.reshape(hi - lo, b_pad, -1))
            return outs[0] if len(outs) == 1 else torch.cat(outs)

        self._programs[pkey] = run_fused
        return run_fused

    def shapes(self) -> List[Tuple[int, int, int]]:
        """(B_pad, N_pad, P_pad) of every program built so far (a fused
        program's per-block shape)."""
        return [(pkey[1], pkey[0].n_pad, pkey[0].p_pad)
                for pkey in self._programs]


@dataclass
class _Block:
    """One canonical launch block."""
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
    """One launch-shaped unit: one canonical block at its canonical
    shape (the common case), several tail blocks packed
    lane-contiguously (cross-shape coalescing), or a block morphed up
    to a neighbour's B.  ``offsets[i]`` is the first lane of
    ``parts[i]`` inside the combined (b_pad,) batch axis."""
    parts: List[_Block]
    offsets: List[int]
    b_pad: int
    k: int                                # total real lanes


def _coalesce(blocks: List[_Block], b_block: int, b_align: int,
              morph: bool, fuse: bool) -> List[_LaunchBlock]:
    """Lower canonical blocks to launch blocks.

    Without morphing this is the identity wrapping (every block at its
    own canonical shape).  With morphing: tails pack first-fit into
    combined blocks at one uniform padded size T chosen to minimize
    total padded lanes (buckets.pack_tail_blocks), then — if fusing
    would still face mixed shapes (full blocks vs packed tails) — the
    remaining blocks morph up to the largest b_pad so the bucket fuses
    into a single launch.
    """
    out = [_LaunchBlock([b], [0], b.b_pad, b.k)
           for b in blocks if b.b_pad >= b_block]
    tails = [b for b in blocks if b.b_pad < b_block]
    if not morph or len(tails) <= 1:
        out += [_LaunchBlock([b], [0], b.b_pad, b.k) for b in tails]
    else:
        groups, target = pack_tail_blocks([b.k for b in tails], b_block,
                                          8, b_align)
        for idxs in groups:
            parts = [tails[i] for i in idxs]
            offs, tot = [], 0
            for p in parts:
                offs.append(tot)
                tot += p.k
            out.append(_LaunchBlock(parts, offs, target, tot))
    if morph and fuse and len(out) > 1:
        target = max(lb.b_pad for lb in out)
        out = [lb if lb.b_pad == target else
               _LaunchBlock(lb.parts, lb.offsets, target, lb.k)
               for lb in out]
    return out


@dataclass(eq=False)            # identity equality: comparing in-flight
class Launch:                   # tensors elementwise would be wrong
    """One program call: ``out`` is the result tensor — (B, N_pad), or
    (G, B, N_pad) for a fused launch — possibly still being computed on
    the device.  On a CUDA device ``host`` is the pinned buffer ``out``
    is copied into (queued right after the launch, ``non_blocking``) and
    ``done`` the event recorded after that copy; on the CPU both are
    None and ``out`` is final."""
    out: torch.Tensor
    blocks: List[_LaunchBlock]
    fused: bool = False
    host: Optional[torch.Tensor] = None
    done: Optional["torch.cuda.Event"] = None

    @classmethod
    def queue(cls, out: torch.Tensor, blocks: List[_LaunchBlock],
              fused: bool = False) -> "Launch":
        """Wrap a launch's output, queueing its copy to the host."""
        if out.device.type != "cuda":
            return cls(out=out, blocks=blocks, fused=fused)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return cls(out=out, blocks=blocks, fused=fused, host=host,
                   done=done)

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
        """Wait for every launch; scatter predictions back per block,
        lane and invocation.  Returns {(req_idx, inv): preds (tpi,
        n_obs)}."""
        self._disarm("harvest")
        results: Dict[Entry, np.ndarray] = {}
        for launch in self.launches:
            out = launch.wait()
            outs = out if launch.fused else out[None]
            for g, lb in enumerate(launch.blocks):
                for blk, ofs in zip(lb.parts, lb.offsets):
                    for lane, (_, inv, row) in enumerate(blk.members):
                        buf = results.get((blk.ri, inv))
                        if buf is None:
                            buf = results[(blk.ri, inv)] = \
                                np.empty((blk.tpi, blk.n), np.float32)
                        buf[row] = outs[g, ofs + lane, :blk.n]
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


# segment_of_inv and _index_maps are pure functions of (grid, scaling,
# segment l_ids) — all key components — hence covers under req.segments
@warm_cache(name="block_layouts",
            key=("req.grid.n_rep", "req.grid.n_folds",
                 "req.grid.n_nuisance", "req.scaling", "req.segments",
                 "invs", "b_block", "b_align"),
            reads=("req.segment_of_inv", "req._index_maps"),
            covers={"req.segments": ("req.segment_of_inv",
                                     "req._index_maps")})
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


# work_key pins the FULL data content plus plan structure, which
# determines the wave arrays and key-data tables; a block's lane count k
# is determined by its member list
@warm_cache(name="block_tensors",
            key=("req.work_key", "seg_idx", "blk.members", "blk.b_pad",
                 "n_pad"),
            reads=("req.wave_arrays", "req.task_key_data", "blk.k",
                   "blk.n"),
            covers={"req.work_key": ("req.wave_arrays",
                                     "req.task_key_data", "blk.n"),
                    "blk.members": ("blk.k",)})
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
        """Per-launch-block terms: what the device actually burned — a
        coalesced launch block bills its combined b_pad ONCE."""
        self.padded_cells += lb.b_pad * key.n_pad
        self.padded_tasks += lb.b_pad

    def stats(self, padded_tasks_pow2: int,
              padded_tasks_morphed: int) -> PaddingStats:
        return PaddingStats(
            true_cells=self.true_cells, padded_cells=self.padded_cells,
            tasks=self.tasks, padded_tasks=self.padded_tasks,
            padded_tasks_pow2=padded_tasks_pow2,
            padded_tasks_morphed=padded_tasks_morphed,
            lane_cells=self.lane_cells,
            lane_cells_pow2=self.lane_cells_pow2,
            true_feats=self.true_feats, padded_feats=self.padded_feats)


def _page_key_of(plan: MegabatchPlan, pages: Optional[PagePool],
                 blk: _Block, n_pad: int, p_pad: int):
    """Identity of a block's feature page: the PagePool content key when
    pooled, the request index on the host-stacked path."""
    if pages is not None:
        return PagePool.page_key(plan.requests[blk.ri], n_pad, p_pad)
    return blk.ri


def _launch_pages(plan: MegabatchPlan, pages: Optional[PagePool],
                  key: BucketKey, lbs: List[_LaunchBlock],
                  n_pad: int, p_pad: int, device: torch.device):
    """Union page stack on ``device`` + page-key -> lane map across launch
    blocks: from the pool when there is one, else stacked on the host and
    uploaded."""
    lane_of: Dict[object, int] = {}
    needs = []
    for lb in lbs:
        for blk in lb.parts:
            pk = _page_key_of(plan, pages, blk, n_pad, p_pad)
            if pk not in lane_of:
                lane_of[pk] = len(lane_of)
                needs.append((pk, plan.requests[blk.ri]))
    if pages is not None:
        return pages.stack(needs, n_pad, p_pad), lane_of
    stack = [plan.page(ri, key) for ri, _ in needs]
    d_pad = pow2_bucket(len(stack), 1)
    stack += [np.zeros((n_pad, p_pad), np.float32)] * (d_pad - len(stack))
    return upload(np.stack(stack), device), lane_of


def _launch_tensors(plan: MegabatchPlan, lb: _LaunchBlock, n_pad: int):
    """One launch block's (y, w, valid, kd) at its launch shape.

    A single canonical block at its own shape comes straight from the
    content-keyed tensor cache (zero copy); packed or morphed launch
    blocks assemble their combined batch axis from the parts' cached
    tensors (padding lanes stay zero with valid=0)."""
    if len(lb.parts) == 1 and lb.b_pad == lb.parts[0].b_pad:
        blk = lb.parts[0]
        return _block_tensors(plan.requests[blk.ri], blk.si, blk, n_pad)
    y = np.zeros((lb.b_pad, n_pad), np.float32)
    w = np.zeros((lb.b_pad, n_pad), np.float32)
    valid = np.zeros((lb.b_pad, n_pad), np.float32)
    kd = None
    for blk, ofs in zip(lb.parts, lb.offsets):
        py, pw, pv, pkd = _block_tensors(plan.requests[blk.ri], blk.si,
                                         blk, n_pad)
        if kd is None:
            kd = np.zeros((lb.b_pad,) + pkd.shape[1:], pkd.dtype)
        k = blk.k
        y[ofs:ofs + k] = py[:k]
        w[ofs:ofs + k] = pw[:k]
        valid[ofs:ofs + k] = pv[:k]
        kd[ofs:ofs + k] = pkd[:k]
    return y, w, valid, kd


def _launch_didx(plan: MegabatchPlan, pages: Optional[PagePool],
                 lb: _LaunchBlock, lane_of: Dict[object, int],
                 n_pad: int, p_pad: int) -> np.ndarray:
    """Per-lane page index for one launch block.  Padding lanes point at
    page 0 — their gather is masked by valid=0, and a fixed index keeps
    the launch deterministic."""
    didx = np.zeros((lb.b_pad,), np.int64)
    for blk, ofs in zip(lb.parts, lb.offsets):
        didx[ofs:ofs + blk.k] = \
            lane_of[_page_key_of(plan, pages, blk, n_pad, p_pad)]
    return didx


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


def _morphed_tasks(blocks: List[_Block], lblocks: List[_LaunchBlock],
                   b_block: int, b_align: int, morph: bool, can_morph: bool,
                   fuse: bool) -> int:
    """The morphed-B comparator: the lanes the coalescing scheduler
    burns (or would burn, when coalescing is off) on a slice's B axis."""
    if morph == can_morph:
        return sum(lb.b_pad for lb in lblocks)
    return sum(lb.b_pad for lb in
               _coalesce(blocks, b_block, b_align, can_morph, fuse))


def _book(cache: ProgramCache, pad_acc: _PaddingAcc, plan: MegabatchPlan,
          key: BucketKey, lb: _LaunchBlock) -> None:
    """Blocks, coalesced parts and padding of one launch block."""
    cache.stats.blocks += len(lb.parts)
    if len(lb.parts) > 1:
        cache.stats.coalesced_blocks += len(lb.parts)
    for blk in lb.parts:
        pad_acc.book_part(
            key, blk, plan.requests[blk.ri].segments[blk.si].learner is None)
    pad_acc.book_launch(key, lb)


def _launch_one(plan: MegabatchPlan, pages: Optional[PagePool],
                key: BucketKey, lb: _LaunchBlock, device: torch.device,
                program: Callable[[int, int], Callable]) -> Launch:
    """Launch one launch block on its own (``program(b_pad, d_pad)``
    picks the program)."""
    n_pad, p_pad = key.n_pad, key.p_pad
    pages_t, lane_of = _launch_pages(plan, pages, key, [lb], n_pad, p_pad,
                                     device)
    y, w, valid, kd = _launch_tensors(plan, lb, n_pad)
    didx = _launch_didx(plan, pages, lb, lane_of, n_pad, p_pad)
    prog = program(lb.b_pad, int(pages_t.shape[0]))
    out = prog(pages_t, *(upload(a, device)
                          for a in (didx, y, w, valid, kd)))
    return Launch.queue(out, [lb])


def _dispatch_axis_bucket(plan: MegabatchPlan, cache: ProgramCache,
                          key: BucketKey, entries: Sequence[Entry],
                          blocks: List[_Block], axis: str, mesh, *,
                          b_align: int, pages: Optional[PagePool],
                          b_block: int, coalesce: bool,
                          morph_tolerance: float) -> BucketDispatch:
    """Lower a bucket slice through the planner's data/feature layout:
    every launch block runs the in-mesh fit-predict program
    (sharding/gram.py::axis_fit_program) on ``mesh``'s device instead of
    the task program — the data form streams the rows as chunks through
    the blocked Gram kernel.  Pages, task tensors, tail packing, harvest
    booking and the padding account are the task path's; results sit in
    the float tier of the task axis (another solve, another order of
    summation), so axis launches never fuse across blocks."""
    from repro_torch.sharding.gram import (
        axis_fit_program, axis_fit_program_cached,
    )
    family = bucket_family(key)
    params = tuple(key.learner[1])
    can_morph = morph_allowed(key, morph_tolerance)
    morph = coalesce and can_morph
    lblocks = _coalesce(blocks, b_block, b_align, morph, False)
    morphed_tasks = _morphed_tasks(blocks, lblocks, b_block, b_align, morph,
                                   can_morph, False)

    def program(b_pad: int, d_pad: int) -> Callable:
        if axis_fit_program_cached(mesh, axis, family, params):
            cache.stats.hits += 1
        else:
            cache.stats.misses += 1
        return axis_fit_program(mesh, axis, family, params)

    pad_acc = _PaddingAcc()
    launches: List[Launch] = []
    for lb in lblocks:
        launches.append(_launch_one(plan, pages, key, lb, mesh.device,
                                    program))
        cache.stats.launches += 1
        if len(lb.parts) > 1:
            cache.stats.fused_launches += 1
        _book(cache, pad_acc, plan, key, lb)
    total_tasks = sum(blk.k for blk in blocks)
    cache.stats.padding = cache.stats.padding.merge(
        pad_acc.stats(pow2_bucket(total_tasks, 8), morphed_tasks))
    return BucketDispatch(key=key, launches=launches,
                          entries=list(entries), n_tasks=total_tasks)


def dispatch_bucket(plan: MegabatchPlan, cache: ProgramCache,
                    key: BucketKey, entries: Sequence[Entry], *,
                    device: torch.device, b_align: int = 1,
                    pages: Optional[PagePool] = None,
                    b_block: int = B_BLOCK, fuse: bool = True,
                    coalesce: bool = True, morph_tolerance: float = 0.0,
                    axis_decision=None, mesh=None) -> BucketDispatch:
    """Launch one bucket slice WITHOUT waiting for the device.

    Groups the entries' tasks into canonical launch blocks; for
    morph-proven families (``coalesce``, see MORPH_BITWISE_FAMILIES)
    tail blocks pack cross-request into combined launch blocks and
    residual mixed shapes morph up so the bucket fuses into one launch.
    Equal-``b_pad`` launch blocks go up in fused launches over one union
    page stack (per-block launches when ``fuse`` is off or the block is
    alone at its shape).  ``pages``: the backend's ``PagePool``, else the
    pages are stacked on the host per launch.  Returns the in-flight
    ``BucketDispatch``; call ``.harvest()`` for the results.

    ``axis_decision``/``mesh``: a planner ``AxisDecision`` whose axis is
    data/feature lowers every block through the in-mesh program of
    sharding/gram.py on ``mesh``'s device when ``_axis_to_execute``
    allows it; the decision's ``executed`` field is stamped with the
    axis that ran either way.
    """
    requests = plan.requests
    n_pad, p_pad = key.n_pad, key.p_pad
    blocks = _plan_blocks(plan, key, entries, b_block, b_align)
    axis_m = _axis_to_execute(key, axis_decision, mesh)
    if axis_m is not None:
        axis_decision.executed = axis_m[0]
        return _dispatch_axis_bucket(
            plan, cache, key, entries, blocks, axis_m[0], mesh,
            b_align=b_align, pages=pages, b_block=b_block,
            coalesce=coalesce, morph_tolerance=morph_tolerance)
    if axis_decision is not None:
        axis_decision.executed = "task"
    can_morph = morph_allowed(key, morph_tolerance)
    morph = coalesce and can_morph
    lblocks = _coalesce(blocks, b_block, b_align, morph, fuse)
    morphed_tasks = _morphed_tasks(blocks, lblocks, b_block, b_align, morph,
                                   can_morph, fuse)

    by_shape: Dict[int, List[_LaunchBlock]] = {}
    for lb in lblocks:
        by_shape.setdefault(lb.b_pad, []).append(lb)

    pad_acc = _PaddingAcc()
    launches: List[Launch] = []
    for b_pad, group in by_shape.items():
        lead = group[0].parts[0]
        seg = requests[lead.ri].segments[lead.si]
        if not fuse or len(group) == 1:
            for lb in group:
                blk_seg = requests[lb.parts[0].ri].segments[lb.parts[0].si]
                launches.append(_launch_one(
                    plan, pages, key, lb, device,
                    lambda b, d: cache.program(
                        key, b, d, lambda: segment_batched_fn(blk_seg))))
                cache.stats.launches += 1
                if len(lb.parts) > 1:
                    # a coalesced multi-part launch IS a fused launch:
                    # 2+ canonical blocks went up in one call
                    cache.stats.fused_launches += 1
                _book(cache, pad_acc, plan, key, lb)
            continue

        # ---- fused launch: G same-shape launch blocks, one union stack
        pages_t, lane_of = _launch_pages(plan, pages, key, group, n_pad,
                                         p_pad, device)
        g = len(group)
        ys = np.empty((g, b_pad, n_pad), np.float32)
        ws = np.empty((g, b_pad, n_pad), np.float32)
        valids = np.empty((g, b_pad, n_pad), np.float32)
        didx = np.empty((g, b_pad), np.int64)
        kds = None
        for gi, lb in enumerate(group):
            y, w, valid, kd = _launch_tensors(plan, lb, n_pad)
            if kds is None:
                kds = np.empty((g,) + kd.shape, kd.dtype)
            ys[gi], ws[gi], valids[gi], kds[gi] = y, w, valid, kd
            didx[gi] = _launch_didx(plan, pages, lb, lane_of, n_pad, p_pad)
            _book(cache, pad_acc, plan, key, lb)
        prog = cache.fused_program(key, b_pad, int(pages_t.shape[0]), g,
                                   lambda: segment_batched_fn(seg))
        out = prog(pages_t, *(upload(a, device)
                              for a in (didx, ys, ws, valids, kds)))
        launches.append(Launch.queue(out, list(group), fused=True))
        cache.stats.launches += 1
        cache.stats.fused_launches += 1

    total_tasks = sum(blk.k for blk in blocks)
    # one merge per dispatch; padded_tasks_pow2 records what one pow2
    # launch per bucket slice would have cost, padded_tasks_morphed what
    # the coalescing scheduler costs
    cache.stats.padding = cache.stats.padding.merge(
        pad_acc.stats(pow2_bucket(total_tasks, 8), morphed_tasks))
    return BucketDispatch(key=key, launches=launches,
                          entries=list(entries), n_tasks=total_tasks)

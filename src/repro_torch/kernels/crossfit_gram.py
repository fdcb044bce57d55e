"""The shared-X cross-fit Gram kernel, beside its plain PyTorch version.

``crossfit_gram_cuda`` replaces the TPU kernel ``crossfit_gram_pallas``
(body ``_kernel``) of the JAX package's ``kernels/crossfit_gram.py``: the
T = M*K*L cross-fit tasks of one request share one feature matrix and
differ only in their weights (0/1 fold masks) and targets, so the
per-task normal equations

    G_t = X' diag(w_t) X,   b_t = X'(w_t * y_t)

are accumulated for a block of tasks in one pass over X.  That is the
paper's technique as compute: one read of an X tile serves a block of
tasks, where K1 (``batched_gram``) on X broadcast to (T, N, P) reads X
once per task.  At the paper's shape (T 1000, N 5099, P 18 with the
intercept) the function moves 42.5 MB and does 2.0 GFLOP: bound by
operations on an H100 (0.030 ms at 67 TFLOP/s plain float32, against
0.013 ms for the bytes); K1 on the broadcast tensor would read 367 MB.

The kernel (``crossfit_gram_kernel<SUB, TT, SPAN>`` in
``csrc/megabatch.cu``) sums every element of every task in K1's order
(64-row steps, four groups of 16 rows, the groups added in order), so the
result is bitwise K1 on ``x.expand(T, N, P)``.  That order fixes one chain
per (task, element, group) over all of N; what the launch chooses is which
thread owns which chains.  A thread owns one SUB x SUB sub-tile of G's
upper triangle for TT tasks and one row group, (SUB, TT) one of (4, 2),
(4, 4), (2, 2), (2, 1); a block packs (sub-tile, task pack) items densely
into 4 groups of 32 or 64 threads; a ring of 2-8 slots of 2 or 4 64-row
steps in shared memory, filled by ``cp.async`` in chunks aligned to the
operands' addresses, keeps the next slots in flight while one is
multiplied out.  ``launch_plan`` picks the plan from T, N and P with a
small model of the card (132 SMs, 4 schedulers each, shared-load and L2
rates, a barrier a slot), checked against the time of every plan at the
path shapes by ``scripts/bench_crossfit_plans.py``: the opaque drain's
T = 1 lanes take SUB 2, the paper's T = 1000 SUB 4 with two tasks a
thread, wide P four.  Every plan gives the same bits.  No TF32, no
atomics, N never split across blocks; G comes out exactly symmetric, and
rows with ``w == 0`` add exact zeros.  Any T, N, P and alignment of a
float: the ragged edges are masked in the kernel, with no padding in the
wrapper (the TPU kernel's 128-lane P, 8-task and 512-row padding was that
machine's layout).  PERF.md has its times beside the earlier kernel's
(one-step register prefetch, four tasks a thread at 186 registers: 0.245
ms at the paper's shape, 0.0868 ms at T = 1; NVIDIA H100 80GB HBM3,
700.00 W).

``crossfit_gram_cuda`` adds one to ``runtime.launch_counts
["crossfit_gram"]`` where it launches, and nowhere else; it raises on an
input that needs a gradient (no backward is ported).
``crossfit_gram_plain`` is what the CPU path and the on-card comparison
use; nothing on the main path calls it for tensors that lie on the card.
"""
from __future__ import annotations

import functools
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import build
# the card the plan is sized for: an H100's SMs, and the shared memory a
# block may hold (csrc/megabatch.cu XF_SMEM_MAX, GRAM_SMEM_MAX)
from repro_torch.kernels.megabatch import SM_COUNT, SMEM_MAX, check_operand

F32 = torch.float32
_MAX_GRID_Y = 65535

TILE, ROWS, GROUPS = 32, 64, 4         # K1's tile edge, row step, groups
X_STRIDE = 36                          # a staged tile row: 9 chunks
MAX_THREADS = 256
MAX_ACC = 64                           # accumulators of G a thread
MAX_RING, MAX_M = 8, 8
RING_BYTES = 100 * 1024                # two blocks share an SM's 228 KB
# the (SUB, TT) instances the kernel is built for (SUB^2 TT >= 32 runs one
# block an SM, the others two), slots a group, 64-row steps a ring slot
CONFIGS = ((4, 2), (4, 4), (2, 2), (2, 1))
SLOTS = (64, 32)
STEPS = (2, 4)


class LaunchPlan(NamedTuple):
    """How ``crossfit_gram_kernel`` is launched for one (T, N, P)."""
    sub: int            # sub-tile edge a thread owns
    tt: int             # tasks a thread holds
    slots: int          # threads a row group; a block is 4 groups
    packs: int          # task packs a block (tt tasks each)
    chunks: int         # blocks that share one tile pair's items
    ring: int           # ring slots in shared memory
    m: int              # 64-row steps a ring slot
    grid: Tuple[int, int]
    smem_bytes: int
    est_cycles: float   # the model's estimate, for the choice

    @property
    def threads(self) -> int:
        return GROUPS * self.slots

    @property
    def tasks(self) -> int:
        """Tasks a block."""
        return self.packs * self.tt

    @property
    def per_block(self) -> int:
        """Items (sub-tiles) a block."""
        return self.slots // self.packs

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds at once (registers: two of 256 threads under
        128 registers, one above; and shared memory)."""
        regs = 1 if self.sub * self.sub * self.tt >= 32 else 2
        return max(1, min(regs * MAX_THREADS // self.threads,
                          SMEM_MAX // self.smem_bytes))


def subtiles(ti: int, tj: int, p: int, sub: int) -> Tuple[int, int, int]:
    """(items, sub-rows, sub-columns) of tile pair (ti, tj): the SUB x SUB
    sub-tiles that meet [0, P)^2 and, on a diagonal pair, the upper
    triangle (``xfit_subtiles`` in ``csrc/megabatch.cu``)."""
    edge = TILE // sub
    sy_n = min(-(-(p - ti * TILE) // sub), edge)
    sx_n = min(-(-(p - tj * TILE) // sub), edge)
    n = sy_n * (sy_n + 1) // 2 if ti == tj else sy_n * sx_n
    return n, sy_n, sx_n


def tile_pairs(p: int) -> Iterator[Tuple[int, int]]:
    """The tile pairs ti <= tj in the kernel's blockIdx.y order."""
    n_tiles = -(-p // TILE)
    for ti in range(n_tiles):
        for tj in range(ti, n_tiles):
            yield ti, tj


def stage_floats(p: int, tasks: int, m: int) -> int:
    """Floats of one ring slot (``xfit_stage_floats``): m steps of 64 X
    rows (P <= 32: at a stride of 32; above: two tiles of rows of 36), then
    w and y of the block's tasks (64 m values and a chunk for the
    shift)."""
    x = ROWS * m * (TILE if p <= TILE else 2 * X_STRIDE)
    return x + 2 * tasks * (ROWS * m + 4)


def _plan(t: int, n: int, p: int, sub: int, tt: int, slots: int,
          m: int) -> Optional[LaunchPlan]:
    items = [subtiles(ti, tj, p, sub)[0] for ti, tj in tile_pairs(p)]
    most = max(items)
    if most <= slots:
        packs, chunks = min(slots // most, -(-t // tt)), 1
    else:
        packs, chunks = 1, -(-most // slots)
    tasks = packs * tt
    per_block = slots // packs
    sf = stage_floats(p, tasks, m)
    n_slots = -(-n // (ROWS * m))
    task_blocks = -(-t // tasks)
    # blocks with items (a chunk past its pair's items exits at once)
    blocks = task_blocks * sum(-(-k // per_block) for k in items)
    # the ring takes what shared memory the SM's blocks leave it: all of it
    # when the launch has no more blocks than the card has SMs
    budget = SMEM_MAX if blocks <= SM_COUNT else RING_BYTES
    ring = max(2, min(MAX_RING, budget // (4 * sf), n_slots + 1))
    red = 3 * slots * (sub * sub + sub)          # partial tiles, floats
    while ring * sf < red:
        ring += 1
    smem = 4 * ring * sf
    if smem > SMEM_MAX or ring > MAX_RING:
        return None
    grid = (chunks * task_blocks, len(items))
    plan = LaunchPlan(sub, tt, slots, packs, chunks, ring, m, grid, smem,
                      0.0)
    return plan._replace(est_cycles=_estimate(plan, n, p, blocks))


# The model behind the choice (clock cycles of the busiest SM).  A row
# group's thread issues, per row, `lds` shared loads and `fp` float
# operations; a scheduler issues one instruction a clock, and a warp
# alone reaches FEW_WARPS of that (load and FMA latency); an SM's shared
# memory takes one load a clock.  Each ring slot costs a barrier, and the
# X slab, w and y of every block come from L2 at L2_BYTES_CLK per SM.
FEW_WARPS = 0.5
BARRIER_CLK = 300
L2_BYTES_CLK = 24.0


def _estimate(plan: LaunchPlan, n: int, p: int, blocks: int) -> float:
    sub, tt = plan.sub, plan.tt
    span = p <= TILE
    vec = 4 if span or p % 4 == 0 else (2 if p % 2 == 0 else 1)
    lds = 2 * -(-sub // min(vec, sub)) + tt
    fp = tt * (sub + sub * sub)
    per_sm = -(-blocks // SM_COUNT)
    resident = plan.blocks_per_sm
    warps = plan.threads // 32
    n_slots = -(-n // (ROWS * plan.m))
    rows = n_slots * plan.m * (ROWS // GROUPS)
    # bytes a block brings from L2 a slot: the X rows (P floats, or two
    # tiles of 36) and the chunks of w and y
    slab = 4 * ROWS * plan.m * (p if span else 2 * X_STRIDE) \
        + 8 * plan.tasks * (ROWS * plan.m + 4)
    est = 0.0
    while per_sm > 0:
        k = min(per_sm, resident)
        wps = k * warps / 4
        compute = rows * max((lds + fp) * max(1.0 / FEW_WARPS, wps),
                             lds * 4 * wps)
        l2 = k * n_slots * slab / L2_BYTES_CLK
        est += max(compute, l2) + n_slots * BARRIER_CLK
        per_sm -= resident
    return est


@functools.lru_cache(maxsize=256)
def launch_plan(t: int, n: int, p: int) -> LaunchPlan:
    """The plan ``crossfit_gram_cuda`` launches for (T, N, P): of every
    (SUB, TT) instance, group size and ring slot, the one the model rates
    fastest (ties to the earlier, heavier, configuration)."""
    best = None
    for sub, tt in CONFIGS:
        for slots in SLOTS:
            for m in STEPS:
                plan = _plan(t, n, p, sub, tt, slots, m)
                if plan is not None and (
                        best is None or plan.est_cycles < best.est_cycles):
                    best = plan
    assert best is not None        # SUB 2, one task a thread always fits
    return best


def block_items(plan: LaunchPlan, t: int, p: int, bx: int,
                by: int) -> Iterator[Tuple[int, int, int, int, int]]:
    """(task, ti, tj, sy, sx) of every chain the block (bx, by) of a
    launch owns, per row group: the kernel's index arithmetic, so the
    tests can check that a plan covers each (task, sub-tile) once."""
    pairs = list(tile_pairs(p))
    ti, tj = pairs[by]
    n_sub, sy_n, sx_n = subtiles(ti, tj, p, plan.sub)
    chunk, task0 = bx % plan.chunks, (bx // plan.chunks) * plan.tasks
    if chunk * plan.per_block >= n_sub:
        return
    for slot in range(plan.slots):
        li, q = divmod(slot, plan.packs)
        u = chunk * plan.per_block + li
        tq = task0 + q * plan.tt
        if li >= plan.per_block or u >= n_sub or tq >= t:
            continue
        if ti == tj:
            sy, length = 0, sy_n
            while u >= length > 0:
                u -= length
                sy += 1
                length -= 1
            sx = sy + u
        else:
            sy, sx = divmod(u, sx_n)
        for task in range(tq, min(tq + plan.tt, t)):
            yield task, ti, tj, sy, sx


def crossfit_gram_plain(x, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N,P); w, y (T,N) -> (G (T,P,P) f32, b (T,P) f32)."""
    xf, wf, yf = x.to(F32), w.to(F32), y.to(F32)
    g = torch.einsum("np,tn,nq->tpq", xf, wf, xf)
    b = torch.einsum("tn,np->tp", wf * yf, xf)
    return g, b


def check_task_rows(x, w, y) -> Tuple[int, int, int]:
    """(T, N, P) of a shared-X call — x (N, P), w and y (T, N), float32
    contiguous on one device — or raise."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2 or min(x.shape) < 1:
        raise ValueError("x: expected a non-empty (N, P) torch.Tensor")
    check_operand("x", x, x.shape, x)
    n, p = x.shape
    if not isinstance(w, torch.Tensor) or w.dim() != 2 or w.shape[0] < 1:
        raise ValueError("w: expected a non-empty (T, N) torch.Tensor")
    t = int(w.shape[0])
    check_operand("w", w, (t, n), x)
    check_operand("y", y, (t, n), x)
    return t, n, p


def crossfit_gram_cuda(x, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the shared-X Gram kernel on CUDA tensors (contiguous
    float32): x (N, P), w and y (T, N)."""
    runtime.refuse_grad("crossfit_gram", x, w, y)
    t, n, p = check_task_rows(x, w, y)
    if not x.is_cuda:
        raise ValueError(f"x: the CUDA kernels take tensors on the card, "
                         f"got {x.device}")
    n_tiles = -(-p // TILE)
    # row indices (plus a 64-row step) are 32-bit ints in the kernel
    if n * p >= 2 ** 31 or n_tiles * (n_tiles + 1) // 2 > _MAX_GRID_Y:
        raise ValueError(f"crossfit_gram: shape (T {t}, N {n}, P {p}) "
                         "exceeds the kernel's launch limits")
    plan = launch_plan(t, n, p)
    if plan.grid[0] >= 2 ** 31:
        raise ValueError(f"crossfit_gram: shape (T {t}, N {n}, P {p}) "
                         "exceeds the kernel's launch limits")
    lib = build.load_library("megabatch")
    with torch.cuda.device(x.device):
        g = torch.empty((t, p, p), dtype=F32, device=x.device)
        bv = torch.empty((t, p), dtype=F32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["crossfit_gram"] += 1
        code = lib.repro_crossfit_gram(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), g.data_ptr(),
            bv.data_ptr(), t, n, p, plan.sub, plan.tt, plan.slots,
            plan.packs, plan.chunks, plan.ring, plan.m, stream)
    build.check_launch(lib, code, "crossfit_gram")
    return g, bv

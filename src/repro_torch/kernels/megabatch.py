"""The three megabatch kernels, each beside its plain PyTorch version.

The megabatch compiler (repro_torch/compile) stacks tasks from different
requests — hence different datasets — into one ``(B, N, P)`` tensor, so
every task carries its own feature page.  Three kernels cover the linear
learners' hot path; all are CUDA C++ in ``csrc/megabatch.cu``.

``batched_gram_cuda``
    replaces the TPU kernel ``batched_gram_pallas`` (body ``_gram_kernel``)
    of the JAX package's ``kernels/megabatch.py``: per-task masked normal
    equations ``G_b = X_b' diag(w_b) X_b``, ``b_b = X_b'(w_b * y_b)``.
    It does P/2 float32 operations per byte of X it reads; an H100 does
    about 20 plain float32 operations in the time it reads one byte
    (67 TFLOP/s over 3.35 TB/s).  So at the paper's block shape
    (B 32, N 5104, P 33) and the tall path's it is bound by bytes, and
    wide pages (P in the hundreds) are bound by operations.
    Every element is four chains, one per row group g (rows [16g, 16g+16)
    of every 64-row step, in order, ``fmaf(w x_i, x_j, acc)``), added as
    ((g0 + g1) + g2) + g3: the order the shared-X kernel (K4) keeps too,
    so K4 is bitwise K1 on x broadcast.  Each chain is whole in one
    thread; what is split is the set of chains: the four row groups of a
    task run in four blocks, each reading only its group's rows, and a
    row group's elements may be split over ``chunks`` blocks; a second
    launch adds the groups' partial tiles (a scratch the wrapper
    allocates) in that order.  A thread owns an SI x SJ sub-tile of G's
    upper triangle (or of b, a row of w y below it); a producer warp keeps
    a ring of row slots in shared memory full with 1-D bulk copies, three
    more turn each slot into padded rows of w x and x, and the consumer
    warps multiply them out.  ``gram_launch_plan`` picks (SI, SJ), chunks,
    slot rows and ring depth from (B, N, P); every plan gives the same
    bits.  No atomics; only i <= j is computed and mirrored, so ``G`` is
    exactly symmetric; rows with ``w == 0`` contribute exact zeros.  The
    plan gives the kernel a table of each chunk's items and the columns
    they read: whole rows up to about 2400 columns, and past that a pair
    of PANEL-column panels a chunk, so any P fits a block.

``batched_gram_blocked_cuda``
    replaces ``batched_gram_blocked_pallas`` (body
    ``_gram_blocked_kernel``): the same normal equations over N streamed
    as C chunks of Nc rows, ``xc (B, C, Nc, P)``, for the tall buckets
    of the data-parallel layout (sharding/gram.py), whose N exceeds one
    device page.  ``xc`` is contiguous, so its rows already lie as the
    merged ``(B, C*Nc, P)``: the wrapper launches batched_gram's kernel
    on that view (no copy), and the result is bitwise batched_gram on the
    merged tensor at every Nc.

``batched_predict_cuda``
    replaces ``batched_predict_pallas`` (body ``_predict_kernel``): the
    masked GEMV epilogue ``valid_b * (X_b beta_b)``.  Bound by bytes (two
    operations per four bytes read), so the design keeps bytes in flight:
    a block stages the contiguous span of X its rows occupy into shared
    memory with 16-byte loads, four in flight a thread (a scalar head and
    tail where the span is not 16-byte aligned), then each row is summed
    by a group of 1-32 threads chosen from P alone, in one fixed order per
    output element, and multiplied by ``valid`` last so padding rows come
    out exactly 0.  P is at most 28672 (one row and ``beta_b`` in a
    block's shared memory).

The TPU kernels' 128-lane padding of P, 8-sublane padding of B and
``block_n`` padding of N were that machine's layout, not the contract:
these kernels take the true ``(B, N, P)`` and mask the ragged edges.

Each ``*_cuda`` wrapper adds one to its entry of ``runtime.launch_counts``
where it launches, and nowhere else.  The ``*_plain`` versions are what
the CPU path and the on-card comparison use; nothing on the main path
calls them for tensors that lie on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import build

F32 = torch.float32
_MAX_GRID_Y = 65535
_MAX_PREDICT_P = 28672                 # a row and beta_b in one block's smem


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def batched_gram_plain(xs, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B,N,P); w, y (B,N) -> (G (B,P,P) f32, b (B,P) f32)."""
    xf, wf, yf = xs.to(F32), w.to(F32), y.to(F32)
    g = torch.einsum("bnp,bn,bnq->bpq", xf, wf, xf)
    b = torch.einsum("bn,bnp->bp", wf * yf, xf)
    return g, b


def batched_gram_blocked_plain(xc, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc (B,C,Nc,P); w, y (B,C,Nc) -> batched_gram_plain on the merged
    (B, C*Nc, P) view: merging the chunk axis is a relayout, no
    arithmetic."""
    b, c, nc, p = xc.shape
    return batched_gram_plain(xc.reshape(b, c * nc, p),
                              w.reshape(b, c * nc), y.reshape(b, c * nc))


def batched_predict_plain(xs, beta, valid) -> torch.Tensor:
    """xs (B,N,P); beta (B,P); valid (B,N) -> valid * (X beta), (B,N) f32."""
    pred = torch.einsum("bnp,bp->bn", xs.to(F32), beta.to(F32))
    return pred * valid.to(F32)


# ---------------------------------------------------------------------------
# operand checks (shared with kernels/ops.py)
# ---------------------------------------------------------------------------
def check_xs(xs) -> Tuple[int, int, int]:
    """(B, N, P) of a float32 contiguous feature batch, or raise."""
    if not isinstance(xs, torch.Tensor) or xs.dim() != 3 \
            or min(xs.shape) < 1:
        raise ValueError("xs: expected a non-empty (B, N, P) torch.Tensor")
    check_operand("xs", xs, xs.shape, xs)
    return tuple(xs.shape)


def check_xc(xc) -> Tuple[int, int, int, int]:
    """(B, C, Nc, P) of a float32 contiguous chunked feature batch, or
    raise."""
    if not isinstance(xc, torch.Tensor) or xc.dim() != 4 \
            or min(xc.shape) < 1:
        raise ValueError("xc: expected a non-empty (B, C, Nc, P) "
                         "torch.Tensor")
    check_operand("xc", xc, xc.shape, xc)
    return tuple(xc.shape)


def check_operand(name: str, t, shape, xs: torch.Tensor) -> None:
    """Raise unless ``t`` is a float32 contiguous tensor of ``shape`` on
    the device of ``xs`` — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != xs.device:
        raise ValueError(f"{name}: lies on {t.device}, xs on {xs.device}")
    if t.dtype != F32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _check_launchable(xs: torch.Tensor) -> Tuple[int, int, int]:
    b, n, p = check_xs(xs)
    _check_on_card_within_limits("xs", xs, b, n, p)
    return b, n, p


def _check_on_card_within_limits(name: str, t: torch.Tensor, b: int,
                                 rows: int, p: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernels take tensors on the "
                         f"card, got {t.device}")
    # row indices (plus a 64-row step) are 32-bit ints in the kernels
    if b > _MAX_GRID_Y or max(rows, p) >= 2 ** 31 - 64:
        raise ValueError(f"{name}: shape {tuple(t.shape)} exceeds the "
                         "kernels' launch limits")


# ---------------------------------------------------------------------------
# the Gram kernel's launch plan (csrc/megabatch.cu batched_gram_kernel)
# ---------------------------------------------------------------------------
SM_COUNT = 132                         # an H100's SMs
SMEM_MAX = 232448                      # shared memory a block may hold
SMEM_TWO = 113 * 1024                  # ... when two blocks share an SM
GROUPS, STEP = 4, 64                   # row groups of a 64-row step
GROUP_ROWS = STEP // GROUPS
MAX_CONSUMERS = 256                    # threads that own sub-tiles
MAX_RING = 8
TILES = ((4, 2), (4, 4), (8, 8))       # the kernel's (SI, SJ) instances
SLOT_ROWS = (4, 8, 16, 32, 64, 128)    # rows of the group a ring slot
SLOT_BYTES = 17 * 1024                 # the size the plan gives a slot
BAR_FLOATS = 4 * MAX_RING              # the ring's mbarriers, 2 a slot
PANEL = 128                            # columns of a panel (wide P), with
PANEL_TILE = (8, 8)                    # the (SI, SJ) instance built for it


class GramPlan(NamedTuple):
    """How ``batched_gram_kernel<SI, SJ>`` is launched for one (B, N, P),
    and the layout of a block's shared memory (``GramLayout`` in the C
    source, the fields from ``per_cta`` to ``bar_at`` in its order)."""
    si: int             # sub-tile a thread owns: rows (of w x) ...
    sj: int             # ... and columns (of x)
    panel: int          # columns of a panel; 0: every chunk reads whole rows
    chunks: int         # blocks that share a row group's items
    per_cta: int        # items (threads with a sub-tile) a block
    ring: int           # ring slots in shared memory
    srows: int          # rows of the group a ring slot
    pr: int             # rows of a staged piece
    ws: int             # row stride of the padded w x buffer
    xs: int             # ... and of the x buffer
    blk: int            # floats of a staged piece
    wa: int             # where w starts in a piece (y: pr + 8 floats on)
    seg: int            # panels: floats a staged row window; 0: whole rows
    pad_at: int         # where the two padded buffers start
    bar_at: int         # where the ring's mbarriers start
    grid: Tuple[int, int]
    smem_bytes: int

    def layout(self) -> Tuple[int, ...]:
        """The ints of ``GramLayout``, in its order."""
        return self[self._fields.index("per_cta"):
                    self._fields.index("bar_at") + 1]

    @property
    def consumers(self) -> int:
        """Threads that own items: whole warps, the block's first."""
        return -(-self.per_cta // 32) * 32

    def scratch_floats(self, b: int) -> int:
        """The partial tiles of the four row groups of every block, which
        the second launch adds: B chunks 4 SI SJ consumers floats."""
        return b * self.chunks * GROUPS * self.si * self.sj * self.consumers


def _up(v: int, q: int) -> int:
    return -(-v // q) * q


def gram_items(p: int, si: int, sj: int) -> torch.Tensor:
    """The sub-tiles (I, J) of the (P + 1) x P matrix whose row P is
    w y, (items, 2) int64 in row-major order: sub-rows I < P // SI from the
    first sub-column that meets the upper triangle, then every sub-column
    of sub-row P // SI, which holds b."""
    ip, jn = p // si, -(-p // sj)
    i = torch.arange(ip + 1).unsqueeze(1)
    j = torch.arange(jn).unsqueeze(0)
    keep = (j >= si * i // sj) | (i == ip)
    return torch.nonzero(keep)


def _item_sets(p: int, si: int, sj: int, panel: int):
    """The items grouped by the columns they read: one set of every item
    (whole rows), or one set a pair of column panels (the panel of the
    item's w x rows, the panel of its x columns).  Returns the items in
    set order, each item's set, and each set's windows (a0, na, b0, nb)."""
    items = gram_items(p, si, sj)
    if not panel:
        return (items, torch.zeros(len(items), dtype=torch.long),
                torch.tensor([[0, p + 1, 0, p]]))
    key = si * items[:, 0] // panel * (p // panel + 2) \
        + sj * items[:, 1] // panel
    keys, inverse = torch.unique(key, return_inverse=True)
    order = torch.sort(inverse, stable=True).indices
    a0 = keys // (p // panel + 2) * panel
    b0 = keys % (p // panel + 2) * panel
    win = torch.stack([a0, torch.clamp(p + 1 - a0, max=panel), b0,
                       torch.clamp(p - b0, max=panel)], 1)
    return items[order], inverse[order], win


def _chunk_of(sets: torch.Tensor, per_cta: int):
    """Each item's chunk and place in it: a set's items fill its chunks in
    order, per_cta a chunk.  Also the chunks a set takes."""
    counts = torch.bincount(sets)
    per_set = -(-counts // per_cta)
    first_item = torch.cumsum(counts, 0) - counts
    first_chunk = torch.cumsum(per_set, 0) - per_set
    pos = torch.arange(len(sets)) - first_item[sets]
    return first_chunk[sets] + pos // per_cta, pos % per_cta, per_set


def gram_table(plan: GramPlan, p: int) -> torch.Tensor:
    """What the kernels read of the plan (int32, on the CPU): per chunk its
    windows (a0, na, b0, nb), then per chunk ``per_cta`` items (I, J),
    (-1, -1) where a chunk has fewer."""
    items, sets, win = _item_sets(p, plan.si, plan.sj, plan.panel)
    chunk, slot, per_set = _chunk_of(sets, plan.per_cta)
    assert int(per_set.sum()) == plan.chunks
    table = torch.full((plan.chunks, plan.per_cta, 2), -1, dtype=torch.long)
    table[chunk, slot] = items
    wins = torch.repeat_interleave(win, per_set, dim=0)
    return torch.cat([wins.flatten(), table.flatten()]).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _device_table(plan: GramPlan, p: int, device: torch.device
                  ) -> torch.Tensor:
    return gram_table(plan, p).to(device)


def gram_layout(p: int, si: int, sj: int, ring: int, srows: int,
                panel: int) -> Tuple[int, ...]:
    """(pr, ws, xs, blk, wa, seg, pad_at, bar_at) of ``GramPlan``: the ring
    of slots of pieces of pr = min(srows, 16) rows (whole rows: pr P + 8
    floats of X from the aligned chunk before them; panels: each row's A
    window, then its B window, seg floats each), w and y after them
    (pr + 8 floats each); then two padded buffers of srows rows of w x and
    x, rows 16-byte aligned and holding whole sub-tiles; then the ring's
    mbarriers (``BAR_FLOATS``)."""
    pr = min(srows, GROUP_ROWS)
    a, b = (panel, panel) if panel else (p + 1, p)
    ws, xs = _up(a, max(4, si)), _up(b, max(4, sj))
    seg = _up(panel, 4) + 8 if panel else 0
    wa = 2 * pr * seg if panel else pr * p + 8
    blk = wa + 2 * pr + 16
    pad_at = ring * (srows // pr) * blk
    return pr, ws, xs, blk, wa, seg, pad_at, pad_at + 2 * srows * (ws + xs)


def make_gram_plan(b: int, n: int, p: int, si: int, sj: int, split: int,
                   srows: int, ring: Optional[int] = None, panel: int = 0
                   ) -> Optional[GramPlan]:
    """The plan with these choices, or None where it does not fit a block:
    the largest set of items (``_item_sets``) split over ``split`` blocks.
    ``ring`` None: as deep as the shared memory the SM's blocks leave it
    allows (all of it when the launch has no more blocks than the card has
    SMs)."""
    if panel and ((si, sj) != PANEL_TILE or panel >= p):
        return None
    _, sets, _ = _item_sets(p, si, sj, panel)
    per_cta = -(-int(torch.bincount(sets).max()) // split)
    if per_cta > MAX_CONSUMERS:
        return None
    chunks = int(_chunk_of(sets, per_cta)[2].sum())
    one_an_sm = GROUPS * chunks * b <= SM_COUNT
    n_slots = -(-(-(-n // STEP) * GROUP_ROWS) // srows)
    if ring is None:
        budget = SMEM_MAX if one_an_sm else SMEM_TWO
        empty = gram_layout(p, si, sj, 0, srows, panel)[-1]
        slot = gram_layout(p, si, sj, 1, srows, panel)[-1] - empty
        fit = (budget // 4 - BAR_FLOATS - empty) // slot
        ring = max(2, min(MAX_RING, n_slots, fit))
    lay = gram_layout(p, si, sj, ring, srows, panel)
    smem = 4 * (lay[-1] + BAR_FLOATS)
    if smem > SMEM_MAX or not 2 <= ring <= MAX_RING:
        return None
    if one_an_sm:
        # one block an SM: ask for more than half of its shared memory, so
        # that no SM takes two blocks while another has none
        smem = max(smem, SMEM_TWO + 4096)
    return GramPlan(si, sj, panel, chunks, per_cta, ring, srows, *lay,
                    (GROUPS * chunks, b), smem)


def _slot_rows(p: int, si: int, sj: int, panel: int) -> int:
    """The largest slot of SLOT_ROWS rows within SLOT_BYTES, at most 64
    rows (4 at least); with panels one piece of 16 rows (17 KB)."""
    if panel:
        return GROUP_ROWS
    fits = [r for r in SLOT_ROWS if r <= 64 and 4 * (
        gram_layout(p, si, sj, 1, r, panel)[-2]
        - gram_layout(p, si, sj, 0, r, panel)[-2]) <= SLOT_BYTES]
    return fits[-1] if fits else SLOT_ROWS[0]


def _with_slots(b, n, p, si, sj, split, panel, srows=None):
    """make_gram_plan at the largest slot that fits, halving it until a
    plan fits (None if none does)."""
    srows = srows or _slot_rows(p, si, sj, panel)
    while True:
        plan = make_gram_plan(b, n, p, si, sj, split, srows, panel=panel)
        if plan is not None or srows == SLOT_ROWS[0]:
            return plan
        srows = SLOT_ROWS[SLOT_ROWS.index(srows) - 1]


@functools.lru_cache(maxsize=256)
def gram_launch_plan(b: int, n: int, p: int) -> GramPlan:
    """The plan ``batched_gram_cuda`` launches for (B, N, P).  A block's
    time is its rows times what one consumer warp issues a row, whatever
    its number of items, so the items of a row group are split over as
    many blocks as one wave of the card holds at one block an SM (``fill``
    chunks: 1 at 24 or 32 tasks, 4 at 8; more blocks than SMs measured
    slower, PERF.md), and never more than MAX_CONSUMERS a block.  At P <= 48 one
    block holds a row group's 4 x 4 items (53 at the paper's P 33, two
    warps, the producers on the other two schedulers), or, split in
    chunks, 4 x 2 items (a warp of 25); wider rows take 8 x 8 items, 64
    FMAs a row for 4 loads.  A ring slot holds about SLOT_BYTES of rows (64
    rows at P 33, 16 at P 257), the ring as many slots as the blocks an SM
    holds leave room for.  Where whole rows do not fit a block (P above
    about 2400), each chunk reads a pair of PANEL-column panels.  Measured
    on the card (PERF.md, ``scripts/bench_gram.py``)."""
    fill = max(1, SM_COUNT // (GROUPS * b))
    if p <= 48:
        si, sj = (4, 4) if fill == 1 else (4, 2)
    else:
        si, sj = 8, 8
    items = len(gram_items(p, si, sj))
    split = max(-(-items // MAX_CONSUMERS), min(fill, max(1, items // 16)))
    plan = _with_slots(b, n, p, si, sj, split, 0)
    return plan or _with_slots(b, n, p, *PANEL_TILE, 1, PANEL)


def gram_plans(b: int, n: int, p: int) -> List[GramPlan]:
    """Every plan of a small family around the chosen one, for timing and
    for the check that plans agree bit for bit: each (SI, SJ) instance in
    the fewest blocks and (whole rows) in as many as the chosen plan and as
    give at least 128 blocks, slots of 16 and of the chosen rows, the
    deepest ring that fits and a ring of 2, whole rows and (where P >
    PANEL) column panels."""
    chosen = gram_launch_plan(b, n, p)
    out = [chosen]
    for panel in (0, PANEL):
        for si, sj in (TILES if not panel else (PANEL_TILE,)):
            _, sets, _ = _item_sets(p, si, sj, panel)
            least = -(-int(torch.bincount(sets).max()) // MAX_CONSUMERS)
            splits = {least}
            if not panel and not chosen.panel:
                splits |= {max(least, chosen.chunks),
                           max(least, -(-128 // (GROUPS * b)))}
            for split in sorted(splits):
                for srows in sorted({GROUP_ROWS,
                                     _slot_rows(p, si, sj, panel)}):
                    for ring in (None, 2):
                        plan = make_gram_plan(b, n, p, si, sj, split, srows,
                                              ring, panel)
                        if plan is not None and plan not in out:
                            out.append(plan)
    return out


def gram_block_chains(plan: GramPlan, p: int, grp: int, chunk: int,
                      task: int, table: Optional[torch.Tensor] = None):
    """(task, i, j, group) of every element chain the block (4 chunk + grp,
    task) of ``batched_gram_kernel`` computes, and (task, i, j) of every
    element the block (chunk, task) of ``batched_gram_combine_kernel``
    stores (G[i][j] for i <= j < P, b[j] as (P, j)): what the kernels read
    of ``gram_table`` and their element filter, so the tests can check
    that a plan covers each chain once and stores each element once.
    Returns (chains, stores)."""
    table = gram_table(plan, p) if table is None else table
    items = table[4 * plan.chunks:].view(plan.chunks, plan.per_cta, 2)
    chains, stores = [], []
    for it, jt in items[chunk].tolist():
        if it < 0:
            continue
        for e in range(plan.si * plan.sj):
            i = plan.si * it + e // plan.sj
            j = plan.sj * jt + e % plan.sj
            if j < p and (i < p and i <= j or i == p):
                chains.append((task, i, j, grp))
                if grp == 0:                   # the combine's (chunk, task)
                    stores.append((task, i, j))
    return chains, stores


def merged_rows(xc, w, y):
    """The (B, C*Nc, P) rows of a contiguous (B, C, Nc, P) chunked batch,
    and its w and y: views of the same storage, no copy."""
    b, c, nc, p = xc.shape
    return (xc.view(b, c * nc, p), w.view(b, c * nc), y.view(b, c * nc))


def batched_gram_cuda(xs, w, y, plan: Optional[GramPlan] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Gram kernel on CUDA tensors (contiguous float32), under
    ``plan`` (default: ``gram_launch_plan``)."""
    b, n, p = _check_launchable(xs)
    check_operand("w", w, (b, n), xs)
    check_operand("y", y, (b, n), xs)
    return _launch_gram(xs, w, y, plan, "batched_gram")


def batched_gram_blocked_cuda(xc, w, y, plan: Optional[GramPlan] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Gram kernel on the merged rows of CUDA tensors
    (contiguous float32): xc (B, C, Nc, P), w and y (B, C, Nc)."""
    b, c, nc, p = check_xc(xc)
    _check_on_card_within_limits("xc", xc, b, c * nc, p)
    check_operand("w", w, (b, c, nc), xc)
    check_operand("y", y, (b, c, nc), xc)
    return _launch_gram(*merged_rows(xc, w, y), plan,
                        "batched_gram_blocked")


def _launch_gram(xs, w, y, plan: Optional[GramPlan], name: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, n, p = xs.shape
    plan = plan or gram_launch_plan(b, n, p)
    lib = build.load_library("megabatch")
    layout = (ctypes.c_int * len(plan.layout()))(*plan.layout())
    with torch.cuda.device(xs.device):
        table = _device_table(plan, p, xs.device)
        g = torch.empty((b, p, p), dtype=F32, device=xs.device)
        bv = torch.empty((b, p), dtype=F32, device=xs.device)
        part = torch.empty(plan.scratch_floats(b), dtype=F32,
                           device=xs.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts[name] += 1
        code = lib.repro_batched_gram(
            xs.data_ptr(), w.data_ptr(), y.data_ptr(), g.data_ptr(),
            bv.data_ptr(), part.data_ptr(), table.data_ptr(), b, n, p,
            plan.si, plan.sj, plan.chunks, plan.smem_bytes,
            ctypes.addressof(layout), stream)
    build.check_launch(lib, code, name)
    return g, bv


def batched_predict_cuda(xs, beta, valid) -> torch.Tensor:
    """Launch the predict kernel on CUDA tensors (contiguous float32)."""
    b, n, p = _check_launchable(xs)
    if p > _MAX_PREDICT_P:
        raise ValueError(f"batched_predict: P={p} exceeds the kernel's "
                         f"shared-memory limit of {_MAX_PREDICT_P} columns")
    check_operand("beta", beta, (b, p), xs)
    check_operand("valid", valid, (b, n), xs)
    lib = build.load_library("megabatch")
    with torch.cuda.device(xs.device):
        out = torch.empty((b, n), dtype=F32, device=xs.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["batched_predict"] += 1
        code = lib.repro_batched_predict(xs.data_ptr(), beta.data_ptr(),
                                         valid.data_ptr(), out.data_ptr(),
                                         b, n, p, stream)
    build.check_launch(lib, code, "batched_predict")
    return out

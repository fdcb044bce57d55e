"""The launch plan of the per-task Gram kernel (K1, and K3 on its merged
rows), checked on the CPU.

``kernels/megabatch.py::gram_table`` is what the kernels read of a plan
(``batched_gram_kernel`` and ``batched_gram_combine_kernel`` in
``csrc/megabatch.cu``): each chunk's items and the columns they read, and
``gram_block_chains`` applies the kernels' element filter to it: which
block of grid (4 row groups x chunks, B) computes which element chain, and
which block of the combine writes it.  These tests hold every plan to the
kernel's contract: each (task, element i <= j, row group) chain once, each
element written once, every item's reads inside its chunk's windows, and
blocks that fit an H100 and fill it at the path shapes.  The kernel itself
runs only on the card (``chip_smoke.py`` compares two plans bit for bit at
every shape, and column panels with whole rows).
"""
from collections import Counter

import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.kernels import megabatch as mb

# (B, N, P) of every K1 launch on the paths chip_smoke.py drives, K3's
# merged rows on the tall path, and the ragged shapes it compares
PATH_SHAPES = [(32, 5104, 33), (8, 5104, 33), (32, 5000, 33), (8, 5000, 33),
               (24, 5000, 33), (32, 60000, 257), (8, 60000, 257),
               (24, 60000, 257), (32, 250000, 33), (8, 250000, 33),
               (32, 250016, 33), (8, 250016, 33)]
FILL = 128                      # at least this many of the card's 132 SMs
FILL_SHAPES = [(32, 5104, 33), (8, 5104, 33), (32, 250016, 33),
               (8, 250016, 33)]
RAGGED = [(b, n, p) for b in (1, 5, 32) for n in (1, 63, 1003)
          for p in (1, 2, 7, 18, 34, 65, 129)]


def _wanted(p):
    """The chains of one task: G[i][j] for i <= j < P, b[j] as (P, j)."""
    return {(i, j) for i in range(p) for j in range(i, p)} \
        | {(p, j) for j in range(p)}


def _check_covers(plan, b, p, task):
    assert plan.grid == (mb.GROUPS * plan.chunks, b)
    table = mb.gram_table(plan, p)
    chains, stores = Counter(), Counter()
    for grp in range(mb.GROUPS):
        for chunk in range(plan.chunks):
            got, put = mb.gram_block_chains(plan, p, grp, chunk, task, table)
            for t, i, j, g in got:
                assert (t, g) == (task, grp)
                chains[i, j, g] += 1
            for t, i, j in put:
                assert t == task
                stores[i, j] += 1
    want = _wanted(p)
    assert set(chains.values()) == {1}
    assert set(chains) == {(i, j, g) for i, j in want
                           for g in range(mb.GROUPS)}
    assert set(stores) == want and set(stores.values()) == {1}


@pytest.mark.parametrize("b,n,p", PATH_SHAPES)
def test_gram_plan_covers_every_chain_once_at_the_path_shapes(b, n, p):
    """Every (element, row group) chain of a task is computed by exactly
    one thread of the grid, and every element is written by exactly one
    thread of the combine (the task is a grid axis of both, so the first
    and the last task stand for all)."""
    plan = mb.gram_launch_plan(b, n, p)
    for task in (0, b - 1):
        _check_covers(plan, b, p, task)


@pytest.mark.parametrize("b,n,p", RAGGED)
def test_every_gram_plan_covers_every_chain_once(b, n, p):
    plans = mb.gram_plans(b, n, p)
    assert plans and plans[0] == mb.gram_launch_plan(b, n, p)
    for plan in plans:
        _check_covers(plan, b, p, b - 1)


def _check_fits(plan, b, n, p):
    assert (plan.si, plan.sj) in mb.TILES
    assert plan.srows in mb.SLOT_ROWS and 2 <= plan.ring <= mb.MAX_RING
    assert 1 <= plan.per_cta <= plan.consumers <= mb.MAX_CONSUMERS
    assert plan.consumers % 32 == 0 and plan.consumers - plan.per_cta < 32
    # the table: every chunk has an item
    items = mb.gram_table(plan, p)[4 * plan.chunks:].view(
        plan.chunks, plan.per_cta, 2)
    assert bool((items[:, 0, 0] >= 0).all())
    # the layout is the one gram_layout gives, the buffers in order and
    # inside the block's shared memory, every piece and row 16-byte aligned
    assert plan.layout()[1:] == (plan.ring, plan.srows) + mb.gram_layout(
        p, plan.si, plan.sj, plan.ring, plan.srows, plan.panel)
    assert plan.ring * (plan.srows // plan.pr) * plan.blk <= plan.pad_at
    assert plan.pad_at + 2 * plan.srows * (plan.ws + plan.xs) <= plan.bar_at
    assert 4 * (plan.bar_at + mb.BAR_FLOATS) <= plan.smem_bytes <= mb.SMEM_MAX
    assert plan.wa + 2 * plan.pr + 16 <= plan.blk
    for v in (plan.ws, plan.xs, plan.blk, plan.wa, plan.seg, plan.pad_at,
              plan.bar_at):
        assert v % 4 == 0
    assert plan.ws % plan.si == 0 and plan.xs % plan.sj == 0
    # a whole-row piece holds its rows of X from the aligned chunk before
    # them; a panel row window holds PANEL columns from its chunk
    if plan.panel:
        assert plan.seg >= plan.panel + 6 and plan.wa >= 2 * plan.pr \
            * plan.seg
    else:
        assert plan.wa >= plan.pr * p + 6
    # a launch that fits the card in one wave takes one block an SM
    if mb.GROUPS * plan.chunks * b <= mb.SM_COUNT:
        assert 2 * plan.smem_bytes > mb.SMEM_MAX
    # grid x (row groups and chunks) and y (tasks) limits
    assert plan.grid == (mb.GROUPS * plan.chunks, b)
    assert plan.grid[0] < 2 ** 31 and b <= 65535
    # more blocks than SMs: two share an SM
    if mb.GROUPS * plan.chunks * b > mb.SM_COUNT and plan.ring > 2:
        assert plan.smem_bytes <= mb.SMEM_TWO
    # the ring is never deeper than the walk has slots (or 2)
    n_slots = -(-(-(-n // mb.STEP) * mb.GROUP_ROWS) // plan.srows)
    assert plan.ring <= max(2, n_slots)


@pytest.mark.parametrize("b,n,p", PATH_SHAPES + RAGGED)
def test_gram_plans_fit_the_card(b, n, p):
    for plan in mb.gram_plans(b, n, p):
        _check_fits(plan, b, n, p)


@pytest.mark.parametrize("b,n,p", PATH_SHAPES)
def test_gram_plan_fills_one_wave_at_the_path_shapes(b, n, p):
    """One block a row group: 4 B blocks, split in chunks of a task's
    items while the launch still fits the card at one block an SM; more
    chunks only where a block's items need them.  So a launch of at most
    132 blocks leaves fewer than 4 B SMs idle."""
    plan = mb.gram_launch_plan(b, n, p)
    blocks = plan.grid[0] * plan.grid[1]
    least = -(-len(mb.gram_items(p, plan.si, plan.sj)) // mb.MAX_CONSUMERS)
    if plan.chunks > least:
        assert blocks <= mb.SM_COUNT
    if blocks <= mb.SM_COUNT:
        assert 2 * plan.smem_bytes > mb.SMEM_MAX       # one block an SM
        # one more chunk: past one wave, or under 16 items a block
        assert blocks + mb.GROUPS * b > mb.SM_COUNT or \
            len(mb.gram_items(p, plan.si, plan.sj)) < 16 * (plan.chunks + 1)


@pytest.mark.parametrize("b,n,p", FILL_SHAPES)
def test_gram_plan_fills_the_card_at_the_paper_and_tall_shapes(b, n, p):
    """At the paper's and the tall path's shapes at least 128 of the 132
    SMs are busy from the launch's start, one block an SM.  (At 24 tasks
    the rule gives 96 blocks: two chunks, 192 blocks, measured slower.)"""
    plan = mb.gram_launch_plan(b, n, p)
    blocks = plan.grid[0] * plan.grid[1]
    assert FILL <= blocks <= mb.SM_COUNT


@pytest.mark.parametrize("b,n,p", PATH_SHAPES)
def test_chip_smoke_has_a_second_plan_at_every_path_shape(b, n, p):
    """chip_smoke.py holds two plans against each other bit for bit."""
    plans = mb.gram_plans(b, n, p)
    assert len(plans) >= 2 and plans[1] != plans[0]


def _subtiles_holding_a_chain(p, si, sj):
    return {(i // si, j // sj) for i, j in _wanted(p)}


@pytest.mark.parametrize("p", [1, 2, 7, 33, 257, 1000])
@pytest.mark.parametrize("si,sj", mb.TILES)
def test_gram_items_are_the_subtiles_that_hold_a_chain(p, si, sj):
    """The items are exactly the SI x SJ sub-tiles of the (P + 1) x P
    matrix that hold some element of G's upper triangle or of b: none
    missing, none that holds only padding, each once."""
    items = [tuple(t) for t in mb.gram_items(p, si, sj).tolist()]
    assert len(set(items)) == len(items)
    assert set(items) == _subtiles_holding_a_chain(p, si, sj)


def _check_windows(plan, p):
    """Every element an item of a chunk computes lies in the chunk's
    windows, and every column an item reads lies in the padded rows."""
    table = mb.gram_table(plan, p)
    win = table[:4 * plan.chunks].view(plan.chunks, 4).tolist()
    items = table[4 * plan.chunks:].view(plan.chunks, plan.per_cta, 2)
    for (a0, na, b0, nb), chunk in zip(win, items.tolist()):
        for it, jt in chunk:
            if it < 0:
                continue
            ai, bj = plan.si * it - a0, plan.sj * jt - b0
            assert 0 <= ai and ai + plan.si <= plan.ws
            assert 0 <= bj and bj + plan.sj <= plan.xs
            for e in range(plan.si * plan.sj):
                i, j = plan.si * it + e // plan.sj, plan.sj * jt + e % plan.sj
                if j < p and (i < p and i <= j or i == p):
                    assert a0 <= i < a0 + na and b0 <= j < b0 + nb
        if plan.panel:
            assert na <= plan.panel and nb <= plan.panel
        else:
            assert (a0, na, b0, nb) == (0, p + 1, 0, p)


@pytest.mark.parametrize("b,n,p", PATH_SHAPES + RAGGED)
def test_gram_plan_items_read_inside_their_windows(b, n, p):
    for plan in mb.gram_plans(b, n, p):
        _check_windows(plan, p)


def test_paper_items_execute_far_less_padding():
    """At P 33 the 4 x 2 items execute 776 FMAs a row for the 594 chains
    (561 of G, 33 of b), where 32 x 32 tiles executed 3072."""
    items = mb.gram_items(33, 4, 2)
    assert len(items) == 97 and 8 * len(items) == 776
    assert len(_wanted(33)) == 594


@pytest.mark.parametrize("b,n,p", [(1, 100, 2400), (2, 700, 2600),
                                   (1, 64, 5000), (3, 10, 20000)])
def test_wide_p_takes_column_panels_that_fit_a_block(b, n, p):
    """Whole rows fit a block up to about 2400 columns; past that the
    chunks read a pair of PANEL-column panels, and the block's buffers do
    not grow with P."""
    plan = mb.gram_launch_plan(b, n, p)
    assert plan.panel == (mb.PANEL if p > 2400 else 0)
    _check_fits(plan, b, n, p)
    if plan.panel:
        assert plan.ws == plan.xs == mb.PANEL
        assert plan.per_cta <= (mb.PANEL // 8) ** 2


@pytest.mark.parametrize("p", [129, 200, 300])
def test_panel_plans_cover_every_chain_once(p):
    """Column panels (forced below the width that needs them) cover every
    chain once, and read inside their windows; only the 8 x 8 instance
    takes them."""
    for si, sj in mb.TILES:
        plan = mb.make_gram_plan(2, 300, p, si, sj, 1, 16, panel=mb.PANEL)
        if (si, sj) != mb.PANEL_TILE:
            assert plan is None
            continue
        assert plan.panel == mb.PANEL and plan.per_cta <= 256
        _check_fits(plan, 2, 300, p)
        _check_covers(plan, 2, p, 1)
        _check_windows(plan, p)


def test_blocked_merged_rows_are_the_same_storage():
    """K3 launches K1's kernel on (B, C*Nc, P) views of its operands: no
    copy is made."""
    xc = torch.randn(3, 4, 10, 5)
    w, y = torch.rand(3, 4, 10), torch.randn(3, 4, 10)
    xm, wm, ym = mb.merged_rows(xc, w, y)
    assert tuple(xm.shape) == (3, 40, 5) and tuple(wm.shape) == (3, 40)
    for view, base in ((xm, xc), (wm, w), (ym, y)):
        assert view.data_ptr() == base.data_ptr()
        assert view.untyped_storage().data_ptr() == \
            base.untyped_storage().data_ptr()
    xm[1, 13, 2] = 7.0
    assert xc[1, 1, 3, 2] == 7.0

"""The shared-X slice: ``crossfit_gram`` (plain version on the CPU), the
shared-X learner forms, logistic in both forms, the opaque-learner drain
(``compile_raw_request`` + ``as_batched``) and the ``DoubleMLServerless``
shim, each against the JAX package on the same numpy inputs.

Tolerances, stated once:
- Gram: max |G - G_ref| within 2e-4 of max |G_ref| (the reference's own
  float tier for ``crossfit_gram``, tests/test_kernels.py).
- predictions of ridge, ols, lasso and the raw-request drain: rtol 1e-4,
  atol 1e-5; theta and se 1e-4 relative.
- logistic probabilities: atol 1e-6 (32 Newton steps, each an SPD solve
  with its own rounding; measured up to 1.8e-7 on these inputs).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.core as rcore
from repro.core.session import compile_raw_request as jax_compile_raw
from repro.data import make_irm_data, make_plr_data
from repro.kernels import ref
from repro.learners import get_batched_learner as jax_batched_learner
from repro.learners import get_learner as jax_learner
from repro.serverless import InlineBackend as JaxInline
from repro.serverless import PoolConfig as JaxPool

import repro_torch
import repro_torch.core as tcore
from repro_torch import compat, runtime
from repro_torch.compile import plan_buckets
from repro_torch.core.crossfit import TaskGrid, draw_fold_masks
from repro_torch.core.session import compile_raw_request, compile_request
from repro_torch.kernels import ops
from repro_torch.kernels import crossfit_gram as xfit
from repro_torch.kernels.crossfit_gram import crossfit_gram_plain
from repro_torch.learners import (
    LEARNERS, as_batched, get_batched_learner, get_learner,
)
from repro_torch.learners import linear
from repro_torch.serverless import InlineBackend, PoolConfig, TaskLedger

GRAM_TOL = 2e-4


def _gram_inputs(t, n, p, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = (rng.random((t, n)) > 0.4).astype(np.float32)
    y = rng.normal(size=(t, n)).astype(np.float32)
    return x, w, y


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _rel_max(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    return float(np.abs(got - want).max()) / scale


# ---------------------------------------------------------------------------
# K4's plain version and its ops wrapper
# ---------------------------------------------------------------------------
# the reference's sweep (n, p, t), then ragged T, N and P
GRAM_SHAPES = [(256, 8, 8), (512, 16, 16), (1024, 24, 8), (128, 4, 8),
               (1003, 7, 5), (97, 33, 3), (65, 1, 1), (200, 18, 13)]


@pytest.mark.parametrize("n,p,t", GRAM_SHAPES)
@pytest.mark.parametrize("reg", [0.0, 0.7])
def test_crossfit_gram_matches_reference(n, p, t, reg):
    x, w, y = _gram_inputs(t, n, p, seed=n + p + t)
    g0, b0 = ref.crossfit_gram_ref(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(y), reg)
    g0, b0 = np.asarray(g0), np.asarray(b0)
    g, b = ops.crossfit_gram(*_t(x, w, y), reg=reg)
    assert g.shape == (t, p, p) and b.shape == (t, p)
    assert g.dtype == b.dtype == torch.float32
    assert _rel_max(g.numpy(), g0) < GRAM_TOL
    assert _rel_max(b.numpy(), b0) < GRAM_TOL
    if not reg:
        gp, bp = crossfit_gram_plain(*_t(x, w, y))
        assert torch.equal(gp, g) and torch.equal(bp, b)


@pytest.mark.parametrize("seed", [0, 17, 256, 511, 999])
def test_crossfit_gram_mask_of_ones_equals_plain_gram(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(128, 6)).astype(np.float32)
    w = np.ones((8, 128), np.float32)
    y = rng.normal(size=(8, 128)).astype(np.float32)
    g, _ = ops.crossfit_gram(*_t(x, w, y))
    for t in range(8):
        np.testing.assert_allclose(g[t].numpy(), x.T @ x, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("seed", [1, 42, 300, 777, 1000])
def test_crossfit_gram_additivity_over_disjoint_masks(seed):
    """G(w1) + G(w2) == G(w1 + w2) for disjoint masks — the fold-partition
    structure the paper's grid relies on."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(128, 5)).astype(np.float32)
    m = rng.random(128) > 0.5
    ones = np.ones_like(m)
    w = np.stack([m, ~m, ones, m, ~m, ones, m, ~m]).astype(np.float32)
    y = np.ones((8, 128), np.float32)
    g, b = ops.crossfit_gram(*_t(x, w, y))
    np.testing.assert_allclose(g[0] + g[1], g[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b[0] + b[1], b[2], rtol=1e-4, atol=1e-4)


def test_crossfit_gram_refuses_what_the_kernel_does_not_take():
    x, w, y = _t(*_gram_inputs(3, 40, 4, seed=1))
    with pytest.raises(TypeError):
        ops.crossfit_gram(x.double(), w, y)
    with pytest.raises(ValueError):
        ops.crossfit_gram(x, w[:, :-1], y)
    with pytest.raises(ValueError):
        ops.crossfit_gram(x.t(), w, y)                  # not contiguous
    with pytest.raises(ValueError):
        ops.crossfit_gram(x[None], w, y)                # not (N, P)


def test_cpu_tensors_never_launch_crossfit_gram():
    runtime.reset_launch_counts()
    x, w, y = _t(*_gram_inputs(4, 64, 5, seed=2))
    ops.crossfit_gram(x, w, y)
    get_learner("ridge")(x, y, w, None)
    assert runtime.launch_counts["crossfit_gram"] == 0


# ---------------------------------------------------------------------------
# K4's launch plan (kernels/crossfit_gram.py): the kernel's index
# arithmetic, mirrored by block_items, checked on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [7, 18, 33, 201])
@pytest.mark.parametrize("t", [1, 5, 32, 1000, 1001])
def test_crossfit_launch_plan_covers_every_chain_once(t, p):
    """Every (task, tile pair, useful sub-tile) is owned by exactly one
    thread slot of one block of the plan's grid, and the sub-tiles cover
    each task's upper triangle of G, diagonal included, exactly once."""
    plan = xfit.launch_plan(t, 5099, p)
    owned = [item for bx in range(plan.grid[0]) for by in range(plan.grid[1])
             for item in xfit.block_items(plan, t, p, bx, by)]
    assert len(owned) == len(set(owned))
    want = {(task, ti, tj, sy, sx)
            for ti, tj in xfit.tile_pairs(p)
            for sy, sx in _useful_subtiles(ti, tj, p, plan.sub)
            for task in range(t)}
    assert set(owned) == want
    # the sub-tiles of one task tile the upper triangle exactly once
    cover = np.zeros((p, p), np.int64)
    for task, ti, tj, sy, sx in owned:
        if task:
            continue
        r0, c0 = ti * 32 + plan.sub * sy, tj * 32 + plan.sub * sx
        for i in range(r0, min(r0 + plan.sub, p)):
            for j in range(c0, min(c0 + plan.sub, p)):
                if i <= j:
                    cover[i, j] += 1
    assert (cover[np.triu_indices(p)] == 1).all()


def _useful_subtiles(ti, tj, p, sub):
    _, sy_n, sx_n = xfit.subtiles(ti, tj, p, sub)
    return [(sy, sx) for sy in range(sy_n) for sx in range(sx_n)
            if ti != tj or sx >= sy]


@pytest.mark.parametrize("n", [1, 64, 1003, 5099, 65536])
@pytest.mark.parametrize("p", [7, 18, 33, 201])
@pytest.mark.parametrize("t", [1, 5, 32, 1000, 1001])
def test_crossfit_launch_plan_fits_the_card(t, n, p):
    """The plan is one of the kernel's instances, its blocks fit the
    card's limits, the accumulators a thread holds stay in the register
    budget of its launch bounds, and two blocks share an SM where the
    instance runs two."""
    plan = xfit.launch_plan(t, n, p)
    assert (plan.sub, plan.tt) in xfit.CONFIGS
    assert plan.slots in xfit.SLOTS and plan.m in xfit.STEPS
    assert plan.threads <= xfit.MAX_THREADS
    assert plan.tt * plan.sub ** 2 <= xfit.MAX_ACC
    assert 2 <= plan.ring <= xfit.MAX_RING
    assert plan.smem_bytes <= xfit.SMEM_MAX
    assert plan.smem_bytes == 4 * plan.ring * xfit.stage_floats(
        p, plan.tasks, plan.m)
    # the ring holds the partial tiles of three row groups at the end
    assert plan.smem_bytes >= 4 * 3 * plan.slots * (plan.sub ** 2
                                                     + plan.sub)
    assert 1 <= plan.packs <= plan.slots and plan.chunks >= 1
    assert plan.grid[1] == len(list(xfit.tile_pairs(p))) <= 65535
    if plan.tt * plan.sub ** 2 < 32:        # two blocks an SM
        # blocks with items (a chunk past its pair's items exits at once)
        blocks = -(-t // plan.tasks) * sum(
            -(-xfit.subtiles(ti, tj, p, plan.sub)[0] // plan.per_block)
            for ti, tj in xfit.tile_pairs(p))
        assert blocks <= xfit.SM_COUNT \
            or 2 * (plan.smem_bytes + 1024) <= 233472


def test_crossfit_launch_plan_fills_the_card_at_every_t():
    """Small T takes small sub-tiles (more threads for one task), large T
    the 4 x 4 register tile; the paper's 1000 tasks give the card more
    than one block an SM's worth of blocks' threads to work with."""
    assert xfit.launch_plan(1, 5099, 18).sub == 2
    big = xfit.launch_plan(1000, 5099, 18)
    assert big.sub == 4
    assert big.grid[0] * big.grid[1] * big.threads >= xfit.SM_COUNT * 128


# ---------------------------------------------------------------------------
# the shared-X learners against the reference's
# ---------------------------------------------------------------------------
def _problem(n=200, p=6, t=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    beta = rng.normal(size=p).astype(np.float32)
    y = (x @ beta + 0.1 * rng.normal(size=n)).astype(np.float32)
    ys = np.tile(y, (t, 1))
    w = (rng.random((t, n)) > 0.3).astype(np.float32)
    return x, ys, w, beta


def _binary_problem(n=300, p=4, t=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    logits = 1.2 * x[:, 0] - 0.8 * x[:, 1] + 0.3
    y = (rng.random((t, n)) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    w = (rng.random((t, n)) > 0.3).astype(np.float32)
    return x, y, w


LEARNER_CASES = [
    ("ridge", {"reg": 1.0}), ("ridge", {"reg": 2.5, "intercept": False}),
    ("ridge", {"reg": 1.0, "classify": True}), ("ols", {}),
    ("lasso", {}), ("lasso", {"reg": 0.05, "n_iter": 50}),
    ("logistic", {}), ("logistic", {"reg": 1e-3, "n_iter": 16}),
]


@pytest.mark.parametrize("name,params", LEARNER_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(LEARNER_CASES)])
def test_shared_x_learner_matches_reference(name, params):
    if name == "logistic":
        x, ys, w = _binary_problem(seed=len(params))
    else:
        x, ys, w, _ = _problem(seed=len(params))
    want = np.asarray(jax_learner(name, params)(
        jnp.asarray(x), jnp.asarray(ys), jnp.asarray(w), jax.random.key(0)))
    got = get_learner(name, params)(*_t(x, ys, w), None)
    assert got.shape == want.shape == ys.shape and got.dtype == torch.float32
    if name == "logistic":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert ((got > 0) & (got < 1)).all()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_registry_has_the_ported_families_only():
    """Every family is ported: the shared-X registry is the reference's
    six, and a name outside it raises the registry's KeyError."""
    from repro.learners import LEARNERS as jax_learners
    assert set(LEARNERS) == set(jax_learners) == {
        "ols", "ridge", "lasso", "logistic", "kernel_ridge", "mlp"}
    with pytest.raises(KeyError, match="unknown learner"):
        get_learner("forest")
    with pytest.raises(KeyError, match="unknown learner"):
        get_batched_learner("forest")


def test_ridge_matches_numpy_closed_form():
    x, ys, w, _ = _problem()
    preds = get_learner("ridge", {"reg": 2.0})(*_t(x, ys, w), None).numpy()
    xa = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], axis=1)
    for t in range(ys.shape[0]):
        g = xa.T @ np.diag(w[t]) @ xa + 2.0 * np.eye(xa.shape[1])
        g[-1, -1] -= 2.0 - 1e-8                    # unpenalized intercept
        beta = np.linalg.solve(g, xa.T @ (w[t] * ys[t]))
        np.testing.assert_allclose(preds[t], xa @ beta, rtol=2e-3,
                                   atol=2e-3)


def test_masked_fit_equals_subset_fit():
    """Weighted fit with a 0/1 mask == fitting on the subset only."""
    x, ys, w, _ = _problem(t=1)
    preds = get_learner("ridge", {"reg": 1.0})(*_t(x, ys, w), None).numpy()
    keep = w[0] > 0
    xa = np.concatenate([x, np.ones((x.shape[0], 1), np.float32)], axis=1)
    xs = xa[keep]
    g = xs.T @ xs + np.eye(xa.shape[1])
    g[-1, -1] += -1.0 + 1e-8
    beta = np.linalg.solve(g, xs.T @ ys[0][keep])
    np.testing.assert_allclose(preds[0], xa @ beta, rtol=2e-3, atol=2e-3)


def test_lasso_sparsity_and_fit():
    x, ys, w, beta = _problem(n=300)
    p_big = get_learner("lasso", {"reg": 1e3})(*_t(x, ys, w), None)
    assert float(p_big[0].std()) < 0.2
    p_small = get_learner("lasso", {"reg": 1e-3})(*_t(x, ys, w), None)
    resid = p_small[0].numpy() - x @ beta
    assert np.sqrt(np.mean(resid ** 2)) < 0.25


def test_logistic_recovers_probabilities():
    rng = np.random.default_rng(1)
    n = 800
    x = rng.normal(size=(n, 3)).astype(np.float32)
    pz = 1 / (1 + np.exp(-(1.5 * x[:, 0] - x[:, 1])))
    y = (rng.random(n) < pz).astype(np.float32)
    p = get_learner("logistic", {"reg": 1e-3})(
        *_t(x, y[None], np.ones((1, n), np.float32)), None)[0].numpy()
    assert ((p > 0) & (p < 1)).all()
    assert np.corrcoef(p, pz)[0, 1] > 0.95


def test_shared_x_learners_raise_without_a_device():
    """Operands that are not tensors go to the card: on a machine without
    one, the shared-X learners and ``as_batched`` raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    x, ys, w, _ = _problem(t=2)
    for name in LEARNERS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_learner(name)(x, ys, w, None)
    fn = as_batched(get_learner("ridge"))
    xs = np.stack([x, x])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(xs, ys, w, np.ones_like(w), np.zeros((2, 2), np.int64))


# ---------------------------------------------------------------------------
# logistic, megabatch form
# ---------------------------------------------------------------------------
def test_logistic_batched_on_a_padded_bucket_matches_reference():
    """Two datasets in one padded bucket (N 90 -> 104, P 5 -> 8, lanes 6
    -> 8): probabilities within the logistic tier, padding rows exactly
    0."""
    rng = np.random.default_rng(7)
    b_pad, n_pad, p_pad = 8, 104, 8
    xs = np.zeros((b_pad, n_pad, p_pad), np.float32)
    y = np.zeros((b_pad, n_pad), np.float32)
    w = np.zeros((b_pad, n_pad), np.float32)
    valid = np.zeros((b_pad, n_pad), np.float32)
    for lane in range(6):
        n, p = (90, 5) if lane % 2 else (70, 3)
        x = rng.normal(size=(n, p)).astype(np.float32)
        xs[lane, :n, :p] = x
        y[lane, :n] = rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))
        w[lane, :n] = rng.random(n) > 0.25
        valid[lane, :n] = 1.0
    keys = np.zeros((b_pad, 2), np.int64)
    want = np.asarray(jax_batched_learner("logistic", {"reg": 1.0})(
        *(jnp.asarray(a) for a in (xs, y, w, valid)),
        jax.random.split(jax.random.key(0), b_pad)))
    got = get_batched_learner("logistic", {"reg": 1.0})(
        *_t(xs, y, w, valid), torch.from_numpy(keys)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[valid == 0] == 0.0).all()
    assert ((got[valid == 1] > 0) & (got[valid == 1] < 1)).all()


# ---------------------------------------------------------------------------
# the opaque-learner drain
# ---------------------------------------------------------------------------
def _raw_arrays(n=101, p=5, m=2, k=3, seed=0):
    data = make_plr_data(n_obs=n, dim_x=p, theta=0.5, seed=seed)
    masks = draw_fold_masks(n, k, m, seed)
    train_w = np.repeat((~masks).astype(np.float32)[:, :, None], 2, axis=2)
    targets = np.stack([data["y"], data["d"]])
    return TaskGrid(m, k, 2), data, targets, train_w


def test_opaque_callable_buckets_use_exact_shapes():
    grid, data, targets, train_w = _raw_arrays()
    req = compile_raw_request(grid, "n_rep", data["x"], targets, train_w,
                              get_learner("ridge", {"reg": 1.0}), 0)
    plan = plan_buckets([req])
    (key,) = plan.buckets
    assert (key.n_pad, key.p_pad) == data["x"].shape       # no padding
    assert key.learner == ("opaque", id(req.segments[0].learner_fn))
    assert req.segments[0].learner is None and req.work_key is None


@pytest.mark.parametrize("scaling", ["n_rep", "n_folds*n_rep"])
@pytest.mark.parametrize("m", [2, 7])
def test_raw_request_drain_matches_reference(scaling, m):
    """The opaque drain against the reference's (same callable family,
    same arrays), and against the registry path on the same request: the
    two paths of the port agree too.  At M 7 a block of 32 lanes and a
    tail of 10 in 16 lanes; padding lanes are never read."""
    grid, data, targets, train_w = _raw_arrays(m=m, k=3, seed=m)
    jreq = jax_compile_raw(grid, scaling, data["x"], targets, train_w,
                           jax_learner("ridge", {"reg": 1.0}),
                           jax.random.key(3))
    JaxInline().run_requests([jreq])
    want = jreq.gathered_preds()

    linear.reset_solve_status()
    runtime.reset_launch_counts()
    req = compile_raw_request(grid, scaling, data["x"], targets, train_w,
                              get_learner("ridge", {"reg": 1.0}), 3)
    backend = InlineBackend(device="cpu")
    backend.run_requests([req])
    got = req.gathered_preds()
    assert req.ledger.complete and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert linear.solve_failures("cpu") == 0
    assert runtime.launch_counts["crossfit_gram"] == 0
    assert req.report.bill.n_invocations == jreq.report.bill.n_invocations

    plan = tcore.DMLPlan.for_model(
        "plr", learner="ridge", learner_params={"reg": 1.0}, n_folds=3,
        n_rep=m, seed=m, scaling=scaling, backend="inline")
    reg_req = compile_request(plan, tcore.DMLData.from_dict(data))
    assert np.array_equal(reg_req.train_w, req.train_w)
    InlineBackend(device="cpu").run_requests([reg_req])
    np.testing.assert_allclose(got, reg_req.gathered_preds(), rtol=1e-4,
                               atol=1e-5)


def test_raw_request_padding_account_matches_reference():
    """Exact-shape opaque blocks are booked as the reference books them
    with fusion, coalescing and the page pool off."""
    grid, data, targets, train_w = _raw_arrays(m=7, seed=1)
    jb = JaxInline(JaxPool(fuse=False, coalesce=False, page_pool_bytes=0))
    jb.run_requests([jax_compile_raw(grid, "n_rep", data["x"], targets,
                                     train_w, jax_learner("ols"),
                                     jax.random.key(0))])
    tb = InlineBackend(PoolConfig(fuse=False, coalesce=False,
                                  page_pool_bytes=0), device="cpu")
    tb.run_requests([compile_raw_request(grid, "n_rep", data["x"], targets,
                                         train_w, get_learner("ols"), 0)])
    st, sj = tb.compiler.stats, jb.compiler.stats
    assert (st.launches, st.blocks, st.misses) == \
        (sj.launches, sj.blocks, sj.misses)
    for f in ("true_cells", "padded_cells", "tasks", "padded_tasks",
              "lane_cells", "lane_cells_pow2", "true_feats", "padded_feats"):
        assert getattr(st.padding, f) == getattr(sj.padding, f), f


def test_as_batched_is_one_call_per_lane():
    calls = []
    ridge = get_learner("ridge", {"reg": 1.0})

    def spy(x, y, w, key):
        calls.append((tuple(x.shape), tuple(y.shape), int(key[1])))
        return ridge(x, y, w, key)

    x, ys, w, _ = _problem(t=3)
    xs = np.stack([x] * 3)
    keys = np.array([[5, 0], [5, 1], [5, 2]], np.int64)
    got = as_batched(spy)(*_t(xs, ys, w, np.ones_like(w), keys))
    assert calls == [((200, 6), (1, 200), i) for i in range(3)]
    np.testing.assert_allclose(got, ridge(*_t(x, ys, w), None), rtol=1e-6,
                               atol=1e-6)


def test_reference_raw_ledger_resumes_in_the_port(tmp_path):
    """A ledger the reference's raw-request drain half filled loads
    through compat: the port runs only the missing invocations."""
    grid, data, targets, train_w = _raw_arrays(m=3, seed=4)
    jreq = jax_compile_raw(grid, "n_rep", data["x"], targets, train_w,
                           jax_learner("ridge", {"reg": 1.0}),
                           jax.random.key(0))
    JaxInline().run_requests([jreq])
    full = jreq.ledger
    half = type(full).create(full.n_invocations, full.n_obs,
                             full.tasks_per_invocation)
    half.record_successes([0, 2], full.preds[[0, 2]])
    path = str(tmp_path / "raw.msgpack")
    half.save(path)

    ledger = compat.ledger_from_reference(path)
    req = compile_raw_request(grid, "n_rep", data["x"], targets, train_w,
                              get_learner("ridge", {"reg": 1.0}), 0,
                              ledger=ledger)
    InlineBackend(device="cpu").run_requests([req])
    assert sorted(r.invocation for r in req.report.bill.records) == \
        [i for i in range(full.n_invocations) if i not in (0, 2)]
    assert np.array_equal(ledger.preds[[0, 2]], full.preds[[0, 2]])
    np.testing.assert_allclose(req.gathered_preds(), jreq.gathered_preds(),
                               rtol=1e-4, atol=1e-5)
    assert isinstance(ledger, TaskLedger) and ledger.complete


# ---------------------------------------------------------------------------
# estimates with a logistic propensity, and the deprecated shim
# ---------------------------------------------------------------------------
def _iivm_data(n=400, p=5, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    z = (rng.random(n) < 1 / (1 + np.exp(-x[:, 0]))).astype(float)
    d = (rng.random(n) < 0.2 + 0.6 * z).astype(float)
    y = 0.5 * d + x @ (0.5 ** np.arange(p)) + rng.normal(size=n)
    return {k: v.astype(np.float32) for k, v in
            {"x": x, "y": y, "d": d, "z": z}.items()}


@pytest.mark.parametrize("model", ["irm", "iivm"])
def test_default_plan_with_logistic_propensity_matches_reference(model):
    raw = make_irm_data(n_obs=400, dim_x=6, seed=2) if model == "irm" \
        else _iivm_data()
    kw = dict(learner="ridge", learner_params={"reg": 1.0}, n_folds=3,
              n_rep=3, seed=8, backend="inline")
    pt = tcore.DMLPlan.for_model(model, **kw)
    pj = rcore.DMLPlan.for_model(model, **kw)
    assert [ns.learner for ns in pt.nuisances] == \
        [ns.learner for ns in pj.nuisances]
    assert "logistic" in [ns.learner for ns in pt.nuisances]
    sj = rcore.DMLSession(backend="inline")
    rj = sj.estimate(pj, rcore.DMLData.from_dict(raw))
    st = tcore.DMLSession(backend="inline", device="cpu")
    rt = st.estimate(pt, tcore.DMLData.from_dict(raw))
    np.testing.assert_allclose(st.request(0).gathered_preds(),
                               sj.request(0).gathered_preds(), rtol=1e-4,
                               atol=1e-5)
    assert abs(rt.theta - rj.theta) < 1e-4 * abs(rj.theta)
    assert abs(rt.se - rj.se) < 1e-4 * rj.se
    assert st.last_run_info.buckets == sj.last_run_info.buckets == 2


def test_double_ml_serverless_shim_equals_estimate():
    raw = make_plr_data(n_obs=150, dim_x=4, seed=9)
    with pytest.warns(DeprecationWarning):
        est = tcore.DoubleMLServerless(
            "plr", n_folds=3, n_rep=2, learner="lasso",
            learner_params={"reg": 0.01}, seed=7, backend="inline",
            device="cpu")
    res = est.fit(raw)
    plan = tcore.DMLPlan.for_model("plr", learner="lasso",
                                   learner_params={"reg": 0.01}, n_folds=3,
                                   n_rep=2, seed=7, backend="inline")
    want = repro_torch.estimate(plan, raw, device="cpu")
    assert (res.theta, res.se) == (want.theta, want.se)
    assert est.grid.n_tasks == 3 * 2 * 2 and est.pool.scaling == "n_rep"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = rcore.DoubleMLServerless(
            "plr", n_folds=3, n_rep=2, learner="lasso",
            learner_params={"reg": 0.01}, seed=7, backend="inline").fit(raw)
    assert abs(res.theta - jres.theta) < 1e-4 * abs(jres.theta)
    assert abs(res.se - jres.se) < 1e-4 * jres.se


def test_double_ml_serverless_default_backend_is_not_ported():
    """The default backend (wave) is ported now: ``fit`` runs on it and
    lands the inline backend's estimate bit for bit."""
    raw = make_plr_data(n_obs=50, dim_x=3, seed=0)
    with pytest.warns(DeprecationWarning):
        est = tcore.DoubleMLServerless("plr", n_folds=2, n_rep=1,
                                       device="cpu")
    assert est.plan.backend == "wave"
    res = est.fit(raw)
    want = repro_torch.estimate(est.plan.replace(backend="inline"), raw,
                                device="cpu")
    assert (res.theta, res.se) == (want.theta, want.se)

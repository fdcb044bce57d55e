"""The port's linear learners (megabatch forms) against the JAX package's.

Same numpy inputs through ``repro.learners.linear`` (jnp oracles on the
CPU) and ``repro_torch.learners.linear`` (plain PyTorch versions on the
CPU), on unpadded buckets and on buckets padded in N and P as the
compiler pads them.  Tolerance on predictions: rtol 1e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learners import get_batched_learner as jax_batched
from repro.learners import linear as jax_linear
from repro_torch.learners import (
    BATCHED_LEARNERS, FEATURE_PAD_SAFE, get_batched_learner, resolve_params,
)
from repro_torch.learners import linear

FAMILIES = [
    ("ridge", {"reg": 1.0}),
    ("ridge", {"reg": 0.1, "intercept": False}),
    ("ols", {}),
    ("lasso", {"reg": 0.01}),
    ("lasso", {"reg": 0.05, "n_iter": 50}),
]


def _bucket(seed, b=6, n=100, p=5):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, n, p)).astype(np.float32)
    y = (xs @ rng.normal(size=p) + rng.normal(size=(b, n))).astype(np.float32)
    w = (rng.random((b, n)) > 0.3).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    return xs, y, w, valid


def _pad(a, n_extra, p_extra=0):
    if a.ndim == 3:
        return np.pad(a, ((0, 0), (0, n_extra), (0, p_extra)))
    return np.pad(a, ((0, 0), (0, n_extra)))


def _jax_keys(b):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.arange(b))


def _run_both(name, params, xs, y, w, valid):
    want = np.asarray(jax_batched(name, params)(
        jnp.asarray(xs), jnp.asarray(y), jnp.asarray(w), jnp.asarray(valid),
        _jax_keys(xs.shape[0])))
    keys = torch.zeros((xs.shape[0], 2), dtype=torch.int64)
    got = get_batched_learner(name, params)(
        torch.from_numpy(xs), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(valid), keys)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("name,params", FAMILIES)
def test_unpadded_bucket_matches_reference(name, params):
    got, want = _run_both(name, params, *_bucket(seed=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,params", FAMILIES)
def test_padded_bucket_matches_reference(name, params):
    """N padded by 28 rows (w = 0, valid = 0) and P by 3 zero columns — for
    ols that leaves three rows of G holding only the 1e-8 ridge on the
    diagonal."""
    xs, y, w, valid = _bucket(seed=1)
    padded = (_pad(xs, 28, 3), _pad(y, 28), _pad(w, 28), _pad(valid, 28))
    got, want = _run_both(name, params, *padded)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.isfinite(got).all()
    assert float(np.abs(got[:, 100:]).max()) == 0.0    # masked tail exact 0
    # and the port's own contract: padding never moves a fit
    unpadded, _ = _run_both(name, params, xs, y, w, valid)
    np.testing.assert_allclose(got[:, :100], unpadded, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p_true,p_pad", [(17, 32), (5, 8)])
def test_ols_on_wide_feature_padding(p_true, p_pad):
    """ols is ridge with reg 1e-8: a bucket that pads P leaves rows of G
    whose only entry is 1e-8 on the diagonal.  The factorisation must
    still succeed and agree with the reference."""
    rng = np.random.default_rng(4)
    b, n = 8, 240
    xs = (rng.random((b, n, p_true)) < 0.4).astype(np.float32)
    y = (2.0 + xs @ rng.normal(0, 0.15, p_true)
         + rng.gumbel(0, 0.55, (b, n))).astype(np.float32)
    w = (rng.random((b, n)) > 0.2).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    xs_p = _pad(xs, 0, p_pad - p_true)
    linear.reset_solve_status()
    got, want = _run_both("ols", {}, xs_p, y, w, valid)
    assert linear.solve_failures("cpu") == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_all_padding_lane_agrees_and_is_never_counted():
    """A launch's padding lanes carry w = 0 and valid = 0 everywhere.
    With an intercept and reg = 1 their G has, in float32, an exact 0 on
    the diagonal after the intercept fix-up, so the lane's solve fails on
    both sides (NaN, never read back); a penalty-free or l1 fit leaves
    exact zeros.  Live lanes are untouched either way, and the port's
    Cholesky status ignores lanes without a valid row."""
    xs, y, w, valid = _bucket(seed=2, b=4)
    w[3] = 0.0
    valid[3] = 0.0
    linear.reset_solve_status()
    for name, params in FAMILIES:
        got, want = _run_both(name, params, xs, y, w, valid)
        assert np.isfinite(got[:3]).all(), name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        if name != "ridge" or not params.get("intercept", True):
            assert (got[3] == 0).all(), name
    assert linear.solve_failures("cpu") == 0


def test_solve_status_follows_valid_rows_not_lane_position():
    """A padding lane may lie anywhere in the batch, and a live lane's
    valid rows need not start at row 0: the status ignores exactly the
    lanes without any valid row."""
    xs, y, w, valid = _bucket(seed=5, b=4)
    w[1] = 0.0
    valid[1] = 0.0                       # interior padding lane
    w[2, :3] = 0.0
    valid[2, :3] = 0.0                   # live lane, first rows invalid
    linear.reset_solve_status()
    got, want = _run_both("ridge", {"reg": 1.0}, xs, y, w, valid)
    assert np.isfinite(got[[0, 2, 3]]).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert linear.solve_failures("cpu") == 0
    # a live lane that fails is counted even though its first row is
    # invalid: no training row at all leaves the intercept's pivot at 0
    w[2] = 0.0
    _run_both("ridge", {"reg": 1.0}, xs, y, w, valid)
    assert linear.solve_failures("cpu") > 0
    linear.reset_solve_status()


def test_failed_factorisation_gives_nan_and_is_recorded():
    """The reference's Cholesky returns NaN on failure and never raises;
    so does the port's, and it records the status on the device."""
    g = torch.eye(3).repeat(2, 1, 1)
    g[1, 1, 1] = -1.0
    b = torch.ones(2, 3)
    linear.reset_solve_status()
    beta = linear._solve_spd(g, b)
    assert torch.isfinite(beta[0]).all() and torch.isnan(beta[1]).all()
    assert linear.solve_failures("cpu") > 0
    want = jax_linear._solve_spd(jnp.asarray(g.numpy()), jnp.asarray(b.numpy()))
    assert np.isnan(np.asarray(want)[1]).all()
    linear.reset_solve_status()
    assert linear.solve_failures("cpu") == 0


@pytest.mark.parametrize("intercept", [True, False])
def test_fista_moments_match_reference(intercept):
    rng = np.random.default_rng(3)
    t, n, p = 5, 80, 6
    x = rng.normal(size=(t, n, p)).astype(np.float32)
    g = np.einsum("tnp,tnq->tpq", x, x).astype(np.float32)
    b = rng.normal(size=(t, p)).astype(np.float32) * n
    nw = np.full((t,), float(n), np.float32)
    want = jax_linear._fista_beta_moments(
        jnp.asarray(g), jnp.asarray(b), jnp.asarray(nw), reg=0.02,
        intercept=intercept, n_iter=120)
    got = linear._fista_beta_moments(
        torch.from_numpy(g), torch.from_numpy(b), torch.from_numpy(nw),
        reg=0.02, intercept=intercept, n_iter=120)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_augment_adds_the_intercept_column():
    xs = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    xa = linear._augment_b(xs)
    assert tuple(xa.shape) == (2, 3, 5) and xa.is_contiguous()
    assert torch.equal(xa[..., :4], xs) and (xa[..., 4] == 1).all()


def test_registry_holds_the_linear_families():
    """All six families of the reference, both forms."""
    from repro.learners import BATCHED_LEARNERS as jax_batched_table
    from repro.learners import FEATURE_PAD_SAFE as jax_safe
    from repro.learners import LEARNERS as jax_table
    from repro_torch.learners import LEARNERS
    assert set(BATCHED_LEARNERS) == set(jax_batched_table) == {
        "ols", "ridge", "lasso", "logistic", "kernel_ridge", "mlp"}
    assert set(LEARNERS) == set(jax_table) == set(BATCHED_LEARNERS)
    assert FEATURE_PAD_SAFE == jax_safe
    with pytest.raises(KeyError):
        get_batched_learner("nope")
    # mlp takes classify=True (the propensity's sigmoid)
    assert get_batched_learner("mlp", {"classify": True}).keywords == \
        {"classify": True}
    # classify=True is accepted and ignored by the linear families
    fn = get_batched_learner("ridge", {"reg": 2.0, "classify": True})
    assert fn.keywords == {"reg": 2.0}


@pytest.mark.parametrize("name,params", [
    ("ridge", {"reg": 1.0}), ("kernel_ridge", {}),
    ("kernel_ridge", {"gamma": 0.3, "n_landmarks": 500}), ("lasso", None),
])
def test_resolve_params_matches_reference(name, params):
    from repro.learners import resolve_params as jax_resolve
    assert resolve_params(name, params, n_obs=200, dim_x=7) == \
        jax_resolve(name, params, n_obs=200, dim_x=7)

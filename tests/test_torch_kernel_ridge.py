"""The port's Nyström kernel ridge against the JAX package's.

Same numpy inputs and the same task keys (JAX's Threefry words) through
``repro.learners.kernel_ridge`` (jnp on the CPU) and
``repro_torch.learners.kernel_ridge`` (plain PyTorch on the CPU): the
landmark indices exactly, the features and predictions at the float tier
(rtol 1e-4, atol 1e-5), both forms, padded as the compiler pads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.learners import get_batched_learner as jax_batched
from repro.learners import get_learner as jax_shared
from repro.data import make_bonus_data
from repro.learners import kernel_ridge as jax_kr
from repro_torch import runtime, threefry
from repro_torch.learners import get_batched_learner, get_learner
from repro_torch.learners import kernel_ridge

TIER = dict(rtol=1e-4, atol=1e-5)


def _keys(b, seed=7):
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(b))
    return jk, torch.from_numpy(
        np.asarray(jax.random.key_data(jk)).astype(np.int64))


def _bucket(seed, b=4, n=200, p=5):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, n, p)).astype(np.float32)
    y = (np.sin(xs[..., 0]) + xs[..., 1] ** 2
         + 0.3 * rng.normal(size=(b, n))).astype(np.float32)
    w = (rng.random((b, n)) > 0.3).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    return xs, y, w, valid


def _pad(a, n_extra, p_extra=0):
    if a.ndim == 3:
        return np.pad(a, ((0, 0), (0, n_extra), (0, p_extra)))
    return np.pad(a, ((0, 0), (0, n_extra)))


def _run_both(params, xs, y, w, valid, seed=7):
    jk, tk = _keys(xs.shape[0], seed)
    want = np.asarray(jax_batched("kernel_ridge", params)(
        jnp.asarray(xs), jnp.asarray(y), jnp.asarray(w), jnp.asarray(valid),
        jk))
    got = get_batched_learner("kernel_ridge", params)(
        *(torch.from_numpy(a) for a in (xs, y, w, valid)), tk)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("n,p,m", [(200, 5, 32), (300, 17, 64),
                                   (300, 17, 128)])
def test_features_match_reference(n, p, m):
    xs, _, _, valid = _bucket(0, b=3, n=n, p=p)
    valid[:, -4:] = 0.0
    xs[:, -4:] = 0.0
    jk, tk = _keys(3)
    gamma = 1.0 / p
    want = np.asarray(jax.vmap(lambda x1, v1, k1: jax_kr.nystrom_features(
        x1, k1, n_landmarks=m, gamma=gamma, valid=v1))(
            jnp.asarray(xs), jnp.asarray(valid), jk))
    got = kernel_ridge.nystrom_features(
        torch.from_numpy(xs), tk, n_landmarks=m, gamma=gamma,
        valid=torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape == (3, n, min(m, n))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("params", [
    {"reg": 1.0, "n_landmarks": 32, "gamma": 0.2},
    {"reg": 1.0, "n_landmarks": 64},
    {"reg": 0.1, "n_landmarks": 32, "gamma": 1.0 / 5},
])
def test_batched_matches_reference(params):
    got, want = _run_both(params, *_bucket(seed=1))
    np.testing.assert_allclose(got, want, **TIER)
    assert np.isfinite(got).all()


def _float64_fit(xs, y, w, keys, m, reg, gamma=None):
    """The batched fit in float64 on the port's landmarks (the same as the
    reference's): what both float32 forms approximate."""
    b, n, p = xs.shape
    gamma = 1.0 / p if gamma is None else gamma
    idx = kernel_ridge.landmark_idx(keys, n, m)
    x64 = torch.from_numpy(xs).double()
    lm = torch.gather(x64, 1, idx.unsqueeze(-1).expand(b, m, p))

    def rbf(a, c):
        return torch.exp(-gamma * torch.cdist(a, c) ** 2)

    evals, evecs = torch.linalg.eigh(
        rbf(lm, lm) + 1e-6 * torch.eye(m, dtype=torch.float64))
    inv_sqrt = (evecs / torch.sqrt(evals.clamp_min(1e-8)).unsqueeze(-2)) \
        @ evecs.transpose(1, 2)
    xa = torch.cat([rbf(x64, lm) @ inv_sqrt,
                    torch.ones((b, n, 1), dtype=torch.float64)], -1)
    ww, yy = torch.from_numpy(w).double(), torch.from_numpy(y).double()
    g = torch.einsum("bnp,bn,bnq->bpq", xa, ww, xa) \
        + reg * torch.eye(m + 1, dtype=torch.float64)
    g[:, m, m] += -reg + 1e-8
    beta = torch.linalg.solve(g, torch.einsum("bnp,bn->bp", xa, ww * yy))
    return (xa @ beta.unsqueeze(-1)).squeeze(-1).numpy(), \
        float((evals.max(-1).values / evals.min(-1).values).max())


def _tier_units(a, c):
    return float((np.abs(a - c) / (1e-5 + 1e-4 * np.abs(c))).max())


@pytest.mark.parametrize("n,p,m,reg,cond", [
    (1000, 17, 128, 1.0, 3.5e2), (1000, 17, 128, 0.1, 3.5e2),
    (400, 5, 128, 1.0, 5.5e5), (200, 5, 64, 0.1, 2.1e4)])
def test_ill_conditioned_fits_are_as_close_to_float64_as_the_reference(
        n, p, m, reg, cond):
    """Measured tolerance, not the float tier.  With many landmarks for
    few features (a wide spread of Kmm's eigenvalues: ``cond``) or a small
    ridge, the float32 computation itself is off a float64 one by more
    than the float tier, in both packages alike: measured 0.54-39 tier
    units for the reference, 0.92-40 for the port, and up to 6.8 tier
    units (rtol 1e-4, atol 1e-5 each) between the two (ROADMAP Queue 3).
    So each is held to the float64 fit: the port within twice the
    reference's distance plus one tier unit, and the two within 10 tier
    units of each other."""
    xs, y, w, valid = _bucket(seed=1, n=n, p=p)
    params = {"reg": reg, "n_landmarks": m}
    got, want = _run_both(params, xs, y, w, valid)
    truth, kmm_cond = _float64_fit(xs, y, w, _keys(xs.shape[0])[1], m, reg)
    assert 0.3 * cond < kmm_cond < 3 * cond
    assert _tier_units(got, truth) <= 2 * _tier_units(want, truth) + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_padded_bucket_matches_reference_and_unpadded():
    """N padded by 28 rows (w = 0, valid = 0) and P by 3 zero columns, as
    ``tests/test_compile.py`` pads the reference: the landmarks are drawn
    over valid rows, the resolved gamma ignores zero columns, so padding
    never moves a fit; padding rows predict exactly 0."""
    params = {"reg": 1.0, "n_landmarks": 32, "gamma": 0.2}
    xs, y, w, valid = _bucket(seed=2)
    padded = (_pad(xs, 28, 3), _pad(y, 28), _pad(w, 28), _pad(valid, 28))
    got, want = _run_both(params, *padded)
    np.testing.assert_allclose(got, want, **TIER)
    assert float(np.abs(got[:, 200:]).max()) == 0.0
    unpadded, _ = _run_both(params, xs, y, w, valid)
    np.testing.assert_allclose(got[:, :200], unpadded, rtol=1e-5, atol=1e-5)


def test_landmarks_are_drawn_over_valid_rows_not_training_rows():
    """An IRM subset nuisance trains on a fraction of the rows (w = 0
    elsewhere); the landmarks still come from every valid row, as in the
    reference."""
    params = {"reg": 1.0, "n_landmarks": 48, "gamma": 0.2}
    xs, y, w, valid = _bucket(seed=3)
    w[:, ::3] = 0.0
    w[:, 1::3] = 0.0
    got, want = _run_both(params, xs, y, w, valid)
    np.testing.assert_allclose(got, want, **TIER)
    _, tk = _keys(xs.shape[0])
    idx = kernel_ridge.landmark_idx(tk, 200, 48, torch.from_numpy(valid))
    assert (torch.from_numpy(w).gather(1, idx) == 0).any()


def test_bonus_data_fit_is_as_close_to_float64_as_the_reference():
    """Measured tolerance, not the float tier: the README quickstart's
    first 4 tasks (bonus data, 256 landmarks, gamma 1/17, reg 1.0).  The
    bonus covariates are mostly binary, so landmark rows repeat and Kmm
    is singular but for its 1e-6 jitter (condition 1.9e8): measured, the
    port is 0.054 (356 tier units) and the reference 0.041 (259) off a
    float64 fit, and the two differ by up to 0.051, though their
    landmarks are the same.  So each is held to the float64 fit, the port
    within twice the reference's distance plus one tier unit, and the two
    within 0.2 of each other (ROADMAP Queue 3)."""
    raw = make_bonus_data()
    rng = np.random.default_rng(0)
    b, (n, p) = 4, raw["x"].shape
    xs = np.broadcast_to(raw["x"].astype(np.float32), (b, n, p)).copy()
    y = np.broadcast_to(raw["y"].astype(np.float32), (b, n)).copy()
    w = (rng.random((b, n)) < 0.8).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    params = {"reg": 1.0, "n_landmarks": 256, "gamma": 1.0 / p}
    got, want = _run_both(params, xs, y, w, valid, seed=42)
    truth, kmm_cond = _float64_fit(xs, y, w, _keys(b, 42)[1], 256, 1.0,
                                   gamma=1.0 / p)
    assert kmm_cond > 1e6
    assert _tier_units(got, truth) <= 2 * _tier_units(want, truth) + 1.0
    assert np.abs(got - want).max() < 0.2


@pytest.mark.parametrize("t,m", [(6, 32), (10, 64)])
def test_shared_x_matches_reference(t, m):
    rng = np.random.default_rng(4)
    n, p = 240, 6
    x = rng.normal(size=(n, p)).astype(np.float32)
    y = (np.cos(x[:, 0]) + x[:, 2] + 0.2 * rng.normal(size=(t, n))
         ).astype(np.float32)
    w = (rng.random((t, n)) > 0.25).astype(np.float32)
    params = {"reg": 1.0, "n_landmarks": m}
    key = jax.random.key(11)
    want = np.asarray(jax_shared("kernel_ridge", params)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), key))
    runtime.reset_launch_counts()
    got = get_learner("kernel_ridge", params)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        threefry.key(11))
    np.testing.assert_allclose(got.numpy(), want, **TIER)
    # the CPU runs the plain versions: no kernel launch is counted
    assert not any(runtime.launch_counts.values())
    # and the key may come as JAX's words
    again = get_learner("kernel_ridge", params)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        np.asarray(jax.random.key_data(key)))
    assert torch.equal(again, got)


def test_rbf_matches_reference():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(40, 7)).astype(np.float32)
    b = rng.normal(size=(9, 7)).astype(np.float32)
    want = np.asarray(jax_kr._rbf(jnp.asarray(a), jnp.asarray(b), 0.3))
    got = kernel_ridge._rbf(torch.from_numpy(a), torch.from_numpy(b), 0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

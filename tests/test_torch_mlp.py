"""The port's MLP learner against the JAX package's.

Same numpy inputs and task keys (JAX's Threefry words) through
``repro.learners.mlp`` (jnp on the CPU) and ``repro_torch.learners.mlp``
(plain PyTorch on the CPU): the initial weights within 1e-6 (the normals
are JAX's to 2 ulps), predictions after Adam at the float tier (rtol 1e-4,
atol 1e-5), both forms and ``classify``; padding in N never moves a fit
and padding rows predict exactly 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.learners import get_batched_learner as jax_batched
from repro.learners import get_learner as jax_shared
from repro.learners import mlp as jax_mlp
from repro_torch import threefry
from repro_torch.learners import get_batched_learner, get_learner
from repro_torch.learners import mlp

TIER = dict(rtol=1e-4, atol=1e-5)


def _keys(b, seed=7):
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(b))
    return jk, torch.from_numpy(
        np.asarray(jax.random.key_data(jk)).astype(np.int64))


def _bucket(seed, b=4, n=120, p=5, classify=False):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, n, p)).astype(np.float32) * 2.0 + 0.5
    y = (np.tanh(xs[..., 0]) + 0.3 * xs[..., 1]
         + 0.2 * rng.normal(size=(b, n))).astype(np.float32)
    if classify:
        y = (y > 0.3).astype(np.float32)
    w = (rng.random((b, n)) > 0.3).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    return xs, y, w, valid


def _run_both(params, xs, y, w, valid):
    jk, tk = _keys(xs.shape[0])
    want = np.asarray(jax_batched("mlp", params)(
        jnp.asarray(xs), jnp.asarray(y), jnp.asarray(w), jnp.asarray(valid),
        jk))
    got = get_batched_learner("mlp", params)(
        *(torch.from_numpy(a) for a in (xs, y, w, valid)), tk)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("hidden", [(8,), (16, 16), (64, 64)])
def test_init_matches_reference(hidden):
    jk, tk = _keys(3)
    want = [jax_mlp._init_mlp(k, 7, hidden) for k in jk]
    got = mlp._init_mlp(tk, 7, hidden)
    assert len(got) == 2 * len(want[0])
    for t in range(3):
        for i, layer in enumerate(want[t]):
            np.testing.assert_allclose(got[2 * i][t].numpy(),
                                       np.asarray(layer["w"]), rtol=1e-6,
                                       atol=1e-6)
            assert np.array_equal(got[2 * i + 1][t].numpy(),
                                  np.asarray(layer["b"]))


@pytest.mark.parametrize("params", [
    {"hidden": (8,), "n_steps": 30},
    {"hidden": (16, 16), "n_steps": 100, "lr": 1e-2},
    {"hidden": (16, 16), "n_steps": 300},
])
def test_batched_matches_reference(params):
    got, want = _run_both(params, *_bucket(seed=1))
    np.testing.assert_allclose(got, want, **TIER)


@pytest.mark.parametrize("params", [
    {"hidden": (8,), "n_steps": 30, "classify": True},
    {"hidden": (16, 16), "n_steps": 200, "classify": True},
])
def test_batched_classify_matches_reference(params):
    got, want = _run_both(params, *_bucket(seed=2, classify=True))
    np.testing.assert_allclose(got, want, **TIER)
    assert ((got >= 0) & (got <= 1)).all()          # sigmoid, saturating


def test_padding_rows_never_move_a_fit():
    """N padded by 28 rows (w = 0, valid = 0) at the exact P (mlp buckets
    keep P: the init scale is sqrt(2/P)): the masked moments ignore the
    padding, padding rows stay exactly 0 and predict exactly 0."""
    params = {"hidden": (16, 16), "n_steps": 60}
    xs, y, w, valid = _bucket(seed=3)
    pad = [np.pad(a, ((0, 0), (0, 28)) + ((0, 0),) * (a.ndim - 2))
           for a in (xs, y, w, valid)]
    got, want = _run_both(params, *pad)
    np.testing.assert_allclose(got, want, **TIER)
    assert float(np.abs(got[:, 120:]).max()) == 0.0
    unpadded, _ = _run_both(params, xs, y, w, valid)
    np.testing.assert_allclose(got[:, :120], unpadded, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("params", [
    {"hidden": (8,), "n_steps": 50},
    {"hidden": (16, 16), "n_steps": 150},
    {"hidden": (16, 16), "n_steps": 60, "classify": True},
])
def test_shared_x_matches_reference(params):
    xs, y, w, _ = _bucket(seed=4, b=6, classify=params.get("classify",
                                                           False))
    x = xs[0]
    key = jax.random.key(13)
    want = np.asarray(jax_shared("mlp", params)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), key))
    got = get_learner("mlp", params)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        threefry.key(13))
    np.testing.assert_allclose(got.numpy(), want, **TIER)


def test_lanes_train_independently():
    """A lane's fit does not depend on the other lanes of its call: the
    gradient of the summed losses is each lane's own."""
    params = {"hidden": (8,), "n_steps": 40}
    xs, y, w, valid = _bucket(seed=5)
    _, tk = _keys(4)
    fn = get_batched_learner("mlp", params)
    ops = [torch.from_numpy(a) for a in (xs, y, w, valid)] + [tk]
    whole = fn(*ops)
    alone = fn(*(a[1:2] for a in ops))
    torch.testing.assert_close(whole[1:2], alone, rtol=1e-6, atol=1e-6)

"""The port's Threefry stream (``repro_torch.threefry``) against
``jax.random`` of the installed JAX, in the mode JAX runs by default
(``jax_threefry_partitionable``).

Tiers: keys, bits and uniforms exact (``np.array_equal``); gumbel and
exponential within 2 float32 ulps of max(|value|, 1) (PyTorch's ``log``
and ``log1p`` against XLA's); normal within 3e-7
relative (JAX's erf_inv polynomial evaluated by PyTorch; measured 2.4e-7
over 1e8 draws).  Landmark indices exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.learners import kernel_ridge as jax_kr
from repro_torch import threefry
from repro_torch.learners import kernel_ridge

SEEDS = [0, 1, 42, 141, 2 ** 31 - 1]


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_the_mode_reproduced_is_jax_default():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    # gumbel's default mode draws one uniform an element ("low")
    assert not jax.config.jax_high_dynamic_range_gumbel


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words(seed):
    assert np.array_equal(threefry.key(seed).numpy(),
                          _words(jax.random.key(seed)))
    assert threefry.key(seed).dtype == torch.int64


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    data = [0, 1, 7, 99, 5103, 2 ** 32 - 1]
    want = np.stack([_words(jax.random.fold_in(jax.random.key(seed), d))
                     for d in data])
    got = threefry.fold_in(threefry.key(seed), torch.tensor(data))
    assert np.array_equal(got.numpy(), want)
    # one key a row of a batch of keys, broadcast against the data
    keys = threefry.fold_in(threefry.key(seed), torch.arange(3))
    both = threefry.fold_in(keys.unsqueeze(-2), torch.arange(4))
    for i in range(3):
        ki = jax.random.fold_in(jax.random.key(seed), i)
        for d in range(4):
            assert np.array_equal(both[i, d].numpy(),
                                  _words(jax.random.fold_in(ki, d)))


@pytest.mark.parametrize("num", [1, 2, 5, (2, 3)])
def test_split(num):
    k = jax.random.key(42)
    want = _words(jax.random.split(k, num))
    got = threefry.split(threefry.key(42), num)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(), (1,), (3,), (50, 300), (2, 3, 4),
                                   (1001,)])
def test_bits(shape):
    k = jax.random.fold_in(jax.random.key(5), 3)
    want = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
    got = threefry.bits(threefry.fold_in(threefry.key(5), 3), shape)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_bits_of_a_batch_of_keys_are_each_keys_bits():
    keys = threefry.split(threefry.key(9), 4)
    got = threefry.bits(keys, (3, 5))
    jkeys = jax.random.split(jax.random.key(9), 4)
    for i in range(4):
        want = np.asarray(jax.random.bits(jkeys[i], (3, 5))).astype(np.int64)
        assert np.array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_exact(lo, hi):
    k = jax.random.key(17)
    want = np.asarray(jax.random.uniform(k, (4000,), jnp.float32, lo, hi))
    got = threefry.uniform(threefry.key(17), (4000,), lo, hi)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def _ulps(got, want):
    """|got - want| in float32 ulps of max(|want|, 1): near 0 the error of
    -log(-log u) is that of the inner log, of magnitude about 1."""
    scale = np.maximum(np.abs(want), 1.0).astype(np.float32)
    return np.abs(got - want) / np.spacing(scale)


@pytest.mark.parametrize("fn", ["gumbel", "exponential"])
def test_gumbel_and_exponential_within_two_ulps(fn):
    k = jax.random.key(3)
    want = np.asarray(getattr(jax.random, fn)(k, (20000,)))
    got = getattr(threefry, fn)(threefry.key(3), (20000,)).numpy()
    assert np.isfinite(got).all()
    assert _ulps(got, want).max() <= 2.0


@pytest.mark.parametrize("seed", [42, 141])
def test_normal_within_erf_inv_ulps(seed):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.normal(k, (500, 5099)))
    got = threefry.normal(threefry.key(seed), (500, 5099)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-7)
    # the tails too: the largest |z| of the draw
    assert np.abs(got).max() > 4.0


def test_erf_inv_matches_lax_on_a_grid():
    x = np.linspace(-0.9999999, 0.9999999, 20001).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = threefry.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-7)
    ends = threefry.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    assert np.array_equal(ends, np.asarray(jax.lax.erf_inv(
        jnp.array([-1.0, 1.0], jnp.float32))))


def test_gumbel_order_is_the_mantissa_order():
    """kernel_ridge ranks rows by the uniform's 23 mantissa bits: the
    Gumbel transform JAX evaluates is strictly increasing over every one
    of the 2^23 uniforms it can draw."""
    m = np.arange(2 ** 23, dtype=np.uint32)
    u = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    tiny = np.float32(np.finfo(np.float32).tiny)
    u = np.maximum(tiny, u + tiny)
    g = np.asarray(-jnp.log(-jnp.log(jnp.asarray(u))))
    assert (np.diff(g) > 0).all()


def test_top_m_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(5, 60))
        s = rng.integers(0, 4, size=(3, n)).astype(np.float32)
        s[rng.random((3, n)) < 0.2] = -np.inf           # padding rows
        for m in (1, n // 2, n):
            _, want = jax.lax.top_k(jnp.asarray(s), m)
            got = kernel_ridge.top_m(torch.from_numpy(s), m)
            assert np.array_equal(got.numpy(), np.asarray(want)), (trial, m)


def test_landmarks_equal_lax_top_k_over_many_task_keys():
    """1024 task keys (fold_in of a segment seed by flat task id) at the
    bonus data's N 5104, 128 landmarks, with 5 padding rows masked: the
    port's indices are exactly the reference's."""
    n, m, t = 5104, 128, 1024
    valid = np.ones(n, np.float32)
    valid[-5:] = 0.0
    base = jax.random.key(42)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(t))
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax_kr._landmark_idx(k, n, m, jnp.asarray(valid))))(jkeys))
    keys = threefry.fold_in(threefry.key(42), torch.arange(t))
    assert np.array_equal(keys.numpy(), _words(jkeys))
    got = kernel_ridge.landmark_idx(keys, n, m,
                                    torch.from_numpy(valid).expand(t, n))
    assert np.array_equal(got.numpy(), want)
    assert (got < n - 5).all()


def test_landmarks_ignore_padding_rows_appended():
    keys = threefry.fold_in(threefry.key(7), torch.arange(16))
    valid = torch.ones((16, 300))
    valid[:, 250:] = 0.0
    a = kernel_ridge.landmark_idx(keys, 250, 40)
    b = kernel_ridge.landmark_idx(keys, 300, 40, valid)
    assert torch.equal(a, b)

"""The port's multiplier bootstrap against the JAX package's: the same
score components and key through ``repro.core.bootstrap`` and
``repro_torch.core.bootstrap`` on the CPU.  The multipliers are JAX's
Threefry draws to a few ulps, so the t-statistics agree within 2e-6 and
the intervals within 1e-6 relative; the score's se at the float tier.
"""
import jax
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.core import bootstrap as jax_boot
from repro_torch import threefry
from repro_torch.core import boot_confint, multiplier_bootstrap


def _scores(seed, n=2000):
    rng = np.random.default_rng(seed)
    psi_a = -np.abs(rng.normal(1.0, 0.3, size=n)).astype(np.float32)
    psi_b = (rng.normal(size=n) * 1.5 + 0.4).astype(np.float32)
    return psi_a, psi_b


@pytest.mark.parametrize("method", ["normal", "Bayes", "wild"])
@pytest.mark.parametrize("seed,n_boot", [(141, 500), (7, 64)])
def test_bootstrap_matches_reference(method, seed, n_boot):
    psi_a, psi_b = _scores(seed)
    want_t, want_se = jax_boot.multiplier_bootstrap(
        psi_a, psi_b, 0.5, jax.random.key(seed), n_boot=n_boot,
        method=method)
    got_t, got_se = multiplier_bootstrap(
        torch.from_numpy(psi_a), torch.from_numpy(psi_b), 0.5,
        threefry.key(seed), n_boot=n_boot, method=method)
    assert got_t.shape == (n_boot,) and got_t.dtype == torch.float32
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=2e-6)
    assert abs(got_se - want_se) <= 1e-6 * want_se
    ci = boot_confint(0.5, got_se, got_t)
    want_ci = jax_boot.boot_confint(0.5, want_se, want_t)
    np.testing.assert_allclose(ci, want_ci, rtol=1e-6)
    assert ci[0] < 0.5 < ci[1]


def test_methods_draw_different_multipliers():
    psi_a, psi_b = _scores(3)
    outs = [multiplier_bootstrap(psi_a, psi_b, 0.2, threefry.key(1),
                                 n_boot=50, method=m)[0]
            for m in ("normal", "Bayes", "wild")]
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("level", [0.9, 0.95, 0.99])
def test_confint_quantile_is_jnp_quantile(level):
    rng = np.random.default_rng(int(level * 100))
    t = rng.normal(size=333).astype(np.float32)
    want = jax_boot.boot_confint(1.25, 0.1, t, level)
    got = boot_confint(1.25, 0.1, torch.from_numpy(t), level)
    np.testing.assert_allclose(got, want, rtol=1e-6)

"""Synthetic data-generating processes for DML validation.

``make_plr_data`` follows Chernozhukov et al. (2018) §5.1 style PLR DGPs
(nonlinear confounding, known theta0) so estimator bias/coverage is
checkable.  ``make_irm_data`` gives a binary-treatment interactive model.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _toeplitz_cov(p: int, rho: float = 0.7) -> np.ndarray:
    idx = np.arange(p)
    return rho ** np.abs(idx[:, None] - idx[None, :])


def make_plr_data(n_obs: int = 500, dim_x: int = 20, theta: float = 0.5,
                  seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.Philox(key=seed))
    cov = _toeplitz_cov(dim_x)
    chol = np.linalg.cholesky(cov)
    x = rng.standard_normal((n_obs, dim_x)) @ chol.T
    m0 = x[:, 0] + 0.25 * np.exp(x[:, 2]) / (1 + np.exp(x[:, 2]))
    g0 = np.exp(x[:, 0]) / (1 + np.exp(x[:, 0])) + 0.25 * x[:, 2]
    d = m0 + rng.standard_normal(n_obs)
    y = theta * d + g0 + rng.standard_normal(n_obs)
    return {"x": x.astype(np.float32), "y": y.astype(np.float32),
            "d": d.astype(np.float32), "theta0": theta}


def make_irm_data(n_obs: int = 500, dim_x: int = 20, theta: float = 0.5,
                  seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.Philox(key=seed))
    cov = _toeplitz_cov(dim_x, 0.5)
    chol = np.linalg.cholesky(cov)
    x = rng.standard_normal((n_obs, dim_x)) @ chol.T
    idx = x[:, 0] + 0.5 * x[:, 1]
    pz = 1.0 / (1.0 + np.exp(-idx))
    d = (rng.random(n_obs) < pz).astype(np.float32)
    g = np.exp(x[:, 0]) / (1 + np.exp(x[:, 0])) + 0.25 * x[:, 2]
    y = theta * d + g + rng.standard_normal(n_obs)
    return {"x": x.astype(np.float32), "y": y.astype(np.float32),
            "d": d, "theta0": theta}


def make_pliv_data(n_obs: int = 500, dim_x: int = 20, theta: float = 0.5,
                   seed: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.Philox(key=seed))
    x = rng.standard_normal((n_obs, dim_x))
    z = x[:, 0] + rng.standard_normal(n_obs)        # instrument
    u = rng.standard_normal(n_obs)                  # endogeneity
    d = z + 0.3 * x[:, 1] + u + 0.5 * rng.standard_normal(n_obs)
    g = 0.25 * x[:, 2] + np.tanh(x[:, 0])
    y = theta * d + g + u + rng.standard_normal(n_obs)
    return {"x": x.astype(np.float32), "y": y.astype(np.float32),
            "d": d.astype(np.float32), "z": z.astype(np.float32),
            "theta0": theta}

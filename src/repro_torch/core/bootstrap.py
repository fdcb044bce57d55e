"""Multiplier bootstrap inference on the evaluated score (paper §5.1:
"inference tasks like ... multiplier bootstrap ... done locally").

Given the cross-fitted score components the bootstrap never touches the
data again: it reweights psi with iid multipliers (Bayes / normal / wild),
as in Chernozhukov et al. (2018) §3.3 and the DoubleML package.  The
multipliers come from JAX's stream (``repro_torch.threefry``), drawn on
the device the scores lie on, so they are the reference's to a few ulps.
"""
from __future__ import annotations

import torch

from repro_torch import threefry

F32 = torch.float32


def multiplier_bootstrap(psi_a, psi_b, theta: float, key,
                         n_boot: int = 500, method: str = "normal"):
    """t-statistics of the bootstrapped estimator.

    psi_a/psi_b: (N,) evaluated score components for ONE repetition;
    ``key`` (2,) the stream's key.  Returns the (n_boot,) bootstrap
    t-stats (a tensor on psi's device) and the score's se.
    """
    psi_a = torch.as_tensor(psi_a).to(F32)
    psi_b = torch.as_tensor(psi_b).to(psi_a.device, F32)
    key = threefry.key_data(key).to(psi_a.device)
    n = psi_a.shape[0]
    psi = theta * psi_a + psi_b
    j = psi_a.mean()
    se = torch.sqrt((psi * psi).mean() / (j * j) / n)

    if method == "Bayes":
        xi = threefry.exponential(key, (n_boot, n)) - 1.0
    elif method == "wild":
        u = threefry.normal(key, (n_boot, n))
        v = threefry.normal(threefry.fold_in(key, 1), (n_boot, n))
        sqrt2 = torch.full((), 2.0, dtype=F32, device=psi.device).sqrt()
        xi = u / sqrt2 + (v * v - 1.0) / 2.0
    else:                                  # "normal"
        xi = threefry.normal(key, (n_boot, n))

    boot_t = (xi * psi.unsqueeze(0)).mean(dim=1) / (j * se)
    return boot_t, float(se)


def boot_confint(theta: float, se: float, boot_t, level: float = 0.95):
    """The bootstrap interval: theta -/+ the ``level`` quantile of |t|
    (linear interpolation, as ``jnp.quantile``) times se."""
    q = torch.quantile(torch.as_tensor(boot_t).abs(), level)
    return float(theta - q * se), float(theta + q * se)

"""Aggregation over repeated sample splits (paper §3, final step).

theta_tilde = Median_m(theta_m); the variance aggregation follows
Chernozhukov et al. (2018) remark 3.1 / the DoubleML package:
sigma^2 = Median_m( sigma_m^2 + (theta_m - theta_tilde)^2 ), which accounts
for the across-split variability.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.scipy_free_stats import norm_ppf


def _median(x):
    """Median that averages the two middle order statistics of an even
    count (``torch.median`` would return the lower one)."""
    return torch.quantile(x, 0.5)


def aggregate_thetas(thetas, ses, method: str = "median") -> Tuple[float, float]:
    thetas = torch.as_tensor(thetas, dtype=torch.float32)
    ses = torch.as_tensor(ses, dtype=torch.float32)
    if method == "median":
        theta = _median(thetas)
        var = _median(ses**2 + (thetas - theta) ** 2)
    elif method == "mean":
        theta = torch.mean(thetas)
        var = torch.mean(ses**2 + (thetas - theta) ** 2)
    else:
        raise ValueError(method)
    return float(theta), float(torch.sqrt(var))


def confint(theta: float, se: float, level: float = 0.95):
    q = norm_ppf(0.5 + level / 2)
    return theta - q * se, theta + q * se

"""Learner registry (megabatch forms).

Every family registers one pure function on tensors:

  megabatch form  fn(xs (B,N,P), y (B,N), w (B,N), valid (B,N), keys (B,2))
                  -> preds (B,N) — per-task feature pages with padding
                  masks, executed by the bucketed programs the compiler
                  (repro_torch/compile) builds.  ``keys`` is the per-task
                  key table (segment seed, flat task id); the linear
                  families ignore it.

``get_batched_learner`` binds hyperparameters.  ``resolve_params`` binds
data-dependent defaults at *compile* time so padded execution is
padding-invariant.  The linear families accept ``classify=True`` via
params (a linear probability model for IRM/IIVM propensities).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping

from repro_torch.learners.linear import (
    lasso_batched_fit_predict, ols_batched_fit_predict,
    ridge_batched_fit_predict,
)

LearnerFn = Callable

BATCHED_LEARNERS: Dict[str, Callable] = {
    "ols": ols_batched_fit_predict,
    "ridge": ridge_batched_fit_predict,
    "lasso": lasso_batched_fit_predict,
}

# Families whose megabatch form is invariant to zero-padded feature lanes
# (linear algebra sees inert columns).  The names of families that are not
# registered yet stay listed so bucket keys agree with the reference's.
FEATURE_PAD_SAFE = frozenset(
    {"ols", "ridge", "lasso", "logistic", "kernel_ridge"})


def resolve_params(name: str, params: Mapping | None, *, n_obs: int,
                   dim_x: int) -> Dict:
    """Bind data-dependent hyperparameter defaults at compile time.

    The megabatch programs run on padded shapes, so any default derived
    from the *data* shape (kernel_ridge's gamma = 1/P, landmark count
    capped by N) must be pinned to the true shape before bucketing —
    otherwise padding would leak into the estimate.
    """
    params = dict(params or {})
    if name == "kernel_ridge":
        if params.get("gamma") is None:
            params["gamma"] = 1.0 / dim_x
        params["n_landmarks"] = min(params.get("n_landmarks", 128), n_obs)
    return params


def _bind(table: Dict[str, Callable], name: str,
          params: Mapping | None) -> LearnerFn:
    if name not in table:
        raise KeyError(f"unknown learner {name!r}; known: {list(table)}")
    params = dict(params or {})
    fn = table[name]
    if name in ("ols", "ridge", "lasso"):
        # linear probability model for propensities: fit as regression,
        # clip in the score (scores.py clips)
        params.pop("classify", False)
    if params:
        fn = functools.partial(fn, **params)
    return fn


def get_batched_learner(name: str, params: Mapping | None = None) -> LearnerFn:
    """Resolve the megabatch form: fn(xs, y, w, valid, keys) -> preds."""
    return _bind(BATCHED_LEARNERS, name, params)

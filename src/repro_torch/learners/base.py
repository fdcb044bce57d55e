"""Learner registry.

Every family registers two pure functions on tensors:

  shared-X form   fn(x (N,P), y (T,N), w (T,N), key) -> preds (T,N)
                  the fold-mask task batch over one dataset (paper: one
                  scikit-learn fit per lambda; here: one fused call, whose
                  normal equations are one ``crossfit_gram`` launch).
  megabatch form  fn(xs (B,N,P), y (B,N), w (B,N), valid (B,N), keys (B,2))
                  -> preds (B,N) — per-task feature pages with padding
                  masks, executed by the bucketed programs the compiler
                  (repro_torch/compile) builds.  ``keys`` holds one
                  PRNG key per task, the uint32 words of
                  fold_in(key(segment seed), flat task id) in int64
                  (repro_torch/threefry.py: JAX's Threefry stream).

The linear families (ols, ridge, lasso, logistic) ignore ``key`` and
``keys``; kernel_ridge draws its landmarks and mlp its initial weights from
them.  ``get_learner`` / ``get_batched_learner`` bind hyperparameters;
``as_batched`` adapts an opaque shared-X callable to the megabatch form.
``resolve_params`` binds data-dependent defaults at *compile* time so
padded execution is padding-invariant.  mlp accepts ``classify=True`` via
params (a sigmoid output for IRM/IIVM propensities); the linear regression
families accept and drop it (a linear probability model).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping

import torch

from repro_torch.learners.kernel_ridge import (
    kernel_ridge_batched_fit_predict, kernel_ridge_fit_predict,
)
from repro_torch.learners.linear import (
    lasso_batched_fit_predict, lasso_fit_predict,
    logistic_batched_fit_predict, logistic_fit_predict,
    ols_batched_fit_predict, ols_fit_predict, on_one_device,
    ridge_batched_fit_predict, ridge_fit_predict,
)
from repro_torch.learners.mlp import mlp_batched_fit_predict, mlp_fit_predict

LearnerFn = Callable

LEARNERS: Dict[str, Callable] = {
    "ols": ols_fit_predict,
    "ridge": ridge_fit_predict,
    "lasso": lasso_fit_predict,
    "logistic": logistic_fit_predict,
    "kernel_ridge": kernel_ridge_fit_predict,
    "mlp": mlp_fit_predict,
}

BATCHED_LEARNERS: Dict[str, Callable] = {
    "ols": ols_batched_fit_predict,
    "ridge": ridge_batched_fit_predict,
    "lasso": lasso_batched_fit_predict,
    "logistic": logistic_batched_fit_predict,
    "kernel_ridge": kernel_ridge_batched_fit_predict,
    "mlp": mlp_batched_fit_predict,
}

# Families whose megabatch form is invariant to zero-padded feature lanes
# (linear algebra sees inert columns; kernel_ridge's rbf distances ignore
# zero columns once gamma is resolved).  mlp is excluded: its init scale
# is sqrt(2/P), so the bucket planner keeps mlp buckets at the exact P.
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


def get_learner(name: str, params: Mapping | None = None) -> LearnerFn:
    """Resolve the shared-X form: fn(x, y, w, key) -> preds."""
    return _bind(LEARNERS, name, params)


def get_batched_learner(name: str, params: Mapping | None = None) -> LearnerFn:
    """Resolve the megabatch form: fn(xs, y, w, valid, keys) -> preds."""
    return _bind(BATCHED_LEARNERS, name, params)


def as_batched(fn: Callable) -> Callable:
    """Adapt an opaque shared-X learner callable to the megabatch
    signature: lane b is ``fn(xs[b], y[b:b+1], w[b:b+1], keys[b])[0]``,
    and the lanes' predictions are stacked.  ``valid`` is not applied, as
    in the reference: the opaque buckets have exact shapes.

    The reference maps the lanes with one ``jax.vmap``.  ``torch.func.vmap``
    cannot trace through a kernel launched with ctypes, so here the lanes
    are a Python loop on the device the tensors lie on: a shared-X learner
    that launches ``crossfit_gram`` launches it once per lane (T = 1), B
    times per block — the same math, more launches.  Operands that are not
    tensors go to the card, so on a machine without one they raise."""
    def batched(xs, y, w, valid, keys):
        xs, y, w, keys = on_one_device(xs, y, w, keys)
        return torch.stack([fn(xs[b], y[b:b + 1], w[b:b + 1], keys[b])[0]
                            for b in range(xs.shape[0])])
    return batched

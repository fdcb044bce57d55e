"""Nyström kernel ridge: the nonparametric learner (the stand-in for the
paper's random forest).  RBF features through m landmarks, then the ridge
path: the megabatch form on ``batched_gram`` and ``batched_predict`` (K1,
K2) at P = m + 1, the shared-X form on ``crossfit_gram`` (K4).

Landmarks are a Gumbel top-m over the valid rows, one scalar Gumbel drawn
per row from ``fold_in(task key, row)`` (``repro_torch.threefry``, JAX's
stream): a row's draw depends on (key, row) only, never on the array
length, so appending masked padding rows cannot change the landmarks.
The Gumbel transform is increasing in the uniform it is made from, so the
rows are ranked by that uniform's 23 mantissa bits, an integer: the same
order as the Gumbel values (on every one of the 2^23 uniforms), ties to
the lower row as ``lax.top_k`` breaks them, and the same on the CPU and on
the card whatever ulp their ``log`` rounds to.

The RBF products, ``eigh`` and ``knm @ inv_sqrt`` are PyTorch library
calls, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch import threefry
from repro_torch.learners.linear import (
    on_one_device, ridge_batched_fit_predict, ridge_fit_predict,
)

F32 = torch.float32


def _rbf(a, b, gamma: float):
    """exp(-gamma |a_i - b_j|^2) of (..., N, P) and (..., M, P) rows."""
    d2 = ((a * a).sum(-1).unsqueeze(-1) + (b * b).sum(-1).unsqueeze(-2)
          - torch.matmul(2.0 * a, b.transpose(-1, -2)))
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


def top_m(score: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest of ``score`` (..., N) in descending order,
    equal values in ascending index: ``lax.top_k``'s order."""
    return torch.sort(score, dim=-1, descending=True, stable=True
                      ).indices[..., :m]


def landmark_idx(keys, n: int, m: int, valid=None) -> torch.Tensor:
    """(..., m) row indices drawn uniformly without replacement (Gumbel
    top-m) for each key of ``keys`` (..., 2), restricted to the rows where
    ``valid`` (..., N) is non-zero when it is given."""
    rows = torch.arange(n, dtype=torch.int64, device=keys.device)
    row_keys = threefry.fold_in(keys.unsqueeze(-2), rows)     # (..., N, 2)
    score = threefry.mantissa(threefry.bits(row_keys))
    if valid is not None:
        score = torch.where(valid > 0, score, -1)
    return top_m(score, m)


def nystrom_features(x, keys, *, n_landmarks: int = 128,
                     gamma: float | None = None, valid=None):
    """phi(x) (..., N, m) with K ~= phi phi^T, for x (..., N, P) and one key
    (..., 2) per leading index.  ``valid`` (..., N) restricts the landmark
    candidates to real rows (megabatch padding); callers keep
    n_landmarks <= the valid rows."""
    x = x.to(F32)
    n, p = x.shape[-2:]
    m = min(n_landmarks, n)
    idx = landmark_idx(keys, n, m, valid)
    lm = torch.gather(x, -2, idx.unsqueeze(-1).expand(idx.shape + (p,)))
    if gamma is None:
        gamma = 1.0 / p
    eye = torch.eye(m, dtype=F32, device=x.device)
    kmm = _rbf(lm, lm, gamma) + 1e-6 * eye
    kmm = (kmm + kmm.transpose(-1, -2)) / 2         # as jnp.linalg.eigh does
    knm = _rbf(x, lm, gamma)
    # K ~= Knm Kmm^-1 Kmn  =>  phi = Knm Kmm^-1/2
    evals, evecs = torch.linalg.eigh(kmm)
    d = 1.0 / torch.sqrt(torch.clamp_min(evals, 1e-8))
    inv_sqrt = torch.matmul(evecs * d.unsqueeze(-2), evecs.transpose(-1, -2))
    return torch.matmul(knm, inv_sqrt)


def kernel_ridge_fit_predict(x, y, w, key, *, reg: float = 1.0,
                             n_landmarks: int = 128,
                             gamma: float | None = None):
    """Shared-X form: one landmark set from ``key`` (2,) for all T tasks,
    then one ``crossfit_gram`` launch on the (N, m + 1) features."""
    (x,) = on_one_device(x)
    phi = nystrom_features(x, threefry.key_data(key).to(x.device),
                           n_landmarks=n_landmarks, gamma=gamma)
    return ridge_fit_predict(phi, y, w, reg=reg, intercept=True)


def kernel_ridge_batched_fit_predict(xs, y, w, valid, keys, *,
                                     reg: float = 1.0,
                                     n_landmarks: int = 128,
                                     gamma: float | None = None):
    """Megabatch form: per-task landmarks (per-task keys (B, 2)) on every
    lane at once, then the batched ridge on the (B, N, m + 1) features."""
    phi = nystrom_features(xs, threefry.key_data(keys),
                           n_landmarks=n_landmarks, gamma=gamma, valid=valid)
    return ridge_batched_fit_predict(phi, y, w, valid, reg=reg,
                                     intercept=True)

"""Linear nuisance learners on batched masked fits (megabatch forms).

  megabatch form  fn(xs (B,N,P), y (B,N), w (B,N), valid (B,N), keys)
                  -> preds (B,N) — every task carries its own (padded)
                  feature page, so one program serves tasks from many
                  requests/datasets at once (repro_torch/compile buckets).
                  ``valid`` marks real observation rows (0 = N-padding);
                  training weights are already 0 on padded rows, and
                  predictions on padded rows are returned as exactly 0.

Fits are fused across tasks: the batch dimension is written out, the
normal equations come from the ``batched_gram`` kernel and the
predictions from ``batched_predict`` (kernels/ops.py).  The batched
Cholesky solve and FISTA's small products are PyTorch library calls, as
the JAX package leaves them to XLA.

Nothing here synchronises with the device: the Cholesky status is kept
on the device and read only by ``solve_failures``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ops

F32 = torch.float32

# device -> running maximum of cholesky_ex's ``info`` (0: every
# factorisation so far succeeded)
_solve_status: Dict[torch.device, torch.Tensor] = {}


def solve_failures(device) -> int:
    """Largest Cholesky ``info`` seen on ``device`` since the last
    ``reset_solve_status`` (0 = all factorisations succeeded).  Reading
    it waits for the device; the fit path itself never does."""
    status = _solve_status.get(torch.device(device))
    return 0 if status is None else int(status.item())


def reset_solve_status() -> None:
    _solve_status.clear()


def _augment_b(xs):
    """Add intercept column to every task page: (B,N,P) -> (B,N,P+1)."""
    ones = torch.ones(xs.shape[:2] + (1,), dtype=xs.dtype, device=xs.device)
    return torch.cat([xs, ones], dim=-1)


def _solve_spd(g, b, live=None):
    """Batched SPD solve via Cholesky: g (B,P,P), b (B,P) -> (B,P).

    ``cholesky_ex`` neither raises nor synchronises; a factorisation that
    fails yields NaN coefficients, as the reference's does.  ``live``
    (B,) marks the lanes whose failure counts in ``solve_failures``: a
    launch's padding lanes (no valid row, G = reg*I) may legitimately
    fail — in float32 the intercept fix-up leaves an exact 0 on their
    diagonal — and nothing ever reads them."""
    chol, info = torch.linalg.cholesky_ex(g)
    worst = (info if live is None else info * live.to(info.dtype)).max()
    prev = _solve_status.get(g.device)
    _solve_status[g.device] = worst if prev is None \
        else torch.maximum(prev, worst)
    beta = torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)
    beta = beta.masked_fill(info.ne(0).unsqueeze(-1), float("nan"))
    return beta.contiguous()


def ridge_batched_fit_predict(xs, y, w, valid, keys=None, *, reg: float = 1.0,
                              intercept: bool = True):
    """Closed-form weighted ridge over a megabatch bucket.

    Padded feature lanes (zero columns) get beta == 0 under the ridge
    penalty and padded rows carry w == 0, so padding never leaks into the
    fit — the bucketed result equals the unpadded fit to float precision.
    """
    xa = _augment_b(xs) if intercept else xs
    g, b = ops.batched_gram(xa, w, y, reg=float(reg))
    if intercept and reg:
        # keep the intercept unpenalized; applied after reg*I, in this
        # order: in f32 (x + reg) + (-reg + 1e-8) is not x + 1e-8
        p = xa.shape[-1]
        g[:, p - 1, p - 1] += -float(reg) + 1e-8
    # a lane with any valid row is live, wherever padding lanes lie
    beta = _solve_spd(g, b, live=valid.ne(0).any(dim=1))
    return ops.batched_predict(xa, beta, valid)


def ols_batched_fit_predict(xs, y, w, valid, keys=None, *,
                            intercept: bool = True):
    return ridge_batched_fit_predict(xs, y, w, valid, keys, reg=1e-8,
                                     intercept=intercept)


def _fista_beta(g, b, w, *, reg: float, intercept: bool, n_iter: int):
    """FISTA on per-task normal equations.

    g (T,P,P), b (T,P) unnormalized moments; w (T,N) training weights
    (used only for the per-observation normalization).  Fixed iteration
    count, so the solve never looks at a value on the device.
    """
    nw = torch.clamp(torch.sum(w, dim=1), min=1.0)            # (T,)
    return _fista_beta_moments(g, b, nw, reg=reg, intercept=intercept,
                               n_iter=n_iter)


def _fista_momentum(n_iter: int):
    """The momentum coefficients (t_k - 1) / t_{k+1}, in float32 as the
    reference carries ``t_k``.  They depend on nothing on the device, so
    they are plain host floats."""
    one, two, four = np.float32(1.0), np.float32(2.0), np.float32(4.0)
    tk = one
    out = []
    for _ in range(n_iter):
        tk1 = (one + np.sqrt(one + four * tk * tk)) / two
        out.append(float((tk - one) / tk1))
        tk = tk1
    return out


def _fista_beta_moments(g, b, nw, *, reg: float, intercept: bool,
                        n_iter: int):
    """The moments form of the FISTA solve: identical math to
    ``_fista_beta`` but with the weight normalizer ``nw`` (T,)
    precomputed by the caller.  A Python loop over batched tensors: 16
    power iterations for the step size, then ``n_iter`` proximal steps.
    """
    t, p = g.shape[0], g.shape[-1]
    g = g / nw[:, None, None]
    b = b / nw[:, None]
    # Lipschitz constant via a few power iterations on each G_t.
    v = torch.ones((t, p), dtype=F32, device=g.device) / float(np.sqrt(p))
    for _ in range(16):
        v = torch.einsum("tpq,tq->tp", g, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                            min=1e-12)
    lmax = (torch.einsum("tp,tpq->tq", v, g) * v).sum(dim=1)
    step = (1.0 / torch.clamp(lmax, min=1e-6))[:, None]       # (T,1)
    pen = torch.ones((p,), dtype=F32, device=g.device)
    if intercept:
        pen[p - 1] = 0.0                                      # no l1 on bias
    thresh = (reg * step) * pen[None]

    beta = torch.zeros((t, p), dtype=F32, device=g.device)
    zeta = beta
    for mom in _fista_momentum(n_iter):
        grad = torch.einsum("tpq,tq->tp", g, zeta) - b
        z = zeta - step * grad
        beta_new = torch.sign(z) * torch.clamp(torch.abs(z) - thresh, min=0.0)
        zeta = beta_new + mom * (beta_new - beta)
        beta = beta_new
    return beta


def lasso_batched_fit_predict(xs, y, w, valid, keys=None, *,
                              reg: float = 0.01, n_iter: int = 200,
                              intercept: bool = True):
    """Megabatch lasso: FISTA on per-task feature pages.

    Padded feature lanes see zero gradient and the l1 penalty keeps their
    beta at exactly 0; padded rows carry w == 0 and drop out of the
    moments, so bucketing is invisible to the estimate.
    """
    xa = _augment_b(xs) if intercept else xs
    g, b = ops.batched_gram(xa, w, y)
    beta = _fista_beta(g, b, w, reg=reg, intercept=intercept, n_iter=n_iter)
    return ops.batched_predict(xa, beta, valid)

"""Linear nuisance learners on batched masked fits.

Two entry points per family (learners/base.py registers both):

  shared-X form   fn(x (N,P), y (T,N), w (T,N), key) -> preds (T,N)
                  all T tasks share one dataset; w holds per-task training
                  weights (0 on the held-out fold).
  megabatch form  fn(xs (B,N,P), y (B,N), w (B,N), valid (B,N), keys)
                  -> preds (B,N) — every task carries its own (padded)
                  feature page, so one program serves tasks from many
                  requests/datasets at once (repro_torch/compile buckets).
                  ``valid`` marks real observation rows (0 = N-padding);
                  training weights are already 0 on padded rows, and
                  predictions on padded rows are returned as exactly 0.

Fits are fused across tasks: the batch dimension is written out.  The
shared-X normal equations come from the ``crossfit_gram`` kernel (one
launch for all T tasks, one read of X per block of tasks), the megabatch
ones from ``batched_gram``, and megabatch predictions from
``batched_predict`` (kernels/ops.py).  The shared-X predictions (one
matrix product), the batched Cholesky solve, FISTA's small products and
the logistic family's IRLS steps are PyTorch library calls, as the JAX
package leaves them to XLA.

A shared-X learner runs where its tensors lie; operands that are not
tensors go to the card, so on a machine without one they raise.

Nothing here synchronises with the device: the status of the Cholesky
factorisations (and of the LU solves of sharding/gram.py) is kept on the
device and read only by ``solve_failures``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.runtime import default_device

F32 = torch.float32

# device -> running maximum of the factorisations' ``info`` (0: every
# factorisation so far succeeded)
_solve_status: Dict[torch.device, torch.Tensor] = {}


def solve_failures(device) -> int:
    """Largest factorisation ``info`` seen on ``device`` since the last
    ``reset_solve_status`` (0 = all factorisations succeeded).  Reading
    it waits for the device; the fit path itself never does."""
    status = _solve_status.get(torch.device(device))
    return 0 if status is None else int(status.item())


def reset_solve_status() -> None:
    _solve_status.clear()


def on_one_device(*arrays):
    """The operands as tensors on one device: where the first lies when it
    is a tensor, else on the card (which raises where there is none)."""
    first = arrays[0]
    dev = first.device if isinstance(first, torch.Tensor) \
        else default_device()
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def _shared_operands(x, y, w):
    """x (N,P), y and w (T,N) as contiguous float32 tensors on one device,
    what ``ops.crossfit_gram`` takes."""
    return tuple(a.to(F32).contiguous() for a in on_one_device(x, y, w))


def _augment(x):
    """Add intercept column: (N,P) -> (N,P+1)."""
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=1)


def _augment_b(xs):
    """Add intercept column to every task page: (B,N,P) -> (B,N,P+1)."""
    ones = torch.ones(xs.shape[:2] + (1,), dtype=xs.dtype, device=xs.device)
    return torch.cat([xs, ones], dim=-1)


def _note_solve_status(info, live=None) -> None:
    """Fold a batched factorisation's ``info`` (B,) into the device's
    running maximum, counting only the ``live`` lanes when given."""
    worst = (info if live is None else info * live.to(info.dtype)).max()
    prev = _solve_status.get(info.device)
    _solve_status[info.device] = worst if prev is None \
        else torch.maximum(prev, worst)


def _solve_spd(g, b, live=None):
    """Batched SPD solve via Cholesky: g (B,P,P), b (B,P) -> (B,P).

    ``cholesky_ex`` neither raises nor synchronises; a factorisation that
    fails yields NaN coefficients, as the reference's does.  ``live``
    (B,) marks the lanes whose failure counts in ``solve_failures``: a
    launch's padding lanes (no valid row, G = reg*I) may legitimately
    fail — in float32 the intercept fix-up leaves an exact 0 on their
    diagonal — and nothing ever reads them."""
    chol, info = torch.linalg.cholesky_ex(g)
    _note_solve_status(info, live)
    beta = torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)
    beta = beta.masked_fill(info.ne(0).unsqueeze(-1), float("nan"))
    return beta.contiguous()


def ridge_fit_predict(x, y, w, key=None, *, reg: float = 1.0,
                      intercept: bool = True):
    """Closed-form (weighted) ridge for all T tasks in one fused pass: one
    ``crossfit_gram`` launch, one batched Cholesky solve, one matrix
    product for the predictions."""
    x, y, w = _shared_operands(x, y, w)
    xa = _augment(x) if intercept else x
    g, b = ops.crossfit_gram(xa, w, y, reg=float(reg))
    if intercept and reg:
        # keep the intercept unpenalized: two adds in the reference's
        # order (the megabatch form makes one, and in f32 they differ)
        p = xa.shape[1]
        g[:, p - 1, p - 1] += -float(reg)
        g[:, p - 1, p - 1] += 1e-8
    beta = _solve_spd(g, b, live=w.ne(0).any(dim=1))
    return torch.matmul(beta, xa.T)                          # (T, N)


def ols_fit_predict(x, y, w, key=None, *, intercept: bool = True):
    return ridge_fit_predict(x, y, w, key, reg=1e-8, intercept=intercept)


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


def lasso_fit_predict(x, y, w, key=None, *, reg: float = 0.01,
                      n_iter: int = 200, intercept: bool = True):
    """FISTA on the weighted lasso for all T tasks; fixed iteration count.

    reg is the l1 penalty on standardized features, per-observation scale.
    """
    x, y, w = _shared_operands(x, y, w)
    xa = _augment(x) if intercept else x
    g, b = ops.crossfit_gram(xa, w, y)                       # (T,P,P),(T,P)
    beta = _fista_beta(g, b, w, reg=reg, intercept=intercept, n_iter=n_iter)
    return torch.matmul(beta, xa.T)                          # (T, N)


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


def _irls_beta(xa, y, w, live, *, reg: float, n_iter: int):
    """Weighted l2-regularized logistic regression by ``n_iter`` Newton
    steps on per-task pages xa (B,N,P) — for a shared X a broadcast view.
    Each step is the reference's: mu = sigmoid(X beta), curvature
    s = w mu (1 - mu) + 1e-6, gradient X'(w (mu - y)) + reg beta, Hessian
    X' diag(s) X + reg I, and an SPD solve (batched Cholesky, as
    ``solve(..., assume_a="pos")``; NaN on a lane whose factorisation
    fails).  The factorisations' status is folded into ``solve_failures``
    once, for the ``live`` lanes, and never read here."""
    b_dim, _, p = xa.shape
    beta = torch.zeros((b_dim, p), dtype=F32, device=xa.device)
    eye = torch.eye(p, dtype=F32, device=xa.device) * reg
    worst = None
    for _ in range(n_iter):
        mu = torch.sigmoid(torch.bmm(xa, beta.unsqueeze(-1)).squeeze(-1))
        s = w * mu * (1.0 - mu) + 1e-6
        grad = torch.bmm(xa.mT, (w * (mu - y)).unsqueeze(-1)).squeeze(-1) \
            + reg * beta
        hess = torch.bmm((xa * s.unsqueeze(-1)).mT, xa) + eye
        chol, info = torch.linalg.cholesky_ex(hess)
        delta = torch.cholesky_solve(grad.unsqueeze(-1), chol).squeeze(-1)
        beta = beta - delta.masked_fill(info.ne(0).unsqueeze(-1),
                                        float("nan"))
        worst = info if worst is None else torch.maximum(worst, info)
    if worst is not None:
        _note_solve_status(worst, live)
    return beta


def logistic_fit_predict(x, y, w, key=None, *, reg: float = 1.0,
                         n_iter: int = 32, intercept: bool = True):
    """Weighted l2-regularized logistic regression via Newton steps (IRLS
    with a fixed step count), all T tasks batched.  Returns
    probabilities."""
    x, y, w = _shared_operands(x, y, w)
    xa = _augment(x) if intercept else x
    t = w.shape[0]
    beta = _irls_beta(xa.expand(t, *xa.shape), y, w, w.ne(0).any(dim=1),
                      reg=reg, n_iter=n_iter)
    return torch.sigmoid(torch.matmul(beta, xa.T))           # (T, N)


def logistic_batched_fit_predict(xs, y, w, valid, keys=None, *,
                                 reg: float = 1.0, n_iter: int = 32,
                                 intercept: bool = True):
    """Megabatch IRLS logistic: per-task Newton solves on per-task pages.

    The s-smoothing term (1e-6) adds a vanishing curvature on padded rows
    and the l2 penalty keeps padded-lane betas near 0; predictions on
    padded rows are masked to exactly 0 on return.
    """
    xa = _augment_b(xs) if intercept else xs
    beta = _irls_beta(xa, y, w, valid.ne(0).any(dim=1), reg=reg,
                      n_iter=n_iter)
    probs = torch.sigmoid(torch.bmm(xa, beta.unsqueeze(-1)).squeeze(-1))
    return probs * valid

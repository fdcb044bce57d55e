"""MLP nuisance learner: every task trains its own small MLP with Adam for
a fixed number of full-batch steps, all tasks as one batched computation
on (T, ., .) parameter tensors.

The initial weights come from the task's key through JAX's stream
(``repro_torch.threefry``: ``split``, then ``normal * sqrt(2 / fan_in)``),
so they are the reference's to a few ulps.  Tasks share nothing, so the
gradient of the sum of their losses is each task's own gradient
(``torch.autograd.grad``).  The hidden layers use the tanh form of GELU,
the standardization ``ddof=0``, Adam's bias correction ``i + 1.0`` in
float32, as the reference does.  Every product is a PyTorch library call,
as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import threefry
from repro_torch.learners.linear import on_one_device

F32 = torch.float32


def _init_mlp(keys: torch.Tensor, p: int, hidden: Tuple[int, ...]
              ) -> List[torch.Tensor]:
    """[w_1, b_1, w_2, b_2, ...] for keys (T, 2): w (T, a, b), b (T, b)."""
    dims = (p,) + tuple(hidden) + (1,)
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        pair = threefry.split(keys)                  # (T, 2, 2)
        keys, k = pair[:, 0], pair[:, 1]
        scale = float(np.float32(np.sqrt(2.0 / a)))
        params.append(threefry.normal(k, (a, b)) * scale)
        params.append(torch.zeros((keys.shape[0], b), dtype=F32,
                                  device=keys.device))
    return params


def _fwd(params: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (N, P) or (T, N, P) -> (T, N)."""
    h = x
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = torch.matmul(h, params[2 * i]) + params[2 * i + 1].unsqueeze(-2)
        if i < n_layers - 1:
            h = torch.nn.functional.gelu(h, approximate="tanh")
    return h[..., 0]


def _train(xs, y, w, keys, hidden, lr: float, n_steps: int,
           classify: bool) -> torch.Tensor:
    """Train T MLPs on standardized features xs ((N, P) shared or
    (T, N, P)), targets and weights (T, N); predictions (T, N)."""
    params = _init_mlp(keys, xs.shape[-1], tuple(hidden))
    m = [torch.zeros_like(q) for q in params]
    v = [torch.zeros_like(q) for q in params]
    denom = torch.clamp_min(w.sum(-1), 1.0)

    def loss(params):
        pred = _fwd(params, xs)
        if classify:
            ll = w * (torch.logaddexp(pred, torch.zeros_like(pred))
                      - y * pred)
        else:
            ll = w * (pred - y) ** 2
        return (ll.sum(-1) / denom).sum()

    one = np.float32(1.0)
    for i in range(n_steps):
        params = [q.requires_grad_(True) for q in params]
        with torch.enable_grad():
            g = torch.autograd.grad(loss(params), params)
        with torch.no_grad():
            params = [q.detach() for q in params]
            m = torch._foreach_add(torch._foreach_mul(m, 0.9),
                                   torch._foreach_mul(g, 0.1))
            v = torch._foreach_add(torch._foreach_mul(v, 0.999),
                                   torch._foreach_mul(
                                       torch._foreach_mul(g, 0.001), g))
            t = np.float32(i + 1.0)
            bc1 = float(one - np.float32(0.9) ** t)
            bc2 = float(one - np.float32(0.999) ** t)
            step = torch._foreach_mul(torch._foreach_div(m, bc1), lr)
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(v, bc2)), 1e-8)
            params = torch._foreach_sub(params,
                                        torch._foreach_div(step, den))
    with torch.no_grad():
        pred = _fwd(params, xs)
    return torch.sigmoid(pred) if classify else pred


def mlp_fit_predict(x, y, w, key, *, hidden=(64, 64), lr: float = 3e-3,
                    n_steps: int = 300, classify: bool = False):
    """Shared-X form: x (N, P); y, w (T, N) -> preds (T, N).  Task t's key
    is ``split(key, T)[t]``."""
    x, y, w = on_one_device(x, y, w)
    x = x.to(F32)
    mu = x.mean(0)
    sd = torch.sqrt(((x - mu) ** 2).mean(0)) + 1e-8
    xs = (x - mu) / sd
    keys = threefry.split(threefry.key_data(key).to(x.device), y.shape[0])
    return _train(xs, y.to(F32), w.to(F32), keys, hidden, lr, n_steps,
                  classify)


def mlp_batched_fit_predict(xs, y, w, valid, keys, *, hidden=(64, 64),
                            lr: float = 3e-3, n_steps: int = 300,
                            classify: bool = False):
    """Megabatch form: every task trains on its own (padded) feature page.

    Standardization uses masked moments over the valid rows only, so
    padding rows (zero features, zero weight) never shift mu/sd, and they
    stay exactly 0; predictions on them are exactly 0.
    """
    x1 = xs.to(F32)
    v1 = valid.to(F32).unsqueeze(-1)
    nv = torch.clamp_min(v1.sum(-2), 1.0)                    # (B, 1)
    mu = (x1 * v1).sum(-2) / nv
    var = (v1 * (x1 - mu.unsqueeze(-2)) ** 2).sum(-2) / nv
    sd = torch.sqrt(var) + 1e-8
    x1 = (x1 - mu.unsqueeze(-2)) / sd.unsqueeze(-2) * v1
    pred = _train(x1, y.to(F32), w.to(F32), threefry.key_data(keys),
                  hidden, lr, n_steps, classify)
    return pred * valid.to(F32)

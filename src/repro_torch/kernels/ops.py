"""Public wrappers of the megabatch kernels.

Routing is by where the tensors lie, and by nothing else: tensors on a
CUDA device go through the hand-written kernel (a build or a launch that
fails raises), tensors on the CPU — which a caller has to ask for —
through the kernel's plain PyTorch version.  All operands of one call lie
on one device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import megabatch
from repro_torch.kernels.megabatch import check_operand, check_xs

F32 = torch.float32


def batched_gram(xs, w, y, reg: float = 0.0):
    """Per-task masked normal equations with per-task features.

    xs: (B, N, P); w/y: (B, N), float32 contiguous.  Returns
    G (B,P,P) f32 = X_b' diag(w_b) X_b + reg*I and b (B,P) f32 =
    X_b'(w_b*y_b).  ``reg*I`` is added after the kernel, as the reference
    wrapper adds it.
    """
    b, n, p = check_xs(xs)
    check_operand("w", w, (b, n), xs)
    check_operand("y", y, (b, n), xs)
    if xs.is_cuda:
        g, bv = megabatch.batched_gram_cuda(xs, w, y)
    else:
        g, bv = megabatch.batched_gram_plain(xs, w, y)
    if reg:
        g = g + reg * torch.eye(p, dtype=F32, device=xs.device)
    return g, bv


def batched_predict(xs, beta, valid):
    """Masked per-task GEMV epilogue: valid_b * (X_b @ beta_b).

    xs: (B, N, P); beta: (B, P); valid: (B, N) -> (B, N) f32 with padding
    rows exactly 0.
    """
    b, n, p = check_xs(xs)
    check_operand("beta", beta, (b, p), xs)
    check_operand("valid", valid, (b, n), xs)
    if xs.is_cuda:
        return megabatch.batched_predict_cuda(xs, beta, valid)
    return megabatch.batched_predict_plain(xs, beta, valid)

"""Public wrappers of the Gram, predict, attention and SSD-scan kernels.

Routing is by where the tensors lie, and by nothing else: tensors on a
CUDA device go through the hand-written kernel (a build or a launch that
fails raises), tensors on the CPU — which a caller has to ask for —
through the kernel's plain PyTorch version.  All operands of one call lie
on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import crossfit_gram as crossfit_gram_mod
from repro_torch.kernels import flash_attention as flash_attention_mod
from repro_torch.kernels import megabatch
from repro_torch.kernels import ssd_scan as ssd_scan_mod
from repro_torch.kernels.crossfit_gram import check_task_rows
from repro_torch.kernels.megabatch import check_operand, check_xc, check_xs

F32 = torch.float32


def crossfit_gram(x, w, y, reg: float = 0.0):
    """Batched masked normal equations over one shared feature matrix.

    x: (N, P); w/y: (T, N), float32 contiguous.  Returns G (T,P,P) f32 =
    X' diag(w_t) X + reg*I and b (T,P) f32 = X'(w_t*y_t).  ``reg*I`` is
    added after the kernel, as the reference wrapper adds it.
    """
    _, _, p = check_task_rows(x, w, y)
    if x.is_cuda:
        g, bv = crossfit_gram_mod.crossfit_gram_cuda(x, w, y)
    else:
        g, bv = crossfit_gram_mod.crossfit_gram_plain(x, w, y)
    if reg:
        g = g + reg * torch.eye(p, dtype=F32, device=x.device)
    return g, bv


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


# Blocked-Gram parity tiers.  For families whose fit is a pure function of
# the Gram statistics (X'X, X'y), the streaming Gram is batched_gram on the
# merged rows, so results are bitwise equal at any chunking; for families
# whose iterations re-reduce per-row activations there is a tolerance tier
# instead.  (Only the first set is ported so far.)
BLOCKED_GRAM_BITWISE_FAMILIES = frozenset({"ols", "ridge", "lasso"})
BLOCKED_GRAM_TOLERANCE_FAMILIES = frozenset(
    {"logistic", "kernel_ridge", "mlp"})


def chunk_tall_n(xs, w, y, chunk_rows: int):
    """Split a tall (B, N, P) task batch into (B, C, Nc, P) N-chunks for
    the streaming blocked Gram.

    A ragged tail (N % chunk_rows != 0) is padded with zero rows of
    weight 0, which the Gram treats as exact no-ops; that pad is the only
    copy made.  Otherwise a pure relayout (views), no arithmetic.
    """
    b, n, p = xs.shape
    nc = int(chunk_rows)
    pad = (-n) % nc
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    c = (n + pad) // nc
    return (xs.reshape(b, c, nc, p), w.reshape(b, c, nc),
            y.reshape(b, c, nc))


def batched_gram_blocked(xc, w, y, reg: float = 0.0):
    """Streaming blocked Gram: per-task normal equations accumulated over
    pre-chunked N.

    xc: (B, C, Nc, P); w/y: (B, C, Nc), float32 contiguous.  Returns
    G (B,P,P) f32 and b (B,P) f32 — the contract of ``batched_gram`` on
    the merged (B, C*Nc, P) tensor.  ``reg*I`` is added after the kernel.
    """
    b, c, nc, p = check_xc(xc)
    check_operand("w", w, (b, c, nc), xc)
    check_operand("y", y, (b, c, nc), xc)
    if xc.is_cuda:
        g, bv = megabatch.batched_gram_blocked_cuda(xc, w, y)
    else:
        g, bv = megabatch.batched_gram_blocked_plain(xc, w, y)
    if reg:
        g = g + reg * torch.eye(p, dtype=F32, device=xc.device)
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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Forward attention over folded heads: q (BH, Sq, D), k/v (BH, Skv,
    D), float32 or bfloat16, queries aligned to the keys' suffix.  Returns
    (BH, Sq, D) in q's type."""
    flash_attention_mod.check_qkv(q, k, v, window)
    if q.is_cuda:
        return flash_attention_mod.flash_attention_cuda(
            q, k, v, causal=causal, window=window)
    return flash_attention_mod.flash_attention_plain(
        q, k, v, causal=causal, window=window)


def ssd_scan(xbar, la, bm, cm, *, chunk: int = 256, heads: int = 1):
    """Mamba-2 SSD scan: xbar (BH, S, P), la (BH, S), bm/cm (BH / heads,
    S, N), float32.  Returns (y (BH, S, P), final state (BH, N, P)).  The
    plain version steps through time; ``chunk`` is the kernel's tiling and
    does not change the function."""
    ssd_scan_mod.check_ssd(xbar, la, bm, cm, chunk, heads)
    if xbar.is_cuda:
        return ssd_scan_mod.ssd_scan_cuda(xbar, la, bm, cm, chunk=chunk,
                                          heads=heads)
    return ssd_scan_mod.ssd_scan_plain(xbar, la, bm, cm, heads=heads)

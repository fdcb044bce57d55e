"""The shared-X cross-fit Gram kernel, beside its plain PyTorch version.

``crossfit_gram_cuda`` replaces the TPU kernel ``crossfit_gram_pallas``
(body ``_kernel``) of the JAX package's ``kernels/crossfit_gram.py``: the
T = M*K*L cross-fit tasks of one request share one feature matrix and
differ only in their weights (0/1 fold masks) and targets, so the
per-task normal equations

    G_t = X' diag(w_t) X,   b_t = X'(w_t * y_t)

are accumulated for a block of tasks in one pass over X.  That is the
paper's technique as compute: one read of an X tile serves a block of
tasks, where K1 (``batched_gram``) on X broadcast to (T, N, P) reads X
once per task.  At the paper's shape (T 1000, N 5099, P 18 with the
intercept) the function moves 42.5 MB and does 2.0 GFLOP: bound by
operations on an H100 (0.030 ms at 67 TFLOP/s plain float32, against
0.013 ms for the bytes); K1 on the broadcast tensor would read 367 MB.

The kernel (``crossfit_gram_kernel`` in ``csrc/megabatch.cu``) is built
from K1's parts: one thread block per (1-4 quads of tasks, 32x32 tile pair
of the upper triangle) walks N in K1's 64-row steps, stages a step's X
columns in shared memory once for all its tasks, and gives each thread
K1's 4x4 register tile for a quad of four tasks, fed by the same loads of
X.  Only the 4x4 sub-tiles that meet the upper triangle of G get threads
(15 of 64 at the paper's P 18), and a block whose tasks end at T = 1
multiplies out one task.  Per task every element is summed in K1's order,
so the result is bitwise K1 on ``x.expand(T, N, P)``.  No TF32, no
atomics, N never split across blocks; G comes out exactly symmetric, and
rows with ``w == 0`` add exact zeros.  Any T, N and P: the ragged edges
are masked in the kernel, with no padding in the wrapper (the TPU
kernel's 128-lane P, 8-task and 512-row padding was that machine's
layout).  On an H100 it runs at 8x its operations bound at the paper's
shape, bound by instruction latency with one warp per scheduler (PERF.md).

``crossfit_gram_cuda`` adds one to ``runtime.launch_counts
["crossfit_gram"]`` where it launches, and nowhere else.
``crossfit_gram_plain`` is what the CPU path and the on-card comparison
use; nothing on the main path calls it for tensors that lie on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import build
from repro_torch.kernels.megabatch import check_operand

F32 = torch.float32
_MAX_GRID_Y = 65535


def crossfit_gram_plain(x, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N,P); w, y (T,N) -> (G (T,P,P) f32, b (T,P) f32)."""
    xf, wf, yf = x.to(F32), w.to(F32), y.to(F32)
    g = torch.einsum("np,tn,nq->tpq", xf, wf, xf)
    b = torch.einsum("tn,np->tp", wf * yf, xf)
    return g, b


def check_task_rows(x, w, y) -> Tuple[int, int, int]:
    """(T, N, P) of a shared-X call — x (N, P), w and y (T, N), float32
    contiguous on one device — or raise."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2 or min(x.shape) < 1:
        raise ValueError("x: expected a non-empty (N, P) torch.Tensor")
    check_operand("x", x, x.shape, x)
    n, p = x.shape
    if not isinstance(w, torch.Tensor) or w.dim() != 2 or w.shape[0] < 1:
        raise ValueError("w: expected a non-empty (T, N) torch.Tensor")
    t = int(w.shape[0])
    check_operand("w", w, (t, n), x)
    check_operand("y", y, (t, n), x)
    return t, n, p


def crossfit_gram_cuda(x, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the shared-X Gram kernel on CUDA tensors (contiguous
    float32): x (N, P), w and y (T, N)."""
    t, n, p = check_task_rows(x, w, y)
    if not x.is_cuda:
        raise ValueError(f"x: the CUDA kernels take tensors on the card, "
                         f"got {x.device}")
    n_tiles = -(-p // 32)
    # row indices (plus a 64-row step) are 32-bit ints in the kernel
    if n * p >= 2 ** 31 or n_tiles * (n_tiles + 1) // 2 > _MAX_GRID_Y:
        raise ValueError(f"crossfit_gram: shape (T {t}, N {n}, P {p}) "
                         "exceeds the kernel's launch limits")
    lib = build.load_library("megabatch")
    with torch.cuda.device(x.device):
        g = torch.empty((t, p, p), dtype=F32, device=x.device)
        bv = torch.empty((t, p), dtype=F32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["crossfit_gram"] += 1
        code = lib.repro_crossfit_gram(x.data_ptr(), w.data_ptr(),
                                       y.data_ptr(), g.data_ptr(),
                                       bv.data_ptr(), t, n, p, stream)
    build.check_launch(lib, code, "crossfit_gram")
    return g, bv

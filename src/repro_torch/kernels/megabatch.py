"""The three megabatch kernels, each beside its plain PyTorch version.

The megabatch compiler (repro_torch/compile) stacks tasks from different
requests — hence different datasets — into one ``(B, N, P)`` tensor, so
every task carries its own feature page.  Three kernels cover the linear
learners' hot path; all are CUDA C++ in ``csrc/megabatch.cu``.

``batched_gram_cuda``
    replaces the TPU kernel ``batched_gram_pallas`` (body ``_gram_kernel``)
    of the JAX package's ``kernels/megabatch.py``: per-task masked normal
    equations ``G_b = X_b' diag(w_b) X_b``, ``b_b = X_b'(w_b * y_b)``.
    It does P/2 float32 operations per byte of X it reads; an H100 does
    about 20 plain float32 operations in the time it reads one byte
    (67 TFLOP/s over 3.35 TB/s).  So at the paper's block shape
    (B 32, N 5104, P 33) it is bound by bytes, and wide pages (P in the
    hundreds) are bound by operations.  In practice a thread block is
    bound by its own load/store pipe long before either, so the design
    issues few loads and stores: one block per (task, 32x32 tile of the
    upper triangle) stages 64 rows of raw X at a time in shared memory,
    loads the step's weights once, keeps a 4x4 register tile per thread,
    and prefetches the next rows into registers without a branch.  The N
    loop runs inside the block (where the TPU kernel walked a sequential
    grid axis with the output block resident); N is never split across
    blocks and no atomics are used, so each output element has one fixed
    accumulation order, whatever the launch's batch size.  Only the
    upper triangle of tiles is computed and mirrored, so ``G`` is exactly
    symmetric.  Rows with ``w == 0`` contribute exact zeros.

``batched_gram_blocked_cuda``
    replaces ``batched_gram_blocked_pallas`` (body
    ``_gram_blocked_kernel``): the same normal equations over N streamed
    as C chunks of Nc rows, ``xc (B, C, Nc, P)``, for the tall buckets
    of the data-parallel layout (sharding/gram.py), whose N exceeds one
    device page.  Its bound and design are batched_gram's: the kernel
    runs the same block body (one block per (task, tile), 64-row steps,
    4x4 register tiles, four row groups added in a fixed order), with
    the N walk made ``for chunk: for step in chunk``.  The accumulator
    persists across chunks, as the TPU kernel's output block persisted
    across its (c, j) grid; the prefetch of the next step crosses chunk
    boundaries; each chunk's ragged last step is masked at row Nc.  When
    Nc is a multiple of the 64-row step the steps are those of
    batched_gram on the merged ``(B, C*Nc, P)`` tensor, so the result is
    bitwise batched_gram's; otherwise it is within batched_gram's
    tolerance of the plain version.

``batched_predict_cuda``
    replaces ``batched_predict_pallas`` (body ``_predict_kernel``): the
    masked GEMV epilogue ``valid_b * (X_b beta_b)``.  Bound by bytes (two
    operations per four bytes read), so the design keeps bytes in flight:
    a block stages the contiguous span of X its rows occupy into shared
    memory with 16-byte loads, four in flight a thread (a scalar head and
    tail where the span is not 16-byte aligned), then each row is summed
    by a group of 1-32 threads chosen from P alone, in one fixed order per
    output element, and multiplied by ``valid`` last so padding rows come
    out exactly 0.  P is at most 28672 (one row and ``beta_b`` in a
    block's shared memory).

The TPU kernels' 128-lane padding of P, 8-sublane padding of B and
``block_n`` padding of N were that machine's layout, not the contract:
these kernels take the true ``(B, N, P)`` and mask the ragged edges.

Each ``*_cuda`` wrapper adds one to its entry of ``runtime.launch_counts``
where it launches, and nowhere else.  The ``*_plain`` versions are what
the CPU path and the on-card comparison use; nothing on the main path
calls them for tensors that lie on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import build

F32 = torch.float32
_MAX_GRID_Y = 65535
_MAX_PREDICT_P = 28672                 # a row and beta_b in one block's smem


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def batched_gram_plain(xs, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B,N,P); w, y (B,N) -> (G (B,P,P) f32, b (B,P) f32)."""
    xf, wf, yf = xs.to(F32), w.to(F32), y.to(F32)
    g = torch.einsum("bnp,bn,bnq->bpq", xf, wf, xf)
    b = torch.einsum("bn,bnp->bp", wf * yf, xf)
    return g, b


def batched_gram_blocked_plain(xc, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc (B,C,Nc,P); w, y (B,C,Nc) -> batched_gram_plain on the merged
    (B, C*Nc, P) view: merging the chunk axis is a relayout, no
    arithmetic."""
    b, c, nc, p = xc.shape
    return batched_gram_plain(xc.reshape(b, c * nc, p),
                              w.reshape(b, c * nc), y.reshape(b, c * nc))


def batched_predict_plain(xs, beta, valid) -> torch.Tensor:
    """xs (B,N,P); beta (B,P); valid (B,N) -> valid * (X beta), (B,N) f32."""
    pred = torch.einsum("bnp,bp->bn", xs.to(F32), beta.to(F32))
    return pred * valid.to(F32)


# ---------------------------------------------------------------------------
# operand checks (shared with kernels/ops.py)
# ---------------------------------------------------------------------------
def check_xs(xs) -> Tuple[int, int, int]:
    """(B, N, P) of a float32 contiguous feature batch, or raise."""
    if not isinstance(xs, torch.Tensor) or xs.dim() != 3 \
            or min(xs.shape) < 1:
        raise ValueError("xs: expected a non-empty (B, N, P) torch.Tensor")
    check_operand("xs", xs, xs.shape, xs)
    return tuple(xs.shape)


def check_xc(xc) -> Tuple[int, int, int, int]:
    """(B, C, Nc, P) of a float32 contiguous chunked feature batch, or
    raise."""
    if not isinstance(xc, torch.Tensor) or xc.dim() != 4 \
            or min(xc.shape) < 1:
        raise ValueError("xc: expected a non-empty (B, C, Nc, P) "
                         "torch.Tensor")
    check_operand("xc", xc, xc.shape, xc)
    return tuple(xc.shape)


def check_operand(name: str, t, shape, xs: torch.Tensor) -> None:
    """Raise unless ``t`` is a float32 contiguous tensor of ``shape`` on
    the device of ``xs`` — what the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != xs.device:
        raise ValueError(f"{name}: lies on {t.device}, xs on {xs.device}")
    if t.dtype != F32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _check_launchable(xs: torch.Tensor) -> Tuple[int, int, int]:
    b, n, p = check_xs(xs)
    _check_on_card_within_limits("xs", xs, b, n, p)
    return b, n, p


def _check_on_card_within_limits(name: str, t: torch.Tensor, b: int,
                                 rows: int, p: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernels take tensors on the "
                         f"card, got {t.device}")
    # row indices (plus a 64-row step) are 32-bit ints in the kernels
    if b > _MAX_GRID_Y or max(rows, p) >= 2 ** 31 - 64:
        raise ValueError(f"{name}: shape {tuple(t.shape)} exceeds the "
                         "kernels' launch limits")


def batched_gram_cuda(xs, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Gram kernel on CUDA tensors (contiguous float32)."""
    b, n, p = _check_launchable(xs)
    check_operand("w", w, (b, n), xs)
    check_operand("y", y, (b, n), xs)
    lib = build.load_library("megabatch")
    with torch.cuda.device(xs.device):
        g = torch.empty((b, p, p), dtype=F32, device=xs.device)
        bv = torch.empty((b, p), dtype=F32, device=xs.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["batched_gram"] += 1
        code = lib.repro_batched_gram(xs.data_ptr(), w.data_ptr(),
                                      y.data_ptr(), g.data_ptr(),
                                      bv.data_ptr(), b, n, p, stream)
    build.check_launch(lib, code, "batched_gram")
    return g, bv


def batched_gram_blocked_cuda(xc, w, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the streaming Gram kernel on CUDA tensors (contiguous
    float32): xc (B, C, Nc, P), w and y (B, C, Nc)."""
    b, c, nc, p = check_xc(xc)
    _check_on_card_within_limits("xc", xc, b, c * nc, p)
    check_operand("w", w, (b, c, nc), xc)
    check_operand("y", y, (b, c, nc), xc)
    lib = build.load_library("megabatch")
    with torch.cuda.device(xc.device):
        g = torch.empty((b, p, p), dtype=F32, device=xc.device)
        bv = torch.empty((b, p), dtype=F32, device=xc.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["batched_gram_blocked"] += 1
        code = lib.repro_batched_gram_blocked(xc.data_ptr(), w.data_ptr(),
                                              y.data_ptr(), g.data_ptr(),
                                              bv.data_ptr(), b, c, nc, p,
                                              stream)
    build.check_launch(lib, code, "batched_gram_blocked")
    return g, bv


def batched_predict_cuda(xs, beta, valid) -> torch.Tensor:
    """Launch the predict kernel on CUDA tensors (contiguous float32)."""
    b, n, p = _check_launchable(xs)
    if p > _MAX_PREDICT_P:
        raise ValueError(f"batched_predict: P={p} exceeds the kernel's "
                         f"shared-memory limit of {_MAX_PREDICT_P} columns")
    check_operand("beta", beta, (b, p), xs)
    check_operand("valid", valid, (b, n), xs)
    lib = build.load_library("megabatch")
    with torch.cuda.device(xs.device):
        out = torch.empty((b, n), dtype=F32, device=xs.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["batched_predict"] += 1
        code = lib.repro_batched_predict(xs.data_ptr(), beta.data_ptr(),
                                         valid.data_ptr(), out.data_ptr(),
                                         b, n, p, stream)
    build.check_launch(lib, code, "batched_predict")
    return out

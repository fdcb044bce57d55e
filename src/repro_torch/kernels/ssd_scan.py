"""The Mamba-2 SSD chunked scan (K6), beside its plain PyTorch version.

``ssd_scan_cuda`` replaces the TPU kernel ``ssd_scan_pallas`` (body
``_kernel``) of the JAX package's ``kernels/ssd_scan.py``: for each of BH
lanes (batch rows times heads) the linear recurrence

    S_t = exp(la_t) S_{t-1} + bm_t xbar_t^T,    y_t = cm_t . S_t

with an (N, P) state, computed chunk by chunk as Dao & Gu's SSD: per chunk
of Q rows, ``cl = cumsum(la)``, ``W = tril(C B^T * exp(clip(cl_i - cl_j,
-60, 0)))``, ``y = W x + exp(cl) * (C S)`` and ``S <- exp(cl_Q) S + (B *
exp(cl_Q - cl))^T x``.  It also writes the final state (BH, N, P), which
the reference wrapper recomputed with its sequential oracle.  ``bm`` and
``cm`` (BH / heads, S, N) are shared by the ``heads`` consecutive lanes of
one batch row, as Mamba-2 shares them across heads (n_groups 1): the
kernel reads row ``lane // heads``, so nothing is broadcast in memory.

The kernel (``ssd_scan_kernel`` in ``csrc/lm.cu``) is the simple first
version: one block per lane walks the chunks in order with the state in
shared memory, 64-row sub-tiles for the scores and products, plain
float32 FMA (TF32 stays off).  At the serve path's (448, 2048, 64, 64,
Q 256, heads 112) call the function needs 5 N P operations a row and
lane, 18.8 GFLOP, and moves 485 MB: bound by operations, 0.28 ms at 67
TFLOP/s (PERF.md has its time).  Any S (a ragged
last chunk is masked in the kernel), N and P up to 64, Q up to 256.

``ssd_scan_cuda`` adds one to ``runtime.launch_counts["ssd_scan"]`` where
it launches, and nowhere else.  ``ssd_scan_plain`` is the sequential
recurrence of the reference oracle ``ssd_scan_ref``: what the CPU path and
the on-card comparison use.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import build

F32 = torch.float32
MAX_NP = 64
MAX_CHUNK = 256


def ssd_scan_plain(xbar, la, bm, cm, *, heads: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xbar (BH,S,P); la (BH,S); bm/cm (BH/heads,S,N) -> y (BH,S,P) f32
    and the final state (BH,N,P) f32, one time step after another."""
    bh, s, p = xbar.shape
    n = bm.shape[-1]
    g = bh // heads
    x4 = xbar.to(F32).reshape(g, heads, s, p)
    a3 = la.to(F32).reshape(g, heads, s)
    b3, c3 = bm.to(F32), cm.to(F32)
    state = torch.zeros((g, heads, n, p), dtype=F32, device=xbar.device)
    ys = []
    for t in range(s):
        state = state * torch.exp(a3[:, :, t])[..., None, None] \
            + b3[:, None, t, :, None] * x4[:, :, t, None, :]
        ys.append(torch.einsum("gn,ghnp->ghp", c3[:, t], state))
    y = torch.stack(ys, dim=2).reshape(bh, s, p)
    return y, state.reshape(bh, n, p)


def check_ssd(xbar, la, bm, cm, chunk: int, heads: int
              ) -> Tuple[int, int, int, int]:
    """(BH, S, P, N) of an SSD scan — float32 contiguous xbar (BH, S, P),
    la (BH, S), bm and cm (BH / heads, S, N) on one device — or raise."""
    for name, t in (("xbar", xbar), ("la", la), ("bm", bm), ("cm", cm)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
        if t.dtype != F32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != xbar.device:
            raise ValueError(f"{name}: lies on {t.device}, xbar on "
                             f"{xbar.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if xbar.dim() != 3 or min(xbar.shape) < 1:
        raise ValueError("xbar: expected a non-empty (BH, S, P) tensor")
    bh, s, p = xbar.shape
    heads = int(heads)
    if heads < 1 or bh % heads:
        raise ValueError(f"heads: {heads} does not divide BH {bh}")
    if tuple(la.shape) != (bh, s):
        raise ValueError(f"la: expected ({bh}, {s}), got {tuple(la.shape)}")
    if bm.dim() != 3 or bm.shape[-1] < 1:
        raise ValueError("bm: expected a (BH / heads, S, N) tensor")
    n = bm.shape[-1]
    for name, t in (("bm", bm), ("cm", cm)):
        if tuple(t.shape) != (bh // heads, s, n):
            raise ValueError(f"{name}: expected ({bh // heads}, {s}, {n}), "
                             f"got {tuple(t.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"chunk: expected >= 1, got {chunk}")
    return bh, s, p, n


def ssd_scan_cuda(xbar, la, bm, cm, *, chunk: int = 256, heads: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD scan kernel on CUDA tensors."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    if not xbar.is_cuda:
        raise ValueError(f"xbar: the CUDA kernels take tensors on the card, "
                         f"got {xbar.device}")
    q = min(int(chunk), s)
    if max(n, p) > MAX_NP or q > MAX_CHUNK or s * max(n, p) >= 2 ** 31:
        raise ValueError(f"ssd_scan: shape (BH {bh}, S {s}, P {p}, N {n}, "
                         f"chunk {chunk}) exceeds the kernel's limits "
                         f"(N, P <= {MAX_NP}, chunk <= {MAX_CHUNK})")
    lib = build.load_library("lm")
    with torch.cuda.device(xbar.device):
        y = torch.empty((bh, s, p), dtype=F32, device=xbar.device)
        state = torch.empty((bh, n, p), dtype=F32, device=xbar.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["ssd_scan"] += 1
        code = lib.repro_ssd_scan(
            xbar.data_ptr(), la.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), bh, s, p, n, q, int(heads),
            stream)
    build.check_launch(lib, code, "ssd_scan")
    return y, state

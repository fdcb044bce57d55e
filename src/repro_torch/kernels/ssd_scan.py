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

The kernels (``csrc/lm.cu``) run the chunks in parallel by state passing,
in four launches a call: (a) ``ssd_scores_kernel``, the scores C B^T of
each (batch row, chunk), once for all ``heads`` lanes of the row, into an
L2-resident scratch (BH / heads, S / Q, Qp, Qp), Qp = Q rounded up to 64;
(b) ``ssd_states_kernel``, each (lane, chunk)'s own state (B * exp(cl_Q -
cl))^T x into (BH, S / Q, N, P) and its decay exp(cl_Q) into (BH, S / Q);
(c) ``ssd_pass_kernel``, per lane in chunk order, the state entering each
chunk, written over (b)'s scratch, and the final state; (d)
``ssd_out_kernel``, per (lane, chunk, 128-row tile), ``y = exp(cl) * (C S)
+ W x``.  Every product runs on the tensor cores (``mma.sync`` m16n8k8
TF32) with each float32 operand split into a TF32 hi and lo part, three
passes summed in float32: float32 grade, with TF32 mode left off.  W is
formed and decayed in float32; the cumsum, the decays and the state
passing are float32 FMA.  At the serve path's (448, 2048, 64, 64, Q 256,
heads 112) call the function needs 5 N P operations a row and lane, 18.8
GFLOP, and moves 485 MB: bound by bytes, 0.145 ms at 3.35 TB/s, against
0.114 ms for the operations at the TF32 rate over three passes (0.28 ms at
the 67 TFLOP/s FMA rate).  The schedule does about 34 GFLOP (the
square-in-chunk products) and moves the chunks' states through device
memory four times (written, passed in place, read back), about 235 MB
(PERF.md has its time).  Any S (a ragged last chunk is masked in the
kernels), N and P up to 64, Q up to 256, any BH while the outputs' grid
of BH ceil(S / Q) ceil(Qp / 128) blocks stays under 2^31
(``check_kernel_shape``); the wrapper allocates the scratch
(``scratch_shapes``) with ``torch.empty``.

``ssd_scan_cuda`` adds one to ``runtime.launch_counts["ssd_scan"]`` where
it launches (once a call, for its four kernel launches), and nowhere
else.  ``ssd_scan_plain`` is the sequential recurrence of the reference
oracle ``ssd_scan_ref``: what the CPU path and the on-card comparison
use.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import runtime
from repro_torch.kernels import build

F32 = torch.float32
MAX_NP = 64
MAX_CHUNK = 256
SUB_TILE = 64             # the kernels' sub-tile: a chunk's rows pad to it
OUT_TILE = 128            # rows of the outputs kernel's tile


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


def scratch_shapes(bh: int, s: int, p: int, n: int, chunk: int, heads: int
                   ) -> Tuple[Tuple[int, ...], ...]:
    """Shapes of the kernels' float32 scratch: the scores (BH / heads,
    chunks, Qp, Qp), the chunks' states (BH, chunks, N, P) and their decays
    (BH, chunks), with Q = min(chunk, S) and Qp = Q rounded up to 64."""
    q = min(int(chunk), s)
    nc = -(-s // q)
    qp = -(-q // SUB_TILE) * SUB_TILE
    return (bh // heads, nc, qp, qp), (bh, nc, n, p), (bh, nc)


def check_kernel_shape(bh: int, s: int, p: int, n: int, chunk: int) -> None:
    """Raise ``ValueError`` naming the limit when the kernels do not take a
    (BH, S, P, N) scan in chunks of ``chunk`` rows."""
    q = min(int(chunk), s)
    blocks = bh * -(-s // q) * -(-q // OUT_TILE)
    if max(n, p) > MAX_NP or q > MAX_CHUNK or s * max(n, p) >= 2 ** 31 \
            or blocks >= 2 ** 31:
        raise ValueError(f"ssd_scan: shape (BH {bh}, S {s}, P {p}, N {n}, "
                         f"chunk {chunk}) exceeds the kernels' limits "
                         f"(N, P <= {MAX_NP}, chunk <= {MAX_CHUNK}, "
                         f"S * max(N, P) < 2**31, BH * ceil(S / chunk) * "
                         f"ceil(chunk / {OUT_TILE}) < 2**31)")


def ssd_scan_cuda(xbar, la, bm, cm, *, chunk: int = 256, heads: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD scan's kernels on CUDA tensors."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    if not xbar.is_cuda:
        raise ValueError(f"xbar: the CUDA kernels take tensors on the card, "
                         f"got {xbar.device}")
    check_kernel_shape(bh, s, p, n, chunk)
    q = min(int(chunk), s)
    lib = build.load_library("lm")
    with torch.cuda.device(xbar.device):
        y = torch.empty((bh, s, p), dtype=F32, device=xbar.device)
        state = torch.empty((bh, n, p), dtype=F32, device=xbar.device)
        cb, states, decay = (
            torch.empty(shape, dtype=F32, device=xbar.device)
            for shape in scratch_shapes(bh, s, p, n, q, heads))
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["ssd_scan"] += 1
        code = lib.repro_ssd_scan(
            xbar.data_ptr(), la.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), cb.data_ptr(),
            states.data_ptr(), decay.data_ptr(), bh, s, p, n, q,
            int(heads), stream)
    build.check_launch(lib, code, "ssd_scan")
    return y, state

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
L2-resident scratch (BH / heads, S / Q, Qp, Qp), Qp = Q rounded up to 64,
over N in 64-deep slices; (b) ``ssd_states_kernel``, each (lane, chunk,
64 x 64 tile of the state)'s own state (B * exp(cl_Q - cl))^T x into (BH,
S / Q, N, P) and its decay exp(cl_Q) into (BH, S / Q); (c)
``ssd_pass_kernel``, per lane in chunk order, the state entering each
chunk, written over (b)'s scratch, and the final state; (d)
``ssd_out_kernel``, per (lane, chunk, 128-row tile, 64 columns of P),
``y = exp(cl) * (C S) + W x``, C S over N in 32-deep slices.  Every
product runs on the tensor cores (``mma.sync`` m16n8k8 TF32) with each
float32 operand split into a TF32 hi and lo part, three passes summed in
float32: float32 grade, with TF32 mode left off.  W is formed and decayed
in float32; the cumsum, the decays and the state passing are float32 FMA.
The state's P columns evolve independently, so P past 64 is a grid index
of (b) and (d) in 64-column tiles, and N past 64 one of (b) in 64-row
tiles; where N, P <= 64 the grids hold one tile and every sum runs in the
single-tile order.

At the serve path's (448, 2048, 64, 64, Q 256, heads 112) call the
function needs 5 N P operations a row and lane, 18.8 GFLOP, and moves 485
MB: bound by bytes, 0.145 ms at 3.35 TB/s, against 0.114 ms for the
operations at the TF32 rate over three passes (0.28 ms at the 67 TFLOP/s
FMA rate).  The schedule does about 34 GFLOP (the square-in-chunk
products) and moves the chunks' states through device memory four times
(written, passed in place, read back), about 235 MB.  At xlstm-350m's
mLSTM (BH 16, S 2048, N 512, P 513, Q 256, heads 1: the key depth as N,
the value depth plus the normalizer column as P) the function needs 43.0
GFLOP and moves about 285 MB: bound by operations, 0.26 ms at the TF32
rate over three passes (0.64 ms at the FMA rate); its chunk states
scratch is (16, 8, 512, 513) float32, 134 MB, and P 513 is odd, so its
operands take the 4-byte copies (PERF.md has the times).  Any S (a ragged
last chunk is masked in the kernels), Q up to 256, N P up to 65535 * 256
state entries in at most 65535 64 x 64 tiles, any BH while the outputs'
grid of BH ceil(S / Q) ceil(Qp / 128) blocks stays under 2^31
(``check_kernel_shape``); the wrapper allocates the scratch
(``scratch_shapes``) with ``torch.empty``.

``ssd_scan_cuda`` adds one to ``runtime.launch_counts["ssd_scan"]`` where
it launches (once a call, for its four kernel launches), and nowhere
else.  With grad mode on and an input that requires a gradient it goes
through ``SsdScanFunction``, whose forward keeps the scores, the chunk
states and their decays that the four launches leave in their scratch,
and whose backward is ``ssd_scan_bwd_cuda`` (``csrc/ssd_bwd.cu``, its own
library: four launches a call, one count in
``runtime.launch_counts["ssd_scan_bwd"]``; wgmma on operand tiles that
TMA or 4-byte cp.async bring in and producer warps split into three bf16
parts, dS kept on chip, the heads' dB and dC summed by ``HEAD_GROUPS``
head groups inside the kernels); that route checks the backward's shape
limits (``check_backward_shape``) before the forward launches.
``ssd_scan_plain`` is the sequential recurrence of the reference oracle
``ssd_scan_ref``: what the CPU path and the on-card
comparison use; autograd through it is the CPU route's gradient.
``ssd_scan_chunked_plain`` is the reference's chunked ``ssd_chunked`` on
the kernels' lanes, in the inputs' type: ``ssd_scan_backward_plain``
(autograd through it, float64 on the card) is the yardstick of the
backward kernels at the path shapes, where the sequential form would keep
thousands of states for autograd.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) the same route
takes shape-only stand-ins of the forward's and the backward's launches
(ops of their own, ``repro_torch::ssd_scan_meta`` and
``ssd_scan_bwd_meta``), which launch and count nothing: their outputs
have the kernels' shapes, their operations for
``torch.utils.flop_counter`` are the function's, 5 N P a row and lane
forward and 11 N P backward, and the wrapper allocates the scratch the
card's would (``scratch_shapes``, ``bwd_scratch_shapes``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch import runtime
from repro_torch.kernels import build

F32 = torch.float32
MAX_CHUNK = 256
SUB_TILE = 64             # the kernels' sub-tile: a chunk's rows pad to it,
                          # and the state's N and P tile by it
OUT_TILE = 128            # rows of the outputs kernel's tile
MAX_GRID_Y = 65535        # (b)'s state tiles, (c)'s blocks of entries
PASS_BLOCK = 256          # state entries of one (c) block
HEAD_GROUPS = 8           # the backward's head groups (csrc/ssd_bwd.cu)
SUM_BLOCKS = 2 ** 20      # the backward's last launch: its group-sum blocks


def ssd_scan_plain(xbar, la, bm, cm, *, heads: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xbar (BH,S,P); la (BH,S); bm/cm (BH/heads,S,N) -> y (BH,S,P) f32
    and the final state (BH,N,P) f32 (float64 for float64 inputs), one
    time step after another."""
    bh, s, p = xbar.shape
    n = bm.shape[-1]
    g = bh // heads
    dt = torch.float64 if xbar.dtype == torch.float64 else F32
    x4 = xbar.to(dt).reshape(g, heads, s, p)
    a3 = la.to(dt).reshape(g, heads, s)
    b3, c3 = bm.to(dt), cm.to(dt)
    state = torch.zeros((g, heads, n, p), dtype=dt, device=xbar.device)
    ys = []
    for t in range(s):
        state = state * torch.exp(a3[:, :, t])[..., None, None] \
            + b3[:, None, t, :, None] * x4[:, :, t, None, :]
        ys.append(torch.einsum("gn,ghnp->ghp", c3[:, t], state))
    y = torch.stack(ys, dim=2).reshape(bh, s, p)
    return y, state.reshape(bh, n, p)


def ssd_scan_chunked_plain(xbar, la, bm, cm, *, chunk: int, heads: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan as the reference's ``ssd_chunked`` computes it, on the
    kernels' lanes and in the inputs' type: per chunk of ``chunk`` rows
    (S padded with rows that leave the state as it is), y = W x + exp(cl)
    * (C S) and S <- exp(cl_Q) S + (B * exp(cl_Q - cl))' x.  Returns y
    (BH, S, P) and the final state (BH, N, P)."""
    bh, s, p = xbar.shape
    n = bm.shape[-1]
    g = bh // heads
    q = min(int(chunk), s)
    pad = -s % q
    x = F.pad(xbar.reshape(g, heads, s, p), (0, 0, 0, pad))
    a = F.pad(la.reshape(g, heads, s), (0, pad))
    b, c = (F.pad(t, (0, 0, 0, pad)) for t in (bm, cm))
    causal = torch.ones((q, q), dtype=torch.bool, device=xbar.device).tril()
    state = torch.zeros((g, heads, n, p), dtype=xbar.dtype,
                        device=xbar.device)
    ys = []
    for c0 in range(0, s + pad, q):
        xc, cl = x[:, :, c0:c0 + q], torch.cumsum(a[:, :, c0:c0 + q], dim=-1)
        bc, cc = b[:, c0:c0 + q], c[:, c0:c0 + q]
        lmat = torch.exp(torch.clamp(cl[..., :, None] - cl[..., None, :],
                                     -60.0, 0.0))
        w = torch.where(causal, torch.einsum("gin,gjn->gij", cc, bc)[:, None]
                        * lmat, torch.zeros((), dtype=xbar.dtype,
                                            device=xbar.device))
        ys.append(torch.einsum("ghij,ghjp->ghip", w, xc)
                  + torch.exp(cl)[..., None]
                  * torch.einsum("gin,ghnp->ghip", cc, state))
        tail = torch.exp(cl[..., -1:] - cl)
        state = torch.einsum("gjn,ghjp,ghj->ghnp", bc, xc, tail) \
            + state * torch.exp(cl[..., -1])[..., None, None]
    y = torch.cat(ys, dim=2)[:, :, :s].reshape(bh, s, p)
    return y, state.reshape(bh, n, p)


def ssd_scan_backward_plain(xbar, la, bm, cm, dy, dstate=None, *,
                            chunk: int, heads: int = 1, chunked: bool = True):
    """The plain backward: autograd through the plain forward
    (``ssd_scan_chunked_plain`` in the inputs' type, or with ``chunked``
    False the sequential ``ssd_scan_plain``) — (dxbar, dla, dbm, dcm) from
    the output's gradient ``dy`` and the final state's ``dstate`` (None:
    zero)."""
    leaves = [t.detach().requires_grad_(True) for t in (xbar, la, bm, cm)]
    with torch.enable_grad():
        if chunked:
            y, state = ssd_scan_chunked_plain(*leaves, chunk=chunk,
                                              heads=heads)
        else:
            y, state = ssd_scan_plain(*leaves, heads=heads)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


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
    tiles = -(-n // SUB_TILE) * -(-p // SUB_TILE)
    if q > MAX_CHUNK or s * max(n, p) >= 2 ** 31 or blocks >= 2 ** 31 \
            or tiles > MAX_GRID_Y or n * p > MAX_GRID_Y * PASS_BLOCK:
        raise ValueError(f"ssd_scan: shape (BH {bh}, S {s}, P {p}, N {n}, "
                         f"chunk {chunk}) exceeds the kernels' limits "
                         f"(chunk <= {MAX_CHUNK}, ceil(N / {SUB_TILE}) * "
                         f"ceil(P / {SUB_TILE}) <= {MAX_GRID_Y}, N * P <= "
                         f"{MAX_GRID_Y * PASS_BLOCK}, S * max(N, P) < "
                         f"2**31, BH * ceil(S / chunk) * ceil(chunk / "
                         f"{OUT_TILE}) < 2**31)")


def head_groups(heads: int) -> Tuple[int, int]:
    """(heads a group, groups) of the backward's blocks: at most
    ``HEAD_GROUPS`` groups of ceil(heads / HEAD_GROUPS) heads, the last one
    short where they do not divide."""
    per = -(-int(heads) // HEAD_GROUPS)
    return per, -(-int(heads) // per)


def check_backward_shape(bh: int, s: int, p: int, n: int, chunk: int
                         ) -> None:
    """Raise ``ValueError`` naming the limit when the backward kernels do
    not take a (BH, S, P, N) scan in chunks of ``chunk`` rows: the
    forward's limits, and the backward's grids under 2**31 blocks: BH *
    ceil(S / Q) * ceil(N / 64) * ceil(P / 64) state tiles, and BH *
    ceil(S / Q) + 2**20 blocks of the last launch (the band blocks'
    grid, at most BH * ceil(S / Q), is under both)."""
    check_kernel_shape(bh, s, p, n, chunk)
    q = min(int(chunk), s)
    items = bh * -(-s // q)
    ntn, npt = -(-n // SUB_TILE), -(-p // SUB_TILE)
    if items * ntn * npt >= 2 ** 31 or items + SUM_BLOCKS >= 2 ** 31:
        raise ValueError(f"ssd_scan backward: shape (BH {bh}, S {s}, P {p}, "
                         f"N {n}, chunk {chunk}) exceeds the backward "
                         f"kernels' limits (BH * ceil(S / chunk) * ceil(N / "
                         f"{SUB_TILE}) * ceil(P / {SUB_TILE}) < 2**31, BH * "
                         f"ceil(S / chunk) + {SUM_BLOCKS} < 2**31)")


def bwd_scratch_shapes(bh: int, s: int, p: int, n: int, chunk: int,
                       heads: int):
    """Shapes of the backward kernels' float32 scratch: the gradients of
    the states leaving the chunks (BH, chunks, N, P), the row parts of d
    cumsum(la) (BH, S, 2 + 2 ceil(N / 64)), then the head groups' partial
    dB and dC (BH / heads, groups, S, N) where heads > 1 (else None: the
    kernels write dbm and dcm)."""
    q = min(int(chunk), s)
    nc = -(-s // q)
    parts = 2 + 2 * -(-n // SUB_TILE)
    group = (bh // heads, head_groups(heads)[1], s, n) if heads > 1 \
        else None
    return (bh, nc, n, p), (bh, s, parts), group, group


def _check_on_card(xbar) -> None:
    if not xbar.is_cuda:
        raise ValueError(f"xbar: the CUDA kernels take tensors on the card, "
                         f"got {xbar.device}")


def _forward_cuda(xbar, la, bm, cm, chunk: int, heads: int):
    """Launch the four forward kernels: y, the final state, and the
    scratch they leave (the scores, the state entering each chunk and the
    chunks' decays), which the backward reads."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    _check_on_card(xbar)
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
    return y, state, cb, states, decay


@torch.library.custom_op("repro_torch::ssd_scan_meta", mutates_args=())
def _forward_meta_op(xbar: torch.Tensor, la: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor, chunk: int, heads: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    raise ValueError("the forward's shape-only stand-in takes meta tensors")


@_forward_meta_op.register_fake
def _(xbar, la, bm, cm, chunk, heads):
    bh, _, p = xbar.shape
    return torch.empty_like(xbar), xbar.new_empty((bh, bm.shape[-1], p))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_meta)
def _forward_flops(xbar, la, bm, cm, chunk, heads, *args, **kwargs):
    bh, s, p = xbar
    return bh * s * 5 * bm[-1] * p


@torch.library.custom_op("repro_torch::ssd_scan_bwd_meta", mutates_args=())
def _backward_meta_op(xbar: torch.Tensor, la: torch.Tensor,
                      bm: torch.Tensor, cm: torch.Tensor, cb: torch.Tensor,
                      states: torch.Tensor, decay: torch.Tensor,
                      dy: torch.Tensor, dstate: Optional[torch.Tensor],
                      chunk: int, heads: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    raise ValueError("the backward's shape-only stand-in takes meta tensors")


@_backward_meta_op.register_fake
def _(xbar, la, bm, cm, cb, states, decay, dy, dstate, chunk, heads):
    return tuple(torch.empty_like(t) for t in (xbar, la, bm, cm))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd_meta)
def _backward_flops(xbar, la, bm, *args, **kwargs):
    bh, s, p = xbar
    return bh * s * 11 * bm[-1] * p


def _forward_meta(xbar, la, bm, cm, chunk: int, heads: int):
    """The forward's launches on meta tensors: the card's checks and
    scratch, then the shape-only stand-in (no launch, no count)."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    check_kernel_shape(bh, s, p, n, chunk)
    q = min(int(chunk), s)
    cb, states, decay = (torch.empty(shape, dtype=F32, device=xbar.device)
                         for shape in scratch_shapes(bh, s, p, n, q, heads))
    y, state = _forward_meta_op(xbar, la, bm, cm, q, int(heads))
    return y, state, cb, states, decay


def _backward_meta(xbar, la, bm, cm, cb, states, decay, dy, dstate, *,
                   chunk: int, heads: int):
    """The backward's launches on meta tensors: the card's checks and
    scratch, then the shape-only stand-in."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    check_backward_shape(bh, s, p, n, chunk)
    q = min(int(chunk), s)
    # held through the stand-in's call, as the card's through the launch
    scratch = [torch.empty(shape, dtype=F32, device=xbar.device)
               for shape in bwd_scratch_shapes(bh, s, p, n, q, heads)
               if shape is not None]
    return _backward_meta_op(xbar, la, bm, cm, cb, states, decay, dy,
                             dstate, q, int(heads))


def ssd_scan_bwd_cuda(xbar, la, bm, cm, cb, states, decay, dy, dstate, *,
                      chunk: int, heads: int):
    """Launch the backward kernels on CUDA tensors: (dxbar, dla, dbm, dcm)
    in the shapes of xbar, la, bm, cm, from the forward's operands and the
    scratch its launches left (``cb``, ``states``, ``decay``:
    ``scratch_shapes``), the output's gradient ``dy`` (BH, S, P) and the
    final state's ``dstate`` (BH, N, P; None: zero).  dbm and dcm are
    summed over the ``heads`` lanes that share them."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    q = min(int(chunk), s)
    want = dict(zip(("cb", "states", "decay"),
                    scratch_shapes(bh, s, p, n, q, heads)))
    want.update(dy=(bh, s, p), dstate=(bh, n, p))
    for name, t in (("cb", cb), ("states", states), ("decay", decay),
                    ("dy", dy), ("dstate", dstate)):
        if t is None and name == "dstate":
            continue
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != want[name] \
                or t.dtype != F32 or t.device != xbar.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor "
                             f"of shape {want[name]} on {xbar.device}")
    _check_on_card(xbar)
    check_backward_shape(bh, s, p, n, chunk)
    lib = build.load_library("ssd_bwd")
    with torch.cuda.device(xbar.device):
        dx, dla, dbm, dcm = (torch.empty_like(t) for t in (xbar, la, bm, cm))
        gst, parts, part_b, part_c = (
            None if shape is None
            else torch.empty(shape, dtype=F32, device=xbar.device)
            for shape in bwd_scratch_shapes(bh, s, p, n, q, heads))
        ptrs = [None if t is None else t.data_ptr() for t in (
            xbar, la, bm, cm, cb, states, decay, dy, dstate, dx, dla, dbm,
            dcm, gst, parts, part_b, part_c)]
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["ssd_scan_bwd"] += 1
        code = lib.repro_ssd_scan_bwd(*ptrs, bh, s, p, n, q, int(heads),
                                      stream)
    build.check_launch(lib, code, "ssd_scan_bwd")
    return dx, dla, dbm, dcm


class SsdScanFunction(torch.autograd.Function):
    """K6 with its hand-written gradient: the forward kernels, keeping
    the operands and the scores, chunk states and decays they leave; the
    backward kernels.  A gradient of y or of the final state that autograd
    passes as None counts as zero."""

    @staticmethod
    def forward(ctx, xbar, la, bm, cm, chunk: int, heads: int):
        forward = _forward_meta if xbar.is_meta else _forward_cuda
        y, state, cb, states, decay = forward(xbar, la, bm, cm, chunk, heads)
        ctx.save_for_backward(xbar, la, bm, cm, cb, states, decay)
        ctx.chunk, ctx.heads = chunk, heads
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xbar, la, bm, cm, cb, states, decay = ctx.saved_tensors
        dy = torch.zeros_like(xbar) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        backward = _backward_meta if xbar.is_meta else ssd_scan_bwd_cuda
        grads = backward(xbar, la, bm, cm, cb, states, decay, dy, dstate,
                         chunk=ctx.chunk, heads=ctx.heads)
        return (*grads, None, None)


def ssd_scan_cuda(xbar, la, bm, cm, *, chunk: int = 256, heads: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the SSD scan's kernels on CUDA tensors (on meta tensors,
    their shape-only stand-in); with grad mode on and an input that
    requires a gradient, through ``SsdScanFunction`` (the backward
    kernels then give it)."""
    bh, s, p, n = check_ssd(xbar, la, bm, cm, chunk, heads)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbar, la, bm, cm)):
        check_backward_shape(bh, s, p, n, chunk)
        return SsdScanFunction.apply(xbar, la, bm, cm, chunk, heads)
    forward = _forward_meta if xbar.is_meta else _forward_cuda
    return forward(xbar, la, bm, cm, chunk, heads)[:2]

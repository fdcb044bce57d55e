"""Flash attention (K5) and its gradient, beside their plain PyTorch
versions.

``flash_attention_cuda`` replaces the TPU kernel ``flash_attention_pallas``
(body ``_kernel``) of the JAX package's ``kernels/flash_attention.py``:
softmax attention over heads folded into the leading axis, q (BH, Sq, D)
against k (BH, Skv, D) and v (BH, Skv, Dv), with queries aligned to the
keys' suffix (query i sits at position Skv - Sq + i, as every prefill
passes them), scaled by 1/sqrt(D), a causal
mask and an optional sliding window (a key is visible while
``q_pos - window < k_pos``).  Scores, the running max and sum and the
accumulator are float32; the output is in q's type.  Tiles that the mask
hides from every query of a block are skipped, so the windowed case costs
O(S * W).  v may be shallower than q and k (Dv < D): MLA's prefill folds
its rope channel into the head, D 192 against Dv 128 for deepseek-v2-lite;
the TPU kernel takes one depth, so there the reference's counterpart is
its ``attention_core``.

Two kernels in ``csrc/lm.cu``, chosen by the operands' type, both on the
tensor cores with ``mma.sync``, float32 accumulators, online softmax in
registers, 64-key K/V tiles copied by ``cp.async`` into a two-stage ring,
one block of 8 warps per (lane, 128-query tile), heaviest causal tiles
first.  bfloat16 operands (what the serve path passes) take
``flash_attention_tc_kernel``: m16n8k16 bf16 products, P split into bf16
hi + lo for P V so that every output stays within a bf16 step of the
float32 softmax.  At the serve path's (128, 2048, 112) causal call the
function does 120 GFLOP and moves 235 MB, so it is bound by operations:
0.12 ms at the card's 989 TFLOP/s bf16 rate.  It takes D and Dv % 8 == 0
and Sq <= Skv, or Sq > Skv where nothing is masked (not causal, no
window: cross-attention, whose queries see every key whatever their
alignment; at the VLM's (B 2 x 64 heads, Sq 2048, Skv 1601, D 128) call
the function does 215 GFLOP, 0.22 ms at the bf16 rate).  A causal or
windowed call with Sq > Skv raises: its first queries would see no key.
float32 operands take ``flash_attention_tf32_kernel``:
every operand (q, k, P, v) split into TF32 hi + lo, each product formed as
lo hi + hi lo + hi hi, three m16n8k8 TF32 passes into a float32
accumulator, which keeps a product within about 2^-21 of float32 (one TF32
rounding is 2^-11 off).  This is float32 grade, not a TF32 mode: the port
keeps TF32 off (``runtime.py``), and ``chip_smoke.py`` holds it within
2e-5 of the plain version.  It takes any D and Dv (zero-filled in shared
memory to a multiple of 16), any Sq and Skv, and any alignment of a float;
its bound at the serve shape is 0.73 ms (495 TFLOP/s TF32 over three
passes).  Both mask ragged tiles in the kernel.  Both are built for the
depth pairs (D, Dv), each rounded up to 16, of ``DEPTH_PAIRS``: equal
depths up to 128 (where D == Dv) and the MLA pairs of the port's configs;
other pairs raise.  PERF.md has their times.

The gradient (``FlashAttentionFunction``, a ``torch.autograd.Function``)
is hand-written too: the reference's Pallas kernel has no VJP (it
differentiates its jnp attention), and on the card the plain version may
not run on the main path.  ``flash_attention_cuda`` takes the Function
when grad mode is on and an input requires a gradient: its forward also
writes each row's float32 log-sum-exp (BH, Sq) and saves q, k, v, o and
that; its backward is ``flash_attention_bwd_cuda``: delta = rowsum(dO
o O), then dK and dV a key tile a block and dQ a query tile a block (no
atomics, so the same inputs give the same bits).  Both types take
``csrc/attn_bwd.cu``, a library of its own, in two CUDA launches (a
prologue; the dK/dV and the dQ blocks in one grid): wgmma products on
tiles that TMA loads into a two-stage ring fed by a producer warpgroup,
depths padded by the tensor maps to the classes (64, 64), (128, 128),
(192, 128).  bfloat16 operands (the training path's): the prologue is
delta, 128 keys a dK/dV block and 128 queries a dQ block, P' and dS'
rounded once to bf16.  float32 operands (the card-against-CPU checks):
every operand and P', dS' split into three bf16 parts and each product
taken in six passes (float32 grade, held within 2e-5 of the plain
backward); the prologue is delta and the parts of q, k, v and dO, written
into scratch this wrapper allocates (``f32_scratch_shapes``: (BH, 3, S, D
rounded up to 8) bf16 each), so the tensor maps read 16-byte rows at any
D and the float32 operands may sit anywhere; 128 own rows a block at (64,
64), 64 past it, and dq, dk, dv added in float32 every 512 walked rows
(plain stores).
Otherwise (the serve path, under inference mode) the forward writes o
alone, as it did before the backward existed.  The backward takes the
forward's masks and depth pairs, in both types under the bf16 kernel's
rule (a causal or windowed call needs Sq <= Skv; bf16 needs D, Dv % 8 ==
0 and every tensor on 16 bytes).  GQA's repeated heads reach the kernel
already repeated: autograd sums their gradients through
``models/layers.py``'s repeat.

``flash_attention_cuda`` adds one to ``runtime.launch_counts
["flash_attention"]`` where it launches the forward, and
``flash_attention_bwd_cuda`` one to ``["flash_attention_bwd"]``
where it launches the backward, and nowhere else.
``flash_attention_plain`` is the counterpart of the reference oracle
``flash_attention_ref``: what the CPU path and the on-card comparison use;
``flash_attention_backward_plain`` is the explicit gradient in float32
(float64 for float64 operands), used by the tests and by
``chip_smoke.py``'s comparison, never by the card's main path (on the CPU
autograd differentiates the plain forward).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import runtime
from repro_torch.kernels import build

F32 = torch.float32
# (D, Dv) rounded up to 16 that the kernels are built for (csrc/lm.cu,
# REPRO_FA_DEPTH_PAIRS): equal depths up to 128, and the MLA pairs of the
# port's configs — deepseek-v2-lite's (128 + 64, 128) and its reduced
# variant's (32 + 16, 32)
DEPTH_PAIRS = frozenset({(n, n) for n in range(16, 129, 16)}
                        | {(48, 32), (192, 128)})
_MAX_GRID_Y = 65535
_MAX_TC_SQ = 65535 * 128       # the bfloat16 kernel: grid y of 128-query tiles
_MAX_BWD_ROWS = 8 * (2 ** 31 - 1)  # the bf16 backward's delta: 8 rows a block
# the float32 backward's bf16 parts an operand (csrc/attn_bwd.cu)
SPLIT_PARTS = 3
_TYPES = (torch.float32, torch.bfloat16)


def visible(sq: int, skv: int, causal: bool, window: Optional[int],
            device) -> torch.Tensor:
    """(Sq, Skv) bool: the keys each query sees, queries aligned to the
    keys' suffix (query i at position Skv - Sq + i)."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def _scores(q, k, dtype):
    """Scaled scores q k' / sqrt(D) in ``dtype``."""
    return torch.einsum("bqd,bkd->bqk", q.to(dtype), k.to(dtype)) \
        / math.sqrt(q.shape[-1])


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """q, k (BH,S*,D); v (BH,Skv,Dv) -> (BH,Sq,Dv) in q's type: float32
    scores scaled by 1/sqrt(D), -inf where masked, softmax, float32
    product with v."""
    ok = visible(q.shape[1], k.shape[1], causal, window, q.device)
    s = _scores(q, k, F32).masked_fill(~ok[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(F32)).to(q.dtype)


def _plain_type(q) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else F32


def flash_attention_lse_plain(q, k, *, causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """(BH, Sq): each row's log-sum-exp of its visible scaled scores, in
    float32 (float64 for float64 operands) — what the kernel's forward
    saves for the backward."""
    ok = visible(q.shape[1], k.shape[1], causal, window, q.device)
    s = _scores(q, k, _plain_type(q)).masked_fill(~ok[None], float("-inf"))
    return torch.logsumexp(s, dim=-1)


def flash_attention_backward_plain(q, k, v, o, lse, do, *,
                                   causal: bool = True,
                                   window: Optional[int] = None):
    """(dq, dk, dv) of attention at q, k, v given its output o, row
    log-sum-exp ``lse`` and the output's gradient ``do``, by the explicit
    formula in float32 (float64 for float64 operands): P = exp(q k' /
    sqrt(D) - lse) where visible, dV = P' dO, dS = P o (dO v' - rowsum(dO
    o o)), dQ = dS k / sqrt(D), dK = dS' q / sqrt(D)."""
    ct = _plain_type(q)
    ok = visible(q.shape[1], k.shape[1], causal, window, q.device)
    c = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (t.to(ct) for t in (q, k, v, o, do))
    p = torch.exp(_scores(q, k, ct) - lse.to(ct)[..., None]) \
        .masked_fill(~ok[None], 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = (dof * of).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * c
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * c
    return dq, dk, dv


def check_qkv(q, k, v, window: Optional[int]):
    """(BH, Sq, Skv, D, Dv) of a flash-attention call — q (BH, Sq, D), k
    (BH, Skv, D) and v (BH, Skv, Dv) of one type (float32 or bfloat16),
    contiguous, on one device — or raise."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3 \
                or min(t.shape) < 1:
            raise ValueError(f"{name}: expected a non-empty (BH, S, D) "
                             "torch.Tensor")
        if t.dtype not in _TYPES:
            raise TypeError(f"{name}: expected float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    bh, sq, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (bh, skv, d) or tuple(v.shape) != (bh, skv, dv):
        raise ValueError(f"k, v: expected ({bh}, Skv, {d}) and ({bh}, Skv, "
                         f"Dv), got {tuple(k.shape)} and {tuple(v.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window: expected None or >= 1, got {window}")
    return bh, sq, skv, d, dv


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def check_kernel_shape(bh: int, sq: int, skv: int, d: int,
                       dtype: torch.dtype, dv: Optional[int] = None, *,
                       causal: bool = True,
                       window: Optional[int] = None) -> None:
    """Raise ``ValueError`` naming the limit when the kernel for ``dtype``
    does not take a (BH, Sq, Skv, D, Dv) call (``dv`` None: Dv = D) under
    its mask."""
    dv = d if dv is None else dv
    pair = (_pad16(d), _pad16(dv))
    if pair not in DEPTH_PAIRS or (pair[0] == pair[1] and d != dv) \
            or max(sq, skv) * max(d, dv) >= 2 ** 31:
        raise ValueError(f"flash_attention: shape (BH {bh}, Sq {sq}, "
                         f"Skv {skv}, D {d}, Dv {dv}) exceeds the kernels' "
                         f"limits ((D, Dv) rounded up to 16 among "
                         f"{sorted(DEPTH_PAIRS)}, D == Dv where those are "
                         f"equal, S * D < 2**31)")
    if dtype != torch.bfloat16:
        if bh > _MAX_GRID_Y:
            raise ValueError(f"flash_attention: the float32 kernel takes "
                             f"BH <= {_MAX_GRID_Y}, got {bh}")
        return
    masked = causal or window is not None
    if d % 8 or dv % 8 or (sq > skv and masked) or sq > _MAX_TC_SQ:
        raise ValueError(f"flash_attention: the bfloat16 kernel takes "
                         f"D % 8 == 0, Dv % 8 == 0 and Sq <= Skv unless "
                         f"nothing is masked, Sq <= {_MAX_TC_SQ}; got D "
                         f"{d}, Dv {dv}, Sq {sq}, Skv {skv}, causal "
                         f"{causal}, window {window}")


def check_backward_shape(bh: int, sq: int, skv: int, d: int,
                         dtype: torch.dtype, dv: Optional[int] = None, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> None:
    """Raise ``ValueError`` naming the limit when the backward kernels do
    not take a (BH, Sq, Skv, D, Dv) call: the forward's depth pairs, in
    both types the bf16 kernel's mask rule (Sq <= Skv unless nothing is
    masked), bf16 D, Dv % 8 == 0.  The grids' limits (``csrc/attn_bwd.cu``):
    bfloat16 (the dK/dV and dQ blocks on one grid's y) at most 65535
    128-row tiles of Sq and of Skv together, and BH Sq at most 8 (2**31 -
    1) rows (delta's launch, a warp a row); float32 puts the tiles on the
    grid's x (2**31 - 1 blocks, more than S * D < 2**31 allows) and the
    lanes on its y (the forward's BH <= 65535), so it takes every shape
    the forward takes."""
    dv = d if dv is None else dv
    check_kernel_shape(bh, sq, skv, d, dtype, dv, causal=causal,
                       window=window)
    masked = causal or window is not None
    ok, grid = True, ""
    if dtype == torch.bfloat16:
        tiles = -(-sq // 128) + -(-skv // 128)
        grid = (f", ceil(Sq / 128) + ceil(Skv / 128) <= {_MAX_GRID_Y}, "
                f"BH * Sq <= {_MAX_BWD_ROWS}")
        ok = tiles <= _MAX_GRID_Y and bh * sq <= _MAX_BWD_ROWS
    if (sq > skv and masked) or not ok:
        raise ValueError(f"flash_attention backward: takes Sq <= Skv "
                         f"unless nothing is masked{grid}; got BH {bh}, "
                         f"Sq {sq}, Skv {skv}, causal {causal}, window "
                         f"{window}")


def f32_scratch_shapes(bh: int, sq: int, skv: int, d: int, dv: int):
    """The shapes of the float32 backward's scratch parts of q, k, v and
    dO (bf16 each): (BH, 3, S, depth rounded up to 8), as
    ``repro_attn_bwd_f32`` reads them."""
    return [(bh, SPLIT_PARTS, n, -(-w // 8) * 8)
            for n, w in ((sq, d), (skv, d), (skv, dv), (sq, dv))]


def _check_on_card(*named):
    """Raise unless the (name, tensor) pairs lie on the card, and, in
    bfloat16, start on 16 bytes (the forward's cp.async chunks, the
    backward's tensor maps)."""
    q = named[0][1]
    if not q.is_cuda:
        raise ValueError(f"q: the CUDA kernels take tensors on the card, "
                         f"got {q.device}")
    if q.dtype == torch.bfloat16:
        for name, t in named:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the bfloat16 kernels need a "
                                 "16-byte aligned tensor")


def _forward_cuda(q, k, v, causal: bool, window: Optional[int],
                  with_lse: bool):
    """Launch the forward kernel: o, and each row's log-sum-exp (BH, Sq)
    float32 when ``with_lse`` (else None, and the kernel writes o
    alone)."""
    bh, sq, skv, d, dv = check_qkv(q, k, v, window)
    _check_on_card(("q", q), ("k", k), ("v", v))
    check_kernel_shape(bh, sq, skv, d, q.dtype, dv, causal=causal,
                       window=window)
    lib = build.load_library("lm")
    with torch.cuda.device(q.device):
        o = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
        lse = torch.empty((bh, sq), dtype=F32, device=q.device) \
            if with_lse else None
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["flash_attention"] += 1
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, sq, skv, d, dv,
            int(bool(causal)), -1 if window is None else int(window),
            1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    build.check_launch(lib, code, "flash_attention")
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *,
                                  causal: bool = True,
                                  window: Optional[int] = None):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv) in the
    shapes and type of q, k, v, from the forward's o and ``lse`` (BH, Sq)
    float32 and the output's gradient ``do`` (o's shape and type)."""
    bh, sq, skv, d, dv = check_qkv(q, k, v, window)
    for name, t, shape, dtype in (("o", o, (bh, sq, dv), q.dtype),
                                  ("do", do, (bh, sq, dv), q.dtype),
                                  ("lse", lse, (bh, sq), F32)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape \
                or t.dtype != dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} "
                             f"tensor of shape {shape} on {q.device}")
    _check_on_card(("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                   ("lse", lse))
    check_backward_shape(bh, sq, skv, d, q.dtype, dv, causal=causal,
                         window=window)
    lib = build.load_library("attn_bwd")
    with torch.cuda.device(q.device):
        delta = torch.empty((bh, sq), dtype=F32, device=q.device)
        dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
        ins = [t.data_ptr() for t in (q, k, v, o, lse, do, delta)]
        outs = [t.data_ptr() for t in (dq, dk, dvv)]
        sizes = (bh, sq, skv, d, dv, int(bool(causal)),
                 -1 if window is None else int(window), 1.0 / math.sqrt(d))
        if q.dtype == torch.bfloat16:
            entry, parts = lib.repro_attn_bwd, []
        else:
            entry = lib.repro_attn_bwd_f32
            parts = [torch.empty(shape, dtype=torch.bfloat16,
                                 device=q.device)
                     for shape in f32_scratch_shapes(bh, sq, skv, d, dv)]
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["flash_attention_bwd"] += 1
        code = entry(*ins, *(t.data_ptr() for t in parts), *outs, *sizes,
                     stream)
    build.check_launch(lib, code, "flash_attention_bwd")
    return dq, dk, dvv


class FlashAttentionFunction(torch.autograd.Function):
    """K5 with its hand-written gradient: the forward kernel (with the row
    log-sum-exp), the backward kernels.  Saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = _forward_cuda(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the flash-attention kernel for q's type on CUDA tensors;
    with grad mode on and an input that requires a gradient, through
    ``FlashAttentionFunction`` (the backward kernels then give it)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        bh, sq, skv, d, dv = check_qkv(q, k, v, window)
        check_backward_shape(bh, sq, skv, d, q.dtype, dv, causal=causal,
                             window=window)
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return _forward_cuda(q, k, v, causal, window, with_lse=False)[0]

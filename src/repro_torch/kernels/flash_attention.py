"""Forward flash attention (K5), beside its plain PyTorch version.

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

``flash_attention_cuda`` adds one to ``runtime.launch_counts
["flash_attention"]`` where it launches, and nowhere else.
``flash_attention_plain`` is the counterpart of the reference oracle
``flash_attention_ref``: what the CPU path and the on-card comparison use.
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
_TYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """q, k (BH,S*,D); v (BH,Skv,Dv) -> (BH,Sq,Dv) in q's type: float32
    scores scaled by 1/sqrt(D), -inf where masked, softmax, float32
    product with v."""
    _, sq, d = q.shape
    skv = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(F32), k.to(F32)) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(F32)).to(q.dtype)


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


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the flash-attention kernel for q's type on CUDA tensors."""
    bh, sq, skv, d, dv = check_qkv(q, k, v, window)
    if not q.is_cuda:
        raise ValueError(f"q: the CUDA kernels take tensors on the card, "
                         f"got {q.device}")
    check_kernel_shape(bh, sq, skv, d, q.dtype, dv, causal=causal,
                       window=window)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:      # cp.async copies 16-byte chunks
                raise ValueError(f"{name}: the bfloat16 kernel needs a "
                                 "16-byte aligned tensor")
    lib = build.load_library("lm")
    with torch.cuda.device(q.device):
        o = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["flash_attention"] += 1
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq,
            skv, d, dv, int(bool(causal)),
            -1 if window is None else int(window), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), stream)
    build.check_launch(lib, code, "flash_attention")
    return o

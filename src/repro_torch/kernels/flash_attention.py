"""Forward flash attention (K5), beside its plain PyTorch version.

``flash_attention_cuda`` replaces the TPU kernel ``flash_attention_pallas``
(body ``_kernel``) of the JAX package's ``kernels/flash_attention.py``:
softmax attention over heads folded into the leading axis, q (BH, Sq, D)
against k, v (BH, Skv, D), with queries aligned to the keys' suffix (query
i sits at position Skv - Sq + i, as every prefill passes them), a causal
mask and an optional sliding window (a key is visible while
``q_pos - window < k_pos``).  Scores, the running max and sum and the
accumulator are float32; the output is in q's type.  Tiles that the mask
hides from every query of a block are skipped, so the windowed case costs
O(S * W).

Two kernels in ``csrc/lm.cu``, chosen by the operands' type, both on the
tensor cores with ``mma.sync``, float32 accumulators, online softmax in
registers, 64-key K/V tiles copied by ``cp.async`` into a two-stage ring,
one block of 8 warps per (lane, 128-query tile), heaviest causal tiles
first.  bfloat16 operands (what the serve path passes) take
``flash_attention_tc_kernel``: m16n8k16 bf16 products, P split into bf16
hi + lo for P V so that every output stays within a bf16 step of the
float32 softmax.  At the serve path's (128, 2048, 112) causal call the
function does 120 GFLOP and moves 235 MB, so it is bound by operations:
0.12 ms at the card's 989 TFLOP/s bf16 rate.  It takes D % 8 == 0, D <=
128 and Sq <= Skv.  float32 operands take ``flash_attention_tf32_kernel``:
every operand (q, k, P, v) split into TF32 hi + lo, each product formed as
lo hi + hi lo + hi hi, three m16n8k8 TF32 passes into a float32
accumulator, which keeps a product within about 2^-21 of float32 (one TF32
rounding is 2^-11 off).  This is float32 grade, not a TF32 mode: the port
keeps TF32 off (``runtime.py``), and ``chip_smoke.py`` holds it within
2e-5 of the plain version.  It takes any D <= 128 (zero-filled in shared
memory to a multiple of 16), any Sq and Skv, and any alignment of a float;
its bound at the serve shape is 0.73 ms (495 TFLOP/s TF32 over three
passes).  Both mask ragged tiles in the kernel.  PERF.md has their times.

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
MAX_D = 128
_MAX_GRID_Y = 65535
_MAX_TC_SQ = 65535 * 128       # the bfloat16 kernel: grid y of 128-query tiles
_TYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """q (BH,Sq,D); k/v (BH,Skv,D) -> (BH,Sq,D) in q's type: float32
    scores, -inf where masked, softmax, float32 product with v."""
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
    """(BH, Sq, Skv, D) of a flash-attention call — q (BH, Sq, D), k and v
    (BH, Skv, D) of one type (float32 or bfloat16), contiguous, on one
    device — or raise."""
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
    skv = k.shape[1]
    if tuple(k.shape) != (bh, skv, d) or tuple(v.shape) != (bh, skv, d):
        raise ValueError(f"k, v: expected ({bh}, Skv, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window: expected None or >= 1, got {window}")
    return bh, sq, skv, d


def check_kernel_shape(bh: int, sq: int, skv: int, d: int,
                       dtype: torch.dtype) -> None:
    """Raise ``ValueError`` naming the limit when the kernel for ``dtype``
    does not take a (BH, Sq, Skv, D) call."""
    if d > MAX_D or max(sq, skv) * d >= 2 ** 31:
        raise ValueError(f"flash_attention: shape (BH {bh}, Sq {sq}, "
                         f"Skv {skv}, D {d}) exceeds the kernels' limits "
                         f"(D <= {MAX_D}, S * D < 2**31)")
    if dtype != torch.bfloat16:
        if bh > _MAX_GRID_Y:
            raise ValueError(f"flash_attention: the float32 kernel takes "
                             f"BH <= {_MAX_GRID_Y}, got {bh}")
        return
    if d % 8 or sq > skv or sq > _MAX_TC_SQ:
        raise ValueError(f"flash_attention: the bfloat16 kernel takes "
                         f"D % 8 == 0 and Sq <= Skv, Sq <= "
                         f"{_MAX_TC_SQ}; got D {d}, Sq {sq}, "
                         f"Skv {skv}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the flash-attention kernel for q's type on CUDA tensors."""
    bh, sq, skv, d = check_qkv(q, k, v, window)
    if not q.is_cuda:
        raise ValueError(f"q: the CUDA kernels take tensors on the card, "
                         f"got {q.device}")
    check_kernel_shape(bh, sq, skv, d, q.dtype)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:      # cp.async copies 16-byte chunks
                raise ValueError(f"{name}: the bfloat16 kernel needs a "
                                 "16-byte aligned tensor")
    lib = build.load_library("lm")
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        runtime.launch_counts["flash_attention"] += 1
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq,
            skv, d, int(bool(causal)), -1 if window is None else int(window),
            1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    build.check_launch(lib, code, "flash_attention")
    return o

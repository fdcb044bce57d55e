"""Shared neural-net layers of the port: norms, RoPE, the GLU MLP and GQA
attention with its KV cache — the parts the hybrid (zamba2) family runs.

All functions are pure functions of tensors, apart from ``attn_decode``,
which writes the step's keys and values into the cache it is given (the
reference donates that buffer).  Parameters come in as trees of tensors
built from the ``PDecl`` trees below.  Activations are in the parameters'
type (bf16 as declared) with float32 softmax and norm statistics.

Attention routes by where its tensors lie.  On the card ``attn_forward``
folds the heads into the leading axis and calls the hand-written flash
attention kernel (``kernels.ops.flash_attention``), whose contract is the
one every prefill in the repo passes: queries at positions ``arange(S)``
(``positions=None``), aligned to the keys' suffix; positions given as a
tensor raise there.  On the
CPU it calls :func:`attention_core`, the reference's chunked online-softmax
math ported line for line, which the CPU tests hold against the JAX
package.  Decode attention has no kernel in the reference and runs as
plain PyTorch on either device.

The reference's sharding ``rules`` argument and ``logical_constraint``
calls are dropped: on one card they are no-ops.  MLA, cross-attention,
``layer_norm`` and ``sinusoidal_pos`` are not ported yet (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.param import PDecl

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms / activations / MLP
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    """Statistics in float32, applied in the input's type."""
    var = torch.mean(torch.square(x.to(F32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_decls(d_model: int, d_ff: int, glu: bool) -> Dict[str, PDecl]:
    if glu:
        return {
            "wi": PDecl((d_model, 2, d_ff), ("embed", None, "ff")),
            "wo": PDecl((d_ff, d_model), ("ff", "embed")),
        }
    return {
        "wi": PDecl((d_model, d_ff), ("embed", "ff")),
        "wo": PDecl((d_ff, d_model), ("ff", "embed")),
    }


def mlp_forward(p, x, act: str, glu: bool):
    if glu:
        wi = p["wi"]
        uv = (x @ wi.reshape(wi.shape[0], -1)).unflatten(-1, wi.shape[1:])
        u, v = uv[..., 0, :], uv[..., 1, :]
        h = act_fn(act)(u) * v
    else:
        h = act_fn(act)(x @ p["wi"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, n_heads, head_dim); positions: (..., seq).  Split
    halves (not interleaved)."""
    hd = x.shape[-1]
    inv = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    ang = positions[..., None].to(F32) * inv              # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------
def _repeat_kv(k, hq: int):
    """(B, S, Hk, D) -> (B, S, Hq, D): GQA KV replication along heads."""
    hk = k.shape[2]
    if hk == hq:
        return k
    return torch.repeat_interleave(k, hq // hk, dim=2)


NEG_BIAS = -1e30          # finite: avoids (-inf) - (-inf) NaNs in the scan
PAD_POS = 2**30           # sentinel position for padded KV slots


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Additive f32 bias (..., Sq, Sk): 0 keep / NEG_BIAS drop."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = (kp < PAD_POS).expand(*qp.shape[:-1], kp.shape[-1])
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=F32, device=q_pos.device)
    return torch.where(ok, zero, torch.full((), NEG_BIAS, dtype=F32,
                                            device=q_pos.device))


def attention_core(q, k, v, q_pos, k_pos, *, causal: bool,
                   window: Optional[int], chunk: int = 1024):
    """Online-softmax attention (the reference's jnp math).

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hk, D); positions (B, S*).
    Returns (B, Sq, Hq, D).  KV is consumed in ``chunk``-sized blocks with
    running (m, l, acc) statistics.
    """
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]
    scale = 1.0 / np.sqrt(d)
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    # the reference multiplies by a numpy float64 scalar, which JAX does
    # not treat as weakly typed: the scaled queries are float32
    qs = q.to(F32) * scale

    if skv <= chunk:
        s = torch.einsum("bqhd,bkhd->bhqk", qs, k.to(F32))
        s = s + _mask_bias(q_pos, k_pos, causal, window)[:, None]
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)

    pad = (-skv) % chunk
    if pad:                                  # ragged tail: mask padded slots
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((b, pad), PAD_POS,
                                             dtype=k_pos.dtype,
                                             device=k_pos.device)], dim=1)
        skv += pad
    m = torch.full((b, hq, sq), NEG_BIAS, dtype=F32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, hq, sq, dv), dtype=F32, device=q.device)
    for c0 in range(0, skv, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kc.to(F32))
        s = s + _mask_bias(q_pos, k_pos[:, c0:c0 + chunk], causal,
                           window)[:, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   vc.to(F32))
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return torch.movedim(o, 1, 2).to(q.dtype)


def flash_attention_heads(q, k, v, q_pos=None, *, causal: bool,
                          window: Optional[int]):
    """The card's route of :func:`attention_core`: heads folded into the
    leading axis, one flash-attention kernel launch.  q: (B, S, Hq, D),
    k/v: (B, S, Hk, D).  The kernel puts the queries at ``arange(S)``,
    aligned to the keys' suffix: ``q_pos`` must be None, which stands for
    those positions.  Positions given as a tensor raise (checking their
    values would cost a host sync on every call)."""
    b, s, hq, d = q.shape
    if q_pos is not None or k.shape[1] != s:
        raise ValueError(
            "flash attention on the card takes queries at positions "
            "arange(S) (positions=None) aligned to S keys; other positions "
            "are not ported")
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(b * hq, s, t.shape[-1]) \
            .contiguous()

    o = ops.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                            window=window)
    return o.reshape(b, hq, s, d).permute(0, 2, 1, 3)


def decode_attention_core(q, k, v, k_pos, q_pos, *, window: Optional[int]):
    """Single-position decode: q (B,1,Hq,D) vs the full cache k/v
    (B,S,Hk,D).  ``k_pos`` holds the slots' positions (-1 for unwritten
    slots); unwritten and out-of-window slots are masked."""
    d = q.shape[-1]
    hq = q.shape[2]
    scale = 1.0 / np.sqrt(d)
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32) * scale, k.to(F32))
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        valid = valid & (k_pos > q_pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", (p / lsum).to(v.dtype), v)


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope + core), with KV cache support
# ---------------------------------------------------------------------------
def attn_decls(a: AttentionConfig, d_model: int) -> Dict[str, PDecl]:
    """Projections declared flattened (d, H*hd), as in the reference."""
    if a.is_mla:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP item 15)")
    decls = {
        "wq": PDecl((d_model, a.q_dim), ("embed", "heads")),
        "wk": PDecl((d_model, a.kv_dim), ("embed", "kv_heads")),
        "wv": PDecl((d_model, a.kv_dim), ("embed", "kv_heads")),
        "wo": PDecl((a.q_dim, d_model), ("heads", "embed")),
    }
    if a.qkv_bias:
        decls["bq"] = PDecl((a.q_dim,), ("heads",), init="zeros")
        decls["bk"] = PDecl((a.kv_dim,), ("kv_heads",), init="zeros")
        decls["bv"] = PDecl((a.kv_dim,), ("kv_heads",), init="zeros")
    return decls


def _heads(t, n: int, hd: int):
    return t.reshape(*t.shape[:-1], n, hd)


def _qkv(p, a: AttentionConfig, x, positions, use_rope: bool):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _heads(q, a.n_heads, a.head_dim)
    k = _heads(k, a.n_kv_heads, a.head_dim)
    v = _heads(v, a.n_kv_heads, a.head_dim)
    if use_rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def attn_forward(p, a: AttentionConfig, x, positions=None, *,
                 use_rope: bool = True, chunk: int = 1024,
                 causal: Optional[bool] = None):
    """Full-sequence self-attention (prefill).  Returns (out, (k, v)), the
    keys and values seeding the decode cache.  ``positions`` (B, S); None
    stands for ``arange(S)`` in every row, the prefill's, and is the only
    form the card's route takes."""
    if a.is_mla:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP item 15)")
    causal = a.causal if causal is None else causal
    pos = positions
    if pos is None:
        b, s = x.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q, k, v = _qkv(p, a, x, pos, use_rope)
    if q.is_cuda:
        o = flash_attention_heads(q, k, v, positions, causal=causal,
                                  window=a.sliding_window)
    else:
        o = attention_core(q, k, v, pos, pos, causal=causal,
                           window=a.sliding_window, chunk=chunk)
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out, (k, v)


def attn_decode(p, a: AttentionConfig, x1, pos, slot_pos, cache, *,
                use_rope: bool = True):
    """One decode step.  x1: (B, 1, d); pos: (B,) int current position.

    ``slot_pos``: (B, S) int table slot -> written position (-1 empty),
    shared across layers and already updated for this step by the caller.
    cache: {"k": (B, S, Hk, D), "v": ...}, written in place at slot
    ``pos % S`` (a ring buffer under a sliding window).  Returns
    (out (B,1,d), cache).
    """
    if a.is_mla:
        raise NotImplementedError("MLA attention is not ported yet "
                                  "(ROADMAP item 15)")
    positions = pos[:, None]
    q = x1 @ p["wq"]
    k = x1 @ p["wk"]
    v = x1 @ p["wv"]
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _heads(q, a.n_heads, a.head_dim)
    k = _heads(k, a.n_kv_heads, a.head_dim)
    v = _heads(v, a.n_kv_heads, a.head_dim)
    if use_rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    ck, cv = cache["k"], cache["v"]
    slot = (pos % ck.shape[1]).long()
    bidx = torch.arange(x1.shape[0], device=x1.device)
    ck[bidx, slot] = k[:, 0]
    cv[bidx, slot] = v[:, 0]
    o = decode_attention_core(q, ck, cv, slot_pos, pos,
                              window=a.sliding_window)
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out, cache


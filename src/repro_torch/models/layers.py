"""Shared neural-net layers of the port: norms (RMS and layer norm), RoPE
and the sinusoidal position table, the MLP, GQA attention (sliding
window, QKV bias) with its KV cache, cross-attention against another
sequence (an encoder's or a vision tower's), and DeepSeek-V2's multi-head
latent attention (MLA) with its latent cache.

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
tensor raise there.  Meta tensors (the dry run's trace) take the same
route, to the kernel's shape-only stand-in.  Cross-attention
(``kv_override``) hands the kernel
keys of their own length Skv, never causal and with no window, so that no
key is masked and the alignment does not matter (the encoder's 1500
frames against a 400-token prompt, the VLM's 1601 image tokens against
a 2048-token one).  On the
CPU it calls :func:`attention_core`, the reference's chunked online-softmax
math ported line for line, which the CPU tests hold against the JAX
package.  Decode attention has no kernel in the reference and runs as
plain PyTorch on either device.

MLA's prefill folds the decoupled rope channel into the head depth, so
its attention has queries and keys of depth head_dim + rope_head_dim (192
for deepseek-v2-lite) against values of depth head_dim (128); the card's
route hands the kernel v at its own depth.  Its decode is the reference's
absorbed form against the latent cache, plain tensor products on either
device (the reference computes it outside any Pallas kernel).

Cross-attention's decode (``attn_decode(cross=True)``) reads a static
cache (never written, every slot valid), as plain tensor ops on either
device.

The reference's sharding ``rules`` argument and ``logical_constraint``
calls are dropped: on one card they are no-ops.

On a mesh whose "model" axis has more than one shard the decoder runs
these layers tensor parallel, as stages (``attn_stage``,
``attn_decode_stage``, ``mlp_stage``): every shard runs the functions
above on its own heads or its own slice of the MLP width, with the
parameter blocks ``tp_attn_params`` and ``tp_mlp_params`` cut for it, and
the shards' partial outputs are summed over "model" in float32, then
cast (``tp_sum``).  A shard's query heads are a contiguous run of
``n_heads / tp``; the KV heads they use are its own block where the KV
heads divide the degree, else the one KV head its whole run maps to
(``shard_heads``), taken from ``wk`` / ``wv`` gathered over "model" where
the placed spec cuts a KV head in the middle.  A split the heads cannot
take raises ``ValueError`` (``tp_heads``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.param import PDecl
from repro_torch.sharding.collectives import mesh_sum, on_shard, respec

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms / activations / MLP
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    """Statistics in float32, applied in the input's type."""
    var = torch.mean(torch.square(x.to(F32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w


def layer_norm(x, w, b, eps: float = 1e-5):
    """Statistics in float32 (the population variance), normalised in
    float32, scaled and shifted in the input's type."""
    h = x.to(F32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.var(h, dim=-1, keepdim=True, unbiased=False)
    return ((h - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


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


def sinusoidal_pos(seq_len: int, d_model: int, dtype=torch.bfloat16,
                   device=None):
    """The (seq_len, d_model) sine / cosine table of positions 0 ..
    seq_len - 1, computed in numpy as the reference does, then cast."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / np.power(10_000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


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


def flash_attention_heads(q, k, v, q_pos=None, k_pos=None, *,
                          causal: bool, window: Optional[int]):
    """The card's route of :func:`attention_core`: heads folded into the
    leading axis, one flash-attention kernel launch.  q: (B, S, Hq, D),
    k: (B, Skv, Hk, D), v: (B, Skv, Hk, Dv); returns (B, S, Hq, Dv).  The
    kernel puts the queries at ``arange(S)`` and the keys at
    ``arange(Skv)``, the queries aligned to the keys' suffix: ``q_pos`` and
    ``k_pos`` must be None, which stands for those positions.  Keys of
    another length than the queries' are taken where nothing is masked
    (not causal, no window): cross-attention.  Positions given as a tensor
    raise (checking their values would cost a host sync on every call)."""
    b, s, hq, _ = q.shape
    skv = k.shape[1]
    if q_pos is not None or k_pos is not None \
            or (skv != s and (causal or window is not None)):
        raise ValueError(
            "flash attention on the card takes queries at positions "
            "arange(S) and keys at arange(Skv) (positions=None), Skv == S "
            "unless nothing is masked; other positions are not ported")
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(b * hq, t.shape[1],
                                             t.shape[-1]).contiguous()

    o = ops.flash_attention(fold(q), fold(k), fold(v), causal=causal,
                            window=window)
    return o.reshape(b, hq, s, v.shape[-1]).permute(0, 2, 1, 3)


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
        r, rh = a.kv_lora_rank, a.rope_head_dim
        return {
            "wq": PDecl((d_model, a.n_heads * (a.head_dim + rh)),
                        ("embed", "heads")),
            "wdkv": PDecl((d_model, r + rh), ("embed", "latent")),
            "wuk": PDecl((r, a.n_heads * a.head_dim), ("latent", "heads")),
            "wuv": PDecl((r, a.n_heads * a.head_dim), ("latent", "heads")),
            "wo": PDecl((a.n_heads * a.head_dim, d_model),
                        ("heads", "embed")),
        }
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


def _qkv(p, a: AttentionConfig, x, positions, use_rope: bool, kv_x=None):
    """q from x, k and v from ``kv_x`` (x where None), rope on both when
    ``use_rope``."""
    kv_x = x if kv_x is None else kv_x
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if a.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _heads(q, a.n_heads, a.head_dim)
    k = _heads(k, a.n_kv_heads, a.head_dim)
    v = _heads(v, a.n_kv_heads, a.head_dim)
    if use_rope:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def _positions(x, positions):
    """``positions``, or ``arange(S)`` in every row where it is None."""
    if positions is not None:
        return positions
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _attend(q, k, v, positions, pos, *, causal: bool,
            window: Optional[int], chunk: int, k_positions=None,
            k_pos=None):
    """The card's kernel route where the tensors lie on the card, the
    reference's chunked math elsewhere.  The keys sit at ``k_positions``
    (``k_pos`` resolved); where both are None, at the queries'."""
    if q.is_cuda or q.is_meta:
        return flash_attention_heads(q, k, v, positions, k_positions,
                                     causal=causal, window=window)
    return attention_core(q, k, v, pos, pos if k_pos is None else k_pos,
                          causal=causal, window=window, chunk=chunk)


def attn_forward(p, a: AttentionConfig, x, positions=None, *,
                 use_rope: bool = True, chunk: int = 1024,
                 kv_override: Optional[Tuple] = None,
                 causal: Optional[bool] = None):
    """Full-sequence attention (prefill).  Returns (out, (k, v)), the keys
    and values seeding the decode cache (MLA: the latent and the rope key,
    ``(c, k_rope)``).  ``positions`` (B, S); None stands for ``arange(S)``
    in every row, the prefill's, and is the only form the card's route
    takes.  ``kv_override = (kv_x, kv_positions)`` makes it
    cross-attention: q from x, k and v from kv_x (B, Skv, d) at
    ``kv_positions`` (None: ``arange(Skv)``), no rope, never causal."""
    if a.is_mla:
        return _mla_forward(p, a, x, positions, chunk=chunk)
    causal = a.causal if causal is None else causal
    pos = _positions(x, positions)
    kv_x, k_positions, k_pos = None, None, None
    if kv_override is not None:  # cross-attention: the encoder/vision tower
        kv_x, k_positions = kv_override
        k_pos = _positions(kv_x, k_positions)
        use_rope, causal = False, False
    q, k, v = _qkv(p, a, x, pos, use_rope, kv_x)
    o = _attend(q, k, v, positions, pos, causal=causal,
                window=a.sliding_window, chunk=chunk,
                k_positions=k_positions, k_pos=k_pos)
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out, (k, v)


def attn_decode(p, a: AttentionConfig, x1, pos, slot_pos, cache, *,
                use_rope: bool = True, cross: bool = False):
    """One decode step.  x1: (B, 1, d); pos: (B,) int current position.

    ``slot_pos``: (B, S) int table slot -> written position (-1 empty),
    shared across layers and already updated for this step by the caller.
    cache: {"k": (B, S, Hk, D), "v": ...} (MLA: {"c": (B, S, r),
    "krope": (B, S, rh)}), written in place at slot ``pos % S`` (a ring
    buffer under a sliding window).  ``cross=True`` treats the cache as a
    static cross-attention KV: no rope, no write, every slot valid.
    Returns (out (B,1,d), cache).
    """
    if a.is_mla:
        return _mla_decode(p, a, x1, pos, slot_pos, cache)
    positions = pos[:, None]
    q = x1 @ p["wq"]
    if a.qkv_bias:
        q = q + p["bq"]
    q = _heads(q, a.n_heads, a.head_dim)
    if use_rope and not cross:
        q = apply_rope(q, positions, a.rope_theta)
    ck, cv = cache["k"], cache["v"]
    if cross:
        o = decode_attention_core(
            q, ck, cv, torch.zeros(ck.shape[:2], dtype=torch.int32,
                                   device=ck.device), pos, window=None)
        return o.reshape(*o.shape[:2], -1) @ p["wo"], cache
    k = x1 @ p["wk"]
    v = x1 @ p["wv"]
    if a.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = _heads(k, a.n_kv_heads, a.head_dim)
    v = _heads(v, a.n_kv_heads, a.head_dim)
    if use_rope:
        k = apply_rope(k, positions, a.rope_theta)
    slot = (pos % ck.shape[1]).long()
    bidx = torch.arange(x1.shape[0], device=x1.device)
    ck[bidx, slot] = k[:, 0]
    cv[bidx, slot] = v[:, 0]
    o = decode_attention_core(q, ck, cv, slot_pos, pos,
                              window=a.sliding_window)
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out, cache



# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent KV + decoupled rope; absorbed decode
# ---------------------------------------------------------------------------
def _mla_split_q(p, a, x, positions):
    qfull = _heads(x @ p["wq"], a.n_heads, a.head_dim + a.rope_head_dim)
    q_nope = qfull[..., : a.head_dim]
    q_rope = apply_rope(qfull[..., a.head_dim:], positions, a.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, a, x, positions):
    ckv = x @ p["wdkv"]
    c, k_rope = ckv[..., : a.kv_lora_rank], ckv[..., a.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        a.rope_theta)[:, :, 0]
    return c, k_rope


def _mla_forward(p, a: AttentionConfig, x, positions=None, *, chunk: int):
    """MLA prefill: keys and values up-projected from the latent, the rope
    channel concatenated into the head depth (queries and keys at
    head_dim + rope_head_dim, values at head_dim), scaled by
    1/sqrt(head_dim + rope_head_dim) as the reference's core scales by
    1/sqrt(dim(q)).  Returns (out, (c, k_rope)), the latent cache."""
    pos = _positions(x, positions)
    q_nope, q_rope = _mla_split_q(p, a, x, pos)
    c, k_rope = _mla_latent(p, a, x, pos)
    k_nope = _heads(c @ p["wuk"], a.n_heads, a.head_dim)
    v = _heads(c @ p["wuv"], a.n_heads, a.head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:-1], a.rope_head_dim)], dim=-1)
    o = _attend(q, k, v, positions, pos, causal=a.causal, window=None,
                chunk=chunk)
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out, (c, k_rope)


def _mla_decode(p, a: AttentionConfig, x1, pos, slot_pos, cache):
    """Absorbed MLA decode: scores and values against the latent cache
    (r + rope_head_dim numbers a token, not 2 H D), W_uk folded into the
    query and W_uv applied after the context.  The cache is written in
    place at slot ``pos % S``."""
    positions = pos[:, None]
    q_nope, q_rope = _mla_split_q(p, a, x1, positions)   # (B,1,H,dh/rh)
    c1, kr1 = _mla_latent(p, a, x1, positions)           # (B,1,r), (B,1,rh)
    cc, ckr = cache["c"], cache["krope"]
    slot = (pos % cc.shape[1]).long()
    bidx = torch.arange(x1.shape[0], device=x1.device)
    cc[bidx, slot] = c1[:, 0]
    ckr[bidx, slot] = kr1[:, 0]

    wuk = p["wuk"].reshape(a.kv_lora_rank, a.n_heads, a.head_dim)
    wuv = p["wuv"].reshape(a.kv_lora_rank, a.n_heads, a.head_dim)
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope, wuk)     # absorb W_uk
    scale = 1.0 / np.sqrt(a.head_dim + a.rope_head_dim)
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.to(F32), cc.to(F32))
         + torch.einsum("bqhk,bsk->bhqs", q_rope.to(F32), ckr.to(F32))) \
        * scale
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    pattn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", pattn.to(cc.dtype), cc)
    o = torch.einsum("bqhr,rhk->bqhk", ctx, wuv)            # absorb W_uv
    out = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return out, cache


# ---------------------------------------------------------------------------
# tensor parallelism over "model": each shard's heads and MLP width
# ---------------------------------------------------------------------------
TP_AXIS = "model"


def tp_heads(a: AttentionConfig, tp: int) -> AttentionConfig:
    """The AttentionConfig of one shard's heads at a model degree ``tp``.
    The query heads must divide the degree, and a shard's run of query
    heads must use whole KV heads or lie within one KV head's group (the
    KV heads divide the degree, or the degree divides them); otherwise
    ``ValueError``."""
    if a.n_heads % tp:
        raise ValueError(f"{a.n_heads} query heads do not split over a "
                         f"model degree of {tp}")
    hq = a.n_heads // tp
    if a.is_mla:
        return replace(a, n_heads=hq)
    group = a.n_heads // a.n_kv_heads
    if hq % group and group % hq:
        raise ValueError(
            f"GQA {a.n_heads}/{a.n_kv_heads} at a model degree of {tp}: a "
            f"shard's {hq} query heads straddle a KV group of {group}")
    return replace(a, n_heads=hq, n_kv_heads=max(hq // group, 1))


def shard_heads(a: AttentionConfig, tp: int, j: int) -> Tuple[int, ...]:
    """(q0, q1, k0, k1): the query heads [q0, q1) of the shard at place
    ``j`` of "model" and the KV heads [k0, k1) they use (MLA: the same
    heads)."""
    hq = a.n_heads // tp
    q0, q1 = j * hq, (j + 1) * hq
    if a.is_mla:
        return q0, q1, q0, q1
    group = a.n_heads // a.n_kv_heads
    return q0, q1, q0 // group, (q1 - 1) // group + 1


def tp_blocks(leaf, dim: int, ranges: Sequence[Tuple[int, int]], mesh,
              axis: str = TP_AXIS) -> List[torch.Tensor]:
    """Each shard's rows [lo, hi) of dim ``dim`` of ``leaf``
    (``ranges[j]`` for the shard at place j of ``axis``), whole along its
    other dims: a leaf placed over "data" (FSDP) is gathered there, and
    one placed over ``axis`` at other places than the ranges (a KV head
    cut in the middle) is gathered over ``axis`` too, then narrowed."""
    n = leaf.shape[dim]
    tp = len(ranges)
    aligned = n % tp == 0 and all(
        r == (j * n // tp, (j + 1) * n // tp) for j, r in enumerate(ranges))
    spec = [None] * len(leaf.shape)
    if aligned:
        spec[dim] = axis
    parts = respec(leaf, tuple(spec), mesh)
    if aligned:
        return parts
    out = []
    for i, part in enumerate(parts):
        lo, hi = ranges[mesh.axis_index(i, axis)]
        out.append(part.narrow(dim, lo, hi - lo))
    return out


def replicated(leaf, mesh) -> List[torch.Tensor]:
    """``leaf`` whole on every shard (gathered where it is placed)."""
    return respec(leaf, (None,) * len(leaf.shape), mesh)


def tp_attn_params(p, a: AttentionConfig, mesh):
    """(each shard's attention parameters, the AttentionConfig of its
    heads): the projections' columns and ``wo``'s rows of its heads (and
    the biases'); MLA's latent projection ``wdkv`` whole on every
    shard."""
    tp = mesh.shape.get(TP_AXIS, 1)
    local = tp_heads(a, tp)
    heads = [shard_heads(a, tp, j) for j in range(tp)]

    def cols(name, width, dim, kv=False):
        ranges = [((k0 if kv else q0) * width, (k1 if kv else q1) * width)
                  for q0, q1, k0, k1 in heads]
        return tp_blocks(p[name], dim, ranges, mesh)
    hd = a.head_dim
    if a.is_mla:
        out = {"wq": cols("wq", hd + a.rope_head_dim, 1),
               "wdkv": replicated(p["wdkv"], mesh),
               "wuk": cols("wuk", hd, 1), "wuv": cols("wuv", hd, 1),
               "wo": cols("wo", hd, 0)}
    else:
        out = {"wq": cols("wq", hd, 1), "wk": cols("wk", hd, 1, kv=True),
               "wv": cols("wv", hd, 1, kv=True), "wo": cols("wo", hd, 0)}
        if a.qkv_bias:
            out.update(bq=cols("bq", hd, 0), bk=cols("bk", hd, 0, kv=True),
                       bv=cols("bv", hd, 0, kv=True))
    return [{k: v[i] for k, v in out.items()}
            for i in range(len(mesh.devices))], local


def tp_mlp_params(p, mesh, axis: str = TP_AXIS):
    """Each shard's MLP parameters: its block of the width ("ff": ``wi``'s
    last dim, ``wo``'s rows)."""
    tp = mesh.shape.get(axis, 1)
    ff = p["wo"].shape[0]
    if ff % tp:
        raise ValueError(f"an MLP width of {ff} does not split over a "
                         f"model degree of {tp}")
    ranges = [(j * ff // tp, (j + 1) * ff // tp) for j in range(tp)]
    wi = tp_blocks(p["wi"], len(p["wi"].shape) - 1, ranges, mesh, axis)
    wo = tp_blocks(p["wo"], 0, ranges, mesh, axis)
    return [{"wi": a, "wo": b} for a, b in zip(wi, wo)]


def tp_sum(parts: Sequence[torch.Tensor], mesh,
           dtype: torch.dtype) -> List[torch.Tensor]:
    """Each shard's partial output summed over "model" in float32, then
    cast to ``dtype``."""
    summed = mesh_sum([p.to(F32) for p in parts], mesh, axis=TP_AXIS)
    return [s.to(dtype) for s in summed]


def attn_stage(p, a: AttentionConfig, xs, mesh, *, chunk: int,
               kv_xs: Optional[Sequence[torch.Tensor]] = None):
    """Prefill attention over "model": every shard attends with its own
    heads (one flash-attention launch a shard on the card) and projects
    them through its rows of ``wo``.  ``kv_xs`` (one per shard: the
    image's or an encoder's activations) makes it cross-attention: each
    shard projects its own KV heads' keys and values from its part, no
    rope, no mask (``attn_forward``'s ``kv_override``).  Returns (the
    output summed over "model", one per shard; each shard's cache pair,
    its KV heads' keys and values or MLA's latent and rope key)."""
    ps, local = tp_attn_params(p, a, mesh)
    outs, kvs = [], []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            o, kv = attn_forward(ps[i], local, xs[i], chunk=chunk,
                                 kv_override=None if kv_xs is None
                                 else (kv_xs[i], None))
        outs.append(o)
        kvs.append(kv)
    return tp_sum(outs, mesh, xs[0].dtype), kvs


def attn_decode_stage(p, a: AttentionConfig, xs, pos, slot_pos, caches,
                      mesh, *, cross: bool = False):
    """One decode step over "model": every shard writes its own KV heads
    (MLA: its copy of the latent) into its cache and attends with its own
    heads; the outputs are summed over "model".  ``cross`` reads each
    shard's static cross keys and values instead (no rope, no write,
    every slot valid)."""
    ps, local = tp_attn_params(p, a, mesh)
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            outs.append(attn_decode(ps[i], local, xs[i], pos[i],
                                    slot_pos[i], caches[i],
                                    use_rope=not cross, cross=cross)[0])
    return tp_sum(outs, mesh, xs[0].dtype)


def mlp_stage(p, xs, mesh, act: str, glu: bool):
    """The MLP over "model": every shard's block of the width, summed."""
    ps = tp_mlp_params(p, mesh)
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            outs.append(mlp_forward(ps[i], xs[i], act, glu))
    return tp_sum(outs, mesh, xs[0].dtype)

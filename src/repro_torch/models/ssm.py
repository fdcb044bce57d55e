"""Recurrent blocks of the port: Mamba-2 (SSD) and xLSTM (mLSTM, sLSTM),
the JAX package's ``models/ssm.py``.

The SSD chunked scan follows Dao & Gu (arXiv:2405.21060): within-chunk
terms are dense products, the inter-chunk recurrence carries an (N x P)
state per head.  :func:`ssd_chunked` routes by where its tensors lie: on
the card it calls the hand-written SSD scan kernel (``kernels.ops.
ssd_scan``) with the heads folded into the lanes and B, C shared by the
heads of a batch row; on the CPU it runs the reference's chunked math,
ported line for line (meta tensors, the dry run's trace, take the card's
route, to the kernel's shape-only stand-in).  Decoding (``ssd_step``,
``causal_conv_step``) has
no kernel in the reference and runs as plain PyTorch on either device.

The mLSTM maps onto the same scan (decay = logsigmoid(f), the state
driven by i v k^T, queried by q, the normalizer an extra all-ones value
channel): its heads are folded into the batch, one head a lane, so on the
card each mLSTM layer is one SSD scan launch with the key depth as the
state's N and the value depth plus one as P (512 and 513 for
xlstm-350m).  The sLSTM is a nonlinear recurrence; the reference runs it
as a ``lax.scan`` outside any Pallas kernel, and the port as a Python loop
of plain tensor ops over time, on either device (about twenty small
launches a step on the card); on meta tensors one step stands for the
loop.

The reference's sharding ``rules`` argument is dropped (a no-op on one
card).  On a mesh whose "model" axis has more than one shard the hybrid
runs the Mamba-2 block tensor parallel (``mamba2_stage``,
``mamba2_decode_stage``): every shard takes ``nh / tp`` of the SSM heads
(``tp_mamba2_params``: its columns of ``in_proj``, its conv channels and
per-head leaves, its rows of ``out_proj``), scans them (one SSD scan
launch a shard on the card), and ``gnorm``'s sum of squares and the
``out_proj`` partials are summed over "model" in float32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    TP_AXIS, replicated, rms_norm, tp_blocks, tp_sum,
)
from repro_torch.models.param import PDecl
from repro_torch.sharding.collectives import mesh_sum, on_shard

F32 = torch.float32


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------
def ssd_chunked(xbar, la, Bm, Cm, chunk: int):
    """y_t = C_t^T S_t,  S_t = exp(la_t) S_{t-1} + B_t xbar_t^T.

    xbar: (B,S,H,P) f32; la: (B,S,H) f32 log-decay (<=0);
    Bm, Cm: (B,S,N) f32 (shared across heads, n_groups=1).
    Returns y (B,S,H,P) f32 and final state (B,H,N,P).
    """
    if xbar.is_cuda or xbar.is_meta:
        return _ssd_kernel_route(xbar, la, Bm, Cm, chunk)
    b, s, h, pdim = xbar.shape
    n = Bm.shape[-1]
    s_true = s
    pad = (-s) % chunk
    if pad:   # zero inputs with zero log-decay leave the state untouched
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        s += pad
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xbar.device))
    state = torch.zeros((b, h, n, pdim), dtype=F32, device=xbar.device)
    ys = []
    for c0 in range(0, s, chunk):
        xc = xbar[:, c0:c0 + chunk]                # (B,Q,H,P)
        lac = la[:, c0:c0 + chunk]                 # (B,Q,H)
        bc, cc = Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk]   # (B,Q,N)
        cl = torch.cumsum(lac, dim=1)              # inclusive (B,Q,H)
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        lmat = torch.exp(torch.clamp(cl[:, :, None, :] - cl[:, None, :, :],
                                     -60.0, 0.0))
        w = torch.where(causal[None, :, :, None], scores[:, :, :, None] * lmat,
                        torch.zeros((), dtype=F32, device=xbar.device))
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
        y_inter = torch.einsum("bin,bhnp,bih->bihp", cc, state,
                               torch.exp(cl))
        tail = torch.exp(cl[:, -1:, :] - cl)       # decay j -> chunk end
        state = torch.einsum("bjn,bjhp,bjh->bhnp", bc, xc, tail) \
            + state * torch.exp(cl[:, -1])[:, :, None, None]
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s_true]
    return y, state


def _ssd_kernel_route(xbar, la, Bm, Cm, chunk: int):
    """Heads folded into the kernel's lanes: xbar (B,S,H,P) -> (B*H,S,P),
    la (B,S,H) -> (B*H,S); B and C stay (B,S,N), read by the H lanes of
    their batch row (no broadcast copy)."""
    b, s, h, pdim = xbar.shape
    n = Bm.shape[-1]
    xf = xbar.permute(0, 2, 1, 3).reshape(b * h, s, pdim).contiguous()
    lf = la.permute(0, 2, 1).reshape(b * h, s).contiguous()
    y, state = ops.ssd_scan(xf, lf, Bm.contiguous(), Cm.contiguous(),
                            chunk=chunk, heads=h)
    return (y.reshape(b, h, s, pdim).permute(0, 2, 1, 3),
            state.reshape(b, h, n, pdim))


def ssd_step(state, xbar1, la1, b1, c1):
    """One decode step. state (B,H,N,P); xbar1 (B,H,P); la1 (B,H); b1/c1
    (B,N)."""
    s_new = state * torch.exp(la1)[:, :, None, None] \
        + torch.einsum("bn,bhp->bhnp", b1, xbar1)
    y = torch.einsum("bn,bhnp->bhp", c1, s_new)
    return s_new, y


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (width cw) with streaming state
# ---------------------------------------------------------------------------
def causal_conv(x, w, bias):
    """x: (B,S,C); w: (cw,C) depthwise; left-pad causal."""
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = 0
    for i in range(cw):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out + bias


def causal_conv_step(conv_state, x1, w, bias):
    """conv_state: (B, cw-1, C) previous inputs; x1: (B, C)."""
    window = torch.cat([conv_state, x1[:, None, :]], dim=1)   # (B,cw,C)
    out = torch.einsum("bkc,kc->bc", window, w) + bias
    return window[:, 1:], out


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------
def mamba2_decls(cfg: ArchConfig) -> Dict[str, PDecl]:
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    nh = di // s.head_dim
    n = s.state_dim
    cdim = di + 2 * n
    return {
        "norm": PDecl((d,), (None,), init="ones"),
        "in_proj": PDecl((d, 2 * di + 2 * n + nh), ("embed", "ff")),
        "conv_w": PDecl((s.conv_dim, cdim), ("conv", None), scale=0.3),
        "conv_b": PDecl((cdim,), (None,), init="zeros"),
        "a_log": PDecl((nh,), (None,), dtype=F32, init="zeros"),
        "dt_bias": PDecl((nh,), (None,), dtype=F32, init="zeros"),
        "d_skip": PDecl((nh,), (None,), dtype=F32, init="ones"),
        "gnorm": PDecl((di,), (None,), init="ones"),
        "out_proj": PDecl((di, d), ("ff", "embed")),
    }


def _mamba2_split(h, cfg, heads: int):
    """in_proj's output cut into z, x, bm, cm, dt for ``heads`` SSM heads
    (all of them, or a shard's)."""
    s = cfg.ssm
    dl = heads * s.head_dim
    return torch.split(h, [dl, dl, s.state_dim, s.state_dim, heads], dim=-1)


def _mamba2_mix(p, cfg: ArchConfig, x, heads: int):
    """The block up to its gate, on ``heads`` SSM heads with ``p`` cut for
    them: (y * silu(z) in x's type, the final state, the conv input)."""
    s = cfg.ssm
    n = s.state_dim
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    h = hin @ p["in_proj"]
    z, xc, bm, cm, dt = _mamba2_split(h, cfg, heads)
    dl = xc.shape[-1]
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out = F.silu(causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xc, bm, cm = torch.split(conv_out, [dl, n, n], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])                  # (B,S,h)
    la = -torch.exp(p["a_log"]) * dt
    xh = xc.reshape(*xc.shape[:2], heads, s.head_dim).to(F32)
    xbar = xh * dt[..., None]
    y, s_fin = ssd_chunked(xbar, la, bm.to(F32), cm.to(F32), s.chunk)
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(*x.shape[:2], dl).to(x.dtype)
    return y * F.silu(z), s_fin, conv_in


def _conv_state(conv_in, cw: int):
    """The last cw - 1 conv inputs (zeros before the sequence)."""
    return F.pad(conv_in, (0, 0, cw - 1, 0))[:, -(cw - 1):]


def mamba2_forward(p, cfg: ArchConfig, x, return_state: bool = False):
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    g, s_fin, conv_in = _mamba2_mix(p, cfg, x, nh)
    y = rms_norm(g, p["gnorm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    if return_state:
        return out, (s_fin, _conv_state(conv_in, s.conv_dim))
    return out


def mamba2_init_state(cfg: ArchConfig, batch: int, device):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return {
        "ssm": torch.zeros((batch, nh, s.state_dim, s.head_dim), dtype=F32,
                           device=device),
        "conv": torch.zeros((batch, s.conv_dim - 1, di + 2 * s.state_dim),
                            dtype=torch.bfloat16, device=device),
    }


def _mamba2_step_mix(p, cfg: ArchConfig, x1, state, heads: int):
    """One decode step up to the gate, on ``heads`` SSM heads: (y *
    silu(z), the new state)."""
    s = cfg.ssm
    n = s.state_dim
    hin = rms_norm(x1[:, 0], p["norm"], cfg.norm_eps)
    h = hin @ p["in_proj"]
    z, xc, bm, cm, dt = _mamba2_split(h, cfg, heads)
    dl = xc.shape[-1]
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_state, conv_out = causal_conv_step(
        state["conv"], conv_in, p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out)
    xc, bm, cm = torch.split(conv_out, [dl, n, n], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])                  # (B,h)
    la = -torch.exp(p["a_log"]) * dt
    xh = xc.reshape(-1, heads, s.head_dim).to(F32)
    ssm, y = ssd_step(state["ssm"], xh * dt[..., None], la,
                      bm.to(F32), cm.to(F32))
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(-1, dl).to(x1.dtype)
    return y * F.silu(z), {"ssm": ssm, "conv": conv_state}


def mamba2_decode(p, cfg: ArchConfig, x1, state):
    """x1: (B,1,d). state: {"ssm","conv"}. Returns (out (B,1,d), state)."""
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    g, state = _mamba2_step_mix(p, cfg, x1, state, nh)
    y = rms_norm(g, p["gnorm"], cfg.norm_eps)
    out = x1 + (y @ p["out_proj"])[:, None]
    return out, state


# ---------------------------------------------------------------------------
# Mamba-2 over "model": each shard's SSM heads
# ---------------------------------------------------------------------------
def tp_ssm_heads(cfg: ArchConfig, tp: int) -> int:
    """The SSM heads of one shard at a model degree ``tp``; ``ValueError``
    where they (and so the inner width) do not split."""
    s = cfg.ssm
    nh = s.expand * cfg.d_model // s.head_dim
    if nh % tp:
        raise ValueError(f"{nh} SSM heads (inner width {nh * s.head_dim}) "
                         f"do not split over a model degree of {tp}")
    return nh // tp


def tp_mamba2_params(p, cfg: ArchConfig, mesh):
    """Each shard's Mamba-2 parameters for its ``nh / tp`` SSM heads: the
    columns of ``in_proj`` that give its heads' z, x and dt and the whole
    bm and cm (the reference's flat "ff" placement cuts across those
    pieces, so the leaf is gathered whole and narrowed); ``conv_w`` /
    ``conv_b`` narrowed to its x channels and bm, cm; ``dt_bias``,
    ``a_log``, ``d_skip`` and ``gnorm`` to its heads; ``out_proj``'s rows
    of its heads."""
    tp = mesh.shape.get(TP_AXIS, 1)
    s = cfg.ssm
    n = s.state_dim
    hl = tp_ssm_heads(cfg, tp)
    dl = hl * s.head_dim
    di = dl * tp
    in_proj = replicated(p["in_proj"], mesh)
    conv_w = replicated(p["conv_w"], mesh)
    conv_b = replicated(p["conv_b"], mesh)
    out_proj = tp_blocks(p["out_proj"], 0,
                         [(j * dl, (j + 1) * dl) for j in range(tp)], mesh)
    per_head = {k: replicated(p[k], mesh)
                for k in ("norm", "dt_bias", "a_log", "d_skip", "gnorm")}

    def cols(t, spans):
        return torch.cat([t.narrow(-1, a, w) for a, w in spans], dim=-1)
    out = []
    for i in range(len(mesh.devices)):
        j = mesh.axis_index(i, TP_AXIS)
        chans = [(j * dl, dl), (di, 2 * n)]
        out.append({
            "norm": per_head["norm"][i],
            "in_proj": cols(in_proj[i], [(j * dl, dl), (di + j * dl, dl),
                                         (2 * di, 2 * n),
                                         (2 * di + 2 * n + j * hl, hl)]),
            "conv_w": cols(conv_w[i], chans),
            "conv_b": cols(conv_b[i], chans),
            **{k: per_head[k][i].narrow(0, j * hl, hl)
               for k in ("dt_bias", "a_log", "d_skip")},
            "gnorm": per_head["gnorm"][i].narrow(0, j * dl, dl),
            "out_proj": out_proj[i]})
    return out


def _gnorm_out_stage(ps, cfg: ArchConfig, gs, mesh):
    """``gnorm`` (an RMS over the whole inner width: each shard's float32
    sum of squares summed over "model") and ``out_proj`` (each shard's
    rows, the partials summed over "model" in float32): the block's
    output before the residual, one per shard."""
    width = cfg.ssm.expand * cfg.d_model
    sq = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            sq.append(torch.sum(torch.square(gs[i].to(F32)), dim=-1,
                                keepdim=True))
    total = mesh_sum(sq, mesh, axis=TP_AXIS)
    parts = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            g = gs[i]
            inv = torch.rsqrt(total[i] / width + cfg.norm_eps).to(g.dtype)
            parts.append((g * inv * ps[i]["gnorm"]) @ ps[i]["out_proj"])
    return tp_sum(parts, mesh, gs[0].dtype)


def mamba2_stage(p, cfg: ArchConfig, xs, mesh):
    """The Mamba-2 block's prefill over "model": every shard runs its own
    SSM heads (one SSD scan launch a shard on the card, ``heads`` = nh /
    tp); returns (the outputs, one per shard; each shard's (final state of
    its heads, conv state of its x channels and bm, cm))."""
    ps = tp_mamba2_params(p, cfg, mesh)
    hl = tp_ssm_heads(cfg, mesh.shape.get(TP_AXIS, 1))
    gs, states = [], []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            g, s_fin, conv_in = _mamba2_mix(ps[i], cfg, xs[i], hl)
        gs.append(g)
        states.append((s_fin, _conv_state(conv_in, cfg.ssm.conv_dim)))
    ys = _gnorm_out_stage(ps, cfg, gs, mesh)
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            outs.append(xs[i] + ys[i])
    return outs, states


def mamba2_decode_stage(p, cfg: ArchConfig, xs, states, mesh):
    """One decode step of the Mamba-2 block over "model": every shard
    steps its own heads' state and its conv window; returns (the outputs,
    the new states), one per shard."""
    ps = tp_mamba2_params(p, cfg, mesh)
    hl = tp_ssm_heads(cfg, mesh.shape.get(TP_AXIS, 1))
    gs, new = [], []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            g, st = _mamba2_step_mix(ps[i], cfg, xs[i], states[i], hl)
        gs.append(g)
        new.append(st)
    ys = _gnorm_out_stage(ps, cfg, gs, mesh)
    outs = []
    for i, dev in enumerate(mesh.devices):
        with on_shard(dev):
            outs.append(xs[i] + ys[i][:, None])
    return outs, new


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block (chunk-parallel) and sLSTM block (sequential)
# ---------------------------------------------------------------------------
GATE_CAP = 4.0   # soft cap replacing the xLSTM stabilizer in the chunked path


def mlstm_decls(cfg: ArchConfig) -> Dict[str, PDecl]:
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    nh = cfg.attention.n_heads
    return {
        "norm": PDecl((d,), (None,), init="ones"),
        "up": PDecl((d, 2 * di), ("embed", "ff")),
        "conv_w": PDecl((s.conv_dim, di), ("conv", None), scale=0.3),
        "conv_b": PDecl((di,), (None,), init="zeros"),
        "wq": PDecl((di, di), ("ff", None)),
        "wk": PDecl((di, di), ("ff", None)),
        "wv": PDecl((di, di), ("ff", None)),
        "wgate": PDecl((d, 2 * nh), ("embed", None), dtype=F32),
        "bgate": PDecl((2 * nh,), (None,), dtype=F32, init="zeros"),
        "gnorm": PDecl((di,), (None,), init="ones"),
        "down": PDecl((di, d), ("ff", "embed")),
    }


def _mlstm_qkv(p, cfg, hin):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = cfg.attention.n_heads
    hd = di // nh
    xb, z = torch.chunk(hin @ p["up"], 2, dim=-1)
    return xb, z, di, nh, hd


def _mlstm_gates(p, hin):
    """(log-decay logsigmoid(f), input gate exp(min(i, GATE_CAP))), each
    (..., nh) float32."""
    gates = hin.to(F32) @ p["wgate"] + p["bgate"]
    ig, fg = torch.chunk(gates, 2, dim=-1)
    return F.logsigmoid(fg), torch.exp(torch.clamp(ig, max=GATE_CAP))


def mlstm_forward(p, cfg: ArchConfig, x, return_state: bool = False):
    """mLSTM via SSD: decay = logsigmoid(f), input i = exp(min(i_raw,
    cap)), the state driven by (i * v) k^T and queried by q; the
    normalizer through an extra all-ones value channel.  The heads are
    folded into the batch (one SSD lane a head, B and C per lane)."""
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    xb, z, di, nh, hd = _mlstm_qkv(p, cfg, hin)
    conv = F.silu(causal_conv(xb, p["conv_w"], p["conv_b"]))
    b, steps = x.shape[:2]
    q = (conv @ p["wq"]).reshape(b, steps, nh, hd)
    k = (conv @ p["wk"]).reshape(b, steps, nh, hd)
    v = (xb @ p["wv"]).reshape(b, steps, nh, hd)
    la, i = _mlstm_gates(p, hin)                               # (B,S,nh)
    scale = 1.0 / np.sqrt(hd)
    # one SSD per head: state dim = key dim; v' = [v, 1] for the normalizer
    vn = torch.cat([v.to(F32), torch.ones_like(v[..., :1], dtype=F32)], -1)
    xbar = vn * i[..., None]

    def fold(t):  # (B,S,nh,*) -> (B*nh, S, 1, *)
        return torch.movedim(t, 2, 1).reshape(b * nh, steps, 1, *t.shape[3:])
    y, s_fin = ssd_chunked(fold(xbar), fold(la[..., None])[..., 0],
                           fold(k.to(F32) * scale)[:, :, 0],
                           fold(q.to(F32))[:, :, 0], cfg.ssm.chunk)
    y = torch.movedim(y.reshape(b, nh, steps, hd + 1), 1, 2)
    num, den = y[..., :hd], y[..., hd:]
    h = num / torch.clamp(den.abs(), min=1.0)
    h = h.reshape(b, steps, di).to(x.dtype)
    h = rms_norm(h * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = x + h @ p["down"]
    if return_state:
        cw = cfg.ssm.conv_dim
        conv_state = F.pad(xb, (0, 0, cw - 1, 0))[:, -(cw - 1):]
        return out, (s_fin.reshape(b, nh, hd, hd + 1), conv_state)
    return out


def mlstm_init_state(cfg: ArchConfig, batch: int, device):
    di = cfg.ssm.expand * cfg.d_model
    nh = cfg.attention.n_heads
    hd = di // nh
    return {
        "ssm": torch.zeros((batch, nh, hd, hd + 1), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, di),
                            dtype=torch.bfloat16, device=device),
    }


def mlstm_decode(p, cfg: ArchConfig, x1, state):
    """x1: (B,1,d). state: {"ssm" (B,nh,hd,hd+1), "conv"}.  Returns (out
    (B,1,d), state)."""
    hin = rms_norm(x1[:, 0], p["norm"], cfg.norm_eps)
    xb, z, di, nh, hd = _mlstm_qkv(p, cfg, hin)
    conv_state, conv = causal_conv_step(state["conv"], xb, p["conv_w"],
                                        p["conv_b"])
    conv = F.silu(conv)
    q = (conv @ p["wq"]).reshape(-1, nh, hd)
    k = (conv @ p["wk"]).reshape(-1, nh, hd)
    v = (xb @ p["wv"]).reshape(-1, nh, hd)
    la, i = _mlstm_gates(p, hin)                               # (B,nh)
    scale = 1.0 / np.sqrt(hd)
    vn = torch.cat([v.to(F32), torch.ones_like(v[..., :1], dtype=F32)], -1)
    s_new = state["ssm"] * torch.exp(la)[..., None, None] + torch.einsum(
        "bhk,bhp->bhkp", k.to(F32) * scale, vn * i[..., None])
    y = torch.einsum("bhk,bhkp->bhp", q.to(F32), s_new)
    h = (y[..., :hd] / torch.clamp(y[..., hd:].abs(), min=1.0)) \
        .reshape(-1, di)
    h = rms_norm(h.to(x1.dtype) * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = x1 + (h @ p["down"])[:, None]
    return out, {"ssm": s_new, "conv": conv_state}


# --- sLSTM -----------------------------------------------------------------
def slstm_decls(cfg: ArchConfig) -> Dict[str, PDecl]:
    d = cfg.d_model
    nh = cfg.attention.n_heads
    hd = d // nh
    ffs = int(d * 4 / 3 / 64) * 64 or 64
    return {
        "norm": PDecl((d,), (None,), init="ones"),
        "w": PDecl((d, 4 * d), ("embed", "ff")),
        "r": PDecl((nh, hd, 4 * hd), (None, None, None), scale=0.05),
        "b": PDecl((4 * d,), (None,), dtype=F32, init="zeros"),
        "gnorm": PDecl((d,), (None,), init="ones"),
        "up": PDecl((d, 2 * ffs), ("embed", "ff")),
        "down": PDecl((ffs, d), ("ff", "embed")),
    }


def slstm_cell(params_r, b, nh, hd, carry, wx_t):
    """Stabilized sLSTM step.  carry: (c, n, h, m) each (B, nh, hd).

    wx_t: (B, 4d) laid out as [z|i|f|o] each d = nh*hd wide; the recurrent
    matrix R (nh, hd, 4*hd) produces the same four gates per head.
    """
    c, n, h, m = carry
    bsz = wx_t.shape[0]
    rh = torch.einsum("bhk,hkg->bhg", h, params_r)             # (B,nh,4*hd)
    wx4 = wx_t.reshape(bsz, 4, nh, hd).permute(0, 2, 1, 3)     # (B,nh,4,hd)
    rh4 = rh.reshape(bsz, nh, 4, hd)
    b4 = b.reshape(4, nh, hd).permute(1, 0, 2)                 # (nh,4,hd)
    pre = wx4 + rh4 + b4
    zt, it, ft, ot = pre.unbind(2)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(log_f + m - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_forward(p, cfg: ArchConfig, x, return_state: bool = False):
    """The sLSTM block over a sequence: the input projection for every
    step at once, then the cell one step after another (the reference's
    ``lax.scan``), then the gated MLP.  ``return_state`` adds the final
    carry (c, n, h, m)."""
    d = cfg.d_model
    nh = cfg.attention.n_heads
    hd = d // nh
    b, steps, _ = x.shape
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    wx = (hin @ p["w"]).to(F32)                                # (B,S,4d)
    carry = tuple(torch.zeros((b, nh, hd), dtype=F32, device=x.device)
                  for _ in range(4))
    r = p["r"].to(F32)
    if x.is_meta:
        # the dry run: one step stands for the loop (its operations are
        # counted by launch/roofline.py's analytic_extra_flops), the
        # others' outputs shaped alike
        carry, h_t = slstm_cell(r, p["b"], nh, hd, carry, wx[:, 0])
        h = h_t[:, None].expand(b, steps, nh, hd)
    else:
        hs = []
        for t in range(steps):
            carry, h_t = slstm_cell(r, p["b"], nh, hd, carry, wx[:, t])
            hs.append(h_t)
        h = torch.stack(hs, dim=1)
    h = h.reshape(b, steps, d).to(x.dtype)
    h = rms_norm(h, p["gnorm"], cfg.norm_eps)
    u, v = torch.chunk(h @ p["up"], 2, dim=-1)
    out = x + (F.silu(u) * v) @ p["down"]
    if return_state:
        return out, carry
    return out


def slstm_init_state(cfg: ArchConfig, batch: int, device):
    nh = cfg.attention.n_heads
    hd = cfg.d_model // nh
    return tuple(torch.zeros((batch, nh, hd), dtype=F32, device=device)
                 for _ in range(4))


def slstm_decode(p, cfg: ArchConfig, x1, state):
    d = cfg.d_model
    nh = cfg.attention.n_heads
    hd = d // nh
    hin = rms_norm(x1[:, 0], p["norm"], cfg.norm_eps)
    wx = (hin @ p["w"]).to(F32)
    state, h = slstm_cell(p["r"].to(F32), p["b"], nh, hd, state, wx)
    h = h.reshape(-1, d).to(x1.dtype)
    h = rms_norm(h, p["gnorm"], cfg.norm_eps)
    u, v = torch.chunk(h @ p["up"], 2, dim=-1)
    out = x1 + ((F.silu(u) * v) @ p["down"])[:, None]
    return out, state

"""Recurrent blocks of the port: the Mamba-2 (SSD) half of the JAX
package's ``models/ssm.py``.

The SSD chunked scan follows Dao & Gu (arXiv:2405.21060): within-chunk
terms are dense products, the inter-chunk recurrence carries an (N x P)
state per head.  :func:`ssd_chunked` routes by where its tensors lie: on
the card it calls the hand-written SSD scan kernel (``kernels.ops.
ssd_scan``) with the heads folded into the lanes and B, C shared by the
heads of a batch row; on the CPU it runs the reference's chunked math,
ported line for line.  Decoding (``ssd_step``, ``causal_conv_step``) has
no kernel in the reference and runs as plain PyTorch on either device.

The reference's sharding ``rules`` argument is dropped (a no-op on one
card).  mLSTM and sLSTM (the xLSTM family) are not ported yet (ROADMAP
item 15).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.param import PDecl

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
    if xbar.is_cuda:
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


def _mamba2_split(p, cfg, h):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    n = s.state_dim
    nh = di // s.head_dim
    z, xc, bm, cm, dt = torch.split(h, [di, di, n, n, nh], dim=-1)
    return z, xc, bm, cm, dt, di, n, nh


def mamba2_forward(p, cfg: ArchConfig, x, return_state: bool = False):
    s = cfg.ssm
    hin = rms_norm(x, p["norm"], cfg.norm_eps)
    h = hin @ p["in_proj"]
    z, xc, bm, cm, dt, di, n, nh = _mamba2_split(p, cfg, h)
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out = F.silu(causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xc, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])                  # (B,S,nh)
    la = -torch.exp(p["a_log"]) * dt
    xh = xc.reshape(*xc.shape[:2], nh, s.head_dim).to(F32)
    xbar = xh * dt[..., None]
    y, s_fin = ssd_chunked(xbar, la, bm.to(F32), cm.to(F32), s.chunk)
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(*x.shape[:2], di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    if return_state:
        cw = s.conv_dim
        conv_state = F.pad(conv_in, (0, 0, cw - 1, 0))[:, -(cw - 1):]
        return out, (s_fin, conv_state)
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


def mamba2_decode(p, cfg: ArchConfig, x1, state):
    """x1: (B,1,d). state: {"ssm","conv"}. Returns (out (B,1,d), state)."""
    s = cfg.ssm
    hin = rms_norm(x1[:, 0], p["norm"], cfg.norm_eps)
    h = hin @ p["in_proj"]
    z, xc, bm, cm, dt, di, n, nh = _mamba2_split(p, cfg, h)
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_state, conv_out = causal_conv_step(
        state["conv"], conv_in, p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out)
    xc, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])                  # (B,nh)
    la = -torch.exp(p["a_log"]) * dt
    xh = xc.reshape(-1, nh, s.head_dim).to(F32)
    ssm, y = ssd_step(state["ssm"], xh * dt[..., None], la,
                      bm.to(F32), cm.to(F32))
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(-1, di).to(x1.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = x1 + (y @ p["out_proj"])[:, None]
    return out, {"ssm": ssm, "conv": conv_state}

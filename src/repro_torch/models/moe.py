"""Mixture-of-experts FFN of the port: shared + routed experts, top-k
routing, the reference's single-shard dispatch.

The reference (``repro.models.moe``) has three dispatch paths, chosen by
the size of the expert axis: ``local`` (one shard: sort + capacity
scatter), ``a2a`` (expert parallelism over ``all_to_all``) and
``dense_ep`` (decode across expert shards).  The port runs on one card and
has the first only; an expert axis larger than 1 raises (ROADMAP items 10
and 11b).  The grouped expert products are plain batched products
(``torch.bmm``), as the reference leaves them to XLA outside any Pallas
kernel.

Where the two packages must pick the same tokens:
* ``top_k`` breaks ties by the lower expert index, as ``jax.lax.top_k``
  does: a stable descending sort, cut at k;
* the tokens are sorted by expert with a stable sort, as ``jnp.argsort``
  sorts, because which tokens a full expert drops depends on that order;
* the combine adds each token's k weighted rows in a fixed order (back to
  (token, k) order, then a sum over k), so that two identical calls on the
  card give the same bits; an atomic scatter-add would not.

Routed experts may be padded (qwen2-moe 60 -> 64 for an expert axis of
16); the router masks padded experts so that they are never selected.
The router and the shared expert's gate are float32 parameters and their
products are taken in float32, whatever the activations' type.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import act_fn, mlp_decls, mlp_forward
from repro_torch.models.param import PDecl

F32 = torch.float32


def padded_experts(m: MoEConfig, ep_size: int) -> int:
    e = m.n_routed
    if ep_size > 1 and e % ep_size:
        e = ((e + ep_size - 1) // ep_size) * ep_size
    return e


def moe_decls(cfg: ArchConfig, ep_size: int = 16) -> Dict[str, PDecl]:
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    e = padded_experts(m, ep_size)
    decls = {
        "router": PDecl((d, e), ("embed", None), dtype=F32),
        "wi": PDecl((e, d, 2, f), ("experts", "embed_tp", None, "expert_ff")),
        "wo": PDecl((e, f, d), ("experts", "expert_ff", "embed_tp")),
    }
    if m.d_shared:
        decls["shared"] = mlp_decls(d, m.d_shared, glu=True)
        if m.shared_gate:
            decls["shared_gate"] = PDecl((d, 1), ("embed", None), dtype=F32)
    return decls


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, m: MoEConfig, x_flat, e_pad: int):
    """Router: top-k probs over the true experts; padded experts masked.
    Returns (top_w (T, k) f32, top_e (T, k) int64, aux)."""
    logits = x_flat.to(F32) @ p["router"].to(F32)
    if e_pad > m.n_routed:
        neg = torch.full((x_flat.shape[0], e_pad - m.n_routed), -1e9,
                         dtype=F32, device=x_flat.device)
        logits = torch.cat([logits[:, : m.n_routed], neg], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, m.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing aux loss
    dispatch = torch.zeros_like(probs).scatter_add_(
        1, top_e, torch.ones_like(top_w))
    aux = m.n_routed * torch.sum(dispatch.mean(0) * probs.mean(0))
    return top_w, top_e, aux


def _capacity(t: int, m: MoEConfig, e_pad: int) -> int:
    """Per-expert token capacity for a dispatch pool of ``t`` tokens:
    serving-size pools (t <= 256) are dropless."""
    if t <= 256:
        return t
    return max(int(np.ceil(t * m.top_k / e_pad * m.capacity_factor)),
               m.top_k)


def _expert_mlp(wi, wo, h, act: str):
    """h: (E, C, d) grouped tokens -> (E, C, d)."""
    e, d = wi.shape[:2]
    uv = torch.bmm(h, wi.reshape(e, d, -1)).unflatten(-1, wi.shape[2:])
    u, v = uv[..., 0, :], uv[..., 1, :]
    return torch.bmm(act_fn(act)(u) * v, wo)


def _capacity_dispatch(x_flat, top_w, top_e, e_pad: int, cap: int):
    """Sort and scatter tokens into an (E, cap, d) buffer.

    Returns (buf, order, se, pos_c, st, sw, keep): the buffer and the
    bookkeeping that gathers the results back to token order (``order``
    sorts the flat (token, k) rows by expert, stably)."""
    t, k = top_e.shape
    e_flat = top_e.reshape(-1)
    w_flat = top_w.reshape(-1)
    tok = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    se, st, sw = e_flat[order], tok[order], w_flat[order]
    # the experts' counts by a scatter-add: bincount on the card reads its
    # input's maximum back to the host, a sync in every MoE layer
    counts = torch.zeros(e_pad, dtype=e_flat.dtype, device=e_flat.device) \
        .scatter_add_(0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=x_flat.device) - starts[se]
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.full_like(pos, cap))
    # whole rows copied into the flat (E * (cap + 1), d) buffer; dropped
    # rows land in the spare slot ``cap`` of their expert, which is cut off
    d = x_flat.shape[-1]
    buf = torch.zeros((e_pad, cap + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    buf.view(-1, d).index_copy_(0, se * (cap + 1) + pos_c,
                                x_flat.index_select(0, st))
    return buf[:, :cap], order, se, pos_c, st, sw, keep


def _combine(y_buf, order, se, pos_c, sw, keep, t: int):
    """Each token's k rows, weighted (dropped rows 0), summed over k in a
    fixed order: back to (token, k) order by the inverse of ``order``."""
    e_pad, cap, d = y_buf.shape
    pad = torch.zeros((e_pad, 1, d), dtype=y_buf.dtype, device=y_buf.device)
    yb = torch.cat([y_buf, pad], dim=1).view(-1, d)
    rows = yb.index_select(0, se * (cap + 1) + pos_c) \
        * (sw * keep)[:, None].to(y_buf.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return rows.index_select(0, inv).reshape(t, -1, d).sum(1)


def _moe_local(p, cfg: ArchConfig, x, e_pad: int):
    """The single-shard routed path (the reference's oracle of its EP
    paths)."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    top_w, top_e, aux = _route(p, m, xf, e_pad)
    cap = _capacity(t, m, e_pad)
    buf, order, se, pos_c, _, sw, keep = _capacity_dispatch(
        xf, top_w, top_e, e_pad, cap)
    y_buf = _expert_mlp(p["wi"], p["wo"], buf, cfg.act)
    y = _combine(y_buf, order, se, pos_c, sw, keep, t)
    return y.reshape(b, s, d), aux


def moe_forward(p, cfg: ArchConfig, x, ep: int = 1):
    """Routed + shared experts.  Returns (y, aux_loss).  ``ep`` is the
    size of the expert axis: only 1 (one card) is ported."""
    if ep != 1:
        raise NotImplementedError(
            f"expert parallelism (an expert axis of {ep}: the reference's "
            "_moe_a2a / _moe_dense_ep) is not ported yet (ROADMAP items 10 "
            "and 11b); the port runs the single-shard dispatch, ep=1")
    m = cfg.moe
    y, aux = _moe_local(p, cfg, x, padded_experts(m, ep))
    if m.d_shared:
        sh = mlp_forward(p["shared"], x, cfg.act, glu=True)
        if m.shared_gate:
            gate = torch.sigmoid(x.to(F32) @ p["shared_gate"].to(F32))
            sh = sh * gate.to(sh.dtype)
        y = y + sh
    return y, m.router_aux_coef * aux

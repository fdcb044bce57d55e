"""Mixture-of-experts FFN of the port: shared + routed experts, top-k
routing, and the reference's three dispatch paths, chosen by the size of
the expert axis (``ep``: the mesh's ``ep_axis``) and the token count:

* ``local``    — one shard: sort + capacity scatter, no collectives;
* ``a2a``      — expert parallelism: tokens are cut along the sequence
                 over the expert axis, each shard routes its own tokens
                 and fills capacity buffers from its own pool, an
                 all-to-all sends each expert's rows to the shard that
                 holds it, the experts run, a second all-to-all brings the
                 rows back, and each shard combines its tokens;
* ``dense_ep`` — decode (few tokens): every shard computes its experts'
                 contributions for all of its tokens in float32, summed
                 over the expert axis in shard order.

The shared expert on an expert axis of more than one shard: in ``a2a``
each shard runs it whole on its own tokens, its leaves gathered
(``_shared_seq``: the tokens are already cut along the sequence, so no
sum is needed); in ``dense_ep`` each shard runs its block of the shared
width (tensor parallel, ``tp_mlp_params``) and adds that partial, gated,
into its float32 contribution before the one sum.  A router or shared
gate placed over "data" (FSDP) is gathered before use.

PyTorch has no ``shard_map``: each EP path is its stages between the
collectives (sharding/collectives.py), each stage run on every shard in
shard order; a shard reads only its ``e_pad / ep`` slice of ``wi`` and
``wo`` (a view on a simulated mesh).  The aux loss is the mean over the
expert axis of each shard's aux, and the value returned is shard 0's (the
reference's ``out_specs P()`` with its replication check off).  The
grouped expert products are plain batched products (``torch.bmm``), as
the reference leaves them to XLA outside any Pallas kernel.

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

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import (
    act_fn, mlp_decls, mlp_forward, replicated, tp_mlp_params,
)
from repro_torch.models.param import PDecl
from repro_torch.sharding.collectives import (
    ShardedLeaf, mesh_all_to_all, mesh_mean, mesh_sum, on_shard,
    shard_map_specs,
)

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


def _shared_forward(p, cfg: ArchConfig, x):
    """The shared expert on ``x``, gated by ``shared_gate`` in float32
    where the config gates it."""
    sh = mlp_forward(p["shared"], x, cfg.act, glu=True)
    if cfg.moe.shared_gate:
        gate = torch.sigmoid(x.to(F32) @ p["shared_gate"].to(F32))
        sh = sh * gate.to(sh.dtype)
    return sh


def _whole_on_mesh(leaf, mesh):
    """A leaf every shard of the EP paths reads whole: as it is when it
    is a tensor, else gathered where it is placed (``ShardedLeaf`` of
    spec ``(None, ...)``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return ShardedLeaf(replicated(leaf, mesh), (None,) * len(leaf.shape),
                       mesh)


def _shared_seq(p, cfg: ArchConfig, x, mesh, ep_axis: str, dp_axes=None):
    """The a2a path's shared expert: each shard's own tokens (the batch
    over the data axes, the sequence over the expert axis) through the
    whole shared expert, its leaves gathered where they are placed."""
    shared = {k: replicated(v, mesh) for k, v in p["shared"].items()}
    gate = replicated(p["shared_gate"], mesh) if cfg.moe.shared_gate \
        else None

    def stages(xs):
        outs = []
        for i, dev in enumerate(mesh.devices):
            with on_shard(dev):
                q = {"shared": {k: v[i] for k, v in shared.items()}}
                if gate is not None:
                    q["shared_gate"] = gate[i]
                outs.append(_shared_forward(q, cfg, xs[i]))
        return (outs,)

    spec = (dp_axes, ep_axis, None)
    return shard_map_specs(stages, mesh, (spec,), (spec,))(x)[0]


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


def _moe_a2a(p, cfg: ArchConfig, x, e_pad: int, mesh, ep_axis: str,
             dp_axes=None):
    """Expert-parallel dispatch: the tokens cut along the sequence over the
    expert axis, each expert's rows exchanged with the shard that holds it
    and back."""
    m = cfg.moe
    d = x.shape[-1]
    ep = mesh.shape[ep_axis]
    e_loc = e_pad // ep
    devices = mesh.devices

    def stages(xs, routers, wis, wos):
        sent, books, auxes = [], [], []
        for i, dev in enumerate(devices):            # route and dispatch
            with on_shard(dev):
                xf = xs[i].reshape(-1, d)
                t = xf.shape[0]
                top_w, top_e, aux = _route({"router": routers[i]}, m, xf,
                                           e_pad)
                cap = _capacity(t, m, e_pad)
                buf, order, se, pos_c, _, sw, keep = _capacity_dispatch(
                    xf, top_w, top_e, e_pad, cap)
                sent.append(buf.reshape(ep, e_loc, cap, d))
                books.append((order, se, pos_c, sw, keep, t, cap))
                auxes.append(aux)
        # recv: (ep, e_loc, cap, d), sender-major groups for local experts
        recv = mesh_all_to_all(sent, mesh, ep_axis)
        done = []
        for i, dev in enumerate(devices):            # the local experts
            with on_shard(dev):
                cap = books[i][-1]
                h = recv[i].transpose(0, 1).reshape(e_loc, ep * cap, d)
                y = _expert_mlp(wis[i], wos[i], h, cfg.act)
                done.append(y.reshape(e_loc, ep, cap, d).transpose(0, 1))
        back = mesh_all_to_all(done, mesh, ep_axis)
        outs = []
        for i, dev in enumerate(devices):            # combine
            with on_shard(dev):
                order, se, pos_c, sw, keep, t, cap = books[i]
                y = _combine(back[i].reshape(e_pad, cap, d), order, se,
                             pos_c, sw, keep, t)
                outs.append(y.reshape(xs[i].shape))
        return outs, mesh_mean(auxes, mesh, ep_axis)

    fn = shard_map_specs(
        stages, mesh,
        in_specs=((dp_axes, ep_axis, None), (None, None),
                  (ep_axis, None, None, None), (ep_axis, None, None)),
        out_specs=((dp_axes, ep_axis, None), ()))
    return fn(x, p["router"], p["wi"], p["wo"])


def _moe_dense_ep(p, cfg: ArchConfig, x, e_pad: int, mesh, ep_axis: str,
                  dp_axes=None):
    """Decode path: each expert shard computes its experts' contributions
    for all of its tokens, weighted in float32 and summed over the expert
    axis in shard order, then cast.  Where ``p`` holds the shared expert,
    each shard adds its block of the shared width's output (gated) into
    its contribution before the sum."""
    m = cfg.moe
    d = x.shape[-1]
    ep = mesh.shape[ep_axis]
    e_loc = e_pad // ep
    devices = mesh.devices
    shared = tp_mlp_params(p["shared"], mesh, ep_axis) if "shared" in p \
        else None
    gate = replicated(p["shared_gate"], mesh) if "shared_gate" in p \
        else None

    def stages(xs, routers, wis, wos):
        parts, auxes = [], []
        for i, dev in enumerate(devices):
            with on_shard(dev):
                xf = xs[i].reshape(-1, d)
                t = xf.shape[0]
                top_w, top_e, aux = _route({"router": routers[i]}, m, xf,
                                           e_pad)
                e0 = mesh.axis_index(i, ep_axis) * e_loc
                # weight of each local expert for each token (T, e_loc);
                # a token's k experts differ, so each (row, column) is
                # written once a pass
                w_local = torch.zeros((t, e_loc), dtype=F32, device=xf.device)
                rows = torch.arange(t, device=xf.device)
                for j in range(m.top_k):
                    idx = top_e[:, j] - e0
                    hit = (idx >= 0) & (idx < e_loc)
                    col = idx.clamp(0, e_loc - 1)
                    w_local[rows, col] = w_local[rows, col] + torch.where(
                        hit, top_w[:, j], torch.zeros_like(top_w[:, j]))
                h = xf.unsqueeze(0).expand(e_loc, t, d)
                y = _expert_mlp(wis[i], wos[i], h, cfg.act)     # (e_loc, T, d)
                part = torch.einsum("etd,te->td", y.to(F32), w_local)
                if shared is not None:
                    q = {"shared": shared[i]}
                    if gate is not None:
                        q["shared_gate"] = gate[i]
                    part = part + _shared_forward(q, cfg, xf).to(F32)
                parts.append(part)
                auxes.append(aux)
        summed = mesh_sum(parts, mesh, axis=ep_axis)
        outs = [o.to(xs[i].dtype).reshape(xs[i].shape)
                for i, o in enumerate(summed)]
        return outs, mesh_mean(auxes, mesh, ep_axis)

    fn = shard_map_specs(
        stages, mesh,
        in_specs=((dp_axes, None, None), (None, None),
                  (ep_axis, None, None, None), (ep_axis, None, None)),
        out_specs=((dp_axes, None, None), ()))
    return fn(x, p["router"], p["wi"], p["wo"])


def moe_forward(p, cfg: ArchConfig, x, mesh=None,
                ep_axis: Optional[str] = None):
    """Routed + shared experts.  Returns (y, aux_loss).  With a ``mesh``
    whose ``ep_axis`` is larger than 1 the routed experts run expert
    parallel: ``_moe_a2a`` when the sequence splits over the expert axis
    and the batch holds at least 256 tokens (the shared expert then
    ``_shared_seq``), else ``_moe_dense_ep`` (the shared expert's blocks
    inside it); the batch is cut over the data axes where it divides
    them."""
    m = cfg.moe
    ep = mesh.shape[ep_axis] if (mesh is not None and ep_axis) else 1
    e_pad = padded_experts(m, ep)
    b, s, _ = x.shape
    if ep == 1:
        y, aux = _moe_local(p, cfg, x, e_pad)
        if m.d_shared:
            y = y + _shared_forward(p, cfg, x)
        return y, m.router_aux_coef * aux
    # batch must divide the data axes for the split; degrade to a
    # replicated batch otherwise (long-context cells with batch 1)
    dp_axes = ("pod", "data") if "pod" in mesh.shape else ("data",)
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape[a]
    if b % dp_size:
        dp_axes = None
    routed = {"router": _whole_on_mesh(p["router"], mesh), "wi": p["wi"],
              "wo": p["wo"]}
    if s % ep == 0 and b * s >= 256:
        y, aux = _moe_a2a(routed, cfg, x, e_pad, mesh, ep_axis, dp_axes)
        if m.d_shared:
            y = y + _shared_seq(p, cfg, x, mesh, ep_axis, dp_axes)
    else:
        if m.d_shared:
            routed["shared"] = p["shared"]
            if m.shared_gate:
                routed["shared_gate"] = p["shared_gate"]
        y, aux = _moe_dense_ep(routed, cfg, x, e_pad, mesh, ep_axis, dp_axes)
    return y, m.router_aux_coef * aux

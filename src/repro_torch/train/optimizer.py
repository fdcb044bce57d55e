"""AdamW from scratch: bf16 params, float32 master weights and moments,
global-norm clipping, warmup and cosine schedule, optional int8 gradient
compression with error feedback (the reference's
``train/optimizer.py``, on the port's parameter trees).

The optimizer state is ``{"step": int32 scalar, "master", "m", "v"}``
(and ``"err"`` under ``compress_grads``), each a tree shaped like the
parameters, on their device.  ``adamw_update`` updates the float32 state
in place, where the reference returns new arrays: at 1.49 B parameters
(h2o-danube-3-4b cut to 8 layers) that saves the 18 GB of a second
master, m and v.  It returns the new parameters (the master cast to each
parameter's type) as new tensors, as the reference does.

On a mesh (``mesh=``, the trees placed by ``models/param.py::shard_params``
with the state by ``shard_opt_state``) the update runs on each shard's
parts, as the reference's sharded update runs on each device's blocks:
each distinct block (``placed_blocks``) is written once where its holders
share one storage (a simulated mesh: parts are views of one tensor) and on
each card of an NCCL mesh, where every holder keeps its own copy; the
global norm sums the squares of each block once, on the shard that owns
it, then over the mesh (``mesh_sum``); ``compress_int8``'s per-leaf scale
is the largest magnitude over the leaf's blocks (``mesh_gather`` of each
shard's largest).  There the parameters' blocks are written in place, so
that the placed tree keeps its layout (the reference donates them).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.param import (
    placed_blocks, shard_params, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.sharding.collectives import (
    ShardedLeaf, mesh_gather, mesh_sum, on_device,
)

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False      # int8 + error feedback


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup, then a
    cosine from lr down to ``min_lr_frac`` of it, in float32."""
    step = step.to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def init_opt_state(params, cfg: OptConfig):
    device = tree_leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        "m": tree_map(_zeros_f32, params),
        "v": tree_map(_zeros_f32, params),
    }
    if cfg.compress_grads:
        state["err"] = tree_map(_zeros_f32, params)
    return state


def shard_opt_state(state, decls, mesh, rules):
    """A one-device optimizer state placed on ``mesh`` as the parameters
    are (``shard_params`` of master, m, v and err; ``step`` on the lead
    device)."""
    return {k: v if k == "step" else shard_params(v, decls, mesh, rules)
            for k, v in state.items()}


def global_norm(tree, mesh=None) -> torch.Tensor:
    """The square root of the sum of every leaf's squares; of a tree
    placed on ``mesh``, each distinct block counted once (on the lead
    device)."""
    if mesh is not None and any(n > 1 for n in mesh.dims):
        n = len(mesh.devices)
        return _placed_norms(
            [[t.to(F32) for t in _parts(x, n)] for x in tree_leaves(tree)],
            [placed_blocks(x, mesh) for x in tree_leaves(tree)], mesh)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def compress_int8(g, err):
    """int8 quantize with error feedback: returns (q_dequantized, new_err).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    gf = g.to(F32) + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return deq, gf - deq


def _zip(*trees):
    """[(leaf of each tree)] in the first tree's flattening order."""
    return list(zip(*(tree_leaves(t) for t in trees)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, mesh=None):
    """Returns (new_params, new_state, metrics); ``state``'s float32
    trees are updated in place (see the module's note).  Trees placed on
    a ``mesh`` with an axis of more than one shard take
    ``_adamw_placed``."""
    if mesh is not None and any(n > 1 for n in mesh.dims):
        return _adamw_placed(params, grads, state, cfg, mesh)
    step = state["step"] + 1
    lr = schedule(cfg, step)

    if cfg.compress_grads:
        deq = []
        for g, err in _zip(grads, state["err"]):
            d, new_err = compress_int8(g, err)
            err.copy_(new_err)
            deq.append(d)
        grads = tree_unflatten(grads, deq)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    stepf = step.to(F32)
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    for g, master, m, v in _zip(grads, state["master"], state["m"],
                                state["v"]):
        g = g.to(F32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if master.dim() >= 2:               # decay on matrices only
            update = update + cfg.weight_decay * master
        master.sub_(lr * update)
    # the master weights cast to each parameter's type, as new tensors
    new_params = tree_unflatten(params, [
        mp.to(p.dtype, copy=True)
        for p, mp in _zip(params, state["master"])])
    state["step"] = step
    return new_params, state, {"lr": lr, "grad_norm": gnorm}


def _parts(leaf, n: int):
    """A placed leaf's parts, one per shard (a tensor every shard
    shares, n times)."""
    return list(leaf.parts) if isinstance(leaf, ShardedLeaf) else [leaf] * n


def _over_mesh(parts, mesh, combine):
    """``combine`` (mesh_sum, or a gather and its max) over every axis of
    more than one shard, one after the other."""
    for axis in mesh.axis_names:
        if mesh.shape[axis] > 1:
            parts = combine(parts, axis)
    return parts


def _placed_norms(gs, blocks, mesh):
    """The global norm on every shard (one (1,) tensor a shard): each
    block's squares once, on its owner, then summed over the mesh.
    ``gs``: each leaf's float32 parts; ``blocks``: each leaf's
    ``placed_blocks``."""
    sq = [torch.zeros((), dtype=F32, device=dev) for dev in mesh.devices]
    for g, bl in zip(gs, blocks):
        for block in bl:
            sq[block.owner] = sq[block.owner] + torch.sum(
                torch.square(g[block.owner]))
    return [torch.sqrt(t) for t in _over_mesh(
        [t[None] for t in sq], mesh,
        lambda ps, axis: mesh_sum(ps, mesh, axis=axis))]


def _gathered_max(parts, axis, mesh):
    return [t.amax(0, keepdim=True)
            for t in mesh_gather(parts, 0, mesh, axis=axis)]


@torch.no_grad()
def _adamw_placed(params, grads, state, cfg: OptConfig, mesh):
    """``adamw_update`` on trees placed on ``mesh`` (see the module's
    note).  Returns (params, state, metrics): ``params`` the same tree,
    its blocks written."""
    n = len(mesh.devices)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    shared = mesh.collective != "nccl"
    names = ["master", "m", "v"] + (["err"] if cfg.compress_grads else [])
    leaves = [(p, [_parts(g, n)] + [_parts(x, n) for x in xs])
              for p, g, *xs in _zip(params, grads,
                                    *(state[k] for k in names))]
    blocks = [placed_blocks(p, mesh) for p, _ in leaves]

    def writers(block):
        return block.shards[:1] if shared else block.shards

    # each shard's gradients in float32 (dequantized under compress_grads),
    # computed once a storage: every shard reads its block's writer's
    gs = []
    for (p, (g, *xs)), bl in zip(leaves, blocks):
        src = {i: (b.shards[0] if shared else i) for b in bl
               for i in b.shards}
        done = {w: g[w].to(F32) for w in set(src.values())}
        if cfg.compress_grads:
            err = xs[3]
            done = {w: t + err[w] for w, t in done.items()}
            top = _over_mesh(
                [torch.clamp(done[src[i]].abs().max(), min=1e-12)[None]
                 for i in range(n)], mesh,
                lambda ps, axis: _gathered_max(ps, axis, mesh))
            for w, t in list(done.items()):
                scale = top[w][0] / 127.0
                q = torch.clamp(torch.round(t / scale), -127, 127).to(
                    torch.int8)
                deq = q.to(F32) * scale
                err[w].copy_(t - deq)
                done[w] = deq
        gs.append([done[src[i]] for i in range(n)])
    norms = _placed_norms(gs, blocks, mesh)
    for (p, (_, master, m, v, *_)), g, bl in zip(leaves, gs, blocks):
        pparts = _parts(p, n)
        for block in bl:
            for w in writers(block):
                dev = mesh.devices[w]
                gnorm = norms[w][0]
                scale = torch.clamp(cfg.clip_norm
                                    / torch.clamp(gnorm, min=1e-12), max=1.0)
                gw = g[w] * scale
                m[w].mul_(cfg.b1).add_((1 - cfg.b1) * gw)
                v[w].mul_(cfg.b2).add_((1 - cfg.b2) * gw * gw)
                update = (m[w] / on_device(bc1, dev)) / (
                    torch.sqrt(v[w] / on_device(bc2, dev)) + cfg.eps)
                if master[w].dim() >= 2:      # decay on matrices only
                    update = update + cfg.weight_decay * master[w]
                master[w].sub_(on_device(lr, dev) * update)
                pparts[w].copy_(master[w])
    state["step"] = step
    return params, state, {"lr": lr,
                           "grad_norm": on_device(norms[0][0], mesh.device)}

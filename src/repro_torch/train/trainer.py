"""Training loop (the reference's ``train/trainer.py`` on one device): a
train step (gradients of ``bundle.loss_fn`` by autograd, then AdamW) with
optional microbatch gradient accumulation, periodic checkpoints with
resume.

On the card attention's gradient is K5's backward kernel; the loss's
other gradients are PyTorch's.  The trainer runs on the card by default
and raises where there is none; pass ``device="cpu"`` for the plain
PyTorch route.  ``Trainer.run`` takes a ``SyntheticLM``-style iterator of
numpy batches and moves each to the parameters' device.

On a mesh (``Trainer(bundle, opt_cfg, tcfg, mesh)``, the reference's
signature; the bundle built on that mesh) the parameters and the
optimizer's master, m, v (and err) are placed by their specs
(``shard_params``, ``shard_opt_state``).  A step takes each shard's part
of each parameter as an autograd leaf, runs ``bundle.loss_fn`` (whose
stages' collectives differentiate as their adjoints), sums each block's
gradient over the shards that hold a copy of it (``mesh_sum`` over its
replica axes: the data-parallel all-reduce), and updates each block once
(``adamw_update`` with the mesh).  ``n_microbatch`` splits each data shard's
rows.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.models.lm import ModelBundle, _sharded
from repro_torch.models.param import (
    init_tree, placed_blocks, shard_params, tree_leaves, tree_map,
    tree_unflatten,
)
from repro_torch.sharding.collectives import ShardedLeaf, mesh_sum, on_device
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import (
    OptConfig, adamw_update, init_opt_state, shard_opt_state,
)

F32 = torch.float32


def grads_of(loss_fn, params, batch):
    """(loss, metrics, gradients shaped like ``params``): the parameters
    enter as fresh leaves (their storage shared), so the caller's tensors
    are left as they are."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(leaves, grads))


def shares_of(loss_fn, params, batch, mesh):
    """(loss, metrics, shares) on ``mesh``: each shard's part of each
    placed parameter (a tensor every shard shares: one part a shard)
    enters as a fresh autograd leaf (its storage shared), and ``shares``
    holds each part's gradient, that shard's share of the block's
    gradient, as a ``ShardedLeaf`` of the parameter's spec."""
    def fresh(t):
        if isinstance(t, ShardedLeaf):
            parts, spec = t.parts, t.spec
        else:
            parts = [on_device(t, dev) for dev in mesh.devices]
            spec = (None,) * t.dim()
        return ShardedLeaf([p.detach().requires_grad_(True) for p in parts],
                           spec, mesh)
    leaves = tree_map(fresh, params)
    loss, metrics = loss_fn(leaves, batch)
    flat = [p for leaf in tree_leaves(leaves) for p in leaf.parts]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    shares = tree_map(lambda leaf: ShardedLeaf(
        [torch.zeros_like(p) if g is None else g
         for p, g in zip(leaf.parts, grads)], leaf.spec, mesh), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            shares)


@torch.no_grad()
def reduce_shares(shares, params, mesh):
    """Each block's gradient: its shares summed in float32 over the
    shards that hold a copy of it (``mesh_sum`` over its replica axes,
    the data-parallel all-reduce), in ``params``' form (a tensor where
    the parameter is one)."""
    def one(share, p):
        parts = share.parts
        replicas = placed_blocks(p, mesh)[0].replicas
        if replicas:
            parts = [t.to(F32) for t in parts]
        for axis in replicas:
            parts = mesh_sum(parts, mesh, axis=axis)
        return ShardedLeaf(parts, share.spec, mesh) \
            if isinstance(p, ShardedLeaf) else parts[0]
    return tree_unflatten(params, [one(s, p) for s, p in zip(
        tree_leaves(shares), tree_leaves(params))])


def _rows(batch, mesh, n_microbatch: int):
    """Microbatch i of ``batch`` on ``mesh``: rows i of each data shard's
    rows cut into ``n_microbatch`` blocks, the data shards' blocks in
    order."""
    b = next(iter(batch.values())).shape[0]
    dp = mesh.shape.get("data", 1)
    dp = dp if b % dp == 0 else 1
    if b % (dp * n_microbatch):
        raise ValueError(f"{b} rows do not split into {n_microbatch} "
                         f"microbatches on each of {dp} data shards")
    return [{k: v.reshape(dp, n_microbatch, b // (dp * n_microbatch),
                          *v.shape[1:])[:, i].reshape(-1, *v.shape[1:])
             for k, v in batch.items()} for i in range(n_microbatch)]


def _placed_step(bundle, opt_cfg: OptConfig, n_microbatch: int, mesh):
    def step(params, opt_state, batch):
        loss, shares = None, None
        for mb in _rows(batch, mesh, n_microbatch):
            mloss, metrics, g = shares_of(bundle.loss_fn, params, mb, mesh)
            if shares is None:
                loss, shares = mloss, g
                if n_microbatch > 1:
                    shares = tree_map(lambda s: ShardedLeaf(
                        [p.to(F32) for p in s.parts], s.spec, mesh), shares)
                continue
            loss = loss + mloss
            for acc, gi in zip(tree_leaves(shares), tree_leaves(g)):
                for a, b in zip(acc.parts, gi.parts):
                    a.add_(b)
            del g
        grads = reduce_shares(shares, params, mesh)
        if n_microbatch > 1:
            loss = loss / n_microbatch
            grads = tree_map(lambda g: g / n_microbatch if isinstance(
                g, torch.Tensor) else ShardedLeaf(
                    [p / n_microbatch for p in g.parts], g.spec, mesh),
                grads)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, mesh)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return step


def make_train_step(bundle: ModelBundle, opt_cfg: OptConfig,
                    n_microbatch: int = 1, mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).  With
    ``n_microbatch`` > 1 the batch's leading axis is split into that many
    microbatches, their gradients summed in float32 and divided by
    ``n_microbatch`` (and the loss too); the metrics are the last
    microbatch's, as in the reference.  On a ``mesh`` with an axis of
    more than one shard the trees are placed (see the module's note)."""
    if _sharded(mesh):
        return _placed_step(bundle, opt_cfg, n_microbatch, mesh)
    loss_fn = bundle.loss_fn

    def step(params, opt_state, batch):
        if n_microbatch == 1:
            loss, metrics, grads = grads_of(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=F32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=p.device), params)
            for i in range(n_microbatch):
                mb = {k: v.reshape(n_microbatch, v.shape[0] // n_microbatch,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                mloss, metrics, g = grads_of(loss_fn, params, mb)
                loss = loss + mloss
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                del g
            loss = loss / n_microbatch
            grads = tree_map(lambda g: g / n_microbatch, grads)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def to_device(batch, device):
    """A numpy batch as tensors on ``device`` (token ids as int32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    n_microbatch: int = 1


class Trainer:
    def __init__(self, bundle: ModelBundle, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, mesh=None):
        if _sharded(mesh) and bundle.mesh != mesh:
            raise ValueError("a Trainer on a mesh needs a bundle built on "
                             "that mesh (build_model(cfg, rules, mesh))")
        self.bundle = bundle
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.mesh = mesh if _sharded(mesh) else None
        self.ckpt = (Checkpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir and tcfg.ckpt_every else None)

    def _device(self, device: runtime.DeviceLike) -> torch.device:
        device = runtime.resolve_device(device)
        if self.mesh is not None and device != self.mesh.device:
            raise ValueError(f"the mesh's lead device is {self.mesh.device}"
                             f", not {device}")
        return device

    def place(self, params, opt_state):
        """Whole (one-device) parameters and optimizer state placed on the
        trainer's mesh by their specs (as they are without one)."""
        if self.mesh is None:
            return params, opt_state
        decls, rules = self.bundle.decls, self.bundle.rules
        return (shard_params(params, decls, self.mesh, rules),
                shard_opt_state(opt_state, decls, self.mesh, rules))

    def init(self, seed: Union[int, torch.Generator] = 0,
             device: runtime.DeviceLike = "cuda"):
        """(params, opt_state) on ``device`` (the card by default; it
        raises where there is none), the parameters drawn from ``seed``
        (an int, or a ``torch.Generator`` on ``device``); on a mesh drawn
        whole on its lead device (``device``), then placed."""
        device = self._device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=device).manual_seed(int(seed))
        params = init_tree(self.bundle.decls, gen, device)
        return self.place(params, init_opt_state(params, self.opt_cfg))

    def run(self, params, opt_state, data_iter, start_step: int = 0):
        step_fn = make_train_step(self.bundle, self.opt_cfg,
                                  self.tcfg.n_microbatch, self.mesh)
        device = tree_leaves(params)[0].device
        history = []
        t0 = time.perf_counter()
        for step in range(start_step, self.tcfg.steps):
            batch = to_device(next(data_iter), device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (step + 1) % self.tcfg.log_every == 0 or step == start_step:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = step + 1
                metrics["wall_s"] = time.perf_counter() - t0
                history.append(metrics)
                print("  " + " ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in sorted(metrics.items())))
            if self.ckpt and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, params, opt_state,
                               extra={"data_step": step + 1})
        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state, history

    def resume(self, device: runtime.DeviceLike = "cuda"):
        """(params, opt_state, start_step) from the latest checkpoint, on
        ``device`` (the card by default); on a mesh restored whole on its
        lead device, then placed."""
        if self.ckpt is None:
            raise ValueError("resume needs TrainerConfig.ckpt_dir and "
                             "ckpt_every")
        device = self._device(device)
        params_like = tree_map(
            lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"),
            self.bundle.decls)
        opt_like = init_opt_state(params_like, self.opt_cfg)
        params, opt_state, step, extra = self.ckpt.restore(
            params_like, opt_like, device=device)
        params, opt_state = self.place(params, opt_state)
        return params, opt_state, extra.get("data_step", step)

"""Training loop (the reference's ``train/trainer.py`` on one device): a
train step (gradients of ``bundle.loss_fn`` by autograd, then AdamW) with
optional microbatch gradient accumulation, periodic checkpoints with
resume.

On the card attention's gradient is K5's backward kernel; the loss's
other gradients are PyTorch's.  The trainer runs on the card by default
and raises where there is none; pass ``device="cpu"`` for the plain
PyTorch route.  ``Trainer.run`` takes a ``SyntheticLM``-style iterator of
numpy batches and moves each to the parameters' device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.models.lm import ModelBundle
from repro_torch.models.param import (
    init_tree, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import (
    OptConfig, adamw_update, init_opt_state,
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


def make_train_step(bundle: ModelBundle, opt_cfg: OptConfig,
                    n_microbatch: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).  With
    ``n_microbatch`` > 1 the batch's leading axis is split into that many
    microbatches, their gradients summed in float32 and divided by
    ``n_microbatch`` (and the loss too); the metrics are the last
    microbatch's, as in the reference."""
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
                 tcfg: TrainerConfig):
        self.bundle = bundle
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.ckpt = (Checkpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir and tcfg.ckpt_every else None)

    def init(self, seed: Union[int, torch.Generator] = 0,
             device: runtime.DeviceLike = "cuda"):
        """(params, opt_state) on ``device`` (the card by default; it
        raises where there is none), the parameters drawn from ``seed``
        (an int, or a ``torch.Generator`` on ``device``)."""
        device = runtime.resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator(device=device).manual_seed(int(seed))
        params = init_tree(self.bundle.decls, gen, device)
        return params, init_opt_state(params, self.opt_cfg)

    def run(self, params, opt_state, data_iter, start_step: int = 0):
        step_fn = make_train_step(self.bundle, self.opt_cfg,
                                  self.tcfg.n_microbatch)
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
        ``device`` (the card by default)."""
        if self.ckpt is None:
            raise ValueError("resume needs TrainerConfig.ckpt_dir and "
                             "ckpt_every")
        device = runtime.resolve_device(device)
        params_like = tree_map(
            lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"),
            self.bundle.decls)
        opt_like = init_opt_state(params_like, self.opt_cfg)
        params, opt_state, step, extra = self.ckpt.restore(
            params_like, opt_like, device=device)
        return params, opt_state, extra.get("data_step", step)

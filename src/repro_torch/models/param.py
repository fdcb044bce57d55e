"""Parameter declaration trees.

A model is declared once as a tree (nested dicts) of :class:`PDecl`; from
it come random initialization (:func:`init_tree`), the counts, the cache
trees of the serving engine, and through the logical-axis rules
(sharding/axes.py) each leaf's spec on a mesh (:func:`spec_tree`,
:func:`sharding_tree`), its placement there (:func:`shard_params`) and
which shards hold each of its blocks (:func:`placed_blocks`: the
optimizer writes each block once, the trainer sums a block's gradient
over its replicas).

:func:`params_from_numpy` carries the JAX package's parameters across —
as numpy arrays, ``jax.tree.map(np.asarray, params)`` — into tensors of
the same tree, bit for bit; a ``bfloat16`` array (``ml_dtypes``) is
reinterpreted through ``int16``, so the port imports neither JAX nor
``ml_dtypes``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

# a leaf larger than this is drawn one leading slice at a time, so that
# its float32 draw never holds more than one slice
_SLICE_NUMEL = 1 << 26


@dataclass(frozen=True)
class PDecl:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)

    def initialize(self, generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = self.scale if self.scale is not None \
            else 1.0 / math.sqrt(fan_in)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        parts = out if len(self.shape) >= 3 \
            and out.numel() > _SLICE_NUMEL else out[None]
        for part in parts:
            draw = torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device)
            part.copy_(draw.mul_(scale))
        return out


# Trees are nested dicts; every value that is not a dict (a PDecl, a
# tensor, an array) is a leaf.  Keys are visited in sorted order, as JAX
# flattens a dict.
def tree_map_with_path(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path of keys, leaf)`` over the leaves, in the tree's shape."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    return fn(prefix, tree)


def tree_map(fn: Callable, tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves``, in ``tree``'s flattening order, in ``tree``'s shape."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_paths(tree, prefix: Tuple[str, ...] = ()):
    """[(path of keys, leaf)] in flattening order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def init_tree(decls, generator: torch.Generator, device) -> Any:
    """Materialize a declaration tree into parameter tensors on ``device``,
    leaf after leaf from one seeded generator (which must live on
    ``device``)."""
    device = torch.device(device)
    return tree_map(lambda d: d.initialize(generator, device), decls)


def spec_tree(decls, rules):
    """Each leaf's spec under ``rules`` (sharding/axes.py), without a
    mesh."""
    return tree_map(lambda d: rules.resolve(d.logical), decls)


def sharding_tree(decls, mesh, rules):
    """Each leaf's spec on ``mesh``: the rules resolver drops mesh axes a
    dim cannot evenly use (and frees them for later dims), as the JAX
    package's jit in_shardings need."""
    sizes = dict(mesh.shape)
    return tree_map(lambda d: rules.resolve(d.logical, shape=d.shape,
                                            mesh_sizes=sizes), decls)


def shard_params(params, decls, mesh, rules):
    """``params`` placed on ``mesh`` by their specs (``sharding_tree``):
    each leaf whose spec uses an axis of more than one shard becomes a
    ``ShardedLeaf`` over all of its spec's axes, whose parts are views of
    the leaf on a simulated mesh and each card's own copy of its block on
    an NCCL mesh (the lead card's block copied too: no part of the placed
    tree keeps the whole leaf alive once the caller drops ``params``).  A
    leaf whose spec uses only axes of one shard stays as it is on a
    simulated mesh, and is copied once to every card of an NCCL mesh.
    The stages that use a leaf (models/layers.py, models/lm.py,
    models/moe.py) gather what its spec splits and they do not
    (``respec``)."""
    from repro_torch.sharding.collectives import (
        ShardedLeaf, on_device, split_spec,
    )
    specs = dict(tree_paths(sharding_tree(decls, mesh, rules)))
    sizes = dict(mesh.shape)

    def place(path, t):
        spec = specs[path]
        axes = [a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        if all(sizes.get(a, 1) == 1 for a in axes):
            if mesh.collective != "nccl":
                return t
            return ShardedLeaf([on_device(t, dev) for dev in mesh.devices],
                               (None,) * t.dim(), mesh)
        parts = split_spec(t, spec, mesh)
        if mesh.collective == "nccl":
            parts = [p.clone() if p.device == t.device else p
                     for p in parts]
        return ShardedLeaf(parts, spec, mesh)
    return tree_map_with_path(place, params)


@dataclass(frozen=True)
class Block:
    """One distinct block of a placed leaf: the shards whose parts hold
    it (in shard order) and the mesh axes of more than one shard that its
    spec does not name, over which it is replicated."""
    shards: Tuple[int, ...]
    replicas: Tuple[str, ...]

    @property
    def owner(self) -> int:
        """The shard that speaks for the block (place 0 of its replica
        axes): the one a sum over blocks reads."""
        return self.shards[0]


def placed_blocks(leaf, mesh) -> Tuple[Block, ...]:
    """The distinct blocks of ``leaf`` on ``mesh`` (a ``ShardedLeaf``, or
    a tensor that every shard shares), in the order of their owners.  On
    a simulated mesh the parts of one block are views of one storage (a
    tensor leaf is that one storage itself); on an NCCL mesh each card
    holds its own copy."""
    from repro_torch.sharding.collectives import ShardedLeaf, _axes, _block
    spec = leaf.spec if isinstance(leaf, ShardedLeaf) \
        else (None,) * len(leaf.shape)
    named = {a for e in spec for a in _axes(e)}
    replicas = tuple(a for a in mesh.axis_names
                     if mesh.shape[a] > 1 and a not in named)
    groups = {}
    for shard in range(len(mesh.devices)):
        key = tuple(_block(mesh, shard, e)[0] for e in spec)
        groups.setdefault(key, []).append(shard)
    return tuple(Block(tuple(g), replicas) for g in groups.values())


def param_count(decls) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(decls))


def _from_numpy(a) -> torch.Tensor:
    arr = np.array(a, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree, device) -> Any:
    """The JAX package's parameters (or any tree of numpy arrays) as
    tensors of the same tree on ``device``, bit for bit."""
    device = torch.device(device)
    return tree_map(lambda a: _from_numpy(a).to(device), tree)


def cast_floating(tree, dtype: torch.dtype) -> Any:
    """Every floating tensor of a tree cast to ``dtype`` (integers kept)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)

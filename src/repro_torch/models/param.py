"""Parameter declaration trees.

A model is declared once as a tree (nested dicts) of :class:`PDecl`; from
it come random initialization (:func:`init_tree`), the counts, and the
cache trees of the serving engine.  The logical axis names of every
dimension are kept as metadata: on one card nothing is sharded, so nothing
reads them yet.

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

"""Collectives over a ``DeviceMesh``'s shards, and the task-axis split
that runs a program once per shard.

The JAX package writes its sharded programs as ``shard_map`` bodies that
call ``jax.lax.psum`` and ``jax.lax.all_gather``; XLA runs the bodies on
the mesh's devices.  PyTorch runs eagerly, so here a sharded program is
written as its stages between collectives, each stage run on every shard
in shard order (no threads), and a collective takes one tensor per shard
and returns one per shard:

``mesh_sum``     the elementwise sum of the parts;
``mesh_gather``  the parts concatenated along ``dim`` in shard order.

On an NCCL mesh (launch/mesh.py: distinct cards) they are
``torch.cuda.nccl.all_reduce`` and ``all_gather``, the single-process
collectives: one controller drives every card, as the JAX package's
session does, so the session, its dispatch queues and its program cache
stay one.  NCCL runs on each card's current stream, the stream its
shard's part was written on, so a part is complete before the collective
reads it without any synchronisation.  Nothing here catches an NCCL
error.  On a simulated mesh (one device repeated) ``mesh_sum`` adds the
parts in shard order and hands the one sum to every shard, and
``mesh_gather`` is ``torch.cat`` in shard order.  Each call on a mesh of
more than one shard adds one to ``runtime.launch_counts["mesh_sum"]`` or
``["mesh_gather"]``; on one shard there is nothing to combine, the part
comes back as it is and nothing is counted.

``shard_map`` is the counterpart of the JAX package's ``shard_map`` over
the "data" axis: its operands split along the dims that
``sharding/policy.py::megabatch_specs`` names (the rest are replicated),
each shard's body runs on its device, and the outputs are gathered.  A
replicated operand reaches another card through ``on_device``: a tensor
that a page pool holds once on each card of its mesh
(``hold_replicas``) is read there, any other is copied.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import runtime

# id of a tensor -> its copy on each other device of an NCCL mesh, for as
# long as the tensor lives (compile/pages.py holds its pages this way)
_REPLICAS: Dict[int, Dict[torch.device, torch.Tensor]] = {}


def _check(parts: Sequence[torch.Tensor], mesh) -> int:
    m = len(mesh.shard_devices)
    if len(parts) != m:
        raise ValueError(f"a collective over {m} shards got {len(parts)} "
                         "parts")
    return m


def mesh_sum(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The sum of one part per shard, one result per shard.  On an NCCL
    mesh the parts are summed in place (``all_reduce``)."""
    m = _check(parts, mesh)
    if m == 1:
        return list(parts)
    runtime.launch_counts["mesh_sum"] += 1
    if mesh.collective == "nccl":
        parts = [p.contiguous() for p in parts]
        torch.cuda.nccl.all_reduce(parts)
        return parts
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return [total] * m


def mesh_gather(parts: Sequence[torch.Tensor], dim: int,
                mesh) -> List[torch.Tensor]:
    """One part per shard concatenated along ``dim`` in shard order, one
    result per shard."""
    m = _check(parts, mesh)
    if m == 1:
        return list(parts)
    runtime.launch_counts["mesh_gather"] += 1
    if mesh.collective == "nccl":
        # all_gather concatenates along the leading dim
        src = [p.movedim(dim, 0).contiguous() for p in parts]
        outs = [torch.empty((m * s.shape[0],) + tuple(s.shape[1:]),
                            dtype=s.dtype, device=s.device) for s in src]
        torch.cuda.nccl.all_gather(src, outs)
        return [o.movedim(0, dim) for o in outs]
    whole = torch.cat(list(parts), dim=dim)
    return [whole] * m


def hold_replicas(t: torch.Tensor, devices: Sequence[torch.device]) -> None:
    """Keep a copy of ``t`` on each of ``devices`` other than its own for
    as long as ``t`` lives (a page of a pool on an NCCL mesh)."""
    copies = {d: t.to(d, non_blocking=True) for d in devices
              if d != t.device}
    if copies:
        _REPLICAS[id(t)] = copies
        weakref.finalize(t, _REPLICAS.pop, id(t), None)


def on_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself, its held replica, or a copy."""
    if t.device == device:
        return t
    held = _REPLICAS.get(id(t))
    if held is not None and device in held:
        return held[device]
    return t.to(device, non_blocking=True)


def on_shard(device: torch.device):
    """The context a shard's stage runs in: its card current (a null
    context off CUDA)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_map(fn: Callable, mesh, in_dims: Sequence[Optional[int]],
              out_dim: int) -> Callable:
    """``fn`` run once per shard of ``mesh``'s "data" axis: operand i is
    split into equal parts along ``in_dims[i]`` (None: the whole operand
    on every shard), each shard calls ``fn`` on its parts on its device,
    and the outputs are gathered along ``out_dim`` (the lead shard's copy
    is returned, on the mesh's lead device).  The split dims must divide
    by the shard count."""
    devices = mesh.shard_devices
    m = len(devices)

    def run(*args):
        outs = []
        for s, dev in enumerate(devices):
            shard_args = []
            for a, dim in zip(args, in_dims):
                if dim is not None:
                    if a.shape[dim] % m:
                        raise ValueError(
                            f"dim {dim} of an operand of shape "
                            f"{tuple(a.shape)} does not split over {m} "
                            "shards")
                    a = a.tensor_split(m, dim)[s].contiguous()
                shard_args.append(on_device(a, dev))
            with on_shard(dev):
                outs.append(fn(*shard_args))
        return mesh_gather(outs, out_dim, mesh)[0]

    return run

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

Scoped to one axis (``axis=``: the shards of each group of
``DeviceMesh.axis_groups(axis)`` combine among themselves, as
``jax.lax.psum(x, axis)`` does inside a ``shard_map`` body):

``mesh_sum``         with ``axis``, the sum within each group;
``mesh_gather``      with ``axis``, the concatenation within each group,
                     in that axis' order;
``mesh_mean``        the sum over ``axis`` divided by its size (``pmean``);
``mesh_all_to_all``  each part's leading dim holds one chunk per shard of
                     its group, and chunk j of shard i goes to shard j,
                     where it lands at place i: the JAX package's
                     ``all_to_all(x, axis, 0, 0, tiled=False)``.  On a
                     simulated mesh it is an ordered re-stacking of the
                     chunks; on an NCCL mesh (``torch.cuda.nccl`` has no
                     all-to-all) each chunk is a peer copy onto the
                     destination card's current stream, after that stream
                     waits for the source card's (written, unverified: no
                     machine with two cards has run it).
Each call over an axis of more than one shard adds one to its count
(``mesh_mean`` counts as ``mesh_sum``, ``mesh_all_to_all`` as itself).
``respec`` lays a placed parameter out as a stage asks: it gathers the
dims the leaf splits over an axis the stage does not (the FSDP gather over
"data", counted as ``mesh_gather``) and narrows the dims the stage splits
and the leaf does not (a view on a simulated mesh).

Under autograd (grad mode on, a part that needs a gradient) ``mesh_sum``,
``mesh_gather`` (``respec``'s gathers with it), ``split_spec`` and
``join_spec`` run as ``torch.autograd.Function``s whose backward is the
adjoint of the forward, on both routes (the simulated mesh's CPU tests
hold the rules the NCCL route uses): a sum's is the sum of the output
gradients over the same groups ("mesh_sum_bwd"), a gather's the group's
sum of the gradients with each shard keeping its own slice, a
reduce-scatter ("mesh_gather_bwd"); a split's adds each part's gradient
into its block, a join's hands each shard it read its block of the
gradient and every other shard zeros.  The port's sharded programs hold
one copy of the residual a shard and read their outputs from the shards
at place 0 (``join_spec``), so these adjoints, not Megatron's identity
and slice (which assume an identity-forward, sum-backward operator at
every stage's input), give each shard its share of every gradient.  The
NCCL backwards are ``torch.cuda.nccl`` ``all_reduce`` and
``reduce_scatter`` (written, unverified: no machine with two cards has
run them).  ``mesh_all_to_all`` has no backward here.

``shard_map`` is the counterpart of the JAX package's ``shard_map`` over
the "data" axis: its operands split along the dims that
``sharding/policy.py::megabatch_specs`` names (the rest are replicated),
each shard's body runs on its device, and the outputs are gathered.  A
replicated operand reaches another card through ``on_device``: a tensor
that a page pool holds once on each card of its mesh
(``hold_replicas``) is read there, any other is copied.

``shard_map_specs`` is its spec form over any axes: each operand names
the mesh axes of each of its dims (``(dp_axes, "model", None)`` for the
JAX package's ``P(dp_axes, "model", None)``), ``split_spec`` cuts it into
one part per shard (views on a simulated mesh), the staged program gets
every operand's parts and returns every output's parts, and ``join_spec``
puts each output together on the lead device.  A dim that no output axis
names is taken from the shards at place 0 of the other axes: for the
replicated ``()`` that is shard 0's part, the value the JAX package's
``shard_map`` returns with its replication check off.  A ``ShardedLeaf``
(a parameter that ``models/param.py::shard_params`` placed on the mesh)
hands over its parts when its spec is the one asked for.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def _group_size(parts: Sequence[torch.Tensor], mesh, axis: str) -> int:
    if len(parts) != len(mesh.devices):
        raise ValueError(f"a collective over a mesh of {len(mesh.devices)} "
                         f"shards got {len(parts)} parts")
    return mesh.shape[axis]


def _tracked(parts: Sequence[torch.Tensor]) -> bool:
    """Whether autograd records a collective of ``parts``: grad mode is
    on and a part needs a gradient."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in parts)


def mesh_sum(parts: Sequence[torch.Tensor], mesh,
             axis: Optional[str] = None) -> List[torch.Tensor]:
    """The sum of one part per shard, one result per shard: over every
    shard of a mesh split over "data" alone, or with ``axis`` within each
    group of that axis.  On an NCCL mesh the parts are summed in place
    (``all_reduce``).  Under autograd (``_MeshSum``) the backward is the
    adjoint: the output gradients summed over the same groups."""
    if axis is None:
        _check(parts, mesh)
        axis = "data"
    if _group_size(parts, mesh, axis) == 1:
        return list(parts)
    if _tracked(parts):
        return list(_MeshSum.apply(mesh, axis, *parts))
    return _sum(parts, mesh, axis, "mesh_sum")


def _sum(parts, mesh, axis: str, count: str,
         own: bool = False) -> List[torch.Tensor]:
    """``mesh_sum``'s collective, counted as ``count``; ``own``: the NCCL
    route sums copies, never a part in place (autograd's tensors)."""
    runtime.launch_counts[count] += 1
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for group in mesh.axis_groups(axis):
        if mesh.collective == "nccl":
            summed = [parts[i].clone(memory_format=torch.contiguous_format)
                      if own else parts[i].contiguous() for i in group]
            torch.cuda.nccl.all_reduce(summed)
        else:
            total = parts[group[0]]
            for i in group[1:]:
                total = total + parts[i]
            summed = [total] * len(group)
        for i, t in zip(group, summed):
            out[i] = t
    return out


def mesh_gather(parts: Sequence[torch.Tensor], dim: int, mesh,
                axis: Optional[str] = None) -> List[torch.Tensor]:
    """One part per shard concatenated along ``dim`` in shard order, one
    result per shard: over every shard of a mesh split over "data" alone,
    or with ``axis`` within each group of that axis, in that axis' order
    (``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``).  Under
    autograd (``_MeshGather``) the backward is the adjoint, a
    reduce-scatter: each shard's part gets its slice of the group's sum of
    the output gradients."""
    if axis is None:
        _check(parts, mesh)
        axis = "data"
    if _group_size(parts, mesh, axis) == 1:
        return list(parts)
    if _tracked(parts):
        return list(_MeshGather.apply(mesh, axis, dim, *parts))
    return _gather(parts, dim, mesh, axis)


def _gather(parts, dim: int, mesh, axis: str) -> List[torch.Tensor]:
    runtime.launch_counts["mesh_gather"] += 1
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for group in mesh.axis_groups(axis):
        if mesh.collective == "nccl":
            # all_gather concatenates along the leading dim
            src = [parts[i].movedim(dim, 0).contiguous() for i in group]
            outs = [torch.empty((len(src) * t.shape[0],)
                                + tuple(t.shape[1:]), dtype=t.dtype,
                                device=t.device) for t in src]
            torch.cuda.nccl.all_gather(src, outs)
            joined = [o.movedim(0, dim) for o in outs]
        else:
            joined = [torch.cat([parts[i] for i in group], dim=dim)] \
                * len(group)
        for i, t in zip(group, joined):
            out[i] = t
    return out


def _reduce_scatter(grads, dim: int, mesh, axis: str) -> List[torch.Tensor]:
    """The adjoint of ``_gather``: within each group, the sum of the
    gradients of the gathered outputs, each shard keeping its own slice
    along ``dim`` (``reduce_scatter`` on an NCCL mesh), counted as
    "mesh_gather_bwd"."""
    runtime.launch_counts["mesh_gather_bwd"] += 1
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for group in mesh.axis_groups(axis):
        n = len(group)
        if mesh.collective == "nccl":
            src = [grads[i].movedim(dim, 0).contiguous() for i in group]
            outs = [torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                                dtype=t.dtype, device=t.device) for t in src]
            torch.cuda.nccl.reduce_scatter(src, outs)
            for i, o in zip(group, outs):
                out[i] = o.movedim(0, dim)
            continue
        total = grads[group[0]]
        for i in group[1:]:
            total = total + grads[i]
        size = total.shape[dim] // n
        for j, i in enumerate(group):
            out[i] = total.narrow(dim, j * size, size)
    return out


class _MeshSum(torch.autograd.Function):
    """``mesh_sum`` under autograd.  On a simulated mesh one sum is every
    shard's output (the same tensor), so autograd may hand a group's
    gradients to one of its outputs: the backward sums each group first,
    which is the adjoint whichever output holds them."""

    @staticmethod
    def forward(ctx, mesh, axis, *parts):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(_sum(parts, mesh, axis, "mesh_sum", own=True))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_sum(grads, ctx.mesh, ctx.axis,
                                         "mesh_sum_bwd", own=True))


class _MeshGather(torch.autograd.Function):
    """``mesh_gather`` under autograd; its backward is ``_reduce_scatter``
    (a group's gradients summed first, as in ``_MeshSum``)."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, *parts):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return tuple(_gather(parts, dim, mesh, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(_reduce_scatter(
            grads, ctx.dim, ctx.mesh, ctx.axis))


def mesh_mean(parts: Sequence[torch.Tensor], mesh,
              axis: str) -> List[torch.Tensor]:
    """The mean over ``axis`` of one part per shard: the sum divided by
    the axis size (``jax.lax.pmean``)."""
    size = _group_size(parts, mesh, axis)
    if size == 1:
        return list(parts)
    return [t / size for t in mesh_sum(parts, mesh, axis)]


def mesh_all_to_all(parts: Sequence[torch.Tensor], mesh,
                    axis: str) -> List[torch.Tensor]:
    """Within each group of ``axis``: chunk j (``part[j]``) of the group's
    shard i goes to its shard j, at place i of the result."""
    n = _group_size(parts, mesh, axis)
    if any(p.shape[0] != n for p in parts):
        raise ValueError(f"an all-to-all over {n} shards needs a leading "
                         f"dim of {n}; got {[tuple(p.shape) for p in parts]}")
    if n == 1:
        return list(parts)
    runtime.launch_counts["mesh_all_to_all"] += 1
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for group in mesh.axis_groups(axis):
        for r, dst in enumerate(group):
            if mesh.collective != "nccl":
                out[dst] = torch.stack([parts[src][r] for src in group])
                continue
            dev = mesh.devices[dst]
            stream = torch.cuda.current_stream(dev)
            head = parts[group[0]]
            buf = torch.empty((n,) + tuple(head.shape[1:]), dtype=head.dtype,
                              device=dev)
            with torch.cuda.device(dev):
                for j, src in enumerate(group):
                    if mesh.devices[src] != dev:
                        stream.wait_stream(
                            torch.cuda.current_stream(mesh.devices[src]))
                        parts[src].record_stream(stream)
                    buf[j].copy_(parts[src][r], non_blocking=True)
            out[dst] = buf
    return out


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


# ---------------------------------------------------------------------------
# the spec form: operands placed by the mesh axes of each dim
# ---------------------------------------------------------------------------
Spec = Tuple[object, ...]


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis name, or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh, shard: int, entry) -> Tuple[int, int]:
    """(index, count) of shard ``shard``'s block of a dim split over
    ``entry``'s axes, row-major over them."""
    index, count = 0, 1
    for a in _axes(entry):
        size = mesh.shape[a]
        index, count = index * size + mesh.axis_index(shard, a), count * size
    return index, count


def _same_spec(a: Spec, b: Spec) -> bool:
    return len(a) == len(b) and all(_axes(x) == _axes(y)
                                    for x, y in zip(a, b))


class ShardedLeaf:
    """A tensor held as one part per shard of ``mesh``, split as ``spec``
    says (``models/param.py::shard_params``).  Indexing its leading,
    unsplit dims (``leaf[i]``: one layer of a stacked leaf) indexes every
    part."""

    def __init__(self, parts: Sequence[torch.Tensor], spec: Spec, mesh):
        self.parts, self.spec, self.mesh = list(parts), tuple(spec), mesh

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        if not all(isinstance(i, int) for i in idx) or any(
                _axes(e) for e in self.spec[:len(idx)]):
            raise IndexError(f"a sharded leaf of spec {self.spec} takes "
                             "integer indexes of its unsplit leading dims")
        return ShardedLeaf([p[idx] for p in self.parts],
                           self.spec[len(idx):], self.mesh)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole leaf's shape."""
        return tuple(n * _block(self.mesh, 0, e)[1]
                     for n, e in zip(self.parts[0].shape, self.spec))

    @property
    def device(self) -> torch.device:
        """The mesh's lead device."""
        return self.mesh.device

    def join(self) -> torch.Tensor:
        """The whole leaf on the mesh's lead device (``join_spec``)."""
        return join_spec(self.parts, self.spec, self.mesh)


def split_spec(x, spec: Spec, mesh) -> List[torch.Tensor]:
    """One part of ``x`` per shard of ``mesh`` (in ``devices`` order),
    each dim cut into the blocks its ``spec`` entry names: views of ``x``
    on a simulated mesh, copies on each shard's card on an NCCL mesh.
    Under autograd (``_SplitSpec``) the backward is the adjoint: each
    part's gradient added into its block of ``x``'s, on ``x``'s device
    (a block several shards hold gets the sum of theirs)."""
    if isinstance(x, ShardedLeaf):
        if not _same_spec(x.spec, spec) or x.mesh != mesh:
            raise ValueError(f"a leaf placed as {x.spec} is asked for as "
                             f"{tuple(spec)}; nothing here re-shards it")
        return list(x.parts)
    if len(spec) != x.dim():
        raise ValueError(f"spec {tuple(spec)} for a tensor of shape "
                         f"{tuple(x.shape)}")
    if _tracked([x]):
        return list(_SplitSpec.apply(mesh, tuple(spec), x))
    return [on_device(_cut(x, spec, mesh, shard), dev)
            for shard, dev in enumerate(mesh.devices)]


def _cut(x: torch.Tensor, spec: Spec, mesh, shard: int) -> torch.Tensor:
    """Shard ``shard``'s block of ``x`` by ``spec`` (a view)."""
    part = x
    for dim, entry in enumerate(spec):
        index, count = _block(mesh, shard, entry)
        if count == 1:
            continue
        if x.shape[dim] % count:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does "
                             f"not split into {count} blocks")
        size = x.shape[dim] // count
        part = part.narrow(dim, index * size, size)
    return part


class _SplitSpec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, x):
        ctx.mesh, ctx.spec = mesh, spec
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        return tuple(on_device(_cut(x, spec, mesh, shard), dev)
                     for shard, dev in enumerate(mesh.devices))

    @staticmethod
    def backward(ctx, *grads):
        out = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        for shard, g in enumerate(grads):
            _cut(out, ctx.spec, ctx.mesh, shard).add_(
                on_device(g, ctx.device))
        return None, None, out


def respec(x, spec: Spec, mesh) -> List[torch.Tensor]:
    """The parts of ``x`` (a ``ShardedLeaf`` of ``mesh``, or a whole
    tensor) laid out as ``spec`` asks, one per shard: each dim that ``x``
    splits over axes that ``spec`` does not name there is gathered over
    them (``mesh_gather(axis=)``, innermost axis first), then each dim
    that ``spec`` splits and the gathered parts do not is narrowed to the
    shard's block (a view).  A whole tensor is every shard's part (a copy
    on each other card of an NCCL mesh)."""
    if isinstance(x, ShardedLeaf):
        if x.mesh != mesh:
            raise ValueError("a leaf placed on another mesh")
        have, parts = x.spec, list(x.parts)
    else:
        have = (None,) * x.dim()
        parts = [on_device(x, dev) for dev in mesh.devices]
    if len(spec) != len(have):
        raise ValueError(f"spec {tuple(spec)} for a leaf of spec {have}")
    for dim, (got, want) in enumerate(zip(have, spec)):
        if _axes(got) == _axes(want):
            continue
        for a in reversed(_axes(got)):
            parts = mesh_gather(parts, dim, mesh, axis=a)
        if not _axes(want):
            continue
        cut = []
        for shard, part in enumerate(parts):
            index, count = _block(mesh, shard, want)
            if part.shape[dim] % count:
                raise ValueError(f"dim {dim} of shape {tuple(part.shape)} "
                                 f"does not split into {count} blocks")
            size = part.shape[dim] // count
            cut.append(part.narrow(dim, index * size, size))
        parts = cut
    return parts


def join_spec(parts: Sequence[torch.Tensor], spec: Spec,
              mesh) -> torch.Tensor:
    """The tensor whose ``split_spec`` is ``parts``, on the mesh's lead
    device; dims split over no axis come from the shards at place 0 of
    every axis that ``spec`` does not name.  Under autograd
    (``_JoinSpec``) the backward is the adjoint: each of those shards gets
    its block of the gradient, every other shard zeros."""
    if _tracked(parts):
        return _JoinSpec.apply(mesh, tuple(spec), *parts)
    return _join(parts, spec, mesh)


def _chosen(spec: Spec, mesh) -> List[int]:
    """The shards ``join_spec`` reads: place 0 of every axis that
    ``spec`` does not name."""
    named = {a for e in spec for a in _axes(e)}
    free = [k for k, a in enumerate(mesh.axis_names) if a not in named]
    return [s for s in range(len(mesh.devices))
            if all(mesh.coords(s)[k] == 0 for k in free)]


def _join(parts, spec: Spec, mesh) -> torch.Tensor:
    chosen = _chosen(spec, mesh)
    if len(chosen) == 1:
        return on_device(parts[chosen[0]], mesh.device)
    head = parts[chosen[0]]
    counts = [_block(mesh, 0, e)[1] for e in spec]
    out = torch.empty([n * c for n, c in zip(head.shape, counts)],
                      dtype=head.dtype, device=mesh.device)
    for s in chosen:
        _cut(out, spec, mesh, s).copy_(parts[s])
    return out


class _JoinSpec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, spec, *parts):
        ctx.mesh, ctx.spec = mesh, spec
        ctx.parts = [(p.shape, p.dtype, p.device) for p in parts]
        out = _join(parts, spec, mesh)
        return out.clone() if any(out is p for p in parts) else out

    @staticmethod
    def backward(ctx, grad):
        chosen = set(_chosen(ctx.spec, ctx.mesh))
        grads = [on_device(_cut(grad, ctx.spec, ctx.mesh, s), dev)
                 if s in chosen else torch.zeros(shape, dtype=dtype,
                                                 device=dev)
                 for s, (shape, dtype, dev) in enumerate(ctx.parts)]
        return (None, None) + tuple(grads)


def shard_map_specs(fn: Callable, mesh, in_specs: Sequence[Spec],
                    out_specs: Sequence[Spec]) -> Callable:
    """A staged sharded program over any axes of ``mesh``: operand i is
    cut by ``in_specs[i]`` (``split_spec``), ``fn`` gets each operand's
    parts in shard order, runs its stages on every shard between the
    collectives and returns each output's parts, and output j is put
    together by ``out_specs[j]`` (``join_spec``)."""
    def run(*args):
        outs = fn(*[split_spec(a, s, mesh) for a, s in zip(args, in_specs)])
        return tuple(join_spec(o, s, mesh) for o, s in zip(outs, out_specs))
    return run

"""Device meshes for the sharded programs and the in-mesh executors.

A ``DeviceMesh`` is a hashable grid of devices with the JAX package's
axis names ``("data", "model")``; it keys the in-mesh program caches and
tells the planner how many shards the "data" axis has.  Its devices are
one of two kinds, and the mesh records which (``collective``):

``"nccl"``   every device a distinct CUDA device: a shard runs on its own
             card and the collectives (sharding/collectives.py) are
             NCCL's, called from this one process over all the cards, as
             the JAX package's session drives all of its devices from
             one controller;
``"local"``  one device repeated: the counterpart of the JAX package's
             forced host device count
             (``--xla_force_host_platform_device_count``).  Each shard
             runs its body on that device, and a collective is a sum or
             a concatenation in shard order there.  The one-device mesh
             is this kind with one shard.

A mesh that mixes the two, or repeats some of several devices, raises
``ValueError``: the caller picks the mesh, and nothing turns one kind
into the other.

The estimator splits over "data" alone (``shard_devices``).  The decoder
family (models/lm.py: tensor parallel over "model", FSDP and the batch
over "data") and the MoE layer's expert parallelism (models/moe.py) use
both axes: a shard's coordinates, its ``axis_index`` and the groups of
shards along one axis (``axis_groups``) place its tokens, heads, widths
and experts and scope its collectives.

The topology backend's host streams are built from these meshes:
``make_sim_host_meshes`` gives N simulated hosts their meshes over the
visible devices, reusing them round-robin when there are fewer than
hosts, and ``split_pod_meshes`` carves a mesh with a leading "pod" axis
into one mesh per pod.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.runtime import DeviceLike, resolve_device

AXIS_NAMES = ("data", "model")


@dataclass(frozen=True)
class DeviceMesh:
    """``devices`` in row-major order over ``dims`` (one size per name in
    ``axis_names``)."""
    devices: Tuple[torch.device, ...]
    dims: Tuple[int, ...] = (1, 1)
    axis_names: Tuple[str, ...] = AXIS_NAMES

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} do not match axis "
                             f"names {self.axis_names}")
        size = 1
        for d in self.dims:
            size *= int(d)
        if size != len(self.devices):
            raise ValueError(f"mesh dims {self.dims} hold {size} devices, "
                             f"got {len(self.devices)}")
        distinct = set(self.devices)
        if len(distinct) > 1 and (
                len(distinct) != len(self.devices)
                or any(d.type != "cuda" for d in distinct)):
            raise ValueError(
                f"a mesh's devices are either distinct CUDA devices (NCCL) "
                f"or one device repeated (a simulated mesh); got "
                f"{[str(d) for d in self.devices]}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def collective(self) -> str:
        """``"nccl"`` over distinct cards, ``"local"`` on one device."""
        return "local" if len(set(self.devices)) == 1 else "nccl"

    @property
    def device(self) -> torch.device:
        """The lead device: where a program's operands and results live
        and the page pool keeps its pages."""
        return self.devices[0]

    def coords(self, shard: int) -> Tuple[int, ...]:
        """The coordinates of shard ``shard`` (its place in ``devices``),
        one per axis."""
        return tuple(int(c) for c in np.unravel_index(shard, self.dims))

    def axis_index(self, shard: int, axis: str) -> int:
        """Shard ``shard``'s index along ``axis`` (``jax.lax.axis_index``
        inside a ``shard_map`` body)."""
        return self.coords(shard)[self.axis_names.index(axis)]

    def axis_groups(self, axis: str) -> List[Tuple[int, ...]]:
        """The shards that differ only along ``axis``: one group for each
        place on the other axes, each group in ``axis`` order (the
        participants of a collective over ``axis``)."""
        k = self.axis_names.index(axis)
        grid = np.arange(len(self.devices)).reshape(self.dims)
        lines = np.moveaxis(grid, k, -1).reshape(-1, self.dims[k])
        return [tuple(int(i) for i in line) for line in lines]

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The device of each shard of the "data" axis, in shard order.
        The estimator's programs split over "data" alone, so every other
        axis must have size 1."""
        shape = self.shape
        if any(size != 1 for name, size in shape.items() if name != "data"):
            raise ValueError(f"the estimator shards over 'data' only; mesh "
                             f"{shape} has another axis of more than 1")
        return self.devices


def _visible(device: DeviceLike) -> List[torch.device]:
    """Every visible CUDA device for ``"cuda"`` without an index, else the
    one device asked for (the CPU only when asked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)                    # raises where there is none
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(dev)]


def make_host_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """The (n, 1) ("data", "model") mesh over every visible CUDA device
    (``"cuda"``), as the JAX package's spans ``jax.device_count()``; the
    1 x 1 mesh on a device named with its index, or on the CPU."""
    devs = _visible(device)
    return DeviceMesh(devices=tuple(devs), dims=(len(devs), 1))


def make_sim_mesh(n_shards: Union[int, Tuple[int, int]],
                  device: DeviceLike = "cuda") -> DeviceMesh:
    """A simulated mesh: ``device`` repeated, the counterpart of the JAX
    package's forced host device count.  ``n_shards`` is the size of the
    "data" axis (an (n, 1) mesh) or the ("data", "model") dims."""
    dev = resolve_device(device)
    dims = (int(n_shards), 1) if isinstance(n_shards, int) \
        else tuple(int(d) for d in n_shards)
    return DeviceMesh(devices=(dev,) * int(np.prod(dims)), dims=dims)


def split_pod_meshes(mesh: DeviceMesh) -> List[DeviceMesh]:
    """One mesh per index of the "pod" axis — the per-host meshes the
    topology layer streams over; a mesh without one is one host."""
    if "pod" not in mesh.axis_names:
        return [mesh]
    pod_axis = mesh.axis_names.index("pod")
    axes = tuple(a for a in mesh.axis_names if a != "pod")
    dims = tuple(d for a, d in zip(mesh.axis_names, mesh.dims) if a != "pod")
    grid = np.empty(len(mesh.devices), dtype=object)
    grid[:] = mesh.devices
    grid = grid.reshape(mesh.dims)
    return [DeviceMesh(tuple(np.take(grid, i, axis=pod_axis).flat), dims,
                       axes)
            for i in range(mesh.dims[pod_axis])]


def make_sim_host_meshes(n_hosts: int, device: DeviceLike = "cuda",
                         shards_per_host: int = 1) -> List[DeviceMesh]:
    """N simulated host meshes of ``shards_per_host`` shards each over the
    visible devices (``_visible``): split contiguously, and a host the
    devices run out for reuses one device round-robin for all its shards,
    as the JAX package reuses its devices when it has fewer than hosts.
    Residency stays separate because each host owns its own page pool,
    and on the card each host's work runs on its own CUDA stream
    (serverless/topology.py)."""
    devs = _visible(device)
    per = int(shards_per_host)
    meshes = []
    for h in range(n_hosts):
        group = devs[h * per:(h + 1) * per]
        if len(group) < per:
            group = [devs[h % len(devs)]] * per
        meshes.append(DeviceMesh(tuple(group), (per, 1)))
    return meshes

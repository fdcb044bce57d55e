"""Device meshes for the in-mesh executors (sharding/gram.py).

A ``DeviceMesh`` is a hashable grid of devices with the JAX package's
axis names ``("data", "model")``; it keys the in-mesh program cache and
tells the planner how many shards the "data" axis has.  Only the 1 x 1
mesh on one device exists so far: the executors' collectives over NCCL
(``torch.distributed``) are later work, so a mesh of more than one device
raises ``NotImplementedError``.

The topology backend's host streams are built from these meshes:
``make_sim_host_meshes`` gives N simulated hosts one one-device mesh each
on the same device, and
``split_pod_meshes`` carves a mesh with a leading "pod" axis into one mesh
per pod (every mesh the port can build has none).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

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
        if size > 1:
            raise NotImplementedError(
                f"a mesh of {size} devices needs collectives over NCCL, "
                "which are not ported yet; only the one-device mesh runs")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def device(self) -> torch.device:
        """The device of a one-device mesh."""
        return self.devices[0]


def make_host_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """The 1 x 1 ("data", "model") mesh on ``device``."""
    return DeviceMesh(devices=(resolve_device(device),))


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


def make_sim_host_meshes(n_hosts: int,
                         device: DeviceLike = "cuda") -> List[DeviceMesh]:
    """N simulated host meshes, each the one-device mesh on ``device`` —
    pure simulation, as the JAX package reuses its devices round-robin
    when it has fewer than hosts: residency stays separate because each
    host owns its own page pool, and each host's work runs on its own
    CUDA stream (serverless/topology.py).  Spreading hosts over several
    cards waits for the multi-device meshes."""
    return [make_host_mesh(device) for _ in range(n_hosts)]

"""Device meshes for the in-mesh executors (sharding/gram.py).

A ``DeviceMesh`` is a hashable grid of devices with the JAX package's
axis names ``("data", "model")``; it keys the in-mesh program cache and
tells the planner how many shards the "data" axis has.  Only the 1 x 1
mesh on one device exists so far: the executors' collectives over NCCL
(``torch.distributed``) are later work, so a mesh of more than one device
raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

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

"""Process-wide runtime state of the PyTorch/CUDA port.

``resolve_device``   the device rule: entry points run on the card unless
                     the caller asks for the CPU.  Asking for CUDA on a
                     machine without a GPU raises — nothing falls back.
``launch_counts``    one plain integer per hand-written kernel, bumped by
                     the kernel's wrapper exactly where it launches (and
                     nowhere else), so a run can show that it really went
                     through the kernels; and one per mesh collective
                     (sharding/collectives.py), bumped where it combines
                     the shards of a mesh of more than one.
``refuse_grad``      the check of every CUDA wrapper whose kernel has no
                     backward (K1-K4: the reference never differentiates
                     them): an input that needs a gradient raises instead
                     of leaving the launch's output without one.
``bounded_put``      shared bounded-FIFO insert for the warm-path caches.
``mesh_axes``        the mesh axis names the logical-axis rules may map
                     onto (None: no filtering), as the JAX package's
                     ``runtime.mesh_axes`` (sharding/axes.py).  Nothing
                     sets it until the dry run's ``--mesh multi`` is
                     ported (ROADMAP Queue 1 item 1); until then it is
                     here only for parity with the reference's filter.

Float32 matrix products stay in full float32: the port never enables
TF32, and refuses to load into a process that did.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

if torch.backends.cuda.matmul.allow_tf32 is not False:
    raise AssertionError(
        "repro_torch needs full-float32 matmuls: "
        "torch.backends.cuda.matmul.allow_tf32 must stay False")

DeviceLike = Union[str, torch.device]

# kernel name -> launches since the last reset (see kernels/megabatch.py,
# kernels/crossfit_gram.py, kernels/flash_attention.py and
# kernels/ssd_scan.py); "flash_attention_bwd" and "ssd_scan_bwd" count
# calls of K5's and K6's backward wrappers (several CUDA launches each);
# "mesh_sum", "mesh_gather" and "mesh_all_to_all" count the collectives
# over a mesh's shards, "mesh_sum_bwd" and "mesh_gather_bwd" those of
# their backwards under autograd (a sum and a reduce-scatter)
launch_counts: Dict[str, int] = {"batched_gram": 0, "batched_gram_blocked": 0,
                                 "batched_predict": 0, "crossfit_gram": 0,
                                 "flash_attention": 0,
                                 "flash_attention_bwd": 0, "ssd_scan": 0,
                                 "ssd_scan_bwd": 0, "mesh_sum": 0,
                                 "mesh_gather": 0, "mesh_all_to_all": 0,
                                 "mesh_sum_bwd": 0, "mesh_gather_bwd": 0}

# mesh axis names available to the logical-axis rules (None = no filtering)
mesh_axes = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any of ``tensors``
    requires a gradient: the CUDA launch of ``kernel`` fills its outputs
    through a raw pointer, so autograd would see no graph through it."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires a gradient, and the kernel has "
            "no backward (the reference never differentiates it); call it "
            "under torch.no_grad() or on detached tensors")


def default_device() -> torch.device:
    """The card.  Raises where there is none."""
    return resolve_device("cuda")


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Canonical ``torch.device`` for an entry point's ``device=``
    argument; a CUDA device on a machine without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def bounded_put(cache: dict, key, value, max_entries: int) -> None:
    """Shared bounded-FIFO insert for the warm-path caches (key tables,
    index maps, block layouts): evict oldest entries past the cap.
    Lives here because the compile and serverless layers both use it and
    this module imports nothing of the package (no cycle risk)."""
    while len(cache) >= max_entries:
        cache.pop(next(iter(cache)))
    cache[key] = value

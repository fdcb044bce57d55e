"""Process-wide runtime state of the PyTorch/CUDA port.

``resolve_device``   the device rule: entry points run on the card unless
                     the caller asks for the CPU.  Asking for CUDA on a
                     machine without a GPU raises — nothing falls back.
``launch_counts``    one plain integer per hand-written kernel, bumped by
                     the kernel's wrapper exactly where it launches (and
                     nowhere else), so a run can show that it really went
                     through the kernels.
``bounded_put``      shared bounded-FIFO insert for the warm-path caches.

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
# kernels/ssd_scan.py)
launch_counts: Dict[str, int] = {"batched_gram": 0, "batched_gram_blocked": 0,
                                 "batched_predict": 0, "crossfit_gram": 0,
                                 "flash_attention": 0, "ssd_scan": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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

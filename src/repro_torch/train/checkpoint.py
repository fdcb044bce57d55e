"""msgpack checkpoints in the reference's payload format
(``train/checkpoint.py``), so that a checkpoint either package writes
restores in the other, bit for bit.

A payload is ``{"step", "params", "opt", "extra"}``; a tree is flattened
to ``{"a/b/c": {"dtype", "shape", "data"}}`` records (numpy dtype names;
bfloat16 stored as its uint16 bits).  Files are
``ckpt_{step:08d}.msgpack``.  Writes are atomic (a temporary file, then
``os.replace``), keep a rolling window of checkpoints (3 by default), and
move serialisation and IO to a writer thread after a synchronous
device-to-host copy.  One card writes the whole tree: a leaf placed on a
mesh (``ShardedLeaf``) is joined first, so a checkpoint written on a mesh
holds the same bytes as one written on one device.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

from repro_torch.models.param import tree_map_with_path, tree_paths
from repro_torch.sharding.collectives import ShardedLeaf


def _record(t) -> Dict[str, Any]:
    if isinstance(t, ShardedLeaf):
        t = t.join()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).numpy().view(np.uint16)
        name = "bfloat16"
    else:
        arr = t.numpy()
        name = arr.dtype.name
    return {"dtype": name, "shape": list(arr.shape), "data": arr.tobytes()}


def tree_to_payload(tree) -> Dict[str, Any]:
    return {"/".join(path): _record(leaf) for path, leaf in tree_paths(tree)}


def _tensor(rec: Dict[str, Any], device) -> torch.Tensor:
    shape = tuple(rec["shape"])
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], np.uint16).reshape(shape)
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(rec["data"], np.dtype(rec["dtype"]))
        t = torch.from_numpy(arr.reshape(shape).copy())
    return t.to(device)


def payload_to_tree(payload: Dict[str, Any], like, device=None):
    """The tree shaped like ``like``, each leaf from its record; on
    ``device``, or each ``like`` leaf's own (a ``like`` on the meta device
    needs ``device``)."""
    return tree_map_with_path(
        lambda path, leaf: _tensor(payload["/".join(path)],
                                   leaf.device if device is None
                                   else device), like)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir,
                            f"ckpt_{step:08d}.msgpack")

    def wait(self):
        """Join the writer thread; a write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, params, opt_state,
             extra: Optional[dict] = None):
        """The device-to-host copy happens here, synchronously;
        serialisation and IO move to a writer thread."""
        payload = {
            "step": int(step),
            "params": tree_to_payload(params),
            "opt": tree_to_payload(opt_state),
            "extra": extra or {},
        }
        self.wait()

        def write():
            path = self._path(step)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(msgpack.packb(payload, use_bin_type=True))
            os.replace(tmp, path)
            self._gc()

        def write_recorded():
            try:
                write()
            except Exception as err:         # re-raised by wait()
                self._error = err

        if self.async_write:
            self._thread = threading.Thread(target=write_recorded,
                                            daemon=True)
            self._thread.start()
        else:
            write()

    def _gc(self):
        for s in sorted(self.steps())[: -self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    def steps(self):
        pat = re.compile(r"ckpt_(\d+)\.msgpack")
        return sorted({int(m.group(1)) for m in map(pat.match,
                                                     os.listdir(self.dir))
                       if m})

    def restore(self, params_like, opt_like, step: Optional[int] = None,
                device=None) -> Tuple[Any, Any, int, dict]:
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        with open(self._path(step), "rb") as f:
            payload = msgpack.unpackb(f.read(), raw=False,
                                      strict_map_key=False)
        params = payload_to_tree(payload["params"], params_like, device)
        opt = payload_to_tree(payload["opt"], opt_like, device)
        return params, opt, payload["step"], payload.get("extra", {})

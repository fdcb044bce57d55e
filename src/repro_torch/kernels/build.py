"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no
PyTorch header, so ``nvcc`` compiles one in seconds.  ``load_library``
compiles a source for ``sm_90a`` at first use into
``build/repro_torch/lib<name>-<hash of the source>.so`` (an edit to the
source changes the name, hence rebuilds), loads it with ``ctypes`` and
sets the ``argtypes`` of its entry points: ``c_void_p`` for every pointer
and for the stream, ``c_int`` for sizes.

A build or a load that fails raises; nothing here gives way to a plain
PyTorch version.

The build directory is ``build/repro_torch`` at the root of the source
checkout (the directory that holds ``src/``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# library name -> {entry point: argtypes}; every entry point returns the
# launch's cudaError_t as an int
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "megabatch": {
        # xs, w, y, g, b, B, N, P, stream
        "repro_batched_gram": (_PTR, _PTR, _PTR, _PTR, _PTR,
                               _INT, _INT, _INT, _PTR),
        # xs, beta, valid, out, B, N, P, stream
        "repro_batched_predict": (_PTR, _PTR, _PTR, _PTR,
                                  _INT, _INT, _INT, _PTR),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
# library name -> (seconds nvcc took in this process, 0.0 when the library
# was already on disk; path of the shared library)
build_log: Dict[str, Tuple[float, str]] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_library(name: str, *, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        build_log.setdefault(name, (0.0, str(out)))
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)                 # atomic: two racing builds both win
    build_log[name] = (time.perf_counter() - t0, str(out))
    return out


def load_library(name: str, *, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name, verbose=verbose)))
        for fn, argtypes in SIGNATURES[name].items():
            entry = getattr(lib, fn)
            entry.argtypes = list(argtypes)
            entry.restype = _INT
        lib.repro_error_string.argtypes = [_INT]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when an entry point reported a refused launch."""
    if code != 0:
        msg: Optional[bytes] = lib.repro_error_string(code)
        raise RuntimeError(f"CUDA launch of {what} failed: error {code} "
                           f"({msg.decode() if msg else 'unknown'})")

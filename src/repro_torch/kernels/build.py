"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no
PyTorch header, so ``nvcc`` compiles one in seconds.  ``load_library``
compiles a source for ``sm_90a`` at first use, loads it with ``ctypes``
and sets the ``argtypes`` of its entry points: ``c_void_p`` for every
pointer and for the stream, ``c_int`` for sizes and flags, ``c_float``
for a scale.

Where a library is built, how it is named and when a built one is reused
is the persistent store's business (``compile/persist.py``): one file
per (toolkit, target, source and flags), under ``REPRO_PROGRAM_CACHE_DIR``
when it is set.  This module keeps the nvcc command, the entry points'
signatures and the launch check.

A build or a load that fails raises; nothing here gives way to a plain
PyTorch version.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# the one target the kernels are compiled for
PLATFORM = "sm_90a"
NVCC_FLAGS = ("-gencode", f"arch=compute_{PLATFORM[3:]},code={PLATFORM}",
              "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_PTR, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> {entry point: argtypes}; every entry point returns the
# launch's cudaError_t as an int
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "megabatch": {
        # xs, w, y, g, b, the scratch of partial tiles, the plan's table of
        # windows and items, B, N, P, then the launch plan (si, sj, chunks,
        # smem_bytes, a pointer to its layout's ints: kernels/megabatch.py
        # GramPlan), stream
        "repro_batched_gram": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                               _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                               _PTR, _PTR),
        # x, w, y, g, b, T, N, P, then the launch plan (sub, tt, slots,
        # packs, chunks, ring, m: kernels/crossfit_gram.py), stream
        "repro_crossfit_gram": (_PTR, _PTR, _PTR, _PTR, _PTR,
                                _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                _INT, _INT, _INT, _PTR),
        # xs, beta, valid, out, B, N, P, stream
        "repro_batched_predict": (_PTR, _PTR, _PTR, _PTR,
                                  _INT, _INT, _INT, _PTR),
    },
    "lm": {
        # q, k, v, o, lse (None: not written), BH, Sq, Skv, D (q, k), Dv,
        # causal, window (-1: none), scale, is_bf16, stream
        "repro_flash_attention": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT,
                                  _INT, _INT, _INT, _INT, _INT, _FLT, _INT,
                                  _PTR),
        # xbar, la, bm, cm, y, state, then the scratch cb, states, decay,
        # BH, S, P, N, chunk, heads, stream
        "repro_ssd_scan": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR),
    },
    "attn_bwd": {
        # K5's bf16 backward: q, k, v, o, lse, dO, the scratch delta, dq,
        # dk, dv, BH, Sq, Skv, D, Dv, causal, window, scale, stream
        "repro_attn_bwd": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                           _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT,
                           _INT, _FLT, _PTR),
        # K5's float32 backward: q, k, v, o, lse, dO, the scratch delta,
        # the scratch parts of q, k, v and dO, dq, dk, dv, BH, Sq, Skv, D,
        # Dv, causal, window, scale, stream
        "repro_attn_bwd_f32": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                               _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                               _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                               _FLT, _PTR),
    },
}

# the process tier of the persistent store: (build, platform, fingerprint)
# -> the loaded library (compile/persist.py inserts, through one
# registered site)
_LOADED: Dict[Tuple, ctypes.CDLL] = {}
# library name -> (seconds nvcc took in this process, 0.0 when the library
# was already built; path of the shared library)
build_log: Dict[str, Tuple[float, str]] = {}


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


def run_nvcc(source: Path, out: Path, *, verbose: bool = False) -> float:
    """Compile ``source`` into the shared library ``out`` with
    ``NVCC_FLAGS``; the seconds nvcc took.  Raises with nvcc's output
    when it fails."""
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(out), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    return time.perf_counter() - t0


def bind(lib, name: str):
    """Set the argument and result types of every entry point of
    ``SIGNATURES[name]`` on a loaded library; a missing entry point
    raises ``AttributeError``."""
    for fn, argtypes in SIGNATURES[name].items():
        entry = getattr(lib, fn)
        entry.argtypes = list(argtypes)
        entry.restype = _INT
    lib.repro_error_string.argtypes = [_INT]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def load_library(name: str, *, verbose: bool = False) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    from repro_torch.compile import persist
    return persist.library_store().load(name, verbose=verbose)


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when an entry point reported a refused launch."""
    if code != 0:
        msg: Optional[bytes] = lib.repro_error_string(code)
        raise RuntimeError(f"CUDA launch of {what} failed: error {code} "
                           f"({msg.decode() if msg else 'unknown'})")

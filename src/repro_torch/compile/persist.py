"""Persistent store of the port's built CUDA libraries.

The JAX package persists its compiled XLA executables across processes
(``REPRO_PROGRAM_CACHE_DIR``).  PyTorch runs eagerly and has no
serialized executable: what a fresh process of the port has to compile
is the kernels' shared libraries (``kernels/csrc/*.cu``, nvcc at first
use).  This module keeps the reference's contract for those:

  * **one store** under ``REPRO_PROGRAM_CACHE_DIR`` (libraries in
    ``<dir>/repro_torch/``) when it is set; else ``build/repro_torch/``
    of the source checkout the package was loaded from; else, for an
    installed package, a per-user cache directory (``$XDG_CACHE_HOME``
    or ``~/.cache``, then ``repro_torch``) — never a directory the
    package does not own;
  * **the key pins what differs between processes**: ``build`` (the
    resolved nvcc and a ``stat`` identity of it: path, size, mtime — no
    subprocess on a warm start), ``platform`` (the target, ``sm_90a``)
    and ``fingerprint`` (the library's name, and a hash of its source
    bytes, the shared headers' (``kernels/csrc/*.cuh``) and the nvcc
    flags).  A change to any of them names another
    file, so it builds again;
  * **corruption is a miss**: a file that fails to load, or lacks an
    entry point of ``kernels/build.py::SIGNATURES``, is removed (an
    eviction) and built once more; if the new build fails to load too,
    the load raises.  Nothing falls back to a plain version;
  * writes are atomic (a per-process, per-thread temporary file, then
    ``os.replace``), so concurrent builds of one library end with one
    good file;
  * the process tier is ``kernels/build.py::_LOADED``, keyed by the same
    triple as the disk.

``ProgramCache(persist="auto")`` (compile/program.py) counts the library
lookups of its programs in ``CompileStats.disk_hits``/``disk_misses``
when a persistent directory is configured.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from repro_torch.analysis.registry import warm_cache
from repro_torch.kernels import build as kbuild
from repro_torch.runtime import bounded_put

# Environment switch, the reference's variable: a directory to keep the
# built libraries in across processes and checkouts.
ENV_CACHE_DIR = "REPRO_PROGRAM_CACHE_DIR"

Key = Tuple[str, str, Tuple[str, str]]


def cache_dir() -> Path:
    """The directory the libraries are built into and loaded from."""
    configured = os.environ.get(ENV_CACHE_DIR)
    if configured:
        return Path(configured) / "repro_torch"
    pkg = Path(__file__).resolve().parents[1]          # .../repro_torch
    checkout = pkg.parents[1]
    if pkg.parent.name == "src" and (checkout / "pyproject.toml").is_file():
        return checkout / "build" / "repro_torch"
    xdg = os.environ.get("XDG_CACHE_HOME", "")
    base = Path(xdg) if os.path.isabs(xdg) else Path.home() / ".cache"
    return base / "repro_torch"


def open_library(path: str) -> ctypes.CDLL:
    """``ctypes.CDLL`` of a shared library that is whole.  The dynamic
    loader maps a file cut short (a killed copy) and then faults on it
    (SIGBUS) instead of failing, so the ELF headers are held against the
    file's size first: a file shorter than its program segments or its
    section header table raises ``OSError``, as a load that fails does."""
    with open(path, "rb") as f:
        head = f.read(64)
        size = os.fstat(f.fileno()).st_size
        if len(head) < 64 or head[:5] != b"\x7fELF\x02":
            raise OSError(f"{path}: not a 64-bit ELF file")
        phoff, shoff = struct.unpack_from("<QQ", head, 0x20)
        phentsize, phnum, shentsize, shnum = struct.unpack_from(
            "<HHHH", head, 0x36)
        need = max(phoff + phentsize * phnum, shoff + shentsize * shnum)
        if size >= need:
            f.seek(phoff)
            table = f.read(phentsize * phnum)
            for i in range(phnum):
                _, _, offset, _, _, filesz = struct.unpack_from(
                    "<IIQQQQ", table, i * phentsize)
                need = max(need, offset + filesz)
    if size < need:
        raise OSError(f"{path}: {size} bytes, its headers need {need}")
    return ctypes.CDLL(path)


def toolkit_identity(nvcc: str) -> str:
    """``build`` component: the resolved compiler and a ``stat`` identity
    of it, which changes when the toolkit is replaced."""
    path = os.path.realpath(nvcc)
    st = os.stat(path)
    return f"{path}:{st.st_size}:{st.st_mtime_ns}"


class PersistentProgramCache:
    """Directory of built kernel libraries, one file per
    ``(build, platform, fingerprint)``.

    ``loader`` opens a shared library (``open_library``); a test may
    give another.  Counters: ``hits`` (served from the process tier or the
    disk), ``misses`` (built), ``builds`` (nvcc runs that produced a
    file), ``evictions`` (files that failed to load and were removed).
    """

    _PROCESS_CAP = 64

    def __init__(self, cache_dir: Path, *,
                 loader: Callable[[str], object] = open_library):
        self.cache_dir = Path(cache_dir)
        self.loader = loader
        self.hits = self.misses = self.builds = self.evictions = 0
        self._ready: Dict[str, object] = {}
        # one lock a library: two threads never build the same one, and
        # two libraries build side by side
        self._locks: Dict[str, threading.Lock] = {}

    def key(self, name: str) -> Key:
        # the source and every header beside it (hopper.cuh): a header's
        # change rebuilds the libraries
        source = (kbuild.CSRC / f"{name}.cu").read_bytes() + b"".join(
            h.read_bytes() for h in sorted(kbuild.CSRC.glob("*.cuh")))
        digest = hashlib.sha1(
            source + " ".join(kbuild.NVCC_FLAGS).encode()).hexdigest()
        return (toolkit_identity(kbuild.find_nvcc()), kbuild.PLATFORM,
                (name, digest))

    def path(self, build: str, platform: str,
             fingerprint: Tuple[str, str]) -> Path:
        h = hashlib.sha1(
            repr((build, platform, fingerprint)).encode()).hexdigest()
        return self.cache_dir / f"lib{fingerprint[0]}-{h[:16]}.so"

    def _open(self, path: Path, name: str):
        return kbuild.bind(self.loader(str(path)), name)

    # The process tier caches under the full triple, as the disk does:
    # the toolkit and the target pin the binary's format, the fingerprint
    # pins the library (its source and flags).  Its single insert site;
    # lookup and store both remember through it.
    @warm_cache(name="persistent_program_cache_process_tier",
                key=("build", "platform", "fingerprint"),
                reads=("prog",),
                covers={"fingerprint": ("prog",)},
                ambient=("self",))
    def _process_put(self, build: str, platform: str,
                     fingerprint: Tuple[str, str], prog) -> None:
        bounded_put(kbuild._LOADED, (build, platform, fingerprint), prog,
                    self._PROCESS_CAP)

    # The file is a pure function of the full key (the same triple as
    # the process tier); the directory handle is instance state.
    @warm_cache(name="persistent_program_cache",
                key=("build", "platform", "fingerprint"),
                ambient=("self",))
    def lookup(self, build: str, platform: str,
               fingerprint: Tuple[str, str]):
        """The loaded library from the process tier, else from the disk,
        else None.  A file that fails to load is evicted (a miss)."""
        prog = kbuild._LOADED.get((build, platform, fingerprint))
        if prog is not None:
            return prog
        path = self.path(build, platform, fingerprint)
        if not path.exists():
            return None
        try:
            prog = self._open(path, fingerprint[0])
        except (OSError, AttributeError):
            # a torn copy, a foreign or truncated file: evict and miss
            self.evictions += 1
            path.unlink(missing_ok=True)
            return None
        self._process_put(build, platform, fingerprint, prog)
        return prog

    def store(self, build: str, platform: str,
              fingerprint: Tuple[str, str], *, verbose: bool = False):
        """Build the library of ``fingerprint`` with nvcc into its file
        (atomically) and load it; a build that does not load raises."""
        name = fingerprint[0]
        out = self.path(build, platform, fingerprint)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        try:
            secs = kbuild.run_nvcc(kbuild.CSRC / f"{name}.cu", tmp,
                                   verbose=verbose)
            os.replace(tmp, out)           # atomic: racing builds both win
        finally:
            tmp.unlink(missing_ok=True)
        self.builds += 1
        kbuild.build_log[name] = (secs, str(out))
        try:
            prog = self._open(out, name)
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"the library built for {name}.cu does not "
                               f"load ({out}): {e}") from e
        self._process_put(build, platform, fingerprint, prog)
        return prog

    def load(self, name: str, *, verbose: bool = False):
        """The loaded library of ``csrc/<name>.cu``: from this store's
        own map, the process tier, the disk, or a build."""
        lib = self._ready.get(name)
        if lib is not None:
            return lib
        with self._locks.setdefault(name, threading.Lock()):
            lib = self._ready.get(name)
            if lib is not None:
                return lib
            key = self.key(name)
            lib = self.lookup(*key)
            if lib is None:
                self.misses += 1
                lib = self.store(*key, verbose=verbose)
            else:
                self.hits += 1
                kbuild.build_log.setdefault(name, (0.0, str(self.path(*key))))
            self._ready[name] = lib
        return lib

    def lookup_library(self, name: str) -> bool:
        """Resolve ``name`` as a program's first launch does: True when it
        was served without a build."""
        builds = self.builds
        self.load(name)
        return self.builds == builds

    def summary(self) -> dict:
        return {"cache_dir": str(self.cache_dir), "hits": self.hits,
                "misses": self.misses, "builds": self.builds,
                "evictions": self.evictions,
                "nvcc_s": {name: s for name, (s, _) in kbuild.build_log.items()
                           if s > 0}}


# REPRO_PROGRAM_CACHE_DIR's value (None: unset) -> its store; read at
# every launch, so the directory is resolved once per value
_STORES: Dict[Optional[str], PersistentProgramCache] = {}


def library_store() -> PersistentProgramCache:
    """The store of the configured directory."""
    configured = os.environ.get(ENV_CACHE_DIR) or None
    store = _STORES.get(configured)
    if store is None:
        store = _STORES.setdefault(configured,
                                   PersistentProgramCache(cache_dir()))
    return store


def default_persist() -> Optional[PersistentProgramCache]:
    """The store when ``REPRO_PROGRAM_CACHE_DIR`` is set, else None."""
    return library_store() if os.environ.get(ENV_CACHE_DIR) else None

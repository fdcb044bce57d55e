"""The port's persistent library store (``compile/persist.py``) on the
CPU, with no nvcc: the contract of the JAX package's program cache
(``tests/test_persist.py``) for the thing a fresh process of the port
compiles, the kernels' shared libraries.

A stub compiler stands in for nvcc: a Python script found through
``CUDA_HOME`` (where ``kernels/build.py::find_nvcc`` looks first) that
writes the output file it is asked for and logs each call.  A test
double stands in for ``ctypes.CDLL``: it opens a file the stub wrote as
a library with every entry point of ``SIGNATURES``, and refuses any
other file as the dynamic loader refuses a truncated one.
"""
import inspect
import json
import os
import stat
import subprocess
import sys
import types
from pathlib import Path

import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch.compile import ProgramCache, persist
from repro_torch.compile.buckets import BucketKey
from repro_torch.kernels import build
from repro_torch.learners import get_batched_learner

SRC = str(Path(__file__).resolve().parent.parent / "src")

STUB_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out, source = args[args.index("-o") + 1], args[-1]
with open(os.environ["STUB_NVCC_LOG"], "a") as f:
    f.write(os.path.basename(source) + "\\n")
time.sleep(float(os.environ.get("STUB_NVCC_SLEEP", "0")))
with open(out, "w") as f:
    f.write(os.environ.get("STUB_NVCC_OUTPUT", "library") + " " + source)
"""

def fake_cdll(path):
    with open(path) as f:
        if not f.read().startswith("library"):
            raise OSError(f"{path}: invalid ELF header")
    names = [fn for sig in build.SIGNATURES.values() for fn in sig]
    return types.SimpleNamespace(**{n: types.SimpleNamespace() for n in
                                    names + ["repro_error_string"]})


# a child process: the default store (REPRO_PROGRAM_CACHE_DIR) with the
# loader double, loading the libraries named on its command line
CHILD = f"""
import json, sys, types
from repro_torch.compile import persist
from repro_torch.kernels import build
{inspect.getsource(fake_cdll)}
store = persist.library_store()
store.loader = fake_cdll
for name in sys.argv[1:]:
    build.load_library(name)
print(json.dumps(store.summary()))
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """CUDA_HOME with a stub nvcc; returns (nvcc path, call log path).
    The process tier starts empty, so lookups reach the disk."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    log.touch()
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("STUB_NVCC_LOG", str(log))
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build_log", {})
    return nvcc, log


def _calls(log):
    return log.read_text().split()


def _store(tmp_path):
    return persist.PersistentProgramCache(tmp_path / "store",
                                          loader=fake_cdll)


def _children(tmp_path, log, names, *, n=1, sleep=0.0):
    env = dict(os.environ, PYTHONPATH=SRC, STUB_NVCC_LOG=str(log),
               STUB_NVCC_SLEEP=str(sleep),
               REPRO_PROGRAM_CACHE_DIR=str(tmp_path / "progcache"))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, *names],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def test_second_process_builds_zero_libraries(tmp_path, stub_nvcc):
    """A fresh process on a warm directory builds nothing; the libraries
    live under ``REPRO_PROGRAM_CACHE_DIR/repro_torch``."""
    _, log = stub_nvcc
    (first,) = _children(tmp_path, log, ["megabatch", "lm"])
    assert (first["builds"], first["misses"], first["hits"]) == (2, 2, 0)
    assert sorted(_calls(log)) == ["lm.cu", "megabatch.cu"]
    assert first["cache_dir"] == str(tmp_path / "progcache" / "repro_torch")
    (second,) = _children(tmp_path, log, ["megabatch", "lm"])
    assert (second["builds"], second["misses"], second["hits"],
            second["evictions"]) == (0, 0, 2, 0)
    assert len(_calls(log)) == 2
    libs = sorted(p.name.split("-")[0] for p in
                  (tmp_path / "progcache" / "repro_torch").iterdir())
    assert libs == ["liblm", "libmegabatch"]


@pytest.mark.parametrize("change", ["source", "header", "flags", "toolkit"])
def test_a_change_to_source_flags_or_toolkit_builds_again(
        tmp_path, stub_nvcc, monkeypatch, change):
    nvcc, log = stub_nvcc
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "megabatch.cu").write_bytes(
        (build.CSRC / "megabatch.cu").read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    first = _store(tmp_path)
    first.load("megabatch")
    key = first.key("megabatch")
    monkeypatch.setattr(build, "_LOADED", {})
    same = _store(tmp_path)
    same.load("megabatch")
    assert (same.builds, same.hits) == (0, 1)
    if change == "source":                 # one byte more, in a comment
        with open(csrc / "megabatch.cu", "a") as f:
            f.write("//\n")
    elif change == "header":               # a header beside the sources
        (csrc / "hopper.cuh").write_text("//\n")
    elif change == "flags":
        monkeypatch.setattr(build, "NVCC_FLAGS",
                            build.NVCC_FLAGS + ("-lineinfo",))
    else:                                  # another toolkit at that path
        st = nvcc.stat()
        os.utime(nvcc, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    changed = _store(tmp_path)
    changed.load("megabatch")
    assert (changed.builds, changed.misses, changed.hits) == (1, 1, 0)
    assert len(_calls(log)) == 2
    new_key = changed.key("megabatch")
    part = {"source": 2, "header": 2, "flags": 2, "toolkit": 0}[change]
    assert [k for k in range(3) if new_key[k] != key[k]] == [part]
    assert changed.path(*new_key) != first.path(*key)


def test_a_library_that_fails_to_load_is_evicted_and_rebuilt_once(
        tmp_path, stub_nvcc, monkeypatch):
    _, log = stub_nvcc
    first = _store(tmp_path)
    first.load("megabatch")
    (lib,) = (tmp_path / "store").iterdir()
    lib.write_bytes(lib.read_bytes()[:3])       # a truncated copy
    monkeypatch.setattr(build, "_LOADED", {})
    again = _store(tmp_path)
    assert again.load("megabatch") is not None
    assert (again.evictions, again.builds, again.misses) == (1, 1, 1)
    assert len(_calls(log)) == 2
    assert lib.read_text().startswith("library")


def test_a_rebuilt_library_that_still_fails_raises(tmp_path, stub_nvcc,
                                                   monkeypatch):
    """A corrupt file is evicted and built once; when the new build does
    not load either, the load raises: no loop, no plain fallback."""
    _, log = stub_nvcc
    store = _store(tmp_path)
    path = store.path(*store.key("megabatch"))
    path.parent.mkdir(parents=True)
    path.write_bytes(b"\x7fEL")
    monkeypatch.setenv("STUB_NVCC_OUTPUT", "garbage")
    with pytest.raises(RuntimeError, match="does not load"):
        store.load("megabatch")
    assert (store.evictions, store.builds) == (1, 1)
    assert _calls(log) == ["megabatch.cu"]


def test_concurrent_builds_end_with_one_good_file(tmp_path, stub_nvcc):
    """Two processes build the same library at once: both load it, and
    the directory holds one library file and no temporary one."""
    _, log = stub_nvcc
    both = _children(tmp_path, log, ["megabatch"], n=2, sleep=1.0)
    assert all(s["misses"] + s["hits"] == 1 for s in both)
    files = list((tmp_path / "progcache" / "repro_torch").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".so")
    assert ".tmp" not in files[0].name
    assert files[0].read_text().startswith("library")


class _OnCard:
    """Stands for a page stack on a CUDA device: indexes as the CPU
    tensor it wraps, and says it is on the card."""
    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getitem__(self, idx):
        return self.t[idx]


def _launch(prog, pages, b=8, n=24):
    gen = torch.Generator().manual_seed(0)
    y = torch.randn(b, n, generator=gen)
    w = (torch.rand(b, n, generator=gen) > 0.3).float()
    return prog(pages, torch.zeros(b, dtype=torch.int64), y, w,
                torch.ones(b, n), torch.zeros(b, 2, dtype=torch.int64))


@pytest.mark.parametrize("family,lookups", [
    ("ridge", 1), ("logistic", 0)])
def test_program_cache_counts_library_lookups_on_the_card_only(
        tmp_path, stub_nvcc, family, lookups):
    """With a store, a program's first launch on a CUDA device looks its
    kernel library up once (a build is a disk miss, a later program's
    lookup a disk hit); CPU launches and families that launch no kernel
    look nothing up."""
    store = _store(tmp_path)
    params = (("reg", 1.0),) if family == "ridge" else ()
    cache = ProgramCache(persist=store)
    pages = torch.randn(1, 24, 4, generator=torch.Generator().manual_seed(1))
    key = BucketKey((family, params), 24, 4)

    def thunk():
        return get_batched_learner(family, dict(params))

    prog = cache.program(key, 8, 1, thunk)
    cpu = _launch(prog, pages)
    assert (cache.stats.disk_hits, cache.stats.disk_misses) == (0, 0)
    card = _launch(prog, _OnCard(pages))
    _launch(cache.program(key, 8, 1, thunk), _OnCard(pages))
    assert torch.equal(cpu, card)
    assert (cache.stats.disk_hits, cache.stats.disk_misses) == (0, lookups)
    assert store.builds == lookups
    fused = cache.fused_program(key, 8, 1, 1, thunk)
    fused(_OnCard(pages), torch.zeros(1, 8, dtype=torch.int64),
          *(t.unsqueeze(0) for t in (torch.randn(8, 24), torch.ones(8, 24),
                                     torch.ones(8, 24))),
          torch.zeros(1, 8, 2, dtype=torch.int64))
    assert (cache.stats.disk_hits, cache.stats.disk_misses) == \
        (lookups, lookups)


def test_no_store_without_the_environment_variable(monkeypatch):
    monkeypatch.delenv(persist.ENV_CACHE_DIR, raising=False)
    assert ProgramCache().persist is None
    assert persist.default_persist() is None
    summary = ProgramCache().stats.summary()
    assert (summary["disk_hits"], summary["disk_misses"]) == (0, 0)


def test_the_directory_is_one_the_package_owns(tmp_path, monkeypatch):
    """The variable's directory; else the source checkout's
    ``build/repro_torch``; else, installed, the user's cache directory —
    never a path beside the interpreter's library directory."""
    monkeypatch.setenv(persist.ENV_CACHE_DIR, str(tmp_path / "c"))
    assert persist.cache_dir() == tmp_path / "c" / "repro_torch"
    monkeypatch.delenv(persist.ENV_CACHE_DIR)
    assert persist.cache_dir() == \
        Path(SRC).parent / "build" / "repro_torch"
    site = tmp_path / "lib" / "python3.12" / "site-packages"
    monkeypatch.setattr(persist, "__file__",
                        str(site / "repro_torch" / "compile" / "persist.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert persist.cache_dir() == tmp_path / "xdg" / "repro_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", "relative/not/a/base")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert persist.cache_dir() == tmp_path / "home" / ".cache" / "repro_torch"


def test_the_default_loader_refuses_a_cut_library(tmp_path):
    """The dynamic loader maps a shared library cut short and then faults
    on it (SIGBUS) rather than failing; ``open_library`` holds the ELF
    headers against the file's size first, so a cut copy raises OSError
    (an eviction in the store) and a whole one loads."""
    import numpy
    whole = min(Path(numpy.__file__).parent.rglob("*.so"),
                key=lambda p: p.stat().st_size)
    assert persist.open_library(str(whole)) is not None
    data = whole.read_bytes()
    for cut in (len(data) // 2, len(data) - 1, 40):
        part = tmp_path / f"cut{cut}.so"
        part.write_bytes(data[:cut])
        with pytest.raises(OSError):
            persist.open_library(str(part))

"""Dead-code report — static import reachability over ``src/repro_torch``.

A copy of the JAX package's ``analysis/deadcode.py`` for the port.  It
builds the module import graph by parsing every source file (no imports
executed), roots it at what loads the port — its tests
(``tests/test_torch_*.py``), ``chip_smoke.py``, ``scripts/*.py`` and
the example twins (``examples/*_torch.py``) — and reports every module
nothing reachable imports.

Modules that are loaded dynamically are whitelisted as roots with a
reason; anything else unreachable is a finding, so keeping a module
means either wiring it to an entry point or consciously adding it to
``WHITELIST`` with a reason.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis import astutil
from repro_torch.analysis.report import Finding

#: dynamically-imported or intentionally-kept modules (module name or
#: trailing-dot prefix), with the reason they stay
WHITELIST: Dict[str, str] = {
    "repro_torch.configs.": "arch configs load via importlib in get_arch()",
    "repro_torch.analysis.": "the auditor is its own CI entry point "
                             "(python -m repro_torch.analysis)",
}


def _module_name(root: Path, path: Path) -> str:
    rel = path.relative_to(root).with_suffix("")
    parts = ("repro_torch",) + rel.parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _whitelisted(mod: str) -> bool:
    for w in WHITELIST:
        if mod == w.rstrip(".") or (w.endswith(".")
                                    and mod.startswith(w)):
            return True
    return False


def _with_parents(mod: str, out: Set[str]) -> None:
    parts = mod.split(".")
    for i in range(1, len(parts) + 1):
        out.add(".".join(parts[:i]))


def _entry_points(repo: Path) -> List[Path]:
    """The files that load the port: its tests, the chip smoke test, the
    scripts and the example twins."""
    return (sorted((repo / "tests").glob("test_torch_*.py"))
            + sorted(repo.glob("chip_smoke.py"))
            + sorted((repo / "scripts").glob("*.py"))
            + sorted((repo / "examples").glob("*_torch.py")))


def _external_roots(src_root: Path) -> Set[str]:
    """repro_torch modules imported by the port's entry points."""
    roots: Set[str] = set()
    for path in _entry_points(src_root.parents[1]):
        tree = astutil.parse(path)
        for name in astutil.imports_of(tree, path.stem):
            if name == "repro_torch" or name.startswith("repro_torch."):
                roots.add(name)
    return roots


def graph(root: Optional[Path] = None):
    """``(modules, edges, roots)`` of the static import graph."""
    root = root or astutil.default_root()
    paths = {p: _module_name(root, p) for p in astutil.iter_py_files(root)}
    modules = set(paths.values()) | {"repro_torch"}
    edges: Dict[str, Set[str]] = {m: set() for m in modules}
    for path, mod in paths.items():
        for name in astutil.imports_of(astutil.parse(path), mod):
            # "from repro_torch.x import y" contributes both
            # repro_torch.x and repro_torch.x.y — keep whichever are
            # real modules
            if name in modules and name != mod:
                edges[mod].add(name)
    roots: Set[str] = set()
    for name in _external_roots(root):
        if name in modules:
            _with_parents(name, roots)
    for mod in modules:
        if _whitelisted(mod):
            _with_parents(mod, roots)
    return modules, edges, roots


def run(root: Optional[Path] = None) -> List[Finding]:
    modules, edges, roots = graph(root)
    seen: Set[str] = set()
    frontier = sorted(roots & modules)
    while frontier:
        mod = frontier.pop()
        if mod in seen:
            continue
        seen.add(mod)
        for dep in edges.get(mod, ()):
            ext: Set[str] = set()
            _with_parents(dep, ext)
            frontier.extend(ext - seen)
    findings: List[Finding] = []
    for mod in sorted(modules - seen):
        findings.append(Finding(
            "dead-code", "unreachable-module", mod,
            "no test, script, example or whitelisted entry point reaches "
            "this module — delete it or whitelist it with a reason"))
    return findings

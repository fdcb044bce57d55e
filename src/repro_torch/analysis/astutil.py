"""Shared pure-AST helpers for the static passes.

The helpers of the JAX package's ``analysis/astutil.py`` (which imports
no JAX) that the static protocol pass (``protocol.py``) uses, copied
because the port imports nothing of that package.  The pass analyses
**source text**, never imported modules: the mutation tests run it
against deliberately broken copies of the tree in a tmp dir, and
importing mutated hot-path code would be both slow and unsafe.  All
helpers therefore operate on ``ast`` nodes parsed from files under a
caller-supplied source root (defaulting to the installed
``src/repro_torch``).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator, List, Optional, Set, Tuple


def default_root() -> Path:
    """The ``src/repro_torch`` tree this package was loaded from."""
    return Path(__file__).resolve().parents[1]


def parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def iter_functions(tree: ast.Module,
                   ) -> Iterator[Tuple[str, ast.FunctionDef]]:
    """Yield ``(qualname, node)`` for every (async) function def, with
    class nesting reflected in the qualname (``Cls.meth``)."""
    def walk(node: ast.AST, prefix: str) -> Iterator:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """Dotted name of the callee (``q.push``, ``dispatch_bucket``).
    A chain interrupted by a subscript/call still reports its method
    leaf as ``?.leaf`` (``state.requests[0].ledger.record_failure(0)``
    -> ``?.record_failure``) so method-allowlist checks cannot be evaded
    by indexing."""
    cn = dotted(node.func)
    if cn is None and isinstance(node.func, ast.Attribute):
        return f"?.{node.func.attr}"
    return cn


def calls_in(fn: ast.FunctionDef) -> List[Tuple[int, str, ast.Call]]:
    """Every call in the body as ``(lineno, dotted_callee, node)`` in
    source order; calls with non-chain callees are skipped."""
    out: List[Tuple[int, str, ast.Call]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            cn = call_name(node)
            if cn is not None:
                out.append((node.lineno, cn, node))
    out.sort(key=lambda t: t[0])
    return out


def module_calls(tree: ast.Module) -> List[Tuple[str, int, str]]:
    """Every call in a module as ``(enclosing_qualname, lineno,
    dotted_callee)``; module-level calls get qualname ``"<module>"``."""
    covered: Set[int] = set()
    out: List[Tuple[str, int, str]] = []
    for qual, fn in iter_functions(tree):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and id(node) not in covered:
                covered.add(id(node))
                cn = call_name(node)
                if cn is not None:
                    out.append((qual, node.lineno, cn))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and id(node) not in covered:
            cn = call_name(node)
            if cn is not None:
                out.append(("<module>", node.lineno, cn))
    return out

"""Shared pure-AST helpers for the static passes.

A copy of the JAX package's ``analysis/astutil.py`` (which imports no
JAX), because the port imports nothing of that package.  Every static
pass (cache_keys, protocol, deadcode) analyses **source text**, never
imported modules: the mutation tests run the passes against
deliberately broken copies of the tree in a tmp dir, and importing
mutated hot-path code would be both slow and unsafe.  All helpers
therefore operate on ``ast`` nodes parsed from files under a
caller-supplied source root (defaulting to the installed
``src/repro_torch``).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple


def default_root() -> Path:
    """The ``src/repro_torch`` tree this package was loaded from."""
    return Path(__file__).resolve().parents[1]


def iter_py_files(root: Path) -> Iterator[Path]:
    for p in sorted(root.rglob("*.py")):
        yield p


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


def func_params(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def attribute_reads(fn: ast.FunctionDef, roots: Set[str]) -> Set[str]:
    """Maximal dotted attribute chains rooted at ``roots`` read anywhere
    in the function body (nested defs included; their own parameters
    shadow outer roots and are excluded).

    ``req._index_maps()[0]`` contributes ``req._index_maps`` — method
    access counts as a read of that path, so cache contracts must either
    key it or justify it under ``covers``.  Simple aliases are followed:
    after ``g = self.grid``, a read of ``g.n_rep`` is reported as
    ``self.grid.n_rep`` (single-assignment approximation — good enough
    for lint; reassigned aliases may over- or under-report one chain).
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            src = dotted(node.value)
            if src is not None and src != node.targets[0].id:
                aliases[node.targets[0].id] = src

    def expand(chain: str) -> str:
        seen: Set[str] = set()
        while True:
            head, dot, rest = chain.partition(".")
            if head in seen or head not in aliases:
                return chain
            seen.add(head)
            chain = aliases[head] + (dot + rest if dot else "")

    out: Set[str] = set()

    def visit(node: ast.AST, roots: Set[str], parent_attr: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            inner = roots - ({p.arg for p in node.args.args}
                             | {p.arg for p in node.args.kwonlyargs}
                             | ({node.args.vararg.arg}
                                if node.args.vararg else set())
                             | ({node.args.kwarg.arg}
                                if node.args.kwarg else set()))
            for child in ast.iter_child_nodes(node):
                visit(child, inner, False)
            return
        if isinstance(node, ast.Attribute):
            if not parent_attr:
                path = dotted(node)
                if path is not None:
                    path = expand(path)
                    if path.split(".", 1)[0] in roots:
                        out.add(path)
            visit(node.value, roots, True)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, roots, False)

    for stmt in fn.body:
        visit(stmt, roots, False)
    return out


def decorator_call(fn: ast.FunctionDef, name: str) -> Optional[ast.Call]:
    """The ``@name(...)`` decorator Call node on ``fn``, if present
    (matches both ``name`` and ``mod.name`` spellings)."""
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            cn = call_name(dec)
            if cn is not None and cn.split(".")[-1] == name:
                return dec
    return None


def literal_kwargs(call: ast.Call) -> Dict[str, object]:
    """Keyword arguments of a call evaluated as literals; non-literal
    values raise ValueError (contracts must be compile-time constants)."""
    out: Dict[str, object] = {}
    for kw in call.keywords:
        if kw.arg is None:
            raise ValueError("**kwargs not allowed in contract")
        try:
            out[kw.arg] = ast.literal_eval(kw.value)
        except (ValueError, SyntaxError) as e:
            raise ValueError(
                f"non-literal contract value for {kw.arg!r}") from e
    return out


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


def imports_of(tree: ast.Module, module_name: str) -> Set[str]:
    """Absolute module names imported by a module (``import x.y`` and
    ``from x.y import z`` both contribute ``x.y``; relative imports are
    resolved against ``module_name``)."""
    out: Set[str] = set()
    pkg_parts = module_name.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:-node.level] if node.level <= len(
                    pkg_parts) else []
                mod = ".".join(base + ([node.module] if node.module
                                       else []))
            else:
                mod = node.module or ""
            if mod:
                out.add(mod)
                for alias in node.names:
                    out.add(f"{mod}.{alias.name}")
    return out

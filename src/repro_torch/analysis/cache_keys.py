"""Cache-key soundness over every registered warm cache of the port.

A copy of the JAX package's ``analysis/cache_keys.py`` pointed at
``src/repro_torch`` (the same rules, the same findings; the port's
caches are listed in ``EXPECTED_CACHES``).  The JAX package once had a
staleness bug of exactly the class this pass eliminates: the stacked
block-tensor cache was keyed by a fingerprint of the X page
while the cached tensors also derived from y/d/z — two datasets sharing
one X silently shared cached targets.  The fix (``DMLData.content_key``)
was example-tested; this pass makes the whole *class* of bug a lint
failure:

  * every bounded warm cache must be registered with ``@warm_cache``
    (``analysis/registry.py``) declaring its key paths, extra reads,
    and the coverage justification tying each read to the key component
    that pins it;
  * the decorated body is AST-checked: an attribute chain read on a
    cache-relevant parameter that is not a key path, a declared read,
    or ambient state scoped to the cache's own lifetime fails the audit
    — so a new read cannot land without extending the key or
    consciously documenting why the key already pins it;
  * two targeted structural checks guard the key *sources* themselves:
    ``DMLData.content_key`` must fingerprint every role in ``_ROLES``,
    and ``compile_request``'s ``work_key`` must be built from
    ``content_key()`` (never the X-only ``fingerprint()``).

Everything here is pure-AST over source text (``astutil``): the
mutation regression tests run this pass against deliberately-broken
copies of the tree without importing them.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.report import Finding

#: every bounded warm cache on the hot path must register under exactly
#: these names — a new bounded_put call site without a registration (or
#: a silently dropped decoration) fails the audit
EXPECTED_CACHES: Tuple[str, ...] = (
    "program_cache",            # ProgramCache.program
    "fused_program_cache",      # ProgramCache.fused_program
    # the reference's thirteenth, "sharded_fused_program_cache" (the
    # shard_map-wrapped fused form), waits for the multi-card mesh
    # (ROADMAP items 10/11b): on one card the sharded backend fuses as
    # inline does, through fused_program_cache
    "block_layouts",            # compile/program.py::_request_block_layout
    "block_tensors",            # compile/program.py::_block_tensors
    "fold_in_key_tables",       # serverless/backends.py::_segment_key_table
    "work_request_index_maps",  # serverless/backends.py::_index_maps
    "page_pool_stacks",         # compile/pages.py::PagePool.stack
    "plan_pages",               # compile/buckets.py::MegabatchPlan.page
    "persistent_program_cache",  # compile/persist.py::PersistentProgramCache.lookup
    # the process tier over the disk (kernels/build.py::_LOADED) shares
    # the same triple key; its single insert site
    # (PersistentProgramCache._process_put) is what lookup() and store()
    # both remember through
    "persistent_program_cache_process_tier",
    # the in-mesh axis programs on one card (sharding/gram.py): one per
    # (mesh, mesh_axis, family, params), standalone Gram form and the
    # drain's bucket fit-predict form sharing each cache
    "data_gram_programs",       # sharding/gram.py::_data_gram_fn
    "feature_gram_programs",    # sharding/gram.py::_feature_gram_fn
)

#: the persistent store outlives the process, so its key must pin
#: everything that can differ between two processes sharing the
#: directory: the build (the nvcc toolkit that compiled a library), the
#: platform (the target it was compiled for, sm_90a), and the
#: fingerprint (the library's source bytes and flags)
PERSIST_KEY_COMPONENTS: Tuple[str, ...] = (
    "build", "platform", "fingerprint")


def _covered(chain: str, paths: Sequence[str]) -> bool:
    """A read chain is pinned if a declared path equals it, prefixes it
    (reading a sub-field of a keyed value), or extends it (reading an
    object whose sub-field is keyed — e.g. ``self.grid`` when
    ``self.grid.n_rep`` is a key component)."""
    for p in paths:
        if chain == p or chain.startswith(p + ".") \
                or p.startswith(chain + "."):
            return True
    return False


def _check_contract(rel: str, qual: str, fn: ast.FunctionDef,
                    kwargs: Dict) -> List[Finding]:
    where = f"{rel}:{fn.lineno}"
    findings: List[Finding] = []
    key = tuple(kwargs.get("key", ()))
    reads = tuple(kwargs.get("reads", ()))
    covers = {k: tuple(v) for k, v in dict(kwargs.get("covers",
                                                      {})).items()}
    ambient = tuple(kwargs.get("ambient", ()))
    declared = key + reads + ambient

    # structural sanity of the contract itself
    for ck in covers:
        if ck not in key:
            findings.append(Finding(
                "cache-keys", "cover-not-a-key", where,
                f"{qual}: covers[{ck!r}] is not a declared key path"))
    covered_reads: Set[str] = set()
    for vals in covers.values():
        covered_reads.update(vals)
    for r in reads:
        if r not in covered_reads:
            findings.append(Finding(
                "cache-keys", "unjustified-read", where,
                f"{qual}: read {r!r} is not pinned by any key component "
                "(add it to covers with the key path that determines "
                "it, or extend the key)"))

    # every parameter must be accounted for
    params = [p for p in astutil.func_params(fn)]
    for p in params:
        if not _covered(p, declared):
            findings.append(Finding(
                "cache-keys", "unkeyed-parameter", where,
                f"{qual}: parameter {p!r} is neither a key component, "
                "a declared read, nor ambient — its value can change "
                "the cached result without changing the cache key"))

    # every attribute chain the body reads must be pinned
    for chain in sorted(astutil.attribute_reads(fn, set(params))):
        if not _covered(chain, declared):
            findings.append(Finding(
                "cache-keys", "uncovered-read", where,
                f"{qual}: reads {chain} but the cache key does not "
                "cover it — a stale hit can serve results computed "
                "from different contents (declare it in key, or in "
                "reads + covers with justification)"))
    return findings


def _check_content_key(tree: ast.Module, rel: str) -> List[Finding]:
    """``DMLData.content_key`` must fingerprint every role in
    ``_ROLES`` — dropping one array re-creates the block-tensor staleness
    bug."""
    findings: List[Finding] = []
    roles: Optional[Tuple[str, ...]] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "_ROLES"
                        for t in node.targets):
            try:
                roles = tuple(ast.literal_eval(node.value))
            except (ValueError, SyntaxError):
                pass
    if roles is None:
        return [Finding("cache-keys", "content-key-covers-roles", rel,
                        "_ROLES literal not found in core/spec.py")]
    for qual, fn in astutil.iter_functions(tree):
        if qual != "DMLData.content_key":
            continue
        # the iteration must range over the bare _ROLES name itself
        # (a slice/subset evades a mere name-presence check), or spell
        # out every role literally — a hardcoded subset fails
        iters = [n.iter for n in ast.walk(fn)
                 if isinstance(n, (ast.For, ast.comprehension))]
        bare = any(isinstance(i, ast.Name) and i.id == "_ROLES"
                   for i in iters)
        lits = {n.value for n in ast.walk(fn)
                if isinstance(n, ast.Constant) and isinstance(n.value,
                                                              str)}
        if bare or set(roles) <= lits:
            return findings
        missing = sorted(set(roles) - lits)
        findings.append(Finding(
            "cache-keys", "content-key-covers-roles",
            f"{rel}:{fn.lineno}",
            f"DMLData.content_key does not fingerprint roles {missing} "
            "— two datasets differing only in those arrays would share "
            "every content-keyed cache entry"))
        return findings
    findings.append(Finding(
        "cache-keys", "content-key-covers-roles", rel,
        "DMLData.content_key not found"))
    return findings


def _check_work_key(tree: ast.Module, rel: str) -> List[Finding]:
    """``compile_request``'s ``work_key`` must be built from
    ``data.content_key()`` — ``fingerprint()`` keys only the X page."""
    for qual, fn in astutil.iter_functions(tree):
        if qual != "compile_request":
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "work_key"
                            for t in node.targets)):
                continue
            calls = [astutil.call_name(c) for c in ast.walk(node.value)
                     if isinstance(c, ast.Call)]
            calls = [c for c in calls if c is not None]
            if any(c.endswith(".content_key") for c in calls):
                return []
            return [Finding(
                "cache-keys", "work-key-uses-content-key",
                f"{rel}:{node.lineno}",
                "compile_request builds work_key without "
                "data.content_key() — the stacked-block-tensor cache "
                "would collide across datasets sharing one X (the "
                "block-tensor staleness bug)")]
        return [Finding(
            "cache-keys", "work-key-uses-content-key", rel,
            "compile_request no longer assigns work_key — migrate this "
            "check to wherever the provenance key is now built")]
    return [Finding(
        "cache-keys", "work-key-uses-content-key", rel,
        "compile_request not found in core/session.py")]


def run(root: Optional[Path] = None) -> List[Finding]:
    root = root or astutil.default_root()
    findings: List[Finding] = []
    registered: Dict[str, Tuple[str, str]] = {}

    for path in astutil.iter_py_files(root):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("analysis/"):
            continue                    # the auditor itself holds no caches
        tree = astutil.parse(path)

        decorated_quals: Set[str] = set()
        for qual, fn in astutil.iter_functions(tree):
            dec = astutil.decorator_call(fn, "warm_cache")
            if dec is None:
                continue
            decorated_quals.add(qual)
            try:
                kwargs = astutil.literal_kwargs(dec)
            except ValueError as e:
                findings.append(Finding(
                    "cache-keys", "non-literal-contract",
                    f"{rel}:{fn.lineno}", f"{qual}: {e}"))
                continue
            name = kwargs.get("name")
            if not isinstance(name, str):
                findings.append(Finding(
                    "cache-keys", "non-literal-contract",
                    f"{rel}:{fn.lineno}",
                    f"{qual}: @warm_cache needs a literal name="))
                continue
            if name in registered:
                findings.append(Finding(
                    "cache-keys", "duplicate-cache-name",
                    f"{rel}:{fn.lineno}",
                    f"cache {name!r} already registered at "
                    f"{registered[name][0]} ({registered[name][1]})"))
            registered[name] = (rel, qual)
            findings.extend(_check_contract(rel, qual, fn, kwargs))
            if name.startswith("persistent_program_cache"):
                key = tuple(kwargs.get("key", ()))
                missing = [c for c in PERSIST_KEY_COMPONENTS
                           if c not in key]
                if missing:
                    findings.append(Finding(
                        "cache-keys", "persist-key-components",
                        f"{rel}:{fn.lineno}",
                        f"{qual}: persistent (cross-process) cache key "
                        f"is missing {missing} — a shared cache dir "
                        "would serve executables across jax builds, "
                        "backend platforms, or program shapes"))

        # every bounded_put insertion must sit inside a registered cache
        for qual, lineno, callee in astutil.module_calls(tree):
            if callee.rsplit(".", 1)[-1] != "bounded_put":
                continue
            outer = qual.split(".<locals>", 1)[0]
            if qual not in decorated_quals and outer not in \
                    decorated_quals:
                findings.append(Finding(
                    "cache-keys", "unregistered-bounded-put",
                    f"{rel}:{lineno}",
                    f"{qual} inserts into a bounded cache without a "
                    "@warm_cache contract"))

        if rel == "core/spec.py":
            findings.extend(_check_content_key(tree, rel))
        if rel == "core/session.py":
            findings.extend(_check_work_key(tree, rel))

    for name in EXPECTED_CACHES:
        if name not in registered:
            findings.append(Finding(
                "cache-keys", "missing-cache", name,
                "expected warm cache is not registered with "
                "@warm_cache — if it was removed, update "
                "EXPECTED_CACHES; if renamed, keep the registry name "
                "stable"))
    return findings

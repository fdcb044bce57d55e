"""The port's invariant auditor (``repro_torch.analysis``): clean on the
port's own tree, each seeded mutation caught, the copied passes giving
the JAX package's findings on the same inputs, and the empirical checks
that stand in for the reference's jaxpr audit.

The static passes are pure-AST: mutations are applied textually to a
copy of ``src/repro_torch`` in tmp_path, so nothing broken is ever
imported.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.analysis.astutil as jastutil
import repro.analysis.cache_keys as jcache_keys
import repro.analysis.deadcode as jdeadcode

from repro_torch.analysis import astutil, cache_keys, deadcode, empirical
from repro_torch.compile import program
from repro_torch.learners import kernel_ridge, mlp
from repro_torch.sharding import gram

SRC = Path(__file__).resolve().parent.parent / "src"


def _mutated_tree(tmp_path, rel, old, new):
    tmp = tmp_path / "repro_torch"
    shutil.copytree(astutil.default_root(), tmp)
    src = (tmp / rel).read_text()
    assert old in src, f"mutation anchor missing from {rel}"
    (tmp / rel).write_text(src.replace(old, new))
    return tmp


def _reference_findings(root, monkeypatch):
    """The JAX package's cache-key pass on ``root`` with the port's list
    of expected caches (the one table the two passes differ in)."""
    monkeypatch.setattr(jcache_keys, "EXPECTED_CACHES",
                        cache_keys.EXPECTED_CACHES)
    return jcache_keys.run(root)


def _rules_at(findings):
    return sorted((f.passname, f.rule, f.where) for f in findings)


# ---------------------------------------------------------------------------
# green: the port's tree is clean, and the CLI says so
# ---------------------------------------------------------------------------
def test_static_passes_clean_on_the_port():
    assert cache_keys.run() == []
    assert deadcode.run() == []


def test_cli_exits_zero_on_the_port():
    for args in ([], ["--dead-code"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            env=dict(os.environ, PYTHONPATH=str(SRC)),
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "finding" not in out.stdout


def test_expected_caches_are_the_references_but_one():
    """The reference's 13 names, the sharded-fused form
    (``sharded_fused_program_cache``) the last to come over.  The
    persistent key's components are the reference's."""
    assert set(jcache_keys.EXPECTED_CACHES) == set(
        cache_keys.EXPECTED_CACHES)
    assert "sharded_fused_program_cache" in cache_keys.EXPECTED_CACHES
    assert len(cache_keys.EXPECTED_CACHES) == 13
    assert cache_keys.PERSIST_KEY_COMPONENTS == \
        jcache_keys.PERSIST_KEY_COMPONENTS


def test_registry_covers_expected_caches():
    from repro_torch.analysis import REGISTRY
    import repro_torch.compile.persist  # noqa: F401  (decorators register
    import repro_torch.serverless.backends  # noqa: F401  on import)
    import repro_torch.sharding.gram  # noqa: F401
    assert set(cache_keys.EXPECTED_CACHES) <= set(REGISTRY)


# ---------------------------------------------------------------------------
# exact tier: the copies against the originals
# ---------------------------------------------------------------------------
def test_astutil_helpers_give_the_references_results():
    """Every helper, on every file of the port: the same output as the
    JAX package's ``astutil`` (which imports no JAX)."""
    root = astutil.default_root()
    assert list(astutil.iter_py_files(root)) == \
        list(jastutil.iter_py_files(root))
    for path in astutil.iter_py_files(root):
        tree = astutil.parse(path)
        mod = "repro_torch." + path.relative_to(root).with_suffix(
            "").as_posix().replace("/", ".")
        assert astutil.imports_of(tree, mod) == \
            jastutil.imports_of(tree, mod)
        assert astutil.module_calls(tree) == jastutil.module_calls(tree)
        for qual, fn in astutil.iter_functions(tree):
            params = astutil.func_params(fn)
            assert params == jastutil.func_params(fn)
            assert astutil.attribute_reads(fn, set(params)) == \
                jastutil.attribute_reads(fn, set(params)), qual
            dec = astutil.decorator_call(fn, "warm_cache")
            assert (dec is None) == \
                (jastutil.decorator_call(fn, "warm_cache") is None)
            if dec is not None:
                assert astutil.literal_kwargs(dec) == \
                    jastutil.literal_kwargs(dec)


def test_copied_passes_match_the_reference_line_for_line():
    """cache_keys and deadcode are the reference's functions: every
    function shared by name is the same AST but for its strings (the
    docstrings, messages and package names that name the port); only
    deadcode's roots differ, rooted at the port's entry points."""
    class Unstrung(ast.NodeTransformer):
        def visit_Constant(self, node):
            return ast.Constant("") if isinstance(node.value, str) else node

    def bodies(path, skip):
        tree = Unstrung().visit(ast.parse(Path(path).read_text()))
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name not in skip}
    for mod, jmod, skip in (
            (cache_keys, jcache_keys, set()),
            (deadcode, jdeadcode, {"_entry_points", "_external_roots"})):
        assert bodies(mod.__file__, skip) == bodies(jmod.__file__, skip)


@pytest.mark.parametrize("mutation", [
    "clean", "role-drop", "key-drop", "undeclared-put", "persist-build",
    "persist-platform", "persist-fingerprint"])
def test_cache_pass_findings_equal_the_references(tmp_path, monkeypatch,
                                                  mutation):
    """On the port's tree, clean and under each seeded mutation, the
    port's pass reports the rules and places the reference's pass
    reports on the same tree."""
    root = {"clean": lambda: astutil.default_root(),
            **{m: lambda m=m: _mutated_tree(tmp_path, *MUTATIONS[m])
               for m in MUTATIONS}}[mutation]()
    got = cache_keys.run(root)
    assert _rules_at(got) == _rules_at(_reference_findings(root,
                                                           monkeypatch))
    assert bool(got) == (mutation != "clean")


def test_deadcode_findings_equal_the_references_on_one_tree(tmp_path):
    """A tree of four modules, one imported by no entry point: the port's
    report and the reference's name the same orphan."""
    for pkg, entry in (("repro_torch", "tests/test_torch_x.py"),
                       ("repro", "tests/test_x.py")):
        src = tmp_path / pkg / "src" / pkg
        src.mkdir(parents=True)
        (src / "__init__.py").write_text("")
        (src / "a.py").write_text(f"from {pkg} import b\n")
        (src / "b.py").write_text("X = 1\n")
        (src / "orphan.py").write_text(f"import {pkg}.b\n")
        test = tmp_path / pkg / entry
        test.parent.mkdir()
        test.write_text(f"from {pkg}.a import b\n")
    got = deadcode.run(tmp_path / "repro_torch" / "src" / "repro_torch")
    want = jdeadcode.run(tmp_path / "repro" / "src" / "repro")
    assert [(f.rule, f.where) for f in got] == \
        [("unreachable-module", "repro_torch.orphan")]
    assert [(f.rule, f.where.replace("repro", "repro_torch"))
            for f in want] == [(f.rule, f.where) for f in got]


def test_deadcode_roots_are_the_ports_entry_points():
    """Every module a port test, chip_smoke.py, a script or an example
    twin imports is a root; a module only the JAX package's tests
    import is not."""
    repo = SRC.parent
    entries = {p.relative_to(repo).as_posix()
               for p in deadcode._entry_points(repo)}
    assert "chip_smoke.py" in entries
    assert "examples/quickstart_torch.py" in entries
    assert "tests/test_torch_analysis.py" in entries
    assert "tests/test_analysis.py" not in entries
    assert "examples/quickstart.py" not in entries


# ---------------------------------------------------------------------------
# red: the cache-key pass against seeded staleness mutations
# ---------------------------------------------------------------------------
MUTATIONS = {
    # DMLData.content_key fingerprints only two of its roles
    "role-drop": ("core/spec.py", "for r in _ROLES if",
                  "for r in _ROLES[:2] if"),
    # the block-tensor contract loses work_key
    "key-drop": ("compile/program.py",
                 'key=("req.work_key", "seg_idx", "blk.members", '
                 '"blk.b_pad",',
                 'key=("seg_idx", "blk.members", "blk.b_pad",'),
    # a bounded cache insert without a @warm_cache contract
    "undeclared-put": ("serverless/backends.py",
                       '@warm_cache(name="fold_in_key_tables",\n'
                       '            key=("base_key", "n_tasks", "key_ref"))\n',
                       ""),
    **{f"persist-{c}": (
        "compile/persist.py",
        '    @warm_cache(name="persistent_program_cache",\n'
        '                key=("build", "platform", "fingerprint"),',
        '    @warm_cache(name="persistent_program_cache",\n'
        '                key=' + repr(tuple(
            k for k in ("build", "platform", "fingerprint") if k != c))
        + ',') for c in ("build", "platform", "fingerprint")},
}


def test_content_key_role_drop_fails_cache_pass(tmp_path):
    tmp = _mutated_tree(tmp_path, *MUTATIONS["role-drop"])
    assert "content-key-covers-roles" in {f.rule for f in
                                          cache_keys.run(tmp)}


def test_key_component_drop_fails_cache_pass(tmp_path):
    tmp = _mutated_tree(tmp_path, *MUTATIONS["key-drop"])
    rules = {f.rule for f in cache_keys.run(tmp) if "program" in f.where}
    assert rules & {"cover-not-a-key", "uncovered-read",
                    "unkeyed-parameter"}


def test_undeclared_bounded_put_fails_cache_pass(tmp_path):
    tmp = _mutated_tree(tmp_path, *MUTATIONS["undeclared-put"])
    rules = {f.rule for f in cache_keys.run(tmp)}
    assert {"unregistered-bounded-put", "missing-cache"} <= rules


@pytest.mark.parametrize("component", ["build", "platform", "fingerprint"])
def test_persistent_key_losing_a_component_fails_cache_pass(tmp_path,
                                                            component):
    """The store's key must pin the toolkit, the target and the library's
    source and flags: dropping one is a finding on the lookup."""
    tmp = _mutated_tree(tmp_path, *MUTATIONS[f"persist-{component}"])
    found = [f for f in cache_keys.run(tmp)
             if f.rule == "persist-key-components"]
    assert len(found) == 1 and found[0].where.startswith(
        "compile/persist.py:")
    assert repr([component]) in found[0].detail


# ---------------------------------------------------------------------------
# the empirical checks for the reference's jaxpr claims: clean, and each
# one red on a seeded violation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("check", sorted(empirical.CHECKS))
def test_empirical_check_holds_on_the_port(check):
    assert empirical.CHECKS[check]() == []


def test_fused_check_catches_a_family_that_changes_bits(monkeypatch):
    """ridge with a term that depends on the batch count: its lanes
    change bits in a call of another size, so both forms are caught."""
    def thunk(family):
        fn = empirical.get_batched_learner(family, empirical.PARAMS[family])
        return lambda: (lambda xs, *a: fn(xs, *a) + 1e-3 * xs.shape[0])
    monkeypatch.setattr(empirical, "_thunk", thunk)
    found = empirical.check_fused_equals_single_block()
    assert {(f.rule, f.where) for f in found} >= {
        ("fused-equals-single-block", "ridge"),
        ("morph-b-invariance", "ridge")}


def test_prng_check_catches_a_data_derived_key(monkeypatch):
    """Keys mixed with a sum of the features: the two datasets draw other
    landmarks and other initial weights."""
    def salted(keys, x):
        salt = (x.abs().sum(dim=(-2, -1)) * 1e3).to(torch.int64) % (1 << 31)
        return keys + salt.reshape(salt.shape + (1,))

    nystrom, train = kernel_ridge.nystrom_features, mlp._train
    monkeypatch.setattr(kernel_ridge, "nystrom_features",
                        lambda x, keys, **kw: nystrom(x, salted(keys, x),
                                                      **kw))
    monkeypatch.setattr(mlp, "_train",
                        lambda xs, y, w, keys, *a: train(
                            xs, y, w, salted(keys, xs), *a))
    found = empirical.check_no_data_derived_prng()
    assert {(f.rule, f.where) for f in found} == {
        ("prng-key-from-runtime-data", "kernel_ridge"),
        ("prng-key-from-runtime-data", "mlp")}


def test_morph_class_check_catches_overlap_and_strays(monkeypatch):
    monkeypatch.setattr(empirical, "MORPH_TOLERANCE_FAMILIES",
                        frozenset({"logistic", "ridge", "forest"}))
    monkeypatch.setattr(empirical, "FUSED_CONCAT_FAMILIES",
                        frozenset({"ols", "ridge", "mlp"}))
    found = {(f.rule, f.where, f.detail.split()[0])
             for f in empirical.check_morph_classes()}
    assert {w for _, w, _ in found} == {"forest", "ridge", "mlp"}


def test_shape_check_catches_a_data_dependent_shape(monkeypatch):
    def thunk(family):
        fn = empirical.get_batched_learner(family, empirical.PARAMS[family])
        return lambda: (lambda xs, y, w, valid, kd: fn(
            xs, y, w, valid, kd)[:1 + int(w.sum()) % 7])
    monkeypatch.setattr(empirical, "_thunk", thunk)
    found = empirical.check_no_data_dependent_shapes()
    assert {f.where for f in found} == set(empirical.FAMILIES)


def test_axis_check_catches_a_lost_row_block(monkeypatch):
    monkeypatch.setattr(gram, "data_parallel_gram", lambda mesh, xs, w, y: (
        torch.einsum("bnp,bn,bnq->bpq", xs[:, :20], w[:, :20], xs[:, :20]),
        torch.einsum("bn,bnp->bp", (w * y)[:, :20], xs[:, :20])))
    found = empirical.check_axis_reassembly()
    # caught on each mesh the check runs: one device and 4 shards
    assert [(f.rule, f.where) for f in found] == [
        ("data-axis-sums-moments", "sharding/gram.py")] * 2

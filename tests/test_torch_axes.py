"""The port's logical-axis rules (``repro_torch.sharding.axes``), the spec
trees of ``models/param.py`` and the trees ``build_model`` declares on a
mesh, against the JAX package's, exactly, on the CPU.

The reference's ``resolve`` returns a ``PartitionSpec``; the port's a
plain tuple of the same entries, so the two are compared as tuples.  Its
``sharding_tree`` and ``build_model`` read only the mesh's axis sizes, so
the reference gets a ``jax.sharding.AbstractMesh`` of the port's dims (no
devices needed) and the port a simulated mesh of the CPU.  Every
architecture is declared at full width: on a (1, 16) mesh the rules that
shard heads pad qwen2.5-32b's 40 query heads to 48 and yi-34b's 56 to 64,
and qwen2-moe's 60 experts are padded to 64.
"""
import jax
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh

from repro import runtime as jax_runtime
from repro.configs import ARCH_NAMES
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import param as JP
from repro.sharding import axes as JA
from repro_torch import runtime
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.models import build_model
from repro_torch.models import param as P
from repro_torch.models.param import tree_paths
from repro_torch.sharding import axes as A

TABLES = ("MEGATRON_FSDP", "SMALL_DP", "SMALL_SEQ")
MESHES = ((1, 4), (4, 2))
AXES = ("data", "model")
# logical tuples of one to three dims, each name of the tables and None
_NAMES = sorted(A.MEGATRON_FSDP.to_dict()) + [None]
LOGICAL = [(n,) for n in _NAMES] + [
    ("batch", "kv_seq"), ("batch", "seq", "act_embed"),
    ("batch", "seq_shard", "act_heads"), ("embed", "vocab"),
    ("vocab", "embed_tp"), ("layers", "experts", "embed_tp", None,
                            "expert_ff"),
    ("layers", "embed", "heads"), ("heads", "kv_heads"), ("ff", "act_ff"),
    ("batch", "batch"), (None, "kv_seq", "kv_seq")]
SHAPES = (128, 1, 6, 32768, 60, 64)
SIZES = ({"data": 4, "model": 2}, {"data": 1, "model": 4},
         {"pod": 2, "data": 2, "model": 4}, {"data": 16, "model": 16})


def _jax_tuple(spec):
    return tuple(spec)


def _shape(logical, k):
    return tuple(SHAPES[(k + i) % len(SHAPES)] for i in range(len(logical)))


@pytest.fixture
def mesh_axes(request):
    """Both packages' ``runtime.mesh_axes`` set to the parameter, then
    restored."""
    old = (runtime.mesh_axes, jax_runtime.mesh_axes)
    runtime.mesh_axes = jax_runtime.mesh_axes = request.param
    yield request.param
    runtime.mesh_axes, jax_runtime.mesh_axes = old


def test_tables_match_reference():
    for name in TABLES:
        assert getattr(A, name).to_dict() == getattr(JA, name).to_dict()
        assert getattr(A, name).rules == getattr(JA, name).rules
    assert A.DP == JA.DP
    got = A.SMALL_DP.replace(batch=None, kv_seq=("data", "model"))
    want = JA.SMALL_DP.replace(batch=None, kv_seq=("data", "model"))
    assert got.rules == want.rules


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("mesh_axes", [None, ("data", "model"), ("model",)],
                         indirect=True)
def test_resolve_matches_reference(table, mesh_axes):
    """Every logical name alone and in tuples, without a shape, and
    divisibility-aware over shapes and mesh sizes, under the
    ``runtime.mesh_axes`` filter."""
    port, ref = getattr(A, table), getattr(JA, table)
    for k, logical in enumerate(LOGICAL):
        assert port.resolve(logical) == _jax_tuple(ref.resolve(logical)), \
            logical
        for j, sizes in enumerate(SIZES):
            shape = _shape(logical, k + j)
            got = port.resolve(logical, shape=shape, mesh_sizes=sizes)
            want = ref.resolve(logical, shape=shape, mesh_sizes=sizes)
            assert got == _jax_tuple(want), (logical, shape, sizes)
            assert isinstance(got, tuple)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_for_matches_reference(arch):
    d = get_arch(arch).d_model
    for kind in ("train", "prefill", "decode"):
        for batch in (0, 1, 128):
            got = A.rules_for(arch, kind, d, batch)
            want = JA.rules_for(arch, kind, d, batch)
            assert got.rules == want.rules, (kind, batch)


def _port_specs(tree):
    return dict(tree_paths(tree))


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (jax.sharding.PartitionSpec,
                                               jax.sharding.NamedSharding)))
    out = {}
    for path, leaf in flat:
        spec = leaf.spec if isinstance(leaf, jax.sharding.NamedSharding) \
            else leaf
        out[tuple(k.key for k in path)] = _jax_tuple(spec)
    return out


def _bundles(arch, dims=None):
    jc, pc = jax_get_arch(arch), get_arch(arch)
    rules = JA.rules_for(arch, "train", jc.d_model)
    jmesh = None if dims is None else AbstractMesh(dims, AXES)
    pmesh = None if dims is None else make_sim_mesh(dims, "cpu")
    jb = jax_build_model(jc, rules, mesh=jmesh, remat="none")
    pb = build_model(pc, A.rules_for(arch, "train", pc.d_model), mesh=pmesh)
    return jb, pb, jmesh, pmesh, rules


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_tree_matches_reference(arch):
    jb, pb, _, _, rules = _bundles(arch)
    prules = A.rules_for(arch, "train", pb.arch.d_model)
    assert _port_specs(P.spec_tree(pb.decls, prules)) == \
        _jax_specs(JP.spec_tree(jb.decls, rules))


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("dims", MESHES)
def test_sharding_tree_matches_reference(arch, dims):
    """Each leaf's spec on the mesh, divisibility-aware, as the
    reference's ``NamedSharding`` tree holds it."""
    jb, pb, jmesh, pmesh, rules = _bundles(arch, dims)
    prules = A.rules_for(arch, "train", pb.arch.d_model)
    assert _port_specs(P.sharding_tree(pb.decls, pmesh, prules)) == \
        _jax_specs(JP.sharding_tree(jb.decls, jmesh, rules))


def _decls(tree, port):
    if port:
        return {path: (tuple(d.shape), d.logical)
                for path, d in tree_paths(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree,
                                                   is_leaf=JP.is_decl)
    return {tuple(k.key for k in path): (tuple(d.shape), tuple(d.logical))
            for path, d in flat}


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("dims", MESHES + ((1, 16),))
def test_build_model_declares_reference_trees(arch, dims):
    """Shapes and logical axes of every leaf on the mesh, with the
    reference's padded query heads and padded experts."""
    jb, pb, _, _, _ = _bundles(arch, dims)
    assert _decls(pb.decls, True) == _decls(jb.decls, False)
    assert pb.arch.attention.n_heads == jb.arch.attention.n_heads
    if dims == (1, 16):
        padded = {"qwen2.5-32b": 48, "yi-34b": 64}
        if arch in padded:
            assert pb.arch.attention.n_heads == padded[arch]
        if arch == "qwen2-moe-a2.7b":
            assert pb.decls["layers"]["moe"]["wi"].shape[1] == 64

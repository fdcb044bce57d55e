"""Expert parallelism of the port's MoE layer (``repro_torch.models.moe``:
``_moe_a2a``, ``_moe_dense_ep``, chosen by ``moe_forward``) and the
collectives it runs on (``sharding/collectives.py``: ``mesh_all_to_all``,
``mesh_sum`` and ``mesh_mean`` over one axis, the spec form of
``shard_map``), against the JAX package on the CPU.

The port runs on a simulated mesh (the CPU repeated).  The reference runs
once, in a subprocess, on 16 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=16`` set before JAX
is imported; this process's JAX has one device), on sub-meshes of the
same dims, and hands back numpy arrays: its ``moe_forward`` on the
reduced deepseek-v2-lite and qwen2-moe (8 routed experts top-2) on (1, 4)
and (2, 2) meshes, its parameters (drawn from a JAX key, float32), and
its collectives on a (2, 2) mesh.  Inputs come from numpy with a seed,
every token sharing one random direction so that the routing is skewed.

Cases: the a2a path at 128 tokens a shard; the a2a path at 600 tokens a
shard, where the per-shard capacity (``_capacity`` of the local pool)
drops rows; S 151, which no expert axis divides, so the prefill takes
dense_ep; decode (S 1, dense_ep); a batch of 1 on the (2, 2) mesh (the
data axes dropped); qwen2-moe on a (1, 16) mesh, its 8 experts padded to
16.  Tiers: the float tier, 1e-4 of the reference's largest magnitude
for the outputs and 1e-4 relative for the aux loss; the collectives and
the layouts exactly; the a2a output against the concatenation of
``_moe_local`` over each shard's tokens within 1e-6 of its largest
magnitude (the expert products take other row counts).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro_torch import runtime
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.models import moe as M
from repro_torch.models import params_from_numpy
from repro_torch.models.param import shard_params, tree_map
from repro_torch.sharding import axes as A
from repro_torch.sharding.collectives import (
    ShardedLeaf, join_spec, mesh_all_to_all, mesh_mean, mesh_sum,
    split_spec,
)

SRC = Path(__file__).resolve().parent.parent / "src"
TIER = 1e-4
ARCHS = ("deepseek-v2-lite-16b", "qwen2-moe-a2.7b")
MESHES = ((1, 4), (2, 2))
# (b, s): a2a; a2a past 256 tokens a shard; dense_ep at a prefill; decode
SHAPES = ((4, 128), (2, 1200), (2, 151), (4, 1))
CASES = [(arch, dims, b, s) for arch in ARCHS for dims in MESHES
         for b, s in SHAPES] + [(arch, (2, 2), 1, 512) for arch in ARCHS]
EP16 = ((2, 128), (2, 1))

_REFERENCE = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=16 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_arch
from repro.models import init_tree
from repro.models import moe as JM
from repro.sharding.axes import rules_for
from repro.sharding.compat import shard_map_compat
assert jax.device_count() == 16
CASES = {cases!r}
EP16 = {ep16!r}


def mesh(dims):
    n = dims[0] * dims[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(dims), ("data", "model"))


def x_of(b, s, d):
    rng = np.random.default_rng(b * 1000 + s)
    z = rng.standard_normal((b, s, d), dtype=np.float32)
    return z + rng.standard_normal(d, dtype=np.float32)


def params(cfg, ep):
    p = init_tree(JM.moe_decls(cfg, ep), jax.random.key(3))
    return jax.tree.map(lambda a: a.astype(jnp.float32), p)


def run(arch, dims, b, s, p):
    cfg = get_arch(arch, reduced=True)
    rules = rules_for(cfg.name, "train", cfg.d_model)
    m = mesh(dims)
    fn = jax.jit(lambda p, x: JM.moe_forward(p, cfg, x, rules, mesh=m,
                                             ep_axis="model"))
    y, aux = fn(p, x_of(b, s, cfg.d_model))
    return np.asarray(y), float(aux)


out = {{}}
for arch in {archs!r}:
    p = params(get_arch(arch, reduced=True), 4)
    out[("params", arch, 4)] = jax.tree.map(np.asarray, p)
    for case in CASES:
        if case[0] == arch:
            out[case] = run(*case, p)
p = params(get_arch("qwen2-moe-a2.7b", reduced=True), 16)
out[("params", "qwen2-moe-a2.7b", 16)] = jax.tree.map(np.asarray, p)
for b, s in EP16:
    out[("qwen2-moe-a2.7b", (1, 16), b, s)] = run("qwen2-moe-a2.7b", (1, 16),
                                                  b, s, p)

# collectives over "model" on a (2, 2) mesh, each shard a (1, 2, 3, 5)
# block holding one chunk for each peer
x = np.arange(4 * 2 * 3 * 5, dtype=np.float32).reshape(4, 2, 3, 5)


def block(xb):
    xb = xb[0]
    a2a = jax.lax.all_to_all(xb, "model", 0, 0, tiled=False)
    s = jax.lax.psum(xb * (1.0 + jax.lax.axis_index("data")), "model")
    mn = jax.lax.pmean(xb + jax.lax.axis_index("model"), "model")
    return a2a[None], s[None], mn[None]


fn = shard_map_compat(block, mesh=mesh((2, 2)),
                      in_specs=(P(("data", "model")),),
                      out_specs=(P(("data", "model")),) * 3)
out["collectives"] = (x, [np.asarray(t) for t in fn(x)])
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's runs on 16 forced host devices."""
    path = tmp_path_factory.mktemp("moe_ep_reference") / "reference.pkl"
    code = _REFERENCE.format(cases=CASES, ep16=EP16, archs=ARCHS)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _x(b, s, d):
    """Activations with a direction shared by every token, so that the
    routing is skewed and full experts drop rows."""
    rng = np.random.default_rng(b * 1000 + s)
    z = rng.standard_normal((b, s, d), dtype=np.float32)
    return torch.from_numpy(z + rng.standard_normal(d, dtype=np.float32))


def _params(reference, arch, ep):
    return params_from_numpy(reference[("params", arch, ep)], "cpu")


class _Dispatches:
    """Every ``_capacity_dispatch`` of the EP paths: (pool, cap, rows
    kept, rows)."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = M._capacity_dispatch

        def record(x_flat, top_w, top_e, e_pad, cap):
            out = real(x_flat, top_w, top_e, e_pad, cap)
            self.seen.append((x_flat.shape[0], cap, int(out[-1].sum()),
                              out[-1].numel()))
            return out
        monkeypatch.setattr(M, "_capacity_dispatch", record)


def _path(mesh, b, s):
    """The reference's rule: a2a when S splits over the expert axis and
    the batch holds 256 tokens."""
    ep = mesh.shape["model"]
    return "a2a" if s % ep == 0 and b * s >= 256 else "dense_ep"


# ---------------------------------------------------------------------------
# the layer against the reference's on the same mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dims,b,s", CASES)
def test_moe_forward_matches_reference(reference, monkeypatch, arch, dims,
                                       b, s):
    """Outputs and the aux loss at the float tier; the path the
    reference's rule picks, with its collectives counted; past 256 tokens
    a shard the per-shard capacity drops rows."""
    cfg = get_arch(arch, reduced=True)
    mesh = make_sim_mesh(dims, "cpu")
    want, jaux = reference[(arch, dims, b, s)]
    seen = _Dispatches(monkeypatch).seen
    runtime.reset_launch_counts()
    with torch.inference_mode():
        got, aux = M.moe_forward(_params(reference, arch, 4), cfg,
                                 _x(b, s, cfg.d_model), mesh=mesh,
                                 ep_axis="model")
    assert _rel(got.numpy(), want) < TIER
    assert abs(float(aux) - jaux) <= TIER * abs(jaux)
    counts = runtime.launch_counts
    if _path(mesh, b, s) == "a2a":
        assert (counts["mesh_all_to_all"], counts["mesh_sum"]) == (2, 1)
        dp, ep = mesh.shape["data"], mesh.shape["model"]
        pool = (b // dp if b % dp == 0 else b) * s // ep
        assert [p for p, *_ in seen] == [pool] * 4
        dropped = sum(n - kept for _, _, kept, n in seen)
        assert (dropped > 0) == (pool > 256), seen
    else:
        assert (counts["mesh_all_to_all"], counts["mesh_sum"]) == (0, 2)
        assert seen == []


@pytest.mark.parametrize("b,s", EP16)
def test_padded_experts_are_never_selected(reference, monkeypatch, b, s):
    """qwen2-moe on a (1, 16) expert axis: its 8 routed experts padded to
    16, one a shard; no token is routed to a padded expert."""
    cfg = get_arch("qwen2-moe-a2.7b", reduced=True)
    mesh = make_sim_mesh((1, 16), "cpu")
    p = _params(reference, "qwen2-moe-a2.7b", 16)
    assert p["router"].shape[1] == M.padded_experts(cfg.moe, 16) == 16
    picked = []
    real = M._route

    def record(p_, m, x, e_pad):
        out = real(p_, m, x, e_pad)
        picked.append(out[1])
        return out
    monkeypatch.setattr(M, "_route", record)
    want, jaux = reference[("qwen2-moe-a2.7b", (1, 16), b, s)]
    with torch.inference_mode():
        got, aux = M.moe_forward(p, cfg, _x(b, s, cfg.d_model), mesh=mesh,
                                 ep_axis="model")
    assert _rel(got.numpy(), want) < TIER
    assert abs(float(aux) - jaux) <= TIER * abs(jaux)
    assert len(picked) == 16
    assert max(int(t.max()) for t in picked) < cfg.moe.n_routed


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dims,b,s", [((1, 4), 4, 128), ((1, 4), 2, 1200),
                                      ((2, 2), 2, 1200)])
def test_a2a_is_the_local_path_on_each_shard(reference, arch, dims, b, s):
    """The a2a output is ``_moe_local`` on each shard's tokens, put back
    in place (the same routing, capacity and buffer positions), and its
    aux the mean over the expert axis of theirs, shard 0's returned."""
    cfg = get_arch(arch, reduced=True)
    mesh = make_sim_mesh(dims, "cpu")
    p = _params(reference, arch, 4)
    x = _x(b, s, cfg.d_model)
    e_pad = M.padded_experts(cfg.moe, mesh.shape["model"])
    with torch.inference_mode():
        got, aux = M._moe_a2a(p, cfg, x, e_pad, mesh, "model", ("data",))
        spec = (("data",), "model", None)
        local = [M._moe_local(p, cfg, part, e_pad)
                 for part in split_spec(x, spec, mesh)]
        want = join_spec([y for y, _ in local], spec, mesh)
    assert _rel(got.numpy(), want.numpy()) < 1e-6
    ep = mesh.shape["model"]
    first = [a for _, a in local[:ep]]
    assert abs(float(aux) - float(sum(first) / ep)) <= 1e-6 * float(aux)


def test_expert_axis_of_one_is_the_local_path(reference):
    """An expert axis of 1 runs ``_moe_local``, bit for bit the call
    without a mesh."""
    cfg = get_arch("deepseek-v2-lite-16b", reduced=True)
    p = _params(reference, "deepseek-v2-lite-16b", 4)
    x = _x(2, 1200, cfg.d_model)
    runtime.reset_launch_counts()
    with torch.inference_mode():
        a, aux_a = M.moe_forward(p, cfg, x, mesh=make_sim_mesh(4, "cpu"),
                                 ep_axis="model")
        b, aux_b = M.moe_forward(p, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert not any(runtime.launch_counts.values())


def test_placed_experts_are_views_and_serve_the_same(reference):
    """``shard_params`` splits ``wi`` and ``wo`` along "experts" (views of
    the leaf on a simulated mesh, a stacked leaf indexed per layer) and
    leaves every other leaf as it is; the placed layer gives the same
    bits."""
    cfg = get_arch("deepseek-v2-lite-16b", reduced=True)
    mesh = make_sim_mesh((1, 4), "cpu")
    decls = M.moe_decls(cfg, 4)
    p = _params(reference, "deepseek-v2-lite-16b", 4)
    stacked_decls = {"moe": decls}
    placed = shard_params({"moe": p}, stacked_decls, mesh, A.MEGATRON_FSDP)
    wi = placed["moe"]["wi"]
    assert isinstance(wi, ShardedLeaf) and wi.spec[0] == "model"
    assert wi.shape == tuple(p["wi"].shape)
    base = p["wi"].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in wi.parts)
    assert [t.shape[0] for t in wi.parts] == [2] * 4
    assert placed["moe"]["router"] is p["router"]
    x = _x(4, 128, cfg.d_model)
    with torch.inference_mode():
        a, _ = M.moe_forward(placed["moe"], cfg, x, mesh=mesh,
                             ep_axis="model")
        b, _ = M.moe_forward(p, cfg, x, mesh=mesh, ep_axis="model")
    assert torch.equal(a, b)
    # a stacked leaf: one layer's parts are views of that layer
    stacked = tree_map(lambda t: torch.stack([t, 2 * t]), p)
    sdecls = {"layers": tree_map(
        lambda d: type(d)((2,) + d.shape, ("layers",) + d.logical, d.dtype),
        decls)}
    placed = shard_params({"layers": stacked}, sdecls, mesh,
                          A.MEGATRON_FSDP)
    one = placed["layers"]["wo"][1]
    assert one.spec == ("model", None, None)
    assert torch.equal(torch.cat(one.parts), 2 * p["wo"])
    with pytest.raises(ValueError, match="re-shards"):
        split_spec(one, (None, "model", None), mesh)


def test_small_rules_leave_the_experts_whole(reference):
    """Under SMALL_DP "experts" maps to no axis: the leaves stay whole,
    and the EP path slices them itself."""
    cfg = get_arch("deepseek-v2-lite-16b", reduced=True)
    mesh = make_sim_mesh((1, 4), "cpu")
    p = _params(reference, "deepseek-v2-lite-16b", 4)
    placed = shard_params({"moe": p}, {"moe": M.moe_decls(cfg, 4)}, mesh,
                          A.SMALL_DP)
    assert placed["moe"]["wi"] is p["wi"]


# ---------------------------------------------------------------------------
# the collectives against the reference's layouts
# ---------------------------------------------------------------------------
def test_collectives_match_reference(reference):
    """On a (2, 2) mesh: ``mesh_all_to_all`` over "model" is the
    reference's ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``,
    ``mesh_sum`` and ``mesh_mean`` over "model" its ``psum`` and
    ``pmean``, exactly; each counted once."""
    x, (a2a, summed, mean) = reference["collectives"]
    mesh = make_sim_mesh((2, 2), "cpu")
    spec = (("data", "model"), None, None, None)
    parts = split_spec(torch.from_numpy(x), spec, mesh)
    assert [mesh.coords(i) for i in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]
    assert mesh.axis_groups("model") == [(0, 1), (2, 3)]
    assert mesh.axis_groups("data") == [(0, 2), (1, 3)]
    runtime.reset_launch_counts()
    got = mesh_all_to_all([t[0] for t in parts], mesh, "model")
    assert np.array_equal(join_spec([t[None] for t in got], spec,
                                    mesh).numpy(), a2a)
    got = mesh_sum([t[0] * (1.0 + mesh.axis_index(i, "data"))
                    for i, t in enumerate(parts)], mesh, axis="model")
    assert np.array_equal(join_spec([t[None] for t in got], spec,
                                    mesh).numpy(), summed)
    got = mesh_mean([t[0] + mesh.axis_index(i, "model")
                     for i, t in enumerate(parts)], mesh, "model")
    assert np.array_equal(join_spec([t[None] for t in got], spec,
                                    mesh).numpy(), mean)
    assert (runtime.launch_counts["mesh_all_to_all"],
            runtime.launch_counts["mesh_sum"]) == (1, 2)


def test_collectives_over_an_axis_of_one_count_nothing():
    mesh = make_sim_mesh((4, 1), "cpu")
    parts = [torch.full((1, 3), float(i)) for i in range(4)]
    runtime.reset_launch_counts()
    assert mesh_all_to_all(parts, mesh, "model") == parts
    assert mesh_sum(parts, mesh, axis="model") == parts
    assert mesh_mean(parts, mesh, "model") == parts
    assert not any(runtime.launch_counts.values())
    with pytest.raises(ValueError, match="leading dim"):
        mesh_all_to_all([torch.zeros(3, 2)] * 4, make_sim_mesh((1, 4), "cpu"),
                        "model")


@pytest.mark.parametrize("dims", [(1, 4), (2, 2), (4, 1)])
def test_split_and_join_by_spec_are_inverse(dims):
    """``split_spec`` cuts each dim by its axes row-major (views of the
    tensor), ``join_spec`` puts the parts back; a dim no axis names comes
    from shard 0's place."""
    mesh = make_sim_mesh(dims, "cpu")
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    for spec in ((("data",), "model", None), (("data", "model"), None, None),
                 (None, ("model", "data"), None), (None, None, None)):
        parts = split_spec(x, spec, mesh)
        assert len(parts) == 4
        assert all(p.untyped_storage().data_ptr()
                   == x.untyped_storage().data_ptr() for p in parts)
        assert torch.equal(join_spec(parts, spec, mesh), x)
    parts = split_spec(x, (None, "model", None), mesh)
    assert torch.equal(join_spec(parts, (), mesh), parts[0])

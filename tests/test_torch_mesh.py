"""The estimator on a mesh of four shards: the port on a simulated mesh
(the CPU repeated) against the JAX package on four forced host devices.

The reference runs once, in a subprocess, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX is
imported (this process's JAX has one device), and hands back numpy
arrays and plain values.  Both packages price the planner with the
reference's hardware constants and the same pinned launch overhead and
shard tax, so the decisions can be compared exactly.

Tiers: ``CompileStats``, ``PaddingStats``, ``PageStats``, placements and
the planner's decisions exact; predictions at the float tier (rtol 1e-4,
atol 1e-5) and theta and se 1e-4 relative against the reference; data@4
and feature@4 at the reference's axis tier (``AXIS_ATOL`` 5e-4); the
port's four shards against its one device bit for bit for the families
of ``MORPH_BITWISE_FAMILIES``; the collectives exactly the ordered sum
and ``torch.cat``.  Inputs come from the repo's generators with a seed.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.launch.roofline as jroof

import repro_torch.launch.roofline as troof
from repro_torch import runtime
from repro_torch.compile import ProgramCache, dispatch_bucket, plan_buckets
from repro_torch.compile.buckets import AxisDecision
from repro_torch.compile.program import MORPH_BITWISE_FAMILIES
from repro_torch.core import DMLData, DMLPlan, DMLSession
from repro_torch.core.session import compile_request
from repro_torch.data import make_irm_data, make_plr_data
from repro_torch.launch.mesh import (
    DeviceMesh, make_host_mesh, make_sim_host_meshes, make_sim_mesh,
)
from repro_torch.learners import linear
from repro_torch.serverless import PoolConfig, ShardedBackend, make_backend
from repro_torch.serverless.topology import Topology, TopologyBackend
from repro_torch.sharding.collectives import mesh_gather, mesh_sum

SRC = Path(__file__).resolve().parent.parent / "src"
CPU = torch.device("cpu")
AXIS_ATOL = 5e-4        # the reference's axis tier (tests/test_axis_exec.py)
LAUNCH_S = 3e-4         # the pinned launch overhead (the reference's own)
SHARD_FRAC = 0.15       # the pinned shard tax (the reference's fallback)

# family -> (model, learner params); "logistic" is IRM's propensity
FAMILIES = {"ridge": ("plr", {"reg": 1.0}), "ols": ("plr", {}),
            "lasso": ("plr", {"reg": 0.01, "n_iter": 60}),
            "kernel_ridge": ("plr", {"reg": 1.0, "n_landmarks": 32}),
            "logistic": ("irm", {"reg": 1.0})}

_REFERENCE = r"""
import os, sys, pickle, dataclasses
# one thread per device's work: the test shares the machine with others
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
import repro.launch.roofline as jroof
from repro.compile import ProgramCache, plan_buckets
from repro.compile.buckets import AxisDecision
from repro.compile.program import dispatch_bucket
from repro.core import DMLData, DMLPlan, DMLSession
from repro.core.session import compile_request
from repro.data import make_irm_data, make_plr_data
from repro.launch.mesh import make_host_mesh
from repro.serverless import PoolConfig, ShardedBackend
from repro.serverless.topology import Topology, TopologyBackend
assert jax.device_count() == 4
FAMILIES = {families!r}


def pin():
    jroof._MEASURED_LAUNCH_OVERHEAD_S = {launch_s!r}
    jroof._MEASURED_SHARD_OVERHEAD_FRAC = {shard_frac!r}


def data(model, seed):
    if model == "irm":
        return DMLData.from_dict(make_irm_data(n_obs=100, dim_x=5,
                                               seed=seed))
    return DMLData.from_dict(make_plr_data(n_obs=100, dim_x=5, theta=0.5,
                                           seed=seed))


def decision(d):
    return (d.axis, d.shards, d.n_tasks, d.n_pad, d.p_pad, d.mesh_devices,
            d.priced_by, d.executed,
            tuple((a, s, ex) for a, s, _, ex in d.candidate_costs))


def record(sess, rids, results):
    info = sess.last_run_info
    return {{"preds": [np.asarray(sess.request(r).gathered_preds())
                      for r in rids],
            "theta": [r.theta for r in results],
            "se": [r.se for r in results],
            "compile": info.compile.summary(),
            "padding": dataclasses.asdict(info.compile.padding),
            "pages": info.pages.summary(),
            "axis_plans": [decision(d) for d in info.axis_plans]}}


out = {{}}
mesh = make_host_mesh()
for fam, (model, params) in FAMILIES.items():
    plan = DMLPlan.for_model(model, learner="ridge" if fam == "logistic"
                             else fam, learner_params=params, n_folds=3,
                             n_rep=2, seed=5)
    for fused in (True, False):
        pin()
        pool = PoolConfig() if fused else \
            PoolConfig(fuse=False, coalesce=False)
        sess = DMLSession(backend=ShardedBackend(pool, mesh=mesh))
        rids = [sess.submit(plan, data(model, s)) for s in (3, 4, 5)]
        out[(fam, fused)] = record(sess, rids, sess.run())

plan = DMLPlan.for_model("plr", learner="ridge", learner_params={{"reg": 1.0}},
                         n_folds=3, n_rep=2, seed=5)
bplan = plan_buckets([compile_request(plan, data("plr", 3))])
(key,) = bplan.buckets
entries = bplan.pending_by_bucket()[key]
for axis in ("data", "feature"):
    dec = AxisDecision(bucket=key, axis=axis, shards=4,
                       n_tasks=len(entries), n_pad=key.n_pad,
                       p_pad=key.p_pad, mesh_devices=4)
    cache = ProgramCache()
    got = dispatch_bucket(bplan, cache, key, entries, axis_decision=dec,
                          mesh=mesh).harvest()
    out[("axis", axis)] = {{"executed": dec.executed,
                           "preds": {{e: np.asarray(v)
                                     for e, v in got.items()}},
                           "compile": cache.stats.summary()}}

pin()
topo = Topology.simulated(2)
assert [h.n_devices for h in topo.hosts] == [2, 2]
sess = DMLSession(backend=TopologyBackend(PoolConfig(n_hosts=2),
                                          topology=topo))
rids = [sess.submit(plan, data("plr", s)) for s in (3, 4, 5)]
rec = record(sess, rids, sess.run())
rec["placements"] = [(k.n_pad, k.p_pad, h, s)
                     for k, h, s in sess.topology_info.placements]
rec["steals"] = sess.topology_info.steals
out["topology"] = rec
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's runs on four forced host devices."""
    path = tmp_path_factory.mktemp("mesh_reference") / "reference.pkl"
    code = _REFERENCE.format(families=FAMILIES, launch_s=LAUNCH_S,
                             shard_frac=SHARD_FRAC)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:            # bytes this test's child wrote
        return pickle.load(f)


@pytest.fixture
def pinned(monkeypatch):
    """The port priced as the reference is: its hardware constants, the
    pinned launch overhead on the CPU and the pinned shard tax."""
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(troof, "NVLINK_BW", jroof.ICI_BW)
    monkeypatch.setattr(troof, "_MEASURED_LAUNCH_OVERHEAD_S",
                        {CPU: LAUNCH_S})
    monkeypatch.setattr(troof, "_LAST_MEASURED_S", None)
    monkeypatch.setattr(troof, "_MEASURED_SHARD_OVERHEAD_FRAC",
                        {("cpu", "local", m): SHARD_FRAC for m in (1, 2, 4)})
    monkeypatch.setattr(troof, "_LAST_SHARD_OVERHEAD_FRAC", None)


def _data(model, seed):
    if model == "irm":
        return DMLData.from_dict(make_irm_data(n_obs=100, dim_x=5,
                                               seed=seed))
    return DMLData.from_dict(make_plr_data(n_obs=100, dim_x=5, theta=0.5,
                                           seed=seed))


def _plan(family):
    model, params = FAMILIES[family]
    return model, DMLPlan.for_model(
        model, learner="ridge" if family == "logistic" else family,
        learner_params=params, n_folds=3, n_rep=2, seed=5)


def _decision(d):
    return (d.axis, d.shards, d.n_tasks, d.n_pad, d.p_pad, d.mesh_devices,
            d.priced_by, d.executed,
            tuple((a, s, ex) for a, s, _, ex in d.candidate_costs))


def _drain(backend, model, plan, seeds=(3, 4, 5)):
    """Requests of one bucket shape through one session (three: their
    blocks fuse, the morphed tails of two and the third)."""
    sess = DMLSession(backend=backend)
    rids = [sess.submit(plan, _data(model, s)) for s in seeds]
    results = sess.run()
    info = sess.last_run_info
    return sess, {
        "preds": [sess.request(r).gathered_preds() for r in rids],
        "theta": [r.theta for r in results], "se": [r.se for r in results],
        "compile": info.compile.summary(),
        "padding": dataclasses.asdict(info.compile.padding),
        "pages": info.pages.summary(),
        "axis_plans": [_decision(d) for d in info.axis_plans]}


def _pool(fused, family="ridge"):
    """The defaults, or one launch per canonical block.  A family outside
    ``MORPH_BITWISE_FAMILIES`` (logistic) opts into morphing, so that the
    port takes the reference's launch decisions (the reference morphs
    it; tests/test_torch_fusion.py does the same)."""
    if not fused:
        return PoolConfig(fuse=False, coalesce=False)
    if family in MORPH_BITWISE_FAMILIES:
        return PoolConfig()
    return PoolConfig(morph_tolerance=1e-6)


# kernel_ridge with 32 landmarks for 5 features: the measured tier of
# tests/test_torch_kernel_ridge.py for many landmarks for few features
# (Kmm's eigenvalues spread; the two packages' float32 fits part by up to
# 10 float-tier units at one device as on the mesh: ROADMAP Queue 3,
# *Nyström conditioning*); the float tier for every other family
PRED_TIER = {"kernel_ridge": dict(rtol=1e-3, atol=1e-4)}
FLOAT_TIER = dict(rtol=1e-4, atol=1e-5)


def _agrees(got, want, family="ridge"):
    for a, b in zip(got["preds"], want["preds"]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **PRED_TIER.get(family,
                                                         FLOAT_TIER))
    for k in ("theta", "se"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for k in ("compile", "padding", "pages", "axis_plans"):
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# the sharded backend on four shards against the reference's four devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_backend_on_four_shards_matches_reference(
        family, fused, reference, pinned):
    model, plan = _plan(family)
    runtime.reset_launch_counts()
    linear.reset_solve_status()
    backend = ShardedBackend(_pool(fused, family),
                             mesh=make_sim_mesh(4, "cpu"))
    assert backend._b_align() == 4
    _, got = _drain(backend, model, plan)
    _agrees(got, reference[(family, fused)], family)
    assert linear.solve_failures("cpu") == 0
    stats = got["compile"]
    # one gather a program call: the shards' predictions
    assert runtime.launch_counts["mesh_gather"] == stats["launches"] > 0
    assert runtime.launch_counts["mesh_sum"] == 0
    if fused:
        assert stats["fused_launches"] >= 1
        assert any(len(k) == 5 for k in backend.compiler._programs)
    else:
        assert stats["fused_launches"] == 0


@pytest.mark.parametrize("axis", ["data", "feature"])
def test_forced_axis_on_four_shards_matches_reference(axis, reference):
    """A ridge bucket forced on data@4 and on feature@4: the shards'
    moments summed, the rows and column blocks gathered."""
    _, plan = _plan("ridge")
    bplan = plan_buckets([compile_request(plan, _data("plr", 3))])
    (key,) = bplan.buckets
    entries = bplan.pending_by_bucket()[key]
    dec = AxisDecision(bucket=key, axis=axis, shards=4, n_tasks=len(entries),
                       n_pad=key.n_pad, p_pad=key.p_pad, mesh_devices=4)
    cache = ProgramCache()
    runtime.reset_launch_counts()
    got = dispatch_bucket(bplan, cache, key, entries, device=CPU,
                          axis_decision=dec,
                          mesh=make_sim_mesh(4, "cpu")).harvest()
    want = reference[("axis", axis)]
    assert dec.executed == want["executed"] == axis
    assert cache.stats.summary() == want["compile"]
    assert got.keys() == want["preds"].keys()
    task = dispatch_bucket(bplan, ProgramCache(), key, entries,
                           device=CPU).harvest()
    for e in got:
        np.testing.assert_allclose(got[e], want["preds"][e], rtol=0,
                                   atol=AXIS_ATOL)
        np.testing.assert_allclose(got[e], task[e], rtol=0, atol=AXIS_ATOL)
    counts = runtime.launch_counts
    assert (counts["mesh_sum"], counts["mesh_gather"]) == \
        ((3, 1) if axis == "data" else (0, 3))


def test_topology_of_two_hosts_of_two_shards_matches_reference(
        reference, pinned):
    _, plan = _plan("ridge")
    topo = Topology.simulated(2, device="cpu", shards_per_host=2)
    assert [h.n_devices for h in topo.hosts] == [2, 2]
    assert all(h.mesh.collective == "local" for h in topo.hosts)
    sess, got = _drain(TopologyBackend(PoolConfig(n_hosts=2),
                                       topology=topo), "plr", plan)
    want = reference["topology"]
    _agrees(got, want)
    t = sess.topology_info
    assert [(k.n_pad, k.p_pad, h, s) for k, h, s in t.placements] == \
        want["placements"]
    assert t.steals == want["steals"]


# ---------------------------------------------------------------------------
# the port's four shards against its one device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(MORPH_BITWISE_FAMILIES))
def test_four_shards_bit_for_bit_one_device(family):
    model, plan = _plan(family)
    for fused in (True, False):
        _, four = _drain(ShardedBackend(_pool(fused),
                                        mesh=make_sim_mesh(4, "cpu")),
                         model, plan, seeds=(3, 4))
        _, one = _drain(ShardedBackend(_pool(fused), device="cpu"), model,
                        plan, seeds=(3, 4))
        for a, b in zip(four["preds"], one["preds"]):
            assert np.array_equal(a, b)
        assert four["theta"] == one["theta"] and four["se"] == one["se"]


def test_padding_lanes_of_an_odd_shard_count_count_no_failure():
    """Three shards pad B 16 to 18: the padding lanes' Cholesky fails (as
    the reference's does), and ``solve_failures`` counts only the lanes
    with a valid row."""
    model, plan = _plan("ridge")
    linear.reset_solve_status()
    backend = ShardedBackend(_pool(False), mesh=make_sim_mesh(3, "cpu"))
    sess, got = _drain(backend, model, plan)
    assert backend.compiler.stats.padding.padded_tasks == 3 * 18
    assert linear.solve_failures("cpu") == 0
    _, one = _drain(ShardedBackend(_pool(False), device="cpu"), model, plan)
    for a, b in zip(got["preds"], one["preds"]):
        assert np.array_equal(a, b)


def test_topology_hosts_take_their_sharded_cache(monkeypatch, pinned):
    """At a launch overhead of 0.1 us the planner spreads the bucket over
    each host's two shards: it runs through the host's sharded cache (the
    reference's own run of this case stops on a device mismatch, ROADMAP
    Queue 3) and stays bit for bit the inline drain."""
    monkeypatch.setattr(troof, "_MEASURED_LAUNCH_OVERHEAD_S", {CPU: 1e-7})
    _, plan = _plan("ridge")
    topo = Topology.simulated(2, device="cpu", shards_per_host=2)
    backend = TopologyBackend(PoolConfig(n_hosts=2), topology=topo)
    runtime.reset_launch_counts()
    sess, got = _drain(backend, "plr", plan)
    assert [d[:2] for d in got["axis_plans"]] == [("task", 2)]
    assert backend._host_compilers and runtime.launch_counts[
        "mesh_gather"] > 0
    _, inline = _drain(make_backend("inline", _pool(True), device="cpu"),
                       "plr", plan)
    for a, b in zip(got["preds"], inline["preds"]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the collectives and the meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2, 4])
def test_mesh_sum_and_gather_are_the_ordered_sum_and_cat(m):
    mesh = make_sim_mesh(m, "cpu")
    gen = torch.Generator().manual_seed(m)
    parts = [torch.randn(3, 5, generator=gen) for _ in range(m)]
    runtime.reset_launch_counts()
    summed = mesh_sum(parts, mesh)
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert len(summed) == m and all(torch.equal(s, want) for s in summed)
    for dim in (0, 1):
        gathered = mesh_gather(parts, dim, mesh)
        assert len(gathered) == m
        assert all(torch.equal(g, torch.cat(parts, dim)) for g in gathered)
    counted = int(m > 1)
    assert (runtime.launch_counts["mesh_sum"],
            runtime.launch_counts["mesh_gather"]) == (counted, 2 * counted)
    with pytest.raises(ValueError):
        mesh_sum(parts + parts[:1], mesh)


def test_mesh_kinds_and_host_meshes():
    sim = make_sim_mesh(4, "cpu")
    assert sim.shape == {"data": 4, "model": 1}
    assert sim.collective == "local" and sim.device == CPU
    assert sim.shard_devices == (CPU,) * 4
    assert sim == make_sim_mesh(4, CPU) and hash(sim) == hash(
        make_sim_mesh(4, CPU))
    assert sim != make_host_mesh("cpu")
    assert make_host_mesh("cpu").collective == "local"
    hosts = make_sim_host_meshes(3, "cpu", shards_per_host=2)
    assert [h.dims for h in hosts] == [(2, 1)] * 3
    assert all(h.devices == (CPU, CPU) for h in hosts)
    with pytest.raises(ValueError, match="'data' only"):
        DeviceMesh((CPU,) * 4, (2, 2)).shard_devices
    pod = DeviceMesh((CPU,) * 4, (2, 2, 1), ("pod", "data", "model"))
    topo = Topology.from_mesh(pod)
    assert [h.n_devices for h in topo.hosts] == [2, 2]
    with pytest.raises(ValueError, match="sharded backend"):
        make_backend("inline", device="cpu", mesh=sim)
    assert make_backend("sharded", device="cpu", mesh=sim).mesh is sim


def test_shard_overhead_is_measured_on_the_mesh(monkeypatch):
    monkeypatch.setattr(troof, "_MEASURED_SHARD_OVERHEAD_FRAC", {})
    monkeypatch.setattr(troof, "_LAST_SHARD_OVERHEAD_FRAC", None)
    assert troof.shard_overhead_frac() == troof.SHARD_OVERHEAD_FRAC
    mesh = make_sim_mesh(4, "cpu")
    runtime.reset_launch_counts()
    frac = troof.measure_shard_overhead_frac(mesh, repeats=5)
    assert 0.02 <= frac <= 2.0 and troof.shard_overhead_frac() == frac
    assert set(runtime.launch_counts.values()) == {0}
    assert troof.measure_shard_overhead_frac(make_sim_mesh(4, CPU)) == frac
    assert ("cpu", "local", 4) in troof._MEASURED_SHARD_OVERHEAD_FRAC
    DMLSession(backend=ShardedBackend(mesh=mesh))
    assert troof.shard_overhead_frac() == frac

"""The tall-N drain: the axis planner, the in-mesh executors and the
sharded backend of the port against the JAX package's, on one device.

Exact tier (``==`` / ``np.array_equal``) for the chunking arithmetic and
the planner's decisions; ``est_s`` to rtol 1e-12 once the port's hardware
constants are patched to the reference's.  Float tier for what the
data@1 program computes: predictions rtol 1e-4, atol 1e-5 against the
reference's data@1 program (both solve by LU over the same chunked
moments), theta and se 1e-4 relative; against the task path (Cholesky,
one walk over N) the reference's axis tier, atol 5e-4.  The reference's
mesh is built from exactly one device.  Inputs come from numpy with a
seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.compile.buckets as jbuckets
import repro.core as rcore
import repro.launch.roofline as jroof
from repro.compile import plan_buckets as jax_plan_buckets
from repro.compile.program import ProgramCache as JaxProgramCache
from repro.compile.program import dispatch_bucket as jax_dispatch_bucket
from repro.core.session import compile_request as jax_compile_request
from repro.data import make_plr_data
from repro.kernels import ops as jops
from repro.serverless import ShardedBackend as JaxSharded
from repro.sharding import gram as jgram

import repro_torch
import repro_torch.compile.buckets as tbuckets
import repro_torch.core as tcore
import repro_torch.launch.roofline as troof
from repro_torch import runtime
from repro_torch.compile import plan_buckets
from repro_torch.compile.program import ProgramCache, dispatch_bucket
from repro_torch.core.session import compile_request
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
from repro_torch.learners import linear
from repro_torch.serverless import (
    BACKENDS, InlineBackend, ShardedBackend, make_backend,
)
from repro_torch.sharding import gram as tgram

AXIS_ATOL = 5e-4        # the reference's axis tier (tests/test_axis_exec.py)
CPU = torch.device("cpu")
_PARAMS = {"ols": {}, "ridge": {"reg": 1.0},
           "lasso": {"reg": 0.01, "n_iter": 60}}


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _rel(a, b):
    return abs(a - b) / abs(b)


def _plans(learner, n_folds=3, n_rep=2, seed=100):
    kw = dict(learner=learner, learner_params=_PARAMS[learner],
              n_folds=n_folds, n_rep=n_rep, seed=seed, backend="sharded")
    return (tcore.DMLPlan.for_model("plr", **kw),
            rcore.DMLPlan.for_model("plr", **kw))


def _data(n_obs, seed, dim_x=5):
    raw = make_plr_data(n_obs=n_obs, dim_x=dim_x, theta=0.5, seed=seed)
    return tcore.DMLData.from_dict(raw), rcore.DMLData.from_dict(raw)


@pytest.fixture
def tall_pages(monkeypatch):
    """One device page holds 16 rows, in both packages."""
    monkeypatch.setattr(troof, "DEVICE_PAGE_ROWS", 16)
    monkeypatch.setattr(jroof, "DEVICE_PAGE_ROWS", 16)


# ---------------------------------------------------------------------------
# exact tier: chunking
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("page", [16, 64, 1 << 16])
def test_chunk_rows_exact(page):
    for n in (1, 7, 8, 15, 16, 17, 63, 64, 65, 104, 1000, 65536, 65537,
              250000, 262144, 1_000_003):
        assert tgram._chunk_rows(n, page) == jgram._chunk_rows(n, page), n
    assert tgram._chunk_rows(250000, 1 << 16) == 62504


@pytest.mark.parametrize("b,n,p,chunk", [
    (3, 64, 5, 16), (2, 100, 7, 24), (4, 250, 3, 64), (1, 9, 2, 8),
])
def test_chunk_tall_n_exact(b, n, p, chunk):
    rng = np.random.default_rng(b * n + p)
    xs = rng.standard_normal((b, n, p)).astype(np.float32)
    w = (rng.random((b, n)) > 0.3).astype(np.float32)
    y = rng.standard_normal((b, n)).astype(np.float32)
    got = ops.chunk_tall_n(torch.from_numpy(xs), torch.from_numpy(w),
                           torch.from_numpy(y), chunk)
    want = jops.chunk_tall_n(jnp.asarray(xs), jnp.asarray(w),
                             jnp.asarray(y), chunk)
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape and g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(wnt))
    assert got[0].shape[1] == -(-n // chunk)


def test_blocked_gram_families_match_reference():
    assert ops.BLOCKED_GRAM_BITWISE_FAMILIES == \
        jops.BLOCKED_GRAM_BITWISE_FAMILIES
    assert ops.BLOCKED_GRAM_TOLERANCE_FAMILIES == \
        jops.BLOCKED_GRAM_TOLERANCE_FAMILIES
    assert troof.GRAM_FAMILIES == jroof.GRAM_FAMILIES
    assert troof.DEVICE_PAGE_ROWS == jroof.DEVICE_PAGE_ROWS == 1 << 16


# ---------------------------------------------------------------------------
# exact tier: the planner
# ---------------------------------------------------------------------------
FAMILIES = {"ols": {}, "ridge": {"reg": 1.0},
            "lasso": {"reg": 0.01, "n_iter": 200}, "logistic": {"n_iter": 32},
            "kernel_ridge": {"n_landmarks": 64},
            "mlp": {"hidden": (32, 32), "n_steps": 100}}
N_PADS = (8, 1000, 65528, 65536, 65544, 131072, 250000)


def _keys(family, n_pad, p_pad):
    ptuple = tuple(sorted(FAMILIES[family].items()))
    return (tbuckets.BucketKey((family, ptuple), n_pad, p_pad),
            jbuckets.BucketKey((family, ptuple), n_pad, p_pad))


def _sweep(family, n_devices):
    for n_pad in N_PADS:
        for p_pad in (8, 32, 256):
            for n_tasks in (1, 8, 33, 100):
                kt, kj = _keys(family, n_pad, p_pad)
                yield (tbuckets.plan_bucket_axis(kt, n_tasks=n_tasks,
                                                 n_devices=n_devices),
                       jbuckets.plan_bucket_axis(kj, n_tasks=n_tasks,
                                                 n_devices=n_devices))


def _decision_fields(d):
    return (d.axis, d.shards, d.n_tasks, d.n_pad, d.p_pad, d.mesh_devices,
            d.priced_by, d.executed,
            tuple((a, s, ex) for a, s, _, ex in d.candidate_costs))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_bucket_axis_decisions_exact_on_one_device(family):
    """On one device the decision follows from which layouts can run, so
    it is exact whatever the hardware constants."""
    seen = set()
    for dt, dj in _sweep(family, 1):
        assert _decision_fields(dt) == _decision_fields(dj)
        seen.add(dt.axis)
        if family in troof.GRAM_FAMILIES:
            assert (dt.axis == "data") == (dt.n_pad > troof.DEVICE_PAGE_ROWS)
    assert seen == ({"task", "data"} if family in troof.GRAM_FAMILIES
                    else {"task"})


@pytest.fixture
def reference_constants(monkeypatch):
    """The port priced with the reference's hardware and launch model."""
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(troof, "NVLINK_BW", jroof.ICI_BW)
    monkeypatch.setattr(troof, "_LAST_MEASURED_S", None)
    monkeypatch.setattr(jroof, "_MEASURED_LAUNCH_OVERHEAD_S", None)
    monkeypatch.setattr(jroof, "_MEASURED_SHARD_OVERHEAD_FRAC", None)
    assert troof.LAUNCH_OVERHEAD_S == jroof.LAUNCH_OVERHEAD_S
    assert troof.SHARD_OVERHEAD_FRAC == jroof.SHARD_OVERHEAD_FRAC


@pytest.mark.parametrize("n_devices", [1, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_bucket_axis_costs_with_reference_constants(
        family, n_devices, reference_constants):
    for dt, dj in _sweep(family, n_devices):
        assert _decision_fields(dt) == _decision_fields(dj)
        np.testing.assert_allclose(
            [c[2] for c in dt.candidate_costs],
            [c[2] for c in dj.candidate_costs], rtol=1e-12)
        np.testing.assert_allclose(dt.est_s, dj.est_s, rtol=1e-12)


def test_opaque_bucket_is_not_planned():
    key = tbuckets.BucketKey(("opaque", 7), 64, 8)
    assert tbuckets.plan_bucket_axis(key, n_tasks=4, n_devices=1) is None


def test_roofline_pricing_functions_match_reference(reference_constants):
    for family, params in FAMILIES.items():
        for n, p in ((1000, 32), (250000, 33)):
            assert troof.megabatch_task_flops(family, n, p, params) == \
                jroof.megabatch_task_flops(family, n, p, params)
            assert troof.invocation_roofline_s(
                family, params, 10, n, p, amortized_launches=0.5) == \
                jroof.invocation_roofline_s(family, params, 10, n, p,
                                            amortized_launches=0.5)
    assert troof.megabatch_task_bytes(250000, 33) == \
        jroof.megabatch_task_bytes(250000, 33)
    assert troof.chunked_gram_flops(250000, 33, 1 << 16) == \
        jroof.chunked_gram_flops(250000, 33, 1 << 16)


def test_measure_launch_overhead_times_the_given_device(monkeypatch):
    monkeypatch.setattr(troof, "_MEASURED_LAUNCH_OVERHEAD_S", {})
    monkeypatch.setattr(troof, "_LAST_MEASURED_S", None)
    assert troof.launch_overhead_s() == troof.LAUNCH_OVERHEAD_S
    s = troof.measure_launch_overhead_s("cpu", repeats=5)
    assert 1e-5 <= s <= 1e-2
    assert troof.launch_overhead_s() == s
    assert troof.measure_launch_overhead_s(CPU) == s          # memoized
    tcore.DMLSession(backend="sharded", device="cpu")
    assert troof.launch_overhead_s() == s


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_host_mesh_is_one_by_one():
    mesh = make_host_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert mesh.device == CPU
    assert mesh == make_host_mesh(CPU) and hash(mesh) == hash(
        make_host_mesh(CPU))
    assert {mesh: 1}[make_host_mesh("cpu")] == 1


def test_multi_device_mesh_raises():
    with pytest.raises(NotImplementedError, match="NCCL"):
        DeviceMesh(devices=(CPU, CPU), dims=(2, 1))
    with pytest.raises(ValueError):
        DeviceMesh(devices=(CPU,), dims=(1,))


# ---------------------------------------------------------------------------
# float tier: the in-mesh executors
# ---------------------------------------------------------------------------
def _gram_inputs(b, n, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, p)).astype(np.float32),
            (rng.random((b, n)) > 0.3).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


@pytest.mark.parametrize("which", ["data", "feature"])
def test_standalone_parallel_gram_matches_reference(which):
    xs, w, y = _gram_inputs(3, 40, 6, seed=4)
    fn_t = getattr(tgram, f"{which}_parallel_gram")
    fn_j = getattr(jgram, f"{which}_parallel_gram")
    g, b = fn_t(make_host_mesh("cpu"), *map(torch.from_numpy, (xs, w, y)),
                reg=0.5)
    g0, b0 = fn_j(_jax_mesh(), jnp.asarray(xs), jnp.asarray(w),
                  jnp.asarray(y), reg=0.5)
    scale = float(np.abs(np.asarray(g0)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(g0), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(b0), rtol=1e-5,
                               atol=1e-5 * scale)


def test_gram_solve_leaves_singular_lanes_unread():
    g = torch.eye(3).repeat(2, 1, 1)
    g[1, 2, 2] = 0.0                    # a padding lane's intercept
    b = torch.ones(2, 3)
    linear.reset_solve_status()
    beta = tgram.gram_solve(g, b, live=torch.tensor([True, False]))
    assert torch.equal(beta[0], torch.ones(3))
    assert torch.isnan(beta[1]).all()
    assert linear.solve_failures("cpu") == 0
    tgram.gram_solve(g, b)
    assert linear.solve_failures("cpu") > 0
    linear.reset_solve_status()


def _bucket_pair(learner, n_obs, seed):
    """The same single-bucket request on both sides."""
    (dt, dj), (pt, pj) = _data(n_obs, seed), _plans(learner, seed=seed)
    rt, rj = compile_request(pt, dt), jax_compile_request(pj, dj)
    bt, bj = plan_buckets([rt]), jax_plan_buckets([rj])
    (kt,), (kj,) = bt.buckets, bj.buckets
    return (bt, kt, bt.pending_by_bucket()[kt]), \
        (bj, kj, bj.pending_by_bucket()[kj])


def _decisions(kt, kj, axis, n_tasks):
    return (tbuckets.AxisDecision(bucket=kt, axis=axis, shards=1,
                                  n_tasks=n_tasks, n_pad=kt.n_pad,
                                  p_pad=kt.p_pad, mesh_devices=1),
            jbuckets.AxisDecision(bucket=kj, axis=axis, shards=1,
                                  n_tasks=n_tasks, n_pad=kj.n_pad,
                                  p_pad=kj.p_pad, mesh_devices=1))


@pytest.mark.parametrize("learner", ["ols", "ridge", "lasso"])
def test_dispatch_data_decision_matches_reference(learner, tall_pages):
    (bt, kt, et), (bj, kj, ej) = _bucket_pair(learner, 104, seed=3)
    assert kt.n_pad == kj.n_pad == 104 and et == ej
    dt, dj = _decisions(kt, kj, "data", len(et))
    ct, cj = ProgramCache(), JaxProgramCache()
    runtime.reset_launch_counts()
    got = dispatch_bucket(bt, ct, kt, et, device=CPU, axis_decision=dt,
                          mesh=make_host_mesh("cpu")).harvest()
    want = jax_dispatch_bucket(bj, cj, kj, ej, axis_decision=dj,
                               mesh=_jax_mesh()).harvest()
    assert dt.executed == dj.executed == "data"
    assert got.keys() == want.keys()
    for e in want:
        np.testing.assert_allclose(got[e], want[e], rtol=1e-4, atol=1e-5)
    st, sj = ct.stats, cj.stats
    assert (st.launches, st.blocks, st.hits, st.misses) == \
        (sj.launches, sj.blocks, sj.hits, sj.misses)
    assert st.padding.padded_cells == sj.padding.padded_cells
    # the CPU path ran the plain versions
    assert set(runtime.launch_counts.values()) == {0}


def test_dispatch_data_program_is_warm_on_repeat(tall_pages):
    (bt, kt, et), _ = _bucket_pair("ridge", 104, seed=4)
    cache, mesh = ProgramCache(), make_host_mesh("cpu")
    tgram._DATA_GRAM_PROGRAMS.clear()
    outs = []
    for _ in range(2):
        dec, _ = _decisions(kt, kt, "data", len(et))
        outs.append(dispatch_bucket(bt, cache, kt, et, device=CPU,
                                    axis_decision=dec, mesh=mesh).harvest())
    assert (cache.stats.misses, cache.stats.hits) == (1, 1)
    for e in outs[0]:
        assert np.array_equal(outs[0][e], outs[1][e])


@pytest.mark.parametrize("learner", ["ols", "lasso"])
def test_task_decision_or_no_mesh_keeps_the_task_path(learner):
    (bt, kt, et), _ = _bucket_pair(learner, 104, seed=5)
    ref = dispatch_bucket(bt, ProgramCache(), kt, et, device=CPU).harvest()
    for axis, mesh in (("task", make_host_mesh("cpu")), ("data", None)):
        dec, _ = _decisions(kt, kt, axis, len(et))
        got = dispatch_bucket(bt, ProgramCache(), kt, et, device=CPU,
                              axis_decision=dec, mesh=mesh).harvest()
        assert dec.executed == "task"
        for e in ref:
            assert np.array_equal(got[e], ref[e])


# ---------------------------------------------------------------------------
# the sharded backend end to end
# ---------------------------------------------------------------------------
def _sharded_pair(learner, n_obs, seed, n_folds=3, n_rep=2):
    (dt, dj), (pt, pj) = _data(n_obs, seed), \
        _plans(learner, n_folds=n_folds, n_rep=n_rep, seed=seed)
    st = tcore.DMLSession(backend=ShardedBackend(device="cpu"))
    sj = rcore.DMLSession(backend=JaxSharded(mesh=_jax_mesh()))
    rt, rj = st.estimate(pt, dt), sj.estimate(pj, dj)
    return (st, rt), (sj, rj)


@pytest.mark.parametrize("learner", ["ols", "ridge", "lasso"])
def test_sharded_tall_drain_matches_reference(learner, tall_pages):
    runtime.reset_launch_counts()
    linear.reset_solve_status()
    (st, rt), (sj, rj) = _sharded_pair(learner, 104, seed=3)
    got, want = st.request(0).gathered_preds(), sj.request(0).gathered_preds()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
    (dec,) = st.last_run_info.axis_plans
    (dec_j,) = sj.last_run_info.axis_plans
    assert (dec.axis, dec.executed) == (dec_j.axis, dec_j.executed) == \
        ("data", "data")
    assert st.last_run_info.backend == "sharded"
    assert rt.report.bill.n_invocations == rj.report.bill.n_invocations
    assert set(runtime.launch_counts.values()) == {0}
    assert linear.solve_failures("cpu") == 0


def test_tall_bucket_with_a_padding_lane(tall_pages):
    """K 3, M 2, L 2: 12 tasks in a 16-lane launch.  The four padding
    lanes are exactly singular for ridge at reg 1 with an intercept; the
    LU solve leaves them unread instead of raising."""
    (st, rt), (sj, rj) = _sharded_pair("ridge", 120, seed=8)
    req = st.request(0)
    assert req.grid.n_tasks == 12
    assert st.backend.compiler.stats.padding.padded_tasks == 16
    assert np.isfinite(req.gathered_preds()).all()
    assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
    assert st.last_run_info.axis_plans[0].executed == "data"


def test_tall_drain_agrees_with_the_inline_task_path(tall_pages):
    (dt, _), (pt, _) = _data(136, seed=9), _plans("ridge", seed=9)
    sharded = repro_torch.estimate(pt, dt, device="cpu")   # plan: sharded
    si = tcore.DMLSession(backend="inline", device="cpu")
    inline = si.estimate(pt, dt)
    ss = tcore.DMLSession(backend="sharded", device="cpu")
    assert ss.estimate(pt, dt).theta == sharded.theta
    np.testing.assert_allclose(ss.request(0).gathered_preds(),
                               si.request(0).gathered_preds(), rtol=0,
                               atol=AXIS_ATOL)
    assert _rel(sharded.theta, inline.theta) < 1e-4


def test_small_bucket_stays_task_and_bitwise_inline():
    (dt, _), (pt, _) = _data(104, seed=6), _plans("ridge", seed=6)
    ss = tcore.DMLSession(backend="sharded", device="cpu")
    si = tcore.DMLSession(backend="inline", device="cpu")
    rs, ri = ss.estimate(pt, dt), si.estimate(pt, dt)
    assert np.array_equal(ss.request(0).gathered_preds(),
                          si.request(0).gathered_preds())
    assert rs.theta == ri.theta and rs.se == ri.se
    (dec,) = ss.last_run_info.axis_plans
    assert (dec.axis, dec.executed) == ("task", "task")
    assert si.last_run_info.axis_plans == []
    assert ss.backend.compiler.stats.misses == si.backend.compiler.stats.misses


def test_forced_feature_decision_executes(monkeypatch):
    def force_feature(key, *, n_tasks, n_devices):
        return tbuckets.AxisDecision(bucket=key, axis="feature", shards=1,
                                     n_tasks=n_tasks, n_pad=key.n_pad,
                                     p_pad=key.p_pad, mesh_devices=1)

    def force_feature_j(key, *, n_tasks, n_devices):
        return jbuckets.AxisDecision(bucket=key, axis="feature", shards=1,
                                     n_tasks=n_tasks, n_pad=key.n_pad,
                                     p_pad=key.p_pad, mesh_devices=1)

    monkeypatch.setattr(tbuckets, "plan_bucket_axis", force_feature)
    monkeypatch.setattr(jbuckets, "plan_bucket_axis", force_feature_j)
    (st, rt), (sj, rj) = _sharded_pair("ols", 120, seed=5)
    assert st.last_run_info.axis_plans[0].executed == "feature"
    assert sj.last_run_info.axis_plans[0].executed == "feature"
    np.testing.assert_allclose(st.request(0).gathered_preds(),
                               sj.request(0).gathered_preds(), rtol=0,
                               atol=AXIS_ATOL)
    assert _rel(rt.theta, rj.theta) < 1e-4
    inline = tcore.DMLSession(backend="inline", device="cpu")
    inline.estimate(_plans("ols", seed=5)[0], _data(120, seed=5)[0])
    np.testing.assert_allclose(st.request(0).gathered_preds(),
                               inline.request(0).gathered_preds(), rtol=0,
                               atol=AXIS_ATOL)


def test_sharded_backend_device_rule():
    assert BACKENDS["sharded"] is ShardedBackend
    assert isinstance(make_backend("sharded", device="cpu"), ShardedBackend)
    mesh = make_host_mesh("cpu")
    assert ShardedBackend(mesh=mesh).device == CPU
    if torch.cuda.is_available():
        return
    pt, data = _plans("ridge")[0], _data(104, seed=1)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedBackend()
    with pytest.raises(RuntimeError):
        tcore.DMLSession(backend="sharded")
    with pytest.raises(RuntimeError):
        repro_torch.estimate(pt, data, backend="sharded")


@pytest.mark.parametrize("field,value", [("fuse", True),
                                         ("failure_rate", 0.1)])
def test_sharded_backend_refuses_unported_pool_settings(field, value):
    """Nothing is refused any more.  ``fuse``: the sharded drain of a
    task-axis bucket (three full blocks and a tail of 24) fuses, as the
    inline backend does, and equals the per-block drain bit for bit.
    Fault injection runs on the sharded backend and leaves the
    predictions as they are."""
    from repro_torch.serverless import PoolConfig
    if field == "fuse":
        (dt, _), (pt, _) = _data(104, seed=3), _plans("ridge", n_rep=20,
                                                       seed=3)
        per_block = PoolConfig(fuse=False, coalesce=False)
        out = []
        for pool in (per_block, PoolConfig(**{field: value})):
            req = compile_request(pt, dt)
            info = ShardedBackend(pool, device="cpu").run_requests([req])
            out.append((req.gathered_preds(), info.compile))
        assert np.array_equal(out[0][0], out[1][0])
        assert out[0][1].fused_launches == 0 and out[0][1].launches == 4
        assert (out[1][1].launches, out[1][1].fused_launches) == (1, 1)
        return
    (dt, _), (pt, _) = _data(104, seed=3), _plans("ridge", seed=3)
    preds = []
    for pool in (PoolConfig(**{field: value, "max_retries": 10, "seed": 0}),
                 PoolConfig()):
        req = compile_request(pt, dt)
        ShardedBackend(pool, device="cpu").run_requests([req])
        preds.append((req.gathered_preds(), req.report.failures))
    assert np.array_equal(preds[0][0], preds[1][0])
    assert preds[0][1] > 0 and preds[1][1] == 0


def test_axis_plans_are_memoized_per_drain(tall_pages):
    (dt, _), (pt, _) = _data(104, seed=2), _plans("ridge", seed=2)
    backend = ShardedBackend(device="cpu")
    reqs = [compile_request(pt, dt), compile_request(pt, dt)]
    info = backend.run_requests(reqs)
    assert len(info.axis_plans) == 1 and info.buckets == 1
    assert info.axis_plans[0].executed == "data"
    assert all(r.ledger.complete for r in reqs)
    assert np.array_equal(reqs[0].gathered_preds(), reqs[1].gathered_preds())
    assert InlineBackend(device="cpu").run_requests(
        [compile_request(pt, dt)]).axis_plans == []

"""The port's estimator core against the JAX package's.

Exact tier (``np.array_equal``) for everything that is numpy or integer
logic — fold masks, task-grid maps, bucket plans, canonical block layouts,
fingerprints, content keys, ledgers, payloads — and rtol 1e-6 for the
float32 score algebra.  Inputs come from numpy with a seed.
"""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.compile as jc
import repro.core as rcore
import repro.core.aggregation as jagg
import repro.core.crossfit as jcf
import repro.core.scores as jscores
from repro.compile import program as jprogram
from repro.core.session import compile_request as jax_compile_request
from repro.data import make_irm_data, make_pliv_data, make_plr_data
from repro.serverless import InlineBackend as JaxInline
from repro.serverless import PoolConfig as JaxPool
from repro.serverless.backends import fingerprint_array as jax_fingerprint
from repro.serverless.ledger import TaskLedger as JaxLedger

import repro_torch.compile as tc
import repro_torch.core as tcore
import repro_torch.core.aggregation as tagg
import repro_torch.core.crossfit as tcf
import repro_torch.core.scores as tscores
from repro_torch import compat
from repro_torch.compile import program as tprogram
from repro_torch.core.session import compile_request
from repro_torch.serverless import InlineBackend, PoolConfig, TaskLedger
from repro_torch.serverless.backends import fingerprint_array

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# exact tier: cross-fitting grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k,m,seed", [
    (100, 5, 3, 42), (101, 3, 2, 0), (5099, 5, 4, 42), (37, 2, 1, 123456),
])
def test_draw_fold_masks_exact(n, k, m, seed):
    got = tcf.draw_fold_masks(n, k, m, seed)
    want = jcf.draw_fold_masks(n, k, m, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tcf.check_partition(got)


@pytest.mark.parametrize("m,k,l", [(3, 5, 2), (2, 3, 5), (1, 2, 3)])
@pytest.mark.parametrize("scaling", ["n_rep", "n_folds*n_rep"])
def test_task_grid_maps_exact(m, k, l, scaling):
    a, b = tcf.TaskGrid(m, k, l), jcf.TaskGrid(m, k, l)
    assert a.n_tasks == b.n_tasks
    assert a.n_invocations(scaling) == b.n_invocations(scaling)
    inv = np.arange(a.n_invocations(scaling))
    assert np.array_equal(a.invocation_task_ids(inv, scaling),
                          b.invocation_task_ids(inv, scaling))
    for x, y in zip(a.task_coords(), b.task_coords()):
        assert np.array_equal(x, y)
    assert np.array_equal(a.segment_invocations((0, l - 1), scaling),
                          b.segment_invocations((0, l - 1), scaling))
    assert [dataclasses.astuple(t) for t in a.keys()] == \
        [dataclasses.astuple(t) for t in b.keys()]
    for i in inv[:7]:
        assert [dataclasses.astuple(t)
                for t in a.tasks_of_invocation(int(i), scaling)] == \
            [dataclasses.astuple(t)
             for t in b.tasks_of_invocation(int(i), scaling)]


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 5099, 60000])
def test_bucket_rules_exact(n):
    assert tcf.pow2_bucket(n) == jcf.pow2_bucket(n)
    assert tcf.pow2_bucket(n, 1) == jcf.pow2_bucket(n, 1)
    assert tcf.aligned_bucket(n) == jcf.aligned_bucket(n)
    assert tcf.aligned_bucket(n, 8, 3) == jcf.aligned_bucket(n, 8, 3)


def test_stitch_and_padding_stats_exact():
    rng = np.random.default_rng(0)
    masks = tcf.draw_fold_masks(50, 5, 3, 1)
    preds = rng.normal(size=(3, 5, 50)).astype(np.float32)
    assert np.array_equal(tcf.stitch_predictions(masks, preds),
                          jcf.stitch_predictions(masks, preds))
    a = tcf.PaddingStats(80, 100, 8, 16, lane_cells=90, true_feats=5,
                         padded_feats=8)
    b = jcf.PaddingStats(80, 100, 8, 16, lane_cells=90, true_feats=5,
                         padded_feats=8)
    assert dataclasses.asdict(a.merge(a)) == dataclasses.asdict(b.merge(b))
    for prop in ("waste_frac", "b_waste_frac", "n_waste_frac", "p_waste_frac"):
        assert getattr(a, prop) == getattr(b, prop)


# ---------------------------------------------------------------------------
# exact tier: data identity, requests, bucket plans, block layouts
# ---------------------------------------------------------------------------
def _both_data(raw):
    return tcore.DMLData.from_dict(raw), rcore.DMLData.from_dict(raw)


@pytest.mark.parametrize("make", [make_plr_data, make_pliv_data,
                                  make_irm_data])
def test_fingerprint_and_content_key_exact(make):
    raw = make(n_obs=120, dim_x=6, seed=3)
    dt, dj = _both_data(raw)
    assert dt.fingerprint() == dj.fingerprint()
    assert dt.content_key() == dj.content_key()
    assert fingerprint_array(raw["x"]) == jax_fingerprint(raw["x"])
    assert fingerprint_array(raw["x"][::2]) == jax_fingerprint(raw["x"][::2])


def test_dgps_are_exact_copies():
    import repro.data as jd
    import repro_torch.data as td
    for name in ("make_plr_data", "make_pliv_data", "make_irm_data"):
        a, b = getattr(td, name)(n_obs=64, dim_x=5, seed=9), \
            getattr(jd, name)(n_obs=64, dim_x=5, seed=9)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    a, b = td.make_bonus_data(), jd.make_bonus_data()
    assert all(np.array_equal(a[k], b[k]) for k in ("x", "y", "d"))
    assert (td.N_BONUS, td.TRUE_EFFECT) == (jd.N_BONUS, jd.TRUE_EFFECT)


CASES = [
    ("plr", make_plr_data, "ridge", {"reg": 1.0}, "n_rep"),
    ("plr", make_plr_data, "lasso", {}, "n_folds*n_rep"),
    ("pliv", make_pliv_data, "ols", {}, "n_rep"),
    ("irm", make_irm_data, "ridge", {"reg": 1.0}, "n_rep"),
]


def _plans(model, learner, params, scaling, **kw):
    args = dict(learner=learner, learner_params=params, n_folds=3, n_rep=5,
                seed=7, scaling=scaling, backend="inline", **kw)
    if model == "irm":          # a linear propensity, as the slice supports
        return (tcore.DMLPlan.for_model(model, overrides={
                    "ml_m": tcore.NuisanceSpec.make(
                        "ml_m", "d", "ridge", {"classify": True})}, **args),
                rcore.DMLPlan.for_model(model, overrides={
                    "ml_m": rcore.NuisanceSpec.make(
                        "ml_m", "d", "ridge", {"classify": True})}, **args))
    return (tcore.DMLPlan.for_model(model, **args),
            rcore.DMLPlan.for_model(model, **args))


@pytest.mark.parametrize("model,make,learner,params,scaling", CASES)
def test_compiled_request_exact(model, make, learner, params, scaling):
    raw = make(n_obs=131, dim_x=6, seed=2)
    dt, dj = _both_data(raw)
    pt, pj = _plans(model, learner, params, scaling)
    rt, rj = compile_request(pt, dt), jax_compile_request(pj, dj)
    arrays = compat.request_arrays(rt)
    assert np.array_equal(arrays["x"], np.asarray(rj.x))
    assert np.array_equal(arrays["targets"], rj.targets)
    assert np.array_equal(arrays["train_w"], rj.train_w)
    assert np.array_equal(arrays["fold_masks"], rj.fold_masks)
    assert rt.data_key == rj.data_key and rt.work_key == rj.work_key
    assert [(s.l_ids, s.cache_key, s.learner, s.params, s.key_ref)
            for s in rt.segments] == \
        [(s.l_ids, s.cache_key, s.learner, s.params, s.key_ref)
         for s in rj.segments]
    assert [s.key for s in rt.segments] == [ref[1] for ref in
                                            (s.key_ref for s in rj.segments)]
    inv = np.arange(rt.ledger.n_invocations)
    assert np.array_equal(rt.segment_of_inv(inv), rj.segment_of_inv(inv))
    for a, b in zip(rt._index_maps(), rj._index_maps()):
        assert np.array_equal(a, b)
    tasks = np.arange(rt.grid.n_tasks)
    for a, b in zip(rt.wave_arrays(tasks), rj.wave_arrays(tasks)):
        assert np.array_equal(a, b)
    for si in range(len(rt.segments)):
        kd = rt.task_key_data(si, tasks)
        assert kd.dtype == np.int64 and kd.shape == (len(tasks), 2)
        assert np.array_equal(kd, rj.task_key_data(si, tasks).astype(np.int64))


@pytest.mark.parametrize("model,make,learner,params,scaling", CASES)
def test_bucket_plan_and_block_layout_exact(model, make, learner, params,
                                            scaling):
    raw = make(n_obs=131, dim_x=6, seed=2)
    dt, dj = _both_data(raw)
    pt, pj = _plans(model, learner, params, scaling)
    rt, rj = compile_request(pt, dt), jax_compile_request(pj, dj)
    bt, bj = tc.plan_buckets([rt]), jc.plan_buckets([rj])
    assert [dataclasses.astuple(k) for k in bt.buckets] == \
        [dataclasses.astuple(k) for k in bj.buckets]
    gt, gj = bt.pending_by_bucket(), bj.pending_by_bucket()
    assert [(dataclasses.astuple(k), v) for k, v in gt.items()] == \
        [(dataclasses.astuple(k), v) for k, v in gj.items()]
    for (kt, entries), kj in zip(gt.items(), gj):
        assert np.array_equal(bt.page(0, kt), bj.page(0, kj))
        invs = [inv for _, inv in entries]
        for b_block in (32, 8):
            assert tprogram._request_block_layout(rt, invs, b_block, 1) == \
                jprogram._request_block_layout(rj, invs, b_block, 1)
        blocks_t = tprogram._plan_blocks(bt, kt, entries, 32, 1)
        blocks_j = jprogram._plan_blocks(bj, kj, entries, 32, 1)
        assert [dataclasses.astuple(b) for b in blocks_t] == \
            [dataclasses.astuple(b) for b in blocks_j]
        for blk_t, blk_j in zip(blocks_t, blocks_j):
            yt, wt, vt, kdt = tprogram._block_tensors(rt, blk_t.si, blk_t,
                                                      kt.n_pad)
            yj, wj, vj, _ = jprogram._block_tensors(rj, blk_j.si, blk_j,
                                                    kj.n_pad)
            assert np.array_equal(yt, yj) and np.array_equal(wt, wj)
            assert np.array_equal(vt, vj)
            assert kdt.shape == (blk_t.b_pad, 2)


def test_tail_block_and_two_segments_occur():
    """The small sizes used by the parity tests do reach a tail block and
    a request with two learner segments."""
    dt, _ = _both_data(make_plr_data(n_obs=100, dim_x=5, seed=1))
    plan = tcore.DMLPlan.for_model("plr", learner="ridge", n_folds=5,
                                   n_rep=4, backend="inline")
    req = compile_request(plan, dt)                   # 40 tasks: 32 + 8
    bplan = tc.plan_buckets([req])
    ((key, entries),) = bplan.pending_by_bucket().items()
    blocks = tprogram._plan_blocks(bplan, key, entries, 32, 1)
    assert [(b.k, b.b_pad) for b in blocks] == [(32, 32), (8, 8)]
    mixed = tcore.DMLPlan.for_model(
        "plr", learner="ridge", n_folds=3, n_rep=2, backend="inline",
        overrides={"ml_m": tcore.NuisanceSpec.make("ml_m", "d", "lasso")})
    req2 = compile_request(mixed, dt)
    assert len(req2.segments) == 2
    assert len(tc.plan_buckets([req2]).buckets) == 2


# ---------------------------------------------------------------------------
# exact tier: ledgers and payloads across the two packages
# ---------------------------------------------------------------------------
def _half_done(ledger_cls, seed=0):
    rng = np.random.default_rng(seed)
    led = ledger_cls.create(10, 40, 3)
    done = [0, 2, 3, 7, 9]
    led.record_successes(done, rng.normal(size=(5, 3, 40)).astype(np.float32))
    led.mark_running([1, 4])
    led.record_failure(5)
    return led


@pytest.mark.parametrize("writer,reader", [
    (JaxLedger, TaskLedger), (TaskLedger, JaxLedger),
    (TaskLedger, TaskLedger)])
def test_ledger_save_load_across_packages(tmp_path, writer, reader):
    led = _half_done(writer)
    path = str(tmp_path / "ledger.msgpack")
    led.save(path)
    back = reader.load(path)
    assert (back.n_invocations, back.n_obs, back.tasks_per_invocation) == \
        (10, 40, 3)
    assert np.array_equal(back.preds, led.preds)
    assert np.array_equal(back.attempts, led.attempts)
    want = led.status.copy()
    want[want == 1] = 0                     # RUNNING rows return to PENDING
    assert np.array_equal(back.status, want)
    assert np.array_equal(back.pending(), np.array([1, 4, 5, 6, 8]))


def test_ledger_files_are_byte_identical(tmp_path):
    a, b = _half_done(JaxLedger), _half_done(TaskLedger)
    a.save(str(tmp_path / "a"))
    b.save(str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    b.path = str(tmp_path / "c")
    b.checkpoint()
    assert (tmp_path / "c").read_bytes() == (tmp_path / "a").read_bytes()


def test_compat_ledger_from_reference(tmp_path):
    led = _half_done(JaxLedger, seed=4)
    path = str(tmp_path / "ref.msgpack")
    led.save(path)
    back = compat.ledger_from_reference(path)
    assert isinstance(back, TaskLedger) and back.n_done == 5
    assert np.array_equal(back.preds, led.preds)


@pytest.mark.parametrize("model,make,learner,params,scaling", CASES)
def test_compat_plan_and_data_round_trip(model, make, learner, params,
                                         scaling):
    raw = make(n_obs=90, dim_x=4, seed=5)
    dt, dj = _both_data(raw)
    pt, pj = _plans(model, learner, params, scaling)
    # reference payload, through msgpack as a durable session writes it
    wire = msgpack.unpackb(msgpack.packb(
        {"plan": pj.to_payload(), "data": dj.to_payload()},
        use_bin_type=True), raw=False)
    plan = compat.plan_from_reference(wire["plan"])
    data = compat.data_from_reference(wire["data"])
    assert plan == pt
    assert data.content_key() == dj.content_key()
    assert data.theta0 == dj.theta0
    # and back: the reference reads what the port writes
    assert pt.to_payload() == pj.to_payload()
    assert rcore.DMLPlan.from_payload(pt.to_payload()) == pj
    back = rcore.DMLData.from_payload(dt.to_payload())
    assert back.content_key() == dt.content_key()


def test_plan_validation_matches_reference():
    for kw in ({"backend": "bogus"}, {"scaling": "nope"}):
        with pytest.raises(ValueError):
            tcore.DMLPlan.for_model("plr", **kw)
        with pytest.raises(ValueError):
            rcore.DMLPlan.for_model("plr", **kw)
    with pytest.raises(KeyError):
        tcore.DMLPlan.for_model("nope")
    with pytest.raises(ValueError):
        tcore.DMLData(x=np.ones((3, 2)), y=np.ones(4), d=np.ones(3))
    with pytest.raises(ValueError):
        tcore.DMLData(x=np.full((3, 2), np.nan), y=np.ones(3), d=np.ones(3))
    # the default plan names the wave backend, as the reference's does
    assert tcore.DMLPlan.for_model("plr").backend == \
        rcore.DMLPlan.for_model("plr").backend == "wave"
    # the standard propensity learner is named the same on both sides
    assert tcore.DMLPlan.for_model("irm").to_payload() == \
        rcore.DMLPlan.for_model("irm").to_payload()


def test_pool_config_keeps_the_reference_fields():
    """Every field and every default is the reference's, fusion,
    coalescing and the 256 MiB page pool included."""
    ft = {f.name: f.default for f in dataclasses.fields(PoolConfig)}
    fj = {f.name: f.default for f in dataclasses.fields(JaxPool)}
    assert list(ft) == list(fj)
    assert ft == fj
    assert (ft["fuse"], ft["coalesce"], ft["page_pool_bytes"]) == \
        (True, True, 256 * 1024 * 1024)
    assert dataclasses.asdict(PoolConfig()) == dataclasses.asdict(JaxPool())
    with pytest.raises(dataclasses.FrozenInstanceError):
        PoolConfig().n_workers = 3


def test_compile_stats_match_reference_unfused():
    """The port launches as the reference does with fusion, coalescing
    and the page pool off: same launches, blocks and padding account."""
    raw = make_plr_data(n_obs=100, dim_x=5, seed=1)
    dt, dj = _both_data(raw)
    pt, pj = _plans("plr", "ridge", {"reg": 1.0}, "n_rep")
    bt = InlineBackend(PoolConfig(fuse=False, coalesce=False,
                                  page_pool_bytes=0), device="cpu")
    bj = JaxInline(JaxPool(fuse=False, coalesce=False, page_pool_bytes=0))
    for _ in range(2):
        bt.run_requests([compile_request(pt, dt)])
        bj.run_requests([jax_compile_request(pj, dj)])
    st, sj = bt.compiler.stats, bj.compiler.stats
    assert (st.launches, st.blocks, st.hits, st.misses, st.fused_launches,
            st.coalesced_blocks) == \
        (sj.launches, sj.blocks, sj.hits, sj.misses, sj.fused_launches,
         sj.coalesced_blocks)
    assert dataclasses.asdict(st.padding) == dataclasses.asdict(sj.padding)


@pytest.mark.parametrize("backend", ["inline", "wave", "sharded"])
def test_compile_stats_match_reference_fused(backend):
    """On the defaults — same-shape blocks fused, tails coalesced, pages
    pooled — the port schedules as the reference does: the paper's task
    grid (K 5, M 100, L 2: 31 full blocks and a tail of 8) at a small N,
    drained twice by one backend; the same ``CompileStats``,
    ``PaddingStats`` and ``PageStats`` after each drain (inline: 1 launch
    of 32 blocks, the tail morphed to 32 lanes; wave: 7 fused launches;
    one page upload), theta and se within the float tier."""
    raw = make_plr_data(n_obs=100, dim_x=5, seed=1)
    dt, dj = _both_data(raw)
    kw = dict(learner="ridge", learner_params={"reg": 1.0}, n_folds=5,
              n_rep=100, seed=42)
    pt = tcore.DMLPlan.for_model("plr", **kw)
    pj = rcore.DMLPlan.for_model("plr", **kw)
    bt = tcore.DMLSession(backend=backend, device="cpu")
    bj = rcore.DMLSession(backend=backend)
    for drain in range(2):
        rt, rj = bt.estimate(pt, dt), bj.estimate(pj, dj)
        it, ij = bt.last_run_info, bj.last_run_info
        st, sj = it.compile, ij.compile
        fields = ("launches", "blocks", "fused_launches", "coalesced_blocks",
                  "hits", "misses")
        assert [getattr(st, f) for f in fields] == \
            [getattr(sj, f) for f in fields], (drain, fields)
        assert dataclasses.asdict(st.padding) == \
            dataclasses.asdict(sj.padding)
        assert dataclasses.asdict(it.pages) == dataclasses.asdict(ij.pages)
        np.testing.assert_allclose(rt.theta, rj.theta, rtol=1e-4)
        np.testing.assert_allclose(rt.se, rj.se, rtol=1e-4)
    launches = {"inline": 2, "sharded": 2, "wave": 14}[backend]
    assert (st.launches, st.fused_launches, st.blocks) == \
        (launches, launches, 64)
    assert st.padding.padded_tasks == 2 * 1024
    assert (it.pages.misses, it.pages.bytes_h2d) == (1, 104 * 8 * 4)


# ---------------------------------------------------------------------------
# float tier (rtol 1e-6): scores, theta, se, aggregation, confint
# ---------------------------------------------------------------------------
def _score_inputs(model, seed, m=4, n=200):
    """Observations with a real effect (y = 2 + d + noise) and mildly
    wrong nuisance predictions, so the sums that give theta are not
    cancellations of float32 noise."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(1, n))
    z = d + rng.normal(size=(1, n))
    if model in ("irm", "iivm"):
        z = (rng.random((1, n)) < 0.5).astype(float)
        d = (rng.random((1, n)) < 0.3 + 0.4 * z).astype(float)
    y = 2.0 + d + 0.3 * rng.normal(size=(1, n))
    data = {k: v.astype(np.float32) for k, v in
            {"y": y, "d": d, "z": z}.items()}
    preds = {}
    for nm, _, _ in tscores.SPECS[model].nuisances:
        v = rng.normal(size=(m, n)) * 0.3
        if nm == "ml_g1":
            v = v + 1.0
        if nm == "ml_r1":
            v = v * 0.1 + 0.7
        if nm == "ml_r0":
            v = v * 0.1 + 0.3
        if nm == "ml_m" and model in ("irm", "iivm"):
            v = rng.random((m, n)) * 1.2 - 0.1       # exercises the clip
        preds[nm] = v.astype(np.float32)
    return data, preds


@pytest.mark.parametrize("model,score", [
    ("plr", "default"), ("plr", "IV-type"), ("pliv", "default"),
    ("irm", "default"), ("irm", "ATTE"), ("iivm", "default")])
def test_scores_theta_and_se(model, score):
    data, preds = _score_inputs(model, seed=len(model) + len(score))
    at, bt = tscores.evaluate_score(
        model, {k: torch.from_numpy(v) for k, v in data.items()},
        {k: torch.from_numpy(v) for k, v in preds.items()}, score)
    aj, bj = jscores.evaluate_score(
        model, {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in preds.items()}, score)
    assert at.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-7)
    # theta and se from the SAME psi on both sides
    a_same, b_same = torch.tensor(np.asarray(aj)), torch.tensor(np.asarray(bj))
    tht = tscores.solve_theta(a_same, b_same)
    thj = jscores.solve_theta(aj, bj)
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), rtol=1e-6)
    set_ = tscores.score_se(a_same, b_same, torch.tensor(np.asarray(thj)))
    sej = jscores.score_se(aj, bj, thj)
    np.testing.assert_allclose(set_.numpy(), np.asarray(sej), rtol=1e-6)


def test_score_specs_match_reference():
    assert {k: (v.name, v.nuisances) for k, v in tscores.SPECS.items()} == \
        {k: (v.name, v.nuisances) for k, v in jscores.SPECS.items()}
    with pytest.raises(KeyError):
        tscores.evaluate_score("nope", {}, {})


@pytest.mark.parametrize("m", [1, 4, 5, 100])
@pytest.mark.parametrize("method", ["median", "mean"])
def test_aggregate_thetas_even_and_odd(m, method):
    """An even count averages the two middle order statistics, as
    jnp.median does (torch.median would take the lower one)."""
    rng = np.random.default_rng(m)
    thetas = (0.5 + 0.05 * rng.normal(size=m)).astype(np.float32)
    ses = (0.05 + 0.01 * rng.random(m)).astype(np.float32)
    got = tagg.aggregate_thetas(torch.from_numpy(thetas),
                                torch.from_numpy(ses), method)
    want = jagg.aggregate_thetas(jnp.asarray(thetas), jnp.asarray(ses),
                                 method)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if method == "median" and m == 4:
        mid = np.sort(thetas)[1:3]
        assert got[0] == pytest.approx(float(mid.mean()), rel=1e-6)
        assert got[0] != pytest.approx(float(mid[0]), rel=1e-6)
    with pytest.raises(ValueError):
        tagg.aggregate_thetas(thetas, ses, "mode")


@pytest.mark.parametrize("level", [0.9, 0.95, 0.99])
def test_confint_and_norm_ppf(level):
    assert tagg.confint(0.4, 0.07, level) == jagg.confint(0.4, 0.07, level)


# ---------------------------------------------------------------------------
# the port stands alone: no import of jax or of the JAX package
# ---------------------------------------------------------------------------
def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) in \
                ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_estimate.py"]


def test_port_file_list_is_not_empty():
    names = {p.name for p in PORT_FILES}
    assert {"runtime.py", "megabatch.py", "ops.py", "linear.py", "session.py",
            "program.py", "backends.py", "chip_smoke.py", "roofline.py",
            "mesh.py", "gram.py", "crossfit_gram.py", "dml.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots
    allowed = {"torch", "numpy", "msgpack", "repro_torch", "__future__"}
    import sys
    third_party = {r for r in roots
                   if r not in sys.stdlib_module_names} - allowed
    assert not third_party, third_party

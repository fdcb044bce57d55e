"""The slice as a whole: ``repro_torch.estimate`` / ``DMLSession`` on the
inline backend (CPU device, plain versions of the kernels) against
``repro.estimate`` on the same numpy data.

Tolerances: (M, K, L, N) predictions rtol 1e-4, atol 1e-5; theta and se
1e-4 relative.  The reference runs at its defaults (fusion on): its
results are bitwise the same with and without fusion.
"""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.core as rcore
from repro.data import make_irm_data, make_pliv_data, make_plr_data
from repro.serverless import TaskLedger as JaxLedger

import repro_torch
import repro_torch.core as tcore
from repro_torch import compat, runtime, threefry
from repro_torch.core.session import assemble_result, compile_request
from repro_torch.serverless import (
    BACKEND_NAMES, InlineBackend, PoolConfig, TaskLedger, make_backend,
)
from repro_torch.serverless.ledger import DONE


def _linear_ml_m(core):
    return {"ml_m": core.NuisanceSpec.make("ml_m", "d", "ridge",
                                           {"reg": 1.0, "classify": True})}


# (id, model, dgp, n_obs, dim_x, K, M, learner, params, scaling)
CASES = [
    ("plr-ridge", "plr", make_plr_data, 300, 12, 5, 4, "ridge",
     {"reg": 1.0}, "n_rep"),                       # 40 tasks: 32 + tail 8
    ("plr-ols", "plr", make_plr_data, 203, 20, 3, 3, "ols", {}, "n_rep"),
    ("plr-lasso", "plr", make_plr_data, 250, 5, 4, 2, "lasso",
     {"reg": 0.01}, "n_folds*n_rep"),
    ("pliv-ridge", "pliv", make_pliv_data, 500, 9, 5, 3, "ridge",
     {"reg": 1.0}, "n_rep"),                       # 45 tasks: 32 + tail 16
    ("irm-linear", "irm", make_irm_data, 400, 6, 3, 2, "ridge",
     {"reg": 1.0}, "n_rep"),
]


def _both(case):
    _, model, make, n, p, k, m, learner, params, scaling = case
    raw = make(n_obs=n, dim_x=p, seed=11)
    out = []
    for core in (tcore, rcore):
        kw = dict(learner=learner, learner_params=params, n_folds=k,
                  n_rep=m, seed=5, scaling=scaling, backend="inline")
        if model == "irm":
            kw["overrides"] = _linear_ml_m(core)
        out.append((core.DMLPlan.for_model(model, **kw),
                    core.DMLData.from_dict(raw)))
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_estimate_matches_reference(case):
    (pt, dt), (pj, dj) = _both(case)
    sj = rcore.DMLSession(backend="inline")
    rj = sj.estimate(pj, dj)
    want = sj.request(0).gathered_preds()

    runtime.reset_launch_counts()
    st = tcore.DMLSession(backend="inline", device="cpu")
    rt = st.estimate(pt, dt)
    got = st.request(0).gathered_preds()

    assert got.shape == want.shape == (case[6], case[5], pt.n_nuisance,
                                       case[3])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert _rel(rt.theta, rj.theta) < 1e-4
    assert _rel(rt.se, rj.se) < 1e-4
    np.testing.assert_allclose(rt.thetas, rj.thetas, rtol=1e-4)
    np.testing.assert_allclose(rt.ses, rj.ses, rtol=1e-4)
    np.testing.assert_allclose(rt.ci, rj.ci, rtol=1e-4, atol=1e-6)
    # same accounting: invocations billed, bookings, completed ledger
    assert rt.report.bill.n_invocations == rj.report.bill.n_invocations
    assert rt.report.waves == rj.report.waves
    assert rt.report.wave_sizes == rj.report.wave_sizes
    assert st.request(0).ledger.complete
    # the CPU path ran the plain versions: no kernel was launched
    assert runtime.launch_counts == {"batched_gram": 0,
                                     "batched_gram_blocked": 0,
                                     "batched_predict": 0,
                                     "crossfit_gram": 0,
                                     "flash_attention": 0,
                                     "ssd_scan": 0}


def test_one_shot_estimate_equals_session_estimate():
    (pt, dt), _ = _both(CASES[0])
    a = repro_torch.estimate(pt, dt, device="cpu")      # backend from plan
    b = tcore.DMLSession(backend="inline", device="cpu").estimate(pt, dt)
    c = repro_torch.estimate(pt.replace(backend="wave"), dt,
                             backend=InlineBackend(device="cpu"))
    assert a.theta == b.theta == c.theta and a.se == b.se == c.se
    assert a.summary()["exec_invocations"] == 8


def test_session_three_requests_match_reference():
    jobs = [_both(CASES[0]), _both(CASES[2]), _both(CASES[3])]
    sj = rcore.DMLSession(backend="inline")
    st = tcore.DMLSession(backend="inline", device="cpu")
    seen = []
    for (pt, dt), (pj, dj) in jobs:
        sj.submit(pj, dj)
        st.submit(pt, dt, on_complete=lambda r: seen.append(r.request_id))
    res_j, res_t = sj.run(), st.run()
    assert [r.request_id for r in res_t] == [0, 1, 2]
    assert st.completion_order == seen == [0, 1, 2]
    assert st.last_run_info.backend == "inline"
    assert st.last_run_info.buckets == sj.last_run_info.buckets == 3
    for rid, (rt, rj) in enumerate(zip(res_t, res_j)):
        assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
        np.testing.assert_allclose(st.request(rid).gathered_preds(),
                                   sj.request(rid).gathered_preds(),
                                   rtol=1e-4, atol=1e-5)
        assert st.result(rid) is rt
    # a request served by a session equals the same request served alone
    solo = repro_torch.estimate(*jobs[1][0], device="cpu")
    assert solo.theta == res_t[1].theta and solo.se == res_t[1].se
    # warm programs: the same three again build nothing new
    misses = st.backend.compiler.stats.misses
    for (pt, dt), _ in jobs:
        st.submit(pt, dt)
    again = st.run()
    assert st.backend.compiler.stats.misses == misses
    assert [r.theta for r in again] == [r.theta for r in res_t]
    assert st.completion_order == [0, 1, 2, 3, 4, 5]


def test_poll_and_wait_drive_the_same_engine():
    (pt, dt), _ = _both(CASES[4])
    (pt2, dt2), _ = _both(CASES[1])
    sess = tcore.DMLSession(backend="inline", device="cpu")
    assert sess.poll() == []
    a, b = sess.submit(pt, dt), sess.submit(pt2, dt2)
    done = []
    for _ in range(10):
        done += sess.poll()
        if len(done) == 2:
            break
    assert done == [a, b]
    with pytest.raises(KeyError):
        sess.wait(99)
    c = sess.submit(pt2, dt2)
    assert sess.wait(c).theta == sess.result(b).theta
    assert sess.run() == []


def test_resume_from_half_done_reference_ledger(tmp_path):
    """A ledger half filled by the reference, saved, loaded through
    compat: the port executes only the missing invocations, keeps the
    reference's rows bit for bit, and lands the same estimate."""
    (pt, dt), (pj, dj) = _both(CASES[0])
    sj = rcore.DMLSession(backend="inline")
    rj = sj.estimate(pj, dj)
    full = sj.request(0).ledger
    half = JaxLedger.create(full.n_invocations, full.n_obs,
                            full.tasks_per_invocation)
    done = np.arange(0, full.n_invocations, 2)
    half.record_successes(done, full.preds[done])
    half.mark_running([1])                              # orphaned by a crash
    path = str(tmp_path / "half.msgpack")
    half.save(path)

    ledger = compat.ledger_from_reference(path)
    assert ledger.n_done == len(done)
    req = compile_request(pt, dt, ledger=ledger)
    backend = InlineBackend(device="cpu")
    backend.run_requests([req])
    missing = full.n_invocations - len(done)
    assert req.report.bill.n_invocations == missing
    assert sorted(r.invocation for r in req.report.bill.records) == \
        [i for i in range(full.n_invocations) if i % 2]
    assert (ledger.status == DONE).all()
    assert np.array_equal(ledger.preds[done], full.preds[done])
    rt = assemble_result(pt, dt, req, device="cpu")
    assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
    # a complete ledger executes nothing at all
    rt2 = repro_torch.estimate(pt, dt, ledger=ledger, device="cpu")
    assert rt2.report.bill.n_invocations == 0 and rt2.theta == rt.theta


def test_ledger_of_another_plan_is_refused():
    (pt, dt), _ = _both(CASES[0])
    with pytest.raises(ValueError, match="different plan"):
        compile_request(pt, dt, ledger=TaskLedger.create(3, 300, 5))


def test_checkpoint_path_is_written_and_resumable(tmp_path):
    (pt, dt), _ = _both(CASES[1])
    path = str(tmp_path / "ckpt.msgpack")
    backend = InlineBackend(PoolConfig(checkpoint_path=path), device="cpu")
    req = compile_request(pt, dt)
    backend.run_requests([req])
    loaded = TaskLedger.load(path)
    assert loaded.complete and np.array_equal(loaded.preds, req.ledger.preds)


# ---------------------------------------------------------------------------
# the device rule and everything this slice leaves to later ones
# ---------------------------------------------------------------------------
def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    (pt, dt), _ = _both(CASES[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.estimate(pt, dt)
    with pytest.raises(RuntimeError):
        tcore.DMLSession(backend="inline")
    with pytest.raises(RuntimeError):
        InlineBackend()
    with pytest.raises(RuntimeError):
        runtime.default_device()
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_tf32_stays_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("name", ["wave", "topology"])
def test_unported_backends_raise(name):
    """Both backends that were once unported run now (``wave`` since the
    wave slice, ``topology`` since the topology slice), each bit for bit
    the inline backend's estimate."""
    assert name in BACKEND_NAMES and "inline" in BACKEND_NAMES
    (pt, dt), _ = _both(CASES[0])
    make_backend(name, device="cpu")
    sess = tcore.DMLSession(backend=name, device="cpu")
    got = repro_torch.estimate(pt.replace(backend=name), dt, device="cpu")
    want = repro_torch.estimate(pt, dt, device="cpu")     # inline
    assert sess.backend.name == name
    assert (got.theta, got.se) == (want.theta, want.se)
    assert np.array_equal(got.psi[1], want.psi[1])


def test_unknown_backend_is_a_key_error():
    with pytest.raises(KeyError):
        make_backend("bogus", device="cpu")


@pytest.mark.parametrize("field,value", [
    ("fuse", True), ("coalesce", True), ("page_pool_bytes", 1 << 20),
    ("failure_rate", 0.1), ("straggler_rate", 0.2), ("hedge", True),
])
def test_unported_pool_settings_raise(field, value):
    """Every setting that was once refused runs now.  ``fuse``,
    ``coalesce`` and ``page_pool_bytes``, each alone on the per-block
    pool, give the per-block estimate bit for bit (ridge over 120 tasks:
    three full blocks and a tail of 24, so fusion and morphing both
    act); the fault settings run on the inline backend and leave the
    estimate as it is."""
    if field in ("fuse", "coalesce", "page_pool_bytes"):
        per_block = PoolConfig(fuse=False, coalesce=False,
                               page_pool_bytes=0)
        pt = tcore.DMLPlan.for_model(
            "plr", learner="ridge", learner_params={"reg": 1.0}, n_folds=3,
            n_rep=20, seed=5, backend="inline")
        dt = tcore.DMLData.from_dict(make_plr_data(n_obs=90, dim_x=6,
                                                   seed=11))
        out = []
        for pool in (per_block,
                     dataclasses.replace(per_block, **{field: value})):
            sess = tcore.DMLSession(backend="inline", pool=pool,
                                    device="cpu")
            res = sess.estimate(pt, dt)
            out.append((res, sess.request(0).gathered_preds(),
                        sess.last_run_info))
        (ref, ref_preds, _), (got, got_preds, info) = out
        assert (got.theta, got.se) == (ref.theta, ref.se)
        assert np.array_equal(got_preds, ref_preds)
        if field == "fuse":           # the three full blocks in one launch
            assert (info.compile.launches, info.compile.fused_launches) == \
                (2, 1)
        if field == "page_pool_bytes":
            assert info.pages.misses == 1 and info.pages.bytes_h2d > 0
        return
    (pt, dt), _ = _both(CASES[1])
    pool = PoolConfig(**{field: value, "max_retries": 10, "seed": 0})
    got = tcore.DMLSession(backend="inline", pool=pool,
                           device="cpu").estimate(pt, dt)
    want = repro_torch.estimate(pt, dt, device="cpu")
    assert (got.theta, got.se) == (want.theta, want.se)
    if field == "failure_rate":
        assert got.report.failures > 0


# (id, model, dgp, learner, params): the nonparametric families end to
# end, with the multiplier bootstrap; IRM puts logistic (kernel_ridge) or
# mlp with classify=True (mlp) on the propensity, and trains ml_g0/ml_g1
# on subsets
NONLINEAR = [
    ("plr-kernel_ridge", "plr", make_plr_data, "kernel_ridge",
     {"reg": 1.0, "n_landmarks": 32}),
    ("irm-kernel_ridge", "irm", make_irm_data, "kernel_ridge",
     {"reg": 1.0, "n_landmarks": 24}),
    ("plr-mlp", "plr", make_plr_data, "mlp", {"hidden": (8,),
                                               "n_steps": 60}),
    ("irm-mlp", "irm", make_irm_data, "mlp", {"hidden": (8, 8),
                                               "n_steps": 40}),
]


@pytest.mark.parametrize("case", NONLINEAR, ids=[c[0] for c in NONLINEAR])
def test_nonlinear_learners_and_bootstrap_match_reference(case):
    """kernel_ridge and mlp plans with ``n_boot > 0``: predictions at the
    float tier, theta, se and the bootstrap interval within 1e-4
    relative of ``repro.estimate``."""
    _, model, make, learner, params = case
    raw = make(n_obs=160, dim_x=6, seed=3)
    plans = [core.DMLPlan.for_model(model, learner=learner,
                                    learner_params=params, n_folds=3,
                                    n_rep=2, seed=9, n_boot=200,
                                    backend="inline")
             for core in (tcore, rcore)]
    if model == "irm":
        want_l = "mlp" if learner == "mlp" else "logistic"
        assert plans[0].nuisances[2].learner == want_l
    sj = rcore.DMLSession(backend="inline")
    rj = sj.estimate(plans[1], rcore.DMLData.from_dict(raw))
    st = tcore.DMLSession(backend="inline", device="cpu")
    rt = st.estimate(plans[0], tcore.DMLData.from_dict(raw))
    np.testing.assert_allclose(st.request(0).gathered_preds(),
                               sj.request(0).gathered_preds(), rtol=1e-4,
                               atol=1e-5)
    assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
    assert rt.boot_ci is not None and len(rt.boot_ci) == 2
    for a, b in zip(rt.boot_ci, rj.boot_ci):
        assert _rel(a, b) < 1e-4
    assert rt.boot_ci[0] < rt.thetas[0] < rt.boot_ci[1]


def test_bootstrap_key_is_the_seed_plus_99():
    """The interval comes from key(seed + 99) on repetition 0, as in the
    reference; a plan without n_boot has none."""
    (pt, dt), _ = _both(CASES[1])
    res = repro_torch.estimate(dataclasses.replace(
        pt, inference=dataclasses.replace(pt.inference, n_boot=100)), dt,
        device="cpu")
    psi_a, psi_b = (torch.from_numpy(a[0]) for a in res.psi)
    bt, se1 = tcore.multiplier_bootstrap(
        psi_a, psi_b, float(res.thetas[0]),
        threefry.key(pt.resampling.seed + 99), n_boot=100)
    assert res.boot_ci == tcore.boot_confint(float(res.thetas[0]), se1, bt)
    assert repro_torch.estimate(pt, dt, device="cpu").boot_ci is None


def test_irm_default_propensity_needs_no_override():
    """The default IRM plan puts ``logistic`` on the propensity; it runs
    with no ``overrides=`` and lands the reference's estimate."""
    raw = make_irm_data(n_obs=200, dim_x=4, seed=2)
    plans = [core.DMLPlan.for_model("irm", learner="ridge", n_folds=3,
                                    n_rep=2, backend="inline")
             for core in (tcore, rcore)]
    assert plans[0].nuisances[2].learner == "logistic"
    rt = repro_torch.estimate(plans[0], raw, device="cpu")
    rj = rcore.estimate(plans[1], rcore.DMLData.from_dict(raw))
    assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
    np.testing.assert_allclose(rt.thetas, rj.thetas, rtol=1e-4)


def test_near_square_ols_is_as_close_to_float64_as_the_reference():
    """ROADMAP Queue 3, *near-square ols*: IRM x ols where the lane
    (m 3, k 1, ``ml_g1``) trains on about as many rows as it has
    coefficients (cond(X'X) about 3e3).  Neither package is within the
    float tier of the other there, so each is held to a float64 solve of
    the same normal equations, within cond(G) float32 epsilons of the
    predictions' scale, and the port no farther from it than the
    reference (recorded: 8.0e-5 against 2.6e-4)."""
    raw = make_irm_data(n_obs=132, dim_x=24, seed=1)
    preds, req = [], None
    for core in (tcore, rcore):
        plan = core.DMLPlan.for_model("irm", learner="ols", n_folds=2,
                                      n_rep=4, seed=7,
                                      scaling="n_folds*n_rep",
                                      backend="inline")
        kw = {"device": "cpu"} if core is tcore else {}
        sess = core.DMLSession(backend="inline", **kw)
        sess.estimate(plan, core.DMLData.from_dict(raw))
        req = sess.request(0)
        preds.append(req.gathered_preds()[3, 1, 1].astype(np.float64))
    w = req.train_w[3, 1, 1].astype(np.float64)
    xa = np.concatenate([req.x.astype(np.float64),
                         np.ones((req.x.shape[0], 1))], axis=1)
    g = xa.T @ (w[:, None] * xa) + 1e-8 * np.eye(xa.shape[1])
    beta = np.linalg.solve(g, xa.T @ (w * req.targets[1]))
    want = xa @ beta
    assert int(w.sum()) <= xa.shape[1] + 3          # near square
    cond = np.linalg.cond(g)
    assert 1e3 < cond < 1e4
    bound = cond * np.finfo(np.float32).eps * np.abs(want).max()
    err_port, err_ref = (float(np.abs(p - want).max()) for p in preds)
    assert err_port <= bound and err_ref <= bound
    assert err_port <= err_ref

"""The serving layer on the default (wave) backend: ``estimate`` and
``DMLSession`` with no ``backend`` anywhere, against the JAX package on
the same numpy data (float tier: predictions rtol 1e-4 / atol 1e-5,
theta and se 1e-4 relative), and the session's event loop on the wave
backend — ``poll`` interleaving, continuous admission mid-drain,
early-result ordering, completion callbacks — within the port (bitwise
against an inline drain of the same request)."""
import warnings

import numpy as np
import pytest

import repro.core as rcore
from repro.data import make_pliv_data, make_plr_data

import repro_torch
import repro_torch.core as tcore
from repro_torch.core.session import compile_request
from repro_torch.serverless import InlineBackend, PoolConfig

SMALL = PoolConfig(n_workers=2, memory_mb=256)   # 2 lanes a wave


def _plr(n_obs, seed, n_rep=2, core=tcore):
    data = core.DMLData.from_dict(make_plr_data(n_obs=n_obs, dim_x=5,
                                                theta=0.5, seed=seed))
    plan = core.DMLPlan.for_model("plr", learner="ridge",
                                  learner_params={"reg": 1.0}, n_folds=3,
                                  n_rep=n_rep, seed=seed + 100)
    return plan, data


def _rel(a, b):
    return abs(a - b) / abs(b)


def _inline_preds(plan, data):
    ref = compile_request(plan, data)
    InlineBackend(device="cpu").run_requests([ref])
    return ref.gathered_preds()


def test_estimate_on_the_default_backend_matches_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    raw = make_plr_data(n_obs=180, dim_x=6, seed=3)
    plans = [core.DMLPlan.for_model("plr", learner="ridge",
                                    learner_params={"reg": 1.0}, n_folds=4,
                                    n_rep=3, seed=9)
             for core in (tcore, rcore)]
    assert plans[0].backend == "wave"
    rt = repro_torch.estimate(plans[0], raw, device="cpu")
    rj = rcore.estimate(plans[1], rcore.DMLData.from_dict(raw))
    assert _rel(rt.theta, rj.theta) < 1e-4 and _rel(rt.se, rj.se) < 1e-4
    np.testing.assert_allclose(rt.thetas, rj.thetas, rtol=1e-4)
    assert rt.report.waves == rj.report.waves
    assert rt.report.wave_sizes == rj.report.wave_sizes
    assert [b.invocation for b in rt.report.bill.records] == \
        [b.invocation for b in rj.report.bill.records]


def test_default_session_matches_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    jobs_t = [_plr(140, 1), _plr(120, 2, n_rep=3)]
    jobs_j = [_plr(140, 1, core=rcore), _plr(120, 2, n_rep=3, core=rcore)]
    st = tcore.DMLSession(device="cpu")
    sj = rcore.DMLSession()
    assert st.backend.name == "wave"
    for sess, jobs in ((st, jobs_t), (sj, jobs_j)):
        for plan, data in jobs:
            sess.submit(plan, data)
    got, want = st.run(), sj.run()
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a.theta, b.theta) < 1e-4 and _rel(a.se, b.se) < 1e-4
        np.testing.assert_allclose(st.request(i).gathered_preds(),
                                   sj.request(i).gathered_preds(),
                                   rtol=1e-4, atol=1e-5)
    assert st.completion_order == sj.completion_order
    ti, ji = st.last_run_info, sj.last_run_info
    assert (ti.waves, ti.wave_members) == (ji.waves, ji.wave_members)
    d = ti.dispatch
    assert d.dispatched == d.harvested >= ti.waves >= 1
    assert d.ready_harvests >= 1 and d.in_flight_peak >= 1


def test_poll_interleaves_and_run_matches_batch():
    plan_a, data_a = _plr(120, 1)
    plan_b, data_b = _plr(90, 2)
    sess = tcore.DMLSession(pool=SMALL, device="cpu")
    ra = sess.submit(plan_a, data_a)
    rb = sess.submit(plan_b, data_b)
    done = []
    for _ in range(100):
        done += sess.poll()
        if len(done) == 2:
            break
    assert sorted(done) == [ra, rb]
    assert sess.poll() == []                       # idle: nothing to do
    sess2 = tcore.DMLSession(pool=SMALL, device="cpu")
    sess2.submit(plan_a, data_a)
    sess2.submit(plan_b, data_b)
    res = sess2.run()
    assert np.array_equal(sess.result(ra).thetas, res[0].thetas)
    assert np.array_equal(sess.result(rb).thetas, res[1].thetas)


def test_continuous_admission_mid_drain():
    plan_a, data_a = _plr(150, 3, n_rep=4)
    plan_b, data_b = _plr(100, 4)                  # another bucket
    sess = tcore.DMLSession(pool=SMALL, device="cpu")
    ra = sess.submit(plan_a, data_a)
    sess.poll()                                    # the drain is moving
    rb = sess.submit(plan_b, data_b)               # late admission
    res_b = sess.wait(rb)
    info = sess.last_run_info
    assert any(ra in m and rb in m for m in info.wave_members)
    sess.wait(ra)
    assert res_b.request_id == rb
    assert np.array_equal(sess.request(rb).gathered_preds(),
                          _inline_preds(plan_b, data_b))
    assert np.array_equal(sess.request(ra).gathered_preds(),
                          _inline_preds(plan_a, data_a))


def test_early_result_delivery_and_admission_from_a_callback():
    """A small request submitted after a large one completes first; a
    third request submitted from the first one's callback joins the
    same drain and completes in it."""
    big_plan, big_data = _plr(140, 5, n_rep=8)       # 16 invocations
    small_plan, small_data = _plr(80, 6, n_rep=1)    # 2 invocations
    pliv = tcore.DMLData.from_dict(make_pliv_data(n_obs=100, dim_x=4,
                                                  seed=7))
    pliv_plan = tcore.DMLPlan.for_model("pliv", learner="ridge", n_folds=3,
                                        n_rep=1, seed=8)
    order, late = [], []
    sess = tcore.DMLSession(pool=SMALL, device="cpu")

    def first_done(res):
        order.append(res.request_id)
        if not late:
            late.append(sess.submit(pliv_plan, pliv,
                                    on_complete=lambda r: order.append(
                                        r.request_id)))

    rid_big = sess.submit(big_plan, big_data, on_complete=first_done)
    rid_small = sess.submit(small_plan, small_data, on_complete=first_done)
    res = sess.run()
    assert [r.request_id for r in res] == [rid_big, rid_small]
    assert order[0] == rid_small and rid_big in order
    assert late and sess.completion_order == order
    assert late[0] in sess.completion_order        # completed in this drain
    assert sess.result(late[0]).se > 0
    assert np.array_equal(sess.request(late[0]).gathered_preds(),
                          _inline_preds(pliv_plan, pliv))


def test_chaos_session_books_each_invocation_once():
    plan, data = _plr(130, 11, n_rep=3)
    pool = PoolConfig(n_workers=2, memory_mb=256, failure_rate=0.4,
                      straggler_rate=0.3, max_retries=10, seed=3)
    sess = tcore.DMLSession(pool=pool, device="cpu")
    res = sess.estimate(plan, data)
    assert res.report.failures > 0
    assert res.report.bill.n_invocations == sess.request(0).ledger.n_invocations
    assert np.array_equal(sess.request(0).gathered_preds(),
                          _inline_preds(plan, data))


def test_double_ml_serverless_fits_on_its_default_backend():
    raw = make_plr_data(n_obs=90, dim_x=3, seed=0)
    with pytest.warns(DeprecationWarning):
        est = tcore.DoubleMLServerless("plr", n_folds=3, n_rep=2,
                                       device="cpu")
    assert est.plan.backend == "wave"
    res = est.fit(raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jres = rcore.DoubleMLServerless("plr", n_folds=3, n_rep=2).fit(raw)
    assert _rel(res.theta, jres.theta) < 1e-4 and _rel(res.se, jres.se) < 1e-4


class _OneStream:
    """Dispatches that land in FIFO order, as launches on one CUDA stream
    do: each takes ``WORK`` polls of the stream after the one before it,
    so a hedge's duplicate lands after its original."""
    WORK = 10

    def __init__(self):
        self.clock = 0
        self.end = 0

    def wrap(self, bd):
        self.end = max(self.end, self.clock) + self.WORK
        return _Queued(bd, self, self.end)


class _Queued:
    def __init__(self, bd, stream, lands_at):
        self._bd, self._stream, self._lands_at = bd, stream, lands_at

    def __getattr__(self, name):
        return getattr(self._bd, name)

    def ready(self) -> bool:
        self._stream.clock += 1
        return self._stream.clock >= self._lands_at


@pytest.mark.parametrize("backend", ["inline", "wave"])
def test_losing_hedge_leg_in_flight_at_retirement_is_discarded(
        monkeypatch, backend):
    """An original that is slow for real wins the race against its
    duplicate queued behind it; the session's drain completes with the
    losing leg still in flight and retires by discarding it unbooked."""
    plan, data = _plr(110, 12)
    pool = PoolConfig(hedge=True, hedge_after_s=1e-9)
    sess = tcore.DMLSession(backend=backend, pool=pool, device="cpu")
    stream = _OneStream()
    dispatch = sess.backend._dispatch
    monkeypatch.setattr(sess.backend, "_dispatch",
                        lambda *a, **kw: stream.wrap(dispatch(*a, **kw)))
    res = sess.estimate(plan, data)
    d = sess.last_run_info.dispatch
    assert d.hedges == 1 and d.hedge_wins == 0
    assert d.cancelled == 1 and d.harvested == d.dispatched - 1
    assert res.report.bill.n_invocations == sess.request(0).ledger.n_invocations
    assert np.array_equal(sess.request(0).gathered_preds(),
                          _inline_preds(plan, data))
    # the drain retired: the next request starts a fresh one
    plan2, data2 = _plr(100, 13)
    sess.estimate(plan2, data2)
    assert np.array_equal(sess.request(1).gathered_preds(),
                          _inline_preds(plan2, data2))


@pytest.mark.parametrize("hold, hedge, armed", [
    (0.0, None, False), (0.05, None, True), (0.0, True, True),
    (0.05, False, False)])
def test_hedging_on_a_cuda_stream_arms_only_where_a_duplicate_can_win(
        hold, hedge, armed):
    """On a CUDA device both legs of a race share one stream, so hedging
    is armed by default only where a straggler hold keeps the original
    not-ready; the pool's explicit choice stands; the CPU keeps the
    reference's default (armed whenever a fault plan is)."""
    import torch
    pool = PoolConfig(straggler_rate=0.2, straggler_hold_s=hold, hedge=hedge)
    for name in ("inline", "wave"):
        b = repro_torch.serverless.make_backend(name, pool=pool, device="cpu")
        state = b.begin_drain()
        assert state.chaos is not None
        assert b._hedge_armed(state) == (True if hedge is None else hedge)
        b.device = torch.device("cuda")
        assert b._hedge_armed(state) == armed

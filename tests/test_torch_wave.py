"""The wave backend (paper §4 scheduler) of the port against the JAX
package's ``WaveBackend``, on the CPU device.

Tiers:
  * exact — the schedule: ``waves``, ``wave_sizes``, ``wave_members``,
    the ledger states and attempts, the invocation ids billed with their
    ``memory_mb``; with ``simulate=True`` every ``BillingRecord``
    (duration, retry, speculative), ``response_time_s``, ``failures``
    and ``stragglers``; with ``autoscale=True`` the decisions;
  * float — predictions rtol 1e-4 / atol 1e-5, theta and se 1e-4
    relative;
  * bitwise — within the port, wave ≡ inline ≡ sharded on one device.

Two test fixtures make the two drains comparable step for step.
``lockstep`` makes every reference launch report ready at once, as a
launch on the port's CPU device does (a JAX launch on the CPU may still
be running when the next step polls it), so both queues harvest at the
same steps.  ``frozen_clock`` stops the host clock both schedulers read,
so that the measured wall (which ``_settle_wave`` adds to the response
time even under ``simulate``) is 0 on both sides and the simulated bill
is all that remains.  The reference pools take the port's ``PoolConfig``
field for field (fusion, coalescing and the page pool off).
"""
import dataclasses
import time
import types

import numpy as np
import pytest

import repro.compile.program as jax_program
import repro.core as rcore
import repro.serverless as rserverless
import repro.serverless.backends as jax_backends
import repro.serverless.dispatch as jax_dispatch
from repro.core.session import assemble_result as jax_assemble
from repro.core.session import compile_request as jax_compile
from repro.data import make_irm_data, make_plr_data

import repro_torch.core as tcore
import repro_torch.serverless.backends as torch_backends
import repro_torch.serverless.dispatch as torch_dispatch
from repro_torch.core.session import assemble_result, compile_request
from repro_torch.serverless import PoolConfig, WaveBackend, make_backend

MODELS = {"plr": (make_plr_data, 150, 5), "irm": (make_irm_data, 160, 4)}


@pytest.fixture
def lockstep(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    monkeypatch.setattr(jax_program.Launch, "is_ready", lambda self: True)


@pytest.fixture
def frozen_clock(monkeypatch, lockstep):
    clock = types.SimpleNamespace(perf_counter=lambda: 0.0, sleep=time.sleep)
    for mod in (jax_backends, jax_dispatch, torch_backends, torch_dispatch):
        monkeypatch.setattr(mod, "time", clock)


def _plans(model, scaling, n_rep=3, n_folds=3, seed=7):
    out = []
    for core in (tcore, rcore):
        kw = dict(learner="ridge", learner_params={"reg": 1.0},
                  n_folds=n_folds, n_rep=n_rep, seed=seed, scaling=scaling)
        out.append(core.DMLPlan.for_model(model, **kw))
    return out


def _data(model, seed):
    make, n, p = MODELS[model]
    raw = make(n_obs=n, dim_x=p, seed=seed)
    return tcore.DMLData.from_dict(raw), rcore.DMLData.from_dict(raw)


def _drain(jobs, pool):
    """Drain ``jobs`` [(model, scaling, data seed, n_rep)] in ONE wave
    drain on each side.  Returns (port, reference) tuples of (info,
    requests, results)."""
    tb = make_backend("wave", pool, device="cpu")
    jb = rserverless.make_backend(
        "wave", rserverless.PoolConfig(**dataclasses.asdict(pool)))
    sides = []
    for backend, side, compile_, assemble in (
            (tb, 0, compile_request, assemble_result),
            (jb, 1, jax_compile, jax_assemble)):
        reqs, plans, datas = [], [], []
        for i, (model, scaling, seed, n_rep) in enumerate(jobs):
            plan = _plans(model, scaling, n_rep=n_rep)[side]
            data = _data(model, seed)[side]
            reqs.append(compile_(plan, data, tag=f"r{i}"))
            plans.append(plan)
            datas.append(data)
        info = backend.run_requests(reqs)
        kw = {"device": "cpu"} if side == 0 else {}
        results = [assemble(p, d, r, **kw)
                   for p, d, r in zip(plans, datas, reqs)]
        sides.append((info, reqs, results))
    return sides


def _schedule(info, reqs):
    return {
        "waves": info.waves, "members": info.wave_members,
        "shared": info.shared_waves, "buckets": info.buckets,
        "reports": [(r.report.waves, r.report.wave_sizes,
                     r.report.failures, r.report.stragglers) for r in reqs],
        "status": [r.ledger.status.tolist() for r in reqs],
        "attempts": [r.ledger.attempts.tolist() for r in reqs],
        "billed": [[(b.invocation, b.memory_mb) for b in r.report.bill.records]
                   for r in reqs],
    }


def _float_tier(got, want):
    (_, treqs, tres), (_, jreqs, jres) = got, want
    for tr, jr, a, b in zip(treqs, jreqs, tres, jres):
        g, w = tr.gathered_preds(), jr.gathered_preds()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        assert abs(a.theta - b.theta) <= 1e-4 * abs(b.theta)
        assert abs(a.se - b.se) <= 1e-4 * b.se


@pytest.mark.parametrize("scaling", ["n_rep", "n_folds*n_rep"])
@pytest.mark.parametrize("model", ["plr", "irm"])
def test_wave_matches_the_reference_fault_free(lockstep, model, scaling):
    """Measured billing, fault-free, two requests sharing waves."""
    pool = PoolConfig(n_workers=2, memory_mb=512, scaling=scaling)
    got, want = _drain([(model, scaling, 1, 3), (model, scaling, 2, 2)],
                       pool)
    assert _schedule(*got[:2]) == _schedule(*want[:2])
    assert got[0].waves >= 3 and got[0].shared_waves >= 1
    _float_tier(got, want)
    for r in got[1]:
        assert r.ledger.complete
        assert all(b.duration_s >= 0 for b in r.report.bill.records)


CHAOS_POOLS = {
    "sim-fault-free": dict(simulate=True, base_work_s=0.35),
    "sim-chaos": dict(simulate=True, base_work_s=0.35, failure_rate=0.3,
                      straggler_rate=0.3, max_retries=10, seed=5),
    "measured-chaos": dict(failure_rate=0.4, straggler_rate=0.3,
                           max_retries=10, seed=3),
}


@pytest.mark.parametrize("name", list(CHAOS_POOLS))
def test_simulated_bills_and_faults_match_the_reference(frozen_clock, name):
    pool = PoolConfig(n_workers=3, memory_mb=256, hedge=False,
                      **CHAOS_POOLS[name])
    got, want = _drain([("plr", "n_rep", 1, 4), ("irm", "n_rep", 3, 2)],
                       pool)
    assert _schedule(*got[:2]) == _schedule(*want[:2])
    for tr, jr in zip(got[1], want[1]):
        assert [dataclasses.astuple(b) for b in tr.report.bill.records] == \
            [dataclasses.astuple(b) for b in jr.report.bill.records]
        assert tr.report.response_time_s == jr.report.response_time_s
        assert tr.report.fit_time_s == jr.report.fit_time_s
        assert tr.report.bill.total_gb_s == jr.report.bill.total_gb_s
    _float_tier(got, want)
    reps = [r.report for r in got[1]]
    if "chaos" in name:
        assert sum(r.failures for r in reps) > 0
        assert sum(r.stragglers for r in reps) > 0
        assert any(b.retry for r in reps for b in r.bill.records)
    if pool.simulate:
        assert all(r.response_time_s > 0 for r in reps)


def test_autoscale_decisions_match_the_reference(frozen_clock):
    pool = PoolConfig(memory_mb=256, autoscale=True, simulate=True,
                      base_work_s=0.35, min_workers=1, max_workers=8,
                      hedge=False)
    got, want = _drain([("plr", "n_rep", 1, 6), ("plr", "n_folds*n_rep", 2, 2)],
                       pool)
    assert _schedule(*got[:2]) == _schedule(*want[:2])
    gd = [dataclasses.asdict(d) for d in got[0].autoscale]
    jd = [dataclasses.asdict(d) for d in want[0].autoscale]
    assert gd == jd
    assert len(gd) == got[0].waves and {d["priced_by"] for d in gd} == \
        {"simulate"}


def test_worker_schedule_matches_the_reference(lockstep):
    pool = PoolConfig(n_workers=4, memory_mb=256,
                      worker_schedule=(4, 1, 2, 8, 8, 8, 8, 8))
    got, want = _drain([("plr", "n_rep", 1, 4)], pool)
    assert _schedule(*got[:2]) == _schedule(*want[:2])
    assert got[1][0].report.wave_sizes[:3] == [4, 1, 2]
    _float_tier(got, want)


def test_retry_budget_exhausted_raises_as_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    pool = PoolConfig(n_workers=2, failure_rate=1.0, max_retries=0, seed=1)
    (tp, jp), (td, jd) = _plans("plr", "n_rep"), _data("plr", 1)
    with pytest.raises(RuntimeError, match="retry budget"):
        WaveBackend(pool, device="cpu").run_requests([compile_request(tp, td)])
    with pytest.raises(RuntimeError, match="retry budget"):
        rserverless.WaveBackend(
            rserverless.PoolConfig(**dataclasses.asdict(pool))
        ).run_requests([jax_compile(jp, jd)])


@pytest.mark.parametrize("pool_kw", [
    dict(n_workers=1, memory_mb=256),
    dict(n_workers=3, memory_mb=512, scaling="n_folds*n_rep"),
    dict(n_workers=2, failure_rate=0.3, straggler_rate=0.3, max_retries=10,
         seed=4),
])
def test_wave_inline_sharded_bitwise_within_the_port(monkeypatch, pool_kw):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    pool = PoolConfig(**pool_kw)
    outs = []
    for name in ("wave", "inline", "sharded"):
        tp, _ = _plans("irm", pool.scaling)
        td, _ = _data("irm", 5)
        req = compile_request(tp, td)
        info = make_backend(name, pool, device="cpu").run_requests([req])
        assert info.dispatch.harvested >= info.dispatch.dispatched - \
            info.dispatch.cancelled
        res = assemble_result(tp, td, req, device="cpu")
        outs.append((req.gathered_preds(), res.theta, res.se))
    for preds, theta, se in outs[1:]:
        assert np.array_equal(preds, outs[0][0])
        assert (theta, se) == outs[0][1:]


def test_inline_under_chaos_matches_the_reference(lockstep):
    """The inline backend books fault verdicts per bucket slice, as the
    reference's does: the same failures, stragglers and ledger."""
    pool = PoolConfig(failure_rate=0.3, straggler_rate=0.2, max_retries=10,
                      seed=6, hedge=False)
    res = []
    for side, backend in ((0, make_backend("inline", pool, device="cpu")),
                          (1, rserverless.make_backend(
                              "inline", rserverless.PoolConfig(
                                  **dataclasses.asdict(pool))))):
        plan = _plans("plr", "n_rep", n_rep=4)[side]
        data = _data("plr", 8)[side]
        req = (compile_request, jax_compile)[side](plan, data)
        backend.run_requests([req])
        res.append((req.report.failures, req.report.stragglers,
                    req.ledger.attempts.tolist(), req.report.wave_sizes,
                    req.gathered_preds()))
    assert res[0][:4] == res[1][:4] and res[0][0] > 0
    np.testing.assert_allclose(res[0][4], res[1][4], rtol=1e-4, atol=1e-5)


def test_hedged_straggler_race_books_once(monkeypatch):
    """A held straggler bucket past its deadline gets a duplicate; the
    race books each invocation once and the estimate is the fault-free
    one."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    tp, _ = _plans("plr", "n_rep")
    td, _ = _data("plr", 9)
    clean = compile_request(tp, td)
    make_backend("inline", device="cpu").run_requests([clean])
    pool = PoolConfig(n_workers=2, memory_mb=512, straggler_rate=0.5,
                      straggler_hold_s=0.03, hedge=True, hedge_after_s=0.002,
                      seed=2)
    req = compile_request(tp, td)
    info = WaveBackend(pool, device="cpu").run_requests([req])
    d = info.dispatch
    assert d.hedges >= 1 and d.cancelled == d.hedges
    assert d.harvested == d.dispatched - d.cancelled
    assert req.report.bill.n_invocations == req.ledger.n_invocations
    assert np.array_equal(req.gathered_preds(), clean.gathered_preds())


def test_topology_still_raises_and_pool_refusals():
    """The topology backend still raises; the three pool settings that
    were refused run on the wave backend, each bit for bit the per-block
    drain."""
    with pytest.raises(NotImplementedError):
        make_backend("topology", device="cpu")
    tp, _ = _plans("plr", "n_rep", n_rep=6)
    td, _ = _data("plr", 3)
    per_block = PoolConfig(fuse=False, coalesce=False, page_pool_bytes=0)
    ref = compile_request(tp, td)
    WaveBackend(per_block, device="cpu").run_requests([ref])
    for field, value in (("fuse", True), ("coalesce", True),
                         ("page_pool_bytes", 1 << 20)):
        req = compile_request(tp, td)
        WaveBackend(dataclasses.replace(per_block, **{field: value}),
                    device="cpu").run_requests([req])
        assert np.array_equal(req.gathered_preds(), ref.gathered_preds())

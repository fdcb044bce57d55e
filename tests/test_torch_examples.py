"""The port's example twins (``examples/*_torch.py``) against the JAX
package's examples, on the CPU at a reduced size.

The reference examples print and return nothing, so each is run through
its own function with its ``estimate`` (or ``DMLSession``) wrapped to
keep what it computed.  Tiers:
  * exact — waves, shared waves, invocations and the simulated bills
    (billed GB-s, response times), with the reference's launches forced
    ready and both packages' clocks frozen, as tests/test_torch_wave.py
    does;
  * float — theta and se of the ridge requests within 1e-4 relative;
  * measured — kernel_ridge (the quickstart and the session's second
    request) at ROADMAP Queue 3's Nyström tolerance, ``KR_TOL``.
"""
import time
import types

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import examples.quickstart as jquickstart
import examples.serverless_scaling as jscaling
import examples.session_batching as jsession
import repro.compile.program as jax_program
import repro.serverless.backends as jax_backends
import repro.serverless.dispatch as jax_dispatch

import examples.quickstart_torch as tquickstart
import examples.serverless_scaling_torch as tscaling
import examples.session_batching_torch as tsession
import repro_torch.serverless.backends as torch_backends
import repro_torch.serverless.dispatch as torch_dispatch

# kernel_ridge's measured tier (ROADMAP Queue 3, Nystrom conditioning):
# Kmm of the bonus data is singular but for its jitter (condition 1.9e8),
# so the float32 fits of the two packages part although their landmarks
# are equal.  On the quickstart at M 2 on the CPU the predictions differ
# by up to 0.069 (of 3.1), the per-repetition thetas by 0.025 se, theta by
# 0.019 se, se by 2.9e-4 relative and the bootstrap interval's ends by
# 0.014 se.  Held at about twice that: (theta in se, se relative, the
# bootstrap interval's ends in se).
KR_TOL = (0.05, 1e-3, 0.03)


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    monkeypatch.setattr(jax_program.Launch, "is_ready", lambda self: True)
    clock = types.SimpleNamespace(perf_counter=lambda: 0.0, sleep=time.sleep)
    for mod in (jax_backends, jax_dispatch, torch_backends, torch_dispatch):
        monkeypatch.setattr(mod, "time", clock)


def _kept(monkeypatch, module, name):
    """Wrap ``module.name`` (a callable) to keep every value it returns."""
    kept = []
    fn = getattr(module, name)

    def keep(*a, **kw):
        kept.append(fn(*a, **kw))
        return kept[-1]
    monkeypatch.setattr(module, name, keep)
    return kept


def _bills(res):
    s = res.report.summary()
    return (s["invocations"], s["waves"], s["billed_gb_s"],
            res.report.response_time_s)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _kr_tier(got, want):
    theta_se, se_rel, boot_se = KR_TOL
    assert np.abs(got.thetas - want.thetas).max() <= theta_se * want.se
    assert abs(got.theta - want.theta) <= theta_se * want.se
    assert _rel(got.se, want.se) <= se_rel
    if want.boot_ci is not None:
        assert max(abs(g - w) for g, w in zip(got.boot_ci, want.boot_ci)) \
            <= boot_se * want.se


def test_twins_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    for call in (lambda: tquickstart.run(n_rep=1),
                 lambda: tscaling.run_sweep(n_rep=1, repeats=1),
                 lambda: tsession.run()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_quickstart_twin_matches_the_reference(frozen, monkeypatch, capsys):
    kept = _kept(monkeypatch, jquickstart, "estimate")
    jquickstart.main(n_rep=2)
    (want,) = kept
    data, got = tquickstart.run(n_rep=2, device="cpu")
    assert (data.n_obs, data.dim_x) == (5099, 17)
    assert _bills(got) == _bills(want)
    _kr_tier(got, want)
    out = capsys.readouterr().out
    assert "theta_hat" in out


def test_scaling_twin_matches_the_reference(frozen, monkeypatch):
    """The Fig. 3 sweep at M 2, one repeat: the same simulated times and
    bills at every grid point, thetas at the float tier."""
    kept = _kept(monkeypatch, jscaling, "estimate")
    want_rows = jscaling.run_sweep(n_rep=2, repeats=1)
    got_rows, got = tscaling.run_sweep(n_rep=2, repeats=1, device="cpu")
    assert got_rows == want_rows
    assert len(got) == len(kept) == 8
    for g, w in zip(got, kept):
        assert _bills(g) == _bills(w)
        assert _rel(g.theta, w.theta) <= 1e-4 and _rel(g.se, w.se) <= 1e-4
    t_ps = [t for s, _, t, _ in got_rows if s == "n_rep"]
    assert all(b < a for a, b in zip(t_ps, t_ps[1:]))


def test_session_batching_twin_matches_the_reference(frozen, monkeypatch):
    sessions = _kept(monkeypatch, jsession, "DMLSession")
    solo = _kept(monkeypatch, jsession, "estimate")
    jsession.main()
    (jsess,) = sessions
    reqs, ids, got, info, got_solo = tsession.run(device="cpu")
    want = [jsess.result(rid) for rid in ids]
    jinfo = jsess.last_run_info
    assert (info.waves, info.shared_waves) == (jinfo.waves,
                                              jinfo.shared_waves)
    assert info.shared_waves >= 1
    for i, (g, w) in enumerate(zip(got + got_solo, want + solo)):
        assert _bills(g) == _bills(w), i
        if reqs[i % 3][0].nuisances[0].learner == "kernel_ridge":
            _kr_tier(g, w)
        else:
            assert _rel(g.theta, w.theta) <= 1e-4
            assert _rel(g.se, w.se) <= 1e-4

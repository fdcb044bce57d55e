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
    request) at ROADMAP Queue 3's Nyström tolerance, ``KR_TOL``;
  * exact — the serving example's generated tokens, from the reference's
    parameters cast to float32 (the twin is given the same tree).
"""
import time
import types

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import examples.quickstart as jquickstart
import examples.serve_lm as jserve
import examples.serverless_scaling as jscaling
import examples.session_batching as jsession
import repro.compile.program as jax_program
import repro.serving.engine as jax_engine
import repro.serverless.backends as jax_backends
import repro.serverless.dispatch as jax_dispatch

import examples.quickstart_torch as tquickstart
import examples.serve_lm_torch as tserve
import examples.serverless_scaling_torch as tscaling
import examples.session_batching_torch as tsession
import examples.train_lm_torch as ttrain
import repro_torch.serverless.backends as torch_backends
import repro_torch.serverless.dispatch as torch_dispatch
from repro_torch.models import params_from_numpy

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
                 lambda: tsession.run(),
                 lambda: ttrain.run(steps=1)):
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


def test_serve_lm_twin_matches_the_reference(monkeypatch, capsys):
    """The serving example on the reduced deepseek-v2-lite (its default)
    with 6 requests and 5 generated tokens: the reference's run with its
    parameters cast to float32 (its ``init_tree`` wrapped), the twin on
    the CPU given the same parameters.  The served tokens (slots refilled
    from the queue) and the batch's tokens are equal."""
    params = []
    real_init = jserve.init_tree

    def init_f32(decls, key):
        params.append(jax.tree.map(lambda a: a.astype(jnp.float32),
                                   real_init(decls, key)))
        return params[-1]
    monkeypatch.setattr(jserve, "init_tree", init_f32)
    served = _kept(monkeypatch, jax_engine.Engine, "serve_requests")
    generated = _kept(monkeypatch, jax_engine.Engine, "generate")
    argv = ["--requests", "6", "--gen", "5"]
    monkeypatch.setattr("sys.argv", ["serve_lm.py"] + argv)
    jserve.main()
    (want,) = served
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.run(requests=1)
    cfg, _, outs, res = tserve.run(
        requests=6, gen=5, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, params[0]), "cpu"))
    assert cfg.attention.is_mla and len(outs) == len(want) == 6
    for g, w in zip(outs, want):
        assert np.array_equal(g, w)
    assert np.array_equal(res.tokens, generated[-1].tokens)
    tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving reduced deepseek-v2-lite-16b (MLA latent cache)" in out


def test_serve_lm_twin_matches_the_reference_on_xlstm(monkeypatch, capsys):
    """The serving example with ``--arch xlstm-350m``: the reference's
    reduced config, which has no block (slstm_every 8 at 4 layers: an
    embedding, the final norm and the unembedding).  The reference's run
    with its parameters cast to float32, the twin on the CPU given the
    same parameters: the served tokens and the batch's are equal."""
    params = []
    real_init = jserve.init_tree

    def init_f32(decls, key):
        params.append(jax.tree.map(lambda a: a.astype(jnp.float32),
                                   real_init(decls, key)))
        return params[-1]
    monkeypatch.setattr(jserve, "init_tree", init_f32)
    served = _kept(monkeypatch, jax_engine.Engine, "serve_requests")
    generated = _kept(monkeypatch, jax_engine.Engine, "generate")
    argv = ["--arch", "xlstm-350m", "--requests", "6", "--gen", "5"]
    monkeypatch.setattr("sys.argv", ["serve_lm.py"] + argv)
    jserve.main()
    (want,) = served
    cfg, _, outs, res = tserve.run(
        "xlstm-350m", requests=6, gen=5, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, params[0]), "cpu"))
    assert cfg.family == "ssm" and len(outs) == len(want) == 6
    for g, w in zip(outs, want):
        assert np.array_equal(g, w)
    assert np.array_equal(res.tokens, generated[-1].tokens)
    tserve.main(argv + ["--device", "cpu"])
    assert "serving reduced xlstm-350m" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_serve_lm_twin_takes_the_cross_attention_families(arch):
    """whisper-base and the VLM need frames or image patches, which
    ``serve_requests`` does not pass (nor does the reference's): the twin
    serves no queue for them and generates the batch with inputs drawn
    from a seed, the same tokens twice."""
    cfg, prompts, outs, res = tserve.run(arch, requests=3, gen=3,
                                         device="cpu")
    assert cfg.name == arch and outs == [] and len(prompts) == 3
    assert res.tokens.shape == (3, 3)
    _, _, _, again = tserve.run(arch, requests=3, gen=3, device="cpu")
    assert np.array_equal(res.tokens, again.tokens)


def test_train_lm_twin_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """The training twin, reduced, on the CPU: six steps with a checkpoint
    every three; resumed from step 3's checkpoint alone, it ends with the
    uninterrupted run's parameters and optimizer state, bit for bit."""
    import shutil
    from repro_torch.models.param import tree_leaves
    full = tmp_path / "full"
    _, params, opt, hist, start = ttrain.run(
        steps=6, ckpt_dir=str(full), device="cpu", log_every=1,
        ckpt_every=3)
    assert start == 0 and [h["step"] for h in hist] == list(range(1, 7))
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    part = tmp_path / "part"
    part.mkdir()
    shutil.copy(full / "ckpt_00000003.msgpack", part)
    _, params2, opt2, hist2, start2 = ttrain.run(
        steps=6, ckpt_dir=str(part), resume=True, device="cpu",
        log_every=1, ckpt_every=3)
    assert start2 == 3 and [h["step"] for h in hist2] == [4, 5, 6]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[3:]]
    for a, b in zip(tree_leaves({"p": params, "o": opt}),
                    tree_leaves({"p": params2, "o": opt2})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ttrain.main(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path / "cli")])
    assert "loss:" in capsys.readouterr().out

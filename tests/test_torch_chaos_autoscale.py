"""The port's copies of the framework-free serverless modules against the
JAX package's originals, exact tier: the chaos fault plan (verdicts,
backoff, ``REPRO_CHAOS``), the occupancy and topology autoscalers, and
the paper's §5 configuration constants."""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.configs import dml_plr_bonus as jax_bonus
from repro.serverless import PoolConfig as JaxPool
from repro.serverless import autoscale as jax_autoscale
from repro.serverless import chaos as jax_chaos

from repro_torch.configs import dml_plr_bonus as torch_bonus
from repro_torch.serverless import PoolConfig
from repro_torch.serverless import autoscale as torch_autoscale
from repro_torch.serverless import chaos as torch_chaos

PLANS = [
    dict(failure_rate=0.3, straggler_rate=0.2, straggler_slowdown=4.0,
         simulate=True, seed=5),
    dict(failure_rate=0.5, straggler_rate=0.5, straggler_slowdown=2.5,
         simulate=False, seed=0, backoff_base_s=0.01, backoff_cap_s=0.05),
    dict(failure_rate=0.1, straggler_rate=0.0, straggler_slowdown=4.0,
         simulate=True, seed=123456789, backoff_base_s=0.002),
]


@pytest.mark.parametrize("kw", PLANS, ids=["sim", "measured", "bigseed"])
def test_verdicts_and_backoff_equal_the_reference(kw):
    got = torch_chaos.ChaosPlan(**kw)
    want = jax_chaos.ChaosPlan(**kw)
    for slot in range(3):
        for inv in range(0, 40, 3):
            for att in range(3):
                g, w = got.verdict(slot, inv, att), want.verdict(slot, inv, att)
                assert (g.failed, g.straggler, g.noise) == \
                    (w.failed, w.straggler, w.noise)
    for att in range(8):
        assert got.backoff_s(att) == want.backoff_s(att)


def test_verdicts_hit_both_outcomes():
    """The grid above is not vacuous: at these rates some invocations
    fail and straggle, and a failure fires on attempt 0 only."""
    plan = torch_chaos.ChaosPlan(**PLANS[0])
    vs = [plan.verdict(0, inv, att) for inv in range(60) for att in (0, 1)]
    assert any(v.failed for v in vs) and any(v.straggler for v in vs)
    assert not any(plan.verdict(0, inv, 1).failed for inv in range(60))
    assert len({v.noise for v in vs}) > 1


@pytest.mark.parametrize("raw", ["", "0", "1", "fail=0.25",
                                 "fail=0.2,strag=0.4", "strag=0.05,bogus=3"])
def test_env_chaos_rates_equal_the_reference(monkeypatch, raw):
    monkeypatch.setenv("REPRO_CHAOS", raw)
    assert torch_chaos.env_chaos_rates() == jax_chaos.env_chaos_rates()
    tp = torch_chaos.chaos_plan(PoolConfig())
    jp = jax_chaos.chaos_plan(JaxPool())
    if jp is None:
        assert tp is None
    else:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("pool_kw", [
    dict(failure_rate=0.3, seed=7, retry_backoff_s=0.01),
    dict(simulate=True, base_work_s=0.35, memory_mb=2048),
    dict(),
])
def test_chaos_plan_of_a_pool_equals_the_reference(monkeypatch, pool_kw):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    tp = torch_chaos.chaos_plan(PoolConfig(**pool_kw))
    jp = jax_chaos.chaos_plan(JaxPool(**pool_kw))
    assert (tp is None) == (jp is None)
    if jp is not None:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def _script(scaler):
    """One scripted sequence of observe/decide calls."""
    out = [scaler.decide(100, tasks_per_invocation=5, padding_waste=0.1,
                         roofline_inv_s=lambda: 0.02)]
    out.append(scaler.decide(40, tasks_per_invocation=5, in_flight=32,
                             roofline_inv_s=None))
    scaler.observe(0.0)                     # ignored
    scaler.observe(0.05)
    scaler.observe(0.2)
    out.append(scaler.decide(7, tasks_per_invocation=1, padding_waste=0.5,
                             in_flight=3, roofline_inv_s=0.001))
    out.append(scaler.decide(0))
    return out


@pytest.mark.parametrize("pool_kw", [
    dict(autoscale=True, min_workers=1, max_workers=64),
    dict(autoscale=True, min_workers=3, max_workers=40, memory_mb=512,
         autoscale_cost_weight=5.0),
    dict(autoscale=True, simulate=True, base_work_s=0.35, memory_mb=2048),
])
def test_occupancy_autoscaler_decisions_equal_the_reference(pool_kw):
    got = _script(torch_autoscale.OccupancyAutoscaler(PoolConfig(**pool_kw)))
    want = _script(jax_autoscale.OccupancyAutoscaler(JaxPool(**pool_kw)))
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    assert {d.priced_by for d in got} <= {"simulate", "ema", "roofline",
                                          "unit"}


def test_topology_autoscaler_decisions_equal_the_reference():
    pool_kw = dict(autoscale=True, max_workers=16)
    got = torch_autoscale.TopologyAutoscaler(PoolConfig(**pool_kw), 3)
    want = jax_autoscale.TopologyAutoscaler(JaxPool(**pool_kw), 3)
    for s in (got, want):
        s.decide(0, 50, tasks_per_invocation=5)
        s.observe(1, 0.03)
        s.decide(1, 12, in_flight=4, roofline_inv_s=0.5)
        s.decide(2, 300, padding_waste=0.25, roofline_inv_s=lambda: 0.01)
        s.decide(0, 9)
    assert [dataclasses.asdict(d) for d in got.decisions] == \
        [dataclasses.asdict(d) for d in want.decisions]
    assert [d.host for d in got.decisions] == [0, 0, 1, 2]


def test_paper_configuration_equals_the_reference():
    assert dataclasses.asdict(torch_bonus.CONFIG) == \
        dataclasses.asdict(jax_bonus.CONFIG)
    assert torch_bonus.FIG3_MEMORY_GRID == jax_bonus.FIG3_MEMORY_GRID
    assert torch_bonus.FIG3_SCALING_GRID == jax_bonus.FIG3_SCALING_GRID
    assert torch_bonus.PAPER_TABLE1 == jax_bonus.PAPER_TABLE1
    assert torch_bonus.USD_PER_GB_S == jax_bonus.USD_PER_GB_S
    cfg = torch_bonus.CONFIG
    assert (cfg.n_folds, cfg.n_rep, cfg.model) == (5, 100, "plr")
    assert np.isclose(torch_bonus.USD_PER_GB_S, 1.66667e-5)

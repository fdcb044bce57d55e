"""The port's non-blocking dispatch queue (``serverless/dispatch.py``)
against the JAX package's, exact tier.

Both queues are driven by the same scripts over fake bucket dispatches
whose ``ready()`` the test sets: out-of-order harvest, two in-flight
buckets with one key, the in-flight cap forcing a harvest, a hedge race
settled by each leg in turn (the loser is discarded and never booked),
``abandon`` and ``overdue``.  The harvest order, the bucket states and
every count of ``DispatchStats`` must be the same; the time fields are
host-clock readings and are only checked for sign.  Then the real thing
on the CPU device: a ``BucketDispatch`` is armed once.
"""
import numpy as np
import pytest
import torch

from repro.serverless import dispatch as jax_dispatch

from repro_torch.compile import ProgramCache, dispatch_bucket, plan_buckets
from repro_torch.core import DMLData, DMLPlan
from repro_torch.core.session import compile_request
from repro_torch.data import make_plr_data
from repro_torch.serverless import dispatch as torch_dispatch

COUNTS = ("dispatched", "harvested", "ready_harvests", "in_flight_peak",
          "hedges", "hedge_wins", "cancelled", "lost")


class FakeDispatch:
    """A bucket dispatch whose readiness the script sets."""

    def __init__(self, name, key, entries):
        self.name, self.key, self.entries = name, key, entries
        self.is_ready = False
        self.armed = True
        self.discarded = False

    def ready(self):
        return self.is_ready

    def harvest(self):
        assert self.armed, f"{self.name} harvested twice"
        self.armed = False
        return {e: (self.name, e) for e in self.entries}

    def discard(self):
        assert self.armed, f"{self.name} discarded after a harvest"
        self.armed = False
        self.discarded = True


def _queue(mod, cap=8):
    booked = []

    def book(pb, res, elapsed):
        assert elapsed >= 0.0
        booked.append((pb.dispatch.name, sorted(res)))
    return mod.DispatchQueue(cap), booked, book


def _push(mod, q, book, name, key, entries, **kw):
    d = FakeDispatch(name, key, entries)
    pb = mod.PendingBucket(dispatch=d, **kw)
    q.push(pb, book)
    return d, pb


def _counts(q):
    s = q.stats
    assert s.wait_s >= 0 and s.host_overlap_s >= 0 and s.hedge_waste_s >= 0
    return {k: getattr(s, k) for k in COUNTS}


def scenario_out_of_order(mod):
    q, booked, book = _queue(mod)
    a, _ = _push(mod, q, book, "a", "k1", [(0, 0), (0, 1)])
    b, _ = _push(mod, q, book, "b", "k2", [(0, 2)])
    c, _ = _push(mod, q, book, "c", "k3", [(1, 0)])
    assert q.in_flight == 4
    assert q.in_flight_entries() == {(0, 0), (0, 1), (0, 2), (1, 0)}
    trace = [q.harvest_ready(book)]             # nothing landed yet
    c.is_ready = a.is_ready = True
    trace.append(q.harvest_ready(book))          # a and c, b still out
    trace.append(len(q))
    q.harvest_all(book)                          # b, blocking
    return booked, trace, _counts(q)


def scenario_same_key(mod):
    q, booked, book = _queue(mod)
    d1, _ = _push(mod, q, book, "d1", "k", [(0, 0), (0, 1)])
    d2, _ = _push(mod, q, book, "d2", "k", [(0, 2), (0, 3)])
    d2.is_ready = True
    trace = [q.harvest_ready(book), len(q)]
    q.harvest_all(book)
    return booked, trace, _counts(q)


def scenario_cap(mod):
    q, booked, book = _queue(mod, cap=2)
    trace = []
    for i in range(5):
        _push(mod, q, book, f"b{i}", f"k{i}", [(0, i)])
        trace.append((len(q), len(booked)))
    q.harvest_all(book)
    return booked, trace, _counts(q)


def _race(mod, winner):
    q, booked, book = _queue(mod)
    orig, pb = _push(mod, q, book, "orig", "k", [(0, 0), (0, 1)],
                     deadline_s=0.0)
    other, _ = _push(mod, q, book, "other", "k2", [(0, 2)])
    trace = [[p.dispatch.name for p in q.overdue(now=pb.t_dispatch + 1.0)]]
    dup = FakeDispatch("dup", "k", list(pb.entries))
    pair = mod.HedgePair()
    hpb = mod.PendingBucket(dispatch=dup, book=pb.book, is_hedge=True,
                            pair=pair)
    pair.legs = [(pb, q), (hpb, q)]
    pb.state, pb.pair = "HEDGED", pair
    q.stats.hedges += 1
    q.push(hpb)
    trace.append([p.dispatch.name for p in q.overdue(now=1e12)])
    if winner == "dup":
        dup.is_ready = True
        trace.append(q.harvest_ready(book))      # dup wins; orig cancelled
        trace.append((pb.state, hpb.state, len(q)))
        orig.is_ready = True                     # the loser lands
        trace.append(q.harvest_ready(book))      # discarded, not booked
    else:
        orig.is_ready = True
        trace.append(q.harvest_ready(book))      # orig wins; dup cancelled
        trace.append((pb.state, hpb.state, len(q)))
        dup.is_ready = True
        trace.append(q.harvest_ready(book))
    q.harvest_all(book)
    trace.append((orig.discarded, dup.discarded, pair.winner is pb))
    return booked, trace, _counts(q)


def scenario_hedge_dup_wins(mod):
    return _race(mod, "dup")


def scenario_hedge_orig_wins(mod):
    return _race(mod, "orig")


def scenario_abandon(mod):
    q, booked, book = _queue(mod)
    _push(mod, q, book, "a", "k1", [(0, 0)])
    _, pb = _push(mod, q, book, "b", "k2", [(0, 1), (0, 2)])
    pb.state = "CANCELLED"                       # a hedge loser in waiting
    _push(mod, q, book, "c", "k3", [(1, 0)])
    orphans = q.abandon()
    trace = [[(o.dispatch.name, o.state) for o in orphans], len(q), q.empty]
    return booked, trace, _counts(q)


SCENARIOS = [scenario_out_of_order, scenario_same_key, scenario_cap,
             scenario_hedge_dup_wins, scenario_hedge_orig_wins,
             scenario_abandon]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[9:] for s in SCENARIOS])
def test_queue_equals_the_reference(scenario):
    got = scenario(torch_dispatch)
    want = scenario(jax_dispatch)
    assert got == want


def test_scenarios_do_what_they_say():
    """Spot checks on the port's traces, so that agreement is not
    agreement on nothing."""
    booked, trace, counts = scenario_out_of_order(torch_dispatch)
    assert [b[0] for b in booked] == ["a", "c", "b"] and trace == [0, 2, 1]
    assert counts["ready_harvests"] == 2 and counts["harvested"] == 3
    booked, _, counts = scenario_cap(torch_dispatch)
    assert counts["in_flight_peak"] == 2 and len(booked) == 5
    for scen, win in ((scenario_hedge_dup_wins, "dup"),
                      (scenario_hedge_orig_wins, "orig")):
        booked, trace, counts = scen(torch_dispatch)
        names = [b[0] for b in booked]
        assert names.count(win) == 1 and \
            names.count({"dup": "orig", "orig": "dup"}[win]) == 0
        assert counts["cancelled"] == 1 and counts["hedges"] == 1
        assert counts["hedge_wins"] == (win == "dup")
        assert trace[0] == ["orig"] and trace[1] == []
    _, trace, counts = scenario_abandon(torch_dispatch)
    assert trace[0] == [("a", "LOST"), ("c", "LOST")]
    assert counts["lost"] == 2 and counts["cancelled"] == 1


def test_stats_merge_and_summary_equal_the_reference():
    vals = (3, 2, 1, 0.5, 0.25, 2, 1, 1, 1, 0, 0.125)
    a = torch_dispatch.DispatchStats(*vals).merge(
        torch_dispatch.DispatchStats(*vals))
    b = jax_dispatch.DispatchStats(*vals).merge(
        jax_dispatch.DispatchStats(*vals))
    assert a.summary() == b.summary()
    assert a.overlap_ratio == pytest.approx(1 / 3)


def _bucket_dispatch():
    raw = make_plr_data(n_obs=60, dim_x=3, seed=2)
    plan = DMLPlan.for_model("plr", learner="ridge", n_folds=2, n_rep=1,
                             seed=1)
    req = compile_request(plan, DMLData.from_dict(raw))
    bplan = plan_buckets([req])
    (key,) = bplan.buckets
    ents = [(0, int(i)) for i in req.ledger.pending()]
    return dispatch_bucket(bplan, ProgramCache(), key, ents,
                           device=torch.device("cpu")), ents


def test_bucket_dispatch_is_armed_once():
    """On the CPU a launch is ready at once; a harvested dispatch cannot
    be discarded or harvested again, and a discarded one cannot be
    booked."""
    bd, ents = _bucket_dispatch()
    assert bd.ready()
    res = bd.harvest()
    assert sorted(res) == sorted(ents)
    assert all(np.isfinite(v).all() for v in res.values())
    with pytest.raises(RuntimeError, match="already"):
        bd.harvest()
    with pytest.raises(RuntimeError, match="already"):
        bd.discard()
    bd2, _ = _bucket_dispatch()
    bd2.discard()
    assert bd2.launches == []
    with pytest.raises(RuntimeError, match="already"):
        bd2.harvest()

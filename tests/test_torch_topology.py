"""The topology backend of the port against the JAX package's, on the CPU.

Tiers:
  * bitwise — within the port, topology ≡ inline for every learner family
    (ridge, ols, lasso, kernel_ridge, mlp, and logistic through IRM);
  * exact — the placement policy (``place_bucket``, ``steal_choice``) on
    the same synthetic pools and queues, and the schedule of the same
    drains (per-host waves, placements, steals, the ledgers);
  * float — predictions rtol 1e-4 / atol 1e-5, theta and se 1e-4
    relative, against the reference.

The reference's launches are forced ready (``lockstep``), as a launch on
the port's CPU device is, so both sides harvest at the same steps.
Inputs come from numpy with a seed.
"""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.compile.program as jax_program
import repro.core as rcore
import repro.serverless as rserverless
import repro.sharding.policy as jpolicy
from repro.core.session import assemble_result as jax_assemble
from repro.core.session import compile_request as jax_compile
from repro.data import make_irm_data, make_plr_data

import repro_torch.core as tcore
import repro_torch.sharding.policy as tpolicy
from repro_torch.compile import PagePool, plan_buckets
from repro_torch.core.session import assemble_result, compile_request
from repro_torch.serverless import (
    InlineBackend, PoolConfig, Topology, TopologyBackend, make_backend,
)
from repro_torch.sharding.policy import place_bucket, steal_choice


@pytest.fixture
def lockstep(monkeypatch):
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    monkeypatch.setattr(jax_program.Launch, "is_ready", lambda self: True)


def _plr(n_obs, seed, *, learner="ridge", learner_params=None, n_rep=2,
         n_folds=3, core=tcore):
    data = core.DMLData.from_dict(make_plr_data(n_obs=n_obs, dim_x=5,
                                                theta=0.5, seed=seed))
    if learner_params is None:
        learner_params = {"reg": 1.0}
    plan = core.DMLPlan.for_model(
        "plr", learner=learner, learner_params=learner_params,
        n_folds=n_folds, n_rep=n_rep, seed=seed + 100)
    return plan, data


FAMILIES = [
    ("ridge", {"reg": 1.0}),
    ("ols", {}),
    ("lasso", {"reg": 0.01}),
    ("kernel_ridge", {"reg": 1.0, "n_landmarks": 32}),
    ("mlp", {"hidden": (8,), "n_steps": 20}),
]


def _family_cases(core=tcore):
    cases = [_plr(100 + 7 * i, seed=i, learner=name, learner_params=params,
                  core=core)
             for i, (name, params) in enumerate(FAMILIES)]
    cases.append((core.DMLPlan.for_model("irm", learner="ridge", n_folds=3,
                                         n_rep=2, seed=77),
                  core.DMLData.from_dict(make_irm_data(n_obs=130, dim_x=4,
                                                       theta=0.4, seed=9))))
    return cases


def _inline_preds(plan, data):
    ref = compile_request(plan, data)
    InlineBackend(device="cpu").run_requests([ref])
    return ref.gathered_preds()


def _topology(pool):
    return TopologyBackend(pool, device="cpu")


# ---------------------------------------------------------------------------
# bitwise parity vs the inline path, and the reference at the float tier
# ---------------------------------------------------------------------------
def test_topology_bitwise_parity_all_families():
    """Every learner family (logistic rides along via IRM) drained over
    two host streams — with placement, stealing, and per-host
    autoscaling live — matches a solo inline drain bit for bit."""
    cases = _family_cases()
    sess = tcore.DMLSession(backend="topology",
                            pool=PoolConfig(n_workers=2, memory_mb=256,
                                            autoscale=True, n_hosts=2),
                            device="cpu")
    rids = [sess.submit(plan, data) for plan, data in cases]
    sess.run()
    t = sess.topology_info
    assert t is not None and t.n_hosts == 2
    assert sum(h.waves for h in t.hosts) == sess.last_run_info.waves
    assert all(h.waves > 0 for h in t.hosts)       # both streams really ran
    for rid, (plan, data) in zip(rids, cases):
        np.testing.assert_array_equal(sess.request(rid).gathered_preds(),
                                      _inline_preds(plan, data))


def _schedule(info, reqs):
    t = info.topology
    return {
        "waves": info.waves, "members": info.wave_members,
        "hosts": [(h.waves, h.invocations, h.buckets_placed, h.steals)
                  for h in t.hosts],
        "placements": [(k.n_pad, k.p_pad, host, score)
                       for k, host, score in t.placements],
        "steals": t.steals,
        "status": [r.ledger.status.tolist() for r in reqs],
        "wave_sizes": [r.report.wave_sizes for r in reqs],
    }


@pytest.mark.parametrize("n_hosts,steal", [(2, True), (3, False)])
def test_topology_matches_the_reference(lockstep, n_hosts, steal):
    """The same requests on both packages' topology backends: the
    schedule exactly (per-host waves, placements with their scores,
    steals, ledgers), the estimates at the float tier."""
    pool = dict(n_hosts=n_hosts, n_workers=1, memory_mb=512, steal=steal)
    jobs = [(100, 1), (300, 2), (101, 3), (600, 4)]
    sides = []
    for core, backend, compile_, assemble, kw in (
            (tcore, _topology(PoolConfig(**pool)), compile_request,
             assemble_result, {"device": "cpu"}),
            (rcore, rserverless.TopologyBackend(
                rserverless.PoolConfig(**pool)), jax_compile,
             jax_assemble, {})):
        cases = [_plr(n, seed=s, core=core) for n, s in jobs]
        reqs = [compile_(p, d, tag=f"r{i}")
                for i, (p, d) in enumerate(cases)]
        info = backend.run_requests(reqs)
        results = [assemble(p, d, r, **kw)
                   for (p, d), r in zip(cases, reqs)]
        sides.append((info, reqs, results))
    (tinfo, treqs, tres), (jinfo, jreqs, jres) = sides
    assert _schedule(tinfo, treqs) == _schedule(jinfo, jreqs)
    assert dataclasses.asdict(tinfo.pages) == dataclasses.asdict(jinfo.pages)
    for tr, jr, a, b in zip(treqs, jreqs, tres, jres):
        g, w = tr.gathered_preds(), jr.gathered_preds()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        assert abs(a.theta - b.theta) <= 1e-4 * abs(b.theta)
        assert abs(a.se - b.se) <= 1e-4 * b.se


# ---------------------------------------------------------------------------
# the placement policy, exactly the reference's
# ---------------------------------------------------------------------------
class FakePool:
    def __init__(self, pages=(), stacks=()):
        self._p, self._s = set(pages), set(stacks)

    def resident(self, pk):
        return pk in self._p

    def stack_cached(self, pkeys):
        return tuple(pkeys) in self._s


def _random_pools(rng, keys, n_hosts):
    pools = []
    for _ in range(n_hosts):
        pages = [k for k in keys if rng.random() < 0.5]
        stacks = [(k,) for k in pages if rng.random() < 0.5]
        pools.append(FakePool(pages, stacks))
    return pools


@pytest.mark.parametrize("seed", range(6))
def test_policy_is_exactly_the_references(seed):
    """``place_bucket`` and ``steal_choice`` on the same synthetic pools,
    loads and queues give the reference's decisions field for field."""
    rng = np.random.default_rng(seed)
    keys = [("fp", 128 * (i + 1), 8) for i in range(6)]
    n_hosts = int(rng.integers(1, 5))
    pools = _random_pools(rng, keys, n_hosts)
    for _ in range(20):
        pkeys = [keys[i] for i in rng.integers(0, len(keys),
                                               rng.integers(1, 4))]
        loads = rng.integers(0, 4, n_hosts).tolist()
        got = place_bucket(pkeys, pools, loads)
        want = jpolicy.place_bucket(pkeys, pools, loads)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    bucket_keys = [f"k{i}" for i in range(8)]
    pkeys_of = {k: [keys[i] for i in rng.integers(0, len(keys), 2)]
                for k in bucket_keys}
    for _ in range(20):
        queues = {h: [k for k in bucket_keys if rng.random() < 0.4]
                  for h in range(n_hosts)}
        queues = {h: ks for h, ks in queues.items() if ks}
        got = steal_choice(queues, pools, pkeys_of.__getitem__)
        want = jpolicy.steal_choice(queues, pools, pkeys_of.__getitem__)
        assert got == want
    assert tpolicy._page_points(pools[0], keys[0]) == \
        jpolicy._page_points(pools[0], keys[0])


def test_place_bucket_scoring_and_determinism():
    """Stack-cached beats pages-resident beats cold; ties break to the
    least-loaded host, then the lowest id."""
    pk = ("fp", 128, 8)
    cold = FakePool()
    resident = FakePool(pages=[pk])
    stacked = FakePool(pages=[pk], stacks=[(pk,)])
    p = place_bucket([pk], [cold, resident, stacked], loads=[0, 0, 0])
    assert p.host == 2 and p.stacked == 1 and p.score == 2.0
    p = place_bucket([pk], [cold, resident], loads=[0, 100])
    assert p.host == 1 and p.score == 1.0   # residency outweighs load
    p = place_bucket([pk], [cold, cold], loads=[5, 3])
    assert p.host == 1                  # cold tie -> least loaded
    p = place_bucket([pk], [cold, cold], loads=[3, 3])
    assert p.host == 0                  # full tie -> lowest id


def test_steal_choice_picks_least_local_from_most_loaded():
    pools = [FakePool(pages=["a"]), FakePool()]
    queues = {0: ["ka", "kb", "kc"]}
    pick = steal_choice(queues, pools,
                        lambda k: ["a"] if k == "ka" else [k])
    assert pick == (0, "kb")            # kb/kc cold on donor; kb first
    assert steal_choice({0: ["ka"]}, pools, lambda k: [k]) is None
    assert steal_choice({}, pools, lambda k: [k]) is None


# ---------------------------------------------------------------------------
# placement follows residency
# ---------------------------------------------------------------------------
def test_routing_follows_page_residency():
    """Round 1 seeds residency (cold placement balances load); every
    later round routes each bucket back to the host holding its pages:
    steady-state hit rate 1.0, zero h2d bytes, zero cross-host fetches."""
    cases = [_plr(100 + i, seed=i) for i in range(2)] + \
            [_plr(300, seed=5), _plr(310, seed=6)]   # two N-buckets
    sess = tcore.DMLSession(backend="topology",
                            pool=PoolConfig(n_hosts=2, n_workers=8),
                            device="cpu")
    for plan, data in cases:
        sess.submit(plan, data)
    sess.run()                                      # warmup: cold placement
    cold = {key: host for key, host, _ in sess.topology_info.placements}
    topo = sess.backend.topology
    warm0 = topo.page_stats().snapshot()
    fetches0 = topo.directory.fetches
    for _ in range(3):                              # steady state
        for plan, data in cases:
            sess.submit(plan, data)
        sess.run()
        warm = {key: host for key, host, _
                in sess.topology_info.placements}
        assert warm == cold                         # residency-stable routes
    d = topo.page_stats().delta(warm0)
    assert d.bytes_h2d == 0 and d.misses == 0
    assert d.hit_rate == 1.0
    assert topo.directory.fetches == fetches0      # no cross-host traffic
    assert all(s > 0 for _, _, s in sess.topology_info.placements)


# ---------------------------------------------------------------------------
# work stealing
# ---------------------------------------------------------------------------
def _same_data_cases():
    """Several learner families over ONE dataset: distinct buckets that
    all share one feature page."""
    data = tcore.DMLData.from_dict(make_plr_data(n_obs=100, dim_x=5,
                                                 theta=0.5, seed=3))
    return [(tcore.DMLPlan.for_model("plr", learner=name,
                                     learner_params=params, n_folds=3,
                                     n_rep=2, seed=50 + i), data)
            for i, (name, params) in enumerate(FAMILIES)]


def _seed_host0_residency(backend, cases):
    """Pre-warm host 0's pool with every page the cases need, so
    residency scoring routes ALL their buckets to host 0 and leaves
    host 1 idle — the stealing scenario."""
    pool = backend.topology.hosts[0].pool
    for plan, data in cases:
        req = compile_request(plan, data)
        for key in plan_buckets([req]).buckets:
            pool._page(PagePool.page_key(req, key.n_pad, key.p_pad),
                       req, key.n_pad, key.p_pad)


def test_work_stealing_triggers_on_idle_host():
    cases = _same_data_cases()
    backend = _topology(PoolConfig(n_hosts=2, n_workers=1, memory_mb=256))
    _seed_host0_residency(backend, cases)
    reqs = [compile_request(p, d) for p, d in cases]
    info = backend.run_requests(reqs)
    t = info.topology
    assert all(host == 0 for _, host, _ in t.placements)
    assert t.steals >= 1
    assert t.hosts[1].steals >= 1 and t.hosts[1].waves >= 1
    # the stolen bucket's page arrived device-to-device, not via host
    topo = backend.topology
    assert topo.directory.fetches >= 1
    assert topo.page_stats().cross_host_fetches >= 1
    assert topo.page_stats().bytes_d2d > 0
    for req, (plan, data) in zip(reqs, cases):
        np.testing.assert_array_equal(req.gathered_preds(),
                                      _inline_preds(plan, data))


def test_fusion_under_placement_and_stealing():
    """Same-shape block fusion stays bitwise when the fused bucket is
    placed by residency, stolen by an idle host, and harvested out of
    order across host streams."""
    cases = [_plr(100 + i, seed=40 + i) for i in range(4)]  # one bucket
    backend = _topology(PoolConfig(n_hosts=2, n_workers=2, memory_mb=1024))
    _seed_host0_residency(backend, cases)
    reqs = [compile_request(p, d) for p, d in cases]
    info = backend.run_requests(reqs)
    assert backend.compiler.stats.fused_launches >= 1
    assert info.dispatch is not None
    assert info.dispatch.harvested == info.dispatch.dispatched
    assert info.dispatch.dispatched == sum(
        h.dispatch.dispatched for h in info.topology.hosts)
    for req, (plan, data) in zip(reqs, cases):
        np.testing.assert_array_equal(req.gathered_preds(),
                                      _inline_preds(plan, data))


def test_steal_disabled_keeps_buckets_on_resident_host():
    cases = _same_data_cases()
    backend = _topology(PoolConfig(n_hosts=2, n_workers=1, memory_mb=256,
                                   steal=False))
    _seed_host0_residency(backend, cases)
    reqs = [compile_request(p, d) for p, d in cases]
    info = backend.run_requests(reqs)               # pileup, no stealing
    assert info.topology.steals == 0
    assert backend.topology.directory.fetches == 0
    busy = [h for h in info.topology.hosts if h.waves > 0]
    assert [h.host_id for h in busy] == [0]         # the other stayed idle


# ---------------------------------------------------------------------------
# per-host streams from the session event loop
# ---------------------------------------------------------------------------
def test_poll_steps_host_streams_round_robin():
    """poll() advances one host stream per call; ledgers complete out of
    order across hosts; completion set matches a blocking run()."""
    cases = [_plr(n, seed=i, n_rep=2)
             for i, n in enumerate((100, 300, 600, 1200))]
    sess = tcore.DMLSession(backend="topology",
                            pool=PoolConfig(n_hosts=2, n_workers=1,
                                            memory_mb=256),
                            device="cpu")
    rids = [sess.submit(p, d) for p, d in cases]
    done = []
    for _ in range(200):
        done += sess.poll()
        if len(done) == len(rids):
            break
    assert sorted(done) == sorted(rids)
    assert all(h.waves > 0 for h in sess.topology_info.hosts)


def test_worker_schedule_honored_per_host_stream():
    """The static ramp sizes each host stream's waves by that host's own
    wave count, and the estimate is untouched."""
    backend = _topology(PoolConfig(n_hosts=2, memory_mb=256,
                                   worker_schedule=[1, 2, 8, 8]))
    plan, data = _plr(100, seed=31, n_rep=4)
    req = compile_request(plan, data)
    info = backend.run_requests([req])
    assert req.ledger.complete
    busy = [h for h in info.topology.hosts if h.waves > 0]
    assert busy and busy[0].waves >= 2          # the ramp really waved
    np.testing.assert_array_equal(req.gathered_preds(),
                                  _inline_preds(plan, data))


def test_topology_from_pod_mesh():
    """A mesh with a "pod" axis splits into one host stream per pod.  The
    port's meshes hold one device, so a pod mesh of two hosts needs two
    cards; not counted where there are fewer."""
    if torch.cuda.device_count() < 2:
        pytest.skip("a two-pod mesh needs two CUDA devices; meshes of "
                    "more than one device are not ported yet")
    from repro_torch.launch.mesh import DeviceMesh
    devs = (torch.device("cuda", 0), torch.device("cuda", 1))
    mesh = DeviceMesh(devs, (2, 1, 1), ("pod", "data", "model"))
    topo = Topology.from_mesh(mesh)
    assert len(topo) == 2
    assert topo.hosts[0].device != topo.hosts[1].device


def test_simulated_hosts_share_the_device_and_own_their_pools():
    """Every simulated host's mesh is the one-device mesh on the asked
    device; pools (and, on the card, streams) are the hosts' own; a
    pod-less mesh is one host."""
    topo = Topology.simulated(3, page_pool_bytes=1 << 20, device="cpu")
    assert len(topo) == 3
    assert {h.device for h in topo.hosts} == {torch.device("cpu")}
    assert all(h.n_devices == 1 and h.stream is None for h in topo.hosts)
    assert len({id(h.pool) for h in topo.hosts}) == 3
    assert [h.pool.host_id for h in topo.hosts] == [0, 1, 2]
    assert len(Topology.from_mesh(topo.hosts[0].mesh)) == 1
    backend = make_backend("topology", PoolConfig(n_hosts=4), device="cpu")
    assert len(backend.topology) == 4 and backend.name == "topology"


# ---------------------------------------------------------------------------
# roofline-priced autoscaling
# ---------------------------------------------------------------------------
def test_autoscaler_first_decision_roofline_priced():
    """Before any duration is observed, candidates are priced by the
    roofline estimates, the full candidate cost table is logged, and
    later waves switch to the measured EMA."""
    sess = tcore.DMLSession(backend="topology",
                            pool=PoolConfig(n_hosts=2, n_workers=2,
                                            memory_mb=256, autoscale=True,
                                            max_workers=4),
                            device="cpu")
    for i, n in enumerate((100, 300, 600)):        # distinct buckets
        sess.submit(*_plr(n, seed=i, n_rep=4))
    sess.run()
    decisions = sess.last_run_info.autoscale
    assert decisions
    assert decisions[0].priced_by == "roofline"
    assert len(decisions[0].candidate_costs) >= 2
    for w, time_s, gb_s, score in decisions[0].candidate_costs:
        assert w >= 1 and time_s > 0 and gb_s > 0 and score > 0
    assert any(d.priced_by == "ema" for d in decisions[1:])
    assert {d.host for d in decisions} == {0, 1}   # each mesh sized itself


def test_roofline_task_models_scale_sanely():
    from repro_torch.launch.roofline import (
        invocation_roofline_s, megabatch_task_flops,
    )
    for fam, params in [("ridge", {}), ("lasso", {"n_iter": 50}),
                        ("logistic", {}), ("mlp", {"hidden": (8,)}),
                        ("kernel_ridge", {"n_landmarks": 16})]:
        small = megabatch_task_flops(fam, 128, 8, params)
        big = megabatch_task_flops(fam, 512, 8, params)
        assert 0 < small < big
    assert invocation_roofline_s("ridge", {}, 6, 128, 8) == \
        2 * invocation_roofline_s("ridge", {}, 3, 128, 8)


# ---------------------------------------------------------------------------
# tall buckets and hedging across host streams
# ---------------------------------------------------------------------------
def test_tall_bucket_runs_the_data_program_on_its_host(monkeypatch):
    """A Gram bucket taller than one device page (DEVICE_PAGE_ROWS
    patched to 16) takes the data@1 program on its host, as the sharded
    backend does — same bits as the sharded backend."""
    import repro_torch.launch.roofline as troof
    monkeypatch.setattr(troof, "DEVICE_PAGE_ROWS", 16)
    plan, data = _plr(100, seed=8)
    req = compile_request(plan, data)
    info = _topology(PoolConfig(n_hosts=2)).run_requests([req])
    assert [d.executed for d in info.axis_plans] == ["data"]
    ref = compile_request(plan, data)
    make_backend("sharded", device="cpu").run_requests([ref])
    np.testing.assert_array_equal(req.gathered_preds(), ref.gathered_preds())


@pytest.mark.parametrize("n_alive,hold,hedge,armed", [
    (2, 0.0, None, False), (1, 0.0, None, False), (2, 0.05, None, True),
    (1, 0.05, None, True), (2, 0.0, False, False), (2, 0.0, True, True)])
def test_hedging_across_host_streams_arms_only_where_a_duplicate_can_win(
        n_alive, hold, hedge, armed):
    """A duplicate goes to another live host's stream, but on the card no
    such leg booked first without a straggler hold, so the topology
    backend keeps the single-stream rule: on a CUDA device hedging is
    armed by default only with a hold, however many hosts live; the
    pool's explicit choice stands; the CPU keeps the reference's default
    (armed whenever a fault plan is)."""
    pool = PoolConfig(n_hosts=2, straggler_rate=0.2, straggler_hold_s=hold,
                      hedge=hedge)
    b = _topology(pool)
    state = b.begin_drain()
    assert state.chaos is not None
    for h in range(2 - n_alive):
        b.kill_host(state, h)
    assert b._hedge_armed(state) == (True if hedge is None else hedge)
    b.device = torch.device("cuda")
    assert b._hedge_armed(state) == armed
    calm = _topology(PoolConfig(n_hosts=2))
    calm.device = torch.device("cuda")
    assert not calm._hedge_armed(calm.begin_drain())   # no chaos: never


def test_cross_host_hedge_race_books_once(monkeypatch):
    """A held straggler on host 0 is hedged onto host 1's stream; the
    duplicate wins, the original is discarded unbooked, and the bits are
    the inline drain's."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    plan, data = _plr(150, seed=4, n_rep=6)
    pool = PoolConfig(n_hosts=2, n_workers=2, memory_mb=512,
                      straggler_rate=0.5, straggler_hold_s=0.03, hedge=True,
                      hedge_after_s=0.002, seed=2)
    req = compile_request(plan, data)
    info = _topology(pool).run_requests([req])
    d = info.dispatch
    assert d.hedges >= 1 and d.cancelled == d.hedges
    assert d.harvested == d.dispatched - d.cancelled
    assert req.report.bill.n_invocations == req.ledger.n_invocations
    np.testing.assert_array_equal(req.gathered_preds(),
                                  _inline_preds(plan, data))

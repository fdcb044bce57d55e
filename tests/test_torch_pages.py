"""The device-resident page pool, its directory, tail packing and the
warm-cache registry: the port against the JAX package on the CPU.

Exact tier throughout — these are integer and bookkeeping logic: the
``PageStats`` of the same drains, ``pack_tail_blocks`` and the
``@warm_cache`` declarations must be the reference's, field for field.
Predictions, where a test looks at them, agree to rtol 1e-4 / atol 1e-5.
Inputs come from numpy with a seed.
"""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.analysis.registry as jregistry
import repro.compile.buckets as jbuckets
import repro.compile.pages as jpages
import repro.compile.persist  # noqa: F401  (registers its declarations)
import repro.core as rcore
import repro.serverless as rserverless
import repro.sharding.gram  # noqa: F401  (registers its declarations)
from repro.core.session import compile_request as jax_compile_request
from repro.data import make_plr_data

import repro_torch.analysis.registry as tregistry
import repro_torch.compile.buckets as tbuckets
import repro_torch.compile.pages as tpages
import repro_torch.compile.persist  # noqa: F401
import repro_torch.core as tcore
import repro_torch.serverless as tserverless
import repro_torch.sharding.gram  # noqa: F401
from repro_torch.compile import PageDirectory, PagePool, PageStats
from repro_torch.core.session import compile_request

CPU = torch.device("cpu")


def _plr(n_obs, seed, *, n_rep=2, n_folds=3):
    """((port plan, port data), (reference plan, reference data))."""
    raw = make_plr_data(n_obs=n_obs, dim_x=5, theta=0.5, seed=seed)
    return tuple((core.DMLPlan.for_model(
        "plr", learner="ridge", learner_params={"reg": 1.0},
        n_folds=n_folds, n_rep=n_rep, seed=seed + 100),
        core.DMLData.from_dict(raw)) for core in (tcore, rcore))


def _sessions(**pool):
    """A port session on the CPU and a reference session on the same
    pool settings (wave backend)."""
    return (tcore.DMLSession(backend="wave",
                             pool=tserverless.PoolConfig(**pool),
                             device="cpu"),
            rcore.DMLSession(backend="wave",
                             pool=rserverless.PoolConfig(**pool)))


def _asdict(stats):
    return dataclasses.asdict(stats)


# ---------------------------------------------------------------------------
# the pool's fields and constants
# ---------------------------------------------------------------------------
def test_page_stats_and_constants_match_reference():
    assert [f.name for f in dataclasses.fields(PageStats)] == \
        [f.name for f in dataclasses.fields(jpages.PageStats)]
    st = PageStats(hits=3, misses=1, bytes_h2d=8, bytes_saved=24)
    sj = jpages.PageStats(hits=3, misses=1, bytes_h2d=8, bytes_saved=24)
    assert st.summary() == sj.summary() and st.hit_rate == sj.hit_rate
    assert _asdict(st.merge(st)) == _asdict(sj.merge(sj))
    assert _asdict(st.delta(PageStats(hits=1))) == \
        _asdict(sj.delta(jpages.PageStats(hits=1)))
    assert tpages.DEFAULT_BYTE_BUDGET == jpages.DEFAULT_BYTE_BUDGET
    assert tpages.MAX_CACHED_STACKS == jpages.MAX_CACHED_STACKS


def test_page_pool_needs_a_card_unless_the_cpu_is_asked_for():
    """The pool follows the port's device rule: the card by default, which
    raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagePool()
    assert PagePool(device="cpu").device == CPU


# ---------------------------------------------------------------------------
# the reference's four page-pool tests, each against the reference
# ---------------------------------------------------------------------------
def test_page_pool_steady_state_zero_transfer():
    """Warm drains of the same datasets upload nothing: after the warm-up
    drain every page is a hit and the same compositions are reused —
    with the reference's accounting, drain for drain."""
    cases = [_plr(100 + i, seed=i) for i in range(3)]
    sessions = _sessions(n_workers=8, memory_mb=1024)
    deltas = []
    for sess, side in zip(sessions, (0, 1)):
        for case in cases:
            sess.submit(*case[side])
        sess.run()                                # warm-up: cold uploads
        pool = sess.backend.pages
        assert pool.stats.misses >= 1
        warm0 = pool.stats.snapshot()
        cold = _asdict(pool.stats)
        for _ in range(3):                        # steady state
            for case in cases:
                sess.submit(*case[side])
            sess.run()
        d = pool.stats.delta(warm0)
        assert d.bytes_h2d == 0 and d.misses == 0 and d.hits > 0
        assert d.hit_rate == 1.0 and d.stack_hits >= 1
        deltas.append((cold, _asdict(d)))
    assert deltas[0] == deltas[1]


def test_page_pool_shared_across_equal_data():
    """Two requests over equal-content datasets share one resident page
    (content fingerprint, not object identity)."""
    (tplan, tdata), (jplan, jdata) = _plr(100, seed=7)
    (tplan2, _), (jplan2, _) = _plr(100, seed=8)
    tcopy = tcore.DMLData(x=np.array(tdata.x), y=np.array(tdata.y),
                          d=np.array(tdata.d))
    jcopy = rcore.DMLData(x=np.array(jdata.x), y=np.array(jdata.y),
                          d=np.array(jdata.d))
    ts = tcore.DMLSession(backend="inline", device="cpu")
    js = rcore.DMLSession(backend="inline")
    for sess, jobs in ((ts, [(tplan, tdata), (tplan2, tcopy)]),
                       (js, [(jplan, jdata), (jplan2, jcopy)])):
        for job in jobs:
            sess.submit(*job)
        sess.run()
    assert ts.backend.pages.n_pages == js.backend.pages.n_pages == 1
    assert _asdict(ts.backend.pages.stats) == _asdict(js.backend.pages.stats)


def test_page_pool_eviction_accounting():
    """A budget of one page forces LRU evictions and re-uploads; what the
    launch in flight needs is never evicted; a larger budget then keeps
    everything resident — the reference's counts, step for step."""
    page_bytes = 104 * 8 * 4                       # N_pad=104, P_pad=8
    cases = [_plr(100 + i, seed=10 + i) for i in range(3)]
    got = []
    for side, backend, pool in (
            (0, tserverless.make_backend("inline", device="cpu"),
             PagePool(byte_budget=page_bytes, device="cpu")),
            (1, rserverless.make_backend("inline"),
             jpages.PagePool(byte_budget=page_bytes))):
        compile_fn = compile_request if side == 0 else jax_compile_request
        backend.pages = pool
        for _ in range(2):
            for case in cases:                     # one dataset per drain
                backend.run_requests([compile_fn(*case[side])])
        assert pool.stats.evictions >= 3
        assert pool.total_bytes <= 2 * page_bytes
        assert pool.stats.misses == 6 and pool.stats.hits == 0
        assert pool.stats.bytes_h2d == pool.stats.misses * page_bytes
        tight = _asdict(pool.stats)
        pool.byte_budget = 10 * page_bytes         # now everything fits
        for _ in range(2):
            for case in cases:
                backend.run_requests([compile_fn(*case[side])])
        assert pool.stats.misses == 8 and pool.stats.hits == 4
        got.append((tight, _asdict(pool.stats), pool.n_pages,
                    pool.total_bytes))
    assert got[0] == got[1]


def test_page_pool_disabled_by_budget_zero():
    (tplan, tdata), (jplan, jdata) = _plr(100, seed=12)
    ts = tcore.DMLSession(backend="inline",
                          pool=tserverless.PoolConfig(page_pool_bytes=0),
                          device="cpu")
    js = rcore.DMLSession(backend="inline",
                          pool=rserverless.PoolConfig(page_pool_bytes=0))
    rt, rj = ts.estimate(tplan, tdata), js.estimate(jplan, jdata)
    assert ts.backend.pages is None and js.backend.pages is None
    assert ts.last_run_info.pages is None
    assert abs(rt.theta - rj.theta) <= 1e-4 * abs(rj.theta)


# ---------------------------------------------------------------------------
# stacks, LRU order, the directory
# ---------------------------------------------------------------------------
def _reqs(n):
    return [compile_request(*_plr(100 + i, seed=30 + i)[0])
            for i in range(n)]


def test_stack_is_the_same_tensor_on_a_warm_repeat():
    """A multi-page composition is concatenated once, zero-padded to the
    pow2 lane count, and handed back as the very same tensor on a warm
    repeat; a singleton launch gets its resident page itself."""
    reqs = _reqs(3)
    pool = PagePool(device="cpu")
    needs = [(PagePool.page_key(r, 104, 8), r) for r in reqs]
    stack = pool.stack(needs, 104, 8)
    assert stack.shape == (4, 104, 8) and stack.dtype == torch.float32
    for i, r in enumerate(reqs):
        n = r.x.shape[0]
        assert torch.equal(stack[i, :n, :5],
                           torch.as_tensor(np.asarray(r.x, np.float32)))
        assert not stack[i, n:].any() and not stack[i, :, 5:].any()
    assert not stack[3].any()
    assert pool.stack(needs, 104, 8) is stack
    page = pool.stack(needs[:1], 104, 8)
    assert page.shape == (1, 104, 8) and torch.equal(page[0], stack[0])
    assert pool.stack(needs[:1], 104, 8) is page
    assert pool.stack_cached([pk for pk, _ in needs])
    assert (pool.stats.misses, pool.stats.stack_builds,
            pool.stats.stack_hits) == (3, 1, 3)     # resident: hits
    assert pool.total_bytes == 3 * 104 * 8 * 4 + 4 * 104 * 8 * 4


def test_stack_accounting_matches_reference():
    """The same sequence of stack calls under a tight budget books the
    reference's ``PageStats`` and keeps its residency, call for call."""
    tr = _reqs(4)
    jr = [jax_compile_request(*_plr(100 + i, seed=30 + i)[1])
          for i in range(4)]
    budget = 5 * 104 * 8 * 4
    pools = (PagePool(budget, device="cpu"), jpages.PagePool(budget))
    calls = [(0, 1), (0, 1), (2,), (1, 2, 3), (0,), (0, 1), (3,), (2, 3)]
    for pool, reqs in zip(pools, (tr, jr)):
        trace = []
        for lanes in calls:
            needs = [(type(pool).page_key(reqs[i], 104, 8), reqs[i])
                     for i in lanes]
            out = pool.stack(needs, 104, 8)
            trace.append((tuple(out.shape), pool.n_pages, pool.total_bytes,
                          _asdict(pool.stats)))
        pool.trace = trace
    assert pools[0].trace == pools[1].trace
    assert pools[0].stats.evictions > 0


def test_page_directory_two_pools_on_one_device():
    """Two pools on one device share a directory: a miss in the second is
    a device-to-device copy of the first's page (booked as a cross-host
    fetch, no upload); ``invalidate`` withdraws a pool; the reference
    books the same."""
    out = []
    for side in (0, 1):
        reqs = _reqs(1) if side == 0 else [
            jax_compile_request(*_plr(100, seed=30)[1])]
        req = reqs[0]
        if side == 0:
            directory = PageDirectory()
            pools = [PagePool(device="cpu", host_id=h, directory=directory)
                     for h in range(2)]
        else:
            directory = jpages.PageDirectory()
            pools = [jpages.PagePool(host_id=h, directory=directory)
                     for h in range(2)]
        pk = type(pools[0]).page_key(req, 104, 8)
        first = pools[0].stack([(pk, req)], 104, 8)
        assert directory.holders(pk) == {0}
        fetched = pools[1].stack([(pk, req)], 104, 8)
        if side == 0:                              # a copy, on the device
            assert fetched is not first and fetched.device == CPU
        np.testing.assert_array_equal(np.asarray(fetched), np.asarray(first))
        assert directory.holders(pk) == {0, 1}
        assert directory.fetch(pk, 1) is not None
        pools[0].invalidate()
        assert pools[0].n_pages == 0 and directory.holders(pk) == {1}
        assert directory.fetch(pk, 1) is None      # no peer holds it now
        out.append((directory.fetches, directory.bytes_fetched,
                    _asdict(pools[0].stats), _asdict(pools[1].stats)))
    assert out[0] == out[1]
    assert out[0][3]["cross_host_fetches"] == 1
    assert out[0][3]["bytes_d2d"] == 104 * 8 * 4 and \
        out[0][3]["bytes_h2d"] == 0


def test_backends_own_pools_on_their_device_and_report_them():
    """Each backend owns a pool on its device (None at budget 0), and a
    drain's ``BackendRunInfo.pages`` is that pool's ``PageStats``."""
    for name in ("inline", "wave", "sharded"):
        backend = tserverless.make_backend(name, device="cpu")
        assert backend.pages.device == CPU
        assert backend.pages.byte_budget == 256 * 1024 * 1024
        info = backend.run_requests([compile_request(*_plr(100, 1)[0])])
        assert info.pages is backend.pages.stats
        assert info.pages.misses == 1
        assert tserverless.make_backend(
            name, tserverless.PoolConfig(page_pool_bytes=0),
            device="cpu").pages is None


# ---------------------------------------------------------------------------
# exact copies: pack_tail_blocks and the warm-cache registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b_align", [1, 2, 8])
def test_pack_tail_blocks_exact(b_align):
    rng = np.random.default_rng(b_align)
    cases = [[8], [1, 1], [4, 4, 4], [31, 1], [20, 8], [12, 12, 8, 3]]
    cases += [list(rng.integers(1, 32, size=k)) for k in (2, 3, 5, 9)
              for _ in range(5)]
    for counts in cases:
        for b_block in (16, 32):
            if max(counts) > b_block:
                continue
            assert tbuckets.pack_tail_blocks(counts, b_block, 8, b_align) \
                == jbuckets.pack_tail_blocks(counts, b_block, 8, b_align), \
                (counts, b_block)


def test_registry_exact():
    """The registry is the reference's: the same spec type and decorator
    behaviour, and every warm cache the port has declares the
    reference's key, reads, covers and ambient state."""
    assert [f.name for f in dataclasses.fields(tregistry.WarmCacheSpec)] \
        == [f.name for f in dataclasses.fields(jregistry.WarmCacheSpec)]

    def fn(a, b):
        return a

    for reg in (tregistry, jregistry):
        out = reg.warm_cache(name="_probe", key=("a",), reads=("b",),
                             covers={"a": ["b"]}, ambient=("self",))(fn)
        assert out is fn
        spec = fn.__warm_cache__
        assert (spec.name, spec.key, spec.reads, dict(spec.covers),
                spec.ambient) == ("_probe", ("a",), ("b",), {"a": ("b",)},
                                  ("self",))
        assert reg.REGISTRY.pop("_probe") is spec
    # the persistent store's two tiers key the reference's triple; the
    # port's ``fingerprint`` names a kernel library (source and flags)
    # where the reference's names an XLA executable, and its ``build`` is
    # the nvcc toolkit where the reference's is the jax build
    ported = {"program_cache", "fused_program_cache", "block_layouts",
              "block_tensors", "plan_pages", "page_pool_stacks",
              "work_request_index_maps", "data_gram_programs",
              "feature_gram_programs", "fold_in_key_tables",
              "persistent_program_cache",
              "persistent_program_cache_process_tier"}
    assert ported <= set(tregistry.REGISTRY)
    for name in ported:
        t, j = tregistry.REGISTRY[name], jregistry.REGISTRY[name]
        assert (t.key, t.reads, dict(t.covers), t.ambient) == \
            (j.key, j.reads, dict(j.covers), j.ambient), name
        assert t.module.startswith("repro_torch.")
        assert t.qualname == j.qualname, name


def test_registry_declares_only_caches_the_port_has():
    """A declaration sits on a function of the port, one per cache."""
    names = [n for n in tregistry.REGISTRY if not n.startswith("_")]
    assert len(names) == len(set(names))
    for name in names:
        spec = tregistry.REGISTRY[name]
        assert spec.module.startswith("repro_torch."), name
    assert set(names) <= set(jregistry.REGISTRY)

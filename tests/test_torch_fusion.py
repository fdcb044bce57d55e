"""Same-shape block fusion and cross-shape coalescing: the port's launch
scheduler (``repro_torch.compile.program``) against the JAX package's, on
the CPU.

Inputs come from numpy with a seed and go through both packages.  Two
tiers: within the port, fused, morphed, sliced and per-block launches give
the same bits (``np.array_equal``) for the families of its bitwise sets,
and the stated tolerance for the others; against the reference,
predictions agree to rtol 1e-4 / atol 1e-5 and the scheduler's integer
accounting (launches, blocks, fused launches, coalesced blocks, padding)
exactly wherever both packages take the same scheduling decision.
"""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.compile as jcompile
import repro.core as rcore
from repro.core.session import compile_request as jax_compile_request
from repro.data import make_plr_data

import repro_torch.core as tcore
from repro_torch.compile import (
    ProgramCache, dispatch_bucket, plan_buckets, program,
)
from repro_torch.compile.buckets import BucketKey
from repro_torch.core.session import compile_request
from repro_torch.learners import get_batched_learner

CPU = torch.device("cpu")
FAMILIES = [("ols", {}), ("ridge", {"reg": 1.0}), ("lasso", {"reg": 0.01}),
            ("logistic", {"reg": 1.0})]
IDS = [f for f, _ in FAMILIES]
# the morph tolerance tier (chip_smoke.py's MORPH_TOL)
MORPH_TOL = 1e-5


def _plr(n_obs, seed, *, learner="ridge", learner_params=None, n_rep=2,
         n_folds=3):
    """(port plan, port data), (reference plan, reference data) of one
    PLR request on the same numpy data."""
    raw = make_plr_data(n_obs=n_obs, dim_x=5, theta=0.5, seed=seed)
    params = {"reg": 1.0} if learner_params is None else learner_params
    out = []
    for core in (tcore, rcore):
        out.append((core.DMLPlan.for_model(
            "plr", learner=learner, learner_params=params, n_folds=n_folds,
            n_rep=n_rep, seed=seed + 100), core.DMLData.from_dict(raw)))
    return out


def _both_plans(cases):
    """Compiled requests of both packages and each side's bucket plan."""
    treqs = [compile_request(*t) for t, _ in cases]
    jreqs = [jax_compile_request(*j) for _, j in cases]
    return plan_buckets(treqs), jcompile.plan_buckets(jreqs)


def _entries(bplan):
    return [(ri, int(i)) for ri, req in enumerate(bplan.requests)
            for i in req.ledger.pending()]


def _run(bplan, entries, cache=None, **kw):
    """Dispatch and harvest one bucket slice on the CPU (port)."""
    (key,) = bplan.buckets
    cache = ProgramCache() if cache is None else cache
    return dispatch_bucket(bplan, cache, key, entries, device=CPU,
                           **kw).harvest(), cache


def _jrun(bplan, entries, **kw):
    (key,) = bplan.buckets
    cache = jcompile.ProgramCache(persist=None)
    res, _ = jcompile.run_bucket(bplan, cache, key, entries, **kw)
    return res, cache


def _close(got, want):
    assert got.keys() == want.keys()
    for e in want:
        np.testing.assert_allclose(got[e], want[e], rtol=1e-4, atol=1e-5)


def _same(got, want):
    assert got.keys() == want.keys()
    for e in want:
        np.testing.assert_array_equal(got[e], want[e])


def _stats(cache):
    st = cache.stats
    return (st.launches, st.blocks, st.fused_launches, st.coalesced_blocks,
            dataclasses.asdict(st.padding))


# ---------------------------------------------------------------------------
# canonical blocks: a task's launch never depends on how a slice is cut
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_tail_launch_b_invariance(name, params):
    """A bucket executed whole, one invocation at a time, or in ragged
    slices gives the same bits (every task launches at its canonical
    block's B); and the reference's whole-bucket predictions to the
    float tier."""
    case = _plr(100, seed=7, learner=name, learner_params=params, n_rep=4)
    tplan, jplan = _both_plans([case])
    entries = _entries(tplan)
    whole, _ = _run(tplan, entries)
    one_at_a_time, ragged = {}, {}
    for e in entries[::-1]:
        one_at_a_time.update(_run(tplan, [e])[0])
    for sl in (entries[:3], entries[3:4], entries[4:]):
        ragged.update(_run(tplan, sl)[0])
    _same(one_at_a_time, whole)
    _same(ragged, whole)
    want, _ = _jrun(jplan, entries)
    _close(whole, want)


# ---------------------------------------------------------------------------
# same-shape block fusion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_fused_multi_request_launch_bitwise_parity(name, params):
    """Equal-B blocks of different requests in one launch (one union page
    stack) give each request the bits of its own per-block launches, for
    every family — concatenated for ``FUSED_CONCAT_FAMILIES``, one call
    per block for the others — and the reference's fused drain to the
    float tier, with the same accounting."""
    cases = [_plr(97 + i, seed=10 + i, learner=name, learner_params=params,
                  n_rep=6) for i in range(3)]        # all align to N=104
    solo = {}
    for ri, case in enumerate(cases):
        tplan, _ = _both_plans([case])
        res, _ = _run(tplan, _entries(tplan), fuse=False, coalesce=False)
        solo.update({(ri, inv): v for (_, inv), v in res.items()})
    tplan, jplan = _both_plans(cases)
    entries = _entries(tplan)
    fused, cache = _run(tplan, entries, fuse=True, coalesce=False)
    assert cache.stats.fused_launches >= 1
    assert cache.stats.launches < cache.stats.blocks     # really packed
    _same(fused, solo)
    want, jcache = _jrun(jplan, entries, fuse=True, coalesce=False)
    _close(fused, want)
    assert _stats(cache)[:3] == _stats(jcache)[:3]


@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_fusion_off_matches_fused_and_launch_counts(name, params):
    """``fuse=False, coalesce=False`` is the canonical baseline (one
    launch per canonical block); coalescing packs the tails of the
    morph-bitwise families even unfused, fusion cuts the count further,
    and every variant gives the baseline's bits.  The launch accounting
    is the reference's wherever the port takes the reference's decision
    (the reference morphs logistic, the port only under a tolerance)."""
    cases = [_plr(100 + i, seed=i, learner=name, learner_params=params)
             for i in range(3)]
    tplan, jplan = _both_plans(cases)
    entries = _entries(tplan)
    res_b, cache_b = _run(tplan, entries, fuse=False, coalesce=False)
    res_u, cache_u = _run(tplan, entries, fuse=False)
    res_f, cache_f = _run(tplan, entries, fuse=True)
    assert cache_b.stats.launches == cache_b.stats.blocks
    assert cache_b.stats.coalesced_blocks == 0
    if name in program.MORPH_BITWISE_FAMILIES:
        assert cache_u.stats.launches < cache_b.stats.launches
    else:
        assert _stats(cache_u) == _stats(cache_b)
    assert cache_f.stats.launches < cache_u.stats.launches
    _same(res_u, res_b)
    _same(res_f, res_b)
    for kw, cache in (({"fuse": False, "coalesce": False}, cache_b),
                      ({"fuse": False}, cache_u), ({"fuse": True}, cache_f)):
        want, jcache = _jrun(jplan, entries, **kw)
        _close(_run(tplan, entries, **kw)[0], want)
        if name in program.MORPH_BITWISE_FAMILIES \
                or kw.get("coalesce") is False:
            assert _stats(cache) == _stats(jcache), kw


# ---------------------------------------------------------------------------
# cross-shape coalescing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_morphed_tail_launch_bitwise_parity(name, params):
    """Three 6-entry requests: two tails pack into a 16-lane launch block
    and the third is morphed up to 16 before the shapes fuse.  For the
    morph-bitwise families that is the per-block bits, at the reference's
    accounting; a tolerance-tier family keeps its canonical shapes (and
    bits) by default and morphs within the tier under
    ``morph_tolerance``."""
    cases = [_plr(97 + i, seed=20 + i, learner=name, learner_params=params)
             for i in range(3)]
    tplan, jplan = _both_plans(cases)
    entries = _entries(tplan)
    base, _ = _run(tplan, entries, fuse=False, coalesce=False)
    morphed, cache_m = _run(tplan, entries, fuse=True, coalesce=True)
    if name in program.MORPH_BITWISE_FAMILIES:
        assert cache_m.stats.coalesced_blocks >= 2
        assert cache_m.stats.launches < cache_m.stats.blocks
        _same(morphed, base)
        want, jcache = _jrun(jplan, entries, fuse=True, coalesce=True)
        assert _stats(cache_m) == _stats(jcache)
        _close(morphed, want)
        return
    assert name in program.MORPH_TOLERANCE_FAMILIES
    assert cache_m.stats.coalesced_blocks == 0
    _same(morphed, base)
    opted, cache_o = _run(tplan, entries, fuse=True, coalesce=True,
                          morph_tolerance=1e-6)
    assert cache_o.stats.coalesced_blocks >= 2
    for e in base:
        np.testing.assert_allclose(opted[e], base[e], rtol=0,
                                   atol=MORPH_TOL)
    # opted in, the port morphs as the reference always does
    want, jcache = _jrun(jplan, entries, fuse=True, coalesce=True)
    assert _stats(cache_o) == _stats(jcache)
    _close(opted, want)


@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_morph_tolerance_gate(name, params):
    """The port's three family sets: every ported family is in exactly
    one morph tier; bitwise families morph without an opt-in, tolerance
    families only under ``morph_tolerance > 0``; opaque buckets and
    unknown families never; the concatenated fused form is a subset of
    the morph-bitwise families."""
    key = BucketKey(learner=(name, tuple(sorted(params.items()))),
                    n_pad=8, p_pad=8)
    bitwise = name in program.MORPH_BITWISE_FAMILIES
    assert bitwise != (name in program.MORPH_TOLERANCE_FAMILIES)
    assert program.morph_allowed(key, 0.0) == bitwise
    assert program.morph_allowed(key, 1e-6)
    assert program.FUSED_CONCAT_FAMILIES <= program.MORPH_BITWISE_FAMILIES
    for other in (BucketKey(learner=("hypothetical", ()), n_pad=8, p_pad=8),
                  BucketKey(learner=("opaque", 1), n_pad=8, p_pad=8)):
        assert not program.morph_allowed(other, 0.0)
        assert not program.morph_allowed(other, 1.0)


@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_lanes_same_bits_at_any_batch_count(name, params):
    """The property the sets record, at the batched function: a family
    of ``FUSED_CONCAT_FAMILIES`` gives each lane the same bits in one
    call of G blocks as block by block; a morph-bitwise family the same
    bits for a lane of a call of 8, 16 or 24 lanes inside a call of 32;
    the tolerance tier stays within its bound."""
    rng = np.random.default_rng(5)
    b, n, p, g = 32, 203, 9, 3
    xs = torch.tensor(rng.normal(size=(g * b, n, p)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(g * b, n)), dtype=torch.float32)
    if name == "logistic":
        y = (y > 0).float()
    valid = torch.ones((g * b, n))
    valid[:, n - 3:] = 0.0
    w = torch.tensor(rng.random((g * b, n)) < 0.8, dtype=torch.float32)
    w = w * valid
    kd = torch.zeros((g * b, 2), dtype=torch.int64)
    fn = get_batched_learner(name, params)
    blocks = torch.cat([fn(*(a[i * b:(i + 1) * b]
                             for a in (xs, y, w, valid, kd)))
                        for i in range(g)])
    concat = fn(xs, y, w, valid, kd)
    if name in program.FUSED_CONCAT_FAMILIES:
        assert torch.equal(concat, blocks)
    np.testing.assert_allclose(concat.numpy(), blocks.numpy(), rtol=0,
                               atol=MORPH_TOL)
    for k in (8, 16, 24):
        part = fn(*(a[:k] for a in (xs, y, w, valid, kd)))
        if name in program.MORPH_BITWISE_FAMILIES:
            assert torch.equal(part, blocks[:k]), k
        np.testing.assert_allclose(part.numpy(), blocks[:k].numpy(), rtol=0,
                                   atol=MORPH_TOL)


# kernel_ridge and mlp, placed in the sets by scripts/probe_batch_bits.py
NONPARAMETRIC = [("kernel_ridge", {"reg": 1.0, "n_landmarks": 16}),
                 ("mlp", {"hidden": (8,), "n_steps": 20})]


@pytest.mark.parametrize("name,params", NONPARAMETRIC,
                         ids=[f for f, _ in NONPARAMETRIC])
def test_nonparametric_families_sets(name, params):
    """The sets as measured on the CPU and on the card: kernel_ridge keeps
    a lane's bits at any batch count, so its tails morph (as in the
    reference), but it fuses one call a block (its m + 1 feature columns
    outgrow the gathered-page budget of a concatenated call); mlp's lanes
    change bits at another batch count on the card (a call of 8 lanes
    against 32), so it is in no set: it fuses one call a block and its
    tails keep their canonical shapes even under ``morph_tolerance`` (the
    reference morphs it: ``repro/compile/program.py``
    ``MORPH_BITWISE_FAMILIES``).  Fused and coalesced drains give the
    per-block bits, and the reference's predictions to the float tier."""
    key = BucketKey(learner=(name, tuple(sorted(params.items()))),
                    n_pad=8, p_pad=8)
    morphs = name == "kernel_ridge"
    assert name not in program.FUSED_CONCAT_FAMILIES
    assert (name in program.MORPH_BITWISE_FAMILIES) == morphs
    assert name not in program.MORPH_TOLERANCE_FAMILIES
    assert program.morph_allowed(key, 0.0) == morphs
    assert program.morph_allowed(key, 1.0) == morphs
    cases = [_plr(97 + i, seed=30 + i, learner=name, learner_params=params)
             for i in range(3)]                 # three tails of 12 tasks
    tplan, jplan = _both_plans(cases)
    entries = _entries(tplan)
    base, _ = _run(tplan, entries, fuse=False, coalesce=False)
    fused, cache = _run(tplan, entries, fuse=True, coalesce=True,
                        morph_tolerance=1e-3)
    assert (cache.stats.coalesced_blocks > 0) == morphs
    assert cache.stats.fused_launches >= 1
    _same(fused, base)
    want, jcache = _jrun(jplan, entries, fuse=True, coalesce=True)
    _close(fused, want)
    if morphs:
        assert _stats(cache) == _stats(jcache)


# ---------------------------------------------------------------------------
# non-blocking dispatch and the memory bound of a fused launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_out_of_order_harvest_parity(name, params):
    """Buckets dispatched on the defaults (fused, coalesced) and harvested
    in reverse order return the bits of dispatch-and-harvest one at a
    time, and the reference's results to the float tier."""
    cases = [_plr(100, seed=0, learner=name, learner_params=params),
             _plr(300, seed=1, learner=name, learner_params=params)]
    treqs = [compile_request(*t) for t, _ in cases]
    jreqs = [jax_compile_request(*j) for _, j in cases]
    tplan, jplan = plan_buckets(treqs), jcompile.plan_buckets(jreqs)
    groups = tplan.pending_by_bucket()
    assert len(groups) == 2                        # two distinct buckets
    cache = ProgramCache()
    dispatched = [dispatch_bucket(tplan, cache, key, ents, device=CPU)
                  for key, ents in groups.items()]
    harvested = {}
    for bd in reversed(dispatched):
        harvested.update(bd.harvest())
    expected = {}
    cache2 = ProgramCache()
    for key, ents in groups.items():
        expected.update(dispatch_bucket(tplan, cache2, key, ents,
                                        device=CPU).harvest())
    _same(harvested, expected)
    want = {}
    jcache = jcompile.ProgramCache(persist=None)
    for key, ents in jplan.pending_by_bucket().items():
        want.update(jcompile.run_bucket(jplan, jcache, key, ents)[0])
    _close(harvested, want)


def test_fused_spans_bound_the_gathered_bytes(monkeypatch):
    """A fused launch gathers at most ``FUSED_GATHER_BYTES`` of pages a
    call, in runs of whole blocks (at least one); the per-block form is
    one call a block."""
    assert program.FUSED_GATHER_BYTES == 2 << 30
    block = 32 * 5104 * 32 * 4
    assert program.fused_spans(32, 32, 5104, 32, True) == [(0, 32)]
    assert program.fused_spans(3, 32, 5104, 32, False) == \
        [(0, 1), (1, 2), (2, 3)]
    # the wide configuration: 1.97 GB a block, one block a call
    assert program.fused_spans(2, 32, 60000, 256, True) == [(0, 1), (1, 2)]
    monkeypatch.setattr(program, "FUSED_GATHER_BYTES", 2 * block + 1)
    assert program.fused_spans(5, 32, 5104, 32, True) == \
        [(0, 2), (2, 4), (4, 5)]
    monkeypatch.setattr(program, "FUSED_GATHER_BYTES", 1)
    assert program.fused_spans(2, 32, 5104, 32, True) == [(0, 1), (1, 2)]


@pytest.mark.parametrize("name,params", FAMILIES, ids=IDS)
def test_fused_group_split_gives_the_same_bits(name, params, monkeypatch):
    """Sub-calls of a split fused launch give the bits of one call: the
    same slice, the gather bound cut to one block, then two."""
    cases = [_plr(97 + i, seed=40 + i, learner=name, learner_params=params,
                  n_rep=6) for i in range(3)]
    tplan, _ = _both_plans(cases)
    entries = _entries(tplan)
    one, cache_1 = _run(tplan, entries)
    assert cache_1.stats.fused_launches >= 1
    block = 32 * tplan.buckets[0].n_pad * tplan.buckets[0].p_pad * 4
    for bound in (block, 2 * block):
        monkeypatch.setattr(program, "FUSED_GATHER_BYTES", bound)
        split, cache_s = _run(tplan, entries)
        assert _stats(cache_s) == _stats(cache_1)
        _same(split, one)

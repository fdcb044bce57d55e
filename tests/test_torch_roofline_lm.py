"""The LM half of the port's ``launch/roofline.py`` and the dry run's
variant table (``sharding/policy.py``) against the JAX package's.

Tiers: exact for the probe plans, ``model_flops`` and
``analytic_extra_flops`` at every architecture and shape (integer and
float64 arithmetic in the same order); 1e-12 relative for the
least-squares solve; ``RooflineTerms`` with each side's hardware
constants divided out (the port prices one H100, the reference a TPU
v5e); the variants field for field.
"""
import dataclasses

import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

import repro.launch.roofline as jroof
from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.sharding.policy import VARIANTS as J_VARIANTS

import repro_torch.launch.roofline as troof
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.sharding.policy import VARIANTS, apply_variant

CELLS = [(a, s) for a in ARCH_NAMES for s in range(len(SHAPES))]


def test_registries_agree():
    assert ARCH_NAMES == J_ARCH_NAMES
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(s) for s in J_SHAPES]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_probe_plan_is_the_references(arch):
    got, want = troof.probe_plan(get_arch(arch)), \
        jroof.probe_plan(j_get_arch(arch))
    assert got.full_trips == want.full_trips
    assert len(got.probes) == len(want.probes)
    for (gcfg, gtrips), (wcfg, wtrips) in zip(got.probes, want.probes):
        assert gtrips == wtrips
        assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{SHAPES[s].name}" for a, s in CELLS])
def test_model_and_extra_flops_are_the_references(arch, shape):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    assert troof.model_flops(cfg, sh) == jroof.model_flops(jcfg, jsh)
    for n_dev in (1, 256):
        assert troof.analytic_extra_flops(cfg, sh, n_dev) == \
            jroof.analytic_extra_flops(jcfg, jsh, n_dev)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_solve_extrapolation_is_the_references(arch):
    got_plan, want_plan = troof.probe_plan(get_arch(arch)), \
        jroof.probe_plan(j_get_arch(arch))
    rng = np.random.default_rng(len(arch))
    costs = [{"flops": float(rng.uniform(1e12, 1e15)),
              "bytes": float(rng.uniform(1e9, 1e12)),
              "coll_all-reduce": float(rng.uniform(0, 1e9))}
             for _ in got_plan.probes]
    got = troof.solve_extrapolation(got_plan, costs)
    want = jroof.solve_extrapolation(want_plan, costs)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(abs(want[k]), 1.0), k


@pytest.mark.parametrize("values", [
    (3.2e15, 4.1e12, 0.0, 1, 2.9e15),
    (1.0e14, 9.0e13, 2.0e11, 4, 3.0e14),
    (5.0e10, 8.0e12, 7.0e12, 8, 1.0e11)])
def test_roofline_terms_are_the_references_formulas(values):
    flops, nbytes, coll, n_dev, useful = values
    got = troof.RooflineTerms(flops, nbytes, coll, n_dev, useful)
    want = jroof.RooflineTerms(flops, nbytes, coll, n_dev, useful)
    assert got.to_dict().keys() == want.to_dict().keys()
    # each side's constants divided out
    pairs = ((got.compute_s * troof.PEAK_BF16_FLOPS,
              want.compute_s * jroof.PEAK_FLOPS),
             (got.memory_s * troof.HBM_BW, want.memory_s * jroof.HBM_BW),
             (got.collective_s * troof.NVLINK_BW,
              want.collective_s * jroof.ICI_BW),
             (got.mfu_bound * got.step_s * troof.PEAK_BF16_FLOPS,
              want.mfu_bound * want.step_s * jroof.PEAK_FLOPS))
    for a, b in pairs:
        assert a == pytest.approx(b, rel=1e-15, abs=0.0)
    assert got.useful_ratio == want.useful_ratio
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.bottleneck == max(terms, key=terms.get)
    assert got.step_s == max(terms.values())


def test_lm_constants_are_the_h100s():
    assert troof.PEAK_BF16_FLOPS == 989e12
    assert troof.HBM_BW == 3.35e12
    assert troof.PEAK_FLOPS == 67e12          # the estimator's, kept


def test_variants_are_the_references():
    assert VARIANTS.keys() == J_VARIANTS.keys()
    for name, want in J_VARIANTS.items():
        got = VARIANTS[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert apply_variant(name) is got
    with pytest.raises(KeyError, match="unknown variant"):
        apply_variant("bogus")

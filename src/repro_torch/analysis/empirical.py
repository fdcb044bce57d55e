"""The JAX package's jaxpr audit (``analysis/jaxpr_audit.py``) as
empirical checks.

PyTorch runs eagerly: there is no jaxpr whose structure a pass could
read.  So each structural claim of the reference's audit becomes a
property of what the port's programs compute, checked on the CPU at a
small size (the same checks run on the card are ``chip_smoke.py``'s
fusion phase and the tests named in the README's table):

  (a) **fused ≡ single block** — a fused launch of a family in
      ``FUSED_CONCAT_FAMILIES`` gives every lane the bits of its
      per-block launch, and a lane of a family in
      ``MORPH_BITWISE_FAMILIES`` keeps its bits in a call of another
      batch count (the reference: ``fused-lowers-through-scan``,
      ``fused-body-equals-block``, ``morph-structural-b-pin``);
  (b) **no data-derived PRNG** — a kernel_ridge bucket and an mlp bucket
      drained on two datasets of the same shapes draw the same landmark
      indices and the same initial weights: the keys come only from the
      fold-in tables (``prng-key-from-runtime-data``);
  (c) **morph classes** — every family is in at most one of
      ``MORPH_BITWISE_FAMILIES`` and ``MORPH_TOLERANCE_FAMILIES``, the
      sets are disjoint and name only registry families
      (``morph-classified``; the port leaves mlp in neither, measured);
  (d) **no data-dependent shapes** — a program's outputs have the shape
      ``(key, b_pad, d_pad)`` fixes, whatever the data
      (``data-dependent-shape``);
  (e) **the axis programs' reassembly** — on one device and on a
      simulated mesh of 4 shards, data@m sums the shards' moments and
      feature@m gathers the rows: both equal the Gram of the whole rows
      (``data-axis-psums-moments``, ``feature-axis-gathers-rows``);
  (f) **the sharded-fused program wraps the fused body** — on a
      simulated mesh of 4 shards, a sharded-fused launch gives the
      predictions of the unsharded fused launch (bit for bit for the
      families of ``MORPH_BITWISE_FAMILIES``, whose lanes keep their
      bits at the shards' B/4, within 1e-6 for the others: the
      reference's sharded tier) (``sharded-fused-wraps-scan``).

Each check returns ``Finding`` records; ``run()`` is the pass
``python -m repro_torch.analysis`` runs as ``empirical``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.analysis.report import Finding
from repro_torch.compile import ProgramCache, dispatch_bucket, plan_buckets
from repro_torch.compile.buckets import BucketKey
from repro_torch.compile.program import (
    FUSED_CONCAT_FAMILIES, MORPH_BITWISE_FAMILIES, MORPH_TOLERANCE_FAMILIES,
)
from repro_torch.kernels import ops
from repro_torch.learners import get_batched_learner, kernel_ridge, mlp

CPU = torch.device("cpu")

#: the six registry families (literal, so that a dropped registry entry
#: fails a check instead of shrinking its coverage)
FAMILIES: Tuple[str, ...] = ("ols", "ridge", "lasso", "logistic",
                             "kernel_ridge", "mlp")

#: small hyperparameters that keep every check to a fraction of a second
PARAMS: Dict[str, Dict] = {
    "ols": {}, "ridge": {"reg": 1.0}, "lasso": {"reg": 0.05, "n_iter": 50},
    "logistic": {"reg": 1.0}, "kernel_ridge": {"reg": 1.0, "n_landmarks": 8},
    "mlp": {"hidden": (8,), "n_steps": 10},
}

N_PAD, P_PAD = 40, 8


def _key(family: str) -> BucketKey:
    return BucketKey((family, tuple(sorted(PARAMS[family].items()))),
                     N_PAD, P_PAD)


def _operands(seed: int, b: int, d: int = 2, g: int = 0):
    """(pages, data_idx, y, w, valid, key_data) of one launch of ``b``
    lanes over ``d`` pages (``g`` > 0: a fused launch of g blocks);
    the key data is fixed, the rest drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    lead = (g, b) if g else (b,)
    pages = torch.randn(d, N_PAD, P_PAD, generator=gen)
    didx = torch.randint(0, d, lead, generator=gen)
    y = (torch.rand(lead + (N_PAD,), generator=gen) > 0.5).float()
    w = (torch.rand(lead + (N_PAD,), generator=gen) > 0.3).float()
    valid = torch.ones(lead + (N_PAD,))
    kd = torch.arange(2 * int(np.prod(lead)), dtype=torch.int64
                      ).reshape(lead + (2,)) * 7919
    return pages, didx, y, w, valid, kd


def _thunk(family: str):
    return lambda: get_batched_learner(family, PARAMS[family])


def check_fused_equals_single_block() -> List[Finding]:
    """(a) fused launches and morphed lanes keep the per-block bits."""
    out: List[Finding] = []
    for fam in sorted(FUSED_CONCAT_FAMILIES | MORPH_BITWISE_FAMILIES):
        cache = ProgramCache(persist=None)
        key = _key(fam)
        pages, didx, y, w, valid, kd = _operands(0, 8, g=2)
        if fam in FUSED_CONCAT_FAMILIES:
            fused = cache.fused_program(key, 8, 2, 2, _thunk(fam))(
                pages, didx, y, w, valid, kd)
            single = cache.program(key, 8, 2, _thunk(fam))
            blocks = torch.stack([single(pages, didx[i], y[i], w[i],
                                         valid[i], kd[i]) for i in range(2)])
            if not torch.equal(fused, blocks):
                out.append(Finding(
                    "empirical", "fused-equals-single-block", fam,
                    "a fused launch of 2 blocks differs from the blocks' "
                    "own launches, yet the family is in "
                    "FUSED_CONCAT_FAMILIES"))
        if fam in MORPH_BITWISE_FAMILIES:
            prog32 = cache.program(key, 32, 2, _thunk(fam))
            p32 = _operands(1, 32)
            whole = prog32(*p32)
            part = cache.program(key, 8, 2, _thunk(fam))(
                p32[0], *(t[8:16] for t in p32[1:]))
            if not torch.equal(whole[8:16], part):
                out.append(Finding(
                    "empirical", "morph-b-invariance", fam,
                    "lanes 8-15 of a call of 32 differ from the same lanes "
                    "in a call of 8, yet the family is in "
                    "MORPH_BITWISE_FAMILIES"))
    return out


@contextlib.contextmanager
def _recording_draws() -> Iterator[Dict[str, List[torch.Tensor]]]:
    """Record every landmark draw of kernel_ridge and every initial
    weight set of mlp made inside the block."""
    draws: Dict[str, List[torch.Tensor]] = {"landmarks": [], "init": []}
    landmark_idx, init_mlp = kernel_ridge.landmark_idx, mlp._init_mlp

    def rec_landmarks(*a, **kw):
        idx = landmark_idx(*a, **kw)
        draws["landmarks"].append(idx.clone())
        return idx

    def rec_init(*a, **kw):
        params = init_mlp(*a, **kw)
        draws["init"].extend(p.clone() for p in params)
        return params

    kernel_ridge.landmark_idx, mlp._init_mlp = rec_landmarks, rec_init
    try:
        yield draws
    finally:
        kernel_ridge.landmark_idx, mlp._init_mlp = landmark_idx, init_mlp


def _drained_draws(family: str, data_seed: int):
    from repro_torch.core import DMLData, DMLPlan
    from repro_torch.core.session import compile_request
    from repro_torch.data import make_plr_data
    data = DMLData.from_dict(make_plr_data(n_obs=60, dim_x=4,
                                           seed=data_seed))
    plan = DMLPlan.for_model("plr", learner=family,
                             learner_params=PARAMS[family], n_folds=2,
                             n_rep=1, seed=7)
    mp = plan_buckets([compile_request(plan, data)])
    cache = ProgramCache(persist=None)
    with _recording_draws() as draws:
        for key, entries in mp.pending_by_bucket().items():
            dispatch_bucket(mp, cache, key, entries, device=CPU).harvest()
    return draws


def check_no_data_derived_prng() -> List[Finding]:
    """(b) the random draws of a drain are those of its keys only."""
    out: List[Finding] = []
    for fam, kind in (("kernel_ridge", "landmarks"), ("mlp", "init")):
        a, b = (_drained_draws(fam, s)[kind] for s in (1, 2))
        if not a or len(a) != len(b) or not all(
                torch.equal(x, y) for x, y in zip(a, b)):
            out.append(Finding(
                "empirical", "prng-key-from-runtime-data", fam,
                f"two datasets of the same shapes drew other {kind}: a "
                "draw depends on the data, not only on the fold-in keys"))
    return out


def check_morph_classes() -> List[Finding]:
    """(c) each family in at most one morph class; disjoint sets of
    registry families."""
    out: List[Finding] = []
    for name, fams in (("FUSED_CONCAT_FAMILIES", FUSED_CONCAT_FAMILIES),
                       ("MORPH_BITWISE_FAMILIES", MORPH_BITWISE_FAMILIES),
                       ("MORPH_TOLERANCE_FAMILIES",
                        MORPH_TOLERANCE_FAMILIES)):
        for fam in sorted(set(fams) - set(FAMILIES)):
            out.append(Finding("empirical", "morph-classified", fam,
                               f"{name} names no registry family"))
    for fam in sorted(MORPH_BITWISE_FAMILIES & MORPH_TOLERANCE_FAMILIES):
        out.append(Finding(
            "empirical", "morph-classified", fam,
            "in both MORPH_BITWISE_FAMILIES and MORPH_TOLERANCE_FAMILIES"))
    for fam in sorted(FUSED_CONCAT_FAMILIES - MORPH_BITWISE_FAMILIES):
        out.append(Finding(
            "empirical", "morph-classified", fam,
            "concatenated across blocks (FUSED_CONCAT_FAMILIES) but not "
            "proven to keep its bits at another batch count"))
    return out


def check_no_data_dependent_shapes() -> List[Finding]:
    """(d) outputs shaped by (key, b_pad, d_pad) alone."""
    out: List[Finding] = []
    for fam in FAMILIES:
        cache = ProgramCache(persist=None)
        key = _key(fam)
        shapes = set()
        for seed in (3, 4):
            for prog, ops_ in (
                    (cache.program(key, 8, 2, _thunk(fam)),
                     _operands(seed, 8)),
                    (cache.fused_program(key, 8, 2, 2, _thunk(fam)),
                     _operands(seed, 8, g=2))):
                try:
                    shapes.add(tuple(prog(*ops_).shape))
                except RuntimeError as e:   # a shape that broke a reshape
                    shapes.add((str(e),))
        if shapes != {(8, N_PAD), (2, 8, N_PAD)}:
            out.append(Finding(
                "empirical", "data-dependent-shape", fam,
                f"program outputs of shapes {sorted(shapes, key=str)} on two "
                f"datasets; (key, b_pad, d_pad) fixes (8, {N_PAD}) and "
                f"(2, 8, {N_PAD})"))
    return out


def check_axis_reassembly() -> List[Finding]:
    """(e) data@m sums the shards' moments, feature@m gathers the rows,
    on one device and on 4 simulated shards."""
    from repro_torch.launch.mesh import make_host_mesh, make_sim_mesh
    from repro_torch.sharding import gram
    out: List[Finding] = []
    pages, didx, y, w, _, _ = _operands(5, 4)
    xs = pages[didx]
    g_ref, b_ref = ops.batched_gram(xs, w, y)
    half = N_PAD // 2
    parts = [ops.batched_gram(xs[:, s].contiguous(), w[:, s].contiguous(),
                              y[:, s].contiguous())
             for s in (slice(0, half), slice(half, N_PAD))]
    g_sum = parts[0][0] + parts[1][0]
    tol = 1e-5 * float(g_ref.abs().max())
    for mesh in (make_host_mesh("cpu"), make_sim_mesh(4, "cpu")):
        m = mesh.shape["data"]
        for rule, (g, b) in (
                ("data-axis-sums-moments", gram.data_parallel_gram(
                    mesh, xs, w, y)),
                ("feature-axis-gathers-rows", gram.feature_parallel_gram(
                    mesh, xs, w, y))):
            err = max(float((g - g_ref).abs().max()),
                      float((g - g_sum).abs().max()),
                      float((b - b_ref).abs().max()))
            if err > tol:
                out.append(Finding(
                    "empirical", rule, "sharding/gram.py",
                    f"on {m} shards the reassembled statistics are "
                    f"{err:.3g} off the Gram of the whole rows (tolerance "
                    f"{tol:.3g})"))
    return out


def check_sharded_fused_wraps_fused_body() -> List[Finding]:
    """(f) a sharded-fused launch on 4 simulated shards gives the
    unsharded fused launch's predictions."""
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.serverless.backends import make_sharded_compiler
    out: List[Finding] = []
    for fam in FAMILIES:
        key = _key(fam)
        ops_ = _operands(6, 8, g=2)
        fused = ProgramCache(persist=None).fused_program(
            key, 8, 2, 2, _thunk(fam))(*ops_)
        sharded = make_sharded_compiler(make_sim_mesh(4, "cpu"))
        got = sharded.sharded_fused_program(key, 8, 2, 2, _thunk(fam))(
            *ops_)
        if fam in MORPH_BITWISE_FAMILIES:
            ok, tier = torch.equal(got, fused), "bit for bit"
        else:
            ok, tier = torch.allclose(got, fused, rtol=1e-6,
                                      atol=2e-6), "within 1e-6"
        if not ok or tuple(got.shape) != (2, 8, N_PAD):
            out.append(Finding(
                "empirical", "sharded-fused-wraps-scan", fam,
                f"a sharded-fused launch of 2 blocks on 4 shards is not "
                f"{tier} the unsharded fused launch"))
    return out


CHECKS = {"fused-equals-single-block": check_fused_equals_single_block,
          "no-data-derived-prng": check_no_data_derived_prng,
          "morph-classes": check_morph_classes,
          "no-data-dependent-shapes": check_no_data_dependent_shapes,
          "axis-reassembly": check_axis_reassembly,
          "sharded-fused-wraps-fused-body":
              check_sharded_fused_wraps_fused_body}


def run() -> List[Finding]:
    findings: List[Finding] = []
    for check in CHECKS.values():
        findings.extend(check())
    return findings

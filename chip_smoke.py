#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
first use), holds each kernel against its plain PyTorch version on the
card, and drives the port's paths — ``estimate`` / ``DMLSession`` on the
inline backend at the paper's own configuration and at a wide synthetic
one, and on the sharded backend at a tall one (250 000 rows, more than a
device page: the data@1 layout and its streaming Gram kernel); the
shared-X learners (``get_learner``, one ``crossfit_gram`` launch for the
paper's 1000 tasks) and the opaque-learner drain (``compile_raw_request``)
at the paper's configuration; and the default IRM plan, whose propensity
is the logistic learner.  Every phase prints one JSON line; any failure
raises and the process exits non-zero.  Without a CUDA device it exits
non-zero and prints no result.  ``--phases a,b`` runs a subset (the lines
that sum up the run are printed only by a full run).

Phases: device, build, kernels, estimate_paper, estimate_wide, session,
same_as_cpu, estimate_tall, shared_x, raw_request, estimate_irm.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np                                         # noqa: E402
import torch                                               # noqa: E402

from repro_torch import runtime                            # noqa: E402
from repro_torch.core import (                             # noqa: E402
    DMLData, DMLPlan, DMLSession, estimate,
)
from repro_torch.core.session import (                     # noqa: E402
    assemble_result, compile_raw_request, compile_request,
)
from repro_torch.data import (                             # noqa: E402
    TRUE_EFFECT, make_bonus_data, make_irm_data, make_pliv_data,
    make_plr_data,
)
from repro_torch.kernels import (                          # noqa: E402
    build, crossfit_gram, megabatch, ops,
)
from repro_torch.launch import roofline                    # noqa: E402
from repro_torch.learners import get_learner, linear       # noqa: E402
from repro_torch.serverless import make_backend            # noqa: E402

PHASES = ("device", "build", "kernels", "estimate_paper", "estimate_wide",
          "session", "same_as_cpu", "estimate_tall", "shared_x",
          "raw_request", "estimate_irm")

# NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, and plain (non tensor
# core) float32 FLOP/s — the kernels use plain FMA
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

KERNELS = {
    "batched_gram": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/megabatch.cu",
        "replaces": "src/repro/kernels/megabatch.py:65",
    },
    "batched_predict": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/megabatch.cu",
        "replaces": "src/repro/kernels/megabatch.py:167",
    },
    "batched_gram_blocked": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/megabatch.cu",
        "replaces": "src/repro/kernels/megabatch.py:116",
    },
    "crossfit_gram": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/megabatch.cu",
        "replaces": "src/repro/kernels/crossfit_gram.py:45",
    },
}
# the wrapper module of each kernel (its ``<name>_cuda`` launches it)
KERNEL_MODULES = {"batched_gram": megabatch, "batched_predict": megabatch,
                  "batched_gram_blocked": megabatch,
                  "crossfit_gram": crossfit_gram}
# (B, N, P) of every launch each driven path makes: full blocks of 32
# lanes and the aligned tail, N and P as the bucket pads them, plus the
# intercept column.  Each path asserts after its run that it built no
# program of another shape.
MAIN_SHAPE = (32, 5104, 33)
TALL_N = 250_000
PATH_SHAPES = {
    "estimate_paper": (MAIN_SHAPE, (8, 5104, 33)),
    "estimate_wide": ((32, 60000, 257), (8, 60000, 257), (24, 60000, 257)),
    "session": ((32, 5000, 33), (8, 5000, 33), (24, 5000, 33)),
    "same_as_cpu": (MAIN_SHAPE, (8, 5104, 33)),
    # the inline run (K1, K2) and the sharded run's predict (K2)
    "estimate_tall": ((32, TALL_N, 33), (8, TALL_N, 33)),
}
# the paths' shapes, then a ragged one (odd B, N and P below a tile) and
# one whose N is a multiple of the kernels' row step
SHAPES = tuple(dict.fromkeys(
    [s for shapes in PATH_SHAPES.values() for s in shapes]
    + [(5, 1003, 7), (8, 65536, 257)]))
# (B, C, Nc, P) of the streaming Gram: the tall path's launches (N 250000
# in 4 chunks of 62504 rows, not a multiple of the 64-row step), a small
# ragged one, and one whose chunks are whole steps, where it must be
# bitwise batched_gram on the merged (B, C*Nc, P)
MAIN_BLOCKED_SHAPE = (32, 4, 62504, 33)
TALL_BLOCKED_SHAPES = (MAIN_BLOCKED_SHAPE, (8, 4, 62504, 33))
BLOCKED_SHAPES = TALL_BLOCKED_SHAPES + ((5, 3, 1003, 7), (32, 4, 65536, 33))
# (T, N, P) of the shared-X Gram: the paper request's 1000 tasks in one
# call (P 17 plus the intercept), a wide one (make_plr_data(60000, 200) at
# M 4 x K 5 x L 2), a ragged one, and the opaque drain's per-lane call;
# then one whose N is a multiple of the 64-row step, where it must be
# bitwise batched_gram on x broadcast to (T, N, P)
MAIN_XFIT_SHAPE = (1000, 5099, 18)
LANE_XFIT_SHAPE = (1, 5099, 18)
XFIT_BITWISE_SHAPE = (32, 65536, 33)
XFIT_SHAPES = (MAIN_XFIT_SHAPE, (40, 60000, 201), (5, 1003, 7),
               LANE_XFIT_SHAPE, XFIT_BITWISE_SHAPE)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# timing: CUDA events around single calls, median over runs, the 50 MB L2
# flushed before each timed call ("cold") or left as the last call left it
# ("warm").  The device is kept busy while the host enqueues the call, so
# the events bracket device time and not the launch.
# ---------------------------------------------------------------------------
_flush = None


def _time_ms(fn, *, cold: bool, runs: int = 20, warmup: int = 3) -> float:
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8,
                             device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if cold:
            _flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gram_bound(b, n, p):
    nbytes = 4 * (b * n * p + 2 * b * n + b * p * p + b * p)
    # w*x, the upper triangle of G (mirrored, not recomputed), w*y, b
    flops = b * n * (p + p * (p + 1) + 1 + 2 * p)
    return nbytes, flops


def _crossfit_bound(t, n, p):
    # the shared X read once, w and y of every task, G and b written
    nbytes = 4 * (n * p + 2 * t * n + t * p * p + t * p)
    flops = t * n * (p + p * (p + 1) + 1 + 2 * p)
    return nbytes, flops


def _predict_bound(b, n, p):
    nbytes = 4 * (b * n * p + b * p + 2 * b * n)
    flops = b * n * (2 * p + 1)
    return nbytes, flops


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _errs(got, want):
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    return float(diff.max()), float(rel[want.abs() > 1e-6].max())


def phase_kernels(device):
    """Each kernel against its plain version on the card, with times."""
    gen = torch.Generator(device=device).manual_seed(20210104)
    rows = {}
    report = []
    for shape in SHAPES:
        b, n, p = shape
        xs = torch.randn(shape, generator=gen, device=device)
        y = torch.randn((b, n), generator=gen, device=device)
        w = (torch.rand((b, n), generator=gen, device=device) < 0.8).float()
        beta = torch.randn((b, p), generator=gen, device=device)
        valid = (torch.rand((b, n), generator=gen, device=device)
                 < 0.9).float()
        entry = {"shape": list(shape)}

        # ---- batched_gram -------------------------------------------------
        g, bv = ops.batched_gram(xs, w, y)
        torch.cuda.synchronize()
        g0, b0 = megabatch.batched_gram_plain(xs, w, y)
        # the two sum over N in different orders
        g_atol = 1e-4 * float(g0.abs().max())
        b_atol = 1e-4 * float(b0.abs().max())
        assert torch.allclose(g, g0, rtol=1e-4, atol=g_atol), \
            ("batched_gram G disagrees", shape, _errs(g, g0))
        assert torch.allclose(bv, b0, rtol=1e-4, atol=b_atol), \
            ("batched_gram b disagrees", shape, _errs(bv, b0))
        assert torch.equal(g, g.transpose(1, 2)), \
            ("batched_gram G is not exactly symmetric", shape)

        def gram_library():
            return (torch.bmm((xs * w.unsqueeze(-1)).transpose(1, 2), xs),
                    torch.bmm(xs.transpose(1, 2), (w * y).unsqueeze(-1)))

        gl, _ = gram_library()
        assert torch.allclose(gl, g0, rtol=1e-3, atol=10 * g_atol)
        del gl
        nbytes, flops = _gram_bound(b, n, p)
        bound, by = _bound_ms(nbytes, flops)
        abs_g, rel_g = _errs(g, g0)
        abs_b, rel_b = _errs(bv, b0)
        # both against the same sums taken in float64: float32 sums over N
        # in two different orders differ by more than either is wrong
        g64 = torch.einsum("bnp,bn,bnq->bpq", xs.double(), w.double(),
                           xs.double())
        gram = {
            "max_abs_err": max(abs_g, abs_b), "max_rel_err": max(rel_g, rel_b),
            "max_abs_G": float(g0.abs().max()),
            "abs_err_vs_f64": float((g.double() - g64).abs().max()),
            "plain_abs_err_vs_f64": float((g0.double() - g64).abs().max()),
            "ms": _time_ms(lambda: ops.batched_gram(xs, w, y), cold=True),
            "ms_warm_l2": _time_ms(lambda: ops.batched_gram(xs, w, y),
                                   cold=False),
            "plain_ms": _time_ms(
                lambda: megabatch.batched_gram_plain(xs, w, y), cold=True),
            "library_ms": _time_ms(gram_library, cold=True),
            "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "operations": flops,
        }
        del g, bv, g0, b0, g64

        # ---- batched_predict ----------------------------------------------
        out = ops.batched_predict(xs, beta, valid)
        torch.cuda.synchronize()
        out0 = megabatch.batched_predict_plain(xs, beta, valid)
        assert torch.allclose(out, out0, rtol=1e-5, atol=1e-5), \
            ("batched_predict disagrees", shape, _errs(out, out0))
        assert bool((out[valid == 0] == 0).all()), \
            ("batched_predict: valid == 0 rows are not exactly 0", shape)

        def predict_library():
            return torch.bmm(xs, beta.unsqueeze(-1)).squeeze(-1) * valid

        assert torch.allclose(predict_library(), out0, rtol=1e-4, atol=1e-4)
        nbytes, flops = _predict_bound(b, n, p)
        bound, by = _bound_ms(nbytes, flops)
        abs_o, rel_o = _errs(out, out0)
        pred = {
            "max_abs_err": abs_o, "max_rel_err": rel_o,
            "ms": _time_ms(lambda: ops.batched_predict(xs, beta, valid),
                           cold=True),
            "ms_warm_l2": _time_ms(
                lambda: ops.batched_predict(xs, beta, valid), cold=False),
            "plain_ms": _time_ms(
                lambda: megabatch.batched_predict_plain(xs, beta, valid),
                cold=True),
            "library_ms": _time_ms(predict_library, cold=True),
            "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "operations": flops,
        }
        del out, out0
        entry["batched_gram"] = gram
        entry["batched_predict"] = pred
        report.append(entry)
        if shape == MAIN_SHAPE:
            rows = {"batched_gram": gram, "batched_predict": pred}
        del xs, y, w, beta, valid
        torch.cuda.empty_cache()
    blocked, rows["batched_gram_blocked"] = _blocked_kernel_rows(device, gen)
    xfit, rows["crossfit_gram"] = _xfit_kernel_rows(device, gen)
    emit("kernels", tolerance={
        "batched_gram": "rtol 1e-4, atol 1e-4*max|G| (the two sum over N in "
                        "different orders); G == G' exactly",
        "batched_predict": "rtol 1e-5, atol 1e-5; valid == 0 rows == 0 "
                           "exactly",
        "batched_gram_blocked": "as batched_gram; bitwise batched_gram on "
                                "the merged (B, C*Nc, P) when Nc % 64 == 0",
        "crossfit_gram": "as batched_gram; bitwise batched_gram on x "
                         "broadcast to (T, N, P) at "
                         f"{list(XFIT_BITWISE_SHAPE)}"},
        timing="median of 20 single launches after 3 warm-ups, CUDA events, "
               "L2 flushed before each (ms_warm_l2: not flushed), the "
               "device kept busy while the host enqueues",
        kernels=sorted(KERNELS), shapes=report, blocked_shapes=blocked,
        crossfit_shapes=xfit)
    return rows


def _blocked_kernel_rows(device, gen):
    """The streaming Gram against its plain version (and, where its chunks
    are whole 64-row steps, bitwise against batched_gram on the merged
    tensor) at every shape of BLOCKED_SHAPES."""
    report, main = [], None
    for shape in BLOCKED_SHAPES:
        b, c, nc, p = shape
        n = c * nc
        xc = torch.randn(shape, generator=gen, device=device)
        y = torch.randn((b, c, nc), generator=gen, device=device)
        w = (torch.rand((b, c, nc), generator=gen, device=device)
             < 0.8).float()
        xm, wm, ym = xc.view(b, n, p), w.view(b, n), y.view(b, n)

        g, bv = ops.batched_gram_blocked(xc, w, y)
        torch.cuda.synchronize()
        g0, b0 = megabatch.batched_gram_blocked_plain(xc, w, y)
        g_atol = 1e-4 * float(g0.abs().max())
        b_atol = 1e-4 * float(b0.abs().max())
        assert torch.allclose(g, g0, rtol=1e-4, atol=g_atol), \
            ("batched_gram_blocked G disagrees", shape, _errs(g, g0))
        assert torch.allclose(bv, b0, rtol=1e-4, atol=b_atol), \
            ("batched_gram_blocked b disagrees", shape, _errs(bv, b0))
        assert torch.equal(g, g.transpose(1, 2)), \
            ("batched_gram_blocked G is not exactly symmetric", shape)
        g1, b1 = ops.batched_gram(xm, wm, ym)
        torch.cuda.synchronize()
        bitwise = torch.equal(g, g1) and torch.equal(bv, b1)
        if nc % 64 == 0:
            assert bitwise, ("batched_gram_blocked is not bitwise "
                             "batched_gram on the merged tensor", shape)

        def library():
            return (torch.bmm((xm * wm.unsqueeze(-1)).transpose(1, 2), xm),
                    torch.bmm(xm.transpose(1, 2), (wm * ym).unsqueeze(-1)))

        gl, _ = library()
        assert torch.allclose(gl, g0, rtol=1e-3, atol=10 * g_atol)
        g64 = torch.einsum("bnp,bn,bnq->bpq", xm.double(), wm.double(),
                           xm.double())
        nbytes, flops = _gram_bound(b, n, p)
        bound, by = _bound_ms(nbytes, flops)
        abs_g, rel_g = _errs(g, g0)
        abs_b, rel_b = _errs(bv, b0)
        row = {
            "max_abs_err": max(abs_g, abs_b), "max_rel_err": max(rel_g, rel_b),
            "max_abs_G": float(g0.abs().max()),
            "abs_err_vs_f64": float((g.double() - g64).abs().max()),
            "plain_abs_err_vs_f64": float((g0.double() - g64).abs().max()),
            "bitwise_batched_gram_merged": bitwise,
            "max_abs_diff_batched_gram_merged": float((g - g1).abs().max()),
            "ms": _time_ms(lambda: ops.batched_gram_blocked(xc, w, y),
                           cold=True),
            "ms_warm_l2": _time_ms(lambda: ops.batched_gram_blocked(xc, w, y),
                                   cold=False),
            "batched_gram_merged_ms": _time_ms(
                lambda: ops.batched_gram(xm, wm, ym), cold=True),
            "plain_ms": _time_ms(
                lambda: megabatch.batched_gram_blocked_plain(xc, w, y),
                cold=True),
            "library_ms": _time_ms(library, cold=True),
            "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "operations": flops,
        }
        report.append({"shape": list(shape), "batched_gram_blocked": row})
        if shape == MAIN_BLOCKED_SHAPE:
            main = row
        del xc, y, w, xm, wm, ym, g, bv, g0, b0, g1, b1, gl, g64
        torch.cuda.empty_cache()
    return report, main


def _xfit_kernel_rows(device, gen):
    """The shared-X Gram against its plain version, and against
    batched_gram on x broadcast to (T, N, P), at every shape of
    XFIT_SHAPES."""
    report, main = [], None
    for shape in XFIT_SHAPES:
        t, n, p = shape
        x = torch.randn((n, p), generator=gen, device=device)
        y = torch.randn((t, n), generator=gen, device=device)
        w = (torch.rand((t, n), generator=gen, device=device) < 0.8).float()
        g, bv = ops.crossfit_gram(x, w, y)
        torch.cuda.synchronize()
        g0, b0 = crossfit_gram.crossfit_gram_plain(x, w, y)
        g_atol = 1e-4 * float(g0.abs().max())
        b_atol = 1e-4 * float(b0.abs().max())
        assert torch.allclose(g, g0, rtol=1e-4, atol=g_atol), \
            ("crossfit_gram G disagrees", shape, _errs(g, g0))
        assert torch.allclose(bv, b0, rtol=1e-4, atol=b_atol), \
            ("crossfit_gram b disagrees", shape, _errs(bv, b0))
        assert torch.equal(g, g.transpose(1, 2)), \
            ("crossfit_gram G is not exactly symmetric", shape)
        xe = x.expand(t, n, p)                 # a view: X is not copied
        xb = xe.contiguous()                   # K1 takes (T, N, P) pages
        g1, b1 = ops.batched_gram(xb, w, y)
        torch.cuda.synchronize()
        bitwise = torch.equal(g, g1) and torch.equal(bv, b1)
        if shape == XFIT_BITWISE_SHAPE:
            assert bitwise, ("crossfit_gram is not bitwise batched_gram on "
                             "the broadcast tensor", shape)

        def library():
            return (torch.bmm((xe * w.unsqueeze(-1)).transpose(1, 2), xe),
                    torch.bmm(xe.transpose(1, 2), (w * y).unsqueeze(-1)))

        gl, _ = library()
        assert torch.allclose(gl, g0, rtol=1e-3, atol=10 * g_atol)
        g64 = torch.einsum("np,tn,nq->tpq", x.double(), w.double(),
                           x.double())
        nbytes, flops = _crossfit_bound(t, n, p)
        bound, by = _bound_ms(nbytes, flops)
        abs_g, rel_g = _errs(g, g0)
        abs_b, rel_b = _errs(bv, b0)
        row = {
            "max_abs_err": max(abs_g, abs_b), "max_rel_err": max(rel_g, rel_b),
            "max_abs_G": float(g0.abs().max()),
            "abs_err_vs_f64": float((g.double() - g64).abs().max()),
            "plain_abs_err_vs_f64": float((g0.double() - g64).abs().max()),
            "bitwise_batched_gram_broadcast": bitwise,
            "max_abs_diff_batched_gram_broadcast":
                float((g - g1).abs().max()),
            "ms": _time_ms(lambda: ops.crossfit_gram(x, w, y), cold=True),
            "ms_warm_l2": _time_ms(lambda: ops.crossfit_gram(x, w, y),
                                   cold=False),
            "batched_gram_broadcast_ms": _time_ms(
                lambda: ops.batched_gram(xb, w, y), cold=True),
            "plain_ms": _time_ms(
                lambda: crossfit_gram.crossfit_gram_plain(x, w, y),
                cold=True),
            "library_ms": _time_ms(library, cold=True),
            "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "operations": flops,
        }
        report.append({"shape": list(shape), "crossfit_gram": row})
        if shape == MAIN_XFIT_SHAPE:
            main = row
        del x, y, w, g, bv, g0, b0, xe, xb, g1, b1, gl, g64
        torch.cuda.empty_cache()
    return report, main


def _compared_shapes(cache, path):
    """Every program the path built ran the kernels at a shape the
    kernels phase compared (the learners add the intercept column)."""
    built = {(b, n, p + 1) for b, n, p in cache.shapes()}
    assert built and built <= set(PATH_SHAPES[path]), \
        f"{path} launched {sorted(built)}, compared {PATH_SHAPES[path]}"


def _checked(res, req, device, truth, what):
    """The repo's own checks on one finished request (``req`` None: only
    the result, whose scores are finite only if every prediction is)."""
    if req is not None:
        preds = req.gathered_preds()
        assert preds.shape == (req.grid.n_rep, req.grid.n_folds,
                               req.grid.n_nuisance, req.ledger.n_obs)
        assert np.isfinite(preds).all(), f"{what}: a prediction is not finite"
    assert all(np.isfinite(psi).all() for psi in res.psi), \
        f"{what}: a score is not finite"
    assert np.isfinite([res.theta, res.se]).all() and res.se > 0
    assert abs(res.theta - truth) < 4 * res.se, \
        f"{what}: theta {res.theta} not within 4 se ({res.se}) of {truth}"
    info = linear.solve_failures(device)
    assert info == 0, f"{what}: a Cholesky factorisation failed (info {info})"


def _paper_plan(n_rep: int = 100) -> DMLPlan:
    # the paper's own §5 configuration: PLR on the bonus data, K = 5,
    # M = 100, L = 2, ridge with reg 1.0
    return DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0}, n_folds=5,
                             n_rep=n_rep, seed=42, backend="inline")


def phase_estimate_paper(device):
    """The main path: one request at the paper's configuration, full width
    and depth.  Launch counts are set to 0 just before and read just
    after."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _paper_plan()
    backend = make_backend("inline", device=device)
    linear.reset_solve_status()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    res = estimate(plan, data, backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    _checked(res, None, device, TRUE_EFFECT, "estimate_paper")
    assert launches == {"batched_gram": 32, "batched_gram_blocked": 0,
                        "batched_predict": 32, "crossfit_gram": 0}, launches
    stats = backend.compiler.stats.summary()
    _compared_shapes(backend.compiler, "estimate_paper")

    # where the time goes, on the host's clock with the device drained at
    # each boundary: lowering, the drain (uploads, launches, harvest,
    # booking), the score
    t0 = time.perf_counter()
    req2 = compile_request(plan, data)
    t_compile = time.perf_counter() - t0
    backend = make_backend("inline", device=device)
    t0 = time.perf_counter()
    backend.run_requests([req2])
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = assemble_result(plan, data, req2, device=device)
    torch.cuda.synchronize()
    t_assemble = time.perf_counter() - t0
    _checked(res2, req2, device, TRUE_EFFECT, "estimate_paper (second run)")
    assert res2.theta == res.theta and res2.se == res.se and \
        np.array_equal(res2.psi[1], res.psi[1]), \
        "a second run of the same request changed its result"
    emit("estimate_paper", n_obs=data.n_obs, dim_x=data.dim_x, n_folds=5,
         n_rep=100, learner="ridge", tasks=req2.grid.n_tasks,
         theta=res.theta, se=res.se, planted=TRUE_EFFECT,
         wall_s=wall, launches=launches,
         compile_stats=stats,
         second_run={"compile_request_s": t_compile, "drain_s": t_drain,
                     "assemble_result_s": t_assemble,
                     "bitwise_same_result": True})
    return launches, {"wall_s": wall, "drain_s": t_drain}


def phase_estimate_wide(device):
    """A size at which the card does real work: a page is 60000 x 256
    float32, a full block's gathered batch about 2 GB."""
    data = DMLData.from_dict(make_plr_data(n_obs=60000, dim_x=200))
    out = []
    for learner, params, n_rep in (("ridge", {"reg": 1.0}, 4), ("ols", {}, 2),
                                   ("lasso", {"n_iter": 200}, 2)):
        plan = DMLPlan.for_model("plr", learner=learner,
                                 learner_params=params, n_folds=5,
                                 n_rep=n_rep, backend="inline")
        sess = DMLSession(backend="inline", device=device)
        linear.reset_solve_status()
        runtime.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid = sess.submit(plan, data)
        res = sess.wait(rid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _checked(res, sess.request(rid), device, data.theta0,
                 f"estimate_wide/{learner}")
        _compared_shapes(sess.backend.compiler, "estimate_wide")
        out.append({"learner": learner, "n_rep": n_rep, "theta": res.theta,
                    "se": res.se, "wall_s": wall,
                    "launches": dict(runtime.launch_counts),
                    "peak_device_bytes": torch.cuda.max_memory_allocated()})
        del sess
        torch.cuda.empty_cache()
    emit("estimate_wide", n_obs=60000, dim_x=200, n_folds=5,
         theta0=data.theta0, requests=out)


def phase_session(device):
    """Three requests through one session; a second drain of the same
    three builds no new program."""
    plr = DMLData.from_dict(make_plr_data(n_obs=5000, dim_x=20))
    pliv = DMLData.from_dict(make_pliv_data(n_obs=5000, dim_x=20))
    jobs = [
        (DMLPlan.for_model("plr", learner="ridge", n_folds=5, n_rep=10,
                           backend="inline"), plr),
        (DMLPlan.for_model("plr", learner="lasso", n_folds=5, n_rep=10,
                           backend="inline"), plr),
        (DMLPlan.for_model("pliv", learner="ols", n_folds=5, n_rep=10,
                           backend="inline"), pliv),
    ]
    sess = DMLSession(backend="inline", device=device)
    linear.reset_solve_status()
    walls, thetas = [], []
    misses = []
    for _ in range(2):
        runtime.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [sess.submit(p, d) for p, d in jobs]
        results = sess.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for rid, res, (_, d) in zip(rids, results, jobs):
            _checked(res, sess.request(rid), device, d.theta0,
                     f"session/request {rid}")
        thetas.append([r.theta for r in results])
        misses.append(sess.backend.compiler.stats.misses)
    assert sess.completion_order == [0, 1, 2, 3, 4, 5], sess.completion_order
    _compared_shapes(sess.backend.compiler, "session")
    assert misses[1] == misses[0], \
        f"the second drain built {misses[1] - misses[0]} new programs"
    assert thetas[0] == thetas[1], "the second drain changed a theta"
    emit("session", requests=3, completion_order=sess.completion_order,
         thetas=thetas[0], wall_s=walls, programs_built=misses,
         launches_second_drain=dict(runtime.launch_counts),
         compile_stats=sess.backend.compiler.stats.summary())


def phase_same_as_cpu(device):
    """The paper request at M = 4: the plain versions on the CPU against
    the kernels on the card."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _paper_plan(n_rep=4)
    got = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        sess = DMLSession(backend="inline", device=dev)
        runtime.reset_launch_counts()
        rid = sess.submit(plan, data)
        res = sess.wait(rid)
        got[name] = (res, sess.request(rid).gathered_preds(),
                     dict(runtime.launch_counts))
        _compared_shapes(sess.backend.compiler, "same_as_cpu")
    (rc, pc, lc), (rg, pg, lg) = got["cpu"], got["card"]
    assert lc == {"batched_gram": 0, "batched_gram_blocked": 0,
                  "batched_predict": 0, "crossfit_gram": 0}, lc
    assert lg == {"batched_gram": 2, "batched_gram_blocked": 0,
                  "batched_predict": 2, "crossfit_gram": 0}, lg
    np.testing.assert_allclose(pg, pc, rtol=1e-4, atol=1e-5)
    rel_theta = abs(rg.theta - rc.theta) / abs(rc.theta)
    rel_se = abs(rg.se - rc.se) / rc.se
    assert rel_theta < 1e-4 and rel_se < 1e-4, (rel_theta, rel_se)
    emit("same_as_cpu", theta_cpu=rc.theta, theta_card=rg.theta,
         se_cpu=rc.se, se_card=rg.se, rel_theta=rel_theta, rel_se=rel_se,
         max_abs_pred_diff=float(np.abs(pg - pc).max()),
         tolerance="predictions rtol 1e-4, atol 1e-5; theta, se 1e-4 "
                   "relative")


@contextlib.contextmanager
def _launch_shapes():
    """Record the operand shape of every kernel launch made inside the
    block: each ``*_cuda`` wrapper is wrapped for the duration (the
    launch counts are the wrappers' own and are not touched)."""
    seen = {name: set() for name in KERNELS}
    real = {name: getattr(KERNEL_MODULES[name], f"{name}_cuda")
            for name in KERNELS}

    def recorder(name):
        def call(operand, *args):
            shape = tuple(operand.shape)
            if name == "crossfit_gram":         # (T,) of w, then x's (N, P)
                shape = (int(args[0].shape[0]),) + shape
            seen[name].add(shape)
            return real[name](operand, *args)
        return call

    for name in KERNELS:
        setattr(KERNEL_MODULES[name], f"{name}_cuda", recorder(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(KERNEL_MODULES[name], f"{name}_cuda", fn)


def _launches_compared(seen, what):
    """Every launch of a path ran at a shape the kernels phase
    compared."""
    compared = {"batched_gram": set(SHAPES), "batched_predict": set(SHAPES),
                "batched_gram_blocked": set(BLOCKED_SHAPES),
                "crossfit_gram": set(XFIT_SHAPES)}
    for name, shapes in seen.items():
        assert shapes <= compared[name], \
            f"{what}: {name} launched at {sorted(shapes - compared[name])}"


def phase_estimate_tall(device):
    """Tall-N estimation: 250 000 rows, more than one device page, so the
    sharded backend plans every bucket on the data axis and streams its
    rows as N-chunks through batched_gram_blocked.  Each request runs on
    the sharded backend (launch counts set to 0 just before, read just
    after) and, as the yardstick, on the inline backend (one 250 000-row
    page, batched_gram)."""
    data = DMLData.from_dict(make_plr_data(n_obs=TALL_N, dim_x=20,
                                           theta=0.5))
    out, total = [], dict.fromkeys(runtime.launch_counts, 0)
    for learner, params, n_rep in (("ridge", {"reg": 1.0}, 10),
                                   ("lasso", {}, 4)):
        plan = DMLPlan.for_model("plr", learner=learner,
                                 learner_params=params, n_folds=5,
                                 n_rep=n_rep, backend="sharded")
        got = {}
        for backend in ("sharded", "inline"):
            what = f"estimate_tall/{learner}/{backend}"
            sess = DMLSession(backend=backend, device=device)
            linear.reset_solve_status()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runtime.reset_launch_counts()
            t0 = time.perf_counter()
            with _launch_shapes() as seen:
                rid = sess.submit(plan, data)
                res = sess.wait(rid)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(runtime.launch_counts)
            req = sess.request(rid)
            _checked(res, req, device, data.theta0, what)
            _launches_compared(seen, what)
            decisions = sess.last_run_info.axis_plans
            if backend == "sharded":
                assert decisions and all(
                    (d.axis, d.executed) == ("data", "data")
                    for d in decisions), \
                    [(d.axis, d.executed) for d in decisions]
                assert launches["batched_gram_blocked"] > 0 and \
                    launches["batched_gram"] == 0, launches
                for name, k in launches.items():
                    total[name] += k
            else:
                assert launches["batched_gram"] > 0 and \
                    launches["batched_gram_blocked"] == 0, launches
            got[backend] = (res, req.gathered_preds())
            out.append({
                "learner": learner, "n_rep": n_rep, "backend": backend,
                "theta": res.theta, "se": res.se, "wall_s": wall,
                "launches": launches,
                "launch_shapes": {k: sorted(v) for k, v in seen.items()},
                "axis_plans": [{"axis": d.axis, "executed": d.executed,
                                "n_tasks": d.n_tasks, "n_pad": d.n_pad,
                                "p_pad": d.p_pad, "est_s": d.est_s}
                               for d in decisions],
                "compile_stats": sess.backend.compiler.stats.summary(),
                "peak_device_bytes": torch.cuda.max_memory_allocated()})
            del sess
            torch.cuda.empty_cache()
        (rs, ps), (ri, pi) = got["sharded"], got["inline"]
        diff = float(np.abs(ps - pi).max())
        rel_theta = abs(rs.theta - ri.theta) / abs(ri.theta)
        rel_se = abs(rs.se - ri.se) / ri.se
        assert diff <= 5e-4, f"estimate_tall/{learner}: predictions {diff}"
        assert rel_theta < 1e-4 and rel_se < 1e-4, (rel_theta, rel_se)
        out[-1].update(max_abs_pred_diff_vs_sharded=diff,
                       rel_theta_vs_sharded=rel_theta,
                       rel_se_vs_sharded=rel_se)

    # where the time goes for the ridge request on the sharded backend, on
    # the host's clock with the device drained at each boundary
    plan = DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0}, n_folds=5,
                             n_rep=10, backend="sharded")
    t0 = time.perf_counter()
    req = compile_request(plan, data)
    t_compile = time.perf_counter() - t0
    backend = make_backend("sharded", device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend.run_requests([req])
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    res = assemble_result(plan, data, req, device=device)
    torch.cuda.synchronize()
    t_assemble = time.perf_counter() - t0
    assert res.theta == out[0]["theta"] and res.se == out[0]["se"], \
        "a second run of the same tall request changed its result"
    emit("estimate_tall", n_obs=TALL_N, dim_x=20, n_folds=5,
         theta0=data.theta0, requests=out,
         launch_overhead_s=roofline.launch_overhead_s(),
         second_run={"learner": "ridge", "compile_request_s": t_compile,
                     "drain_s": t_drain, "assemble_result_s": t_assemble,
                     "peak_device_bytes_drain": peak,
                     "bitwise_same_result": True},
         tolerance="sharded vs inline on the card: predictions atol 5e-4, "
                   "theta and se 1e-4 relative")
    return total


def _task_preds(req, preds):
    """(T, N) predictions of a drained request in flat task order."""
    _, tm, tk, tl = req._index_maps()[:4]
    return preds[tm, tk, tl]


def _book_shared_preds(req, preds):
    """Book (T, N) shared-X predictions into ``req``'s ledger, invocation
    by invocation, so that ``assemble_result`` stitches and scores them."""
    invs = np.arange(req.ledger.n_invocations)
    req.ledger.record_successes(
        invs, np.stack([preds[req.invocation_tasks(i)] for i in invs]))


def _warm_ms(fn, runs: int = 5) -> float:
    """Median wall ms of ``fn`` on the host's clock, device drained."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_shared_x(device):
    """The shared-X learner forms at the paper's full width and depth: the
    request's 1000 tasks (y, w from ``wave_arrays``) in ONE call of
    ``get_learner(...)`` — one crossfit_gram launch — for ridge and lasso,
    held against the inline megabatch drain of the same request: the
    predictions of every task, and theta through the port's scores.
    Launch counts are set to 0 just before each call and read just
    after."""
    data = DMLData.from_dict(make_bonus_data())
    x = torch.as_tensor(data.x, device=device)
    out, total = [], 0
    for learner, params in (("ridge", {"reg": 1.0}), ("lasso", {})):
        plan = DMLPlan.for_model("plr", learner=learner, learner_params=params,
                                 n_folds=5, n_rep=100, seed=42,
                                 backend="inline")
        # the yardstick: the megabatch drain (K1 + K2) of the same request
        req_mb = compile_request(plan, data)
        make_backend("inline", device=device).run_requests([req_mb])
        res_mb = assemble_result(plan, data, req_mb, device=device)
        want = _task_preds(req_mb, req_mb.gathered_preds())

        req = compile_request(plan, data)
        y, w = req.wave_arrays(np.arange(req.grid.n_tasks))
        y = torch.as_tensor(y, device=device)
        w = torch.as_tensor(w, device=device)
        fn = get_learner(learner, params)
        linear.reset_solve_status()
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        with _launch_shapes() as seen:
            preds = fn(x, y, w, None)
            torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(runtime.launch_counts)
        assert launches == {"batched_gram": 0, "batched_gram_blocked": 0,
                            "batched_predict": 0, "crossfit_gram": 1}, \
            launches
        assert seen["crossfit_gram"] == {MAIN_XFIT_SHAPE}, seen
        _launches_compared(seen, f"shared_x/{learner}")
        total += launches["crossfit_gram"]
        got = preds.cpu().numpy()
        assert got.shape == want.shape == (1000, data.n_obs)
        assert np.isfinite(got).all(), f"shared_x/{learner}: not finite"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        _book_shared_preds(req, got)
        res = assemble_result(plan, data, req, device=device)
        if learner == "ridge":                # the paper's own learner
            _checked(res, req, device, TRUE_EFFECT, "shared_x/ridge")
        assert np.isfinite([res.theta, res.se]).all()
        rel_theta = abs(res.theta - res_mb.theta) / abs(res_mb.theta)
        rel_se = abs(res.se - res_mb.se) / res_mb.se
        assert rel_theta < 1e-4 and rel_se < 1e-4, (rel_theta, rel_se)
        out.append({"learner": learner, "tasks": int(w.shape[0]),
                    "launches": launches, "first_call_ms": first_ms,
                    "warm_call_ms": _warm_ms(lambda: fn(x, y, w, None)),
                    "theta": res.theta, "se": res.se,
                    "theta_megabatch": res_mb.theta, "rel_theta": rel_theta,
                    "rel_se": rel_se,
                    "max_abs_pred_diff_vs_megabatch":
                        float(np.abs(got - want).max())})
        del preds, y, w
        torch.cuda.empty_cache()
    emit("shared_x", n_obs=data.n_obs, dim_x=data.dim_x, n_folds=5,
         n_rep=100, calls=out,
         tolerance="predictions rtol 1e-4, atol 1e-5 of the megabatch "
                   "drain's; theta and se 1e-4 relative")
    return total


def phase_raw_request(device):
    """The opaque-learner drain at the paper's configuration:
    ``compile_raw_request`` with the shared-X ridge callable, drained by
    the inline backend at exact shapes; ``as_batched`` calls the learner
    once per lane, one crossfit_gram launch each (T = 1).  Held against
    the registry drain of the same request."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _paper_plan()
    req_mb = compile_request(plan, data)
    make_backend("inline", device=device).run_requests([req_mb])
    res_mb = assemble_result(plan, data, req_mb, device=device)

    raw = compile_raw_request(req_mb.grid, req_mb.scaling, data.x,
                              req_mb.targets, req_mb.train_w,
                              get_learner("ridge", {"reg": 1.0}), 42)
    backend = make_backend("inline", device=device)
    linear.reset_solve_status()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        backend.run_requests([raw])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    stats = backend.compiler.stats.summary()
    lanes = stats["padded_tasks"]              # live and padding lanes
    assert launches == {"batched_gram": 0, "batched_gram_blocked": 0,
                        "batched_predict": 0, "crossfit_gram": lanes}, \
        (launches, lanes)
    assert seen["crossfit_gram"] == {LANE_XFIT_SHAPE}, seen
    _launches_compared(seen, "raw_request")
    info = linear.solve_failures(device)
    assert info == 0, f"raw_request: a live lane's Cholesky failed ({info})"
    got, want = raw.gathered_preds(), req_mb.gathered_preds()
    assert raw.ledger.complete and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    raw.fold_masks = req_mb.fold_masks
    res = assemble_result(plan, data, raw, device=device)
    rel_theta = abs(res.theta - res_mb.theta) / abs(res_mb.theta)
    assert rel_theta < 1e-4, rel_theta
    emit("raw_request", n_obs=data.n_obs, dim_x=data.dim_x, n_folds=5,
         n_rep=100, tasks=raw.grid.n_tasks, lanes=lanes, launches=launches,
         drain_s=wall, theta=res.theta, theta_registry=res_mb.theta,
         rel_theta=rel_theta,
         max_abs_pred_diff_vs_registry=float(np.abs(got - want).max()),
         compile_stats=stats,
         tolerance="predictions rtol 1e-4, atol 1e-5 of the registry "
                   "drain's; theta 1e-4 relative")
    return launches["crossfit_gram"]


def phase_estimate_irm(device):
    """The default IRM plan — ridge outcome regressions, logistic
    propensity (IRLS on the megabatch bucket) — on the card and on the
    CPU."""
    data = DMLData.from_dict(make_irm_data(n_obs=5000, dim_x=20))
    plan = DMLPlan.for_model("irm", learner="ridge", n_folds=5, n_rep=10,
                             backend="inline")
    assert [ns.learner for ns in plan.nuisances] == \
        ["ridge", "ridge", "logistic"]
    got = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        sess = DMLSession(backend="inline", device=dev)
        linear.reset_solve_status()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        rid = sess.submit(plan, data)
        res = sess.wait(rid)
        if name == "card":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _checked(res, sess.request(rid), dev, data.theta0,
                 f"estimate_irm/{name}")
        got[name] = (res, wall, dict(runtime.launch_counts),
                     sess.backend.compiler.stats.summary())
    (rg, wg, lg, sg), (rc, wc, lc, _) = got["card"], got["cpu"]
    assert lg["batched_gram"] > 0 and lg["batched_predict"] > 0, lg
    assert not any(lc.values()), lc
    rel_theta = abs(rg.theta - rc.theta) / abs(rc.theta)
    rel_se = abs(rg.se - rc.se) / rc.se
    assert rel_theta < 1e-4 and rel_se < 1e-4, (rel_theta, rel_se)
    emit("estimate_irm", n_obs=5000, dim_x=20, n_folds=5, n_rep=10,
         learners=[ns.learner for ns in plan.nuisances],
         theta=rg.theta, se=rg.se, theta0=data.theta0, theta_cpu=rc.theta,
         se_cpu=rc.se, rel_theta=rel_theta, rel_se=rel_se, wall_s=wg,
         wall_cpu_s=wc, launches=lg, compile_stats=sg,
         tolerance="card vs CPU: theta and se 1e-4 relative")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas reports for each kernel")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases: {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs the "
              "port on the card and has no CPU mode", file=sys.stderr)
        return 1
    device = runtime.default_device()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    t_start = time.perf_counter()
    smi = smi_line()

    if "device" in phases:
        nvcc = subprocess.run([build.find_nvcc(), "--version"],
                              capture_output=True, text=True, check=True)
        emit("device", nvidia_smi=smi, torch=torch.__version__,
             cuda=torch.version.cuda,
             nvcc=next(ln.strip() for ln in nvcc.stdout.splitlines()
                       if "release" in ln),
             kind=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count())
    if "build" in phases:
        t0 = time.perf_counter()
        build.load_library("megabatch", verbose=args.verbose_build)
        nvcc_s, path = build.build_log["megabatch"]
        emit("build", library=str(Path(path).relative_to(ROOT))
             if Path(path).is_relative_to(ROOT) else path,
             nvcc_s=nvcc_s, build_and_load_s=time.perf_counter() - t0)
    rows, launches = None, None
    if "kernels" in phases:
        rows = phase_kernels(device)
    if "estimate_paper" in phases:
        launches, _ = phase_estimate_paper(device)
    if "estimate_wide" in phases:
        phase_estimate_wide(device)
    if "session" in phases:
        phase_session(device)
    if "same_as_cpu" in phases:
        phase_same_as_cpu(device)
    if "estimate_tall" in phases:
        tall = phase_estimate_tall(device)
        if launches is not None:
            launches["batched_gram_blocked"] = tall["batched_gram_blocked"]
    if "shared_x" in phases:
        xfit = phase_shared_x(device)
        if launches is not None:
            launches["crossfit_gram"] = xfit
    if "raw_request" in phases:
        phase_raw_request(device)
    if "estimate_irm" in phases:
        phase_estimate_irm(device)

    if phases != list(PHASES):
        print(json.dumps({"ok": False, "partial": phases,
                          "seconds": time.perf_counter() - t_start}))
        return 0
    for name in KERNELS:
        assert launches[name] > 0, f"the main path never launched {name}"
    print(json.dumps({"phase": "done",
                      "seconds": time.perf_counter() - t_start}))
    print(smi, flush=True)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, **meta, "launches": launches[name],
         **{k: rows[name][k] for k in keys}}
        for name, meta in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

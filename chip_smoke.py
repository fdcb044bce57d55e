#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
first use), holds each kernel against its plain PyTorch version on the
card, and drives the port's main path — ``estimate`` / ``DMLSession`` on
the inline backend — at the paper's own configuration and at a wide
synthetic one.  Every phase prints one JSON line; any failure raises and
the process exits non-zero.  Without a CUDA device it exits non-zero and
prints no result.  ``--phases a,b`` runs a subset (the lines that sum up
the run are printed only by a full run).

Phases: device, build, kernels, estimate_paper, estimate_wide, session,
same_as_cpu.
"""
from __future__ import annotations

import argparse
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
    assemble_result, compile_request,
)
from repro_torch.data import (                             # noqa: E402
    TRUE_EFFECT, make_bonus_data, make_pliv_data, make_plr_data,
)
from repro_torch.kernels import build, megabatch, ops      # noqa: E402
from repro_torch.learners import linear                    # noqa: E402
from repro_torch.serverless import make_backend            # noqa: E402

PHASES = ("device", "build", "kernels", "estimate_paper", "estimate_wide",
          "session", "same_as_cpu")

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
}
# (B, N, P) of every launch each driven path makes: full blocks of 32
# lanes and the aligned tail, N and P as the bucket pads them, plus the
# intercept column.  Each path asserts after its run that it built no
# program of another shape.
MAIN_SHAPE = (32, 5104, 33)
PATH_SHAPES = {
    "estimate_paper": (MAIN_SHAPE, (8, 5104, 33)),
    "estimate_wide": ((32, 60000, 257), (8, 60000, 257), (24, 60000, 257)),
    "session": ((32, 5000, 33), (8, 5000, 33), (24, 5000, 33)),
    "same_as_cpu": (MAIN_SHAPE, (8, 5104, 33)),
}
# the paths' shapes, then a ragged one (odd B, N and P below a tile) and
# one whose N is a multiple of the kernels' row step
SHAPES = tuple(dict.fromkeys(
    [s for shapes in PATH_SHAPES.values() for s in shapes]
    + [(5, 1003, 7), (8, 65536, 257)]))


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
    emit("kernels", tolerance={
        "batched_gram": "rtol 1e-4, atol 1e-4*max|G| (the two sum over N in "
                        "different orders); G == G' exactly",
        "batched_predict": "rtol 1e-5, atol 1e-5; valid == 0 rows == 0 "
                           "exactly"},
        timing="median of 20 single launches after 3 warm-ups, CUDA events, "
               "L2 flushed before each (ms_warm_l2: not flushed), the "
               "device kept busy while the host enqueues",
        kernels=sorted(KERNELS), shapes=report)
    return rows


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
    assert launches == {"batched_gram": 32, "batched_predict": 32}, launches
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
    assert lc == {"batched_gram": 0, "batched_predict": 0}, lc
    assert lg == {"batched_gram": 2, "batched_predict": 2}, lg
    np.testing.assert_allclose(pg, pc, rtol=1e-4, atol=1e-5)
    rel_theta = abs(rg.theta - rc.theta) / abs(rc.theta)
    rel_se = abs(rg.se - rc.se) / rc.se
    assert rel_theta < 1e-4 and rel_se < 1e-4, (rel_theta, rel_se)
    emit("same_as_cpu", theta_cpu=rc.theta, theta_card=rg.theta,
         se_cpu=rc.se, se_card=rg.se, rel_theta=rel_theta, rel_se=rel_se,
         max_abs_pred_diff=float(np.abs(pg - pc).max()),
         tolerance="predictions rtol 1e-4, atol 1e-5; theta, se 1e-4 "
                   "relative")


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

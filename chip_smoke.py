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
at the paper's configuration; the default IRM plan, whose propensity is
the logistic learner; and the language-model serving path: the full
zamba2-7b (81 layer slots, full width, random weights from a seed) served
through ``Engine.serve_requests``, whose prefills run the flash-attention
and SSD-scan kernels, and its card route held against its CPU route.  The
API's default backend, the paper's wave scheduler: the paper request on
it cold and warm beside the inline backend, the paper's Figure 3 sweep
(both scaling levels x four worker memories, simulated Lambda billing)
and one drain under the fault model (failures, stragglers, hedged
re-dispatch), and a default ``DMLSession`` with continuous admission.
Every phase prints one JSON line; any failure raises and the process exits
non-zero.  Without a CUDA device it exits non-zero and prints no result.  ``--phases a,b`` runs a subset (the lines
that sum up the run are printed only by a full run).

The compile layer's warm path: each ported learner family's fused and
morphed launches against its per-block ones, bit for bit (the two family
sets of ``compile/program.py`` decide the form and the tier), and the
device-resident page pool (warm drains upload nothing and get the same
stack tensors back; a one-page budget evicts).  The paths run on the
defaults (fused, coalesced, pages pooled) and, where they count
per-block launches, on the per-block pool as well, bit for bit.

The nonparametric learners and the bootstrap: the README's quickstart
(kernel_ridge with 256 landmarks on the wave backend: its ridge solve on
the Gram and predict kernels at P 257) cold, then warm in turns with the
inline backend, with the multiplier bootstrap, each held against the CPU
path; the mlp learner at full width (PLR on the bonus data, and an IRM
plan whose propensity is mlp's sigmoid) against the CPU path.

Phases: device, build, kernels, estimate_paper, estimate_wide, session,
same_as_cpu, estimate_tall, shared_x, raw_request, estimate_irm,
estimate_wave, wave_pool, session_wave, fusion, page_pool,
estimate_quickstart, estimate_mlp, serve_zamba2, same_as_cpu_lm.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np                                         # noqa: E402
import torch                                               # noqa: E402

from repro_torch import runtime, threefry                 # noqa: E402
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
from repro_torch.compile import plan_buckets, program    # noqa: E402
from repro_torch.configs import get_arch                  # noqa: E402
from repro_torch.configs.dml_plr_bonus import (            # noqa: E402
    CONFIG, FIG3_MEMORY_GRID, FIG3_SCALING_GRID, USD_PER_GB_S,
)
from repro_torch.kernels import (                          # noqa: E402
    build, crossfit_gram, flash_attention, megabatch, ops, ssd_scan,
)
from repro_torch.launch import roofline                    # noqa: E402
from repro_torch.learners import (                         # noqa: E402
    get_batched_learner, get_learner, kernel_ridge, linear,
)
from repro_torch.models import (                           # noqa: E402
    build_model, init_tree, param_count,
)
from repro_torch.models.param import cast_floating, tree_map  # noqa: E402
from repro_torch.serverless import PoolConfig, make_backend  # noqa: E402
from repro_torch.serving import Engine, grow_cache         # noqa: E402

PHASES = ("device", "build", "kernels", "estimate_paper", "estimate_wide",
          "session", "same_as_cpu", "estimate_tall", "shared_x",
          "raw_request", "estimate_irm", "estimate_wave", "wave_pool",
          "session_wave", "fusion", "page_pool", "estimate_quickstart",
          "estimate_mlp", "serve_zamba2", "same_as_cpu_lm")
LIBRARIES = ("megabatch", "lm")

# NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, and plain (non tensor
# core) float32 FLOP/s — K1-K4 use plain FMA
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# dense bf16 tensor-core rate: the least time for K5's bf16 operands
PEAK_BF16_TC_FLOP_S = 989e12
# dense TF32 tensor-core rate; K5's float32 kernel and K6 do each product
# in three TF32 passes (hi/lo split), so their float32-grade rate is a third
PEAK_TF32_TC_FLOP_S = 495e12
TF32_SPLIT_PASSES = 3

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
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lm.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
    },
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lm.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:52",
    },
}
# the wrapper module of each kernel (its ``<name>_cuda`` launches it)
KERNEL_MODULES = {"batched_gram": megabatch, "batched_predict": megabatch,
                  "batched_gram_blocked": megabatch,
                  "crossfit_gram": crossfit_gram,
                  "flash_attention": flash_attention, "ssd_scan": ssd_scan}
# (B, N, P) of every launch each driven path makes: full blocks of 32
# lanes and the aligned tail, N and P as the bucket pads them, plus the
# intercept column; then the fused launches of the default pool, whose
# lanes are the G blocks' laid end to end.  Each path asserts after its
# run that it built no program of another block shape; launches at a
# fused shape not listed here are held against the plain versions right
# after the path that made them (``_launches_compared``).
MAIN_SHAPE = (32, 5104, 33)
# the paper request on the defaults: inline, all 32 blocks (the tail of 8
# morphed to 32) in one launch; the wave backend, 5 blocks a wave, then
# the last full block and the morphed tail
FUSED_PAPER_SHAPE = (1024, 5104, 33)
FUSED_WAVE_SHAPES = ((160, 5104, 33), (64, 5104, 33))
TALL_N = 250_000
# the pool that launches every canonical block on its own, with pages
# stacked on the host: the drains whose checks count per-block launches
PER_BLOCK_POOL = PoolConfig(fuse=False, coalesce=False, page_pool_bytes=0)
# kernel_ridge's ridge on its Nyström features: P = m + 1, N the bonus
# bucket's.  The README's quickstart (256 landmarks): 32 blocks of 32 lanes
# (kernel_ridge fuses one call a block; its tail of 8 morphs to 32); the
# learner's default 128 landmarks
QUICKSTART_SHAPES = ((32, 5104, 257),)
KR128_SHAPE = (32, 5104, 129)
KR_SHAPES = QUICKSTART_SHAPES + (KR128_SHAPE,)
PATH_SHAPES = {
    "estimate_paper": (MAIN_SHAPE, (8, 5104, 33), FUSED_PAPER_SHAPE),
    "estimate_wide": ((32, 60000, 257), (8, 60000, 257), (24, 60000, 257)),
    "session": ((32, 5000, 33), (8, 5000, 33), (24, 5000, 33)),
    "same_as_cpu": (MAIN_SHAPE, (8, 5104, 33), (64, 5104, 33)),
    # the inline run (K1, K2) and the sharded run's predict (K2); fused
    # inline, two 32-lane blocks a call (a block gathers 1.02 GB)
    "estimate_tall": ((32, TALL_N, 33), (8, TALL_N, 33), (64, TALL_N, 33)),
    # the wave backend: the paper request's blocks, and the PLIV request
    # of session_wave (150 tasks: 4 full blocks and a tail of 22 -> 24)
    "estimate_wave": (MAIN_SHAPE, (8, 5104, 33)) + FUSED_WAVE_SHAPES,
    "wave_pool": (MAIN_SHAPE, (8, 5104, 33), FUSED_PAPER_SHAPE),
    "session_wave": (MAIN_SHAPE, (8, 5104, 33), (32, 5000, 33),
                     (24, 5000, 33)),
    "estimate_quickstart": QUICKSTART_SHAPES,
}
# the paths' shapes, then a ragged one (odd B, N and P below a tile) and
# one whose N is a multiple of the kernels' row step
SHAPES = tuple(dict.fromkeys(
    [s for shapes in PATH_SHAPES.values() for s in shapes]
    + [KR128_SHAPE, (5, 1003, 7), (8, 65536, 257)]))
# a page too wide for whole rows in a block: the Gram kernel reads column
# panels (no path runs it; checked and timed like SHAPES)
WIDE_GRAM_SHAPES = ((2, 1000, 2600),)
# (B, C, Nc, P) of the streaming Gram: the tall path's launches (N 250000
# in 4 chunks of 62504 rows, not a multiple of the 64-row step), a small
# ragged one, and one whose chunks are whole steps; at every one it must be
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
# the shared-X kernel_ridge form on the bonus data: 10 tasks on the
# (N, 257) features of 256 landmarks (estimate_quickstart drives it)
KR_XFIT_SHAPE = (10, 5099, 257)
XFIT_SHAPES = (MAIN_XFIT_SHAPE, (40, 60000, 201), (5, 1003, 7),
               LANE_XFIT_SHAPE, XFIT_BITWISE_SHAPE, KR_XFIT_SHAPE)
# serve_zamba2: prompts of ragged length <= SERVE_LEN, left-padded into
# SERVE_BATCH slots, SERVE_GEN tokens generated for each
SERVE_BATCH, SERVE_LEN, SERVE_GEN, SERVE_PROMPTS = 4, 2048, 16, 8
# (BH, Sq, Skv, D, type, causal, window) of flash attention: serve_zamba2's
# prefills (B 4 x 32 heads, S 2048, D 112, bf16, the config's window 32768;
# again in float32, held at the f32 tier) and its consistency check (B 1 at S 2048, then 2049); same_as_cpu_lm's
# reduced model (B 2 x 4 heads, S 100, D 32, window 64) and its full-width
# group in float32 (B 1, S 512); then a window shorter than S, non-causal,
# Sq < Skv (queries aligned to the keys' suffix) and ragged S, in both
# types; then D 120 (h2o-danube-3-4b's heads), which the bfloat16 kernel
# pads to a depth of 128; last a float32 call only that kernel takes: D not
# a multiple of 4 (4-byte copies) and more queries than keys
MAIN_ATTN_SHAPE = (128, 2048, 2048, 112, "bf16", True, 32768)
ATTN_SHAPES = (MAIN_ATTN_SHAPE, (128, 2048, 2048, 112, "f32", True, 32768),
               (32, 2048, 2048, 112, "bf16", True, 32768),
               (32, 2049, 2049, 112, "bf16", True, 32768),
               (8, 100, 100, 32, "bf16", True, 64),
               (32, 512, 512, 112, "f32", True, 32768),
               (64, 1024, 1024, 112, "bf16", True, 256),
               (64, 1024, 1024, 112, "f32", True, 256),
               (32, 512, 512, 112, "bf16", False, None),
               (32, 512, 512, 112, "f32", False, None),
               (32, 64, 256, 112, "bf16", True, None),
               (32, 64, 256, 112, "f32", True, None),
               (16, 1000, 1000, 112, "bf16", True, 300),
               (16, 1000, 1000, 112, "f32", True, None),
               (32, 1024, 1024, 120, "bf16", True, None),
               (8, 300, 100, 18, "f32", False, None))
# (BH, S, P, N, chunk, heads) of the SSD scan, for the same runs (112 SSM
# heads of 64 a batch row, state 64, chunk 256; the reduced model 8 heads of
# 16, state 16, chunk 16), then a ragged S; "strong" decay is la = -50; S
# shorter than one chunk, heads = 1 (no lane shares bm/cm), and odd N, P
# (4-byte copies, the scalar state passing, a chunk shorter than a tile)
MAIN_SSD_SHAPE = (448, 2048, 64, 64, 256, 112)
SSD_SHAPES = ((MAIN_SSD_SHAPE, "slow"), ((112, 2048, 64, 64, 256, 112), "slow"),
              ((112, 2049, 64, 64, 256, 112), "slow"),
              ((16, 100, 16, 16, 16, 8), "slow"),
              ((112, 512, 64, 64, 256, 112), "slow"),
              ((64, 1000, 64, 64, 256, 16), "slow"),
              ((32, 512, 64, 64, 256, 8), "strong"),
              ((112, 200, 64, 64, 256, 112), "slow"),
              ((8, 777, 64, 64, 256, 1), "slow"),
              ((6, 300, 13, 7, 64, 3), "slow"))
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TYPE_NAMES = {v: k for k, v in TYPES.items()}
# attention tolerance: the reference's own (tests/test_kernels.py TOL)
ATTN_TOL = {"f32": 2e-4, "bf16": 2e-2}
# and, for float32, the split-TF32 kernel's own tier: a product within
# about 2^-21 of float32 (one TF32 rounding is about 1e-3 off)
ATTN_F32_SPLIT_TOL = 2e-5
# and per element in bf16: |o - o0| <= 2 bf16 steps at |o0| + 1e-4
BF16_ULPS = 2.0
# the SSD scan: the reference's tier (2e-4 of max|y|, of max|state|), and
# the split-TF32 kernels' own, the same relative to max|y| and max|state|
SSD_TOL = 2e-4
SSD_SPLIT_TOL = 2e-5


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


def _device_kernels(fn, calls: int = 1) -> dict:
    """The CUDA kernels that ``calls`` calls of ``fn`` launch, traced by
    torch.profiler: name -> (launches, device ms), each per call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        # the operators' rows ("aten::...") and the runtime's API rows
        # ("cudaLaunchKernel") are not kernels
        if us > 0 and not ev.key.startswith(("aten::", "cuda")):
            out[ev.key] = (ev.count / calls, us / 1e3 / calls)
    return out


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


def _predict_atol(shape, out0) -> float:
    """K2's absolute tolerance against its plain version: 1e-5, and at the
    kernel_ridge shapes (257 and 129 columns of features, sums of as many
    terms) 1e-6 of max|plain|, the form K1's check takes (1e-4 of max|G|):
    there the two orders of summation differ by more than 1e-5 near 0."""
    if shape in KR_SHAPES:
        return 1e-6 * float(out0.abs().max())
    return 1e-5


def phase_kernels(device):
    """Each kernel against its plain version on the card, with times."""
    gen = torch.Generator(device=device).manual_seed(20210104)
    rows = {}
    report = []
    for shape in SHAPES + WIDE_GRAM_SHAPES:
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
        # another launch plan: the order of summation is the plan's own,
        # so the bits are the same
        plan, alt = megabatch.gram_plans(b, n, p)[:2]
        ga, ba = megabatch.batched_gram_cuda(xs, w, y, plan=alt)
        torch.cuda.synchronize()
        assert torch.equal(g, ga) and torch.equal(bv, ba), \
            ("batched_gram differs under another launch plan", shape, alt)
        # column panels against whole rows, where both fit (P > PANEL)
        other = next((q for q in megabatch.gram_plans(b, n, p)
                      if q.panel != plan.panel), None)
        if other is not None:
            ga, ba = megabatch.batched_gram_cuda(xs, w, y, plan=other)
            torch.cuda.synchronize()
            assert torch.equal(g, ga) and torch.equal(bv, ba), \
                ("batched_gram differs between whole rows and column "
                 "panels", shape, other)
        del ga, ba

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
            "plan": plan._asdict(), "bitwise_plan": alt._asdict(),
            "bitwise_panel_plan": other and other._asdict(),
        }
        del g, bv, g0, b0, g64

        # ---- batched_predict ----------------------------------------------
        out = ops.batched_predict(xs, beta, valid)
        torch.cuda.synchronize()
        out0 = megabatch.batched_predict_plain(xs, beta, valid)
        p_atol = _predict_atol(shape, out0)
        assert torch.allclose(out, out0, rtol=1e-5, atol=p_atol), \
            ("batched_predict disagrees", shape, _errs(out, out0))
        assert bool((out[valid == 0] == 0).all()), \
            ("batched_predict: valid == 0 rows are not exactly 0", shape)

        def predict_library():
            return torch.bmm(xs, beta.unsqueeze(-1)).squeeze(-1) * valid

        assert torch.allclose(predict_library(), out0, rtol=1e-4, atol=1e-4)
        nbytes, flops = _predict_bound(b, n, p)
        bound, by = _bound_ms(nbytes, flops)
        abs_o, rel_o = _errs(out, out0)
        out64 = torch.bmm(xs.double(), beta.double().unsqueeze(-1)
                          ).squeeze(-1) * valid.double()
        pred = {
            "max_abs_err": abs_o, "max_rel_err": rel_o, "atol": p_atol,
            "abs_err_vs_f64": float((out.double() - out64).abs().max()),
            "plain_abs_err_vs_f64": float((out0.double() - out64).abs().max()),
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
        del out, out0, out64
        if shape == MAIN_SHAPE:
            # one wrapper call (one count): its CUDA launches (the Gram
            # kernel and the combine) as the profiler sees them, and the
            # scratch of partial tiles it allocates beside G and b as the
            # device allocator counts it (the peak of the call less what
            # stays allocated after it)
            traced = _device_kernels(lambda: ops.batched_gram(xs, w, y))
            gram["cuda_launches_per_call"] = sum(k for k, _ in traced.values())
            assert gram["cuda_launches_per_call"] >= 1, traced
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            g, bv = ops.batched_gram(xs, w, y)
            torch.cuda.synchronize()
            gram["scratch_bytes"] = (torch.cuda.max_memory_allocated()
                                     - torch.cuda.memory_allocated())
            del g, bv
        entry["batched_gram"] = gram
        entry["batched_predict"] = pred
        report.append(entry)
        if shape == MAIN_SHAPE:
            rows.update(batched_gram=gram, batched_predict=pred)
        if shape == FUSED_PAPER_SHAPE:
            rows["fused"] = {"batched_gram": gram, "batched_predict": pred}
        if shape in (QUICKSTART_SHAPES[0], KR128_SHAPE):
            rows[f"p{shape[2]}"] = {"batched_gram": gram,
                                    "batched_predict": pred}
        del xs, y, w, beta, valid
        torch.cuda.empty_cache()
    report += _gram_unaligned_rows(device, gen)
    blocked, rows["batched_gram_blocked"] = _blocked_kernel_rows(device, gen)
    xfit, rows["crossfit_gram"] = _xfit_kernel_rows(device, gen)
    attn, rows["flash_attention"] = _attn_kernel_rows(device, gen)
    ssd, rows["ssd_scan"] = _ssd_kernel_rows(device, gen)
    emit("kernels", tolerance={
        "batched_predict": "rtol 1e-5, atol 1e-5; valid == 0 rows == 0 "
                           "exactly",
        "batched_gram": "rtol 1e-4, atol 1e-4*max|G| (the two sum over N in "
                        "different orders); G == G' exactly; bitwise under "
                        "a second launch plan, and column panels bitwise "
                        "whole rows where P > 128; on operands off a "
                        "16-byte boundary bitwise the aligned result",
        "batched_gram_blocked": "as batched_gram; bitwise batched_gram on "
                                "the merged (B, C*Nc, P) at every shape, and "
                                "under a second launch plan",
        "crossfit_gram": "as batched_gram; bitwise batched_gram on x "
                         "broadcast to (T, N, P) at "
                         f"{list(XFIT_BITWISE_SHAPE)}; on operands off a "
                         "16-byte boundary bitwise the aligned result",
        "flash_attention": "max abs error 2e-4 (float32), 2e-2 (bf16): "
                           "the reference's own tolerance; float32 also "
                           "within 2e-5 (the split-TF32 tier); bf16 also "
                           "per element within 2 bf16 steps at |o0| after "
                           "1e-4",
        "ssd_scan": "y within 2e-4 of max|y|, the final state within "
                    "2e-4 of max|state|: the reference's own tolerance; "
                    "also within 2e-5 of each (the split-TF32 tier)"},
        timing="median of 20 single launches after 3 warm-ups, CUDA events, "
               "L2 flushed before each (ms_warm_l2: not flushed), the "
               "device kept busy while the host enqueues; ssd_scan's "
               "plain_ms (2048 sequential steps): median of 5 after 1",
        kernels=sorted(KERNELS), shapes=report, blocked_shapes=blocked,
        crossfit_shapes=xfit, attention_shapes=attn, ssd_shapes=ssd,
        bound_rates={"bytes_s": PEAK_BYTES_S, "f32_flop_s": PEAK_F32_FLOP_S,
                     "bf16_tensor_core_flop_s": PEAK_BF16_TC_FLOP_S,
                     "tf32_tensor_core_flop_s": PEAK_TF32_TC_FLOP_S,
                     "tf32_split_passes": TF32_SPLIT_PASSES})
    return rows


def _gram_unaligned_rows(device, gen):
    """batched_gram on operands that start off a 16-byte boundary (a task's
    rows then start anywhere on a float): the same bits as aligned copies."""
    report = []
    for b, n, p in ((5, 1003, 7), (3, 517, 45)):
        xs = torch.randn((b, n, p), generator=gen, device=device)
        y = torch.randn((b, n), generator=gen, device=device)
        w = (torch.rand((b, n), generator=gen, device=device) < 0.8).float()
        views = [torch.empty(a.numel() + k, device=device)[k:].view(a.shape)
                 .copy_(a) for a, k in ((xs, 1), (w, 2), (y, 3))]
        assert all(v.data_ptr() % 16 for v in views)
        g, bv = ops.batched_gram(xs, w, y)
        gv, bvv = ops.batched_gram(*views)
        torch.cuda.synchronize()
        assert torch.equal(g, gv) and torch.equal(bv, bvv), \
            ("batched_gram differs on unaligned operands", (b, n, p))
        g0, _ = megabatch.batched_gram_plain(xs, w, y)
        assert torch.allclose(gv, g0, rtol=1e-4,
                              atol=1e-4 * float(g0.abs().max()))
        report.append({"shape": [b, n, p], "batched_gram": {
            "unaligned_operands_bitwise_aligned": True,
            "max_abs_err": float((gv - g0).abs().max())}})
        del xs, y, w, views, g, bv, gv, bvv, g0
    return report


def _blocked_kernel_rows(device, gen):
    """The streaming Gram against its plain version, bitwise against
    batched_gram on the merged tensor and under a second launch plan, at
    every shape of BLOCKED_SHAPES."""
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
        plan, alt = megabatch.gram_plans(b, n, p)[:2]
        ga, ba = megabatch.batched_gram_blocked_cuda(xc, w, y, plan=alt)
        torch.cuda.synchronize()
        bitwise = torch.equal(g, g1) and torch.equal(bv, b1)
        assert bitwise, ("batched_gram_blocked is not bitwise batched_gram "
                         "on the merged tensor", shape)
        assert torch.equal(g, ga) and torch.equal(bv, ba), \
            ("batched_gram_blocked differs under another launch plan",
             shape, alt)
        del ga, ba

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
            "plan": plan._asdict(), "bitwise_plan": alt._asdict(),
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
    XFIT_SHAPES.  The main row carries the opaque drain's lane shape
    beside it (``lane``), and the shared-X kernel_ridge shape (``p257``)."""
    report, main, lane, wide = [], None, None, None
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

        def library():              # the faster single-call form
            return (torch.einsum("np,tn,nq->tpq", x, w, x),
                    torch.einsum("tn,np->tp", w * y, x))

        def bmm_expand():           # the bmm pair on the broadcast view
            return (torch.bmm((xe * w.unsqueeze(-1)).transpose(1, 2), xe),
                    torch.bmm(xe.transpose(1, 2), (w * y).unsqueeze(-1)))

        for gl, _ in (library(), bmm_expand()):
            assert torch.allclose(gl, g0, rtol=1e-3, atol=10 * g_atol)
        del gl
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
            "library": "einsum('np,tn,nq->tpq') and einsum('tn,np->tp')",
            "bmm_expand_ms": _time_ms(bmm_expand, cold=True),
            "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "operations": flops,
            "plan": crossfit_gram.launch_plan(t, n, p)._asdict(),
        }
        report.append({"shape": list(shape), "crossfit_gram": row})
        if shape == MAIN_XFIT_SHAPE:
            main = dict(row)
        if shape == LANE_XFIT_SHAPE:
            lane = row
        if shape == KR_XFIT_SHAPE:
            wide = row
        del x, y, w, g, bv, g0, b0, xe, xb, g1, b1, g64
        torch.cuda.empty_cache()
    # operands that start off a 16-byte boundary (as_batched hands the
    # kernel such views of w and y): the same bits as aligned copies
    for t, n, p in ((5, 1003, 7), (3, 517, 45)):
        x = torch.randn((n, p), generator=gen, device=device)
        y = torch.randn((t, n), generator=gen, device=device)
        w = (torch.rand((t, n), generator=gen, device=device) < 0.8).float()
        views = [torch.empty(a.numel() + k, device=device)[k:].view(a.shape)
                 .copy_(a) for a, k in ((x, 1), (w, 2), (y, 3))]
        assert all(v.data_ptr() % 16 for v in views)
        g, bv = ops.crossfit_gram(x, w, y)
        gv, bvv = ops.crossfit_gram(*views)
        torch.cuda.synchronize()
        assert torch.equal(g, gv) and torch.equal(bv, bvv), \
            ("crossfit_gram differs on unaligned operands", (t, n, p))
        g0, _ = crossfit_gram.crossfit_gram_plain(x, w, y)
        assert torch.allclose(gv, g0, rtol=1e-4,
                              atol=1e-4 * float(g0.abs().max()))
        report.append({"shape": [t, n, p], "crossfit_gram": {
            "unaligned_operands_bitwise_aligned": True,
            "max_abs_err": float((gv - g0).abs().max())}})
        del x, y, w, views, g, bv, gv, bvv, g0
    for name, shape, row in (("lane", LANE_XFIT_SHAPE, lane),
                             ("p257", KR_XFIT_SHAPE, wide)):
        main[name] = {"shape": list(shape),
                      **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "bmm_expand_ms")}}
    return report, main


def _attn_pairs(sq, skv, causal, window):
    """(query, key) pairs the mask leaves visible, queries aligned to the
    keys' suffix: the work this call's inputs need."""
    qa = np.arange(sq, dtype=np.int64) + (skv - sq)
    lo = np.maximum(0, qa - window + 1) if window else np.zeros_like(qa)
    hi = np.minimum(skv, qa + 1) if causal else np.full_like(qa, skv)
    return int(np.maximum(hi - lo, 0).sum())


def _attn_bound(bh, sq, skv, d, dtype, causal, window):
    # QK' and PV: 2 D operations each per visible pair; q, k, v read once
    # and o written once.  bf16 at the bf16 tensor-core rate; float32 at
    # the TF32 rate over the split's three passes (the FMA figure is kept
    # beside it as bound_ms_at_f32_fma)
    flops = bh * _attn_pairs(sq, skv, causal, window) * 4 * d
    nbytes = TYPES[dtype].itemsize * bh * d * (2 * sq + 2 * skv)
    peak = PEAK_BF16_TC_FLOP_S if dtype == "bf16" \
        else PEAK_TF32_TC_FLOP_S / TF32_SPLIT_PASSES
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    bound = max(t_bytes, t_ops)
    return (nbytes, flops, bound, "bytes" if t_bytes >= t_ops
            else "operations", max(t_bytes, flops / PEAK_F32_FLOP_S * 1e3))


def _ssd_bound(bh, s, p, n, chunk, heads):
    # the function, not the chunked schedule (``chunk`` is tiling): per
    # lane and row the decay of the (N, P) state (NP), the outer product
    # b x' added to it (2NP) and y = c'S (2NP); priced at the TF32 rate
    # over the split's three passes (the FMA figure is kept beside it as
    # bound_ms_at_f32_fma)
    flops = bh * s * 5 * n * p
    nbytes = 4 * (2 * bh * s * p + bh * s + 2 * (bh // heads) * s * n
                  + bh * n * p)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / (PEAK_TF32_TC_FLOP_S / TF32_SPLIT_PASSES) * 1e3
    return (nbytes, flops, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            _bound_ms(nbytes, flops)[0])


def _bf16_ulps(o, o0):
    """Largest |o - o0| in units of one bf16 step at |o0| (both sides are
    float32 sums rounded to bf16 once, so a right kernel stays within a
    step or two), with 1e-4 absolute below the smallest normal steps."""
    _, e = torch.frexp(o0.float())
    ulp = torch.ldexp(torch.ones_like(o0, dtype=torch.float32), e - 8)
    return float(((o.float() - o0.float()).abs() - 1e-4).div(ulp).max())


def _attn_kernel_rows(device, gen):
    """Flash attention against its plain version (and, at the serve
    path's shape, against scaled_dot_product_attention, timed only) at
    every shape of ATTN_SHAPES.  The main (bf16) row carries the float32
    kernel's row at the same shape beside it (``f32``)."""
    report, main, f32 = [], None, None
    for shape in ATTN_SHAPES:
        bh, sq, skv, d, dtype, causal, window = shape
        q = torch.randn((bh, sq, d), generator=gen, device=device) \
            .to(TYPES[dtype])
        k = torch.randn((bh, skv, d), generator=gen, device=device) \
            .to(TYPES[dtype])
        v = torch.randn((bh, skv, d), generator=gen, device=device) \
            .to(TYPES[dtype])
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        o0 = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                   window=window)
        err = float((o.float() - o0.float()).abs().max())
        assert torch.isfinite(o).all() and err < ATTN_TOL[dtype], \
            ("flash_attention disagrees", shape, err)
        # float32: the split-TF32 kernel's own, stricter tier besides
        assert dtype == "bf16" or err <= ATTN_F32_SPLIT_TOL, \
            ("flash_attention float32 outside the split-TF32 tier", shape,
             err)
        # per element in bf16: the flat tier alone would pass a fault
        # confined to the late query rows, whose outputs are small
        ulps = _bf16_ulps(o, o0) if dtype == "bf16" else None
        assert ulps is None or ulps <= BF16_ULPS, \
            ("flash_attention disagrees per element", shape, ulps)
        nbytes, flops, bound, by, bound_f32 = _attn_bound(*shape)
        row = {
            "max_abs_err": err, "max_abs_out": float(o0.float().abs().max()),
            "max_err_bf16_steps": ulps,
            "ms": _time_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window), cold=True),
            "plain_ms": _time_ms(lambda: flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window), cold=True),
            "library_ms": None,
            "bound_ms": bound, "bound_by": by,
            "bound_ms_at_f32_fma": bound_f32,
            "bytes": nbytes, "operations": flops,
        }
        if shape[:4] == MAIN_ATTN_SHAPE[:4]:
            # the serve path's shape in both types (the window 32768 is
            # longer than S: causal alone)
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def library():          # (1, BH, S, D): the fused backends
                return sdpa(q[None], k[None], v[None], is_causal=True)[0]

            lib_err = float((library().float() - o0.float()).abs().max())
            # float32: recorded only (the fused backends may take TF32)
            assert dtype == "f32" or lib_err < ATTN_TOL[dtype], \
                ("sdpa disagrees", lib_err)
            row["library_ms"] = _time_ms(library, cold=True)
            row["library"] = ("scaled_dot_product_attention(is_causal=True) "
                              "on (1, BH, S, D)")
            row["library_max_abs_err"] = lib_err
        if shape == MAIN_ATTN_SHAPE:
            main = dict(row)
        elif shape[:4] == MAIN_ATTN_SHAPE[:4]:
            f32 = row
        report.append({"shape": list(shape), "flash_attention": row})
        del q, k, v, o, o0
        torch.cuda.empty_cache()
    main["f32"] = {"shape": list(MAIN_ATTN_SHAPE[:4]) + ["f32"],
                   **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms",
                                          "bound_ms_at_f32_fma")}}
    return report, main


def _ssd_inputs(shape, decay, device, gen):
    """xbar, la, bm, cm of an SSD_SHAPES row."""
    bh, s, p, n, _, heads = shape
    x = torch.randn((bh, s, p), generator=gen, device=device)
    if decay == "strong":
        la = torch.full((bh, s), -50.0, device=device)
    else:
        la = -0.1 * torch.rand((bh, s), generator=gen, device=device)
    bm = torch.randn((bh // heads, s, n), generator=gen, device=device)
    cm = torch.randn((bh // heads, s, n), generator=gen, device=device)
    return x, la, bm, cm


def _ssd_kernel_rows(device, gen):
    """The SSD scan against its plain sequential version — y and the final
    state — at every shape of SSD_SHAPES.  No single PyTorch call computes
    the scan: library_ms is None."""
    report, main = [], None
    for shape, decay in SSD_SHAPES:
        bh, s, p, n, chunk, heads = shape
        x, la, bm, cm = _ssd_inputs(shape, decay, device, gen)
        y, st = ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads)
        torch.cuda.synchronize()
        y0, st0 = ssd_scan.ssd_scan_plain(x, la, bm, cm, heads=heads)
        err_y = float((y - y0).abs().max())
        err_s = float((st - st0).abs().max())
        scale_y = float(y0.abs().max())
        scale_s = float(st0.abs().max())
        assert err_y <= SSD_TOL * scale_y and err_s <= SSD_TOL * scale_s, \
            ("ssd_scan disagrees", shape, decay, err_y, scale_y, err_s,
             scale_s)
        # the split-TF32 kernels' own, stricter tier besides
        assert err_y <= SSD_SPLIT_TOL * scale_y \
            and err_s <= SSD_SPLIT_TOL * scale_s, \
            ("ssd_scan outside the split-TF32 tier", shape, decay, err_y,
             scale_y, err_s, scale_s)
        nbytes, flops, bound, by, bound_f32 = _ssd_bound(*shape)
        row = {
            "decay": decay, "max_abs_err": max(err_y, err_s),
            "max_abs_err_y": err_y, "max_abs_y": scale_y,
            "max_abs_err_state": err_s, "max_abs_state": scale_s,
            "rel_err_y": err_y / scale_y, "rel_err_state": err_s / scale_s,
            "ms": _time_ms(lambda: ops.ssd_scan(x, la, bm, cm, chunk=chunk,
                                                heads=heads), cold=True),
            "plain_ms": None, "library_ms": None,
            "bound_ms": bound, "bound_by": by,
            "bound_ms_at_f32_fma": bound_f32,
            "bytes": nbytes, "operations": flops,
        }
        if shape == MAIN_SSD_SHAPE:
            row["plain_ms"] = _time_ms(lambda: ssd_scan.ssd_scan_plain(
                x, la, bm, cm, heads=heads), cold=True, runs=5, warmup=1)
            # one wrapper call (one count): its CUDA launches as the
            # profiler sees them, and the scratch it allocates beside y and
            # the state as the device allocator counts it (the peak of the
            # call less what stays allocated after it)
            traced = _device_kernels(lambda: ops.ssd_scan(
                x, la, bm, cm, chunk=chunk, heads=heads))
            row["cuda_launches_per_call"] = sum(
                k for k, _ in traced.values())
            assert row["cuda_launches_per_call"] >= 1, traced
            del y, st
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y, st = ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads)
            torch.cuda.synchronize()
            row["scratch_bytes"] = (torch.cuda.max_memory_allocated()
                                    - torch.cuda.memory_allocated())
            main = row
        report.append({"shape": list(shape), "ssd_scan": row})
        del x, la, bm, cm, y, st, y0, st0
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


def _planned_launches(req, wave_sizes=None, pool=PoolConfig()):
    """What the port's scheduler plans for a fault-free one-request drain
    (``wave_sizes``: the waves of the wave backend, each the next
    invocations in ascending order; None: one slice of everything):
    program launches, fused launches, blocks and kernel calls (K1 = K2),
    from ``_plan_blocks``, ``_coalesce`` and ``fused_spans``."""
    bplan = plan_buckets([req])
    (key,) = bplan.buckets
    n_inv = req.ledger.n_invocations
    sizes = wave_sizes or [n_inv]
    family = program.bucket_family(key)
    out = dict.fromkeys(("launches", "fused_launches", "blocks",
                         "kernel_calls"), 0)
    start = 0
    for size in sizes:
        entries = [(0, inv) for inv in range(start, start + size)]
        start += size
        blocks = program._plan_blocks(bplan, key, entries, program.B_BLOCK,
                                      1)
        morph = pool.coalesce and program.morph_allowed(
            key, pool.morph_tolerance)
        lblocks = program._coalesce(blocks, program.B_BLOCK, 1, morph,
                                    pool.fuse)
        groups = {}
        for lb in lblocks:
            groups.setdefault(lb.b_pad, []).append(lb)
        out["blocks"] += len(blocks)
        for b_pad, group in groups.items():
            if pool.fuse and len(group) > 1:
                out["launches"] += 1
                out["fused_launches"] += 1
                out["kernel_calls"] += len(program.fused_spans(
                    len(group), b_pad, key.n_pad, key.p_pad,
                    family in program.FUSED_CONCAT_FAMILIES))
                continue
            for lb in group:
                out["launches"] += 1
                out["fused_launches"] += len(lb.parts) > 1
                out["kernel_calls"] += 1
    assert start == n_inv
    return out


def _page_bytes(plan, data):
    """Bytes of the one feature page of a one-bucket request."""
    (key,) = plan_buckets([compile_request(plan, data)]).buckets
    return key.n_pad * key.p_pad * 4


def _counts(launches, calls):
    """The launch counts of a linear-learner drain: ``calls`` of K1 and of
    K2, no other kernel."""
    return launches == {"batched_gram": calls, "batched_gram_blocked": 0,
                        "batched_predict": calls, "crossfit_gram": 0,
                        "flash_attention": 0, "ssd_scan": 0}


def _same_bits(res, res_ref, preds, preds_ref):
    return bool(res.theta == res_ref.theta and res.se == res_ref.se
                and np.array_equal(res.psi[1], res_ref.psi[1])
                and np.array_equal(preds, preds_ref))


def phase_estimate_paper(device):
    """The main path: one request at the paper's configuration, full width
    and depth, on the defaults (same-shape blocks fused, the tail morphed,
    the page pool on) and on the per-block pool.  Launch counts are set to
    0 just before each drain and read just after."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _paper_plan()
    runs = {}
    for name, pool in (("per_block", PER_BLOCK_POOL),
                       ("defaults", PoolConfig())):
        backend = make_backend("inline", pool, device=device)
        linear.reset_solve_status()
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        with _launch_shapes() as seen:
            res = estimate(plan, data, backend=backend)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(runtime.launch_counts)
        _checked(res, None, device, TRUE_EFFECT, f"estimate_paper ({name})")
        _launches_compared(seen, f"estimate_paper ({name})")
        _compared_shapes(backend.compiler, "estimate_paper")
        runs[name] = {"res": res, "wall_s": wall, "launches": launches,
                      "backend": backend,
                      "stats": backend.compiler.stats.summary()}
    per, dft = runs["per_block"], runs["defaults"]
    assert _counts(per["launches"], 32), per["launches"]
    planned = _planned_launches(compile_request(plan, data))
    stats = dft["stats"]
    assert planned == {"launches": 1, "fused_launches": 1, "blocks": 32,
                       "kernel_calls": 1}, planned
    assert (stats["launches"], stats["fused_launches"], stats["blocks"]) \
        == (planned["launches"], planned["fused_launches"],
            planned["blocks"]), stats
    assert _counts(dft["launches"], planned["kernel_calls"]), \
        dft["launches"]
    pages = dft["backend"].pages.stats
    assert (pages.misses, pages.bytes_h2d) == (1, _page_bytes(plan, data)), \
        pages

    # where the time goes, on the host's clock with the device drained at
    # each boundary: lowering, the drain (uploads, launches, harvest,
    # booking), the score; on the defaults, then on the per-block pool
    second = {}
    preds = {}
    for name, pool in (("defaults", PoolConfig()),
                       ("per_block", PER_BLOCK_POOL)):
        t0 = time.perf_counter()
        req2 = compile_request(plan, data)
        t_compile = time.perf_counter() - t0
        backend = make_backend("inline", pool, device=device)
        t0 = time.perf_counter()
        backend.run_requests([req2])
        torch.cuda.synchronize()
        t_drain = time.perf_counter() - t0
        t0 = time.perf_counter()
        res2 = assemble_result(plan, data, req2, device=device)
        torch.cuda.synchronize()
        t_assemble = time.perf_counter() - t0
        _checked(res2, req2, device, TRUE_EFFECT,
                 f"estimate_paper (second run, {name})")
        res = runs[name]["res"]
        assert res2.theta == res.theta and res2.se == res.se and \
            np.array_equal(res2.psi[1], res.psi[1]), \
            "a second run of the same request changed its result"
        preds[name] = (res2, req2.gathered_preds())
        second[name] = {"compile_request_s": t_compile, "drain_s": t_drain,
                        "assemble_result_s": t_assemble,
                        "bitwise_same_result": True}
    (rd, pd), (rp, pp) = preds["defaults"], preds["per_block"]
    fused_bits = _same_bits(rd, rp, pd, pp)
    assert fused_bits, "estimate_paper: the fused drain is not bit for bit " \
        "the per-block drain"
    emit("estimate_paper", n_obs=data.n_obs, dim_x=data.dim_x, n_folds=5,
         n_rep=100, learner="ridge", tasks=req2.grid.n_tasks,
         theta=dft["res"].theta, se=dft["res"].se, planted=TRUE_EFFECT,
         wall_s=dft["wall_s"], launches=dft["launches"],
         compile_stats=stats, planned=planned,
         page_stats=pages.summary(),
         per_block={"wall_s": per["wall_s"], "launches": per["launches"],
                    "compile_stats": per["stats"]},
         fused_bitwise_per_block=fused_bits, second_run=second)
    return dft["launches"], per["launches"]


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
        with _launch_shapes() as seen:
            rid = sess.submit(plan, data)
            res = sess.wait(rid)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(runtime.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        _checked(res, sess.request(rid), device, data.theta0,
                 f"estimate_wide/{learner}")
        _compared_shapes(sess.backend.compiler, "estimate_wide")
        held = _launches_compared(seen, f"estimate_wide/{learner}", device)
        out.append({"learner": learner, "n_rep": n_rep, "theta": res.theta,
                    "se": res.se, "wall_s": wall, "launches": launches,
                    "launch_shapes": sorted(seen["batched_gram"]),
                    "fused_shapes_held": held,
                    "compile_stats": sess.backend.compiler.stats.summary(),
                    "peak_device_bytes": peak})
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
        with _launch_shapes() as seen:
            rids = [sess.submit(p, d) for p, d in jobs]
            results = sess.run()
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = dict(runtime.launch_counts)
        held = _launches_compared(seen, "session", device)
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
         fused_shapes_held=held,
         launches_second_drain=counts,
         compile_stats=sess.backend.compiler.stats.summary())


def phase_same_as_cpu(device):
    """The paper request at M = 4: the plain versions on the CPU against
    the kernels on the card, on the per-block pool (two blocks, two
    launches) and on the defaults (the tail morphed, one fused launch)."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _paper_plan(n_rep=4)
    out = {}
    for pool_name, pool, calls in (("per_block", PER_BLOCK_POOL, 2),
                                   ("defaults", PoolConfig(), 1)):
        got = {}
        for name, dev in (("cpu", "cpu"), ("card", device)):
            sess = DMLSession(backend="inline", pool=pool, device=dev)
            runtime.reset_launch_counts()
            rid = sess.submit(plan, data)
            res = sess.wait(rid)
            got[name] = (res, sess.request(rid).gathered_preds(),
                         dict(runtime.launch_counts))
            _compared_shapes(sess.backend.compiler, "same_as_cpu")
        (rc, pc, lc), (rg, pg, lg) = got["cpu"], got["card"]
        assert _counts(lc, 0), lc
        assert _counts(lg, calls), lg
        np.testing.assert_allclose(pg, pc, rtol=1e-4, atol=1e-5)
        rel_theta = abs(rg.theta - rc.theta) / abs(rc.theta)
        rel_se = abs(rg.se - rc.se) / rc.se
        assert rel_theta < 1e-4 and rel_se < 1e-4, (rel_theta, rel_se)
        out[pool_name] = dict(
            theta_cpu=rc.theta, theta_card=rg.theta, se_cpu=rc.se,
            se_card=rg.se, rel_theta=rel_theta, rel_se=rel_se,
            max_abs_pred_diff=float(np.abs(pg - pc).max()), launches=lg,
            preds=(rc, pc, rg, pg))
    (rc0, pc0, rg0, pg0), (rc1, pc1, rg1, pg1) = \
        out["per_block"].pop("preds"), out["defaults"].pop("preds")
    assert _same_bits(rc1, rc0, pc1, pc0), \
        "same_as_cpu: fused on the CPU is not bit for bit per-block"
    assert _same_bits(rg1, rg0, pg1, pg0), \
        "same_as_cpu: fused on the card is not bit for bit per-block"
    emit("same_as_cpu", **out["per_block"], defaults=out["defaults"],
         fused_bitwise_per_block={"cpu": True, "card": True},
         tolerance="predictions rtol 1e-4, atol 1e-5; theta, se 1e-4 "
                   "relative; fused vs per-block: bit for bit")


@contextlib.contextmanager
def _launch_shapes():
    """Record the operand shape of every kernel launch made inside the
    block: each ``*_cuda`` wrapper is wrapped for the duration (the
    launch counts are the wrappers' own and are not touched)."""
    seen = {name: set() for name in KERNELS}
    real = {name: getattr(KERNEL_MODULES[name], f"{name}_cuda")
            for name in KERNELS}

    def recorder(name):
        def call(operand, *args, **kw):
            shape = tuple(operand.shape)
            if name == "crossfit_gram":         # (T,) of w, then x's (N, P)
                shape = (int(args[0].shape[0]),) + shape
            elif name == "flash_attention":     # ATTN_SHAPES' key
                shape = (shape[0], shape[1], int(args[0].shape[1]), shape[2],
                         TYPE_NAMES[operand.dtype], bool(kw["causal"]),
                         kw["window"])
            elif name == "ssd_scan":            # SSD_SHAPES' key
                shape = shape + (int(args[1].shape[-1]), int(kw["chunk"]),
                                 int(kw["heads"]))
            seen[name].add(shape)
            return real[name](operand, *args, **kw)
        return call

    for name in KERNELS:
        setattr(KERNEL_MODULES[name], f"{name}_cuda", recorder(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(KERNEL_MODULES[name], f"{name}_cuda", fn)


def _hold_megabatch(shape, device):
    """K1 and K2 against their plain versions at one (B, N, P), with the
    kernels phase's inputs and tolerances (no timing)."""
    gen = torch.Generator(device=device).manual_seed(20210104)
    b, n, p = shape
    xs = torch.randn(shape, generator=gen, device=device)
    y = torch.randn((b, n), generator=gen, device=device)
    w = (torch.rand((b, n), generator=gen, device=device) < 0.8).float()
    beta = torch.randn((b, p), generator=gen, device=device)
    valid = (torch.rand((b, n), generator=gen, device=device) < 0.9).float()
    g, bv = ops.batched_gram(xs, w, y)
    g0, b0 = megabatch.batched_gram_plain(xs, w, y)
    assert torch.allclose(g, g0, rtol=1e-4,
                          atol=1e-4 * float(g0.abs().max())), \
        ("batched_gram G disagrees", shape, _errs(g, g0))
    assert torch.allclose(bv, b0, rtol=1e-4,
                          atol=1e-4 * float(b0.abs().max())), \
        ("batched_gram b disagrees", shape, _errs(bv, b0))
    assert torch.equal(g, g.transpose(1, 2)), shape
    del g, g0, bv, b0
    out = ops.batched_predict(xs, beta, valid)
    out0 = megabatch.batched_predict_plain(xs, beta, valid)
    assert torch.allclose(out, out0, rtol=1e-5, atol=1e-5), \
        ("batched_predict disagrees", shape, _errs(out, out0))
    assert bool((out[valid == 0] == 0).all()), shape
    del xs, y, w, beta, valid, out, out0
    torch.cuda.empty_cache()


def _launches_compared(seen, what, device=None):
    """Every launch of a path ran at a shape the kernels phase compared.
    With ``device``, a K1 or K2 launch at another (fused) shape is held
    against the plain versions now instead (not counted: the counts of
    the path were read before); returns those shapes."""
    compared = {"batched_gram": set(SHAPES), "batched_predict": set(SHAPES),
                "batched_gram_blocked": set(BLOCKED_SHAPES),
                "crossfit_gram": set(XFIT_SHAPES),
                "flash_attention": set(ATTN_SHAPES),
                "ssd_scan": {shape for shape, _ in SSD_SHAPES}}
    held = set()
    if device is not None:
        held = (seen["batched_gram"] | seen["batched_predict"]) \
            - compared["batched_gram"]
        for shape in sorted(held):
            _hold_megabatch(shape, device)
        compared["batched_gram"] |= held
        compared["batched_predict"] |= held
    for name, shapes in seen.items():
        assert shapes <= compared[name], \
            f"{what}: {name} launched at {sorted(shapes - compared[name])}"
    return sorted(held)


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
    _reset_pinned_host()
    t0 = time.perf_counter()
    backend.run_requests([req])
    torch.cuda.synchronize()
    t_drain = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pinned = _pinned_host()
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
                     "pinned_host_drain": pinned,
                     "bitwise_same_result": True},
         tolerance="sharded vs inline on the card: predictions atol 5e-4, "
                   "theta and se 1e-4 relative")
    return total


def _reset_pinned_host():
    torch.cuda.reset_peak_host_memory_stats()
    torch.cuda.reset_accumulated_host_memory_stats()


def _pinned_host() -> dict:
    """PyTorch's pinned host allocator since the last reset: bytes held
    (current, peak) and the pinning calls it made, the host side of the
    staged uploads and result copies."""
    return {k: v for k, v in torch.cuda.host_memory_stats().items()
            if k.startswith(("allocated_bytes", "reserved_bytes",
                             "num_host_alloc", "host_alloc_time"))}


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
                            "batched_predict": 0, "crossfit_gram": 1,
                            "flash_attention": 0, "ssd_scan": 0}, launches
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
                        "batched_predict": 0, "crossfit_gram": lanes,
                        "flash_attention": 0, "ssd_scan": 0}, \
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
        _reset_pinned_host()
        t0 = time.perf_counter()
        rid = sess.submit(plan, data)
        res = sess.wait(rid)
        if name == "card":
            torch.cuda.synchronize()
            pinned = _pinned_host()
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
         pinned_host_card=pinned,
         tolerance="card vs CPU: theta and se 1e-4 relative")


# ---------------------------------------------------------------------------
# the wave backend: the API's default, the paper's scheduler (§4, §5)
# ---------------------------------------------------------------------------
def _paper_default_plan(seed: int = CONFIG.seed, **kw) -> DMLPlan:
    # the paper's §5 request (configs/dml_plr_bonus.py) as a user writes
    # it: no backend= (the wave backend) and the default PoolConfig (8
    # workers x 4 lanes, n_rep scaling: 32 invocations of 5 tasks a wave)
    kw.setdefault("scaling", CONFIG.scaling)
    return DMLPlan.for_model(CONFIG.model, learner=CONFIG.learner,
                             learner_params=dict(CONFIG.learner_params),
                             n_folds=CONFIG.n_folds, n_rep=CONFIG.n_rep,
                             seed=seed, **kw)


def _agree(got, want, preds_got, preds_want, what):
    """Float tier of the CPU tests: predictions rtol 1e-4 / atol 1e-5,
    theta and se 1e-4 relative.  Returns whether the bits are equal."""
    np.testing.assert_allclose(preds_got, preds_want, rtol=1e-4, atol=1e-5,
                               err_msg=what)
    rel = (abs(got.theta - want.theta) / abs(want.theta),
           abs(got.se - want.se) / want.se)
    assert max(rel) < 1e-4, f"{what}: theta, se off by {rel}"
    return bool(np.array_equal(preds_got, preds_want)
                and got.theta == want.theta and got.se == want.se)


def _timed_estimate(sess, plan, data):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.estimate(plan, data)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_estimate_wave(device):
    """The paper's request on the API's defaults — the wave backend —
    at full width and depth: cold through ``estimate`` on the per-block
    pool and on the defaults, then warm on sessions, beside the inline
    backend on the same data in the same call.  Launch counts are set to
    0 just before each drain."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _paper_default_plan()
    assert plan.backend == "wave" and plan.pool is None
    cold = {}
    for name, cold_plan in (
            ("per_block", _paper_default_plan(pool=PER_BLOCK_POOL)),
            ("defaults", plan)):
        linear.reset_solve_status()
        torch.cuda.synchronize()
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        with _launch_shapes() as seen:
            res = estimate(cold_plan, data)
            torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = dict(runtime.launch_counts)
        _checked(res, None, device, TRUE_EFFECT,
                 f"estimate_wave (cold, {name})")
        _launches_compared(seen, f"estimate_wave (cold, {name})")
        sizes = res.report.wave_sizes
        assert sizes == [32] * 6 + [8], sizes
        cold[name] = {"res": res, "cold_s": cold_s, "launches": launches}
    req = compile_request(plan, data)
    planned_per_block = _planned_launches(req, sizes, PER_BLOCK_POOL)
    assert planned_per_block["kernel_calls"] == 32, planned_per_block
    assert _counts(cold["per_block"]["launches"], 32), \
        cold["per_block"]["launches"]
    planned = _planned_launches(req, sizes)
    assert planned == {"launches": 7, "fused_launches": 7, "blocks": 32,
                       "kernel_calls": 7}, planned
    assert _counts(cold["defaults"]["launches"], planned["kernel_calls"]), \
        cold["defaults"]["launches"]
    launches = cold["defaults"]["launches"]

    sessions = {"wave": DMLSession(device=device),
                "inline": DMLSession(backend="inline", device=device),
                "wave_per_block": DMLSession(pool=PER_BLOCK_POOL,
                                             device=device)}
    assert sessions["wave"].backend.name == "wave"
    pool = sessions["wave"].backend.pool
    assert pool == PoolConfig()
    out = {name: {"warm_s": []} for name in sessions}
    for name, sess in sessions.items():                  # warm-up drains
        sess.estimate(plan, data)
    for _ in range(3):                                   # in turns
        for name, sess in sessions.items():
            linear.reset_solve_status()
            runtime.reset_launch_counts()
            _reset_pinned_host()
            stats0 = dataclasses.replace(sess.backend.compiler.stats)
            pool_t = sess.backend.pages
            pages0 = pool_t and pool_t.stats.snapshot()
            res, wall = _timed_estimate(sess, plan, data)
            rid = sess.completion_order[-1]
            _checked(res, sess.request(rid), device, TRUE_EFFECT,
                     f"estimate_wave ({name}, warm)")
            info = sess.last_run_info
            st = info.compile
            out[name]["warm_s"].append(wall)
            out[name].update(
                res=res, preds=sess.request(rid).gathered_preds(),
                launches=dict(runtime.launch_counts), waves=info.waves,
                program_launches=st.launches - stats0.launches,
                fused_launches=st.fused_launches - stats0.fused_launches,
                dispatch=dataclasses.asdict(info.dispatch),
                page_stats=pool_t and pool_t.stats.delta(pages0).summary(),
                pinned_host=_pinned_host())
    _compared_shapes(sessions["wave"].backend.compiler, "estimate_wave")
    w, i, wp = out["wave"], out["inline"], out["wave_per_block"]
    assert w["launches"] == launches, w["launches"]
    assert (w["program_launches"], w["fused_launches"]) == \
        (planned["launches"], planned["fused_launches"]), w
    assert _counts(wp["launches"], 32), wp["launches"]
    assert w["waves"] == 7 and w["dispatch"]["dispatched"] == 7, w
    # a warm drain of the same data uploads no page
    assert w["page_stats"]["page_misses"] == 0 and \
        w["page_stats"]["page_bytes_h2d"] == 0, w["page_stats"]
    bitwise = _agree(w["res"], i["res"], w["preds"], i["preds"],
                     "estimate_wave: wave vs inline")
    fused_bits = _same_bits(w["res"], wp["res"], w["preds"], wp["preds"])
    assert fused_bits, "estimate_wave: the fused drain is not bit for bit " \
        "the per-block drain"
    cold_same = _agree(cold["defaults"]["res"], w["res"], w["preds"],
                       w["preds"], "estimate_wave: cold vs warm")
    emit("estimate_wave", n_obs=data.n_obs, dim_x=data.dim_x, n_folds=5,
         n_rep=100, learner="ridge", backend=plan.backend,
         pool={"n_workers": pool.n_workers,
               "lanes_per_worker": pool.lanes_per_worker(),
               "pipeline_depth": pool.pipeline_depth,
               "scaling": plan.scaling, "fuse": pool.fuse,
               "coalesce": pool.coalesce,
               "page_pool_bytes": pool.page_pool_bytes},
         theta=w["res"].theta, se=w["res"].se, theta_inline=i["res"].theta,
         se_inline=i["res"].se, bitwise_equal_to_inline=bitwise,
         fused_bitwise_per_block=fused_bits,
         cold_equals_warm=cold_same, wave_sizes=sizes,
         launches=launches, planned=planned,
         launches_per_block=cold["per_block"]["launches"],
         planned_per_block=planned_per_block,
         cold_s={k: v["cold_s"] for k, v in cold.items()},
         warm_s={k: v["warm_s"] for k, v in out.items()},
         program_launches={k: v["program_launches"] for k, v in out.items()},
         dispatch={k: v["dispatch"] for k, v in out.items()},
         page_stats={k: v["page_stats"] for k, v in out.items()},
         pinned_host={k: v["pinned_host"] for k, v in out.items()},
         tolerance="wave vs inline: predictions rtol 1e-4 / atol 1e-5, "
                   "theta and se 1e-4 relative; fused vs per-block: bit "
                   "for bit")
    return launches, cold["per_block"]["launches"]


def phase_wave_pool(device):
    """The paper's Figure 3 sweep on the card: both scaling levels x four
    worker memories, simulated Lambda durations (``simulate=True``,
    ``base_work_s`` 0.35, 10 000 workers, as examples/serverless_scaling.py
    runs it) on the full paper request; then one drain of the paper
    request under the fault model (failures, stragglers with a held
    tail, hedged re-dispatch), which must land the fault-free estimate."""
    data = DMLData.from_dict(make_bonus_data())
    rows = []
    for scaling in FIG3_SCALING_GRID:
        for mem in FIG3_MEMORY_GRID:
            pool = PoolConfig(n_workers=10_000, memory_mb=mem,
                              simulate=True, base_work_s=0.35, seed=0)
            plan = _paper_default_plan(scaling=scaling, pool=pool)
            linear.reset_solve_status()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = estimate(plan, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _checked(res, None, device, TRUE_EFFECT,
                     f"wave_pool ({scaling}, {mem} MB)")
            rep = res.report
            assert rep.waves == 1 and rep.failures == 0, rep.summary()
            rows.append({
                "scaling": scaling, "memory_mb": mem,
                "response_time_s": rep.response_time_s,
                "modeled_wave_s": max(b.duration_s for b in rep.bill.records)
                + pool.dispatch_overhead_s,
                "fit_time_s": rep.fit_time_s,
                "billed_gb_s": rep.bill.total_gb_s,
                "usd": rep.bill.total_gb_s * USD_PER_GB_S,
                "invocations": rep.bill.n_invocations, "wall_s": wall,
                "theta": res.theta})
    # the example's claim (Fig 3): time falls with memory at n_rep scaling
    t_split = [r["response_time_s"] for r in rows if r["scaling"] == "n_rep"]
    assert all(b < a for a, b in zip(t_split, t_split[1:])), t_split
    per_fold = [r for r in rows if r["scaling"] != "n_rep"]
    per_split = [r for r in rows if r["scaling"] == "n_rep"]
    faster = sum(f["response_time_s"] < s["response_time_s"]
                 for f, s in zip(per_fold, per_split))

    clean_plan = _paper_default_plan()
    clean = DMLSession(device=device)
    clean_res = clean.estimate(clean_plan, data)
    chaos_pool = PoolConfig(failure_rate=0.3, straggler_rate=0.2,
                            max_retries=10, seed=5, straggler_hold_s=0.05,
                            hedge=True, hedge_after_s=0.01)
    sess = DMLSession(pool=chaos_pool, device=device)
    linear.reset_solve_status()
    with _launch_shapes() as seen:
        res, wall = _timed_estimate(sess, clean_plan, data)
    held = _launches_compared(seen, "wave_pool (chaos)", device)
    _checked(res, sess.request(0), device, TRUE_EFFECT, "wave_pool (chaos)")
    d = sess.last_run_info.dispatch
    rep = res.report
    assert rep.failures > 0 and d.hedges >= 1, (rep.summary(), d)
    assert d.cancelled == d.hedges and \
        d.harvested == d.dispatched - d.cancelled, d
    assert rep.bill.n_invocations == sess.request(0).ledger.n_invocations
    bitwise = _agree(res, clean_res, sess.request(0).gathered_preds(),
                     clean.request(0).gathered_preds(),
                     "wave_pool: chaos vs fault-free")
    emit("wave_pool", n_obs=data.n_obs, dim_x=data.dim_x, n_folds=5,
         n_rep=100, base_work_s=0.35, n_workers=10_000, points=rows,
         time_falls_with_memory=True,
         per_fold_faster_at=f"{faster}/{len(per_split)}",
         chaos={"pool": {"failure_rate": 0.3, "straggler_rate": 0.2,
                         "max_retries": 10, "seed": 5,
                         "straggler_hold_s": 0.05, "hedge": True,
                         "hedge_after_s": 0.01},
                "failures": rep.failures, "stragglers": rep.stragglers,
                "retries_billed": sum(1 for b in rep.bill.records
                                      if b.retry),
                "waves": rep.waves, "wall_s": wall,
                "dispatch": dataclasses.asdict(d),
                "theta": res.theta, "se": res.se,
                "theta_fault_free": clean_res.theta,
                "bitwise_equal_to_fault_free": bitwise,
                "fused_shapes_held": held},
         tolerance="chaos vs fault-free: predictions rtol 1e-4 / atol "
                   "1e-5, theta and se 1e-4 relative")


def _session_wave_run(device, jobs, bonus, pool):
    """One default-plan session drain of ``jobs`` on ``pool``: two paper
    requests, and a PLIV request submitted from the first one's
    ``on_complete``.  Launch counts are set to 0 just before."""
    sess = DMLSession(pool=pool, device=device)
    assert sess.backend.name == "wave"
    late = []

    def first_done(res):
        if not late:
            late.append(sess.submit(*jobs[2]))

    linear.reset_solve_status()
    runtime.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        rids = [sess.submit(*jobs[0], on_complete=first_done),
                sess.submit(*jobs[1])]
        results = sess.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    info = sess.last_run_info
    assert late, "the first request never completed"
    rids.append(late[0])
    assert sess.completion_order == [rids[0], rids[2], rids[1]], \
        sess.completion_order
    assert info.shared_waves >= 1, info.wave_members
    assert [r.request_id for r in results] == rids[:2]
    _compared_shapes(sess.backend.compiler, "session_wave")
    for rid, (plan, data) in zip(rids, jobs):
        truth = TRUE_EFFECT if data is bonus else data.theta0
        _checked(sess.result(rid), sess.request(rid), device, truth,
                 f"session_wave/request {rid}")
    held = _launches_compared(seen, "session_wave", device)
    return sess, rids, {"wall_s": wall, "launches": launches,
                        "held": held, "info": info}


def phase_session_wave(device):
    """``DMLSession()`` on its default backend: two paper requests, and a
    PLIV request submitted from the first one's ``on_complete``
    (continuous admission); on the per-block pool and on the defaults,
    each result held against its own inline drain and the defaults'
    bit for bit against the per-block pool's."""
    bonus = DMLData.from_dict(make_bonus_data())
    pliv = DMLData.from_dict(make_pliv_data(n_obs=5000, dim_x=20))
    jobs = [(_paper_default_plan(42), bonus), (_paper_default_plan(43), bonus),
            (DMLPlan.for_model("pliv", learner="ridge", n_folds=5, n_rep=10),
             pliv)]
    per_sess, per_rids, per = _session_wave_run(device, jobs, bonus,
                                                PER_BLOCK_POOL)
    sess, rids, dft = _session_wave_run(device, jobs, bonus, PoolConfig())
    assert per["launches"]["batched_gram"] == \
        per["info"].compile.launches, per["launches"]
    info = dft["info"]
    st = info.compile
    assert st.fused_launches >= 1 and st.launches < per["info"].compile.launches
    assert dft["launches"]["batched_gram"] == \
        dft["launches"]["batched_predict"] > 0, dft["launches"]
    assert _counts(dft["launches"], dft["launches"]["batched_gram"])
    inline = DMLSession(backend="inline", device=device)
    agree, fused_bits = [], []
    for rid, prid, (plan, data) in zip(rids, per_rids, jobs):
        res, preds = sess.result(rid), sess.request(rid).gathered_preds()
        ref = inline.estimate(plan, data)
        agree.append(_agree(res, ref, preds,
                            inline.request(inline.completion_order[-1])
                            .gathered_preds(),
                            f"session_wave/request {rid} vs inline"))
        fused_bits.append(_same_bits(
            res, per_sess.result(prid), preds,
            per_sess.request(prid).gathered_preds()))
    assert all(fused_bits), ("session_wave: the fused drain is not bit for "
                             "bit the per-block drain", fused_bits)
    emit("session_wave", requests=["plr paper seed 42", "plr paper seed 43",
                                   "pliv 5000 x 20, K 5, M 10 (submitted "
                                   "from request 0's on_complete)"],
         completion_order=sess.completion_order, waves=info.waves,
         shared_waves=info.shared_waves,
         wave_members=[len(m) for m in info.wave_members],
         thetas=[sess.result(r).theta for r in rids],
         bitwise_equal_to_inline=agree,
         fused_bitwise_per_block=fused_bits, wall_s=dft["wall_s"],
         launches=dft["launches"], compile_stats=st.summary(),
         fused_shapes_held=dft["held"],
         page_stats=info.pages.summary(),
         dispatch=dataclasses.asdict(info.dispatch),
         per_block={"wall_s": per["wall_s"], "launches": per["launches"],
                    "waves": per["info"].waves,
                    "compile_stats": per["info"].compile.summary()},
         tolerance="each request vs its inline drain: predictions rtol "
                   "1e-4 / atol 1e-5, theta and se 1e-4 relative; the "
                   "defaults vs the per-block pool: bit for bit")


# ---------------------------------------------------------------------------
# the warm path: fused and coalesced launches, the device-resident page pool
# ---------------------------------------------------------------------------
# (family, params, model) of each ported learner family the fusion phase
# drives: the linear ones on two paper-sized PLR requests (the paper's, M
# 100, and one at M 98 on a second dataset: 61 full blocks and tails of 8
# and 20, which pack into one 32-lane block at offsets 0 and 8), logistic
# as the IRM propensity (M 20: 6 full blocks and two tails of 4)
FUSION_CASES = (("ols", {}, "plr"), ("ridge", {"reg": 1.0}, "plr"),
                ("lasso", {"reg": 0.01}, "plr"),
                ("logistic", {"reg": 1.0}, "irm"))
# the morph tolerance tier: predictions within this of the canonical
# launch's (the float tier of the CPU tests is rtol 1e-4 / atol 1e-5)
MORPH_TOL = 1e-5


def _fusion_bucket(family, params, model, device):
    """Two compiled requests of one bucket of ``family`` and that bucket's
    pending entries."""
    if model == "plr":
        datas = [DMLData.from_dict(make_bonus_data()),
                 DMLData.from_dict(make_bonus_data(seed=2718))]
        plans = [DMLPlan.for_model("plr", learner=family,
                                   learner_params=params, n_folds=5,
                                   n_rep=n_rep, seed=42 + i)
                 for i, n_rep in enumerate((100, 98))]
    else:
        datas = [DMLData.from_dict(make_irm_data(n_obs=5000, dim_x=20,
                                                 seed=1 + i))
                 for i in range(2)]
        plans = [DMLPlan.for_model("irm", learner="ridge", n_folds=5,
                                   n_rep=20, seed=7 + i) for i in range(2)]
    bplan = plan_buckets([compile_request(p, d)
                          for p, d in zip(plans, datas)])
    (key,) = [k for k in bplan.buckets
              if program.bucket_family(k) == family]
    if model == "irm":
        assert dict(key.learner[1]) == params, key.learner
    return bplan, key, bplan.pending_by_bucket()[key]


def _fusion_run(bplan, key, entries, device, **kw):
    """One dispatch of the bucket slice on a fresh program cache: results,
    CompileStats, kernel calls."""
    cache = program.ProgramCache()
    runtime.reset_launch_counts()
    results = program.dispatch_bucket(bplan, cache, key, entries,
                                      device=device, **kw).harvest()
    torch.cuda.synchronize()
    return results, cache.stats, dict(runtime.launch_counts)


def _max_diff(got, want):
    assert got.keys() == want.keys()
    return max(float(np.abs(got[e] - want[e]).max()) for e in want)


@contextlib.contextmanager
def _patched(name, value):
    real = getattr(program, name)
    setattr(program, name, value)
    try:
        yield
    finally:
        setattr(program, name, real)


def phase_fusion(device):
    """Each ported family on the card: fused launches against per-block
    launches, and packed and morphed tails against their canonical
    shapes, on the same bucket slice; bit for bit for the families of the
    bitwise sets, the stated tier for the others, and for every family
    the measured difference of the concatenated form.  Then one fused
    launch split into single-block sub-calls against the one call."""
    rows = []
    for family, params, model in FUSION_CASES:
        bplan, key, entries = _fusion_bucket(family, params, model, device)
        per, st_p, calls_p = _fusion_run(bplan, key, entries, device,
                                         fuse=False, coalesce=False)
        fused, st_f, calls_f = _fusion_run(bplan, key, entries, device,
                                           fuse=True, coalesce=False)
        morphed, st_m, calls_m = _fusion_run(bplan, key, entries, device,
                                             fuse=True, coalesce=True,
                                             morph_tolerance=1.0)
        with _patched("FUSED_CONCAT_FAMILIES", frozenset({family})):
            concat, _, calls_c = _fusion_run(bplan, key, entries, device,
                                             fuse=True, coalesce=False)
        concat_mode = family in program.FUSED_CONCAT_FAMILIES
        morph_bitwise = family in program.MORPH_BITWISE_FAMILIES
        d_fused, d_morph = _max_diff(fused, per), _max_diff(morphed, per)
        d_concat = _max_diff(concat, per)
        # fused launches are the per-block launches' bits, whatever form
        assert d_fused == 0.0, (family, "fused", d_fused)
        if concat_mode:
            assert d_concat == 0.0, (family, "concatenated", d_concat)
        if morph_bitwise:
            assert d_morph == 0.0, (family, "morphed", d_morph)
        else:
            assert family in program.MORPH_TOLERANCE_FAMILIES, family
            assert d_morph <= MORPH_TOL, (family, "morphed", d_morph)
        assert st_f.fused_launches >= 1 and st_m.coalesced_blocks >= 2, \
            (st_f, st_m)
        # one K1 and one K2 call a program call, and a concatenated fused
        # launch is one call for its group; logistic's IRLS runs on
        # library products and launches neither
        kernels = family != "logistic"
        assert calls_p["batched_gram"] == calls_p["batched_predict"] == \
            st_p.launches * kernels, (family, st_p, calls_p)
        want_calls = (st_f.launches if concat_mode else st_p.launches) \
            * kernels
        assert calls_f["batched_gram"] == calls_f["batched_predict"] == \
            want_calls, (family, calls_f, want_calls)
        rows.append({
            "family": family, "params": params, "bucket": [key.n_pad,
                                                           key.p_pad],
            "tasks": st_p.padding.tasks,
            "fused_form": "concatenated" if concat_mode else "per block",
            "per_block": {"launches": st_p.launches,
                          "kernel_calls": calls_p["batched_gram"]},
            "fused": {"launches": st_f.launches,
                      "fused_launches": st_f.fused_launches,
                      "kernel_calls": calls_f["batched_gram"],
                      "max_abs_diff": d_fused},
            "morphed": {"launches": st_m.launches,
                        "coalesced_blocks": st_m.coalesced_blocks,
                        "kernel_calls": calls_m["batched_gram"],
                        "max_abs_diff": d_morph,
                        "tier": "bitwise" if morph_bitwise
                        else f"tolerance {MORPH_TOL}"},
            "concatenated_measured": {"kernel_calls": calls_c["batched_gram"],
                                      "max_abs_diff": d_concat}})
        del per, fused, morphed, concat
        torch.cuda.empty_cache()

    # a fused launch whose pages pass the gather bound runs as sub-calls
    # of whole blocks: one block a call here, against the one call
    bplan, key, entries = _fusion_bucket("ridge", {"reg": 1.0}, "plr",
                                         device)
    one, st_1, calls_1 = _fusion_run(bplan, key, entries, device)
    block_bytes = program.B_BLOCK * key.n_pad * key.p_pad * 4
    with _patched("FUSED_GATHER_BYTES", block_bytes):
        split, st_s, calls_s = _fusion_run(bplan, key, entries, device)
    assert st_s.launches == st_1.launches == 1, (st_1, st_s)
    # the full blocks and one launch block carrying both tails
    n_launch_blocks = st_s.blocks - st_s.coalesced_blocks + 1
    assert calls_1["batched_gram"] == 1 and \
        calls_s["batched_gram"] == n_launch_blocks, (calls_1, calls_s, st_s)
    d_split = _max_diff(split, one)
    assert d_split == 0.0, ("split", d_split)
    emit("fusion", families=rows,
         fused_concat_families=sorted(program.FUSED_CONCAT_FAMILIES),
         morph_bitwise_families=sorted(program.MORPH_BITWISE_FAMILIES),
         morph_tolerance_families=sorted(program.MORPH_TOLERANCE_FAMILIES),
         fused_gather_bytes=program.FUSED_GATHER_BYTES,
         split={"bound_bytes": block_bytes,
                "kernel_calls": calls_s["batched_gram"],
                "kernel_calls_one_call": calls_1["batched_gram"],
                "max_abs_diff": d_split},
         tolerance="fused vs per-block: bit for bit, every family; morphed "
                   "vs canonical: bit for bit for the morph-bitwise "
                   f"families, else within {MORPH_TOL}; split vs one call: "
                   "bit for bit")


def _recording_stacks(pool):
    """Record the tensor ``pool.stack`` hands each call (an instance
    attribute over the method; nothing is counted)."""
    handed = []
    real = pool.stack

    def stack(needs, n_pad, p_pad):
        out = real(needs, n_pad, p_pad)
        handed.append(out)
        return out

    pool.stack = stack
    return handed


def phase_page_pool(device):
    """The device-resident page pool on the default wave backend: two
    warm drains of the paper request beside a second dataset of its
    shape (one bucket, two pages, a stacked composition); the second
    drain uploads no page and is handed the very tensors of the first.
    Then a budget of one page, which forces evictions, with its
    ``PageStats`` checked; and a directory fetch between two pools."""
    datas = [DMLData.from_dict(make_bonus_data()),
             DMLData.from_dict(make_bonus_data(seed=2718))]
    plan = _paper_default_plan()
    page_bytes = _page_bytes(plan, datas[0])
    sess = DMLSession(device=device)
    pool = sess.backend.pages
    assert pool is not None and pool.byte_budget == 256 * 1024 * 1024
    handed = _recording_stacks(pool)
    drains = []
    for _ in range(2):
        before = pool.stats.snapshot()
        start = len(handed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for data in datas:
            sess.submit(plan, data)
        results = sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for res in results:
            _checked(res, None, device, TRUE_EFFECT, "page_pool")
        drains.append({"wall_s": wall,
                       "stats": pool.stats.delta(before),
                       "handed": handed[start:],
                       "thetas": [r.theta for r in results]})
    cold, warm = drains
    assert cold["stats"].misses == 2 and \
        cold["stats"].bytes_h2d == 2 * page_bytes, cold["stats"]
    assert cold["stats"].stack_builds >= 1, cold["stats"]
    assert warm["stats"].misses == 0 and warm["stats"].bytes_h2d == 0 and \
        warm["stats"].stack_builds == 0, warm["stats"]
    assert len(warm["handed"]) == len(cold["handed"]) and all(
        a is b for a, b in zip(warm["handed"], cold["handed"])), \
        "a warm drain was handed another stack tensor"
    assert any(t.shape[0] == 2 for t in warm["handed"]), \
        [tuple(t.shape) for t in warm["handed"]]
    assert warm["thetas"] == cold["thetas"]

    # a budget of one page: the paper request, the second dataset, the
    # paper request again, each alone — every drain's one page evicts the
    # other's; 7 waves a drain, one stack call each
    small = DMLSession(pool=PoolConfig(page_pool_bytes=page_bytes),
                       device=device)
    for data in (datas[0], datas[1], datas[0]):
        small.estimate(plan, data)
    st = small.backend.pages.stats
    want = {"hits": 18, "misses": 3, "evictions": 2, "stack_builds": 3,
            "stack_hits": 18, "bytes_h2d": 3 * page_bytes,
            "bytes_saved": 18 * page_bytes, "cross_host_fetches": 0,
            "bytes_d2d": 0}
    assert dataclasses.asdict(st) == want, dataclasses.asdict(st)
    assert small.backend.pages.total_bytes == page_bytes

    # two pools on one device, one directory: a miss in the second is a
    # device-to-device copy of the first's page
    from repro_torch.compile import PageDirectory, PagePool
    directory = PageDirectory()
    pools = [PagePool(device=device, host_id=h, directory=directory)
             for h in range(2)]
    req = compile_request(plan, datas[0])
    (key,) = plan_buckets([req]).buckets
    pk = PagePool.page_key(req, key.n_pad, key.p_pad)
    first = pools[0].stack([(pk, req)], key.n_pad, key.p_pad)
    fetched = pools[1].stack([(pk, req)], key.n_pad, key.p_pad)
    torch.cuda.synchronize()
    assert fetched is not first and torch.equal(fetched, first)
    assert (pools[1].stats.cross_host_fetches, pools[1].stats.bytes_d2d,
            pools[1].stats.bytes_h2d) == (1, page_bytes, 0), pools[1].stats
    assert directory.fetches == 1 and directory.holders(pk) == {0, 1}
    pools[0].invalidate()
    assert directory.holders(pk) == {1} and pools[0].n_pages == 0
    emit("page_pool", page_bytes=page_bytes,
         drains=[{"wall_s": d["wall_s"], "page_stats": d["stats"].summary(),
                  "stack_calls": len(d["handed"]),
                  "stack_shapes": sorted({tuple(t.shape)
                                          for t in d["handed"]})}
                 for d in drains],
         warm_same_tensors=True, one_page_budget=want,
         directory={"fetches": directory.fetches,
                    "bytes_d2d": pools[1].stats.bytes_d2d})


# ---------------------------------------------------------------------------
# the nonparametric learners and the bootstrap (kernel_ridge, mlp)
# ---------------------------------------------------------------------------
QUICKSTART_PARAMS = {"reg": 1.0, "n_landmarks": 256}
QUICKSTART_POOL = PoolConfig(n_workers=8, memory_mb=1024)
N_BOOT = 500


def _quickstart_plan(**kw) -> DMLPlan:
    # the README's quickstart as a user writes it: the paper's request
    # (make_bonus_data, PLR, K 5, M 100, seed 42, n_rep scaling) with
    # kernel_ridge on the wave backend
    return DMLPlan.for_model(
        "plr", learner="kernel_ridge",
        learner_params=dict(QUICKSTART_PARAMS), n_folds=5, n_rep=100,
        seed=42, scaling="n_rep", backend="wave", pool=QUICKSTART_POOL,
        **kw)


def _sync_sites(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result, and the synchronising calls it made, counted by the source
    line that made them."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        path = Path(w.filename)
        site = f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path.name}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    return out, sites


def _tier_units(got, want):
    """The largest |got - want| in units of the float tier's bound."""
    return float((np.abs(got - want) / (1e-5 + 1e-4 * np.abs(want))).max())


def _compare(got, want, preds_got, preds_want):
    """How far one result is from another: predictions in float-tier
    units and absolute, theta and se relative, and whether every bit is
    equal."""
    diff = np.abs(preds_got - preds_want)
    units = diff / (1e-5 + 1e-4 * np.abs(preds_want))
    lanes = units.reshape(-1, units.shape[-1]).max(axis=1)
    return {"preds_tier_units": float(units.max()),
            "preds_max_abs_diff": float(diff.max()),
            "preds_abs_diff_quantiles": {
                q: float(np.quantile(diff, float(q)))
                for q in ("0.5", "0.9", "0.99", "0.999")},
            "preds_share_in_tier": float((units <= 1.0).mean()),
            "tasks_out_of_tier": int((lanes > 1.0).sum()),
            "tasks": int(lanes.size),
            "rel_theta": abs(got.theta - want.theta) / abs(want.theta),
            "rel_se": abs(got.se - want.se) / want.se,
            "bitwise": bool(np.array_equal(preds_got, preds_want)
                            and got.theta == want.theta
                            and got.se == want.se)}


# Measured tolerances of the nonparametric learners, card against CPU
# (PERF.md §6 and ROADMAP Queue 3; NVIDIA H100 80GB HBM3, 700 W),
# each about twice what was measured.  kernel_ridge: Kmm of the bonus data
# is singular but for its jitter (repeated landmark rows, condition 1.9e8),
# so cuSOLVER's and LAPACK's eigenvectors differ in its null directions
# (measured: predictions 0.128 apart at most, theta 5.6e-5 and se 5.0e-4
# relative, the bootstrap interval's ends 0.014 se).  mlp: Adam turns an
# ulp of a gradient into a step of lr, and 300 steps amplify it (PLR M 2:
# predictions 0.033 apart, theta 0.0007 se; IRM M 2, whose propensities
# enter the score inverted: predictions 0.239, theta 0.078 se, se 2.8%).
# (max |prediction difference|, theta's difference in se, se relative)
QUICKSTART_TOL = (0.25, 0.01, 2e-3)
MLP_TOL = {"plr": (0.1, 0.05, 1e-3), "irm": (0.5, 0.25, 0.1)}


def _within(cmp, got, want, tol, what):
    """A ``_compare`` result within a measured tolerance (``tol`` as
    QUICKSTART_TOL)."""
    preds_abs, theta_se, se_rel = tol
    off = abs(got.theta - want.theta) / want.se
    assert cmp["preds_max_abs_diff"] <= preds_abs and off <= theta_se \
        and cmp["rel_se"] <= se_rel, (what, off, cmp)


def _kernel_ridge_block_vs_f64(plan, data, device):
    """The first 32 tasks of a kernel_ridge request as one block, through
    the batched learner on the card and on the CPU, and through the same
    fit in float64 on the CPU on the same landmarks: how far each float32
    route is from the float64 fit, in float-tier units."""
    req = compile_request(plan, data)
    params = dict(req.segments[0].params)
    m, reg, gamma = params["n_landmarks"], params["reg"], params["gamma"]
    tasks = np.arange(32)
    y, w = req.wave_arrays(tasks)
    kd = torch.from_numpy(req.task_key_data(0, tasks))
    xs = torch.from_numpy(np.asarray(data.x, np.float32)).expand(
        32, *data.x.shape).contiguous()
    y, w = torch.from_numpy(y), torch.from_numpy(w)
    valid = torch.ones_like(y)
    fn = get_batched_learner("kernel_ridge", params)
    card = fn(*(a.to(device) for a in (xs, y, w, valid, kd))).cpu().numpy()
    cpu = fn(xs, y, w, valid, kd).numpy()

    b, n, p = xs.shape
    f64 = torch.float64
    idx = kernel_ridge.landmark_idx(kd, n, m)
    x64 = xs.to(f64)
    lm = torch.gather(x64, 1, idx.unsqueeze(-1).expand(b, m, p))

    def rbf(a, c):
        return torch.exp(-gamma * torch.cdist(a, c) ** 2)

    evals, evecs = torch.linalg.eigh(rbf(lm, lm)
                                     + 1e-6 * torch.eye(m, dtype=f64))
    inv_sqrt = (evecs / torch.sqrt(evals.clamp_min(1e-8)).unsqueeze(-2)) \
        @ evecs.transpose(1, 2)
    xa = torch.cat([rbf(x64, lm) @ inv_sqrt,
                    torch.ones((b, n, 1), dtype=f64)], -1)
    w64, y64 = w.to(f64), y.to(f64)
    g = torch.einsum("bnp,bn,bnq->bpq", xa, w64, xa) \
        + reg * torch.eye(m + 1, dtype=f64)
    g[:, m, m] += -reg + 1e-8
    beta = torch.linalg.solve(g, torch.einsum("bnp,bn->bp", xa, w64 * y64))
    exact = (xa @ beta.unsqueeze(-1)).squeeze(-1).numpy()
    return {"tasks": 32, "n_landmarks": m,
            "kmm_condition_max": float((evals.max(-1).values
                                        / evals.min(-1).values).max()),
            "card_tier_units_vs_f64": _tier_units(card, exact),
            "cpu_tier_units_vs_f64": _tier_units(cpu, exact),
            "card_vs_cpu_tier_units": _tier_units(card, cpu),
            "card_max_abs_vs_f64": float(np.abs(card - exact).max()),
            "cpu_max_abs_vs_f64": float(np.abs(cpu - exact).max())}


def phase_estimate_quickstart(device):
    """The README's quickstart on the card: kernel_ridge with 256
    landmarks, whose ridge solve runs the Gram and predict kernels at
    (B, 5104, 257), on the wave backend.  Cold through ``estimate`` (launch
    counts set to 0 just before, read just after), then warm in turns with
    the inline backend (bit for bit), then with the multiplier
    bootstrap; each held against the CPU path to QUICKSTART_TOL, and one
    block against a float64 fit.  Also the shared-X form (one
    crossfit_gram launch at P 257) against the CPU."""
    data = DMLData.from_dict(make_bonus_data())
    plan = _quickstart_plan()
    linear.reset_solve_status()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        res_cold = estimate(plan, data)
        torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    _checked(res_cold, None, device, TRUE_EFFECT, "estimate_quickstart")
    _launches_compared(seen, "estimate_quickstart")
    assert seen["batched_gram"] == set(QUICKSTART_SHAPES), seen
    sizes = res_cold.report.wave_sizes
    planned = _planned_launches(compile_request(plan, data), sizes,
                                QUICKSTART_POOL)
    assert _counts(launches, planned["kernel_calls"]), (launches, planned)
    assert planned["kernel_calls"] == 32, planned

    sessions = {"wave": DMLSession(pool=QUICKSTART_POOL, device=device),
                "inline": DMLSession(backend="inline", device=device)}
    for sess in sessions.values():                   # warm-up drains
        sess.estimate(plan, data)
    out = {name: {"warm_s": []} for name in sessions}
    syncs = None
    for turn in range(1):                            # in turns
        for name, sess in sessions.items():
            linear.reset_solve_status()
            runtime.reset_launch_counts()
            if name == "wave" and turn == 0:
                (res, wall), syncs = _sync_sites(
                    lambda: _timed_estimate(sess, plan, data))
            else:
                res, wall = _timed_estimate(sess, plan, data)
            rid = sess.completion_order[-1]
            _checked(res, sess.request(rid), device, TRUE_EFFECT,
                     f"estimate_quickstart ({name}, warm)")
            out[name]["warm_s"].append(wall)
            out[name].update(res=res,
                             preds=sess.request(rid).gathered_preds(),
                             launches=dict(runtime.launch_counts))
    w, i = out["wave"], out["inline"]
    assert w["launches"] == launches, w["launches"]
    wave_inline = _compare(w["res"], i["res"], w["preds"], i["preds"])
    cold_bits = _same_bits(res_cold, w["res"], w["preds"], w["preds"])

    # the bootstrap on the card, then the whole request on the CPU
    boot_plan = _quickstart_plan(n_boot=N_BOOT)
    sess = sessions["wave"]
    res_boot, boot_s = _timed_estimate(sess, boot_plan, data)
    assert res_boot.boot_ci is not None
    t0 = time.perf_counter()
    cpu = DMLSession(pool=QUICKSTART_POOL, device="cpu")
    res_cpu = cpu.estimate(boot_plan, data)
    cpu_s = time.perf_counter() - t0
    preds_cpu = cpu.request(cpu.completion_order[-1]).gathered_preds()
    vs_cpu = _compare(w["res"], res_cpu, w["preds"], preds_cpu)
    # the interval's ends, in the CPU's se
    boot_off = [abs(a - b) / res_cpu.se for a, b in zip(res_boot.boot_ci,
                                                         res_cpu.boot_ci)]

    # the shared-X form: one landmark set for 10 tasks of the bonus data
    rng = np.random.default_rng(0)
    x = np.asarray(data.x, np.float32)
    ys = np.repeat(np.asarray(data.y, np.float32)[None], 10, axis=0)
    ws = (rng.random(ys.shape) < 0.8).astype(np.float32)
    fn = get_learner("kernel_ridge", QUICKSTART_PARAMS)
    key = threefry.key(42)
    runtime.reset_launch_counts()
    with _launch_shapes() as seen_x:
        got = fn(*(torch.from_numpy(a).to(device) for a in (x, ys, ws)),
                 key.to(device))
        torch.cuda.synchronize()
    shared_launches = dict(runtime.launch_counts)
    _launches_compared(seen_x, "estimate_quickstart (shared-X)")
    assert seen_x["crossfit_gram"] == {KR_XFIT_SHAPE}, seen_x
    assert shared_launches["crossfit_gram"] == 1, shared_launches
    want = fn(*(torch.from_numpy(a) for a in (x, ys, ws)), key)
    shared_tier = _tier_units(got.cpu().numpy(), want.numpy())
    shared_abs = float((got.cpu() - want).abs().max())

    # one block of the request (its first 32 tasks) on the card, on the
    # CPU and in float64 on the CPU, on the same landmarks
    f64 = _kernel_ridge_block_vs_f64(plan, data, device)

    # eigh alone, at the path's (32, 256, 256): does it synchronise?
    kmm = torch.randn((32, 256, 256), device=device)
    kmm = kmm @ kmm.transpose(1, 2) + 256 * torch.eye(256, device=device)
    _, eigh_syncs = _sync_sites(lambda: torch.linalg.eigh(kmm))
    eigh_ms = _time_ms(lambda: torch.linalg.eigh(kmm), cold=False, runs=5,
                       warmup=1)
    emit("estimate_quickstart", n_obs=data.n_obs, dim_x=data.dim_x,
         n_folds=5, n_rep=100, learner="kernel_ridge",
         learner_params=QUICKSTART_PARAMS, backend=plan.backend,
         pool={"n_workers": QUICKSTART_POOL.n_workers,
               "memory_mb": QUICKSTART_POOL.memory_mb},
         theta=w["res"].theta, se=w["res"].se, planted=TRUE_EFFECT,
         theta_cpu=res_cpu.theta, se_cpu=res_cpu.se,
         boot_ci=res_boot.boot_ci, boot_ci_cpu=res_cpu.boot_ci,
         boot_ci_off_in_se=boot_off, n_boot=N_BOOT, vs_cpu=vs_cpu,
         vs_inline=wave_inline, cold_equals_warm=cold_bits,
         boot_run_same_theta=res_boot.theta == w["res"].theta,
         wave_sizes=sizes, launches=launches, planned=planned,
         launch_shapes=sorted(seen["batched_gram"]),
         cold_s=cold_s, warm_s={k: v["warm_s"] for k, v in out.items()},
         boot_s=boot_s, cpu_s=cpu_s, sync_sites_warm_wave=syncs,
         eigh={"shape": [32, 256, 256], "ms": eigh_ms,
               "sync_sites": eigh_syncs},
         shared_x={"shape": list(KR_XFIT_SHAPE), "launches": shared_launches,
                   "tier_units_vs_cpu": shared_tier,
                   "max_abs_diff_vs_cpu": shared_abs},
         block_vs_float64=f64,
         tolerance="wave vs inline: bit for bit; card vs CPU (measured, "
                   "Kmm nearly singular): predictions within 0.25, theta "
                   "within 0.01 se, se 2e-3 relative, the bootstrap "
                   "interval's ends within 0.05 se, the shared-X form's "
                   "predictions within 0.25; one block on the card no "
                   "farther from a float64 fit than twice the CPU's "
                   "distance plus one float-tier unit")
    assert wave_inline["bitwise"], wave_inline
    _within(vs_cpu, w["res"], res_cpu, QUICKSTART_TOL,
            "estimate_quickstart: card vs CPU")
    assert max(boot_off) <= 0.05, (res_boot.boot_ci, res_cpu.boot_ci)
    assert res_boot.theta == w["res"].theta
    assert shared_abs <= QUICKSTART_TOL[0], ("shared-X vs CPU", shared_abs)
    assert f64["card_tier_units_vs_f64"] \
        <= 2 * f64["cpu_tier_units_vs_f64"] + 1.0, f64
    return {"batched_gram": launches["batched_gram"],
            "batched_predict": launches["batched_predict"],
            "crossfit_gram": shared_launches["crossfit_gram"]}


def _mlp_run(plan, data, dev, truth, what):
    """One mlp request on a fresh default session: the result, its (M, K,
    L, N) predictions, the wall time and the launch counts."""
    sess = DMLSession(device=dev)
    runtime.reset_launch_counts()
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.estimate(plan, data)
    if dev != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    req = sess.request(sess.completion_order[-1])
    _checked(res, req, dev, truth, what)
    return res, req.gathered_preds(), wall, dict(runtime.launch_counts)


def phase_estimate_mlp(device):
    """The mlp learner at full width with its defaults (hidden (64, 64),
    300 Adam steps, lr 3e-3) on the API's default backend: PLR on the bonus
    data at K 5, M 10 (100 fits), and the IRM plan on make_irm_data(5000,
    20) at M 2, whose propensity is mlp's sigmoid (``classify=True``).
    Each is held against the CPU path to MLP_TOL: IRM whole, PLR at M 2
    (the CPU takes about 17 s a repetition's 10 fits), and the card's M 10
    predictions of repetitions 0 and 1 are bit for bit its M 2 ones (the
    same fold masks and task keys: M 2 is a prefix of M 10).  mlp runs no
    hand-written kernel: the launch counts stay 0."""
    bonus = DMLData.from_dict(make_bonus_data())
    irm = DMLData.from_dict(make_irm_data(n_obs=5000, dim_x=20))
    plans = {m: DMLPlan.for_model("plr", learner="mlp", n_folds=5, n_rep=m)
             for m in (10, 2)}
    irm_plan = DMLPlan.for_model("irm", learner="mlp", n_folds=5, n_rep=2)
    assert [(ns.learner, dict(ns.param_dict))
            for ns in irm_plan.nuisances][2] == ("mlp", {"classify": True})
    card = {"plr_m10": _mlp_run(plans[10], bonus, device, TRUE_EFFECT,
                                "estimate_mlp/plr M 10"),
            "plr": _mlp_run(plans[2], bonus, device, TRUE_EFFECT,
                            "estimate_mlp/plr M 2"),
            "irm": _mlp_run(irm_plan, irm, device, irm.theta0,
                            "estimate_mlp/irm")}
    for name, (_, _, _, launches) in card.items():
        assert not any(launches.values()), (name, launches)
    cpu = {"plr": _mlp_run(plans[2], bonus, "cpu", TRUE_EFFECT,
                           "estimate_mlp/plr M 2 (CPU)"),
           "irm": _mlp_run(irm_plan, irm, "cpu", irm.theta0,
                           "estimate_mlp/irm (CPU)")}
    runs = {}
    for name in ("plr", "irm"):
        (rg, pg, wg, _), (rc, pc, wc, _) = card[name], cpu[name]
        runs[name] = {"n_rep": 2, "theta": rg.theta, "se": rg.se,
                      "theta_cpu": rc.theta, "se_cpu": rc.se,
                      "vs_cpu": _compare(rg, rc, pg, pc),
                      "wall_s": wg, "wall_cpu_s": wc}
    r10, p10, w10, _ = card["plr_m10"]
    p_cpu = cpu["plr"][1]
    reps01 = {"preds_tier_units": _tier_units(p10[:2], p_cpu),
              "preds_max_abs_diff": float(np.abs(p10[:2] - p_cpu).max())}
    runs["plr_m10"] = {"n_rep": 10, "tasks": 100, "theta": r10.theta,
                       "se": r10.se, "planted": TRUE_EFFECT, "wall_s": w10,
                       "reps_0_1_vs_cpu": reps01,
                       "reps_0_1_bitwise_card_m2":
                           bool(np.array_equal(p10[:2], card["plr"][1]))}
    runs["irm"]["theta0"] = irm.theta0
    emit("estimate_mlp", hidden=[64, 64], n_steps=300, lr=3e-3, n_folds=5,
         reduced="M 10 (PLR) and 2 (IRM), from the paper's 100", runs=runs,
         tolerance="card vs CPU (measured: Adam amplifies an ulp over 300 "
                   "steps): PLR predictions within 0.1, theta within 0.05 "
                   "se, se 1e-3 relative; IRM predictions within 0.5, "
                   "theta within 0.25 se, se 0.1 relative; the M 10 run's "
                   "repetitions 0 and 1 bit for bit the card's M 2 run")
    for name in ("plr", "irm"):
        _within(runs[name]["vs_cpu"], card[name][0], cpu[name][0],
                MLP_TOL[name], f"estimate_mlp/{name}: card vs CPU")
    assert runs["plr_m10"]["reps_0_1_bitwise_card_m2"], runs["plr_m10"]

LM_SEED = 20241115


def _card_copy(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _logit_recorder(bundle):
    """Wrap the bundle's prefill and decode so that every step records,
    on the device, whether all its logits are finite."""
    flags = []
    prefill, decode = bundle.prefill_fn, bundle.decode_fn

    def prefill_fn(params, batch):
        logits, cache = prefill(params, batch)
        flags.append(torch.isfinite(logits).all())
        return logits, cache

    def decode_fn(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        flags.append(torch.isfinite(logits).all())
        return logits, cache

    bundle.prefill_fn, bundle.decode_fn = prefill_fn, decode_fn
    return flags


def _consistency(bundle, params, prompt, device):
    """The reference's prefill/decode check (tests/test_models_smoke.py):
    the greedy token of prefill(prompt), decoded once from the cache,
    against prefill(prompt + token): the same argmax, logits within the
    hybrid tier, 0.10 of max|logits|."""
    cfg = bundle.arch
    tokens = torch.as_tensor(prompt[None], dtype=torch.int32, device=device)
    with torch.inference_mode():
        logits1, cache = bundle.prefill_fn(params, {"tokens": tokens})
        cache = grow_cache(cfg, cache, 4)
        tok = torch.argmax(logits1, dim=-1)[:, None].to(torch.int32)
        logits2, _ = bundle.decode_fn(params, cache, {"tokens": tok})
        del cache
        logits3, _ = bundle.prefill_fn(
            params, {"tokens": torch.cat([tokens, tok], dim=1)})
    a, b = logits2.float().cpu().numpy(), logits3.float().cpu().numpy()
    assert np.isfinite(a).all() and np.isfinite(b).all() and \
        np.isfinite(logits1.float().cpu().numpy()).all()
    rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    assert same, ("prefill/decode argmax differs", a.argmax(-1),
                  b.argmax(-1))
    assert rel < 0.10, ("prefill/decode logits differ", rel)
    return {"prompt_len": int(prompt.shape[0]), "same_argmax": same,
            "max_abs_diff_over_max_abs_logits": rel,
            "max_abs_logits": float(np.abs(b).max())}


def phase_serve_zamba2(device):
    """The LM serving path at full width and depth: zamba2-7b (81 slots:
    13 groups of 5 Mamba2 blocks and the shared attention block, 3 tail
    blocks), bf16 weights drawn on the card from a seeded generator,
    ``Engine.serve_requests`` over 8 prompts of ragged length <= 2048 in
    slots of 4 (2 prefills, 30 decode steps).  Launch counts are set to 0
    just before the serve and read just after."""
    cfg = get_arch("zamba2-7b")
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = init_tree(bundle.decls, gen, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = torch.cuda.memory_allocated()
    engine = Engine(bundle, params, device=device)
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(SERVE_LEN // 2, SERVE_LEN + 1, size=SERVE_PROMPTS)
    lens[0] = SERVE_LEN
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    flags = _logit_recorder(bundle)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        results = engine.serve_requests(prompts, batch_size=SERVE_BATCH,
                                        prompt_len=SERVE_LEN,
                                        n_gen=SERVE_GEN)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_bursts = -(-SERVE_PROMPTS // SERVE_BATCH)
    # a prefill applies the shared block 13 times and runs 13 x 5 + 3 = 68
    # Mamba2 blocks: 26 and 136 launches over the two prefills
    groups = cfg.n_layers // cfg.shared_attn_every
    n_mamba = cfg.n_layers - groups
    assert launches == {"batched_gram": 0, "batched_gram_blocked": 0,
                        "batched_predict": 0, "crossfit_gram": 0,
                        "flash_attention": n_bursts * groups,
                        "ssd_scan": n_bursts * n_mamba}, launches
    _launches_compared(seen, "serve_zamba2")
    assert bool(torch.stack(flags).all()), "serve_zamba2: a logit is not finite"
    assert len(flags) == n_bursts * SERVE_GEN
    assert len(results) == SERVE_PROMPTS and all(
        r.shape == (SERVE_GEN,) and r.min() >= 0 and r.max() < cfg.vocab_size
        for r in results)
    bursts = [{"prefill_s": r.prefill_s, "decode_s": r.decode_s,
               "decode_tokens_per_s": r.tokens_per_s,
               "prefill_tokens_per_s": SERVE_BATCH * SERVE_LEN / r.prefill_s}
              for r in engine.last_results]
    consistency = _consistency(bundle, params, prompts[0], device)
    emit("serve_zamba2", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=param_count(bundle.decls),
         param_bytes_on_card=param_bytes, init_s=init_s,
         prompts=SERVE_PROMPTS, prompt_lens=[int(n) for n in lens],
         batch=SERVE_BATCH, prompt_len=SERVE_LEN, n_gen=SERVE_GEN,
         wall_s=wall, bursts=bursts, peak_device_bytes=peak,
         launches=launches,
         launch_shapes={k: sorted(map(str, v)) for k, v in seen.items() if v},
         consistency=consistency,
         first_tokens=[r[:4].tolist() for r in results])
    del engine, params
    torch.cuda.empty_cache()
    return launches


def _lm_run(bundle, params, tokens, device, n_decode, feed=None):
    """Prefill, then ``n_decode`` greedy decode steps (fed ``feed``'s
    tokens when given: teacher forcing).  Returns the logits of each step,
    the tokens fed, the prefill cache's states and the launch counts."""
    cfg = bundle.arch
    runtime.reset_launch_counts()
    with torch.inference_mode():
        toks = torch.as_tensor(tokens, device=device)
        logits, cache = bundle.prefill_fn(params, {"tokens": toks})
        # copies: decode updates the cache in place
        states = {"m_ssm": cache["m_ssm"].to("cpu", torch.float32, copy=True),
                  "k": cache["shared_kv"]["k"].to("cpu", torch.float32,
                                                  copy=True)}
        cache = grow_cache(cfg, cache, n_decode)
        out, fed = [logits.float().cpu()], []
        for i in range(n_decode):
            tok = torch.argmax(out[-1], dim=-1)[:, None].to(torch.int32) \
                if feed is None else feed[i]
            fed.append(tok)
            logits, cache = bundle.decode_fn(params, cache,
                                             {"tokens": tok.to(device)})
            out.append(logits.float().cpu())
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, fed, states, dict(runtime.launch_counts)


def _lm_compare(cpu, card, tier, what):
    (lc, _, sc, _), (lg, _, sg, _) = cpu, card
    diffs = [float((g - c).abs().max() / c.abs().max()) for c, g in
             zip(lc, lg)]
    same = [bool((g.argmax(-1) == c.argmax(-1)).all()) for c, g in
            zip(lc, lg)]
    state = {k: float((sg[k] - sc[k]).abs().max() / sc[k].abs().max())
             for k in sc}
    assert all(np.isfinite(diffs)) and max(diffs) < tier and all(same), \
        (what, diffs, same)
    assert max(state.values()) < tier, (what, state)
    return {"logits_rel_err_by_step": diffs, "same_argmax_by_step": same,
            "state_rel_err": state, "tier": tier}


def phase_same_as_cpu_lm(device):
    """The card route (K5, K6) against the CPU route (the reference's jnp
    math, ported) on the same parameters and tokens.  (a) the reduced
    zamba2 (d 64, window 64, chunk 16) at S 100, so that the window, a
    ragged SSD chunk and a ragged attention chunk are live, in bf16 as
    declared: prefill and two decode steps.  (b) full width with the depth
    cut to one group (6 slots: 5 Mamba2 blocks and the shared block), B 1,
    S 512, parameters cast to float32 on both sides.  Decode steps are fed
    the CPU's greedy tokens on both sides."""
    out = {}
    rng = np.random.default_rng(LM_SEED)
    cases = (
        ("reduced_bf16", get_arch("zamba2-7b", reduced=True), 2, 100, None,
         32, 0.08),
        ("full_width_one_group_f32",
         dataclasses.replace(get_arch("zamba2-7b"), n_layers=6), 1, 512,
         torch.float32, 1024, 1e-3),
    )
    for name, cfg, batch, seq, cast, attn_chunk, tier in cases:
        bundle = build_model(cfg, attn_chunk=attn_chunk)
        t0 = time.perf_counter()
        params = init_tree(bundle.decls,
                           torch.Generator().manual_seed(LM_SEED), "cpu")
        if cast is not None:
            params = cast_floating(params, cast)
        tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        cpu = _lm_run(bundle, params, tokens, torch.device("cpu"), 2)
        cpu_s = time.perf_counter() - t0
        card = _lm_run(bundle, _card_copy(params, device), tokens, device, 2,
                       feed=cpu[1])
        groups = cfg.n_layers // cfg.shared_attn_every
        n_mamba = cfg.n_layers - groups
        assert not any(cpu[3].values()), cpu[3]
        assert card[3]["flash_attention"] == groups and \
            card[3]["ssd_scan"] == n_mamba, card[3]
        out[name] = {"batch": batch, "seq": seq, "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model,
                     "dtype": "float32" if cast else "bf16 as declared",
                     "cpu_side_s": cpu_s, "card_launches": card[3],
                     **_lm_compare(cpu, card, tier, name)}
        del params, cpu, card
        torch.cuda.empty_cache()
    f32_launches = out["full_width_one_group_f32"]["card_launches"][
        "flash_attention"]
    emit("same_as_cpu_lm", cases=out,
         cut="(b): depth 81 -> 6 slots (one group), B 1, S 512, to keep the "
             "CPU side under a minute",
         tolerance="logits and prefill states (m_ssm, shared k) within the "
                   "tier of max|CPU|, the same argmax at every step: (a) "
                   "0.08 (bf16), (b) 1e-3 (float32)")
    return f32_launches


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
        # one nvcc per source, all started together
        with ThreadPoolExecutor(len(LIBRARIES)) as pool:
            list(pool.map(lambda name: build.build_library(
                name, verbose=args.verbose_build), LIBRARIES))
        libraries = {}
        for name in LIBRARIES:
            build.load_library(name)
            nvcc_s, path = build.build_log[name]
            libraries[name] = {
                "library": str(Path(path).relative_to(ROOT))
                if Path(path).is_relative_to(ROOT) else path,
                "nvcc_s": nvcc_s}
        emit("build", libraries=libraries,
             build_and_load_s=time.perf_counter() - t0)
    rows, launches = None, None
    if "kernels" in phases:
        rows = phase_kernels(device)
    per_block = None
    if "estimate_paper" in phases:
        launches, per_block = phase_estimate_paper(device)
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
    raw_lanes = None
    if "raw_request" in phases:
        raw_lanes = phase_raw_request(device)
    if "estimate_irm" in phases:
        phase_estimate_irm(device)
    wave_launches = None
    if "estimate_wave" in phases:
        wave_launches = phase_estimate_wave(device)
    if "wave_pool" in phases:
        phase_wave_pool(device)
    if "session_wave" in phases:
        phase_session_wave(device)
    if "fusion" in phases:
        phase_fusion(device)
    if "page_pool" in phases:
        phase_page_pool(device)
    quickstart = None
    if "estimate_quickstart" in phases:
        quickstart = phase_estimate_quickstart(device)
    if "estimate_mlp" in phases:
        phase_estimate_mlp(device)
    if "serve_zamba2" in phases:
        served = phase_serve_zamba2(device)
        if launches is not None:
            for name in ("flash_attention", "ssd_scan"):
                launches[name] = served[name]
    f32_launches = None
    if "same_as_cpu_lm" in phases:
        f32_launches = phase_same_as_cpu_lm(device)

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
    # K1's and K6's CUDA launches of one counted call and their scratch
    # bytes, measured by the kernels phase; K4 at the opaque drain's lane
    # shape (raw_request's launches), K5's float32 kernel at the serve shape
    # (same_as_cpu_lm (b)'s launches), K6's FMA-rate bound
    extra = {"batched_gram": {k: rows["batched_gram"][k] for k in (
                 "cuda_launches_per_call", "scratch_bytes")},
             "batched_predict": {},
             "crossfit_gram": {"lane": {**rows["crossfit_gram"]["lane"],
                                        "launches": raw_lanes},
                               "p257": {**rows["crossfit_gram"]["p257"],
                                        "launches_estimate_quickstart":
                                            quickstart["crossfit_gram"]}},
             "flash_attention": {"f32": {**rows["flash_attention"]["f32"],
                                         "launches": f32_launches}},
             "ssd_scan": {k: rows["ssd_scan"][k] for k in (
                 "bound_ms_at_f32_fma", "cuda_launches_per_call",
                 "scratch_bytes")}}
    # K1's and K2's launches on the per-block pool (estimate_paper), on
    # the wave path (estimate_wave, cold) on both pools, and their rows at
    # the fused paper shape (1024 lanes: the 32 blocks of one launch); on
    # the quickstart (kernel_ridge, cold) and their rows at P 257 and 129
    for name in ("batched_gram", "batched_predict"):
        extra[name].update(
            launches_per_block=per_block[name],
            launches_estimate_wave=wave_launches[0][name],
            launches_estimate_wave_per_block=wave_launches[1][name],
            fused={"shape": list(FUSED_PAPER_SHAPE),
                   **{k: rows["fused"][name][k] for k in keys}},
            launches_estimate_quickstart=quickstart[name],
            **{f"p{shape[2]}": {"shape": list(shape),
                                **{k: rows[f"p{shape[2]}"][name][k]
                                   for k in keys}}
               for shape in (QUICKSTART_SHAPES[0], KR128_SHAPE)})
    print(json.dumps({"kernels": [
        {"name": name, **meta, "launches": launches[name],
         **{k: rows[name][k] for k in keys}, **extra.get(name, {})}
        for name, meta in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

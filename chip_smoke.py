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
and SSD-scan kernels, and its card route held against its CPU route; the
decoder families the same way: the full deepseek-v2-lite-16b (MoE with
latent attention, whose prefills run flash attention with q and k at depth
192 against v at 128), served twice with the same tokens, the full
h2o-danube-3-4b on prompts longer than its sliding window, and
codeqwen1.5-7b, qwen2-moe-a2.7b, qwen2.5-32b and yi-34b at full width with
their depth cut, each family reduced held card against CPU; and the last
three families: the full xlstm-350m (its mLSTM blocks through the SSD
scan at N 512, P 513, its sLSTM a loop of plain ops over time) served
twice with the same tokens, the full whisper-base at 1500 frames and a
400-token prompt, and llama-3.2-vision-90b at full width cut to two
groups (cross-attention at 2048 queries against 1601 image tokens), both
through ``Engine.generate`` with their frames or image patches, each
reduced (and xlstm at full width, depth cut) held card against CPU.  The
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

The topology backend: simulated hosts, each on its own CUDA stream of
the one card, on the paper request at 2 and 4 hosts (cold and warm, bit
for bit the inline drain), with stealing and a device-to-device page
fetch, and on a tall request (K3); a host lost mid-flight, chaos pools
and hedges across host streams; a durable session crashed in a child
process and resumed here; and all of it again under ``REPRO_SANITIZE=1``.

LM training on the card (``repro_torch.train``): h2o-danube-3-4b at its
published widths cut to 8 of its 24 layers (1.49 B parameters) and
whisper-base whole, 12 steps each through ``Trainer.run`` with remat
"full", K5's forward and hand-written backward on every step (step time,
tokens/s, peak memory, launches a step); the reduced h2o-danube-3-4b and
deepseek-v2-lite card against CPU in float32 (a step's loss and
gradients, a loss curve), and a resume on the card bit for bit.  The
kernels phase holds K5's backward (``csrc/attn_bwd.cu``, wgmma on
TMA-fed tiles; float32 through three bf16 parts an operand) against its
plain version at the training shapes and at every depth pair in both
types, counts its CUDA launches a call from a captured graph (and, in
float32, its scratch and its prologue's share of the call) and times it
beside scaled_dot_product_attention's.

The persistent library store (``compile/persist.py``): fresh processes
on a fresh ``REPRO_PROGRAM_CACHE_DIR`` — the first builds the two kernel
libraries it uses (megabatch, lm), the second builds none, one after a
library was truncated evicts and rebuilds that library alone, and one of
a copy of the package with a byte added to a comment of ``megabatch.cu``
rebuilds that library alone; each serves the paper request and holds K1,
K2, K5 and K6 against their plain versions.  The example twins (``examples/*_torch.py``) at
their own sizes on the card, the serving example's included.

Phases: device, build, kernels, estimate_paper, estimate_wide, session,
same_as_cpu, estimate_tall, shared_x, raw_request, estimate_irm,
estimate_wave, wave_pool, session_wave, fusion, page_pool,
estimate_quickstart, estimate_mlp, serve_zamba2, serve_deepseek,
serve_dense, serve_xlstm, serve_whisper, serve_vlm, same_as_cpu_lm,
train_dense, train_whisper, topology, topology_chaos, durable, sanitize,
persist, examples.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
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
from repro_torch.compile import persist, plan_buckets, program  # noqa: E402
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
from repro_torch.models.param import (                      # noqa: E402
    cast_floating, tree_leaves, tree_map,
)
from repro_torch.models import layers as lm_layers         # noqa: E402
from repro_torch.models import ssm as ssm_blocks           # noqa: E402
from repro_torch.serverless import PoolConfig, make_backend  # noqa: E402
from repro_torch.serving import Engine, grow_cache         # noqa: E402

PHASES = ("device", "build", "kernels", "estimate_paper", "estimate_wide",
          "session", "same_as_cpu", "estimate_tall", "shared_x",
          "raw_request", "estimate_irm", "estimate_wave", "wave_pool",
          "session_wave", "fusion", "page_pool", "estimate_quickstart",
          "estimate_mlp", "serve_zamba2", "serve_deepseek", "serve_dense",
          "serve_xlstm", "serve_whisper", "serve_vlm", "same_as_cpu_lm",
          "train_dense", "train_whisper", "topology",
          "topology_chaos", "durable", "sanitize", "persist", "examples")
LIBRARIES = ("megabatch", "lm", "attn_bwd")

# NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s, and plain (non tensor
# core) float32 FLOP/s — K1-K4 use plain FMA
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# dense bf16 tensor-core rate: the least time for K5's bf16 operands
PEAK_BF16_TC_FLOP_S = 989e12
# dense TF32 tensor-core rate; K5's float32 forward and K6 do each product
# in three TF32 passes (hi/lo split), so their float32-grade rate is a
# third; K5's float32 backward takes six bf16 passes (three bf16 parts), a
# sixth of the bf16 rate: the same 165 TFLOP/s
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
    # K5's gradient: the reference differentiates its jnp attention (its
    # Pallas kernel has no VJP); this is the backward of that kernel, in
    # csrc/attn_bwd.cu (wgmma, TMA) for the main path's bf16 calls and the
    # card-against-CPU checks' float32 ones
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attn_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
    },
}
# the wrapper module of each kernel (its ``<name>_cuda`` launches it)
KERNEL_MODULES = {"batched_gram": megabatch, "batched_predict": megabatch,
                  "batched_gram_blocked": megabatch,
                  "crossfit_gram": crossfit_gram,
                  "flash_attention": flash_attention,
                  "flash_attention_bwd": flash_attention, "ssd_scan": ssd_scan}
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
# serve_deepseek: the same burst shape on the full deepseek-v2-lite-16b.
# serve_dense: (arch, depth kept or None for all, slots, slot length,
# prompts) — h2o-danube-3-4b in full on prompts longer than its 4096
# window (the window masks K5's tiles, decode's cache wraps at pos % S),
# the others at full width with their depth cut; 16 tokens generated
DENSE_SERVES = (("h2o-danube-3-4b", None, 2, 4608, 4),
                ("codeqwen1.5-7b", 4, 2, SERVE_LEN, 2),
                ("qwen2-moe-a2.7b", 4, 2, SERVE_LEN, 2),
                ("qwen2.5-32b", 2, 2, SERVE_LEN, 2),
                ("yi-34b", 2, 2, SERVE_LEN, 2))
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
               (8, 300, 100, 18, "f32", False, None)) + tuple(
    (*shape[:4], dtype, *shape[4:]) for shape in (
        # the decoder families, in both types (a D, Dv row's eighth field
        # is Dv, the depth of v): serve_deepseek's prefills (B 4 x 16
        # heads, S 2048, q and k at 128 + 64, v at 128, causal);
        # same_as_cpu_lm's reduced MLA (B 2 x 4 heads, S 100, 48 / 32),
        # reduced MoE (D 32, no window) and full-width MLA group (B 1, S
        # 512); serve_dense's prefills: h2o-danube-3-4b (B 2 x 32 heads,
        # GQA 32/8 repeated, S 4608, D 120, window 4096), codeqwen1.5-7b
        # (32 heads), qwen2-moe-a2.7b (16), qwen2.5-32b (40), yi-34b (56),
        # each B 2, S 2048, D 128
        (64, 2048, 2048, 192, True, None, 128),
        (8, 100, 100, 48, True, None, 32),
        (8, 100, 100, 32, True, None),
        (16, 512, 512, 192, True, None, 128),
        (64, 4608, 4608, 120, True, 4096),
        (64, 2048, 2048, 128, True, None),
        (32, 2048, 2048, 128, True, None),
        (80, 2048, 2048, 128, True, None),
        (112, 2048, 2048, 128, True, None))
    for dtype in ("bf16", "f32"))
# the three last families' prefills (name -> row and its types):
# serve_vlm's (B 2 x 64 heads, GQA 64/8 repeated, S 2048, D 128) causal
# self-attention, in both types (in float32 it sat 2.06e-5 from the plain
# version and 2.0e-5 from float64 until the float32 kernel summed each key
# tile's P V apart: 5.7e-6 and 5.3e-6 since, PERF.md),
# and its cross-attention against one image tile's 1601 tokens (Sq > Skv,
# nothing masked); serve_whisper's (B 4 x 8 heads, D 64) encoder over 1500
# frames (not causal), decoder self-attention over its 400-token prompt
# (causal) and cross-attention against the 1500 frames; a ragged Sq >
# Skv.  Each is timed beside scaled_dot_product_attention
CROSS_ATTN_ROWS = {
    "vlm_self": ((128, 2048, 2048, 128, True, None), ("bf16", "f32")),
    "vlm_cross": ((128, 2048, 1601, 128, False, None), ("bf16", "f32")),
    "whisper_encoder": ((32, 1500, 1500, 64, False, None), ("bf16", "f32")),
    "whisper_self": ((32, 400, 400, 64, True, None), ("bf16", "f32")),
    "whisper_cross": ((32, 400, 1500, 64, False, None), ("bf16", "f32")),
    "ragged_cross": ((16, 1000, 333, 64, False, None), ("bf16", "f32")),
}
ATTN_SHAPES += tuple((*row[:4], dtype, *row[4:])
                     for row, dtypes in CROSS_ATTN_ROWS.values()
                     for dtype in dtypes)
# the deepseek prefill's row: K5 at Dqk 192, Dv 128
MLA_ATTN_SHAPE = (64, 2048, 2048, 192, "bf16", True, None, 128)
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
# xlstm-350m's mLSTM prefill (serve_xlstm: B 4 x 4 heads as lanes, one head
# a lane, the key depth 512 as N, the value depth 512 plus the normalizer
# as P), then past N, P 64: N != P with heads sharing bm/cm and 4-byte
# copies; P 200 (16-byte copies, four column tiles, the last short); N 80
# (a short last 32-deep slice of C S in the outputs kernel)
XLSTM_SSD_SHAPE = (16, 2048, 513, 512, 256, 1)
SSD_SHAPES += ((XLSTM_SSD_SHAPE, "slow"),
               ((8, 777, 129, 96, 256, 2), "slow"),
               ((6, 600, 200, 64, 256, 3), "slow"),
               ((4, 300, 72, 80, 64, 2), "strong"))
TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TYPE_NAMES = {v: k for k, v in TYPES.items()}
# attention tolerance: the reference's own (tests/test_kernels.py TOL)
ATTN_TOL = {"f32": 2e-4, "bf16": 2e-2}
# and, for float32, the split-TF32 kernel's own tier: a product within
# about 2^-21 of float32 (one TF32 rounding is about 1e-3 off).  Every
# float32 row's distances from float64 attention (a slice of lanes at a
# time), the kernel's and the plain version's, are reported beside it
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


# the kernel nodes of a captured CUDA graph (CUgraphNodeType)
CU_GRAPH_NODE_TYPE_KERNEL = 0


def _graph_launches(fn) -> int:
    """The CUDA kernels one call of ``fn`` launches, counted exactly: the
    kernel nodes of a CUDA graph captured from the call (the call is
    captured, not run)."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        kernels += kind.value == CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


# profiler sessions tried before a trace counts as incomplete, and the host
# pause at each end of the first of them (doubled each time)
PROFILER_SESSIONS = 5
PROFILER_PAUSE_S = 0.02
# the kernel that torch.cuda._sleep launches: the sentinels of a session,
# told apart by their lengths in cycles
SENTINEL_KERNEL = "spin_kernel"
SENTINEL_CYCLES = {"first": 1_000, "last": 200_000}
SENTINEL_SPLIT_US = 20.0


def _device_kernels(fn, calls: int = 1):
    """The CUDA kernels that ``calls`` calls of ``fn`` launch, traced by
    torch.profiler: name -> (launches, device ms), each per call, or None
    when no session was whole.

    The profiler loses kernels on an H100: whole sessions came back empty,
    and a K6 call was counted at 2 or 3 of the four kernels its source
    launches.  So each session pauses on the host, launches a short
    sentinel kernel (``torch.cuda._sleep``), runs the calls, launches a
    long sentinel and pauses again; a session missing either sentinel is
    traced again with longer pauses, up to PROFILER_SESSIONS times.  Launch
    counts that a check relies on come from ``_graph_launches``."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILER_SESSIONS):
        pause = PROFILER_PAUSE_S * 2 ** attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            torch.cuda._sleep(SENTINEL_CYCLES["first"])
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda._sleep(SENTINEL_CYCLES["last"])
            torch.cuda.synchronize()
            time.sleep(pause)
        found = {"first": 0, "last": 0}
        for ev in prof.events():
            if SENTINEL_KERNEL in ev.name:
                long = ev.time_range.elapsed_us() > SENTINEL_SPLIT_US
                found["last" if long else "first"] += 1
        if found == {"first": 1, "last": 1}:
            out = {}
            for ev in prof.key_averages():
                us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
                # the operators' rows ("aten::..."), the runtime's API rows
                # ("cudaLaunchKernel") and the sentinels are not fn's
                if us > 0 and SENTINEL_KERNEL not in ev.key \
                        and not ev.key.startswith(("aten::", "cuda")):
                    out[ev.key] = (ev.count / calls, us / 1e3 / calls)
            return out
        print(f"chip_smoke: a profiler session held sentinels {found} "
              f"(pause {pause} s); tracing again", file=sys.stderr,
              flush=True)
    return None


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
            # kernel and the combine) as a captured CUDA graph holds them, and the
            # scratch of partial tiles it allocates beside G and b as the
            # device allocator counts it (the peak of the call less what
            # stays allocated after it)
            gram["cuda_launches_per_call"] = _graph_launches(
                lambda: ops.batched_gram(xs, w, y))
            assert gram["cuda_launches_per_call"] >= 1, gram
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
    rows["flash_attention"]["lse_write"] = _lse_write_cost(device, gen)
    attn_bwd, bwd_rows = _attn_bwd_kernel_rows(device, gen)
    rows["flash_attention_bwd"] = {
        **bwd_rows[MAIN_BWD_ATTN],
        "rows": {f"{name}_{dtype}": row
                 for (name, dtype), row in bwd_rows.items()}}
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
                           "within 2e-5 (the split-TF32 tier; both routes' "
                           "distances from float64 attention reported); "
                           "bf16 also per element within 2 bf16 steps at "
                           "|o0| after 1e-4",
        "flash_attention_bwd": "dq, dk, dv on the first 16 lanes within "
                               "2e-2 (bf16) of each gradient's max|grad| "
                               "of the plain backward (float32, from the "
                               "plain o and lse), and per row within 2e-2 "
                               "of each query row's (dq) or key row's (dk, "
                               "dv) own max|grad|, at least 1e-3 of the "
                               "gradient's, of the plain backward on the "
                               "kernel's own o and lse; float32 (three "
                               "bf16 parts, six passes) within 2e-5 of "
                               "max|grad| (the float64 gradients' "
                               "distances reported); two runs the same "
                               "bits; bf16 steps per element measured, not "
                               "held; the forward writing lse: o as "
                               "flash_attention's tiers (2e-2 and 2 bf16 "
                               "steps; float32 2e-5), lse within 1e-5 of "
                               "max|lse|",
        "ssd_scan": "y within 2e-4 of max|y|, the final state within "
                    "2e-4 of max|state|: the reference's own tolerance; "
                    "also within 2e-5 of each (the split-TF32 tier)"},
        timing="median of 20 single launches after 3 warm-ups, CUDA events, "
               "L2 flushed before each (ms_warm_l2: not flushed), the "
               "device kept busy while the host enqueues; ssd_scan's "
               "plain_ms (2048 sequential steps): median of 5 after 1",
        kernels=sorted(KERNELS), shapes=report, blocked_shapes=blocked,
        crossfit_shapes=xfit, attention_shapes=attn,
        attention_backward_shapes=attn_bwd,
        lse_write=rows["flash_attention"]["lse_write"], ssd_shapes=ssd,
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


def _attn_bound(bh, sq, skv, d, dtype, causal, window, dv=None):
    # QK' and PV: 2 D and 2 Dv operations per visible pair; q, k, v read
    # once and o written once.  bf16 at the bf16 tensor-core rate; float32
    # at the TF32 rate over the split's three passes (the FMA figure is
    # kept beside it as bound_ms_at_f32_fma)
    dv = d if dv is None else dv
    flops = bh * _attn_pairs(sq, skv, causal, window) * 2 * (d + dv)
    nbytes = TYPES[dtype].itemsize * bh * (sq * d + skv * d + skv * dv
                                           + sq * dv)
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
    paths' shapes, against scaled_dot_product_attention, timed only) at
    every shape of ATTN_SHAPES.  The main (bf16) row carries the float32
    kernel's row at the same shape beside it (``f32``), the deepseek
    prefill's rows (Dqk 192, Dv 128) beside it (``mla``), and the rows of
    CROSS_ATTN_ROWS in both types (``families``)."""
    report, main, f32, mla, families = [], None, None, {}, {}
    library_keys = {MAIN_ATTN_SHAPE[:4], MLA_ATTN_SHAPE[:4]} | {
        row[:4] for row, _ in CROSS_ATTN_ROWS.values()}
    for shape in ATTN_SHAPES:
        bh, sq, skv, d, dtype, causal, window = shape[:7]
        dv = shape[7] if len(shape) > 7 else d
        q = torch.randn((bh, sq, d), generator=gen, device=device) \
            .to(TYPES[dtype])
        k = torch.randn((bh, skv, d), generator=gen, device=device) \
            .to(TYPES[dtype])
        v = torch.randn((bh, skv, dv), generator=gen, device=device) \
            .to(TYPES[dtype])
        o = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        o0 = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                   window=window)
        err = float((o.float() - o0.float()).abs().max())
        assert torch.isfinite(o).all() and err < ATTN_TOL[dtype], \
            ("flash_attention disagrees", shape, err)
        # float32: the split-TF32 kernel's own, stricter tier besides; the
        # distances of both from float64 are reported
        f64 = {}
        if dtype == "f32":
            o64 = _attn_f64(q, k, v, causal, window)
            f64 = {"abs_err_vs_f64": float((o.double() - o64).abs().max()),
                   "plain_abs_err_vs_f64": float(
                       (o0.double() - o64).abs().max())}
            del o64
            assert err <= ATTN_F32_SPLIT_TOL, \
                ("flash_attention float32 outside the split-TF32 tier",
                 shape, err, f64)
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
            "bytes": nbytes, "operations": flops, **f64,
        }
        if shape[:4] in library_keys and (sq == skv or not causal) \
                and (window is None or window >= skv):
            # the serve paths' shapes in both types (zamba2's window 32768
            # is longer than S: causal alone; SDPA's causal mask is aligned
            # to the top left, so a causal row needs Sq == Skv)
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def library():          # (1, BH, S, D): the fused backends
                return sdpa(q[None], k[None], v[None], is_causal=causal)[0]

            row["library"] = (f"scaled_dot_product_attention(is_causal="
                              f"{causal}) on (1, BH, S, D)")
            try:                    # Dv != D: not every backend takes it
                lib_err = float((library().float() - o0.float()).abs().max())
            except RuntimeError as err:
                row["library_error"] = str(err).splitlines()[0][:200]
            else:
                # float32: recorded only (the fused backends may take TF32)
                assert dtype == "f32" or lib_err < ATTN_TOL[dtype], \
                    ("sdpa disagrees", lib_err)
                row["library_ms"] = _time_ms(library, cold=True)
                row["library_max_abs_err"] = lib_err
        if shape == MAIN_ATTN_SHAPE:
            main = dict(row)
        elif shape[:4] == MAIN_ATTN_SHAPE[:4]:
            f32 = row
        elif shape[:4] == MLA_ATTN_SHAPE[:4]:
            mla[dtype] = {"shape": list(shape), **row}
        for name, (key, _) in CROSS_ATTN_ROWS.items():
            if shape == (*key[:4], dtype, *key[4:]):
                families[f"{name}_{dtype}"] = {"shape": list(shape), **row}
        report.append({"shape": list(shape), "flash_attention": row})
        del q, k, v, o, o0
        torch.cuda.empty_cache()
    main["f32"] = {"shape": list(MAIN_ATTN_SHAPE[:4]) + ["f32"],
                   **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms",
                                          "bound_ms_at_f32_fma")}}
    main["mla"] = mla
    main["families"] = families
    # more queries than keys under a mask raises on the card, in the
    # wrapper and on the model's route (its first queries would see no
    # key), and launches nothing
    q = torch.zeros((4, 9, 64), dtype=torch.bfloat16, device=device)
    k = torch.zeros((4, 8, 64), dtype=torch.bfloat16, device=device)
    before = dict(runtime.launch_counts)
    refused = []
    for causal, window in ((True, None), (False, 4), (True, 4)):
        for call in (lambda: ops.flash_attention(q, k, k, causal=causal,
                                                 window=window),
                     lambda: lm_layers.flash_attention_heads(
                         *(t.transpose(0, 1)[None] for t in (q, k, k)),
                         causal=causal, window=window)):
            try:
                call()
            except ValueError:
                refused.append([causal, window])
            else:
                raise AssertionError(("a masked call with Sq > Skv ran",
                                      causal, window))
    assert runtime.launch_counts == before, runtime.launch_counts
    main["masked_sq_gt_skv_refused"] = refused
    return report, main


# K5's backward (``flash_attention_bwd``) and the forward that writes the
# row log-sum-exp (the training forward): (name, (BH, Sq, Skv, D, type,
# causal, window[, Dv])) — h2o-danube-3-4b's training call (B 8 x 32 heads,
# GQA 32/8 repeated, S 4096, D 120) causal under its own window of 4096
# (which does not bite at 4096 tokens, but takes the kernels' windowed
# branches), and windowed at 1024; whisper-base's training calls (B 8 x 8
# heads, D 64): the encoder over 1500 frames (not masked), the decoder's
# self-attention over 448 tokens (causal) and its cross-attention against
# the 1500 frames; deepseek-v2-lite's MLA (B 4 x 16 heads, Dqk 192, Dv
# 128) causal; then three of them in float32; last train_dense's reduced
# calls: h2o-danube-3-4b (B 4 x 4 heads, S 256, D 32, window 64) in
# float32 (card against CPU) and bf16 (the resume), and deepseek-v2-lite's
# MLA (B 4 x 4 heads, S 128, Dqk 48, Dv 32) in float32; then rows at
# (16, 256, 256, D) causal for the depth pairs no row above takes (each of
# the kernels' three depth classes, (64, 64), (128, 128) and (192, 128),
# runs at every pair of DEPTH_PAIRS it pads), a ragged one with queries
# aligned to the keys' suffix under a window that bites, and a few
# queries, Sq % 4 != 0 (rows of lse and delta off 16 bytes), each in both
# types; whisper's decoder self-attention in float32; and an odd depth in
# float32 (D 17: rows of 68 bytes, which only the prologue's parts give
# the tensor maps)
BWD_ATTN_ROWS = (
    ("h2o_causal", (256, 4096, 4096, 120, "bf16", True, 4096)),
    ("h2o_window", (256, 4096, 4096, 120, "bf16", True, 1024)),
    ("whisper_encoder", (64, 1500, 1500, 64, "bf16", False, None)),
    ("whisper_self", (64, 448, 448, 64, "bf16", True, None)),
    ("whisper_cross", (64, 448, 1500, 64, "bf16", False, None)),
    ("mla", (64, 2048, 2048, 192, "bf16", True, None, 128)),
    ("whisper_encoder", (64, 1500, 1500, 64, "f32", False, None)),
    ("whisper_cross", (64, 448, 1500, 64, "f32", False, None)),
    ("mla", (64, 2048, 2048, 192, "f32", True, None, 128)),
    ("h2o_reduced", (16, 256, 256, 32, "f32", True, 64)),
    ("h2o_reduced", (16, 256, 256, 32, "bf16", True, 64)),
    ("mla_reduced", (16, 128, 128, 48, "f32", True, None, 32)),
    ("mla_reduced", (16, 128, 128, 48, "bf16", True, None, 32)),
    *((f"depth_{d}", (16, 256, 256, d, "bf16", True, None))
      for d in (16, 48, 80, 96, 112, 128)),
    ("ragged_window", (16, 300, 700, 64, "bf16", True, 128)),
    ("few_queries", (16, 13, 301, 64, "bf16", True, 32)),
    ("whisper_self", (64, 448, 448, 64, "f32", True, None)),
    *((f"depth_{d}", (16, 256, 256, d, "f32", True, None))
      for d in (16, 48, 80, 96, 112, 128)),
    ("ragged_window", (16, 300, 700, 64, "f32", True, 128)),
    ("few_queries", (16, 13, 301, 64, "f32", True, 32)),
    ("odd_depth", (16, 13, 301, 17, "f32", True, 32)),
)
MAIN_BWD_ATTN = ("h2o_causal", "bf16")
# the plain backward holds a few (lanes, Sq, Skv) float32 tensors: it is
# compared on the first lanes of each row (17 GB a tensor at h2o's 256)
BWD_COMPARE_LANES = 16
# bf16 backward, per row, against the plain backward on the kernel's own
# o and lse: each query row of dq and each key row of dk and dv within
# ATTN_TOL["bf16"] of its own largest magnitude, a row under BWD_ROW_FLOOR
# of the gradient's largest held at that floor (a causal query that sees
# one key has dq = 0 exactly).  The flat tier of max|grad| alone would
# pass a fault confined to the late causal query rows, whose dq spreads
# over thousands of keys and stays small beside the early rows'
BWD_ROW_FLOOR = 1e-3
# the forward's row log-sum-exp: within 1e-5 of max|lse| of the plain one
LSE_TOL = 1e-5


def _attn_f64(q, k, v, causal, window, lanes=BWD_COMPARE_LANES):
    """Attention in float64 (the truth the float32 routes are measured
    against), a slice of lanes at a time."""
    ok = flash_attention.visible(q.shape[1], k.shape[1], causal, window,
                                 q.device)
    out = []
    for i in range(0, q.shape[0], lanes):
        s = torch.einsum("bqd,bkd->bqk", q[i:i + lanes].double(),
                         k[i:i + lanes].double()) / np.sqrt(q.shape[-1])
        p = torch.softmax(s.masked_fill(~ok[None], float("-inf")), dim=-1)
        out.append(torch.einsum("bqk,bkd->bqd", p,
                                v[i:i + lanes].double()))
    return torch.cat(out)


def _attn_bwd_bound(bh, sq, skv, d, dtype, causal, window, dv=None):
    # five products a visible pair: Q K' (2 D), dO V' (2 Dv), dV (2 Dv),
    # dK (2 D), dQ (2 D); q, k, v, o, dO and lse read once, dq, dk, dv
    # written once.  bf16 at the bf16 tensor-core rate, float32 at float32
    # grade: the TF32 rate over three passes (the kernel's six bf16 passes
    # cost the same)
    dv = d if dv is None else dv
    flops = bh * _attn_pairs(sq, skv, causal, window) * 2 * (3 * d + 2 * dv)
    size = TYPES[dtype].itemsize
    nbytes = size * bh * (2 * (sq * d + skv * d + skv * dv) + 2 * sq * dv) \
        + 4 * bh * sq
    peak = PEAK_BF16_TC_FLOP_S if dtype == "bf16" \
        else PEAK_TF32_TC_FLOP_S / TF32_SPLIT_PASSES
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (nbytes, flops, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _grad_errs(got, want):
    """Per gradient (dq, dk, dv): max |got - want| as a fraction of max
    |want|."""
    return [float((g.double() - w.double()).abs().max()
                  / w.double().abs().max()) for g, w in zip(got, want)]


def _row_errs(got, want):
    """Per gradient (dq, dk, dv; each (lanes, rows, depth)): the largest
    over rows of max |got - want| as a fraction of the row's max |want|,
    at least BWD_ROW_FLOOR of the gradient's max |want|."""
    out = []
    for g, w in zip(got, want):
        scale = w.float().abs().amax(-1)
        scale = scale.clamp(min=BWD_ROW_FLOOR * float(scale.max()))
        out.append(float(((g.float() - w.float()).abs().amax(-1)
                          / scale).max()))
    return out


def _sdpa_backward(q, k, v, do, causal, window):
    """scaled_dot_product_attention's backward at K5's call (timed only):
    (the function to time, its name).  SDPA's causal mask is aligned top
    left, so a call whose mask is not that (a window that bites, causal
    with Sq != Skv) passes a boolean attn_mask, on the efficient-attention
    backend, which differentiates one."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq, skv = q.shape[1], k.shape[1]
    leaves = [x[None].detach().requires_grad_(True) for x in (q, k, v)]
    if (sq == skv or not causal) and (window is None or window >= skv):
        out = sdpa(*leaves, is_causal=causal)
        name = (f"scaled_dot_product_attention(is_causal={causal}) "
                f"backward on (1, BH, S, D)")
    else:
        mask = flash_attention.visible(sq, skv, causal, window, q.device)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = sdpa(*leaves, attn_mask=mask)
        name = ("scaled_dot_product_attention(attn_mask=visible(...)) "
                "backward on (1, BH, S, D), efficient-attention backend")

    def library():
        return torch.autograd.grad(out, leaves, do[None], retain_graph=True)
    return library, name


def _attn_bwd_kernel_rows(device, gen):
    """K5's backward at every row of BWD_ATTN_ROWS, after the forward that
    writes the row log-sum-exp: run twice (the same bits), held on its
    first BWD_COMPARE_LANES lanes against ``flash_attention_backward_plain``
    (from the plain forward's float32 o and lse) at ATTN_TOL of each
    gradient's max and per row (bf16) or ATTN_F32_SPLIT_TOL (float32; the
    float64 gradients' distances reported), the forward's o and lse held
    against the plain ones, timed beside the plain backward (over all
    lanes, a slice at a time) and scaled_dot_product_attention's
    backward."""
    report, rows = [], {}
    for name, shape in BWD_ATTN_ROWS:
        bh, sq, skv, d, dtype, causal, window = shape[:7]
        dv = shape[7] if len(shape) > 7 else d
        t = TYPES[dtype]
        q, k = (torch.randn((bh, n, d), generator=gen, device=device).to(t)
                for n in (sq, skv))
        v = torch.randn((bh, skv, dv), generator=gen, device=device).to(t)
        do = torch.randn((bh, sq, dv), generator=gen, device=device).to(t)
        o, lse = flash_attention._forward_cuda(q, k, v, causal, window,
                                               with_lse=True)

        def kernel():
            return flash_attention.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=causal, window=window)
        grads, again = kernel(), kernel()
        torch.cuda.synchronize()
        same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
        assert same_bits, ("flash_attention_bwd: two runs differ", shape)
        del again
        n = min(bh, BWD_COMPARE_LANES)
        qs, ks, vs, dos = (x[:n] for x in (q, k, v, do))
        o0 = flash_attention.flash_attention_plain(
            qs.float(), ks.float(), vs.float(), causal=causal, window=window)
        lse0 = flash_attention.flash_attention_lse_plain(
            qs, ks, causal=causal, window=window)
        # the training forward (the row log-sum-exp written) at this call
        o_err = float((o[:n].float() - o0).abs().max())
        lse_err = float((lse[:n] - lse0).abs().max())
        o_ulps = _bf16_ulps(o[:n], o0) if dtype == "bf16" else None
        assert torch.isfinite(o).all() and o_err <= (
            ATTN_TOL["bf16"] if dtype == "bf16" else ATTN_F32_SPLIT_TOL) \
            and (o_ulps is None or o_ulps <= BF16_ULPS), \
            ("flash_attention (lse) disagrees", shape, o_err, o_ulps)
        assert lse_err <= LSE_TOL * float(lse0.abs().max()), \
            ("flash_attention's lse disagrees", shape, lse_err)
        want = flash_attention.flash_attention_backward_plain(
            qs, ks, vs, o0, lse0, dos, causal=causal, window=window)
        got = [g[:n] for g in grads]
        errs = _grad_errs(got, want)
        err = max(errs)
        row = {"shape": list(shape), "compared_lanes": n,
               "max_abs_err": max(float((g.float() - w).abs().max())
                                  for g, w in zip(got, want)),
               "max_rel_err_of_max": err, "dq_dk_dv_rel_errs": errs,
               "forward_lse_o_max_abs_err": o_err,
               "forward_lse_o_bf16_steps": o_ulps,
               "lse_max_abs_err": lse_err,
               "same_bits_twice": same_bits}
        assert all(torch.isfinite(g).all() for g in grads), shape
        if dtype == "bf16":
            # per row against the plain backward on the kernel's own
            # inputs (its bf16 o and its lse): from the plain forward's
            # float32 o, delta = rowsum(dO o O) carries o's bf16 rounding
            # into every dS of a row, which stays where a peaked row's dq
            # (about P (1 - P)) is small; that is the forward's rounding
            # (the plain backward given the bf16 o parts from itself given
            # the float32 o as much, ``plain_bf16_o_per_row``)
            want_in = flash_attention.flash_attention_backward_plain(
                qs, ks, vs, o[:n], lse[:n], dos, causal=causal,
                window=window)
            rows_err = _row_errs(got, want_in)
            row.update(dq_dk_dv_rel_errs_per_row=rows_err,
                       per_row_vs_plain_forward=_row_errs(got, want),
                       plain_bf16_o_per_row=_row_errs(want_in, want))
            del want_in
            assert err <= ATTN_TOL["bf16"] \
                and max(rows_err) <= ATTN_TOL["bf16"], \
                ("flash_attention_bwd", shape, errs, row)
            # per element, in bf16 steps at each element's magnitude (near
            # 0, dS = P o (dP - delta) cancels) and at the gradient's max
            row["max_err_bf16_steps_per_element"] = max(
                _bf16_ulps(g, w) for g, w in zip(got, want))
            row["max_err_bf16_steps_at_max"] = err * 256.0
        else:
            o64 = _attn_f64(qs, ks, vs, causal, window)
            lse64 = flash_attention.flash_attention_lse_plain(
                qs.double(), ks.double(), causal=causal, window=window)
            want64 = flash_attention.flash_attention_backward_plain(
                qs.double(), ks.double(), vs.double(), o64, lse64,
                dos.double(), causal=causal, window=window)
            row.update(rel_err_vs_f64=max(_grad_errs(got, want64)),
                       plain_rel_err_vs_f64=max(_grad_errs(want, want64)))
            assert err <= ATTN_F32_SPLIT_TOL, \
                ("flash_attention_bwd float32 outside the split-TF32 tier",
                 shape, err, row)
            del o64, lse64, want64
        del o0, lse0, want, got

        def plain():
            return [flash_attention.flash_attention_backward_plain(
                q[i:i + n], k[i:i + n], v[i:i + n], o[i:i + n],
                lse[i:i + n], do[i:i + n], causal=causal, window=window)
                for i in range(0, bh, n)]
        nbytes, flops, bound, by = _attn_bwd_bound(*shape)
        if dtype == "f32":
            # the scratch one call allocates beside its outputs (delta and
            # the parts of q, k, v, dO) as the device allocator counts it
            # (the peak of the call less what stays allocated after it),
            # and the prologue's share of the call's device time
            del grads
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            grads = kernel()
            torch.cuda.synchronize()
            row["scratch_bytes"] = (torch.cuda.max_memory_allocated()
                                    - torch.cuda.memory_allocated())
            traced = _device_kernels(kernel)
            if traced is not None:
                split = sum(ms for name, (_, ms) in traced.items()
                            if "attn_bwd_split_kernel" in name)
                row["prologue_device_ms"] = split
                row["prologue_share"] = split / sum(
                    ms for _, ms in traced.values())
        row.update({
            # one wrapper call: its CUDA launches as a captured graph holds
            # them (the prologue, then dK/dV and dQ in one grid)
            "cuda_launches_per_call": _graph_launches(kernel),
            "ms": _time_ms(kernel, cold=True),
            "plain_ms": _time_ms(plain, cold=True, runs=3, warmup=1),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "operations": flops})
        try:                        # Dv != D: not every backend takes it
            library, row["library"] = _sdpa_backward(q, k, v, do, causal,
                                                     window)
            library()
        except RuntimeError as exc:
            row["library_error"] = str(exc).splitlines()[0][:200]
        else:
            row["library_ms"] = _time_ms(library, cold=True)
        library = None
        assert row["cuda_launches_per_call"] == 2, row
        rows[(name, dtype)] = row
        report.append({"name": name, "flash_attention_bwd": row})
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return report, rows


def _lse_write_cost(device, gen):
    """The forward at serve_zamba2's row with and without the row
    log-sum-exp written (the training form), timed in turns (without,
    with, with, without); the two give o with the same bits."""
    bh, sq, skv, d, dtype, causal, window = MAIN_ATTN_SHAPE
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=device)
               .to(TYPES[dtype]) for n in (sq, skv, skv))
    calls = {lse: (lambda lse=lse: flash_attention._forward_cuda(
        q, k, v, causal, window, with_lse=lse)) for lse in (False, True)}
    same = torch.equal(calls[False]()[0], calls[True]()[0])
    assert same, "the forward's o differs with the row log-sum-exp written"
    times = {False: [], True: []}
    for lse in (False, True, True, False):
        times[lse].append(_time_ms(calls[lse], cold=True))
    return {"shape": list(MAIN_ATTN_SHAPE), "ms_without_lse": times[False],
            "ms_with_lse": times[True], "same_o_bits": same}


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
    the scan: library_ms is None.  The main row (zamba2's) carries
    xlstm-350m's row beside it (``xlstm``)."""
    report, main, xlstm = [], None, None
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
        if shape in (MAIN_SSD_SHAPE, XLSTM_SSD_SHAPE):
            row["plain_ms"] = _time_ms(lambda: ssd_scan.ssd_scan_plain(
                x, la, bm, cm, heads=heads), cold=True, runs=5, warmup=1)
            # one wrapper call (one count): its CUDA launches as a captured
            # CUDA graph holds them, and the scratch it allocates beside y and
            # the state as the device allocator counts it (the peak of the
            # call less what stays allocated after it)
            row["cuda_launches_per_call"] = _graph_launches(
                lambda: ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads))
            assert row["cuda_launches_per_call"] >= 1, row
            del y, st
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y, st = ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads)
            torch.cuda.synchronize()
            row["scratch_bytes"] = (torch.cuda.max_memory_allocated()
                                    - torch.cuda.memory_allocated())
            if shape == MAIN_SSD_SHAPE:
                main = row
            else:
                xlstm = {"shape": list(shape), **row}
        report.append({"shape": list(shape), "ssd_scan": row})
        del x, la, bm, cm, y, st, y0, st0
        torch.cuda.empty_cache()
    main["xlstm"] = xlstm
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
                        "flash_attention": 0,
                        "flash_attention_bwd": 0, "ssd_scan": 0}


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
    launch counts are the wrappers' own and are not touched).  A forward
    of flash attention that takes the backward route (grad mode on, an
    input that requires a gradient: the kernel writes the row
    log-sum-exp) is recorded under ``flash_attention_lse``."""
    seen = {name: set() for name in KERNELS} | {"flash_attention_lse": set()}
    real = {name: getattr(KERNEL_MODULES[name], f"{name}_cuda")
            for name in KERNELS}

    def recorder(name):
        def call(operand, *args, **kw):
            shape = tuple(operand.shape)
            if name == "crossfit_gram":         # (T,) of w, then x's (N, P)
                shape = (int(args[0].shape[0]),) + shape
            elif name in ("flash_attention", "flash_attention_bwd"):
                # ATTN_SHAPES' key (the backward's: BWD_ATTN_ROWS')
                dv = int(args[1].shape[-1])
                shape = (shape[0], shape[1], int(args[0].shape[1]), shape[2],
                         TYPE_NAMES[operand.dtype], bool(kw["causal"]),
                         kw["window"]) + ((dv,) if dv != shape[2] else ())
            elif name == "ssd_scan":            # SSD_SHAPES' key
                shape = shape + (int(args[1].shape[-1]), int(kw["chunk"]),
                                 int(kw["heads"]))
            lse = name == "flash_attention" and torch.is_grad_enabled() \
                and any(t.requires_grad for t in (operand, *args[:2]))
            seen["flash_attention_lse" if lse else name].add(shape)
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


def _hold_blocked(shape, device):
    """K3 against its plain version at one (B, C, Nc, P), with the kernels
    phase's inputs and tolerance (no timing)."""
    gen = torch.Generator(device=device).manual_seed(20210104)
    b, c, nc, p = shape
    xc = torch.randn(shape, generator=gen, device=device)
    y = torch.randn((b, c, nc), generator=gen, device=device)
    w = (torch.rand((b, c, nc), generator=gen, device=device) < 0.8).float()
    g, bv = ops.batched_gram_blocked(xc, w, y)
    g0, b0 = megabatch.batched_gram_blocked_plain(xc, w, y)
    assert torch.allclose(g, g0, rtol=1e-4,
                          atol=1e-4 * float(g0.abs().max())), \
        ("batched_gram_blocked G disagrees", shape, _errs(g, g0))
    assert torch.allclose(bv, b0, rtol=1e-4,
                          atol=1e-4 * float(b0.abs().max())), \
        ("batched_gram_blocked b disagrees", shape, _errs(bv, b0))
    del xc, y, w, g, bv, g0, b0
    torch.cuda.empty_cache()


def _launches_compared(seen, what, device=None):
    """Every launch of a path ran at a shape the kernels phase compared.
    With ``device``, a K1, K2 or K3 launch at another shape is held
    against the plain versions now instead (not counted: the counts of
    the path were read before); returns those shapes."""
    compared = {"batched_gram": set(SHAPES), "batched_predict": set(SHAPES),
                "batched_gram_blocked": set(BLOCKED_SHAPES),
                "crossfit_gram": set(XFIT_SHAPES),
                "flash_attention": set(ATTN_SHAPES),
                "flash_attention_bwd": {row for _, row in BWD_ATTN_ROWS},
                "flash_attention_lse": {row for _, row in BWD_ATTN_ROWS},
                "ssd_scan": {shape for shape, _ in SSD_SHAPES}}
    held = set()
    if device is not None:
        held = (seen["batched_gram"] | seen["batched_predict"]) \
            - compared["batched_gram"]
        for shape in sorted(held):
            _hold_megabatch(shape, device)
        compared["batched_gram"] |= held
        compared["batched_predict"] |= held
        blocked = seen["batched_gram_blocked"] \
            - compared["batched_gram_blocked"]
        for shape in sorted(blocked):
            _hold_blocked(shape, device)
        compared["batched_gram_blocked"] |= blocked
        held |= blocked
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
                            "flash_attention": 0,
                            "flash_attention_bwd": 0, "ssd_scan": 0}, \
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
                        "batched_predict": 0, "crossfit_gram": lanes,
                        "flash_attention": 0,
                        "flash_attention_bwd": 0, "ssd_scan": 0}, \
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
            "crossfit_gram": shared_launches["crossfit_gram"],
            "result": res_boot}


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


def _consistency(bundle, params, prompt, device, tier=None):
    """The reference's prefill/decode check (tests/test_models_smoke.py):
    the greedy token of prefill(prompt), decoded once from the cache,
    against prefill(prompt + token): the same argmax, logits within its
    tier of max|logits|: 0.10 for the hybrid and MoE families, 0.05 for
    the dense one."""
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
    ia, ib = a.argmax(-1), b.argmax(-1)
    assert same, ("prefill/decode argmax differs", ia, ib,
                  "decode rates them", a[0, ia], a[0, ib],
                  "prefill rates them", b[0, ia], b[0, ib], "rel", rel)
    if tier is None:
        tier = 0.05 if cfg.family == "dense" else 0.10
    assert rel < tier, ("prefill/decode logits differ", rel, tier)
    return {"prompt_len": int(prompt.shape[0]), "same_argmax": same,
            "max_abs_diff_over_max_abs_logits": rel, "tier": tier,
            "max_abs_logits": float(np.abs(b).max())}


def _serve_prompts(vocab: int, n: int, slot_len: int, lo: int):
    """``n`` prompts of ragged length in [lo, slot_len] (the first exactly
    ``slot_len``), token ids drawn from LM_SEED."""
    rng = np.random.default_rng(LM_SEED)
    lens = rng.integers(lo, slot_len + 1, size=n)
    lens[0] = slot_len
    return [rng.integers(0, vocab, size=int(m)).astype(np.int32)
            for m in lens]


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
    prompts = _serve_prompts(cfg.vocab_size, SERVE_PROMPTS, SERVE_LEN,
                             SERVE_LEN // 2)
    lens = [len(p) for p in prompts]
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
                        "flash_attention_bwd": 0,
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


# the largest prompt whose prefill, one token longer, stays dropless in
# the MoE dispatch (a pool of at most 256 tokens: moe._capacity)
MOE_DROPLESS_PROMPT = 255


def _consistency_f32(bundle, params, prompt, device, depth=None):
    """The reference's prefill/decode check on the decoder families, in
    float32 at their full width, held at the float32 LM tier (1e-3) and
    the same argmax: in bf16 the full models leave the check no margin
    (0.036–0.102 of max|logits| measured on an H100, argmaxes one bf16
    step apart).  ``depth`` keeps the first layers only (the
    parameters sliced, then cast).  An MoE prompt is cut to
    MOE_DROPLESS_PROMPT tokens: past 256 tokens the prefill's capacity
    drops tokens that the dropless decode keeps (the reference's rule), so
    the two would differ by design."""
    cfg = bundle.arch
    if depth is not None and depth < cfg.n_layers:
        n_head = cfg.moe.first_dense_layers if cfg.family == "moe" else 0
        cfg = dataclasses.replace(cfg, n_layers=depth)
        params = {**params, "layers": tree_map(lambda t: t[:depth - n_head],
                                               params["layers"])}
        bundle = build_model(cfg)
    if cfg.family == "moe":
        prompt = prompt[:MOE_DROPLESS_PROMPT]
    out = _consistency(bundle, cast_floating(params, torch.float32), prompt,
                       device, tier=1e-3)
    return {**out, "dtype": "float32", "n_layers": cfg.n_layers}


def _serve(bundle, params, device, prompts, batch, slot_len, what):
    """One ``Engine.serve_requests`` of ``prompts`` in ``batch`` slots of
    ``slot_len``, SERVE_GEN tokens each, with the launch counts set to 0
    just before and read just after, and every launch's shape recorded;
    the model's launches (``_prefill_launches`` a burst: a decoder's K5
    once a layer) and nothing else checked, every logit finite.  Returns
    (engine, tokens, the emitted record)."""
    cfg = bundle.arch
    engine = Engine(bundle, params, device=device)
    flags = _logit_recorder(bundle)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        results = engine.serve_requests(prompts, batch_size=batch,
                                        prompt_len=slot_len,
                                        n_gen=SERVE_GEN)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_bursts = -(-len(prompts) // batch)
    assert launches == {**{k: 0 for k in launches},
                        **{k: n_bursts * n for k, n in
                           _prefill_launches(cfg).items()}}, \
        (what, launches)
    _launches_compared(seen, what)
    assert bool(torch.stack(flags).all()), f"{what}: a logit is not finite"
    assert len(flags) == n_bursts * SERVE_GEN
    assert len(results) == len(prompts) and all(
        r.shape == (SERVE_GEN,) and r.min() >= 0 and r.max() < cfg.vocab_size
        for r in results)
    bursts = [{"prefill_s": r.prefill_s, "decode_s": r.decode_s,
               "decode_tokens_per_s": r.tokens_per_s,
               "prefill_tokens_per_s": batch * slot_len / r.prefill_s}
              for r in engine.last_results]
    record = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "params": param_count(bundle.decls),
              "prompts": len(prompts),
              "prompt_lens": [len(p) for p in prompts], "batch": batch,
              "prompt_len": slot_len, "n_gen": SERVE_GEN, "wall_s": wall,
              "bursts": bursts, "peak_device_bytes": peak,
              "launches": launches,
              "launch_shapes": {k: sorted(map(str, v))
                                for k, v in seen.items() if v},
              "first_tokens": [r[:4].tolist() for r in results]}
    return engine, results, record


def phase_serve_deepseek(device):
    """The decoder families' headline path: the full deepseek-v2-lite-16b
    (27 layers: a dense head layer, then 26 with 64 routed experts top-6
    and 2 shared ones; MLA with a 512-wide latent and a 64-wide rope key),
    bf16 weights drawn on the card from a seeded generator, through
    ``Engine.serve_requests`` on serve_zamba2's burst: 8 prompts of ragged
    length <= 2048 in slots of 4 (2 prefills of 27 K5 launches at Dqk 192,
    Dv 128; 30 decode steps against the latent cache).  Served twice: the
    MoE combine sums in a fixed order, so the tokens are the same.  Launch
    counts are set to 0 just before the first serve and read just after.
    The prefill/decode check runs on its first 4 layers in float32."""
    cfg = get_arch("deepseek-v2-lite-16b")
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = init_tree(bundle.decls, gen, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = torch.cuda.memory_allocated()
    prompts = _serve_prompts(cfg.vocab_size, SERVE_PROMPTS, SERVE_LEN,
                             SERVE_LEN // 2)
    engine, results, record = _serve(bundle, params, device, prompts,
                                     SERVE_BATCH, SERVE_LEN,
                                     "serve_deepseek")
    launches = record["launches"]
    assert record["launch_shapes"]["flash_attention"] == \
        [str(MLA_ATTN_SHAPE)], record["launch_shapes"]
    again = engine.serve_requests(prompts, batch_size=SERVE_BATCH,
                                  prompt_len=SERVE_LEN, n_gen=SERVE_GEN)
    same = all(np.array_equal(a, b) for a, b in zip(results, again))
    assert same, "serve_deepseek: two identical serves differ"
    consistency = _consistency_f32(bundle, params, prompts[0], device,
                                   depth=4)
    emit("serve_deepseek", **record, param_bytes_on_card=param_bytes,
         init_s=init_s, second_serve_same_tokens=same,
         consistency=consistency)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def phase_serve_dense(device):
    """The dense and MoE decoders at full width: h2o-danube-3-4b in full
    (24 layers, GQA 32/8, window 4096) on prompts longer than its window,
    in slots of 4608 — K5's window hides tiles, and decode's cache (4608
    slots, not grown past the window) wraps, slot = pos % 4608;
    codeqwen1.5-7b (QKV bias) and qwen2-moe-a2.7b (60 experts top-4, the
    gated shared expert) with their depth cut to 4; qwen2.5-32b (40 heads,
    GQA 40/8) and yi-34b (56 heads, GQA 56/8) cut to 2 (DENSE_SERVES);
    each model's prefill/decode check in float32 (h2o-danube on its
    4608-token prompt, past the window).  Each model is freed before the
    next loads."""
    models = []
    for arch, depth, batch, slot_len, n_prompts in DENSE_SERVES:
        cfg = get_arch(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        bundle = build_model(cfg)
        gen = torch.Generator(device=device).manual_seed(LM_SEED)
        params = init_tree(bundle.decls, gen, device)
        window = cfg.attention.sliding_window
        lo = window + 1 if window and window < slot_len else slot_len // 2
        prompts = _serve_prompts(cfg.vocab_size, n_prompts, slot_len, lo)
        engine, _, record = _serve(bundle, params, device, prompts, batch,
                                   slot_len, f"serve_dense/{arch}")
        record["cut"] = None if depth is None else \
            f"depth {get_arch(arch).n_layers} -> {depth}"
        if window:
            record["window"] = window
            record["decode_slots_written"] = [
                (slot_len + i) % slot_len for i in range(SERVE_GEN - 1)]
        record["consistency"] = _consistency_f32(bundle, params,
                                                 prompts[0], device)
        models.append(record)
        del engine, params, bundle
        torch.cuda.empty_cache()
    emit("serve_dense", models=models)
    return {m["arch"]: m["launches"]["flash_attention"] for m in models}


# serve_whisper: whisper-base at the source's own lengths — (batch, encoder
# frames, prompt tokens): 30 s of audio are 1500 frames after the conv stem
WHISPER_SERVE = (4, 1500, 400)
# serve_vlm: llama-3.2-vision-90b at full width cut to VLM_GROUPS groups
# (4 self-attention layers and 1 cross-attention layer each: about 10.7 B
# parameters, 21 GB in bf16; the whole model's 180 GB does not fit one
# card), VLM_BATCH prompts of VLM_LEN tokens against one image tile's 1601
# patch embeddings, the cross-attention gates at VLM_GATE (declared zero,
# which cancels the cross-attention)
VLM_GROUPS, VLM_BATCH, VLM_LEN, VLM_GATE = 2, 2, 2048, 0.5


@contextlib.contextmanager
def _device_spans(targets):
    """Bracket every call of each ``(module, attribute)`` of ``targets``
    with CUDA events for the duration: yields {attribute: [(start, end),
    ...]}, to be read after a synchronize."""
    spans = {name: [] for _, name in targets}
    real = [(module, name, getattr(module, name)) for module, name in targets]

    def bracket(fn, name):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    for module, name, fn in real:
        setattr(module, name, bracket(fn, name))
    try:
        yield spans
    finally:
        for module, name, fn in real:
            setattr(module, name, fn)


def _prefill_shares(bundle, params, batch, targets):
    """One prefill of ``batch`` with each target of ``_device_spans``
    bracketed: the prefill's time (host clock, synchronized) and each
    target's calls, summed device span and share of the prefill (a span
    runs from its first launch to its last: for a loop of small launches
    it holds the gaps in which the device waits for the host)."""
    torch.cuda.synchronize()
    with torch.inference_mode(), _device_spans(targets) as spans:
        t0 = time.perf_counter()
        bundle.prefill_fn(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill_ms": wall_ms}
    for name, pairs in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        out[name] = {"calls": len(pairs), "ms": ms, "share": ms / wall_ms}
    return out


def _burst_tokens(prompts, batch, slot_len, device):
    """The first burst ``Engine.serve_requests`` makes of ``prompts``:
    ``batch`` slots of ``slot_len`` tokens, left-padded with 0."""
    toks = np.zeros((batch, slot_len), np.int32)
    for i, prompt in enumerate(prompts[:batch]):
        toks[i, -len(prompt[-slot_len:]):] = prompt[-slot_len:]
    return torch.as_tensor(toks, device=device)


def _seeded_model(cfg, device):
    """(bundle, bf16 parameters drawn on the card from LM_SEED, seconds,
    bytes on the card)."""
    bundle = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = init_tree(bundle.decls, gen, device)
    torch.cuda.synchronize()
    return bundle, params, time.perf_counter() - t0, \
        torch.cuda.memory_allocated()


def phase_serve_xlstm(device):
    """The xLSTM family's headline path: the full xlstm-350m (24 layers: 3
    groups of 7 mLSTM blocks and an sLSTM block; each mLSTM's 4 heads of
    512 are SSD lanes with a state of N 512 keys by P 513 values, the
    normalizer included), bf16 weights drawn on the card from a seeded
    generator, through ``Engine.serve_requests`` on serve_zamba2's burst:
    8 prompts of ragged length <= 2048 in slots of 4 (2 prefills of 21 K6
    launches at XLSTM_SSD_SHAPE; 30 decode steps of the recurrent state).
    Served twice: the same tokens.  Launch counts are set to 0 just before
    the first serve and read just after.  Then one prefill of the first
    burst with K6's and the sLSTM loop's device spans, the loop's CUDA
    launches as a captured CUDA graph holds them, its busy time as the
    profiler traces it, and the prefill/decode check in float32 (the
    reference's check, which its reduced xlstm runs on no block)."""
    cfg = get_arch("xlstm-350m")
    bundle, params, init_s, param_bytes = _seeded_model(cfg, device)
    prompts = _serve_prompts(cfg.vocab_size, SERVE_PROMPTS, SERVE_LEN,
                             SERVE_LEN // 2)
    engine, results, record = _serve(bundle, params, device, prompts,
                                     SERVE_BATCH, SERVE_LEN, "serve_xlstm")
    assert record["launch_shapes"] == {"ssd_scan": [str(XLSTM_SSD_SHAPE)]}, \
        record["launch_shapes"]
    again = engine.serve_requests(prompts, batch_size=SERVE_BATCH,
                                  prompt_len=SERVE_LEN, n_gen=SERVE_GEN)
    same = all(np.array_equal(a, b) for a, b in zip(results, again))
    assert same, "serve_xlstm: two identical serves differ"
    shares = _prefill_shares(
        bundle, params,
        {"tokens": _burst_tokens(prompts, SERVE_BATCH, SERVE_LEN, device)},
        [(ssd_scan, "ssd_scan_cuda"), (ssm_blocks, "slstm_forward")])
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    x = torch.randn((SERVE_BATCH, SERVE_LEN, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    layer = tree_map(lambda t: t[0], params["slstm"])
    with torch.inference_mode():
        launches = _graph_launches(
            lambda: ssm_blocks.slstm_forward(layer, cfg, x))
        traced = _device_kernels(
            lambda: ssm_blocks.slstm_forward(layer, cfg, x))
    # the busy time needs a whole profiler session: None where none was
    slstm = {"cuda_launches_per_layer": launches,
             "device_ms_per_layer": None if traced is None else
             sum(t for _, t in traced.values()),
             "steps": SERVE_LEN, "batch": SERVE_BATCH}
    del x
    consistency = _consistency_f32(bundle, params, prompts[0], device)
    emit("serve_xlstm", **record, param_bytes_on_card=param_bytes,
         init_s=init_s, second_serve_same_tokens=same,
         prefill_shares=shares, slstm_loop=slstm, consistency=consistency)
    del engine, params
    torch.cuda.empty_cache()
    return record["launches"]


def _generate_twice(bundle, params, device, batch, what):
    """``Engine.generate`` of ``batch`` (tokens and the family's frames or
    image patches), SERVE_GEN tokens, with the launch counts set to 0 just
    before and read just after and every launch's shape recorded, then
    again: the model's launches (``_prefill_launches``) and nothing else,
    every logit finite, the same tokens twice.  Returns (the result, the
    emitted record)."""
    cfg = bundle.arch
    engine = Engine(bundle, params, device=device)
    flags = _logit_recorder(bundle)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        res = engine.generate(batch, n_gen=SERVE_GEN)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    assert launches == {**{k: 0 for k in launches},
                        **_prefill_launches(cfg)}, (what, launches)
    _launches_compared(seen, what)
    assert bool(torch.stack(flags).all()), f"{what}: a logit is not finite"
    assert len(flags) == SERVE_GEN
    assert res.tokens.shape == (len(batch["tokens"]), SERVE_GEN) and \
        res.tokens.min() >= 0 and res.tokens.max() < cfg.vocab_size
    again = engine.generate(batch, n_gen=SERVE_GEN)
    same = bool(np.array_equal(res.tokens, again.tokens))
    assert same, f"{what}: two identical generates differ"
    record = {"arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "params": param_count(bundle.decls),
              "inputs": {k: list(np.shape(v)) for k, v in batch.items()},
              "n_gen": SERVE_GEN, "wall_s": wall, "prefill_s": res.prefill_s,
              "decode_s": res.decode_s,
              "decode_tokens_per_s": res.tokens_per_s,
              "peak_device_bytes": peak, "launches": launches,
              "launch_shapes": {k: sorted(map(str, v))
                                for k, v in seen.items() if v},
              "second_generate_same_tokens": same,
              "first_tokens": res.tokens[:, :4].tolist()}
    return res, record


def phase_serve_whisper(device):
    """The encoder-decoder family: the full whisper-base (6 encoder layers
    over precomputed frames, 6 decoder layers with self- and
    cross-attention, d 512, 8 heads of 64), bf16 weights drawn on the
    card from a seeded generator, through ``Engine.generate`` (the frames
    ride in the batch; serve_requests passes tokens only, as the
    reference's does) at the source's lengths: 4 requests of 1500 frames
    and a 400-token prompt, SERVE_GEN tokens generated.  K5 18 times a
    prefill: the encoder (not causal), the decoder's self-attention
    (causal) and its cross-attention against the 1500 frames.  Then one
    prefill with K5's device spans."""
    cfg = get_arch("whisper-base")
    bundle, params, init_s, param_bytes = _seeded_model(cfg, device)
    b, n_frames, n_tok = WHISPER_SERVE
    rng = np.random.default_rng(LM_SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, n_tok))
             .astype(np.int32),
             "frames": rng.standard_normal((b, n_frames, cfg.d_frontend),
                                           dtype=np.float32)}
    _, record = _generate_twice(bundle, params, device, batch,
                                "serve_whisper")
    shares = _prefill_shares(
        bundle, params, {k: torch.as_tensor(v, device=device)
                         for k, v in batch.items()},
        [(flash_attention, "flash_attention_cuda")])
    emit("serve_whisper", **record, param_bytes_on_card=param_bytes,
         init_s=init_s, prefill_shares=shares,
         decode_position="the sinusoid of position 0 at every decode step, "
                         "as the reference's decode adds it")
    del params
    torch.cuda.empty_cache()
    return record["launches"]


def phase_serve_vlm(device):
    """The VLM family: llama-3.2-vision-90b at full width (d 8192, 64
    heads of 128, GQA 64/8, d_ff 28672, vocab 128256) cut to VLM_GROUPS
    groups of 4 self-attention layers and one gated cross-attention layer
    (the whole model does not fit one card), bf16 weights drawn on the
    card from a seeded generator, the gates set to VLM_GATE, through
    ``Engine.generate`` with the image patches in the batch: VLM_BATCH
    prompts of VLM_LEN tokens against one tile's 1601 patch embeddings,
    SERVE_GEN tokens generated.  K5 once a layer a prefill: causal
    self-attention, and cross-attention at Sq 2048 > Skv 1601 with no
    mask.  Then one prefill with K5's device spans."""
    full = get_arch("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full,
                              n_layers=VLM_GROUPS * full.cross_attn_every)
    bundle, params, init_s, param_bytes = _seeded_model(cfg, device)
    params["cross_layers"]["gate"].fill_(VLM_GATE)
    rng = np.random.default_rng(LM_SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (VLM_BATCH, VLM_LEN))
             .astype(np.int32),
             "img": rng.standard_normal(
                 (VLM_BATCH, cfg.n_frontend_tokens, cfg.d_frontend),
                 dtype=np.float32)}
    _, record = _generate_twice(bundle, params, device, batch, "serve_vlm")
    cross = str((VLM_BATCH * cfg.attention.n_heads, VLM_LEN,
                 cfg.n_frontend_tokens, cfg.attention.head_dim, "bf16",
                 False, None))
    assert cross in record["launch_shapes"]["flash_attention"], \
        record["launch_shapes"]
    shares = _prefill_shares(
        bundle, params, {k: torch.as_tensor(v, device=device)
                         for k, v in batch.items()},
        [(flash_attention, "flash_attention_cuda")])
    emit("serve_vlm", **record, param_bytes_on_card=param_bytes,
         init_s=init_s, prefill_shares=shares, gate=VLM_GATE,
         cut=f"depth {full.n_layers} -> {cfg.n_layers} layers "
             f"({VLM_GROUPS} groups of {full.cross_attn_every - 1} self + 1 "
             f"cross); width, heads and vocab in full")
    del params
    torch.cuda.empty_cache()
    return record["launches"]


@contextlib.contextmanager
def _recorded_routes():
    """Record the experts the MoE router picks at every routed layer, as
    (T, k) tensors sorted along k on the CPU, in call order."""
    # imported here: scripts/bench_*.py import this module beside the
    # package of an older tree, which has no MoE
    from repro_torch.models import moe
    real, seen = moe._route, []

    def record(p, m, x, e_pad):
        out = real(p, m, x, e_pad)
        seen.append(torch.sort(out[1], dim=-1).values.cpu())
        return out
    moe._route = record
    try:
        yield seen
    finally:
        moe._route = real


def _lm_states(cache):
    """The prefill cache's float states, copied to the CPU in float32
    (decode updates the cache in place): the hybrid's SSM state and shared
    keys, the xLSTM's mLSTM states and sLSTM carries, the encoder-decoder's
    and VLM's self and cross keys, a decoder's keys (MLA: latents) of every
    stack."""
    def copy(t):
        return t.to("cpu", torch.float32, copy=True)
    if "shared_kv" in cache:
        return {"m_ssm": copy(cache["m_ssm"]),
                "k": copy(cache["shared_kv"]["k"])}
    if "m_ssm" in cache:
        return {name: copy(cache[name]) for name in ("m_ssm", "s_state")
                if name in cache}
    if "cross_kv" in cache:
        return {f"{stack}.k": copy(cache[stack]["k"])
                for stack in ("self_kv", "cross_kv")}
    return {f"{stack}.{name}": copy(cache[stack][name])
            for stack in ("head_layers", "layers") if stack in cache
            for name in ("k", "c") if name in cache[stack]}


def _lm_run(bundle, params, tokens, device, n_decode, feed=None,
            extra=None):
    """Prefill (``extra``: the batch's other inputs, frames or image
    patches), then ``n_decode`` greedy decode steps (fed ``feed``'s tokens
    when given: teacher forcing).  Returns the logits of each step, the
    tokens fed, the prefill cache's states, the launch counts and the MoE
    routes of each step (empty lists without MoE)."""
    cfg = bundle.arch
    runtime.reset_launch_counts()
    with torch.inference_mode(), _recorded_routes() as seen:
        toks = torch.as_tensor(tokens, device=device)
        batch = {"tokens": toks, **{k: v.to(device)
                                    for k, v in (extra or {}).items()}}
        logits, cache = bundle.prefill_fn(params, batch)
        states = _lm_states(cache)
        cache = grow_cache(cfg, cache, n_decode)
        out, fed, cuts = [logits.float().cpu()], [], [len(seen)]
        for i in range(n_decode):
            tok = torch.argmax(out[-1], dim=-1)[:, None].to(torch.int32) \
                if feed is None else feed[i]
            fed.append(tok)
            logits, cache = bundle.decode_fn(params, cache,
                                             {"tokens": tok.to(device)})
            out.append(logits.float().cpu())
            cuts.append(len(seen))
    if device.type == "cuda":
        torch.cuda.synchronize()
    routes = [seen[a:b] for a, b in zip([0] + cuts[:-1], cuts)]
    return out, fed, states, dict(runtime.launch_counts), routes


# the share of (layer, batch, position) rows of a prefill state that a
# bf16 MoE routing flip may move past the tier (tests/test_torch_decoder.py)
FLIP_ROWS = 0.03


def _bf16_tie(x, other, rows):
    """Rows where ``other``'s greedy pick is within one bf16 step of
    ``x``'s own maximum (logits from a bf16 product can tie)."""
    top = x.max(-1).values
    step = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    return top - x[rows, other.argmax(-1)] <= step


def _lm_compare(cpu, card, tier, what, flips=False, ties=False):
    """The card's logits and prefill states against the CPU's: within
    ``tier`` of max|CPU| and the same argmax at every step.  With
    ``flips`` (bf16 MoE: the two devices' roundings flip the routing of
    tokens whose top-k probabilities nearly tie) a decode step is held on
    the batch rows whose routing agreed in every layer, and a state on all
    but FLIP_ROWS of its rows.  With ``ties`` (the decoders in bf16) a
    differing argmax must be a tie: each side rates the other's pick
    within one bf16 step of its own maximum."""
    (lc, _, sc, _, rc), (lg, _, sg, _, rg) = cpu, card
    rows = [torch.ones(c.shape[0], dtype=torch.bool) for c in lc]
    flipped = []
    if flips:
        for step in range(1, len(lc)):
            agree = [(a == b).all(-1) for a, b in zip(rc[step], rg[step])]
            rows[step] = torch.stack(agree).all(0)
        flipped = [int(sum(int((~(a == b).all(-1)).sum())
                           for a, b in zip(rc[s], rg[s])))
                   for s in range(len(lc))]
    diffs = [float((g[r] - c[r]).abs().max() / c.abs().max())
             for c, g, r in zip(lc, lg, rows)]
    same = [bool((g[r].argmax(-1) == c[r].argmax(-1)).all()) for c, g, r in
            zip(lc, lg, rows)]
    if ties:
        same = [bool(((g[r].argmax(-1) == c[r].argmax(-1))
                      | _bf16_tie(g[r], c[r], torch.arange(int(r.sum())))
                      | _bf16_tie(c[r], g[r], torch.arange(int(r.sum()))))
                     .all()) for c, g, r in zip(lc, lg, rows)]
    state, over = {}, {}
    for k in sc:
        err = (sg[k] - sc[k]).abs()
        state[k] = float(err.max() / sc[k].abs().max())
        if flips:
            per_row = err.flatten(3).amax(-1) if err.dim() > 3 else err
            over[k] = float((per_row > tier * sc[k].abs().max())
                            .float().mean())
    assert all(np.isfinite(diffs)) and max(diffs) < tier and all(same), \
        (what, diffs, same)
    assert all(bool(r.any()) for r in rows), (what, rows)
    if flips:
        assert max(over.values()) <= FLIP_ROWS, (what, over)
    else:
        assert max(state.values()) < tier, (what, state)
    out = {"logits_rel_err_by_step": diffs, "same_argmax_by_step": same,
           "state_rel_err": state, "tier": tier}
    if flips:
        out.update(routing_flips_by_step=flipped,
                   rows_held_by_step=[int(r.sum()) for r in rows],
                   state_rows_over_tier=over)
    return out


def _prefill_launches(cfg):
    """K5's and K6's launches in one prefill: the hybrid applies its shared
    block once a group and runs K6 in every other slot; the xLSTM runs K6
    once an mLSTM block; the encoder-decoder attends once an encoder layer
    and twice (self, cross) a decoder layer; a decoder or VLM once a
    layer."""
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_every
        return {"flash_attention": groups, "ssd_scan": cfg.n_layers - groups}
    if cfg.family == "ssm":
        per = cfg.ssm.slstm_every or cfg.n_layers
        n_m = per - 1 if cfg.ssm.slstm_every else per
        return {"flash_attention": 0,
                "ssd_scan": cfg.n_layers // per * n_m}
    if cfg.family == "audio":
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers,
                "ssd_scan": 0}
    return {"flash_attention": cfg.n_layers, "ssd_scan": 0}


def phase_same_as_cpu_lm(device):
    """The card route (K5, K6) against the CPU route (the reference's jnp
    math, ported) on the same parameters and tokens, prefill and two
    decode steps fed the CPU's greedy tokens on both sides.  (a) the
    reduced zamba2 (d 64, window 64, chunk 16) at S 100, so that the
    window, a ragged SSD chunk and a ragged attention chunk are live, in
    bf16 as declared; (b) its full width with the depth cut to one group
    (6 slots: 5 Mamba2 blocks and the shared block), B 1, S 512,
    parameters cast to float32 on both sides.  The decoder families,
    reduced, in bf16 at S 100: (c) dense (h2o-danube-3-4b: window 64, past
    it), (d) MoE (qwen2-moe-a2.7b: QKV bias, the gated shared expert), (e)
    MLA (deepseek-v2-lite-16b: q and k at 48 against v at 32); (f)
    deepseek-v2-lite-16b at full width with the depth cut to 2 (its dense
    head layer and one MoE layer), B 1, S 512, in float32: the float32
    kernel at Dqk 192, Dv 128.  The last three families: (g, h) the
    reduced xlstm-350m with slstm_every 2 (two groups of an mLSTM and an
    sLSTM) and 4 (three mLSTM and an sLSTM: the reduced config itself has
    no block), in bf16 at S 100 (ragged chunks of 16); (i) xlstm-350m at
    full width (N 512, P 513) cut to 2 groups of slstm_every 2, B 1, a
    ragged S 300, in float32: K6 past 64 against the chunked CPU math; (j)
    the reduced whisper-base over 48 frames (cross-attention at Sq 100 >
    Skv 48) and (k) the reduced VLM against 16 image tokens with its gates
    at VLM_GATE, both in bf16 at S 100."""
    out = {}
    rng = np.random.default_rng(LM_SEED)
    deepseek = get_arch("deepseek-v2-lite-16b")
    xlstm = get_arch("xlstm-350m")

    def every(cfg, n, n_layers=None):
        return dataclasses.replace(
            cfg, n_layers=n_layers or cfg.n_layers,
            ssm=dataclasses.replace(cfg.ssm, slstm_every=n))
    xlstm_reduced = get_arch("xlstm-350m", reduced=True)
    cases = (
        ("reduced_bf16", get_arch("zamba2-7b", reduced=True), 2, 100, None,
         32, 0.08),
        ("full_width_one_group_f32",
         dataclasses.replace(get_arch("zamba2-7b"), n_layers=6), 1, 512,
         torch.float32, 1024, 1e-3),
        ("dense_reduced_bf16", get_arch("h2o-danube-3-4b", reduced=True), 2,
         100, None, 32, 0.08),
        ("moe_reduced_bf16", get_arch("qwen2-moe-a2.7b", reduced=True), 2,
         100, None, 32, 0.08),
        ("mla_reduced_bf16", get_arch("deepseek-v2-lite-16b", reduced=True),
         2, 100, None, 32, 0.08),
        ("mla_full_width_two_layers_f32",
         dataclasses.replace(deepseek, n_layers=2), 1, 512, torch.float32,
         1024, 1e-3),
        ("xlstm_pairs_reduced_bf16", every(xlstm_reduced, 2), 2, 100, None,
         32, 0.08),
        ("xlstm_stack_reduced_bf16", every(xlstm_reduced, 4), 2, 100, None,
         32, 0.08),
        ("xlstm_full_width_two_groups_f32", every(xlstm, 2, n_layers=4), 1,
         300, torch.float32, 1024, 1e-3),
        ("whisper_reduced_bf16", get_arch("whisper-base", reduced=True), 2,
         100, None, 32, 0.08),
        ("vlm_reduced_bf16", get_arch("llama-3.2-vision-90b", reduced=True),
         2, 100, None, 32, 0.08),
    )
    for name, cfg, batch, seq, cast, attn_chunk, tier in cases:
        bundle = build_model(cfg, attn_chunk=attn_chunk)
        t0 = time.perf_counter()
        params = init_tree(bundle.decls,
                           torch.Generator().manual_seed(LM_SEED), "cpu")
        if cast is not None:
            params = cast_floating(params, cast)
        tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        extra = {}
        if cfg.family == "audio":
            extra["frames"] = torch.from_numpy(rng.standard_normal(
                (batch, 48, cfg.d_frontend), dtype=np.float32))
        if cfg.family == "vlm":
            extra["img"] = torch.from_numpy(rng.standard_normal(
                (batch, cfg.n_frontend_tokens, cfg.d_frontend),
                dtype=np.float32))
            params["cross_layers"]["gate"].fill_(VLM_GATE)
        cpu = _lm_run(bundle, params, tokens, torch.device("cpu"), 2,
                      extra=extra)
        cpu_s = time.perf_counter() - t0
        card = _lm_run(bundle, _card_copy(params, device), tokens, device, 2,
                       feed=cpu[1], extra=extra)
        assert not any(cpu[3].values()), cpu[3]
        want = _prefill_launches(cfg)
        assert {k: card[3][k] for k in want} == want, card[3]
        flips = cast is None and cfg.family == "moe"
        ties = cast is None and cfg.family != "hybrid"
        out[name] = {"arch": cfg.name, "batch": batch, "seq": seq,
                     "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                     "dtype": "float32" if cast else "bf16 as declared",
                     "cpu_side_s": cpu_s, "card_launches": card[3],
                     "same_or_bf16_tie": ties,
                     **_lm_compare(cpu, card, tier, name, flips=flips,
                                   ties=ties)}
        del params, cpu, card
        torch.cuda.empty_cache()
    f32_launches = {name: out[name]["card_launches"]["flash_attention"]
                    for name in ("full_width_one_group_f32",
                                 "mla_full_width_two_layers_f32")}
    f32_launches["xlstm_ssd_scan"] = out["xlstm_full_width_two_groups_f32"][
        "card_launches"]["ssd_scan"]
    emit("same_as_cpu_lm", cases=out,
         cut="(b): zamba2 depth 81 -> 6 slots (one group), (f): "
             "deepseek-v2-lite depth 27 -> 2 layers; both B 1, S 512; (i): "
             "xlstm-350m depth 24 -> 4 (2 groups of slstm_every 2), B 1, S "
             "300; to keep the CPU side under a minute each",
         tolerance="logits and prefill states within the tier of max|CPU|, "
                   "the same argmax at every step: 0.08 (bf16), 1e-3 "
                   "(float32); bf16 MoE (d, e): decode rows where the "
                   "routing agreed in every layer, states on all but "
                   f"{FLIP_ROWS} of their rows (routing flips); bf16 "
                   "decoders (c-e): a differing argmax a tie within one "
                   "bf16 step")
    return f32_launches


# ---------------------------------------------------------------------------
# the topology backend: simulated hosts as CUDA streams on one card, host
# loss and hedging across streams, durable sessions, the protocol checks
# ---------------------------------------------------------------------------
TOPOLOGY_HOSTS = (2, 4)
# the hedged drains of topology_chaos: a chaos pool (failures 0.1,
# stragglers 0.2), and the same with every bucket overdue at once (the
# evidence for hedging across host streams without a straggler hold)
TOPO_CHAOS_POOL = PoolConfig(n_hosts=2, failure_rate=0.1,
                             straggler_rate=0.2, max_retries=10, seed=5)
TOPO_FORCED_HEDGE_POOL = dataclasses.replace(TOPO_CHAOS_POOL, hedge=True,
                                             hedge_after_s=0.0)
DURABLE_N_REP = 10
# the child of the durable phase: a durable session on the card (wave
# backend), two paper-sized ridge requests at M 10; it reports the rows
# each ledger holds after the first settled wave and leaves with os._exit
DURABLE_CHILD = """
import json, os, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.core import DMLData, DMLPlan, DMLSession
from repro_torch.data import make_bonus_data
data = DMLData.from_dict(make_bonus_data())
sess = DMLSession(device=sys.argv[4], session_dir=sys.argv[1])
for seed in (42, 43):
    sess.submit(DMLPlan.for_model("plr", learner="ridge",
                                  learner_params={"reg": 1.0}, n_folds=5,
                                  n_rep=int(sys.argv[3]), seed=seed), data)
for _ in range(100):
    sess.poll()
    reqs = {p.request_id: p.req for p in sess._queue if p.req is not None}
    reqs.update(sess._requests)
    if sum(r.ledger.n_done for r in reqs.values()) > 0:
        break
from repro_torch.compile import persist
print(json.dumps({"done": {i: r.ledger.n_done for i, r in reqs.items()},
                  "n_inv": {i: r.ledger.n_invocations
                            for i, r in reqs.items()},
                  "library_builds": persist.library_store().builds}),
      flush=True)
os._exit(0)
"""


def _hosts(sess, pages0=None):
    """Per host of a topology session's last drain: its stream, waves,
    placements, steals, page and dispatch accounting (pages since
    ``pages0`` when given)."""
    topo = sess.backend.topology
    out = []
    for h, lane in zip(topo.hosts, sess.topology_info.hosts):
        pages = h.pool.stats if pages0 is None \
            else h.pool.stats.delta(pages0[h.host_id])
        out.append({"host": h.host_id, "stream": h.stream.cuda_stream,
                    "alive": h.host_id not in topo.dead,
                    "waves": lane.waves, "invocations": lane.invocations,
                    "placed": lane.buckets_placed, "steals": lane.steals,
                    "page_stats": pages.summary(),
                    "dispatch": dataclasses.asdict(lane.dispatch)})
    return out


def _topology_drain(sess, jobs, what, device, preload=False):
    """One drain of ``jobs`` [(plan, data, true effect)] on a topology
    session, launch
    counts set to 0 just before and read just after; with ``preload``,
    host 0's pool first holds every page the jobs need (uploaded on the
    default stream, read on the hosts' streams).  Returns the run's
    record and the placements ``place_bucket`` gives on the pools as they
    stood before the drain."""
    from repro_torch.compile import PagePool
    from repro_torch.sharding.policy import place_bucket
    topo = sess.backend.topology
    reqs = [compile_request(p, d) for p, d, _ in jobs]
    if preload:
        for req in reqs:
            for key in plan_buckets([req]).buckets:
                topo.hosts[0].pool._page(
                    PagePool.page_key(req, key.n_pad, key.p_pad), req,
                    key.n_pad, key.p_pad)
    # what the backend's _route must give: each bucket in the plan's
    # order, its requests' page keys, loads kept incrementally
    alive = [h.host_id for h in topo.alive()]
    loads = [0] * len(alive)
    expected = {}
    for key, entries in plan_buckets(reqs).pending_by_bucket().items():
        pkeys = tuple(dict.fromkeys(
            PagePool.page_key(reqs[ri], key.n_pad, key.p_pad)
            for ri, _ in entries))
        placed = place_bucket(pkeys, [topo.hosts[h].pool for h in alive],
                              loads)
        loads[placed.host] += len(entries)
        expected[(key.n_pad, key.p_pad)] = (alive[placed.host], placed.score)
    pages0 = [h.pool.stats.snapshot() for h in topo.hosts]
    linear.reset_solve_status()
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    with _launch_shapes() as seen:
        rids = [sess.submit(p, d) for p, d, _ in jobs]
        results = sess.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(runtime.launch_counts)
    held = _launches_compared(seen, what, device)
    for rid, res, (_, _, truth) in zip(rids, results, jobs):
        _checked(res, sess.request(rid), device, truth, f"{what}/{rid}")
    t = sess.topology_info
    placements = {(k.n_pad, k.p_pad): (host, score)
                  for k, host, score in t.placements}
    return {"rids": rids, "results": results, "wall_s": wall,
            "launches": launches, "held": held,
            "preds": [sess.request(r).gathered_preds() for r in rids],
            "hosts": _hosts(sess, pages0), "placements": placements,
            "placements_expected": expected, "steals": t.steals,
            "waves": sess.last_run_info.waves,
            "wave_sizes": [sorted(r.report.wave_sizes) for r in results],
            "pages": [h.pool.stats.delta(p0)
                      for h, p0 in zip(topo.hosts, pages0)]}


def _inline_refs(jobs, device):
    sess = DMLSession(backend="inline", device=device)
    out = []
    for plan, data, _ in jobs:
        res = sess.estimate(plan, data)
        out.append((res, sess.request(res.request_id).gathered_preds()))
    return out


def _all_same_bits(run, refs):
    return [_same_bits(res, ref, preds, ref_preds)
            for res, preds, (ref, ref_preds)
            in zip(run["results"], run["preds"], refs)]


def _topology_checks(device, what="topology"):
    """The paper request through ``DMLSession(backend="topology")`` at 2
    and 4 hosts, cold and warm, bit for bit the inline drain; the
    stealing / cross-host fetch sub-run; the tall request on K3."""
    bonus = DMLData.from_dict(make_bonus_data())
    plan = _paper_default_plan()
    paper = [(plan, bonus, TRUE_EFFECT)]
    (ref, ref_preds), = _inline_refs(paper, device)
    req = compile_request(plan, bonus)
    sizes = [32] * 6 + [8]
    planned = _planned_launches(req, sizes)
    out = {"paper": {}}
    topo_launches = None
    for n_hosts in TOPOLOGY_HOSTS:
        sess = DMLSession(backend="topology",
                          pool=PoolConfig(n_hosts=n_hosts), device=device)
        streams = {h.stream.cuda_stream for h in sess.backend.topology.hosts}
        assert len(streams) == n_hosts and \
            torch.cuda.default_stream(device).cuda_stream not in streams
        row = {}
        for phase in ("cold", "warm"):
            run = _topology_drain(sess, paper,
                                  f"{what}/{n_hosts} hosts/{phase}", device)
            assert run["wave_sizes"] == [sorted(sizes)], run["wave_sizes"]
            assert _counts(run["launches"], planned["kernel_calls"]), \
                (run["launches"], planned)
            assert run["placements"] == run["placements_expected"], \
                (run["placements"], run["placements_expected"])
            bits = _all_same_bits(run, [(ref, ref_preds)])
            assert all(bits), f"{what}: {n_hosts} hosts, {phase}: not " \
                "bit for bit the inline drain"
            if phase == "warm":
                for h in run["pages"]:
                    assert h.bytes_h2d == 0 and h.bytes_d2d == 0, h
            if topo_launches is None:
                topo_launches = run["launches"]
            row[phase] = {k: run[k] for k in (
                "wall_s", "launches", "hosts", "waves", "wave_sizes",
                "steals", "held")}
            row[phase]["placements"] = [
                {"bucket": list(k), "host": h, "score": s}
                for k, (h, s) in run["placements"].items()]
            row[phase]["bitwise_equal_to_inline"] = bits[0]
        out["paper"][n_hosts] = row
    # the estimate() entry point on a plan that names the backend
    res = estimate(plan.replace(backend="topology"), bonus, device=device)
    assert _same_bits(res, ref, res.psi[0], ref.psi[0]), \
        f"{what}: estimate() is not bit for bit the inline drain"
    out["estimate_entry_point_bitwise"] = True

    # stealing and cross-host fetches: session_wave's three requests with
    # every page pre-loaded on host 0
    pliv = DMLData.from_dict(make_pliv_data(n_obs=5000, dim_x=20))
    jobs = [(_paper_default_plan(42), bonus, TRUE_EFFECT),
            (_paper_default_plan(43), bonus, TRUE_EFFECT),
            (DMLPlan.for_model("pliv", learner="ridge", n_folds=5, n_rep=10),
             pliv, pliv.theta0)]
    refs = _inline_refs(jobs, device)
    sess = DMLSession(backend="topology", pool=PoolConfig(n_hosts=2),
                      device=device)
    run = _topology_drain(sess, jobs, f"{what}/steal", device, preload=True)
    bits = _all_same_bits(run, refs)
    d2d = sum(p.bytes_d2d for p in run["pages"])
    assert run["steals"] >= 1 and d2d > 0 and all(bits), \
        (run["steals"], d2d, bits)
    assert all(h["waves"] > 0 for h in run["hosts"]), run["hosts"]
    out["steal"] = {k: run[k] for k in ("wall_s", "launches", "hosts",
                                         "steals", "waves", "held")}
    out["steal"].update(bytes_d2d=d2d, bitwise_equal_to_inline=bits,
                        placements=[{"bucket": list(k), "host": h,
                                     "score": s}
                                    for k, (h, s)
                                    in run["placements"].items()])

    # a tall request: its bucket takes the data@1 program on its host (K3)
    tall = DMLData.from_dict(make_plr_data(n_obs=TALL_N, dim_x=20,
                                           theta=0.5))
    tplan = DMLPlan.for_model("plr", learner="ridge",
                              learner_params={"reg": 1.0}, n_folds=5,
                              n_rep=2)
    sharded = DMLSession(backend="sharded", device=device)
    sres = sharded.estimate(tplan, tall)
    spreds = sharded.request(sres.request_id).gathered_preds()
    sess = DMLSession(backend="topology", pool=PoolConfig(n_hosts=2),
                      device=device)
    run = _topology_drain(sess, [(tplan, tall, tall.theta0)],
                          f"{what}/tall", device)
    (tres,), (tpreds,) = run["results"], run["preds"]
    k = run["launches"]
    assert k["batched_gram_blocked"] > 0 and k["batched_gram"] == 0, k
    assert [(d.axis, d.executed) for d in sess.last_run_info.axis_plans] \
        == [("data", "data")]
    diff = float(np.abs(tpreds - spreds).max())
    rel = (abs(tres.theta - sres.theta) / abs(sres.theta),
           abs(tres.se - sres.se) / sres.se)
    assert diff <= 5e-4 and max(rel) < 1e-4, (diff, rel)
    out["tall"] = {k: run[k] for k in ("wall_s", "launches", "hosts",
                                        "held")}
    out["tall"].update(max_abs_pred_diff_vs_sharded=diff,
                       rel_theta_se_vs_sharded=rel,
                       bitwise_equal_to_sharded=_same_bits(
                           tres, sres, tpreds, spreds))
    return out, topo_launches, k


def phase_topology(device):
    """The topology backend on the card: simulated hosts as CUDA streams
    (module docstring of serverless/topology.py).  Launch counts are set
    to 0 just before each drain and read just after."""
    out, launches, tall = _topology_checks(device)
    emit("topology", card=smi_line(), **out,
         tolerance="paper and steal: bit for bit the inline drain; tall: "
                   "predictions atol 5e-4, theta and se 1e-4 relative of "
                   "the sharded backend (estimate_tall's)")
    return launches, tall


def _chaos_drain(pool, job, ref, ref_preds, device):
    """One topology drain of ``job`` (plan, data, true effect) on a chaos
    pool, held bit for bit against the fault-free ``ref``."""
    plan, data, truth = job
    sess = DMLSession(backend="topology", pool=pool, device=device)
    res, wall = _timed_estimate(sess, plan, data)
    req = sess.request(res.request_id)
    _checked(res, req, device, truth, "topology_chaos")
    bits = _same_bits(res, ref, req.gathered_preds(), ref_preds)
    d = sess.last_run_info.dispatch
    assert bits, "topology_chaos: not bit for bit the fault-free drain"
    assert d.cancelled == d.hedges and \
        d.harvested == d.dispatched - d.cancelled, d
    assert req.report.bill.n_invocations == req.ledger.n_invocations
    return {"wall_s": wall, "failures": res.report.failures,
            "stragglers": res.report.stragglers,
            "hedge_armed": sess.backend._hedge_armed(
                sess.backend.begin_drain()),
            "dispatch": dataclasses.asdict(d), "hosts": _hosts(sess),
            "bitwise_equal_to_fault_free": bits}


def _topology_chaos_checks(device):
    """Host loss mid-flight on the paper request; the chaos pool on 2
    hosts; the same with every bucket hedged at once onto the other
    host's stream (no straggler hold), on the paper request and on the
    tall one, whose buckets run long enough to queue on their host's
    stream."""
    bonus = DMLData.from_dict(make_bonus_data())
    paper = (_paper_default_plan(), bonus, TRUE_EFFECT)
    (ref, ref_preds), = _inline_refs([paper], device)
    sess = DMLSession(backend="topology", pool=PoolConfig(n_hosts=2),
                      device=device)
    rid = sess.submit(*paper[:2])
    lost = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        sess.poll()
        q = sess._state.queues.get(0) if sess._state is not None else None
        if q is not None and q.in_flight > 0:
            lost = sess.backend.kill_host(sess._state, 0)
            break
    res = sess.wait(rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    req = sess.request(rid)
    _checked(res, req, device, TRUE_EFFECT, "topology_chaos/host loss")
    t = sess.topology_info
    bits = _same_bits(res, ref, req.gathered_preds(), ref_preds)
    assert lost > 0 and t.lost_buckets == lost and t.host_losses == 1, \
        (lost, t)
    assert req.ledger.complete and bits, "host loss: not bit for bit"
    out = {"host_loss": {"lost_buckets": t.lost_buckets,
                         "wall_s": wall, "hosts": _hosts(sess),
                         "bitwise_equal_to_fault_free": bits}}
    out["chaos"] = _chaos_drain(TOPO_CHAOS_POOL, paper, ref, ref_preds,
                                device)
    out["forced_hedges"] = _chaos_drain(TOPO_FORCED_HEDGE_POOL, paper, ref,
                                        ref_preds, device)
    tall_data = DMLData.from_dict(make_plr_data(n_obs=TALL_N, dim_x=20,
                                                theta=0.5))
    tall = (DMLPlan.for_model("plr", learner="ridge",
                              learner_params={"reg": 1.0}, n_folds=5,
                              n_rep=10), tall_data, tall_data.theta0)
    clean = DMLSession(backend="topology", pool=PoolConfig(n_hosts=2),
                       device=device)
    tref = clean.estimate(*tall[:2])
    out["forced_hedges_tall"] = _chaos_drain(
        TOPO_FORCED_HEDGE_POOL, tall, tref,
        clean.request(tref.request_id).gathered_preds(), device)
    # the question the hedging rule rests on: does a duplicate on another
    # host's stream ever book first with no straggler hold?
    out["hedge_leg_won_without_hold"] = bool(sum(
        out[k]["dispatch"]["hedge_wins"]
        for k in ("chaos", "forced_hedges", "forced_hedges_tall")))
    return out


def phase_topology_chaos(device):
    out = _topology_chaos_checks(device)
    emit("topology_chaos", card=smi_line(), **out,
         pools={"chaos": dataclasses.asdict(TOPO_CHAOS_POOL),
                "forced_hedges": dataclasses.asdict(TOPO_FORCED_HEDGE_POOL)},
         tall="make_plr_data(250000, 20), ridge, K 5, M 10",
         tolerance="bit for bit the fault-free drain (inline; the tall "
                   "request: the fault-free topology drain)")


def phase_durable(device):
    """A durable session on the card in a child process that leaves with
    ``os._exit`` after its first settled wave; ``DMLSession.resume`` here
    finishes it.  Zero DONE invocations re-executed (the bills against
    the crashed ledgers), and theta, se and predictions bit for bit an
    uninterrupted run's on the card."""
    from repro_torch.serverless import TaskLedger
    sdir = ROOT / "build" / "durable_session"
    if sdir.exists():
        for f in sdir.iterdir():
            f.unlink()
    build.load_library("megabatch")     # the store is warm for the child
    torch.cuda.empty_cache()            # the child shares the card
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", DURABLE_CHILD, str(sdir), str(ROOT / "src"),
         str(DURABLE_N_REP), str(device)], capture_output=True, text=True,
        timeout=600)
    assert child.returncode == 0, child.stderr[-4000:]
    child_s = time.perf_counter() - t0
    crashed = json.loads(child.stdout.strip().splitlines()[-1])
    done = {int(r): n for r, n in crashed["done"].items()}
    n_inv = {int(r): n for r, n in crashed["n_inv"].items()}
    on_disk = {r: TaskLedger.load(str(sdir / f"ledger_{r:05d}.msgpack"))
               for r in n_inv}
    assert {r: led.n_done for r, led in on_disk.items()} == done, done
    assert 0 < sum(done.values()) < sum(n_inv.values()), done
    # a fresh process on a warm store builds no library
    assert crashed["library_builds"] == 0, crashed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = DMLSession.resume(str(sdir), device=device)
    results = sess.run()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    bonus = DMLData.from_dict(make_bonus_data())
    # the child's plans, as it writes them
    jobs = [(DMLPlan.for_model("plr", learner="ridge",
                               learner_params={"reg": 1.0}, n_folds=5,
                               n_rep=DURABLE_N_REP, seed=seed), bonus,
             TRUE_EFFECT) for seed in (42, 43)]
    refs = _inline_refs(jobs, device)
    rows = []
    for res, (ref, ref_preds) in zip(results, refs):
        rid = res.request_id
        req = sess.request(rid)
        _checked(res, req, device, TRUE_EFFECT, f"durable/{rid}")
        billed = res.report.bill.n_invocations
        re_executed = billed - (n_inv[rid] - done[rid])
        done_rows = on_disk[rid].status == 2
        kept = bool(np.array_equal(req.ledger.preds[done_rows],
                                   on_disk[rid].preds[done_rows]))
        bits = _same_bits(res, ref, req.gathered_preds(), ref_preds)
        assert re_executed == 0 and kept and bits, (rid, re_executed, bits)
        rows.append({"request": rid, "n_invocations": n_inv[rid],
                     "done_at_crash": done[rid], "billed_on_resume": billed,
                     "done_re_executed": re_executed,
                     "theta": res.theta, "se": res.se,
                     "bitwise_equal_to_uninterrupted": bits})
    emit("durable", card=smi_line(), backend="wave",
         session_dir=str(sdir.relative_to(ROOT)),
         files=sorted(f.name for f in sdir.iterdir()), child_s=child_s,
         child_library_builds=crashed["library_builds"],
         resume_s=resume_s, requests=rows,
         tolerance="bit for bit an uninterrupted inline run on the card")


def phase_sanitize(device):
    """``estimate_wave``'s paper request, the topology sub-runs and
    topology_chaos again with ``REPRO_SANITIZE=1``: no ProtocolError.
    Then one bucket dispatch harvested twice on purpose, caught."""
    import os
    from repro_torch.compile import ProgramCache, dispatch_bucket
    from repro_torch.serverless.sanitize import ProtocolError
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        bonus = DMLData.from_dict(make_bonus_data())
        plan = _paper_default_plan()
        res = DMLSession(device=device).estimate(plan, bonus)
        _checked(res, None, device, TRUE_EFFECT, "sanitize/estimate_wave")
        topo, _, _ = _topology_checks(device, what="sanitize/topology")
        chaos = _topology_chaos_checks(device)
        req = compile_request(plan, bonus)
        mp = plan_buckets([req])
        key, entries = next(iter(mp.pending_by_bucket().items()))
        bd = dispatch_bucket(mp, ProgramCache(), key, entries, device=device)
        bd.harvest()
        try:
            bd.harvest()
        except ProtocolError as e:
            caught = str(e)
        else:
            raise AssertionError("a double harvest went through with "
                                 "REPRO_SANITIZE=1")
    finally:
        del os.environ["REPRO_SANITIZE"]
    emit("sanitize", card=smi_line(), estimate_wave_theta=res.theta,
         topology_paper_bitwise={n: r["cold"]["bitwise_equal_to_inline"]
                                 for n, r in topo["paper"].items()},
         topology_steals=topo["steal"]["steals"],
         topology_tall_k3=topo["tall"]["launches"]["batched_gram_blocked"],
         host_loss_lost_buckets=chaos["host_loss"]["lost_buckets"],
         chaos_hedges={k: chaos[k]["dispatch"]["hedges"] for k in (
             "chaos", "forced_hedges", "forced_hedges_tall")},
         protocol_errors=0, planted_double_harvest_caught=caught)


# ---------------------------------------------------------------------------
# the persistent library store: fresh processes on one REPRO_PROGRAM_CACHE_DIR
# ---------------------------------------------------------------------------
# a child of the persist phase: the clock starts before anything is
# imported; argv[1] is the tree whose chip_smoke.py (and src/) it runs
PERSIST_CHILD = """
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.persist_child(t0)
"""


def _persist_kernel_checks(device) -> dict:
    """K1, K2, K5 and K6 launched once each at their main shapes, each held
    against its plain version at the kernels phase's tolerance; the
    largest differences."""
    gen = torch.Generator(device=device).manual_seed(20210104)
    b, n, p = MAIN_SHAPE
    xs = torch.randn(MAIN_SHAPE, generator=gen, device=device)
    y = torch.randn((b, n), generator=gen, device=device)
    w = (torch.rand((b, n), generator=gen, device=device) < 0.8).float()
    beta = torch.randn((b, p), generator=gen, device=device)
    valid = (torch.rand((b, n), generator=gen, device=device) < 0.9).float()
    g, bv = ops.batched_gram(xs, w, y)
    g0, b0 = megabatch.batched_gram_plain(xs, w, y)
    assert torch.allclose(g, g0, rtol=1e-4,
                          atol=1e-4 * float(g0.abs().max())) \
        and torch.allclose(bv, b0, rtol=1e-4,
                           atol=1e-4 * float(b0.abs().max())), \
        ("batched_gram disagrees", _errs(g, g0))
    out = ops.batched_predict(xs, beta, valid)
    out0 = megabatch.batched_predict_plain(xs, beta, valid)
    assert torch.allclose(out, out0, rtol=1e-5,
                          atol=_predict_atol(MAIN_SHAPE, out0)), \
        ("batched_predict disagrees", _errs(out, out0))
    bh, sq, skv, d, dtype, causal, window = MAIN_ATTN_SHAPE
    q, k, v = (torch.randn((bh, s_, d), generator=gen, device=device)
               .to(TYPES[dtype]) for s_ in (sq, skv, skv))
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    o0 = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                               window=window)
    attn_err = float((o.float() - o0.float()).abs().max())
    assert attn_err < ATTN_TOL[dtype] and _bf16_ulps(o, o0) <= BF16_ULPS, \
        ("flash_attention disagrees", attn_err)
    x, la, bm, cm = _ssd_inputs(MAIN_SSD_SHAPE, "slow", device, gen)
    chunk, heads = MAIN_SSD_SHAPE[4:]
    ys, st = ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads)
    ys0, st0 = ssd_scan.ssd_scan_plain(x, la, bm, cm, heads=heads)
    ssd_err = max(float((ys - ys0).abs().max()) / float(ys0.abs().max()),
                  float((st - st0).abs().max()) / float(st0.abs().max()))
    assert ssd_err <= SSD_SPLIT_TOL, ("ssd_scan disagrees", ssd_err)
    return {"batched_gram": _errs(g, g0)[0],
            "batched_predict": _errs(out, out0)[0],
            "flash_attention": attn_err, "ssd_scan_rel": ssd_err}


def persist_child(t0: float) -> None:
    """The body of a persist-phase child: the paper request first (its
    wall from the process's start: the first result), then K1, K2, K5, K6
    against their plain versions; one JSON line with the store's
    counters and the libraries this process built."""
    device = runtime.default_device()
    imported_s = time.perf_counter() - t0
    sess = DMLSession(device=device)
    res = sess.estimate(_paper_default_plan(),
                        DMLData.from_dict(make_bonus_data()))
    torch.cuda.synchronize()
    first_request_s = time.perf_counter() - t0
    stats = sess.backend.compiler.stats
    kernels = _persist_kernel_checks(device)
    print(json.dumps({
        "imported_s": imported_s, "first_request_s": first_request_s,
        "theta": res.theta, "se": res.se,
        "disk_hits": stats.disk_hits, "disk_misses": stats.disk_misses,
        "store": persist.library_store().summary(),
        "built": sorted(n for n, (s_, _) in build.build_log.items()
                        if s_ > 0),
        "max_abs_err": kernels}), flush=True)


def _run_persist_child(tree: Path, cache: Path) -> dict:
    torch.cuda.empty_cache()            # the child shares the card
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", PERSIST_CHILD, str(tree)],
        env=dict(os.environ, **{persist.ENV_CACHE_DIR: str(cache)}),
        capture_output=True, text=True, timeout=600)
    assert child.returncode == 0, child.stderr[-4000:]
    out = json.loads(child.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def phase_persist(device):
    """Four fresh processes on one fresh ``REPRO_PROGRAM_CACHE_DIR``:
    (i) cold: builds megabatch and lm (nvcc seconds of each); (ii) warm:
    builds nothing; (iii) after one library was truncated: one eviction,
    that library rebuilt alone; (iv) a copy of the package with one byte
    more in a comment of megabatch.cu: that library rebuilt alone.  Each
    serves the paper request (the same bits in all four) and holds K1,
    K2, K5 and K6 against their plain versions."""
    work = ROOT / "build" / "persist_phase"
    shutil.rmtree(work, ignore_errors=True)
    cache = work / "cache"
    runs = {"cold": _run_persist_child(ROOT, cache)}
    lib_dir = cache / "repro_torch"
    assert runs["cold"]["built"] == ["lm", "megabatch"], runs["cold"]
    assert runs["cold"]["disk_misses"] >= 1, runs["cold"]
    runs["warm"] = _run_persist_child(ROOT, cache)
    assert runs["warm"]["built"] == [] and \
        runs["warm"]["store"]["builds"] == 0, runs["warm"]
    assert runs["warm"]["disk_hits"] >= 1 and \
        runs["warm"]["disk_misses"] == 0, runs["warm"]
    (mb,) = lib_dir.glob("libmegabatch-*.so")
    mb.write_bytes(mb.read_bytes()[:mb.stat().st_size // 2])
    runs["truncated"] = _run_persist_child(ROOT, cache)
    assert runs["truncated"]["store"]["evictions"] == 1 and \
        runs["truncated"]["built"] == ["megabatch"], runs["truncated"]
    tree = work / "tree"
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree)
    cu = tree / "src" / "repro_torch" / "kernels" / "csrc" / "megabatch.cu"
    text = cu.read_text()
    cu.write_text(text.replace("//", "// ", 1))      # one byte, a comment
    assert len(cu.read_bytes()) == len(text.encode()) + 1
    runs["edited_comment"] = _run_persist_child(tree, cache)
    assert runs["edited_comment"]["built"] == ["megabatch"] and \
        runs["edited_comment"]["store"]["builds"] == 1, \
        runs["edited_comment"]
    assert len({(r["theta"], r["se"]) for r in runs.values()}) == 1, runs
    emit("persist", card=smi_line(), cache_dir="build/persist_phase/cache",
         libraries=sorted(f.name for f in lib_dir.iterdir()),
         nvcc_s=runs["cold"]["store"]["nvcc_s"],
         runs={k: {f: r[f] for f in (
             "built", "store", "disk_hits", "disk_misses", "imported_s",
             "first_request_s", "process_s", "max_abs_err")}
             for k, r in runs.items()},
         theta=runs["cold"]["theta"], se=runs["cold"]["se"],
         tolerance="every child's paper request the same bits; K1, K2, K5, "
                   "K6 at the kernels phase's tolerances")


# ---------------------------------------------------------------------------
# the example twins at their own sizes
# ---------------------------------------------------------------------------
def _example(name: str):
    """The module of ``examples/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples(device, quickstart=None):
    """``examples/quickstart_torch.py`` (M 20), ``serverless_scaling_torch.py``
    (the Fig. 3 sweep: 2 scalings x 4 memories x 3 repeats, simulated
    billing), ``session_batching_torch.py``, ``serve_lm_torch.py`` (the
    reduced deepseek-v2-lite, its default: 10 requests in 4 slots of 48
    tokens, 12 generated, then one batch through ``generate``; K5 once a
    layer and prefill, run twice with the same tokens; then the reduced
    xlstm-350m, whisper-base and llama-3.2-vision-90b the same way, the
    last two through ``generate`` alone) and ``train_lm_torch.py`` at
    ``--full-100m`` for TRAIN_LM_EXAMPLE_STEPS steps on the card.  The
    quickstart's repetitions are the first 20 of ``estimate_quickstart``'s
    request (the same plan at M 100, seed 42, n_boot 500): theta and se of
    each repetition bit for bit."""
    (quickstart_torch, serverless_scaling_torch, session_batching_torch,
     serve_lm_torch) = (_example(name) for name in (
         "quickstart_torch", "serverless_scaling_torch",
         "session_batching_torch", "serve_lm_torch"))
    walls = {}
    t0 = time.perf_counter()
    _, qs = quickstart_torch.run(device=device)
    torch.cuda.synchronize()
    walls["quickstart"] = time.perf_counter() - t0
    _checked(qs, None, device, TRUE_EFFECT, "examples/quickstart")
    if quickstart is None:
        quickstart = estimate(_quickstart_plan(n_boot=N_BOOT),
                              DMLData.from_dict(make_bonus_data()))
    m = len(qs.thetas)
    assert np.array_equal(qs.thetas, quickstart.thetas[:m]) and \
        np.array_equal(qs.ses, quickstart.ses[:m]), \
        ("the quickstart twin's repetitions differ from estimate_quickstart's",
         qs.thetas, quickstart.thetas[:m])
    t0 = time.perf_counter()
    rows, sweep = serverless_scaling_torch.run_sweep(device=device)
    torch.cuda.synchronize()
    walls["serverless_scaling"] = time.perf_counter() - t0
    t_ps = [t for s_, _, t, _ in rows if s_ == "n_rep"]
    assert all(b < a for a, b in zip(t_ps, t_ps[1:])), rows
    for res in sweep:
        _checked(res, None, device, TRUE_EFFECT, "examples/serverless_scaling")
    t0 = time.perf_counter()
    reqs, _, results, info, solo = session_batching_torch.run(device=device)
    torch.cuda.synchronize()
    walls["session_batching"] = time.perf_counter() - t0
    assert info.shared_waves >= 1, info
    for (_, data), res in zip(reqs, results):
        _checked(res, None, device, data.theta0, "examples/session_batching")

    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, prompts, served, gen_res = serve_lm_torch.run(device=device)
    torch.cuda.synchronize()
    walls["serve_lm"] = time.perf_counter() - t0
    serve_launches = dict(runtime.launch_counts)
    prefills = -(-len(prompts) // 4) + 1
    assert serve_launches["flash_attention"] == prefills * cfg.n_layers, \
        serve_launches
    assert all(r.shape == (12,) and 0 <= r.min() and r.max() < cfg.vocab_size
               for r in served) and gen_res.tokens.shape == (4, 12)
    _, _, served2, gen2 = serve_lm_torch.run(device=device)
    assert all(np.array_equal(a, b) for a, b in zip(served, served2)) and \
        np.array_equal(gen_res.tokens, gen2.tokens), "serve_lm: not repeatable"
    # the last three families, reduced, through the same twin: xlstm's
    # queue and batch (no block: no kernel), whisper's and the VLM's batch
    # through generate with frames or image patches from a seed
    families = {}
    for arch in ("xlstm-350m", "whisper-base", "llama-3.2-vision-90b"):
        runtime.reset_launch_counts()
        cfg_a, prompts_a, served_a, gen_a = serve_lm_torch.run(arch=arch,
                                                               device=device)
        torch.cuda.synchronize()
        launches_a = dict(runtime.launch_counts)
        prefills_a = (-(-len(prompts_a) // 4) if served_a else 0) + 1
        want = {k: prefills_a * n
                for k, n in _prefill_launches(cfg_a).items()}
        assert {k: launches_a[k] for k in want} == want, (arch, launches_a)
        assert gen_a.tokens.shape == (4, 12) and 0 <= gen_a.tokens.min() \
            and gen_a.tokens.max() < cfg_a.vocab_size, arch
        _, _, served_b, gen_b = serve_lm_torch.run(arch=arch, device=device)
        assert np.array_equal(gen_a.tokens, gen_b.tokens) and all(
            np.array_equal(a, b) for a, b in zip(served_a, served_b)), \
            f"serve_lm {arch}: not repeatable"
        families[arch] = {"requests_served": len(served_a),
                          "launches": launches_a,
                          "batch_first_tokens": gen_a.tokens[:, :4].tolist(),
                          "second_run_same_tokens": True}

    # the training twin at the reference example's ~100M config (12 layers
    # of 768, 12 heads of 64, vocab 32k; 8 x 512 tokens, remat "none"):
    # a few steps, K5's forward and backward once a layer and step
    train_lm_torch = _example("train_lm_torch")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        runtime.reset_launch_counts()
        t0 = time.perf_counter()
        cfg_t, _, _, hist_t, _ = train_lm_torch.run(
            steps=TRAIN_LM_EXAMPLE_STEPS, full_100m=True, ckpt_dir=tmp,
            device=device, log_every=1)
        torch.cuda.synchronize()
        walls["train_lm"] = time.perf_counter() - t0
        train_launches = dict(runtime.launch_counts)
    train_losses = [h["loss"] for h in hist_t]
    assert len(train_losses) == TRAIN_LM_EXAMPLE_STEPS and \
        all(np.isfinite(train_losses)) and \
        train_losses[-1] < train_losses[0], train_losses
    for name in ("flash_attention", "flash_attention_bwd"):
        assert train_launches[name] == \
            TRAIN_LM_EXAMPLE_STEPS * cfg_t.n_layers, train_launches

    def summary(res):
        s_ = res.report.summary()
        return {"theta": res.theta, "se": res.se,
                "invocations": s_["invocations"], "waves": s_["waves"],
                "billed_gb_s": s_["billed_gb_s"]}

    emit("examples", card=smi_line(), wall_s=walls,
         quickstart={**summary(qs), "n_rep": m, "boot_ci": qs.boot_ci,
                     "repetitions_equal_estimate_quickstart": True},
         serverless_scaling={"rows": rows,
                             "runs": [summary(r) for r in sweep]},
         session_batching={"waves": info.waves,
                           "shared_waves": info.shared_waves,
                           "requests": [summary(r) for r in results],
                           "solo_waves": sum(r.report.waves for r in solo)},
         serve_lm={"arch": cfg.name, "reduced": True,
                   "requests": len(prompts), "launches": serve_launches,
                   "first_tokens": [r[:4].tolist() for r in served[:3]],
                   "batch_prefill_s": gen_res.prefill_s,
                   "batch_decode_tokens_per_s": gen_res.tokens_per_s,
                   "second_run_same_tokens": True, "families": families},
         train_lm={"full_100m": True, "steps": TRAIN_LM_EXAMPLE_STEPS,
                   "losses": train_losses, "launches": train_launches,
                   "step_wall_s": [h["wall_s"] for h in hist_t]},
         tolerance="theta within 4 se of the planted effect; the "
                   "quickstart's repetitions bit for bit "
                   "estimate_quickstart's first 20; serve_lm's tokens "
                   "equal in two runs; train_lm's losses finite and "
                   "falling")


# ---------------------------------------------------------------------------
# LM training: train_dense (h2o-danube-3-4b at full width, depth cut; the
# reduced model card against CPU, a resume bit for bit; the reduced
# deepseek-v2-lite card against CPU) and train_whisper (whisper-base
# whole).  K5's forward and backward run on every step; the optimizer,
# checkpoints and trainer are ``repro_torch.train``'s.
# ---------------------------------------------------------------------------
# h2o-danube-3-4b's depth kept at full width: 24 layers at 16 bytes a
# parameter (bf16 weights and gradients, float32 master, m and v) are 63 GB
# before activations, past one 80 GB card; 8 layers are 1.49 B parameters
TRAIN_DENSE_LAYERS = 8
# (batch, tokens a sequence, steps, warmup) of both full runs
TRAIN_BATCH, TRAIN_DENSE_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 8, 4096, 12, 3
# whisper-base: 8 clips of 1500 frames, 448 target tokens (its decoder's
# context)
TRAIN_WHISPER_FRAMES, TRAIN_WHISPER_TOKENS = 1500, 448
TRAIN_LR = 1e-3
# steps of examples/train_lm_torch.py --full-100m in the examples phase
TRAIN_LM_EXAMPLE_STEPS = 6
# the reduced models card against CPU, float32: the loss of one step
# within 1e-5 relative; every gradient within GRAD_TIER of its largest
# magnitude (K5's split-TF32 backward against autograd through the plain
# attention, cuBLAS's float32 products against the CPU's; measured 3.2e-6
# and 4.8e-6)
TRAIN_LOSS_TIER = 1e-5
TRAIN_GRAD_TIER = 1e-4
# and the loss curves (Adam turns ulps of near-zero gradients into steps
# of lr, so curves part as they go): measured 8.8e-7 relative over 20 steps
# of the reduced h2o-danube-3-4b and 3.5e-7 over 3 of deepseek-v2-lite
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), held at 1e-5
TRAIN_CURVE_TIER = 1e-5


def _loss_and_grads(bundle, params, batch, device):
    """(loss, metrics, gradients in flattening order) of ``bundle.loss_fn``
    at ``params`` on ``device``, autograd through the device's route."""
    from repro_torch.train.trainer import grads_of, to_device
    loss, metrics, grads = grads_of(bundle.loss_fn, params,
                                     to_device(batch, device))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        tree_leaves(grads)


def _grad_gap(got, want):
    """Largest |got - want| over the gradient leaves, each as a fraction
    of its largest |want| (leaves that are 0 on both sides skipped)."""
    out = 0.0
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        scale = float(w.abs().max())
        if scale == 0.0:
            assert float(g.abs().max()) == 0.0
            continue
        out = max(out, float((g - w).abs().max()) / scale)
    return out


def _train_run(bundle, params, batches, device, *, steps, warmup, lr,
               log_every=1):
    """``Trainer.run`` over pre-made batches (host data made before the
    clock starts): (params, opt state, history, K5 launches, peak bytes,
    the step times in ms from the history's wall clock)."""
    from repro_torch.train import (
        OptConfig, Trainer, TrainerConfig, init_opt_state,
    )
    ocfg = OptConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    trainer = Trainer(bundle, ocfg, TrainerConfig(steps=steps,
                                                  log_every=log_every))
    opt = init_opt_state(params, ocfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    params, opt, hist = trainer.run(params, opt, iter(batches))
    launches = {k: runtime.launch_counts[k]
                for k in ("flash_attention", "flash_attention_bwd",
                          "ssd_scan")}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    walls = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + walls, walls)]
    return params, opt, hist, launches, peak, step_ms


def _full_run_record(name, cfg, hist, launches, peak, step_ms, tokens,
                     n_params, n_layers_attn):
    losses = [h["loss"] for h in hist]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    assert np.mean(losses[-4:]) < losses[0], (name, losses)
    steady = statistics.median(step_ms[2:])
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    # remat "full": each layer's forward runs twice a step (the forward,
    # the recompute in the backward), its backward once
    assert per_step["flash_attention"] == 2 * n_layers_attn, per_step
    assert per_step["flash_attention_bwd"] == n_layers_attn, per_step
    return {"arch": cfg.name, "params": n_params,
            "step_ms_median_steps_3_to_12": steady, "step_ms": step_ms,
            "tokens_per_s": tokens / (steady / 1e3),
            "max_memory_allocated_bytes": peak,
            "k5_launches_per_step": per_step, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist],
            "card": smi_line()}


def _reduced_card_vs_cpu(arch, device, *, seq, steps, lr):
    """A reduced config in float32, the same parameters on the card and on
    the CPU: one step's loss and gradients, then ``steps`` steps' losses."""
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    cfg = get_arch(arch, reduced=True)
    bundle = build_model(cfg, remat="full")
    p_cpu = cast_floating(init_tree(
        bundle.decls, torch.Generator().manual_seed(LM_SEED), "cpu"),
        torch.float32)
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, seq, 4, seed=0))
    batch = data.batch(0)
    runtime.reset_launch_counts()
    loss_card, m_card, g_card = _loss_and_grads(
        bundle, _card_copy(p_cpu, device), batch, device)
    launches = dict(runtime.launch_counts)
    loss_cpu, m_cpu, g_cpu = _loss_and_grads(bundle, p_cpu, batch, "cpu")
    assert abs(loss_card - loss_cpu) <= TRAIN_LOSS_TIER * abs(loss_cpu), \
        (arch, loss_card, loss_cpu)
    gap = _grad_gap(g_card, g_cpu)
    assert gap <= TRAIN_GRAD_TIER, (arch, gap)
    curves = {}
    batches = [data.batch(i) for i in range(steps)]
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        _, _, hist, _, _, _ = _train_run(bundle, _card_copy(p_cpu, dev),
                                         batches, dev, steps=steps,
                                         warmup=2, lr=lr)
        curves[where] = [h["loss"] for h in hist]
    curve_gap = max(abs(a - b) / b for a, b in zip(curves["card"],
                                                   curves["cpu"]))
    assert curve_gap <= TRAIN_CURVE_TIER, (arch, curve_gap, curves)
    return {"arch": arch, "seq": seq, "loss_card": loss_card,
            "loss_cpu": loss_cpu, "metrics_card": m_card,
            "metrics_cpu": m_cpu, "grad_gap_of_max": gap,
            "launches_one_step": launches, "curve_steps": steps,
            "curve_rel_gap": curve_gap, "losses_card": curves["card"],
            "losses_cpu": curves["cpu"]}


def _resume_bits(device):
    """The reduced h2o-danube-3-4b (bf16) on the card: 10 steps with a
    checkpoint every 5, then a fresh Trainer resumed from step 5's
    checkpoint alone runs to 10: parameters and optimizer state equal bit
    for bit.  Before it, one step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` lists the
    operators PyTorch flags as non-deterministic on the card."""
    import tempfile
    import warnings
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.train import OptConfig, Trainer, TrainerConfig
    cfg = get_arch("h2o-danube-3-4b", reduced=True)
    bundle = build_model(cfg, remat="full")
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, 256, 4, seed=0))
    ocfg = OptConfig(lr=5e-3, warmup_steps=2, total_steps=10)
    flagged = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            tr = Trainer(bundle, ocfg, TrainerConfig(steps=1, log_every=1))
            params, opt = tr.init(LM_SEED, device)
            tr.run(params, opt, data.iterate())
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    for w in caught:
        text = str(w.message).splitlines()[0][:200]
        if "deterministic" in text and text not in flagged:
            flagged.append(text)
    with tempfile.TemporaryDirectory() as tmp:
        full, part = Path(tmp) / "full", Path(tmp) / "part"
        tr = Trainer(bundle, ocfg, TrainerConfig(steps=10, log_every=1,
                                                 ckpt_every=5,
                                                 ckpt_dir=str(full)))
        params, opt = tr.init(LM_SEED, device)
        runtime.reset_launch_counts()
        p10, o10, hist = tr.run(params, opt, data.iterate())
        launches = dict(runtime.launch_counts)
        part.mkdir()
        shutil.copy(full / "ckpt_00000005.msgpack", part)
        tr2 = Trainer(bundle, ocfg, TrainerConfig(steps=10, log_every=1,
                                                  ckpt_every=5,
                                                  ckpt_dir=str(part)))
        p5, o5, start = tr2.resume(device)
        assert start == 5, start
        p10b, o10b, hist2 = tr2.run(p5, o5, data.iterate(5), start_step=5)
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves({"p": p10, "o": o10}),
                               tree_leaves({"p": p10b, "o": o10b})))
    assert same, "resume: parameters or optimizer state differ"
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[5:]]
    assert launches["flash_attention_bwd"] == 10 * cfg.n_layers, launches
    return {"arch": cfg.name, "dtype": "bf16", "steps": 10,
            "resumed_from": start, "params_and_opt_state_bitwise": same,
            "losses": [h["loss"] for h in hist], "launches": launches,
            "flagged_nondeterministic": flagged}


def phase_train_dense(device):
    """h2o-danube-3-4b at its published widths (d 3840, 32 heads of 120, 8
    KV heads, d_ff 10240, vocab 32000, window 4096) cut to
    TRAIN_DENSE_LAYERS layers, bf16 parameters from a seed on the card,
    float32 master and moments, remat "full", 12 steps of 8 x 4096 tokens
    from SyntheticLM(seed=0) (warmup 3) through ``Trainer.run``; then the
    reduced model card against CPU in float32 (a step's loss and
    gradients, a 20-step loss curve), a resume on the card bit for bit,
    and the reduced deepseek-v2-lite (MoE, MLA: K5 at Dqk 48, Dv 32) card
    against CPU (3 steps)."""
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    base = get_arch("h2o-danube-3-4b")
    cfg = dataclasses.replace(base, n_layers=TRAIN_DENSE_LAYERS)
    bundle = build_model(cfg, remat="full")
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, TRAIN_DENSE_SEQ,
                                    TRAIN_BATCH, seed=0))
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = init_tree(bundle.decls, gen, device)
    with _launch_shapes() as seen:
        _, _, hist, launches, peak, step_ms = _train_run(
            bundle, params, batches, device, steps=TRAIN_STEPS,
            warmup=TRAIN_WARMUP, lr=TRAIN_LR)
        del params
        torch.cuda.empty_cache()
        reduced = _reduced_card_vs_cpu("h2o-danube-3-4b", device, seq=256,
                                       steps=20, lr=5e-3)
        resume = _resume_bits(device)
        mla = _reduced_card_vs_cpu("deepseek-v2-lite-16b", device, seq=128,
                                   steps=3, lr=5e-3)
    _launches_compared(seen, "train_dense")
    full = _full_run_record(
        "train_dense", cfg, hist, launches, peak, step_ms,
        TRAIN_BATCH * TRAIN_DENSE_SEQ, param_count(bundle.decls),
        cfg.n_layers)
    full["reduced"] = {"n_layers": [base.n_layers, TRAIN_DENSE_LAYERS],
                       "why": "24 layers need 63 GB of parameters, "
                              "gradients and optimizer state before "
                              "activations: past one 80 GB card"}
    emit("train_dense", full=full, reduced_card_vs_cpu=reduced,
         resume=resume, deepseek_reduced_card_vs_cpu=mla,
         launch_shapes={k: sorted(seen[k], key=str) for k in (
             "flash_attention", "flash_attention_lse",
             "flash_attention_bwd")},
         tolerance=f"full: finite losses, the mean of the last 4 below "
                   f"step 1's; reduced, float32: loss within "
                   f"{TRAIN_LOSS_TIER} relative, gradients within "
                   f"{TRAIN_GRAD_TIER} of each leaf's max|grad|, the loss "
                   f"curves within {TRAIN_CURVE_TIER} relative; resume bit "
                   f"for bit")
    torch.cuda.empty_cache()
    return launches


def phase_train_whisper(device):
    """whisper-base whole (6 + 6 layers, 74 M parameters), bf16 from a
    seed, remat "full": 12 steps of 8 clips of 1500 frames (drawn from a
    seed per step) against 448 target tokens from SyntheticLM(seed=0)
    through ``Trainer.run``.  K5 at the encoder's (64, 1500, 1500, 64) not
    masked, the decoder's (64, 448, 448, 64) causal and the cross (64,
    448, 1500, 64), forward and backward."""
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    cfg = get_arch("whisper-base")
    bundle = build_model(cfg, remat="full")
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, TRAIN_WHISPER_TOKENS,
                                    TRAIN_BATCH, seed=0))
    batches = []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        batch["frames"] = np.random.default_rng(LM_SEED + i).standard_normal(
            (TRAIN_BATCH, TRAIN_WHISPER_FRAMES, cfg.d_frontend),
            dtype=np.float32)
        batches.append(batch)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    params = init_tree(bundle.decls, gen, device)
    with _launch_shapes() as seen:
        _, _, hist, launches, peak, step_ms = _train_run(
            bundle, params, batches, device, steps=TRAIN_STEPS,
            warmup=TRAIN_WARMUP, lr=TRAIN_LR)
    _launches_compared(seen, "train_whisper")
    del params
    torch.cuda.empty_cache()
    full = _full_run_record(
        "train_whisper", cfg, hist, launches, peak, step_ms,
        TRAIN_BATCH * TRAIN_WHISPER_TOKENS, param_count(bundle.decls),
        cfg.n_encoder_layers + 2 * cfg.n_layers)
    emit("train_whisper", full=full,
         launch_shapes={k: sorted(seen[k], key=str) for k in (
             "flash_attention", "flash_attention_lse",
             "flash_attention_bwd")},
         frames=[TRAIN_BATCH, TRAIN_WHISPER_FRAMES, cfg.d_frontend],
         tolerance="finite losses, the mean of the last 4 below step 1's")
    return launches


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
            list(pool.map(lambda name: build.load_library(
                name, verbose=args.verbose_build), LIBRARIES))
        libraries = {}
        for name in LIBRARIES:
            nvcc_s, path = build.build_log[name]
            libraries[name] = {
                "library": str(Path(path).relative_to(ROOT))
                if Path(path).is_relative_to(ROOT) else path,
                "nvcc_s": nvcc_s}
        emit("build", libraries=libraries,
             store=persist.library_store().summary(),
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
    mla_launches, dense_launches = None, None
    if "serve_deepseek" in phases:
        mla_launches = phase_serve_deepseek(device)["flash_attention"]
    if "serve_dense" in phases:
        dense_launches = phase_serve_dense(device)
    family_launches = {}
    for name, phase in (("serve_xlstm", phase_serve_xlstm),
                        ("serve_whisper", phase_serve_whisper),
                        ("serve_vlm", phase_serve_vlm)):
        if name in phases:
            family_launches[name] = phase(device)
    f32_launches = None
    if "same_as_cpu_lm" in phases:
        f32_launches = phase_same_as_cpu_lm(device)
    train_launches = None
    if "train_dense" in phases:
        train_launches = phase_train_dense(device)
        if launches is not None:
            launches["flash_attention_bwd"] = \
                train_launches["flash_attention_bwd"]
    whisper_train_launches = None
    if "train_whisper" in phases:
        whisper_train_launches = phase_train_whisper(device)
    topo_launches = None
    if "topology" in phases:
        topo_launches = phase_topology(device)
    if "topology_chaos" in phases:
        phase_topology_chaos(device)
    if "durable" in phases:
        phase_durable(device)
    if "sanitize" in phases:
        phase_sanitize(device)
    if "persist" in phases:
        phase_persist(device)
    if "examples" in phases:
        phase_examples(device, quickstart and quickstart["result"])

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
    # (same_as_cpu_lm (b)'s launches), K5 at the deepseek prefill's Dqk 192,
    # Dv 128 in both types (serve_deepseek's launches, and same_as_cpu_lm
    # (f)'s float32 ones at B 1, S 512) and its launches on serve_dense,
    # K5's rows of the last three families (serve_whisper's, serve_vlm's
    # shapes in both types) and its launches there, K6's FMA-rate bound
    # and its row at xlstm-350m's shape with its launches on serve_xlstm
    extra = {"batched_gram": {k: rows["batched_gram"][k] for k in (
                 "cuda_launches_per_call", "scratch_bytes")},
             "batched_predict": {},
             "crossfit_gram": {"lane": {**rows["crossfit_gram"]["lane"],
                                        "launches": raw_lanes},
                               "p257": {**rows["crossfit_gram"]["p257"],
                                        "launches_estimate_quickstart":
                                            quickstart["crossfit_gram"]}},
             "flash_attention": {
                 "f32": {**rows["flash_attention"]["f32"],
                         "launches": f32_launches["full_width_one_group_f32"]},
                 "mla": rows["flash_attention"]["mla"],
                 "launches_serve_deepseek": mla_launches,
                 "launches_same_as_cpu_lm_mla_f32":
                     f32_launches["mla_full_width_two_layers_f32"],
                 "launches_serve_dense": dense_launches,
                 "families": rows["flash_attention"]["families"],
                 "launches_serve_whisper":
                     family_launches["serve_whisper"]["flash_attention"],
                 "launches_serve_vlm":
                     family_launches["serve_vlm"]["flash_attention"],
                 "lse_write": rows["flash_attention"]["lse_write"],
                 "launches_train_dense": train_launches["flash_attention"],
                 "launches_train_whisper":
                     whisper_train_launches["flash_attention"]},
             # K5's backward: its launches are train_dense's full run's
             # (12 steps of h2o-danube-3-4b, 8 layers); every row of the
             # kernels phase, and its launches in train_whisper
             "flash_attention_bwd": {
                 k: v for k, v in rows["flash_attention_bwd"].items()
                 if k not in keys} | {
                 "launches_train_whisper":
                     whisper_train_launches["flash_attention_bwd"]},
             "batched_gram_blocked": {
                 "launches_topology":
                     topo_launches[1]["batched_gram_blocked"]},
             "ssd_scan": {**{k: rows["ssd_scan"][k] for k in (
                 "bound_ms_at_f32_fma", "cuda_launches_per_call",
                 "scratch_bytes")},
                 "xlstm": {**rows["ssd_scan"]["xlstm"],
                           "launches": family_launches["serve_xlstm"][
                               "ssd_scan"],
                           "launches_same_as_cpu_lm_f32":
                               f32_launches["xlstm_ssd_scan"]}}}
    # K1's and K2's launches on the per-block pool (estimate_paper), on
    # the wave path (estimate_wave, cold) on both pools, and their rows at
    # the fused paper shape (1024 lanes: the 32 blocks of one launch); on
    # the quickstart (kernel_ridge, cold) and their rows at P 257 and 129;
    # on the topology path (the paper at 2 hosts, cold; K3: the tall run)
    for name in ("batched_gram", "batched_predict"):
        extra[name].update(
            launches_per_block=per_block[name],
            launches_estimate_wave=wave_launches[0][name],
            launches_estimate_wave_per_block=wave_launches[1][name],
            fused={"shape": list(FUSED_PAPER_SHAPE),
                   **{k: rows["fused"][name][k] for k in keys}},
            launches_estimate_quickstart=quickstart[name],
            launches_topology=topo_launches[0][name],
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

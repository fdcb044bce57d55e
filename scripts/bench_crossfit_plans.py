#!/usr/bin/env python3
"""Time every launch plan of the shared-X Gram kernel (K4) on the card.

    python3 scripts/bench_crossfit_plans.py [--out FILE]

For each (T, N, P) of ``chip_smoke.py``'s ``XFIT_SHAPES`` it launches
``crossfit_gram_kernel`` with every (SUB, TT, slots, m) plan that
``kernels/crossfit_gram.py`` can build, checks that every plan gives the
same bits as the plan ``launch_plan`` picks (the per-element order does not
depend on the plan), and prints one JSON line a shape: each plan's median
time (20 launches, CUDA events, L2 flushed before each), the model's
estimate, and which plan ``launch_plan`` picks.  It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch                                               # noqa: E402

from repro_torch.kernels import build, crossfit_gram       # noqa: E402

SHAPES = ((1000, 5099, 18), (40, 60000, 201), (5, 1003, 7), (1, 5099, 18),
          (32, 65536, 33))


def _launch(lib, plan, x, w, y, g, bv):
    t, (n, p) = w.shape[0], x.shape
    code = lib.repro_crossfit_gram(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), g.data_ptr(),
        bv.data_ptr(), t, n, p, plan.sub, plan.tt, plan.slots, plan.packs,
        plan.chunks, plan.ring, plan.m,
        torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "crossfit_gram")


def _time_ms(fn, flush, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_crossfit_plans: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = build.load_library("megabatch")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(20210104)
    lines = []
    for t, n, p in SHAPES:
        x = torch.randn((n, p), generator=gen, device="cuda")
        y = torch.randn((t, n), generator=gen, device="cuda")
        w = (torch.rand((t, n), generator=gen, device="cuda") < 0.8).float()
        g = torch.empty((t, p, p), device="cuda")
        bv = torch.empty((t, p), device="cuda")
        chosen = crossfit_gram.launch_plan(t, n, p)
        _launch(lib, chosen, x, w, y, g, bv)
        g_ref, b_ref = g.clone(), bv.clone()
        plans = []
        for (sub, tt), slots, m in itertools.product(
                crossfit_gram.CONFIGS, crossfit_gram.SLOTS,
                crossfit_gram.STEPS):
            plan = crossfit_gram._plan(t, n, p, sub, tt, slots, m)
            if plan is None:
                continue
            g.fill_(float("nan"))
            bv.fill_(float("nan"))
            _launch(lib, plan, x, w, y, g, bv)
            torch.cuda.synchronize()
            same = torch.equal(g, g_ref) and torch.equal(bv, b_ref)
            assert same, ("a plan changed the bits", (t, n, p), plan)
            ms = _time_ms(lambda: _launch(lib, plan, x, w, y, g, bv), flush)
            plans.append({"sub": sub, "tt": tt, "slots": slots, "m": m,
                          "packs": plan.packs, "chunks": plan.chunks,
                          "ring": plan.ring, "grid": plan.grid,
                          "est_cycles": plan.est_cycles, "ms": ms})
        best = min(plans, key=lambda r: r["ms"])
        line = {"shape": [t, n, p], "device": smi, "plans": plans,
                "chosen": {"sub": chosen.sub, "tt": chosen.tt,
                           "slots": chosen.slots, "m": chosen.m},
                "best": {k: best[k] for k in ("sub", "tt", "slots", "m",
                                              "ms")}}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del x, y, w, g, bv, g_ref, b_ref
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

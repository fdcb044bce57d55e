#!/usr/bin/env python3
"""Where one estimation request spends its time on the card.

    python3 scripts/profile_torch_estimate.py [--n-rep 100] [--out DIR]

Drives the port's main path — the paper's configuration (PLR on the bonus
data, K = 5, ridge) through ``estimate`` on the inline backend — once to
warm the process up, then again under ``torch.profiler`` (CPU and CUDA
activities).  Prints one JSON object: the request's wall time on the
host's clock (device drained), the device's busy time summed over
kernels and copies, its idle share, and the device time by kernel name.
Needs a CUDA device; exits non-zero without one.  ``--out`` also writes
the Chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch                                               # noqa: E402
from torch.profiler import ProfilerActivity, profile      # noqa: E402

from repro_torch.core import DMLData, DMLPlan, estimate    # noqa: E402
from repro_torch.data import make_bonus_data               # noqa: E402
from repro_torch.serverless import make_backend            # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-rep", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_estimate: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    data = DMLData.from_dict(make_bonus_data())
    plan = DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0}, n_folds=5,
                             n_rep=args.n_rep, backend="inline")
    backend = make_backend("inline")

    def request():
        t0 = time.perf_counter()
        res = estimate(plan, data, backend=backend)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    _, cold = request()
    _, warm = request()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, traced = request()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        # operator rows ("aten::...") repeat the time of the kernels and
        # copies they launch: keep the device-side rows only
        if dev_us > 0 and not ev.key.startswith("aten::"):
            rows.append({"name": ev.key[:80], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    out = {"card": smi, "n_rep": args.n_rep, "theta": res.theta,
           "wall_cold_s": cold, "wall_warm_s": warm,
           "wall_traced_s": traced}
    if rows:
        out.update(device_busy_ms=busy_ms,
                   device_idle_share=1.0 - busy_ms / 1e3 / traced,
                   by_kernel=rows[:25])
    else:
        out.update(device_busy_ms="not measured",
                   device_idle_share="not measured",
                   note="the profiler recorded no device time")
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.out) / "estimate_trace.json"))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

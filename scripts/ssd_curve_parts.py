#!/usr/bin/env python3
"""Where the reduced hybrid's and xLSTM's loss curves, card against CPU in
float32, part from each other: with K6's kernels on the card, and with
K6 replaced on the card by its plain chunked version (autograd through
``ssd_scan_chunked_plain``), at two learning rates.

    python3 scripts/ssd_curve_parts.py [--steps 10] [--lrs 5e-3,1e-3]

Each line: the arch, the route, the lr, the first step's gradient gap
(max |card - CPU| over each leaf's max|grad|) and the relative gap of the
loss at every step.  A route whose curve parts as far as the kernels'
shows that the parting is not K6's.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch                                               # noqa: E402

import chip_smoke                                          # noqa: E402
from repro_torch.kernels import ops, ssd_scan              # noqa: E402

CASES = (("xlstm-350m", {"slstm_every": 2}), ("zamba2-7b", None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lrs", default="5e-3,1e-3")
    args = ap.parse_args(argv)
    device = chip_smoke.runtime.default_device()
    kernels = ops.ssd_scan

    def plain_on_card(x, la, bm, cm, *, chunk, heads):
        if not x.is_cuda:
            return kernels(x, la, bm, cm, chunk=chunk, heads=heads)
        return ssd_scan.ssd_scan_chunked_plain(x, la, bm, cm, chunk=chunk,
                                               heads=heads)
    # report every gap rather than hold the curves to a tier
    chip_smoke.TRAIN_CURVE_TIER = float("inf")
    try:
        for arch, ssm in CASES:
            for lr in (float(v) for v in args.lrs.split(",")):
                for route, fn in (("kernels", kernels),
                                  ("plain", plain_on_card)):
                    ops.ssd_scan = fn
                    r = chip_smoke._reduced_card_vs_cpu(
                        arch, device, seq=64, steps=args.steps, lr=lr,
                        ssm=ssm)
                    print(json.dumps({
                        "arch": arch, "route": route, "lr": lr,
                        "grad_gap_of_max": r["grad_gap_of_max"],
                        "curve_rel_gaps": [abs(a - b) / abs(b) for a, b in
                                           zip(r["losses_card"],
                                               r["losses_cpu"])],
                        "k6_launches_one_step": {
                            k: r["launches_one_step"][k]
                            for k in ("ssd_scan", "ssd_scan_bwd")}}),
                        flush=True)
    finally:
        ops.ssd_scan = kernels
    print(chip_smoke.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

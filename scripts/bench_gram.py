#!/usr/bin/env python3
"""Time the per-task Gram kernels (K1 and K3) of one source tree on the card.

    python3 scripts/bench_gram.py [--src DIR] [--plans] [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), then
this checkout's ``chip_smoke.py`` for its ``SHAPES``, ``WIDE_GRAM_SHAPES``
and ``BLOCKED_SHAPES``, its inputs and its timer, so that two trees — a
parent commit unpacked beside this one, and this one — are timed at the
same shapes in the same way, each in its own process, in turns (parent,
change, change, parent).  Each row is ``chip_smoke.py``'s time of
``ops.batched_gram`` or ``ops.batched_gram_blocked`` (median of 20
launches after 3 warm-ups, CUDA events, L2 flushed before each) and the
bmm pair's beside it, and a hash of the result's bits (the inputs are
the same in both trees, so equal hashes mean equal bits).  With
``--plans`` (a tree whose wrapper takes a launch plan) every plan of
``megabatch.gram_plans`` is timed too, and checked to give the same bits
as the one ``gram_launch_plan`` picks.  The
errors against the plain versions come from ``chip_smoke.py``'s kernels
phase, the registers and spills from ``chip_smoke.py --verbose-build``.
Prints one JSON line a shape, then one with the card's name and power
limit.  Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the source tree whose repro_torch to time")
    ap.add_argument("--plans", action="store_true",
                    help="time and compare every launch plan")
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    tree = Path(args.src).resolve()
    # the tree's package first: chip_smoke's own imports then find it
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build, megabatch, ops
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        print("bench_gram: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    build.load_library("megabatch")
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps({"tree": str(tree), **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    gen = torch.Generator(device="cuda").manual_seed(20210104)
    for shape in (chip_smoke.SHAPES + chip_smoke.WIDE_GRAM_SHAPES
                  + chip_smoke.BLOCKED_SHAPES):
        blocked = len(shape) == 4
        b, p = shape[0], shape[-1]
        n = shape[1] * shape[2] if blocked else shape[1]
        xs = torch.randn((b, n, p), generator=gen, device="cuda")
        y = torch.randn((b, n), generator=gen, device="cuda")
        w = (torch.rand((b, n), generator=gen, device="cuda") < 0.8).float()
        if blocked:
            xc, wc, yc = (xs.view(shape), w.view(shape[:3]),
                          y.view(shape[:3]))

            def call(plan=None):
                if plan is None:
                    return ops.batched_gram_blocked(xc, wc, yc)
                return megabatch.batched_gram_blocked_cuda(xc, wc, yc,
                                                           plan=plan)
        else:
            def call(plan=None):
                if plan is None:
                    return ops.batched_gram(xs, w, y)
                return megabatch.batched_gram_cuda(xs, w, y, plan=plan)

        def library():
            return (torch.bmm((xs * w.unsqueeze(-1)).transpose(1, 2), xs),
                    torch.bmm(xs.transpose(1, 2), (w * y).unsqueeze(-1)))

        g0, b0 = call()
        bits = torch.cat([g0.flatten(), b0.flatten()]).cpu().numpy()
        row = {"kernel": "batched_gram_blocked" if blocked
               else "batched_gram", "shape": list(shape),
               "sha1": hashlib.sha1(bits.tobytes()).hexdigest()[:16],
               "ms": chip_smoke._time_ms(call, cold=True),
               "library_ms": chip_smoke._time_ms(library, cold=True)}
        if args.plans:
            chosen = megabatch.gram_launch_plan(b, n, p)
            row["plans"] = []
            for plan in megabatch.gram_plans(b, n, p):
                g1, b1 = call(plan)
                torch.cuda.synchronize()
                assert torch.equal(g0, g1) and torch.equal(b0, b1), \
                    ("a launch plan changed the bits", shape, plan)
                row["plans"].append({
                    "si": plan.si, "sj": plan.sj, "panel": plan.panel,
                    "per_cta": plan.per_cta,
                    "chunks": plan.chunks, "ring": plan.ring,
                    "srows": plan.srows, "chosen": plan == chosen,
                    "ms": chip_smoke._time_ms(lambda: call(plan),
                                              cold=True)})
            row["plans_bitwise_equal"] = True
        emit(row)
        del xs, y, w
        torch.cuda.empty_cache()
    emit({"card": chip_smoke.smi_line()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

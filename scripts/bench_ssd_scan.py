#!/usr/bin/env python3
"""Time the SSD-scan kernel (K6) of one source tree on the card.

    python3 scripts/bench_ssd_scan.py [--src DIR] [--trace]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), then
this checkout's ``chip_smoke.py`` for its ``SSD_SHAPES``, its inputs and
its timer, so that two trees — a parent commit unpacked beside this one,
and this one — are timed at the same shapes in the same way, each in its
own process, in turns (parent, change, change, parent).  Each row is
``chip_smoke.py``'s time of ``ops.ssd_scan`` (median of 20 launches after 3
warm-ups, CUDA events, L2 flushed before each).  ``--trace`` adds the
device ms per call of each CUDA kernel at the first row (10 calls under
``torch.profiler``, warm L2).  A row past the tree's kernels' limits (a
parent's N, P <= 64, say) is listed as refused, with the limit named.  The
errors against the plain version come
from ``chip_smoke.py``'s kernels phase, the registers and spills from
``chip_smoke.py --verbose-build``.  Prints one JSON object with the card's
name and power limit.  Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the source tree whose repro_torch to time")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    tree = Path(args.src).resolve()
    # the tree's package first: chip_smoke's own imports then find it
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ssd_scan as ssd_mod
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        print("bench_ssd_scan: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.load_library("lm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, decay in chip_smoke.SSD_SHAPES:
        try:
            ssd_mod.check_kernel_shape(*shape[:5])
        except ValueError as err:
            rows.append({"shape": list(shape), "decay": decay,
                         "refused": str(err)})
            continue
        x, la, bm, cm = chip_smoke._ssd_inputs(shape, decay, "cuda", gen)
        chunk, heads = shape[4:]

        def call():
            return ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads)
        row = {"shape": list(shape), "decay": decay,
               "ms": chip_smoke._time_ms(call, cold=True)}
        if args.trace and not any("ms" in r for r in rows):
            traced = chip_smoke._device_kernels(call, calls=10)
            # None: no profiler session was whole
            row["device_ms_by_kernel"] = traced and {
                name[:60]: ms for name, (_, ms) in traced.items()}
        rows.append(row)
        del x, la, bm, cm
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "tree": str(tree), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the SSD-scan kernel (K6) of one source tree on the card.

    python3 scripts/bench_ssd_scan.py [--src DIR] [--trace] [--backward]

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
``chip_smoke.py --verbose-build``.  Prints the card's name and power
limit on its first line, then one JSON object.

``--backward`` times K6's gradient instead: the tree's
``ssd_scan_bwd_cuda`` at every row of ``chip_smoke.SSD_BWD_ROWS``, after
the tree's forward that leaves the scores, chunk states and decays, with
the same timer (median of 20, L2 flushed before each), beside its CUDA
launches a call (a captured graph's kernel nodes) and a hash of dxbar,
dla, dbm and dcm's bits (``bits``).  Run parent, change, change, parent:
each tree in its own process, the same inputs from the same seed.  Needs
a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
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
    ap.add_argument("--backward", action="store_true",
                    help="time K6's backward at chip_smoke's SSD_BWD_ROWS")
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
    print(smi, flush=True)
    build.load_library("lm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.backward:
        build.load_library("ssd_bwd")
        rows = _backward_rows(chip_smoke, ssd_mod, gen)
        print(json.dumps({"card": smi, "tree": str(tree), "backward": True,
                          "rows": rows}))
        return 0
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


def _bits(tensors) -> str:
    """A hash of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _backward_rows(chip_smoke, ssd_mod, gen):
    """K6's backward at every row of SSD_BWD_ROWS: inputs drawn as
    chip_smoke draws them, the scratch from the tree's forward, the bits
    of the four gradients, the CUDA launches of one call and the median
    ms of 20 calls (L2 flushed); a row past the tree's limits is
    ``refused``."""
    import torch
    rows = []
    for name, shape, decay, with_dst, _ in chip_smoke.SSD_BWD_ROWS:
        bh, s, p, n, chunk, heads = shape
        row = {"name": name, "shape": list(shape)}
        x, la, bm, cm, dy, dst = chip_smoke._ssd_bwd_inputs(
            shape, decay, with_dst, "cuda", gen)
        try:
            ssd_mod.check_backward_shape(bh, s, p, n, chunk)
        except ValueError as err:
            row["refused"] = str(err)[:120]
            rows.append(row)
            continue
        _, _, cb, states, dec = ssd_mod._forward_cuda(x, la, bm, cm, chunk,
                                                      heads)

        def call():
            return ssd_mod.ssd_scan_bwd_cuda(x, la, bm, cm, cb, states, dec,
                                             dy, dst, chunk=chunk,
                                             heads=heads)
        row["bits"] = _bits(call())
        row["cuda_launches_per_call"] = chip_smoke._graph_launches(call)
        row["ms"] = chip_smoke._time_ms(call, cold=True)
        rows.append(row)
        del x, la, bm, cm, dy, dst, cb, states, dec
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())

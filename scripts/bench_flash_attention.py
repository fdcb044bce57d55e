#!/usr/bin/env python3
"""Time the flash-attention kernel (K5) of one source tree on the card.

    python3 scripts/bench_flash_attention.py [--src DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), then
this checkout's ``chip_smoke.py`` for its ``ATTN_SHAPES`` and its timer,
so that two trees — a parent commit unpacked beside this one, and this
one — are timed at the same shapes in the same way, each in its own
process, in turns (parent, change, change, parent).  Each row is
``chip_smoke.py``'s time of ``ops.flash_attention`` (median of 20 launches
after 3 warm-ups, CUDA events, L2 flushed before each) on inputs drawn
from one seeded generator; a shape the tree's kernels do not take (a v
shallower than q, before the decoder slice) is marked ``refused``.  The
errors against the plain version come from ``chip_smoke.py``'s kernels
phase.  Each row also carries a hash of the output's bits (``bits``):
equal hashes across two trees mean the same bits.  Prints one JSON object
with the card's name and power limit.
Needs a CUDA device; exits non-zero without one.
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
    args = ap.parse_args(argv)
    tree = Path(args.src).resolve()
    # the tree's package first: chip_smoke's own imports then find it
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build, ops
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        print("bench_flash_attention: no CUDA device", file=sys.stderr)
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
    for shape in chip_smoke.ATTN_SHAPES:
        bh, sq, skv, d, dtype, causal, window = shape[:7]
        dv = shape[7] if len(shape) > 7 else d
        q, k, v = (torch.randn((bh, n, depth), generator=gen, device="cuda")
                   .to(chip_smoke.TYPES[dtype])
                   for n, depth in ((sq, d), (skv, d), (skv, dv)))

        def call():
            return ops.flash_attention(q, k, v, causal=causal, window=window)
        row = {"shape": list(shape)}
        try:
            o = call()
        except ValueError as err:
            row["refused"] = str(err)[:120]
        else:
            raw = o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            row["bits"] = hashlib.sha256(raw).hexdigest()[:16]
            del o
            row["ms"] = chip_smoke._time_ms(call, cold=True)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "tree": str(tree), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

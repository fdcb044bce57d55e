#!/usr/bin/env python3
"""Time the flash-attention kernel (K5) of one source tree on the card.

    python3 scripts/bench_flash_attention.py [--src DIR] [--backward]

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

``--backward`` times K5's gradient instead: the tree's
``flash_attention_bwd_cuda`` at every row of ``chip_smoke.BWD_ATTN_ROWS``
(bf16 and float32), after the tree's forward that writes the row
log-sum-exp, with the same timer, and a hash of dq, dk and dv's bits
(``bits``; ``forward_bits`` hashes o and lse).  Run parent, change,
change, parent: equal hashes show that a row kept its bits.
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
    ap.add_argument("--backward", action="store_true",
                    help="time K5's backward at chip_smoke's BWD_ATTN_ROWS")
    args = ap.parse_args(argv)
    tree = Path(args.src).resolve()
    # the tree's package first: chip_smoke's own imports then find it
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build, flash_attention, ops
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
    if "attn_bwd" in build.SIGNATURES:   # a tree before it has no such library
        build.load_library("attn_bwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.backward:
        rows = _backward_rows(chip_smoke, flash_attention, gen)
        print(json.dumps({"card": smi, "tree": str(tree), "backward": True,
                          "rows": rows}))
        return 0
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


def _bits(tensors) -> str:
    """A hash of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _backward_rows(chip_smoke, flash_attention, gen):
    """K5's backward at every row of BWD_ATTN_ROWS: inputs drawn as
    chip_smoke draws them, o and lse from the tree's forward, the bits of
    dq, dk, dv and the median ms of 20 launches (L2 flushed)."""
    import torch
    rows = []
    for name, shape in chip_smoke.BWD_ATTN_ROWS:
        bh, sq, skv, d, dtype, causal, window = shape[:7]
        dv = shape[7] if len(shape) > 7 else d
        t = chip_smoke.TYPES[dtype]
        q, k = (torch.randn((bh, n, d), generator=gen, device="cuda").to(t)
                for n in (sq, skv))
        v = torch.randn((bh, skv, dv), generator=gen, device="cuda").to(t)
        do = torch.randn((bh, sq, dv), generator=gen, device="cuda").to(t)
        o, lse = flash_attention._forward_cuda(q, k, v, causal, window,
                                               with_lse=True)

        def call():
            return flash_attention.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=causal, window=window)
        rows.append({"name": name, "shape": list(shape),
                     "forward_bits": _bits((o, lse)), "bits": _bits(call()),
                     "ms": chip_smoke._time_ms(call, cold=True)})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())

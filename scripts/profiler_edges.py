#!/usr/bin/env python3
"""Count the CUDA kernels of one K6 call, one K1 call and a loop of small
kernels three ways on the card: as a captured CUDA graph holds them
(``chip_smoke._graph_launches``), as one bare torch.profiler session records
them, and as ``chip_smoke._device_kernels`` records them (a session between
two sentinel kernels and host pauses; None where no session was whole).

    python3 scripts/profiler_edges.py [--seconds 120]

Bare sessions are counted fresh, then every way is traced again and again
for ``--seconds`` between rounds of K5 and SDPA causal backwards at (64,
2048, 2048, 64) bf16.  Prints one JSON line: for each way and call, how
many traces gave each count.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FRESH_TRACES = 12
# small kernels in the loop (the sLSTM loop runs about 43 000 a layer)
LOOP_KERNELS = 20_000


def bare_count(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if getattr(ev, "self_device_time_total", 0) > 0
               and not ev.key.startswith(("aten::", "cuda")))


def bracketed_count(fn):
    traced = chip_smoke._device_kernels(fn)
    return None if traced is None else sum(k for k, _ in traced.values())


def attention_backwards(gen) -> None:
    q, k, v = (torch.randn((64, 2048, 64), device="cuda", dtype=torch.bfloat16,
                           generator=gen).requires_grad_() for _ in range(3))
    for _ in range(10):
        ops.flash_attention(q, k, v, causal=True).float().sum().backward()
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True).float().sum().backward()
    torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_edges: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = chip_smoke.MAIN_SSD_SHAPE
    x, la, bm, cm = chip_smoke._ssd_inputs(shape, "slow", "cuda", gen)
    chunk, heads = shape[4:]
    b, n, p = chip_smoke.MAIN_SHAPE
    xs = torch.randn((b, n, p), device="cuda", generator=gen)
    w = torch.rand((b, n), device="cuda", generator=gen)
    y = torch.randn((b, n), device="cuda", generator=gen)
    acc = torch.zeros(64, device="cuda")

    def loop():
        for _ in range(LOOP_KERNELS):
            acc.add_(1.0)

    calls = {
        "ssd": lambda: ops.ssd_scan(x, la, bm, cm, chunk=chunk, heads=heads),
        "gram": lambda: ops.batched_gram(xs, w, y),
        "loop": loop,
    }
    for fn in calls.values():                 # builds and loads the kernels
        fn()
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": smi, "torch": torch.__version__,
           "graph": {k: chip_smoke._graph_launches(fn)
                     for k, fn in calls.items()}}
    out["bare_fresh"] = {
        k: dict(collections.Counter(bare_count(fn)
                                    for _ in range(FRESH_TRACES)))
        for k, fn in calls.items()}
    seen = {way: {k: collections.Counter() for k in calls}
            for way in ("bare", "bracketed")}
    t0, rounds = time.perf_counter(), 0
    while time.perf_counter() - t0 < args.seconds:
        attention_backwards(gen)
        for k, fn in calls.items():
            seen["bare"][k][bare_count(fn)] += 1
            seen["bracketed"][k][bracketed_count(fn)] += 1
        rounds += 1
    out["rounds"] = rounds
    out["soak"] = {way: {k: {str(c): m for c, m in cnt.items()}
                         for k, cnt in per.items()}
                   for way, per in seen.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

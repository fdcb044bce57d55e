#!/usr/bin/env python3
"""Does a learner family give a lane the same bits at another batch count?

    python3 scripts/probe_batch_bits.py [--device cpu|cuda] [--lanes L]
        [--families a,b] [--mlp-steps S]

For each megabatch family (ols, ridge, lasso, logistic, kernel_ridge with
128 landmarks, mlp with hidden (64, 64) and ``S`` Adam steps, 300 by
default) and each (N, P) page below, one seeded batch of ``L`` lanes
(numpy, seed 0; the lanes' keys fold_in(key(0), lane)) goes
through the family's batched function whole, in blocks of 32, and in its
first k lanes for k in 8, 16, 24.  Prints one JSON line per (family,
shape): for each comparison the largest absolute difference of a
prediction and the number of lanes whose bits differ.  "concat" is the
fused launch's concatenated form (all lanes in one call) against the
per-block launches (32 lanes a call); "morph_k" is a lane of a call of k
lanes (a tail block at its canonical B) against the same lane in a call
of 32 (the tail morphed up).  These are the measured
reasons behind ``compile/program.py``'s ``FUSED_CONCAT_FAMILIES`` and
``MORPH_BITWISE_FAMILIES``.  ``--device cuda`` needs a card (the kernels
build on first use); ``cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np                                         # noqa: E402
import torch                                               # noqa: E402

from repro_torch import threefry                           # noqa: E402
from repro_torch.learners import get_batched_learner       # noqa: E402
from repro_torch.runtime import resolve_device             # noqa: E402

FAMILIES = (("ols", {}), ("ridge", {"reg": 1.0}), ("lasso", {"reg": 0.01}),
            ("logistic", {"reg": 1.0}),
            ("kernel_ridge", {"reg": 1.0, "n_landmarks": 128}),
            ("mlp", {"hidden": (64, 64)}))
# (N, P) of the page, the intercept added by the learner: ragged pages and
# the paper's bucket (N_pad 5104, P_pad 32)
SHAPES = ((1003, 16), (517, 32), (5104, 32))


def _lanes(lanes, n, p, logistic, device):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(lanes, n, p)).astype(np.float32)
    y = rng.normal(size=(lanes, n)).astype(np.float32)
    if logistic:
        y = (y > 0).astype(np.float32)
    valid = np.ones((lanes, n), np.float32)
    valid[:, n - 3:] = 0.0
    w = (rng.random((lanes, n)) < 0.8).astype(np.float32) * valid
    kd = threefry.fold_in(threefry.key(0), torch.arange(lanes))
    return [torch.as_tensor(a, device=device)
            for a in (xs, y, w, valid)] + [kd.to(device)]


def _diff(a, b):
    d = (a - b).abs().amax(dim=1)
    return {"max_abs_diff": float(d.max()),
            "lanes_differ": int((a != b).any(dim=1).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--families", default=",".join(f for f, _ in FAMILIES))
    ap.add_argument("--mlp-steps", type=int, default=300)
    args = ap.parse_args(argv)
    wanted = args.families.split(",")
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    for family, params in FAMILIES:
        if family not in wanted:
            continue
        if family == "mlp":
            params = {**params, "n_steps": args.mlp_steps}
        fn = get_batched_learner(family, params)
        for n, p in SHAPES:
            ops = _lanes(args.lanes, n, p, family == "logistic", device)
            whole = fn(*ops)
            blocks = torch.cat([fn(*(a[i:i + 32] for a in ops))
                                for i in range(0, args.lanes, 32)])
            row = {"device": name, "family": family, "params": params,
                   "n": n, "p": p,
                   "lanes": args.lanes, "concat": _diff(whole, blocks)}
            for k in (8, 16, 24):
                part = fn(*(a[:k] for a in ops))
                row[f"morph_{k}"] = _diff(part, blocks[:k])
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

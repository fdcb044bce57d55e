"""Figure-3 reproduction on the PyTorch/CUDA port —
``examples/serverless_scaling.py`` one for one, with ``repro_torch`` in
place of ``repro``: fit time and billed cost vs worker memory, for both
scaling levels (paper §5.2).  Uses the simulated Lambda timing model for
the memory/vCPU curve plus REAL measured wave compute on the card.

Run:  python examples/serverless_scaling_torch.py [--device cuda|cpu]
      [--n-rep M] [--repeats R]
(on a machine without a GPU it raises unless ``--device cpu`` is given)
"""
import argparse

try:
    import _bootstrap_torch  # noqa: F401  (run as a script from examples/)
except ModuleNotFoundError:          # imported as examples.<module>
    from examples import _bootstrap_torch  # noqa: F401

import numpy as np

from repro_torch.configs.dml_plr_bonus import (
    FIG3_MEMORY_GRID, FIG3_SCALING_GRID, USD_PER_GB_S,
)
from repro_torch.core import DMLData, DMLPlan, estimate
from repro_torch.data import make_bonus_data
from repro_torch.runtime import resolve_device
from repro_torch.serverless import PoolConfig


def run_sweep(n_rep: int = 20, repeats: int = 3, simulate: bool = True,
              device: str = "cuda"):
    """Rows (scaling, memory MB, mean response time s, mean billed GB-s)
    and every run's result, in the sweep's order."""
    device = resolve_device(device)
    data = DMLData.from_dict(make_bonus_data())
    rows, results = [], []
    for scaling in FIG3_SCALING_GRID:
        for mem in FIG3_MEMORY_GRID:
            times, costs = [], []
            for r in range(repeats):
                pool = PoolConfig(n_workers=10_000, memory_mb=mem,
                                  simulate=simulate, base_work_s=0.35, seed=r)
                plan = DMLPlan.for_model(
                    "plr", n_folds=5, n_rep=n_rep, learner="ridge",
                    learner_params={"reg": 1.0}, scaling=scaling,
                    seed=42 + r, pool=pool)
                res = estimate(plan, data, device=device)
                results.append(res)
                times.append(res.report.response_time_s)
                costs.append(res.report.bill.total_gb_s)
            rows.append((scaling, mem, float(np.mean(times)),
                         float(np.mean(costs))))
    return rows, results


def main(n_rep: int = 20, repeats: int = 3, device: str = "cuda"):
    rows, _ = run_sweep(n_rep, repeats, device=device)
    print(f"{'scaling':>16} {'memory':>7} {'time_s':>9} {'GB-s':>9} {'USD':>9}")
    for scaling, mem, t, c in rows:
        print(f"{scaling:>16} {mem:>7} {t:>9.2f} {c:>9.1f} "
              f"{c * USD_PER_GB_S:>9.5f}")
    # the two paper claims (Fig 3):
    per_split = [(m, t, c) for s, m, t, c in rows if s == "n_rep"]
    per_fold = [(m, t, c) for s, m, t, c in rows if s != "n_rep"]
    t_ps = [t for _, t, _ in per_split]
    assert all(b < a for a, b in zip(t_ps, t_ps[1:])), \
        "time must fall with memory"
    faster = sum(int(f[1] < s[1]) for f, s in zip(per_fold, per_split))
    print(f"\nper-fold faster than per-split at {faster}/{len(per_split)} "
          f"memory points (paper: always)")
    print("marginal time improvements (per-split): " + ", ".join(
        f"{(a - b) / a:.1%}" for a, b in zip(t_ps, t_ps[1:])))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-rep", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    main(args.n_rep, args.repeats, args.device)

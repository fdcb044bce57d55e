"""Quickstart on the PyTorch/CUDA port — ``examples/quickstart.py`` one
for one, with ``repro_torch`` in place of ``repro``: the paper's §5.1
snippet on the declarative API, run on the card.

Paper (DoubleML-Serverless):                      Here:
    dml_data = DoubleMLDataS3(...)                  data = DMLData.from_dict(
                                                        make_bonus_data())
    learner = RandomForestRegressor(...)            learner="kernel_ridge"
    dml_plr = DoubleMLPLRServerless(                plan = DMLPlan.for_model(
        lambda_function_name=...,                       "plr", n_folds=5,
        dml_data, ml_g, ml_m, n_folds=5,                n_rep=..., scaling=
        n_rep=100, scaling='n_rep')                     "n_rep", pool=...)
    dml_plr.fit_aws_lambda()                        res = estimate(plan, data)

Run:  python examples/quickstart_torch.py [--device cuda|cpu] [--n-rep M]
(on a machine without a GPU it raises unless ``--device cpu`` is given)
"""
import argparse

try:
    import _bootstrap_torch  # noqa: F401  (run as a script from examples/)
except ModuleNotFoundError:          # imported as examples.<module>
    from examples import _bootstrap_torch  # noqa: F401

from repro_torch.configs.dml_plr_bonus import USD_PER_GB_S
from repro_torch.core import DMLData, DMLPlan, estimate
from repro_torch.data import make_bonus_data
from repro_torch.runtime import resolve_device
from repro_torch.serverless import PoolConfig


def run(n_rep: int = 20, device: str = "cuda"):
    """The quickstart's data and result (``DMLResult``)."""
    device = resolve_device(device)
    data = DMLData.from_dict(make_bonus_data())
    plan = DMLPlan.for_model(
        "plr", n_folds=5, n_rep=n_rep,
        learner="kernel_ridge",                  # RF stand-in (DESIGN.md §2)
        learner_params={"reg": 1.0, "n_landmarks": 256},
        scaling="n_rep",                          # paper's per-split scaling
        n_boot=500,
        pool=PoolConfig(n_workers=8, memory_mb=1024))
    return data, estimate(plan, data, device=device)


def main(n_rep: int = 20, device: str = "cuda"):
    data, res = run(n_rep, device)
    print(f"bonus replica: N={data.n_obs}, p={data.dim_x} controls, "
          f"planted effect {data.theta0}")
    print(f"\ntheta_hat = {res.theta:+.4f}  (se {res.se:.4f})")
    print(f"95% CI     = [{res.ci[0]:+.4f}, {res.ci[1]:+.4f}]")
    print(f"boot CI    = [{res.boot_ci[0]:+.4f}, {res.boot_ci[1]:+.4f}]")
    s = res.report.summary()
    print(f"\ninvocations={s['invocations']} waves={s['waves']} "
          f"fit_time={s['fit_time_s']:.2f}s")
    print(f"billed {s['billed_gb_s']:.1f} GB-s = "
          f"${s['billed_gb_s'] * USD_PER_GB_S:.5f}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-rep", type=int, default=20)
    args = ap.parse_args()
    main(args.n_rep, args.device)

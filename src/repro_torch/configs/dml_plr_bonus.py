"""The paper's own experiment config (§5): PLR model on the Pennsylvania
Reemployment Bonus experiment, K=5 folds, M=100 repetitions, L=2 nuisance
functions => 1000 ML fits.

The bonus dataset itself is not bundled; ``repro_torch.data.make_bonus_data``
generates a schema-faithful synthetic replica (N=5099 rows, 17 regressors as
in the Chernozhukov et al. 2018 / DoubleML preprocessing).
"""
from dataclasses import dataclass

from repro_torch.serverless.cost import USD_PER_GB_S   # noqa: F401


@dataclass(frozen=True)
class DMLConfig:
    model: str = "plr"            # plr | pliv | irm | iivm
    n_folds: int = 5              # K
    n_rep: int = 100              # M
    learner: str = "ridge"        # ridge | ols | lasso | kernel_ridge | mlp
    learner_params: tuple = (("reg", 1.0),)
    scaling: str = "n_rep"        # 'n_rep' | 'n_folds*n_rep'  (paper §4.2)
    score: str = "partialling out"
    # serverless-analogue executor knobs (paper §5.2 sweep)
    worker_memory_mb: int = 1024  # Lambda memory knob (drives the cost model)
    n_workers: int = 0            # 0 = elastic (all available devices)
    seed: int = 42


CONFIG = DMLConfig()

# The paper's Figure 3 sweep grid.
FIG3_MEMORY_GRID = (256, 512, 1024, 2048)
FIG3_SCALING_GRID = ("n_rep", "n_folds*n_rep")

# Table 1 reference numbers (1024 MB, per-sample-split scaling, 100 runs).
PAPER_TABLE1 = {
    "fit_time_s": {"mean": 19.82, "min": 19.53, "max": 21.49},
    "billed_gb_s": {"mean": 3515.36, "min": 3492.01, "max": 3571.42},
    "avg_duration_per_invocation_s": {"mean": 17.16, "min": 17.05, "max": 17.44},
    "total_response_time_s": {"mean": 19.09, "min": 18.81, "max": 20.76},
}

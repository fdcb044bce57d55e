# The paper's primary contribution: serverless-style distributed DML,
# exposed as a declarative three-layer API (spec -> backend -> session).
from repro_torch.core.bootstrap import boot_confint, multiplier_bootstrap
from repro_torch.core.crossfit import (
    TaskGrid, draw_fold_masks, stitch_predictions,
)
from repro_torch.core.dml import DoubleMLServerless
from repro_torch.core.scores import (
    SPECS, evaluate_score, score_se, solve_theta,
)
from repro_torch.core.session import DMLResult, DMLSession, estimate
from repro_torch.core.spec import (
    DMLData, DMLPlan, InferenceSpec, NuisanceSpec, ResamplingSpec,
)

__all__ = [
    "TaskGrid", "draw_fold_masks", "stitch_predictions", "DMLResult",
    "multiplier_bootstrap", "boot_confint",
    "DoubleMLServerless",
    "SPECS", "evaluate_score", "score_se", "solve_theta",
    "DMLData", "DMLPlan", "NuisanceSpec", "ResamplingSpec", "InferenceSpec",
    "DMLSession", "estimate",
]

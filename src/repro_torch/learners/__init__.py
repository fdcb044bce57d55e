from repro_torch.learners.base import (
    BATCHED_LEARNERS, FEATURE_PAD_SAFE, LearnerFn, get_batched_learner,
    resolve_params,
)

__all__ = [
    "LearnerFn", "get_batched_learner", "resolve_params",
    "BATCHED_LEARNERS", "FEATURE_PAD_SAFE",
]

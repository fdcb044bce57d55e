from repro_torch.learners.base import (
    BATCHED_LEARNERS, FEATURE_PAD_SAFE, LEARNERS, LearnerFn, as_batched,
    get_batched_learner, get_learner, resolve_params,
)

__all__ = [
    "LearnerFn", "get_learner", "get_batched_learner", "as_batched",
    "resolve_params", "LEARNERS", "BATCHED_LEARNERS", "FEATURE_PAD_SAFE",
]

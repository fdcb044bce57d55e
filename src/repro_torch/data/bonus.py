"""Schema-faithful synthetic replica of the Pennsylvania Reemployment Bonus
experiment dataset (paper §5: N=5099 after the standard DoubleML
preprocessing; outcome = log unemployment duration, treatment = bonus
offer tgdep≠0 collapsed to binary, 17 control columns).

The exact CSV is not bundled; the replica
matches row count, column names/types and realistic marginals, with a known
planted effect so the pipeline remains checkable end-to-end.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

N_BONUS = 5099
X_COLS = [
    "female", "black", "othrace", "dep1", "dep2",
    "q2", "q3", "q4", "q5", "q6",
    "agelt35", "agegt54", "durable", "lusd", "husd",
    "nondurable", "married",
]
TRUE_EFFECT = -0.08     # planted; the published estimate is ~ -0.07..-0.08


def make_bonus_data(seed: int = 3141) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.Philox(key=seed))
    n = N_BONUS
    cols = {}
    probs = {
        "female": 0.39, "black": 0.11, "othrace": 0.01, "dep1": 0.20,
        "dep2": 0.25, "agelt35": 0.43, "agegt54": 0.11, "durable": 0.17,
        "lusd": 0.40, "husd": 0.27, "nondurable": 0.15, "married": 0.56,
    }
    for c, p in probs.items():
        cols[c] = (rng.random(n) < p).astype(np.float32)
    # quarter-of-enrollment dummies q2..q6 (one-hot-ish)
    q = rng.integers(1, 7, n)
    for i in range(2, 7):
        cols[f"q{i}"] = (q == i).astype(np.float32)
    x = np.stack([cols[c] for c in X_COLS], axis=1)
    # randomized treatment (it was an RCT), mild dependence for realism
    d = (rng.random(n) < 0.34).astype(np.float32)
    # log-duration outcome with covariate effects + planted treatment effect
    beta = rng.normal(0.0, 0.15, x.shape[1])
    base = 2.1 + x @ beta
    y = base + TRUE_EFFECT * d + rng.gumbel(0.0, 0.55, n)
    return {"x": x.astype(np.float32), "y": y.astype(np.float32),
            "d": d, "theta0": TRUE_EFFECT, "columns": X_COLS}

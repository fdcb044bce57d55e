"""Deprecated one-shot front-end over the declarative API.

``DoubleMLServerless`` predates the three-layer design (core/spec.py,
serverless/backends.py, core/session.py) and is kept as a thin shim: it
translates its constructor kwargs into a ``DMLPlan`` and delegates to
``estimate``.  New code should build plans directly:

    plan = DMLPlan.for_model("plr", learner="ridge",
                             learner_params={"reg": 1.0},
                             n_folds=5, n_rep=100, seed=42)
    res = estimate(plan, DMLData.from_dict(data))

Its default ``backend="wave"`` runs the paper's wave scheduler;
``"inline"`` and ``"sharded"`` run too.  ``device`` is where ``fit``
runs: the card by default.
"""
from __future__ import annotations

import warnings
from dataclasses import replace
from typing import Optional

from repro_torch.core.crossfit import TaskGrid
from repro_torch.core.scores import SPECS
from repro_torch.core.session import DMLResult, estimate
from repro_torch.core.spec import DMLData, DMLPlan
from repro_torch.runtime import DeviceLike
from repro_torch.serverless.backends import PoolConfig
from repro_torch.serverless.ledger import TaskLedger

__all__ = ["DMLResult", "DoubleMLServerless"]


class DoubleMLServerless:
    """Deprecated: use ``DMLPlan`` + ``estimate`` / ``DMLSession``."""

    def __init__(self, model: str = "plr", n_folds: int = 5, n_rep: int = 100,
                 learner: str = "ridge", learner_params: Optional[dict] = None,
                 scaling: str = "n_rep", pool: Optional[PoolConfig] = None,
                 score: str = "default", seed: int = 42,
                 backend: str = "wave", device: DeviceLike = "cuda"):
        warnings.warn(
            "DoubleMLServerless is deprecated; build a DMLPlan and call "
            "estimate() or use a DMLSession", DeprecationWarning,
            stacklevel=2)
        self.plan = DMLPlan.for_model(
            model, learner=learner, learner_params=learner_params,
            n_folds=n_folds, n_rep=n_rep, seed=seed, score=score,
            scaling=scaling, backend=backend, pool=pool)
        self.device = device
        # legacy introspection attributes
        self.spec = SPECS[model]
        self.model = model
        self.n_folds = n_folds
        self.n_rep = n_rep
        self.scaling = scaling
        self.score = score
        self.seed = seed
        self.learner_name = learner
        self.learner_params = dict(learner_params or {})
        # legacy introspection saw pool.scaling == scaling; give that view
        # on a COPY so the caller's (frozen) config is never touched
        self.pool = replace(pool, scaling=scaling) if pool is not None \
            else PoolConfig(scaling=scaling)
        self.grid = TaskGrid(n_rep, n_folds, self.spec.n_nuisance)

    def fit(self, data, ledger: Optional[TaskLedger] = None,
            n_boot: int = 0) -> DMLResult:
        plan = self.plan
        if n_boot:
            plan = plan.replace(
                inference=replace(plan.inference, n_boot=n_boot))
        res = estimate(plan, DMLData.from_dict(data), ledger=ledger,
                       device=self.device)
        self._psi = res.psi
        return res

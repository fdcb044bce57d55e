"""Declarative estimation front-end: typed data + composable plans.

The public API is three layers (README "Architecture"):

  1. specification  — ``DMLData`` (validated arrays with roles y/d/x/z)
                      and ``DMLPlan`` (what to estimate: score, per-nuisance
                      learners, resampling, inference options),
  2. execution      — an ``ExecutionBackend`` (serverless/backends.py) that
                      runs the compiled task grid,
  3. serving        — ``DMLSession`` (core/session.py) that batches many
                      (plan, data) requests onto one warm backend.

Everything in this module is an immutable value object: plans can be
shared, hashed into caches, and submitted concurrently without aliasing
hazards (``PoolConfig`` is frozen for the same reason).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.scores import SPECS
from repro_torch.serverless.backends import (
    BACKEND_NAMES, PoolConfig, fingerprint_array,
)

_ROLES = ("x", "y", "d", "z", "cluster")
_SCALINGS = ("n_rep", "n_folds*n_rep")


def _as_f32(name: str, arr, ndim: int) -> np.ndarray:
    out = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
    if out.ndim != ndim:
        raise ValueError(f"DMLData.{name}: expected {ndim}-d array, "
                         f"got shape {out.shape}")
    if not np.isfinite(out).all():
        raise ValueError(f"DMLData.{name}: contains NaN/inf")
    return out


@dataclass(frozen=True, eq=False)
class DMLData:
    """Validated estimation dataset with named roles.

    x (N,P) controls; y (N,) outcome; d (N,) treatment; z (N,) optional
    instrument; cluster (N,) optional cluster ids (reserved for clustered
    inference).  ``theta0`` carries the ground truth for synthetic DGPs.
    Arrays are coerced to contiguous float32 once, at construction — the
    pipeline never re-validates or copies.
    """
    x: np.ndarray
    y: np.ndarray
    d: np.ndarray
    z: Optional[np.ndarray] = None
    cluster: Optional[np.ndarray] = None
    theta0: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "x", _as_f32("x", self.x, 2))
        n = self.x.shape[0]
        for name in ("y", "d", "z", "cluster"):
            arr = getattr(self, name)
            if arr is None:
                continue
            arr = _as_f32(name, arr, 1)
            if arr.shape[0] != n:
                raise ValueError(
                    f"DMLData.{name}: {arr.shape[0]} rows but x has {n}")
            object.__setattr__(self, name, arr)

    # ---- construction ----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Mapping) -> "DMLData":
        """Adapter for the legacy raw-dict format (make_*_data outputs)."""
        if isinstance(data, DMLData):
            return data
        known = {k: data[k] for k in _ROLES if k in data}
        t0 = data.get("theta0")
        return cls(theta0=float(t0) if t0 is not None else None, **known)

    def fingerprint(self) -> Tuple[str, Tuple[int, ...]]:
        """Content identity of the feature matrix (cached): the device
        page-pool key, so repeat traffic over the same dataset — same
        object or an equal copy — shares one resident feature page."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            fp = fingerprint_array(self.x)
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def content_key(self) -> Tuple:
        """Content identity of EVERY role array (cached).  This — not
        ``fingerprint``, which keys only the feature page — is the
        provenance key for caching tensors derived from the outcome/
        treatment columns (e.g. the compiler's stacked block tensors):
        two datasets sharing one X but different y/d/z must never
        collide."""
        ck = getattr(self, "_content_key", None)
        if ck is None:
            ck = tuple((r, fingerprint_array(getattr(self, r)))
                       for r in _ROLES if getattr(self, r) is not None)
            object.__setattr__(self, "_content_key", ck)
        return ck

    # ---- access ----------------------------------------------------------
    @property
    def n_obs(self) -> int:
        return self.x.shape[0]

    @property
    def dim_x(self) -> int:
        return self.x.shape[1]

    def role(self, name: str) -> np.ndarray:
        arr = getattr(self, name, None)
        if arr is None:
            raise KeyError(f"data has no {name!r} column (roles present: "
                           f"{[r for r in _ROLES if getattr(self, r) is not None]})")
        return arr

    def __contains__(self, name: str) -> bool:
        return name in _ROLES and getattr(self, name) is not None

    def __getitem__(self, name: str) -> np.ndarray:
        if name == "theta0":
            return self.theta0
        return self.role(name)

    def score_arrays(self) -> Dict[str, np.ndarray]:
        """The observation arrays the score functions consume."""
        return {k: getattr(self, k) for k in ("y", "d", "z")
                if getattr(self, k) is not None}

    # ---- durability -----------------
    def to_payload(self) -> Dict:
        """A msgpack-safe dict capturing every role array bit-exactly
        (raw bytes + dtype + shape) — the durable half of a session's
        admitted request spec.  Round-tripping through
        ``from_payload`` reproduces identical fingerprints, so a resumed
        drain hits the same pages, buckets, and compiled programs."""
        out: Dict = {}
        for r in _ROLES:
            arr = getattr(self, r)
            if arr is not None:
                out[r] = {"data": arr.tobytes(), "dtype": str(arr.dtype),
                          "shape": list(arr.shape)}
        if self.theta0 is not None:
            out["theta0"] = float(self.theta0)
        return out

    @classmethod
    def from_payload(cls, p: Mapping) -> "DMLData":
        kw = {}
        for r in _ROLES:
            ent = p.get(r)
            if ent is not None:
                kw[r] = np.frombuffer(ent["data"], dtype=ent["dtype"]) \
                          .reshape(tuple(ent["shape"])).copy()
        t0 = p.get("theta0")
        return cls(theta0=float(t0) if t0 is not None else None, **kw)


# ---------------------------------------------------------------------------
# plan components
# ---------------------------------------------------------------------------
def _hashable(v):
    """Canonicalize hyperparameter values so specs stay hashable
    (lists/dicts arrive from user code; learners receive tuples)."""
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, Mapping):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


@dataclass(frozen=True)
class NuisanceSpec:
    """One nuisance function: its regression target and its learner.

    ``subset`` restricts training rows for conditional nuisances
    (IRM/IIVM), e.g. "d1" = rows with D == 1; "all" = no restriction.
    ``params`` is a hyperparameter tuple of (key, value) pairs so specs
    stay hashable; build from a dict via ``NuisanceSpec.make``.
    """
    name: str                                   # e.g. "ml_l"
    target: str                                 # "y" | "d" | "z"
    learner: str                                # registry key (learners/)
    params: Tuple[Tuple[str, object], ...] = ()
    subset: str = "all"

    @classmethod
    def make(cls, name: str, target: str, learner: str,
             params: Optional[Mapping] = None,
             subset: str = "all") -> "NuisanceSpec":
        items = tuple(sorted((k, _hashable(v))
                             for k, v in (params or {}).items()))
        return cls(name=name, target=target, learner=learner,
                   params=items, subset=subset)

    @property
    def param_dict(self) -> Dict:
        return dict(self.params)

    @property
    def learner_key(self) -> Tuple[str, Tuple[Tuple[str, object], ...]]:
        return (self.learner, self.params)


@dataclass(frozen=True)
class ResamplingSpec:
    """Repeated K-fold cross-fitting (paper §3): M partitions of K folds."""
    n_folds: int = 5
    n_rep: int = 100
    seed: int = 42

    def __post_init__(self):
        if self.n_folds < 2:
            raise ValueError("n_folds must be >= 2 (cross-fitting needs a "
                             "held-out fold)")
        if self.n_rep < 1:
            raise ValueError("n_rep must be >= 1")


@dataclass(frozen=True)
class InferenceSpec:
    level: float = 0.95
    n_boot: int = 0                              # multiplier bootstrap draws
    aggregation: str = "median"                  # across repetitions


@dataclass(frozen=True)
class DMLPlan:
    """Everything needed to estimate one causal parameter — no execution
    state.  Built with ``DMLPlan.for_model`` (uniform learner + the
    standard propensity handling) or assembled nuisance-by-nuisance.
    """
    model: str
    nuisances: Tuple[NuisanceSpec, ...]
    resampling: ResamplingSpec = ResamplingSpec()
    score: str = "default"
    inference: InferenceSpec = InferenceSpec()
    scaling: str = "n_rep"                       # paper's scaling knob (§4.2)
    backend: str = "wave"
    pool: Optional[PoolConfig] = None            # execution substrate knobs

    def __post_init__(self):
        if self.model not in SPECS:
            raise KeyError(f"unknown model {self.model!r}; known: "
                           f"{list(SPECS)}")
        if self.scaling not in _SCALINGS:
            raise ValueError(f"scaling must be one of {_SCALINGS}")
        if self.backend not in BACKEND_NAMES:
            raise ValueError(f"backend must be one of {BACKEND_NAMES}")
        spec = SPECS[self.model]
        want = tuple(nm for nm, _, _ in spec.nuisances)
        got = tuple(ns.name for ns in self.nuisances)
        if got != want:
            raise ValueError(f"model {self.model!r} needs nuisances {want}, "
                             f"plan has {got}")

    # ---- construction -----------------------------------------------------
    @classmethod
    def for_model(cls, model: str, *, learner: str = "ridge",
                  learner_params: Optional[Mapping] = None,
                  n_folds: int = 5, n_rep: int = 100, seed: int = 42,
                  score: str = "default", scaling: str = "n_rep",
                  backend: str = "wave", pool: Optional[PoolConfig] = None,
                  n_boot: int = 0, level: float = 0.95,
                  overrides: Optional[Mapping[str, NuisanceSpec]] = None,
                  ) -> "DMLPlan":
        """One learner for every nuisance, with the standard exception:
        binary-treatment propensities (IRM/IIVM ``ml_m``) get a proper
        probability learner — ``logistic`` for the linear families,
        ``classify=True`` otherwise.  Pass ``overrides={"ml_m": spec}`` to
        replace any nuisance wholesale (this is what used to be the
        hard-coded ``_learner_key`` branch in core/dml.py).
        """
        spec = SPECS[model]
        params = dict(learner_params or {})
        nuisances = []
        for nm, target, subset in spec.nuisances:
            if overrides and nm in overrides:
                ov = overrides[nm]
                nuisances.append(replace(ov, name=nm, target=target,
                                         subset=subset))
                continue
            ln, lp = learner, params
            if nm == "ml_m" and model in ("irm", "iivm"):
                if learner in ("ols", "ridge", "lasso", "kernel_ridge"):
                    ln, lp = "logistic", {"reg": params.get("reg", 1.0)}
                else:
                    lp = {**params, "classify": True}
            nuisances.append(NuisanceSpec.make(nm, target, ln, lp, subset))
        return cls(model=model, nuisances=tuple(nuisances),
                   resampling=ResamplingSpec(n_folds, n_rep, seed),
                   score=score,
                   inference=InferenceSpec(level=level, n_boot=n_boot),
                   scaling=scaling, backend=backend, pool=pool)

    def replace(self, **kw) -> "DMLPlan":
        return replace(self, **kw)

    # ---- durability -----------------
    def to_payload(self) -> Dict:
        """A msgpack-safe dict of the full plan minus ``pool`` (execution
        substrate knobs belong to the resuming process, not the durable
        spec — a resume may deliberately swap in a healthier pool)."""
        return {
            "model": self.model,
            "nuisances": [
                {"name": ns.name, "target": ns.target,
                 "learner": ns.learner,
                 "params": [[k, v] for k, v in ns.params],
                 "subset": ns.subset}
                for ns in self.nuisances],
            "resampling": [self.resampling.n_folds, self.resampling.n_rep,
                           self.resampling.seed],
            "score": self.score,
            "inference": [self.inference.level, self.inference.n_boot,
                          self.inference.aggregation],
            "scaling": self.scaling,
            "backend": self.backend,
        }

    @classmethod
    def from_payload(cls, p: Mapping) -> "DMLPlan":
        # NuisanceSpec.make re-canonicalizes params (msgpack turns the
        # hashable tuples into lists on the way through)
        nuisances = tuple(
            NuisanceSpec.make(ns["name"], ns["target"], ns["learner"],
                              {k: v for k, v in ns["params"]},
                              ns["subset"])
            for ns in p["nuisances"])
        nf, nr, seed = p["resampling"]
        level, n_boot, agg = p["inference"]
        return cls(model=p["model"], nuisances=nuisances,
                   resampling=ResamplingSpec(nf, nr, seed),
                   score=p["score"],
                   inference=InferenceSpec(level=level, n_boot=n_boot,
                                           aggregation=agg),
                   scaling=p["scaling"], backend=p["backend"])

    # ---- derived ---------------------------------------------------------
    @property
    def n_nuisance(self) -> int:
        return len(self.nuisances)

    @property
    def uniform(self) -> bool:
        """All nuisances share one (learner, params) — one fused grid."""
        return all(ns.learner_key == self.nuisances[0].learner_key
                   for ns in self.nuisances)

"""Neyman-orthogonal score functions (paper §3; Chernozhukov et al. 2018).

Every score is linear in the causal parameter theta:

    psi(W; theta, eta) = theta * psi_a(W; eta) + psi_b(W; eta)

so the estimate solves  theta = -sum(psi_b) / sum(psi_a)  — the property the
paper exploits to return *predictions only* from workers (§3, §5.1).

Implemented model classes (the four from Chernozhukov et al. 2018 §4-5):
  PLR   partially linear regression            eta = (g, m)          L=2
  PLIV  partially linear IV                    eta = (g, m, r)       L=3
  IRM   interactive regression model           eta = (g0, g1, m)     L=3
  IIVM  interactive IV model                   eta = (g0, g1, m0, m1, r)  L=5*

(*we follow the DoubleML package: p(Z) estimated plus g(d,X), m(z,X) — the
task grid size per split is ``n_nuisance``.)

All functions are pure functions on torch tensors and broadcast over
leading axes, so M repetitions evaluate in one shot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

F32 = torch.float32


@dataclass(frozen=True)
class ScoreSpec:
    """Which nuisance functions a model class needs.

    Each entry: name -> (target_key, conditioning) where target_key selects
    the regression target from the dataset dict and ``subset`` optionally
    restricts the training rows (e.g. to D==1 for IRM's g1).
    """
    name: str
    nuisances: Tuple[Tuple[str, str, str], ...]   # (name, target, subset)

    @property
    def n_nuisance(self) -> int:
        return len(self.nuisances)


PLR = ScoreSpec("plr", (("ml_l", "y", "all"), ("ml_m", "d", "all")))
PLIV = ScoreSpec("pliv", (("ml_l", "y", "all"), ("ml_m", "z", "all"),
                          ("ml_r", "d", "all")))
IRM = ScoreSpec("irm", (("ml_g0", "y", "d0"), ("ml_g1", "y", "d1"),
                        ("ml_m", "d", "all")))
IIVM = ScoreSpec("iivm", (("ml_g0", "y", "z0"), ("ml_g1", "y", "z1"),
                          ("ml_m", "z", "all"),
                          ("ml_r0", "d", "z0"), ("ml_r1", "d", "z1")))

SPECS: Dict[str, ScoreSpec] = {s.name: s for s in (PLR, PLIV, IRM, IIVM)}


def _clip_propensity(p, eps=0.01):
    return torch.clamp(p, eps, 1.0 - eps)


def plr_score(data, preds, score: str = "partialling out"):
    """psi_a, psi_b for the PLR model (paper §5.1).

    data: {"y": (N,), "d": (N,)}; preds: {"ml_l": yhat, "ml_m": dhat} — each
    (..., N) cross-fitted predictions (leading axes = repetitions).
    """
    y, d = data["y"], data["d"]
    v = d - preds["ml_m"]                    # residual treatment
    if score == "IV-type":
        u = y - preds["ml_l"]                # here ml_l ~ g
        psi_a = -v * d
        psi_b = v * u
    else:                                    # "partialling out" (default)
        u = y - preds["ml_l"]
        psi_a = -v * v
        psi_b = v * u
    return psi_a.to(F32), psi_b.to(F32)


def pliv_score(data, preds):
    y, d, z = data["y"], data["d"], data["z"]
    u = y - preds["ml_l"]
    w = z - preds["ml_m"]
    v = d - preds["ml_r"]
    psi_a = -w * v
    psi_b = w * u
    return psi_a.to(F32), psi_b.to(F32)


def irm_score(data, preds, score: str = "ATE"):
    y, d = data["y"], data["d"]
    g0, g1 = preds["ml_g0"], preds["ml_g1"]
    m = _clip_propensity(preds["ml_m"])
    u0 = y - g0
    u1 = y - g1
    if score == "ATTE":
        p = torch.mean(d)
        psi_a = -d / p
        psi_b = d * u0 / p - m * (1 - d) * u0 / (p * (1 - m))
    else:
        psi_a = -torch.ones_like(y)
        psi_b = g1 - g0 + d * u1 / m - (1 - d) * u0 / (1 - m)
    return psi_a.to(F32), psi_b.to(F32)


def iivm_score(data, preds):
    y, d, z = data["y"], data["d"], data["z"]
    g0, g1 = preds["ml_g0"], preds["ml_g1"]
    m = _clip_propensity(preds["ml_m"])
    r0, r1 = preds["ml_r0"], preds["ml_r1"]
    u0, u1 = y - g0, y - g1
    psi_b = g1 - g0 + z * u1 / m - (1 - z) * u0 / (1 - m)
    psi_a = -(r1 - r0 + z * (d - r1) / m - (1 - z) * (d - r0) / (1 - m))
    return psi_a.to(F32), psi_b.to(F32)


def evaluate_score(model: str, data, preds, score: str = "default"):
    if model == "plr":
        return plr_score(data, preds,
                         "partialling out" if score == "default" else score)
    if model == "pliv":
        return pliv_score(data, preds)
    if model == "irm":
        return irm_score(data, preds, "ATE" if score == "default" else score)
    if model == "iivm":
        return iivm_score(data, preds)
    raise KeyError(model)


def solve_theta(psi_a, psi_b, axis=-1):
    """theta = -sum(psi_b)/sum(psi_a) along the observation axis."""
    return -torch.sum(psi_b, dim=axis) / torch.sum(psi_a, dim=axis)


def score_se(psi_a, psi_b, theta, axis=-1):
    """Sandwich standard error from the evaluated score (CCDDHNR18 Thm 3.2)."""
    n = psi_a.shape[axis]
    psi = psi_a * torch.unsqueeze(theta, axis) + psi_b
    j = torch.mean(psi_a, dim=axis)
    var = torch.mean(psi * psi, dim=axis) / (j * j)
    return torch.sqrt(var / n)

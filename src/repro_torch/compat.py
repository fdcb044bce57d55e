"""State carried across from the JAX package.

This system has no weights: its state is the request (plan + data) and
its task ledger.  The functions here take only plain Python / numpy
values — the dicts that the reference's ``DMLPlan.to_payload()`` and
``DMLData.to_payload()`` write (directly, or after a msgpack round trip)
and the file that its ``TaskLedger.save`` writes — so nothing of the JAX
package is imported.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from repro_torch.core.spec import DMLData, DMLPlan
from repro_torch.serverless.backends import WorkRequest
from repro_torch.serverless.ledger import TaskLedger


def plan_from_reference(payload: Mapping) -> DMLPlan:
    """The port's plan for a reference ``DMLPlan.to_payload()`` dict
    (model, nuisances, resampling, score, inference, scaling, backend;
    the pool is not part of a payload)."""
    return DMLPlan.from_payload(payload)


def data_from_reference(payload: Mapping) -> DMLData:
    """The port's dataset for a reference ``DMLData.to_payload()`` dict:
    every role array bit-exact, hence identical fingerprints."""
    return DMLData.from_payload(payload)


def ledger_from_reference(path: str) -> TaskLedger:
    """Load a ledger file written by the reference's ``TaskLedger.save``;
    DONE rows keep their predictions, RUNNING rows return to PENDING."""
    return TaskLedger.load(path)


def request_arrays(req: WorkRequest) -> Dict[str, np.ndarray]:
    """The arrays of a compiled request, for comparing a port
    ``WorkRequest`` with the reference's field by field."""
    return {"x": np.asarray(req.x), "targets": np.asarray(req.targets),
            "train_w": np.asarray(req.train_w),
            "fold_masks": np.asarray(req.fold_masks)}

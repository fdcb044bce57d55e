"""PyTorch/CUDA port of the distributed double machine learning system.

Same sub-package layout as the JAX package it was ported from: the
counterpart of a module is found by its path.  Imports torch, numpy,
msgpack and the standard library only.
"""
from repro_torch.core import (
    DMLData, DMLPlan, DMLResult, DMLSession, estimate,
)

__all__ = ["DMLData", "DMLPlan", "DMLResult", "DMLSession", "estimate"]

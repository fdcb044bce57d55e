"""Model definitions of the port (the hybrid family so far)."""
from repro_torch.models.lm import ModelBundle, build_model
from repro_torch.models.param import (
    PDecl, init_tree, param_count, params_from_numpy,
)

__all__ = ["ModelBundle", "build_model", "PDecl", "init_tree",
           "param_count", "params_from_numpy"]

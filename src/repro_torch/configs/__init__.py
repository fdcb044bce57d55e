"""Architecture and shape registry of the port.

``get_arch("zamba2-7b")`` returns the full config and
``get_arch("zamba2-7b", reduced=True)`` the CPU smoke variant, as the JAX
package's registry does.  Every architecture of the JAX package's
registry is ported, in its order; ``NOT_PORTED`` is empty and stays for
the names a later architecture of the reference would add.  An unknown
name raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (
    ArchConfig,
    AttentionConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    SHAPE_BY_NAME,
    shape_applicable,
)

_ARCH_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "yi-34b": "yi_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-7b": "zamba2_7b",
    "whisper-base": "whisper_base",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}
# names of the JAX package's registry that the port does not take: none
NOT_PORTED: tuple = ()

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


__all__ = [
    "ArchConfig", "AttentionConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "SHAPE_BY_NAME", "shape_applicable", "ARCH_NAMES",
    "NOT_PORTED", "get_arch",
]

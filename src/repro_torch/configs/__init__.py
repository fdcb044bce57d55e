"""Architecture and shape registry of the port.

``get_arch("zamba2-7b")`` returns the full config and
``get_arch("zamba2-7b", reduced=True)`` the CPU smoke variant, as the JAX
package's registry does.  Only the architectures whose model path is
ported are known; every other name of the JAX package's registry raises
``KeyError`` naming the ROADMAP item that ports it.
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
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "yi-34b": "yi_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-7b": "zamba2_7b",
}
# the JAX package's other architectures: their families (xLSTM, enc-dec
# audio, VLM cross-attention) are not ported yet
NOT_PORTED = ("xlstm-350m", "whisper-base", "llama-3.2-vision-90b")

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_arch(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _ARCH_MODULES:
        why = ("not ported yet (ROADMAP item 15)" if name in NOT_PORTED
               else "unknown")
        raise KeyError(f"arch {name!r}: {why}; ported: {ARCH_NAMES}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


__all__ = [
    "ArchConfig", "AttentionConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "SHAPE_BY_NAME", "shape_applicable", "ARCH_NAMES",
    "NOT_PORTED", "get_arch",
]
